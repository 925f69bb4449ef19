"""Paged split-KV decode attention: the wrapper of the CUDA kernel in
``csrc/decode_attention.cu`` (it replaces `repro/kernels/decode_attention.py`
`make_paged_kernel` and runs the exact combine `_combine` as a second small
kernel).

One thread block per (slot, kv head, split) owns C logical pages of the
slot's block table, adjacent (consecutive) or npp/C apart (gapped), streams
their K/V rows with 16-byte loads and writes an online-softmax partial; a
split wholly past ``pos`` writes the empty partial without touching the
pool.  Bound on the H100: the live K/V bytes, 2 * (pos+1) * Hkv * D * 2 per
slot per layer, at 3.35 TB/s.

On CPU tensors the wrapper computes the plain version (`ref.paged_split_kv`,
the same split arithmetic in PyTorch); on CUDA tensors it launches the
kernel or raises.  bf16 pools only: int8 pools raise NotImplementedError.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.coarsening import KIND_GAPPED, CoarseningConfig, resolve
from repro_torch.kernels import _build, ref

MAX_GROUP = 8                      # query heads per kv head the kernel takes
MAX_SMEM = 227 * 1024              # shared memory a block may use (H100)

launches = 0                       # kernel launches since the last reset


def paged_decode_attention(q, k_pool, v_pool, block_table, pos,
                           cfg: CoarseningConfig | str = "auto", *,
                           window: int | None = None,
                           scale: float | None = None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B,1,H,D); pools: (P,ps,Hkv,D) shared by every slot; block_table:
    (B,npp) int32 logical->physical page map; pos: (B,) int32 ->
    (B,1,H,D) in q's dtype."""
    global launches
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("paged decode attention: int8 KV pools are "
                                  "not ported yet")
    cfg = resolve(cfg)
    b, one, h, d = q.shape
    n_pages, ps, hkv, d2 = k_pool.shape
    npp = block_table.shape[1]
    c = cfg.degree
    if one != 1 or d2 != d or v_pool.shape != k_pool.shape \
            or block_table.shape[0] != b or pos.shape != (b,):
        raise ValueError(
            f"paged decode shapes: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(block_table.shape)}, pos {tuple(pos.shape)}")
    if h % hkv:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads {hkv}")
    if npp % c:
        raise ValueError(f"slot pages {npp} not tileable by degree {c}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    gapped = cfg.kind == KIND_GAPPED
    if q.device.type == "cpu":
        return ref.paged_split_kv(q, k_pool, v_pool, block_table, pos,
                                  degree=c, gapped=gapped, window=window,
                                  scale=scale)

    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (k_pool, v_pool, block_table, pos)):
        raise ValueError("paged decode operands must share one CUDA device")
    if q.dtype != torch.bfloat16 or k_pool.dtype != torch.bfloat16 \
            or v_pool.dtype != torch.bfloat16:
        raise TypeError(f"paged decode kernel takes bf16 q and pools, got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("block_table and pos must be int32")
    if not all(t.is_contiguous() for t in
               (q, k_pool, v_pool, block_table, pos)):
        raise ValueError("paged decode kernel takes contiguous operands")
    g = h // hkv
    if g > MAX_GROUP or d % 32 or d > 1024:
        raise ValueError(f"paged decode kernel takes G <= {MAX_GROUP} and "
                         f"D a multiple of 32 up to 1024, got G={g}, D={d}")
    smem = 2 * ps * d * 2 + g * d * 4 + g * ps * 4
    if smem > MAX_SMEM:
        raise ValueError(f"page of {ps} rows x {d} needs {smem} B of shared "
                         f"memory, more than {MAX_SMEM}")
    n_splits = npp // c
    m = torch.empty((b, hkv, g, n_splits), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, g, n_splits, d), dtype=torch.float32,
                      device=dev)
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    rc = lib.paged_decode_attention_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), out.data_ptr(), b, hkv, g, d, n_pages, ps, npp, c,
        int(gapped), window or 0, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "paged_decode_attention_bf16")
    launches += 1
    return out
