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

int8 pools (``k_scale`` / ``v_scale`` (P,ps,Hkv) f32, the ``kv_bits=8``
branch of `make_paged_kernel`) launch the kernel's int8 variant: the
scales are pulled out of the dot, so a split stages half the bytes.  Its
bound: the live rows' int8 K/V bytes and their scales.

On CPU tensors the wrapper computes the plain version (`ref.paged_split_kv`,
the same split arithmetic in PyTorch); on CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.coarsening import KIND_GAPPED, CoarseningConfig, resolve
from repro_torch.kernels import _build, ref

MAX_GROUP = 8                      # query heads per kv head the kernel takes
MAX_SMEM = 227 * 1024              # shared memory a block may use (H100)

launches = 0                       # bf16-pool kernel launches since reset
int8_launches = 0                  # int8-pool kernel launches since reset


def paged_decode_attention(q, k_pool, v_pool, block_table, pos,
                           cfg: CoarseningConfig | str = "auto", *,
                           window: int | None = None,
                           scale: float | None = None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B,1,H,D); pools: (P,ps,Hkv,D) shared by every slot; block_table:
    (B,npp) int32 logical->physical page map; pos: (B,) int32 ->
    (B,1,H,D) in q's dtype."""
    global launches, int8_launches
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
    quant = k_scale is not None or v_scale is not None
    if quant and (k_scale is None or v_scale is None
                  or tuple(k_scale.shape) != (n_pages, ps, hkv)
                  or tuple(v_scale.shape) != (n_pages, ps, hkv)):
        raise ValueError(
            f"int8 pools need k_scale and v_scale of shape "
            f"{(n_pages, ps, hkv)}, got "
            f"{None if k_scale is None else tuple(k_scale.shape)} and "
            f"{None if v_scale is None else tuple(v_scale.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    gapped = cfg.kind == KIND_GAPPED
    if q.device.type == "cpu":
        return ref.paged_split_kv(q, k_pool, v_pool, block_table, pos,
                                  degree=c, gapped=gapped, window=window,
                                  scale=scale, k_scale=k_scale,
                                  v_scale=v_scale)

    dev = q.device
    operands = [k_pool, v_pool, block_table, pos] + (
        [k_scale, v_scale] if quant else [])
    if dev.type != "cuda" or any(t.device != dev for t in operands):
        raise ValueError("paged decode operands must share one CUDA device")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise TypeError(f"paged decode kernel takes bf16 q and "
                        f"{pool_dtype} pools, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError("int8 pools take float32 scale pools")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("block_table and pos must be int32")
    if not all(t.is_contiguous() for t in [q] + operands):
        raise ValueError("paged decode kernel takes contiguous operands")
    g = h // hkv
    if g > MAX_GROUP or d % 32 or d > 1024 or (quant and ps > d):
        raise ValueError(f"paged decode kernel takes G <= {MAX_GROUP}, D a "
                         f"multiple of 32 up to 1024 (and, for int8 pools, "
                         f"page rows <= D), got G={g}, D={d}, ps={ps}")
    smem = (2 * ps * d * k_pool.element_size() + g * d * 4 + g * ps * 4
            + 2 * ps * 4)
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
    tail = (block_table.data_ptr(), pos.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), out.data_ptr(), b, hkv, g, d,
            n_pages, ps, npp, c, int(gapped), window or 0, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if quant:
        rc = lib.paged_decode_attention_int8(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), *tail)
        _build.check(rc, "paged_decode_attention_int8")
        int8_launches += 1
    else:
        rc = lib.paged_decode_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *tail)
        _build.check(rc, "paged_decode_attention_bf16")
        launches += 1
    return out
