"""Block-sparse flash attention: the live-KV index builder (host side) and
the wrapper of the CUDA kernel in ``csrc/sparse_attention.cu`` (it replaces
`repro/kernels/sparse_attention.py` `make_kernel`).

The builder enumerates, per q block, the kv blocks holding at least one
live (q, k) pair under the pattern (causal, sliding window, LongFormer-style
global-stride columns), ascending, padded to a static ``max_live`` width
with ``NULL_BLOCK``; the kernel resolves its slots through that index and
never reads a kv block the index does not list.  The builder is a copy of
the reference's (`repro/kernels/sparse_attention.py:50-154`), so the index
is the reference's array for every geometry; the port uploads it to a
device once per (geometry, device) (`device_index`).

Coarsening is over the live-SLOT axis: consecutive (slot si*C + j) or
gapped (slot j*seg + si, seg = max_live / C); C must divide max_live.

On CPU tensors the wrapper computes its plain version (`ref.flash_sparse`,
a walk of the index in the kernel's slot order); on CUDA tensors it
launches the kernel or raises.  The kernel takes bf16 q, k, v, Sq == Sk,
head dims 64, 128 and 256, q blocks of 64, 128 or 256 rows (64 or 128 at
head dim 256) and kv blocks a multiple of 64 rows.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref

# the NULL slot sentinel: kv block 0 is live under every causal pattern, so
# the index pads with an out-of-range id rather than a reserved block
NULL_BLOCK = -1
HEAD_DIMS = (64, 128, 256)

# kernel launches since the last reset
launches = 0


def _element_mask(rows, cols, *, causal: bool, window, global_stride):
    """Live (q, k) pairs under the pattern, elementwise over broadcastable
    row / col position arrays (numpy arrays or torch tensors).

    causal         : col <= row
    window         : col > row - window ... OR the col is a global column
    global_stride  : cols = 0 (mod stride) are globally attended, still
                     subject to causality
    """
    if isinstance(rows, torch.Tensor):
        mask = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                          dtype=torch.bool, device=rows.device)
    else:
        mask = np.ones(np.broadcast_shapes(rows.shape, cols.shape),
                       dtype=bool)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        keep = cols > rows - window
        if global_stride:
            keep = keep | (cols % global_stride == 0)
        mask = mask & keep
    return mask


def _block_live(sq: int, sk: int, bq: int, bkv: int, *, causal: bool,
                window, global_stride) -> np.ndarray:
    """(nq, nk) bool: block (i, j) holds >= 1 live (q, k) pair, in closed
    form per tile (the band boundaries have slope 1, so a rectangle meets
    the band iff its (row - col) range does)."""
    nq, nk = sq // bq, sk // bkv
    i = np.arange(nq)[:, None]
    j = np.arange(nk)[None, :]
    r0, r1 = i * bq, i * bq + bq - 1          # tile row range
    c0, c1 = j * bkv, j * bkv + bkv - 1       # tile col range
    live = np.ones((nq, nk), dtype=bool)
    if causal:
        live &= c0 <= r1
    if window is not None:
        band = c1 > r0 - window
        if global_stride:
            # smallest multiple of the stride inside the tile's col range
            cg = -(-c0 // global_stride) * global_stride
            stride_live = cg <= c1
            if causal:
                stride_live = stride_live & (cg <= r1)
            band |= stride_live
        live &= band
    return live


def max_live_blocks(sq: int, sk: int, bq: int, bkv: int, *,
                    causal: bool = True, window=None, global_stride=None,
                    pad_multiple: int = 8) -> int:
    """The padded per-q-block index width `build_block_index` produces."""
    live = _block_live(sq, sk, bq, bkv, causal=causal, window=window,
                       global_stride=global_stride)
    ml = int(live.sum(axis=1).max(initial=1))
    return -(-ml // pad_multiple) * pad_multiple


@functools.lru_cache(maxsize=256)
def build_block_index(sq: int, sk: int, bq: int, bkv: int, *,
                      causal: bool = True, window: int | None = None,
                      global_stride: int | None = None,
                      pad_multiple: int = 8) -> np.ndarray:
    """Per-q-block live kv block ids, NULL-padded to a static shape ->
    (nq, max_live) int32: row i lists the kv blocks with a live pair for
    q rows [i*bq, (i+1)*bq), ascending; max_live is rounded up to
    ``pad_multiple`` so every degree in {1, 2, 4, 8} divides it.  Cached;
    the result is read-only."""
    if sq % bq or sk % bkv:
        raise ValueError(f"sequence not tileable: {sq}x{sk} by {bq}x{bkv}")
    live = _block_live(sq, sk, bq, bkv, causal=causal, window=window,
                       global_stride=global_stride)
    nq = live.shape[0]
    counts = live.sum(axis=1)
    max_live = -(-int(counts.max(initial=1)) // pad_multiple) * pad_multiple
    idx = np.full((nq, max_live), NULL_BLOCK, dtype=np.int32)
    for i in range(nq):
        row = np.nonzero(live[i])[0]
        idx[i, :len(row)] = row
    idx.setflags(write=False)
    return idx


@functools.lru_cache(maxsize=256)
def device_index(sq: int, sk: int, bq: int, bkv: int, *, causal: bool,
                 window, global_stride, device) -> torch.Tensor:
    """`build_block_index` as an int32 tensor on ``device``, uploaded once
    per (geometry, device) and reused by every later call (read-only)."""
    return torch.tensor(build_block_index(sq, sk, bq, bkv, causal=causal,
                                          window=window,
                                          global_stride=global_stride),
                        device=device)


def takes(d: int, bq: int, bkv: int) -> bool:
    """Whether the kernel holds head dim ``d``, q blocks of ``bq`` rows
    (one block per q block, 16 rows a warp) and kv blocks of ``bkv``."""
    return (d in HEAD_DIMS and bkv % 64 == 0
            and (bq in (64, 128) or (bq == 256 and d < 256)))


def _check(q, k, v, idx, cfg: CoarseningConfig, bq, bkv) -> None:
    """Shapes, the index and the degree (both devices)."""
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"sparse flash shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads "
                         f"{k.shape[1]}")
    if sq != k.shape[2] or sq % bq or sq % bkv:
        raise ValueError(f"seq not tileable: Sq {sq}, Sk {k.shape[2]}, bq "
                         f"{bq}, bkv {bkv}")
    if tuple(idx.shape)[0] != sq // bq:
        raise ValueError(f"index has {idx.shape[0]} rows, {sq // bq} q "
                         f"blocks")
    if idx.shape[1] % cfg.degree:
        raise ValueError(f"live-slot list of {idx.shape[1]} not tileable by "
                         f"degree {cfg.degree}")


def flash_sparse_fwd(q, k, v, idx, cfg: CoarseningConfig | str = BASE, *,
                     bq: int = 128, bkv: int = 128, causal: bool = True,
                     window: int | None = None,
                     global_stride: int | None = None,
                     scale: float | None = None, residuals: bool = False):
    """q: (B,H,S,D); k, v: (B,Hkv,S,D); idx: (S/bq, max_live) int32 (a
    `device_index` on q's device) -> o (B,H,S,D) float32, or (o, m, l)
    with m, l (B,H,S) float32 when ``residuals``."""
    global launches
    cfg = resolve(cfg)
    _check(q, k, v, idx, cfg, bq, bkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    gapped = cfg.kind == KIND_GAPPED
    if q.device.type == "cpu":
        o, m, l = ref.flash_sparse(q, k, v, idx, degree=cfg.degree,
                                   gapped=gapped, bq=bq, bkv=bkv,
                                   causal=causal, window=window,
                                   global_stride=global_stride, scale=scale)
        return (o, m, l) if residuals else o
    dev = q.device
    if any(t.device != dev for t in (k, v, idx)) or dev.type != "cuda":
        raise ValueError("sparse flash operands and index must share one "
                         "CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) \
            or idx.dtype != torch.int32:
        raise TypeError(f"sparse flash kernel takes bf16 q, k, v and an "
                        f"int32 index, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{idx.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, idx)):
        raise ValueError("sparse flash kernel takes contiguous operands")
    b, h, s, d = q.shape
    if not takes(d, bq, bkv):
        raise ValueError(f"sparse flash kernel holds head dims {HEAD_DIMS}, "
                         f"bq 64/128 (256 below head dim 256) and bkv % 64 "
                         f"== 0; got D={d}, bq={bq}, bkv={bkv}")
    o = torch.empty((b, h, s, d), dtype=torch.float32, device=dev)
    m = l = None
    if residuals:
        m = torch.empty((b, h, s), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
    rc = _build.library("sparse_attention").flash_sparse_fwd_bf16(
        idx.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(), b, h, k.shape[1], s, d, bq, bkv,
        idx.shape[1], cfg.degree, int(gapped), int(causal), window or 0,
        global_stride or 0, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_sparse_fwd_bf16")
    launches += 1
    return (o, m, l) if residuals else o
