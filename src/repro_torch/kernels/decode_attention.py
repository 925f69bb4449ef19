"""Split-KV decode attention: the wrappers of the CUDA kernels in
``csrc/decode_attention.cu``.  `paged_decode_attention` replaces
`repro/kernels/decode_attention.py` `make_paged_kernel`; `decode_attention`
replaces `make_kernel` (a contiguous (B,S,Hkv,D) cache) and
`verify_attention` replaces `make_verify_kernel` (T drafted query rows per
slot through the block table).  Each runs the exact combine `_combine` as
a second small kernel.

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

The contiguous and verify kernels are one kernel (`rows_partials_kernel`)
over T*G query rows a block, staging each kv block or page in tiles of up
to 32 rows; their bounds are the live K/V bytes too (verify: the rows up
to ``pos0 + T - 1``).

On CPU tensors each wrapper computes its plain version
(`ref.verify_split_kv`, with one row for paged decode, and `ref.split_kv`:
the same split arithmetic in PyTorch); on CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref

MAX_GROUP = 8                      # query heads per kv head the kernel takes

MAX_ROWS = 32                      # T*G query rows the rows kernel takes
TILE_ROWS = 32                     # most kv rows the rows kernel stages

launches = 0                       # bf16-pool kernel launches since reset
int8_launches = 0                  # int8-pool kernel launches since reset
contig_launches = 0                # contiguous bf16-cache launches
contig_int8_launches = 0           # contiguous int8-cache launches
verify_launches = 0                # verify, bf16 pools
verify_int8_launches = 0           # verify, int8 pools


def paged_takes(g: int, d: int, ps: int, elem: int) -> bool:
    """Whether the paged decode kernel takes ``g`` query heads a kv head,
    head dim ``d`` and pages of ``ps`` rows of ``elem``-byte values (1: an
    int8 pool); the layer dispatch sends any other geometry to the plain
    path."""
    smem = 2 * ps * d * elem + g * d * 4 + g * ps * 4 + 2 * ps * 4
    return (g <= MAX_GROUP and d % 32 == 0 and d <= 1024
            and not (elem == 1 and ps > d) and smem <= _build.MAX_SMEM)


def rows_takes(t: int, g: int, d: int, seg: int, elem: int) -> bool:
    """Whether the rows kernel (contiguous decode, T = 1; verify) takes
    ``t * g`` query rows a kv head, head dim ``d`` and kv segments of
    ``seg`` rows (a page or a kv block) of ``elem``-byte values."""
    tr, rr = math.gcd(seg, TILE_ROWS), t * g
    smem = 2 * tr * d * elem + 4 * (rr * d + rr * tr + 3 * rr + 2 * tr)
    return (rr <= MAX_ROWS and d % 32 == 0 and d <= 1024
            and smem <= _build.MAX_SMEM)


def _scales(k_scale, v_scale, shape):
    """Whether int8 scales are given, checking both are, at ``shape``."""
    quant = k_scale is not None or v_scale is not None
    if quant and (k_scale is None or v_scale is None
                  or tuple(k_scale.shape) != shape
                  or tuple(v_scale.shape) != shape):
        raise ValueError(
            f"int8 caches need k_scale and v_scale of shape {shape}, got "
            f"{None if k_scale is None else tuple(k_scale.shape)} and "
            f"{None if v_scale is None else tuple(v_scale.shape)}")
    return quant


def paged_decode_attention(q, k_pool, v_pool, block_table, pos,
                           cfg: CoarseningConfig | str = BASE, *,
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
    quant = _scales(k_scale, v_scale, (n_pages, ps, hkv))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    gapped = cfg.kind == KIND_GAPPED
    if q.device.type == "cpu":
        return ref.verify_split_kv(q, k_pool, v_pool, block_table, pos,
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
    if not paged_takes(g, d, ps, k_pool.element_size()):
        raise ValueError(f"paged decode kernel takes G <= {MAX_GROUP}, D a "
                         f"multiple of 32 up to 1024 (and, for int8 pools, "
                         f"page rows <= D) and a page that fits in shared "
                         f"memory ({_build.MAX_SMEM} B), got G={g}, D={d}, "
                         f"ps={ps}")
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


def _launch_rows(q, k, v, k_scale, v_scale, block_table, pos0, *, paged,
                 t, seg, nseg, n_pages, c, gapped, window, scale, what):
    """Check the operands of the rows kernel and launch it (with its
    combine); returns the (B,T,H,D) output."""
    b, _, h, d = q.shape
    hkv = k.shape[2]
    dev = q.device
    quant = k_scale is not None
    operands = [k, v, pos0] + ([block_table] if paged else []) + (
        [k_scale, v_scale] if quant else [])
    if dev.type != "cuda" or any(x.device != dev for x in operands):
        raise ValueError(f"{what} operands must share one CUDA device")
    kv_dtype = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or k.dtype != kv_dtype \
            or v.dtype != kv_dtype:
        raise TypeError(f"{what} kernel takes bf16 q and {kv_dtype} K/V, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError(f"{what}: int8 K/V take float32 scales")
    if pos0.dtype != torch.int32 or (paged
                                     and block_table.dtype != torch.int32):
        raise TypeError(f"{what}: positions and block_table must be int32")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in [q] + operands):
        raise ValueError(f"{what} kernel takes contiguous, 16-byte aligned "
                         f"operands")
    g = h // hkv
    if not rows_takes(t, g, d, seg, k.element_size()):
        raise ValueError(f"{what} kernel takes T*G <= {MAX_ROWS} query rows "
                         f"a kv head, D a multiple of 32 up to 1024 and a "
                         f"tile that fits in shared memory "
                         f"({_build.MAX_SMEM} B), got T={t}, G={g}, D={d}")
    tr = math.gcd(seg, TILE_ROWS)
    rr = t * g
    n_splits = nseg // c
    m = torch.empty((b, hkv, rr, n_splits), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, hkv, rr, n_splits, d), dtype=torch.float32,
                      device=dev)
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    rc = lib.split_kv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_table.data_ptr() if paged else None, pos0.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
        int(quant), int(paged), b, hkv, g, t, d, n_pages, seg, nseg, c,
        int(gapped), window or 0, tr, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{what} ({'int8' if quant else 'bf16'})")
    return out


def decode_attention(q, k_cache, v_cache, pos,
                     cfg: CoarseningConfig | str = BASE, *, bkv: int = 128,
                     window: int | None = None, scale: float | None = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B,1,H,D); caches: (B,S,Hkv,D), slot b's rows in order; pos: (B,)
    int32 -> (B,1,H,D) in q's dtype.  Each split owns ``cfg.degree`` kv
    blocks of ``bkv`` rows; S must tile by degree * bkv.  ``k_scale`` /
    ``v_scale`` (B,S,Hkv) f32 mark int8 caches.  Inactive slots may carry
    ``pos >= S``: every row then counts, and no row past S is read."""
    global contig_launches, contig_int8_launches
    cfg = resolve(cfg)
    b, one, h, d = q.shape
    b2, s, hkv, d2 = k_cache.shape
    c = cfg.degree
    if one != 1 or b2 != b or d2 != d or v_cache.shape != k_cache.shape \
            or pos.shape != (b,):
        raise ValueError(
            f"decode shapes: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, pos "
            f"{tuple(pos.shape)}")
    if h % hkv:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads {hkv}")
    if bkv < 1 or s % (c * bkv):
        raise ValueError(f"cache len {s} not tileable by degree*bkv="
                         f"{c * bkv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    quant = _scales(k_scale, v_scale, (b, s, hkv))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    gapped = cfg.kind == KIND_GAPPED
    if q.device.type == "cpu":
        return ref.split_kv(q, k_cache, v_cache, pos, degree=c,
                            gapped=gapped, bkv=bkv, window=window,
                            scale=scale, k_scale=k_scale, v_scale=v_scale)
    out = _launch_rows(q, k_cache, v_cache, k_scale, v_scale, None, pos,
                       paged=False, t=1, seg=bkv, nseg=s // bkv, n_pages=0,
                       c=c, gapped=gapped, window=window, scale=scale,
                       what="contiguous decode")
    if quant:
        contig_int8_launches += 1
    else:
        contig_launches += 1
    return out


def verify_attention(q, k_pool, v_pool, block_table, pos0,
                     cfg: CoarseningConfig | str = BASE, *,
                     window: int | None = None, scale: float | None = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B,T,H,D), row t at cache position ``pos0[b] + t``; pools:
    (P,ps,Hkv,D); block_table: (B,npp) int32; pos0: (B,) int32 ->
    (B,T,H,D) in q's dtype.  The coarsening axis is the slot's logical
    page axis, as in `paged_decode_attention`.  ``k_scale`` / ``v_scale``
    (P,ps,Hkv) f32 mark int8 pools."""
    global verify_launches, verify_int8_launches
    cfg = resolve(cfg)
    b, t, h, d = q.shape
    n_pages, ps, hkv, d2 = k_pool.shape
    npp = block_table.shape[1]
    c = cfg.degree
    if d2 != d or v_pool.shape != k_pool.shape \
            or block_table.shape[0] != b or pos0.shape != (b,):
        raise ValueError(
            f"verify shapes: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(block_table.shape)}, pos0 {tuple(pos0.shape)}")
    if h % hkv:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads {hkv}")
    if npp % c:
        raise ValueError(f"slot pages {npp} not tileable by degree {c}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    quant = _scales(k_scale, v_scale, (n_pages, ps, hkv))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    gapped = cfg.kind == KIND_GAPPED
    if q.device.type == "cpu":
        return ref.verify_split_kv(q, k_pool, v_pool, block_table, pos0,
                                   degree=c, gapped=gapped, window=window,
                                   scale=scale, k_scale=k_scale,
                                   v_scale=v_scale)
    out = _launch_rows(q, k_pool, v_pool, k_scale, v_scale, block_table,
                       pos0, paged=True, t=t, seg=ps, nseg=npp,
                       n_pages=n_pages, c=c, gapped=gapped, window=window,
                       scale=scale, what="verify")
    if quant:
        verify_int8_launches += 1
    else:
        verify_launches += 1
    return out
