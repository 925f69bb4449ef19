"""Split-KV decode attention: the wrappers of the CUDA kernel in
``csrc/decode_attention.cu``.  One kernel, `rows_kernel`, replaces three
Pallas kernels of `repro/kernels/decode_attention.py`: `make_paged_kernel`
(`paged_decode_attention`: one query row a slot through the block table),
`make_kernel` (`decode_attention`: a contiguous (B,S,Hkv,D) cache) and
`make_verify_kernel` (`verify_attention`: T drafted query rows a slot
through the block table).  Paged decode is verify's call at T = 1 with
``pos0 = pos``, so a decode row and a verify row at the same position
take one walk and one order of every sum: the same bits.

The kernel takes T*G <= 64 query rows a kv head: the splits of a (slot,
kv head) on up to 16 blocks, each walking its live splits through a ring
of 2-4 stages of 16 or 32 kv rows filled by cp.async, scores on the tensor
cores, the online softmax in registers, P.V in float32, and the split
combine in the same launch (the last block to finish merges the live
splits' partials in split order; a dead split writes nothing; the longest
slots run first).  A split owns C segments (pages, or kv blocks of a
contiguous cache), adjacent (consecutive) or nseg/C apart (gapped).
`rows_launch` sizes a launch and `rows_program` mirrors its walk in
Python.  Bound on the H100: the live K/V bytes, 2 * (pos+1) * Hkv * D * 2
per slot per layer (verify: the rows up to ``pos0 + T - 1``), at 3.35
TB/s.

int8 caches (``k_scale`` / ``v_scale`` f32, one a (row, kv head), the
``kv_bits=8`` branches of the Pallas kernels) launch the kernel's int8
instances: K and V are widened to bf16 in shared memory and the scales
applied beside the products.  Their bound: the live rows' int8 K/V bytes
and their scales.

On CPU tensors each wrapper computes its plain version
(`ref.verify_split_kv`, with one row for paged decode, and `ref.split_kv`:
the same split arithmetic in PyTorch); on CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref

MAX_ROWS = 64                      # T*G query rows the rows kernel takes
MAX_ROWS_D = 256                   # head dims: multiples of 32 up to this
MAX_STAGES = 4                     # ring stages of the rows kernel
MAX_BLOCKS = 16                    # rows-kernel blocks a (slot, kv head)
MERGE_SMEM = 48 * 1024             # shared memory a rows block at least
ROWS_TAB = 1024                    # table entries a rows block reads early
ROWS_SMEM = _build.MAX_SMEM - 128  # dynamic shared memory a rows block

launches = 0                       # paged decode, bf16 pools, since reset
int8_launches = 0                  # paged decode, int8 pools
contig_launches = 0                # contiguous bf16-cache launches
contig_int8_launches = 0           # contiguous int8-cache launches
verify_launches = 0                # verify, bf16 pools
verify_int8_launches = 0           # verify, int8 pools


def rows_tile(seg: int, rr: int) -> int:
    """kv rows a stage of the rows kernel for ``rr`` query rows: 32 where
    they tile the segment and ``rr <= 32``, else 16 (a tile's rows past
    its segment are zero-filled)."""
    return 32 if seg % 32 == 0 and rr <= 32 else 16


def rows_mtiles(rr: int) -> int:
    """m16 tiles the rows kernel pads ``rr`` query rows to (1, 2 or 4)."""
    return 1 if rr <= 16 else 2 if rr <= 32 else 4


def rows_smem(rr: int, d: int, tr: int, elem: int, nst: int) -> int:
    """Shared memory of one rows-kernel block (`rows_smem_bytes`): the
    padded query rows, ``nst`` stages of K, V (and int8 scales), each
    warp's probability tile, and for int8 a stage's K and V widened to
    bf16."""
    mt, kvs = rows_mtiles(rr), d * elem + 16
    return (mt * 16 * (2 * d + 16)
            + nst * (2 * tr * kvs + (8 * tr if elem == 1 else 0))
            + (d // 32) * mt * 16 * (tr + 4) * 4
            + (2 * tr * (2 * d + 16) if elem == 1 else 0))


def rows_stages(rr: int, d: int, seg: int, tiles: int, elem: int) -> int:
    """Ring stages of a launch whose blocks walk at most ``tiles`` tiles:
    as many, 2 to `MAX_STAGES`, fewer where shared memory runs out."""
    tr = rows_tile(seg, rr)
    nst = max(2, min(MAX_STAGES, tiles))
    while nst > 2 and rows_smem(rr, d, tr, elem, nst) > ROWS_SMEM:
        nst -= 1
    return nst


def rows_blocks(n_splits: int) -> int:
    """Blocks a (slot, kv head) runs on: the largest divisor of
    ``n_splits`` up to `MAX_BLOCKS`."""
    return max(nb for nb in range(1, MAX_BLOCKS + 1) if n_splits % nb == 0)


@dataclass(frozen=True)
class RowsLaunch:
    """How the rows kernel runs a geometry: ``tile_rows`` kv rows a ring
    stage, ``stages`` stages, ``blocks`` blocks a (slot, kv head) of
    ``per_block`` splits each (block q runs splits q, q + blocks, ...);
    ``smem`` bytes of shared memory a block (`rows_launch_bytes`: at least
    `MERGE_SMEM`, the merge's staging)."""
    tile_rows: int
    stages: int
    blocks: int
    per_block: int
    smem: int


def rows_launch(rr: int, d: int, seg: int, nseg: int, c: int,
                elem: int) -> RowsLaunch:
    """`RowsLaunch` of ``rr`` query rows at head dim ``d`` over ``nseg``
    segments of ``seg`` rows in splits of ``c``."""
    tr, n_splits = rows_tile(seg, rr), nseg // c
    nb = rows_blocks(n_splits)
    spb = n_splits // nb
    nst = rows_stages(rr, d, seg, spb * c * -(-seg // tr), elem)
    smem = (rows_smem(rr, d, tr, elem, nst)
            + (max(ROWS_TAB, spb * c) + 2 * spb + 1) * 4)
    return RowsLaunch(tr, nst, nb, spb, max(-(-smem // 16) * 16, MERGE_SMEM))


def rows_takes(t: int, g: int, d: int, seg: int, elem: int) -> bool:
    """Whether the rows kernel (contiguous decode, T = 1; verify) takes
    ``t * g`` query rows a kv head, head dim ``d`` and kv segments of
    ``seg`` rows (a page or a kv block) of ``elem``-byte values."""
    rr = t * g
    return (1 <= rr <= MAX_ROWS and d % 32 == 0 and 32 <= d <= MAX_ROWS_D
            and seg >= 1
            and rows_smem(rr, d, rows_tile(seg, rr), elem, 2) <= ROWS_SMEM)


@dataclass(frozen=True)
class RowsTile:
    """One stage of a block's walk: logical rows ``row0 .. row0 + rows - 1``
    of segment ``seg`` (the tile's other rows are zero-filled), staged in
    ring stage ``stage``."""
    seg: int
    row0: int
    rows: int
    stage: int


@dataclass(frozen=True)
class RowsSplit:
    """Split ``si`` of a (slot, kv head) in the rows kernel's walk."""
    si: int
    live: bool
    block: int                         # the block that runs it
    segments: tuple[int, ...]          # the C segments the split owns
    tiles: tuple[RowsTile, ...]        # staged, in walk (stage) order


@dataclass(frozen=True)
class RowsProgram:
    """The rows kernel's walk for one (slot, kv head): ``splits`` in split
    order, run by ``launch.blocks`` blocks, each walking its live splits'
    tiles one after another through one ring; ``merge`` the live splits
    whose partials the combine reads, in that order (one live split writes
    the output itself)."""
    launch: RowsLaunch
    splits: tuple[RowsSplit, ...]
    merge: tuple[int, ...]


def rows_program(pos0: int, *, t: int, seg: int, nseg: int, c: int,
                 gapped: bool, window: int | None, g: int = 1, d: int = 128,
                 elem: int = 2) -> RowsProgram:
    """The walk of `rows_kernel` (``csrc/decode_attention.cu``) for a slot
    at ``pos0`` with T query rows at ``pos0 .. pos0 + T - 1``: which
    segments each split owns (si*C + j consecutive, j*(nseg/C) + si
    gapped), which are live, which block runs each, which tiles a live
    split stages, in which ring stage, and which partials the merge
    reads."""
    ln = rows_launch(t * g, d, seg, nseg, c, elem)
    n_splits, tr, nst, nb = nseg // c, ln.tile_rows, ln.stages, ln.blocks
    win = window or 0
    plast, tps = pos0 + t - 1, -(-seg // tr)

    def live_of(si):
        if gapped:
            first = si * seg
            last = ((c - 1) * n_splits + si) * seg + seg - 1
        else:
            first = si * c * seg
            last = (si * c + c - 1) * seg + seg - 1
        return first <= plast and (win <= 0 or last > pos0 - win)

    walked = [0] * nb                  # tiles each block has staged
    splits = []
    for si in sorted(range(n_splits), key=lambda s: (s % nb, s)):
        segs = tuple(j * n_splits + si if gapped else si * c + j
                     for j in range(c))
        tiles = []
        if live_of(si):
            for k in range(c * tps):
                lseg, r0 = segs[k // tps], (k % tps) * tr
                row0, rows = lseg * seg + r0, min(tr, seg - r0)
                if row0 <= plast and (win <= 0
                                      or row0 + rows - 1 > pos0 - win):
                    tiles.append(RowsTile(lseg, row0, rows,
                                          walked[si % nb] % nst))
                    walked[si % nb] += 1
        splits.append(RowsSplit(si, live_of(si), si % nb, segs,
                                tuple(tiles)))
    splits.sort(key=lambda sp: sp.si)
    return RowsProgram(ln, tuple(splits),
                       tuple(sp.si for sp in splits if sp.live))


def rows_instances() -> list[tuple[str, int, int]]:
    """(name, local bytes a thread, registers) of every instance of the
    rows kernel, read from the loaded module."""
    return _build.instances("decode_attention", "split_kv_instance")


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


_TICKETS: dict[int, torch.Tensor] = {}


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    """The rows kernel's counters on ``dev`` for ``n`` (slot, kv head)
    pairs: a ticket each, then the running maxima of its `MAX_ROWS` rows;
    zeros, which every launch leaves zero (its merging block resets its
    own), so none is cleared per call.  Launches that share them run on
    one stream at a time."""
    n *= 1 + MAX_ROWS
    t = _TICKETS.get(dev.index)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1 << 16), dtype=torch.int32, device=dev)
        _TICKETS[dev.index] = t
    return t


def _launch_rows(q, k, v, k_scale, v_scale, block_table, pos0, *, paged,
                 t, seg, nseg, n_pages, c, gapped, window, scale, what):
    """Check the operands of the rows kernel and launch it; returns the
    (B,T,H,D) output."""
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
                         f"a kv head, D a multiple of 32 up to {MAX_ROWS_D} "
                         f"and a block that fits in shared memory "
                         f"({ROWS_SMEM} B), got T={t}, G={g}, D={d}")
    rr, n_splits = t * g, nseg // c
    ln = rows_launch(rr, d, seg, nseg, c, k.element_size())
    if ln.smem > ROWS_SMEM:
        raise ValueError(f"{what} kernel: {ln.per_block * c} segments a "
                         f"block need {ln.smem} B of shared memory, more "
                         f"than {ROWS_SMEM}")
    r4 = -(-rr // 4) * 4                             # m and l rows, acc
    ws = torch.empty(b * hkv * n_splits * (2 * r4 + rr * d),
                     dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    rc = lib.split_kv_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_table.data_ptr() if paged else None, pos0.data_ptr(),
        ws.data_ptr(), _tickets(dev, b * hkv).data_ptr(), out.data_ptr(),
        int(quant), int(paged), b, hkv, g, t, d, n_pages, seg, nseg, c,
        int(gapped), window or 0, ln.stages, ln.blocks, ln.per_block,
        float(scale), torch._C._cuda_getCurrentRawStream(dev.index))
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


def _paged(q, k_pool, v_pool, block_table, pos0, cfg, *, window, scale,
           k_scale, v_scale, what):
    """Check a paged call of the rows kernel (verify, or paged decode at T
    = 1) and run it: its plain version on CPU tensors."""
    cfg = resolve(cfg)
    b, t, h, d = q.shape
    n_pages, ps, hkv, d2 = k_pool.shape
    npp = block_table.shape[1]
    c = cfg.degree
    if d2 != d or v_pool.shape != k_pool.shape \
            or block_table.shape[0] != b or pos0.shape != (b,):
        raise ValueError(
            f"{what} shapes: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(block_table.shape)}, positions {tuple(pos0.shape)}")
    if h % hkv:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads {hkv}")
    if npp % c:
        raise ValueError(f"slot pages {npp} not tileable by degree {c}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _scales(k_scale, v_scale, (n_pages, ps, hkv))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    gapped = cfg.kind == KIND_GAPPED
    if q.device.type == "cpu":
        return ref.verify_split_kv(q, k_pool, v_pool, block_table, pos0,
                                   degree=c, gapped=gapped, window=window,
                                   scale=scale, k_scale=k_scale,
                                   v_scale=v_scale)
    return _launch_rows(q, k_pool, v_pool, k_scale, v_scale, block_table,
                        pos0, paged=True, t=t, seg=ps, nseg=npp,
                        n_pages=n_pages, c=c, gapped=gapped, window=window,
                        scale=scale, what=what)


def paged_decode_attention(q, k_pool, v_pool, block_table, pos,
                           cfg: CoarseningConfig | str = BASE, *,
                           window: int | None = None,
                           scale: float | None = None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B,1,H,D); pools: (P,ps,Hkv,D) shared by every slot; block_table:
    (B,npp) int32 logical->physical page map; pos: (B,) int32 ->
    (B,1,H,D) in q's dtype: `verify_attention` at T = 1 with ``pos0 =
    pos`` (each split owns ``cfg.degree`` pages).  ``k_scale`` /
    ``v_scale`` (P,ps,Hkv) f32 mark int8 pools."""
    global launches, int8_launches
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged decode shapes: q {tuple(q.shape)} is not "
                         f"(B, 1, H, D)")
    out = _paged(q, k_pool, v_pool, block_table, pos, cfg, window=window,
                 scale=scale, k_scale=k_scale, v_scale=v_scale,
                 what="paged decode")
    if q.device.type != "cpu":
        if k_scale is not None:
            int8_launches += 1
        else:
            launches += 1
    return out


def verify_attention(q, k_pool, v_pool, block_table, pos0,
                     cfg: CoarseningConfig | str = BASE, *,
                     window: int | None = None, scale: float | None = None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B,T,H,D), row t at cache position ``pos0[b] + t``; pools:
    (P,ps,Hkv,D); block_table: (B,npp) int32; pos0: (B,) int32 ->
    (B,T,H,D) in q's dtype.  The coarsening axis is the slot's logical
    page axis: each split owns ``cfg.degree`` pages.  ``k_scale`` /
    ``v_scale`` (P,ps,Hkv) f32 mark int8 pools."""
    global verify_launches, verify_int8_launches
    out = _paged(q, k_pool, v_pool, block_table, pos0, cfg, window=window,
                 scale=scale, k_scale=k_scale, v_scale=v_scale,
                 what="verify")
    if q.device.type != "cpu":
        if k_scale is not None:
            verify_int8_launches += 1
        else:
            verify_launches += 1
    return out
