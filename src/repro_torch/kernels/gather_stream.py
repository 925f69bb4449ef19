"""Indirect-indexed streaming (paper Fig. 5b): the wrapper of
``gather_stream_f32`` in ``csrc/stream.cu`` (it replaces
`repro/kernels/gather_stream.py` `make_kernel`).

``out[i] = chain(t0[idx[i]], ..., t{L-1}[idx[i]])``, the chain of
`ew_stream` with ``ai * (L + 1)`` ops.  The index stream is coarsened as in
`ew_stream` (`plan_stream`).  The reference keeps each whole table resident
in VMEM (`repro/kernels/gather_stream.py:58-61`); the kernel keeps a window
of every table in shared memory instead, where the ids allow it.

The kernel's walk (`walk` emulates it, decision for decision): about one
persistent thread block an SM, each taking a contiguous range of programs
in program order, and within a program its C rows in order, each cut into
pieces of at most `PIECE_MAX` ids.  A block reads the ids of a batch of
pieces ahead and takes each piece's min and max.  A piece whose ids lie in
the span staged in shared memory is served from it.  Otherwise the block
unites the piece's span with those of the pieces after it (as far as the
next batch) while the union fits the window (`window` entries a table);
it stages that span of every table when the lookups it serves are at least
the 32-byte sectors it moves (ids * 8 >= entries: a direct lookup costs a
sector, a staged line serves 32 entries), else the piece reads the tables
directly.  Gapped rows lie G*B ids apart, so a gapped tile restages a span
for each row or reads directly: the window is lost between them (the
paper's F2).  Replication changes only how the programs are numbered,
which the persistent walk does not see.

Bound on the H100: (idx and out streamed, the touched table entries read
once) / 3.35 TB/s.  `make_indices` is the reference's index generator, a
numpy copy that gives the same indices for a seed.

On CPU tensors the wrapper computes the plain version (`ref.gather_stream`);
on CUDA tensors it launches the kernel or raises.  ``probe=True`` returns
the owner map (see `ew_stream`); ``paths=True`` returns 1.0 for each
element served from the window and 0.0 for each read directly (on the CPU,
`walk`'s).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coarsening import (BASE, DEFAULT_BLOCK, KIND_GAPPED,
                                         CoarseningConfig, plan_stream,
                                         resolve, stream_owners)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import sm_count

MAX_TABLES = 8
# the kernel's constants (`csrc/stream.cu`, namespace `gw`)
PIECE_MAX = 1024                    # ids a piece
BATCH_IDS = 4096                    # ids a batch
BATCH_MAX = 16                      # pieces a batch
WINDOW_BYTES = 139264               # the table window, every table together
STATIC_SMEM = 2048                  # the static shared memory, at most

launches = 0                        # kernel launches since the last reset


def make_indices(n: int, table: int, locality_window: int,
                 seed: int = 0) -> np.ndarray:
    """Paper §III.C index generator (`repro/kernels/gather_stream.py:29`):
    each block of ``locality_window`` stream positions draws from a random
    contiguous table window of that size; window == table is fully random
    (irregularity degree 1)."""
    rng = np.random.default_rng(seed)
    w = max(1, min(locality_window, table))
    n_blocks = (n + w - 1) // w
    bases = rng.integers(0, max(1, table - w), size=n_blocks)
    offs = rng.integers(0, w, size=n)
    blk = np.repeat(bases, w)[:n]
    return ((blk + offs) % table).astype(np.int32)


def piece_size(block: int, vector_width: int) -> int:
    """The largest divisor of the (widened) block that is a multiple of the
    vector width and at most `PIECE_MAX` ids."""
    return next(block // m for m in range(1, block + 1)
                if block % m == 0 and (block // m) % vector_width == 0
                and block // m <= PIECE_MAX)


def window_entries(n_tables: int) -> int:
    """Entries a table the window holds (a multiple of 4)."""
    return WINDOW_BYTES // (4 * n_tables) // 4 * 4


def smem_bytes(n_tables: int) -> int:
    """Dynamic shared memory of a block: the window and two id batches."""
    return 4 * n_tables * window_entries(n_tables) + 2 * 4 * BATCH_IDS


def aligned_span(lo: int, hi: int) -> int:
    """Entries from lo rounded down to 4 to hi rounded up past a multiple
    of 4 (the span's 16-byte copies)."""
    return ((hi | 3) + 1) - (lo & ~3)


@dataclasses.dataclass(frozen=True)
class Walk:
    """The kernel's walk of one call.  Pieces are listed in visit order,
    block after block; ``base`` / ``count`` name the staged span that
    serves a piece (``base`` -1: the piece reads the tables directly) and
    ``restaged`` marks the pieces at which that span was staged."""

    blocks: int
    piece: int
    batch: int
    window: int
    start: torch.Tensor             # (Q,) int64 first stream position
    block: torch.Tensor             # (Q,) int64 the block that serves it
    program: torch.Tensor           # (Q,) int64 the program that owns it
    base: torch.Tensor              # (Q,) int64 staged span's first entry
    count: torch.Tensor             # (Q,) int64 entries a table staged
    restaged: torch.Tensor          # (Q,) bool
    staged: torch.Tensor            # (N,) bool, by stream position


def walk(idx: torch.Tensor, n_tables: int, table_len: int,
         cfg: CoarseningConfig | str = BASE, *, block: int = DEFAULT_BLOCK,
         sms: int = 132) -> Walk:
    """The kernel's walk and window decisions on these ids, emulated on
    the host (`csrc/stream.cu` `gather_window_kernel` and `decide`)."""
    cfg = resolve(cfg)
    plan = plan_stream(idx.shape[0], cfg, block=block)
    g, c, b = plan.grid, cfg.degree, plan.block
    ps = piece_size(b, cfg.vector_width)
    k = max(1, min(BATCH_MAX, BATCH_IDS // ps))
    win = window_entries(n_tables)
    blocks = min(g, sms)
    pps = b // ps
    pieces = idx.long().reshape(-1, ps)
    lo_all, hi_all = pieces.amin(1).tolist(), pieces.amax(1).tolist()
    starts, owners, bases, counts, restaged, served_by = [], [], [], [], [], []
    for blk in range(blocks):
        p0, p1 = g * blk // blocks, g * (blk + 1) // blocks
        qs = []
        for p in range(p0, p1):
            for kk in range(c):
                seg = (kk * g + p) * b if plan.cfg.kind == KIND_GAPPED \
                    else (p * c + kk) * b
                qs += [(seg + j * ps, p) for j in range(pps)]
        lo = [lo_all[s // ps] for s, _ in qs]
        hi = [hi_all[s // ps] for s, _ in qs]
        w_lo, w_hi, w_a = 1 << 31, -1, 0
        nq = len(qs)
        for q in range(nq):
            t = q // k
            starts.append(qs[q][0])
            owners.append(qs[q][1])
            served_by.append(blk)
            if lo[q] >= w_lo and hi[q] <= w_hi:
                bases.append(w_a), counts.append(w_n), restaged.append(False)
                continue
            g_lo, g_hi, m = lo[q], hi[q], 1
            for q2 in range(q + 1, min(nq, (t + 2) * k)):
                nl, nh = min(g_lo, lo[q2]), max(g_hi, hi[q2])
                if aligned_span(nl, nh) > win:
                    break
                g_lo, g_hi, m = nl, nh, m + 1
            span = aligned_span(g_lo, g_hi)
            if span <= win and 8 * m * ps >= span:
                w_lo, w_hi, w_a = g_lo, g_hi, g_lo & ~3
                w_n = min(table_len, (g_hi | 3) + 1) - w_a
                bases.append(w_a), counts.append(w_n), restaged.append(True)
            else:
                bases.append(-1), counts.append(0), restaged.append(False)
    start = torch.tensor(starts, dtype=torch.int64)
    base = torch.tensor(bases, dtype=torch.int64)
    staged = torch.zeros(idx.shape[0], dtype=torch.bool)
    staged.view(-1, ps)[start // ps] = (base >= 0)[:, None]
    return Walk(blocks, ps, k, win, start,
                torch.tensor(served_by, dtype=torch.int64),
                torch.tensor(owners, dtype=torch.int64), base,
                torch.tensor(counts, dtype=torch.int64),
                torch.tensor(restaged), staged)


def emulate(idx: torch.Tensor, tables, w: Walk, *, ai: int) -> torch.Tensor:
    """The kernel's output computed along the walk: a staged piece reads
    copies of its span of every table at ``id - base`` (an index outside
    the copy raises), a direct piece reads the tables."""
    tables = tuple(tables)
    vals = [torch.empty(idx.shape[0]) for _ in tables]
    for s, base, n in zip(w.start.tolist(), w.base.tolist(),
                          w.count.tolist()):
        ids = idx[s:s + w.piece].long()
        for v, t in zip(vals, tables):
            if base < 0:
                v[s:s + w.piece] = t[ids]
            else:
                off = ids - base
                if int(off.min()) < 0 or int(off.max()) >= n:
                    raise IndexError(f"piece at {s} reads outside its "
                                     f"staged span [{base}, {base + n})")
                v[s:s + w.piece] = t[base:base + n].clone()[off]
    return ref._arith_chain(vals, ai * (len(tables) + 1))


def gather_stream(idx, tables, cfg: CoarseningConfig | str = BASE, *,
                  ai: int = 6, block: int = DEFAULT_BLOCK,
                  probe: bool = False, paths: bool = False) -> torch.Tensor:
    """idx (N,) int32 in [0, T), tables (T,) f32 each -> (N,) f32."""
    global launches
    cfg = resolve(cfg)
    tables = tuple(tables)
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"gather_stream takes 1 to {MAX_TABLES} tables, "
                         f"got {len(tables)}")
    if idx.dim() != 1 or any(t.dim() != 1 or t.shape != tables[0].shape
                             for t in tables):
        raise ValueError("gather_stream takes a 1-D index and equal 1-D "
                         "tables")
    n, tlen = idx.shape[0], tables[0].shape[0]
    plan = plan_stream(n, cfg, block=block)
    if idx.device.type == "cpu" and all(t.device.type == "cpu"
                                        for t in tables):
        if probe:
            return stream_owners(plan).float()
        if paths:
            return walk(idx, len(tables), tlen, cfg, block=block).staged \
                .float()
        return ref.gather_stream(tables, idx, ai=ai)
    _build.check_f32_cuda("gather_stream", tables)
    if idx.device != tables[0].device or idx.dtype != torch.int32 \
            or not idx.is_contiguous() or idx.data_ptr() % 16:
        raise ValueError("gather_stream takes a contiguous, 16-byte aligned "
                         "int32 index on the tables' device")
    ps = piece_size(plan.block, cfg.vector_width)
    out = torch.empty(n, dtype=torch.float32, device=idx.device)
    rc = _build.library("stream").gather_stream_f32(
        idx.data_ptr(), _build.pointers(tables), len(tables), out.data_ptr(),
        n, tlen, block, cfg.degree, int(cfg.kind == KIND_GAPPED),
        cfg.vector_width, ai * (len(tables) + 1), 2 if paths else int(probe),
        min(plan.grid, sm_count(idx.device)), ps,
        max(1, min(BATCH_MAX, BATCH_IDS // ps)), window_entries(len(tables)),
        torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check(rc, "gather_stream_f32")
    launches += 1
    return out
