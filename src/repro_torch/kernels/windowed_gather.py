"""Windowed gather, the paper's cached LSU (Fig. 5b / Fig. 12): the wrapper
of ``windowed_gather_f32`` in ``csrc/windowed_gather.cu`` (it replaces
`repro/kernels/windowed_gather.py` `make_kernel`).

``out[i] = chain(tbl[idx[i]])`` with ``2 * ai`` ops, for ids (N,) int32
from `gather_stream.make_indices(N, T, window)` and a (T,) float32 table.
The id stream is planned as a stream (`plan_stream(N, cfg, block)`): a
program owns C slices of ``plan.block`` ids.  A host planner (`plan_bases`,
the reference's) picks one L-aligned base row of the (T/L, L) table view
per (program, slice); the kernel stages rows base and base + 1, a 2L-wide
window that covers the slice's ids, and gathers from it.  Replication
changes nothing here, as in the reference (its grid is the plan's).

Two deviations from the reference, stated (ROADMAP Queue 3 item 3):

* A slice longer than the window (``plan.block > window``, e.g. simd8 at
  window 1024 and block 256) spans two locality runs, so its ids need not
  lie in one 2L window; the reference computes wrong values there
  silently.  The port raises `ValueError` (also when ``window %
  plan.block``, where a slice can straddle two runs).
* ``table == window`` gives the planner's base row -1 (``n_rows - 2``);
  the kernel clamps window rows into [0, T/L), which reads what the Pallas
  kernel's clamped block index reads: the right values.

The card's kernel stages a 2L window of float32 in shared memory, so it
takes windows up to the block's shared memory (`takes`); row 16's fully
random cell (window = table = 2^24) is outside it.

``run(idx, tbl, bases=None)``: with ``bases=None`` it plans on every call,
as the reference does; a caller may plan once with ``run.plan_bases(idx)``
and pass the (G, C) int32 bases (on the ids' device) to time the launch
alone.  On CPU tensors it computes the plain version
(`ref.windowed_gather`); on CUDA tensors it launches the kernel or raises.
``probe=True`` returns the owner map (the plan's `stream_owners`).  Ids
outside their slice's window are outside the contract, as in the
reference: the kernel clamps their offset into the window and reads a
wrong value, never out of bounds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coarsening import (BASE, CoarseningConfig, plan_stream,
                                         resolve, stream_owners)
from repro_torch.kernels import _build, ref

launches = 0                        # kernel launches since the last reset


def takes(window: int) -> bool:
    """Whether the card's kernel can stage a window of ``window`` floats:
    2 rows of float32 in one block's shared memory, moved 16 bytes at a
    time."""
    return window % 4 == 0 and 2 * window * 4 <= _build.MAX_SMEM


def make_kernel(n: int, table: int, cfg: CoarseningConfig | str = BASE, *,
                window: int = 1024, block: int = 256, ai: int = 6):
    """``run(idx, tbl, bases=None, probe=False)`` with ``run.plan_bases``,
    with the Pallas `make_kernel`'s raise (`repro/kernels/
    windowed_gather.py:39-41`) and the port's refusal of slices longer
    than the window."""
    cfg = resolve(cfg)
    if block > window or window % block or table % window:
        raise ValueError("need block <= window, window % block == 0, "
                         "table % window == 0")
    plan = plan_stream(n, cfg, block=block)
    if plan.block > window or window % plan.block:
        raise ValueError(f"{cfg.label}: a slice of {plan.block} ids (block x "
                         f"vector width) must divide the window of {window}, "
                         f"or its ids need not lie in one 2L window")
    c, n_rows = cfg.degree, table // window

    def plan_bases(idx) -> np.ndarray:
        """Host-side planner (`repro/kernels/windowed_gather.py:87-95`):
        the window base row of each (program, slice), (G, C) int32."""
        view = np.asarray(idx).reshape(plan.view_shape)
        mins = view.min(axis=2) if plan.contiguous else view.min(axis=2).T
        bases = np.minimum(mins // window, n_rows - 2).astype(np.int32)
        return np.ascontiguousarray(bases)          # gapped: mins.T

    def run(idx, tbl, bases=None, *, probe: bool = False) -> torch.Tensor:
        global launches
        if tuple(idx.shape) != (n,) or tuple(tbl.shape) != (table,):
            raise ValueError(f"windowed_gather built for ({n},) ids and a "
                             f"({table},) table, got {tuple(idx.shape)} and "
                             f"{tuple(tbl.shape)}")
        if idx.device.type == "cpu" and tbl.device.type == "cpu":
            if probe:
                return stream_owners(plan).float()
            return ref.windowed_gather(idx, tbl, ai)
        if not takes(window):
            raise ValueError(f"windowed_gather kernel stages 2 x {window} "
                             f"float32 in shared memory, over its "
                             f"{_build.MAX_SMEM} bytes (or not a multiple "
                             f"of 4)")
        _build.check_f32_cuda("windowed_gather", (tbl,))
        if idx.device != tbl.device or idx.dtype != torch.int32 \
                or not idx.is_contiguous():
            raise ValueError("windowed_gather takes contiguous int32 ids on "
                             "the table's device")
        if bases is None:
            bases = torch.from_numpy(plan_bases(idx.cpu().numpy())).to(
                idx.device)
        if tuple(bases.shape) != (plan.grid, c) or bases.dtype != torch.int32 \
                or bases.device != idx.device or not bases.is_contiguous():
            raise ValueError(f"bases must be a contiguous ({plan.grid}, {c}) "
                             f"int32 tensor on the ids' device")
        out = torch.empty(n, dtype=torch.float32, device=idx.device)
        rc = _build.library("windowed_gather").windowed_gather_f32(
            idx.data_ptr(), tbl.data_ptr(), bases.data_ptr(), out.data_ptr(),
            n, table, window, plan.block, c, int(not plan.contiguous),
            2 * ai, int(probe),
            torch.cuda.current_stream(idx.device).cuda_stream)
        _build.check(rc, "windowed_gather_f32")
        launches += 1
        return out

    run.plan_bases = plan_bases
    run.plan = plan
    return run
