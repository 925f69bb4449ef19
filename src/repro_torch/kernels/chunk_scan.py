"""DP min-scan (Pathfinder analog): the wrapper of ``dp_scan_f32`` in
``csrc/chunk_scan.cu`` (it replaces `repro/kernels/chunk_scan.py`
`make_kernel`).

``dist[t] = cost[t] + min(dist[t-1] shifted -1/0/+1)``, row 0 = cost[0],
on an f32 (rows, cols) grid.  Each row needs the whole previous row, so
one call is rows/C launches on the caller's stream (C = 1 for base, the
degree for consecutive conC), each computing C rows over column tiles with
a ghost zone of C columns a side (Rodinia's pyramid).  Gapped coarsening
raises ``ValueError``, as the reference does: it breaks the carry.
Replication and vector width are not read (the reference's kernel reads
neither).  The kernel equals `ref.dp_scan` bit for bit.  Bound on the
H100: 8 * rows * cols bytes / 3.35 TB/s.

On CPU tensors the wrapper computes the plain version; on CUDA tensors it
launches the kernels or raises.  ``launches`` counts kernel launches, so
one call adds rows/C.
"""
from __future__ import annotations

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref

launches = 0                        # kernel launches since the last reset


def dp_scan(cost: torch.Tensor,
            cfg: CoarseningConfig | str = BASE) -> torch.Tensor:
    """(rows, cols) f32 -> (rows, cols) f32."""
    global launches
    cfg = resolve(cfg)
    if cfg.kind == KIND_GAPPED:
        raise ValueError("gapped coarsening breaks the sequential carry of a "
                         "DP scan (paper: barrier kernels favour replication)")
    if cost.dim() != 2:
        raise ValueError(f"dp_scan takes a 2-D grid, got {tuple(cost.shape)}")
    rows, cols = cost.shape
    c = cfg.degree
    if rows % c:
        raise ValueError("rows not divisible by degree")
    if cost.device.type == "cpu":
        return ref.dp_scan(cost)
    _build.check_f32_cuda("dp_scan", (cost,))
    out = torch.empty_like(cost)
    rc = _build.library("chunk_scan").dp_scan_f32(
        cost.data_ptr(), out.data_ptr(), rows, cols, c,
        torch.cuda.current_stream(cost.device).cuda_stream)
    _build.check(rc, "dp_scan_f32")
    launches += rows // c
    return out
