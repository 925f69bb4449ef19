"""5-point stencil (Hotspot analog): the wrapper of ``stencil5_f32`` in
``csrc/stencil.cu`` (it replaces `repro/kernels/stencil.py` `make_kernel`).

``o = 0.5 x + 0.125 (up + down + left + right)``, edge-padded, on an f32
(rows, cols) grid.  The plan is `plan_rows(rows, cfg, block_rows)`: a
program owns C row blocks, adjacent (consecutive) or rows/C apart
(gapped); the kernel also tiles the columns over a second grid axis, so
that con8 at 8192 columns still fills the card.  ``vector_width`` gives
each thread V adjacent columns (float2 / float4); ``replication`` splits
the program axis (R, G/R).  The kernel equals `ref.stencil5` bit for bit.
Bound on the H100: 8 * rows * cols bytes / 3.35 TB/s.

On CPU tensors the wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises.  ``probe=True`` returns the owner map: each
element's flat program index as float32 (on the CPU, `row_owners`).
"""
from __future__ import annotations

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         plan_rows, resolve, row_owners)
from repro_torch.kernels import _build, ref

launches = 0                        # kernel launches since the last reset


def stencil5(x: torch.Tensor, cfg: CoarseningConfig | str = BASE, *,
             block_rows: int = 8, probe: bool = False) -> torch.Tensor:
    """(rows, cols) f32 -> (rows, cols) f32 through the coarsened kernel."""
    global launches
    cfg = resolve(cfg)
    if x.dim() != 2:
        raise ValueError(f"stencil5 takes a 2-D grid, got {tuple(x.shape)}")
    rows, cols = x.shape
    plan = plan_rows(rows, cfg, block_rows)
    if x.device.type == "cpu":
        if probe:
            return row_owners(plan).float()[:, None].expand(rows, cols) \
                .contiguous()
        return ref.stencil5(x)
    _build.check_f32_cuda("stencil5", (x,))
    if cols % cfg.vector_width:
        raise ValueError(f"stencil5 kernel: cols {cols} not a multiple of "
                         f"vector width {cfg.vector_width}")
    out = torch.empty_like(x)
    rc = _build.library("stencil").stencil5_f32(
        x.data_ptr(), out.data_ptr(), rows, cols, block_rows, cfg.degree,
        int(cfg.kind == KIND_GAPPED), cfg.replication, cfg.vector_width,
        int(probe), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "stencil5_f32")
    launches += 1
    return out
