"""The paper's Fig. 6 streaming microbenchmark: the wrapper of
``ew_stream_f32`` in ``csrc/stream.cu`` (it replaces the Pallas kernel that
`repro/core/coarsening.py` `pallas_stream_call` builds for
`repro/kernels/ew_stream.py` `make_kernel`).

``n_loads = len(inputs)`` f32 streams of N elements (1 to 8) go through a
chain of ``ai * (n_loads + 1)`` ops under one of the seven divergence
``VARIANTS`` into one f32 stream.  The plan is `plan_stream(N, cfg, block)`:
a thread block owns the program's (C, B*V) tile, rows adjacent
(consecutive) or G*B*V elements apart (gapped); V-wide vector loads
(simd), an (R, G/R) grid (pipe).  The kernel equals the plain version
(`ref.ew_stream`) bit for bit.  Bound on the H100: bytes / 3.35 TB/s
against ops / 67 TFLOP/s (fp32); the bytes bind at every AI the paper
uses.

On CPU tensors the wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises.  ``probe=True`` returns the owner map
instead: each element's flat program index as float32 (on the CPU, the
plan's own map, `stream_owners`).
"""
from __future__ import annotations

import torch

from repro_torch.core.coarsening import (BASE, DEFAULT_BLOCK, KIND_GAPPED,
                                         CoarseningConfig, plan_stream,
                                         resolve, stream_owners)
from repro_torch.kernels import _build, ref

MAX_LOADS = 8

launches = 0                        # kernel launches since the last reset


def ew_stream(inputs, cfg: CoarseningConfig | str = BASE, *, ai: int = 6,
              variant: str = "base", block: int = DEFAULT_BLOCK,
              probe: bool = False) -> torch.Tensor:
    """(N,) f32 streams -> (N,) f32 through the coarsened kernel."""
    global launches
    cfg = resolve(cfg)
    inputs = tuple(inputs)
    if variant not in ref.VARIANTS:
        raise ValueError(f"variant must be in {ref.VARIANTS}")
    if not 1 <= len(inputs) <= MAX_LOADS:
        raise ValueError(f"ew_stream takes 1 to {MAX_LOADS} streams, got "
                         f"{len(inputs)}")
    if variant == "for_in_if_in" and len(inputs) < 2:
        raise ValueError("for_in_if_in reads two streams (its bound and its "
                         "predicate)")
    n = inputs[0].shape[0]
    if any(x.shape != (n,) for x in inputs):
        raise ValueError(f"ew_stream streams must all be ({n},)")
    plan = plan_stream(n, cfg, block=block)
    dev = inputs[0].device
    if all(x.device.type == "cpu" for x in inputs):
        if probe:
            return stream_owners(plan).float()
        return ref.ew_stream(inputs, ai=ai, variant=variant)
    _build.check_f32_cuda("ew_stream", inputs)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    ptrs = _build.pointers(inputs)
    rc = _build.library("stream").ew_stream_f32(
        ptrs, len(inputs), out.data_ptr(), n, block, cfg.degree,
        int(cfg.kind == KIND_GAPPED), cfg.replication, cfg.vector_width,
        ref.VARIANTS.index(variant), ai * (len(inputs) + 1), int(probe),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "ew_stream_f32")
    launches += 1
    return out
