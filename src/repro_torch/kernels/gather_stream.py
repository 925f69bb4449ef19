"""Indirect-indexed streaming (paper Fig. 5b): the wrapper of
``gather_stream_f32`` in ``csrc/stream.cu`` (it replaces
`repro/kernels/gather_stream.py` `make_kernel`).

``out[i] = chain(t0[idx[i]], ..., t{L-1}[idx[i]])``, the chain of
`ew_stream` with ``ai * (L + 1)`` ops.  The index stream is coarsened as in
`ew_stream` (`plan_stream`); the tables are read from device memory through
the cache hierarchy (L1 / L2), where the reference keeps each whole table
resident in VMEM — only "for interpret-mode correctness"
(`repro/kernels/gather_stream.py:10-15`).  Bound on the H100: (idx and out
streamed, the touched table entries read once) / 3.35 TB/s.

`make_indices` is the reference's index generator, a numpy copy that gives
the same indices for a seed.

On CPU tensors the wrapper computes the plain version (`ref.gather_stream`);
on CUDA tensors it launches the kernel or raises.  ``probe=True`` returns
the owner map (see `ew_stream`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coarsening import (BASE, DEFAULT_BLOCK, KIND_GAPPED,
                                         CoarseningConfig, plan_stream,
                                         resolve, stream_owners)
from repro_torch.kernels import _build, ref

MAX_TABLES = 8

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


def gather_stream(idx, tables, cfg: CoarseningConfig | str = BASE, *,
                  ai: int = 6, block: int = DEFAULT_BLOCK,
                  probe: bool = False) -> torch.Tensor:
    """idx (N,) int32, tables (T,) f32 each -> (N,) f32."""
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
    n = idx.shape[0]
    plan = plan_stream(n, cfg, block=block)
    if idx.device.type == "cpu" and all(t.device.type == "cpu"
                                        for t in tables):
        if probe:
            return stream_owners(plan).float()
        return ref.gather_stream(tables, idx, ai=ai)
    _build.check_f32_cuda("gather_stream", tables)
    if idx.device != tables[0].device or idx.dtype != torch.int32 \
            or not idx.is_contiguous() or idx.data_ptr() % 16:
        raise ValueError("gather_stream takes a contiguous, 16-byte aligned "
                         "int32 index on the tables' device")
    out = torch.empty(n, dtype=torch.float32, device=idx.device)
    rc = _build.library("stream").gather_stream_f32(
        idx.data_ptr(), _build.pointers(tables), len(tables), out.data_ptr(),
        n, block, cfg.degree, int(cfg.kind == KIND_GAPPED), cfg.replication,
        cfg.vector_width, ai * (len(tables) + 1), int(probe),
        torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check(rc, "gather_stream_f32")
    launches += 1
    return out
