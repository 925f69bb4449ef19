"""RG-LRU (RecurrentGemma) gated linear recurrence, channel-coarsened: the
wrapper of ``rglru_f32`` in ``csrc/rglru.cu`` (it replaces
`repro/kernels/rglru.py` `make_kernel`).

  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(i_t) * x_t)
  a_t = exp(-8 * softplus(a_param) * sigmoid(r_t))

x, r, i (B,S,D) float32 and a_param (D,) float32 -> h (B,S,D) float32.
Time is sequential; channels are the coarsened axis.  A program owns C *
block_d channels: adjacent (consecutive) or C blocks of block_d channels
D/C apart (gapped).  The card's kernel runs one thread a channel and the
recurrence sequentially over all S steps (the Pallas kernel's scan within
block_t steps is a tiling of it).

On CPU tensors the wrapper computes the plain version (`ref.rglru`); on
CUDA tensors it launches the kernel or raises.  ``probe=True`` returns the
owner map: each output element set to the index of the channel program
that writes it, as float32.
"""
from __future__ import annotations

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref

STEPS_AHEAD = 8                     # `csrc/rglru.cu` U: S must tile by it
MAX_THREADS = 1024

launches = 0                        # kernel launches since the last reset


def takes(s: int, cfg: CoarseningConfig, block_d: int = 128) -> bool:
    """Whether the card's kernel takes ``cfg`` (beyond the Pallas kernel's
    raises): one thread a channel, so C * block_d <= 1024, and S a multiple
    of the 8 steps it loads ahead."""
    return (cfg.degree * block_d <= MAX_THREADS and s >= STEPS_AHEAD
            and s % STEPS_AHEAD == 0)


def channel_owners(d: int, cfg: CoarseningConfig,
                   block_d: int) -> torch.Tensor:
    """(D,) int64: the channel program that owns each channel."""
    ch = torch.arange(d)
    if cfg.kind == KIND_GAPPED:
        return (ch % (d // cfg.degree)) // block_d
    return ch // (cfg.degree * block_d)


def make_kernel(b: int, s: int, d: int, cfg: CoarseningConfig | str = BASE,
                *, block_d: int = 128, block_t: int = 64):
    """``run(x, r, i, a_param, probe=False)``, with the Pallas
    `make_kernel`'s raise (`repro/kernels/rglru.py:29-32`)."""
    cfg = resolve(cfg)
    c = cfg.degree
    if d % (c * block_d) or s % block_t:
        raise ValueError("shape not tileable")

    def run(x, r, i, a_param, *, probe: bool = False) -> torch.Tensor:
        global launches
        args = (x, r, i, a_param)
        if any(tuple(t.shape) != (b, s, d) for t in args[:3]) \
                or tuple(a_param.shape) != (d,):
            raise ValueError(f"rglru kernel built for ({b}, {s}, {d}), got "
                             f"{[tuple(t.shape) for t in args]}")
        if all(t.device.type == "cpu" for t in args):
            if probe:
                own = channel_owners(d, cfg, block_d).float()
                return own[None, None, :].expand(b, s, d).contiguous()
            return ref.rglru(x, r, i, a_param)
        if not takes(s, cfg, block_d):
            raise ValueError(f"rglru kernel takes C * block_d <= "
                             f"{MAX_THREADS} and S % {STEPS_AHEAD} == 0, got "
                             f"{cfg.label}, block_d={block_d}, S={s}")
        _build.check_f32_cuda("rglru", args)
        out = torch.empty((b, s, d), dtype=torch.float32, device=x.device)
        rc = _build.library("rglru").rglru_f32(
            *(t.data_ptr() for t in args), out.data_ptr(), b, s, d, c,
            block_d, int(cfg.kind == KIND_GAPPED), int(probe),
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(rc, "rglru_f32")
        launches += 1
        return out

    return run
