"""Mamba-2 SSD (state-space duality), chunked and head-coarsened: the
wrapper of ``ssd_f32`` in ``csrc/ssd.cu`` (it replaces
`repro/kernels/ssd.py` `make_kernel`).

Kernel layout: x (B,H,S,P), dt (B,H,S), a (H,), B and C (B,G,S,N), all
float32 -> y (B,H,S,P) float32.  The chunk axis is sequential; the
coarsened axis is heads.  A program owns C heads: adjacent (consecutive,
``[hh*C, hh*C + C)``, which lie in one group and share its B/C tile) or
H/C apart (gapped, ``{k*(H/C) + hh}``, only with one group).

The card's kernel keeps every head's (N, P) state in a global workspace of
(B, H, N, P) float32 that the wrapper allocates, and stages one head's
state in shared memory at a time: the C states of a program do not fit in
a block's shared memory beside the chunk's tiles (con4 at N 128, P 64
would need 128 KB of state alone), and so every label the Pallas kernel
takes is taken (`takes` limits only the chunk's tiles).

On CPU tensors the wrapper computes the plain version (`ref.ssd`, in the
reference's (B,S,H,P) layout: transposed in and out, as
`repro/kernels/ops.py:629-636`); on CUDA tensors it launches the kernel or
raises.  ``probe=True`` returns the owner map: each output element set to
the index of the head program that writes it, as float32.
"""
from __future__ import annotations

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref

launches = 0                        # kernel launches since the last reset


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """Shared memory of one block (`csrc/ssd.cu` `smem_floats`): B, B^T,
    C^T, C.B^T, W^T (rows padded by 4 floats), x, one state and 4 chunk
    vectors."""
    return 4 * (chunk * (n + 4) + 2 * n * (chunk + 4) + 2 * chunk * (chunk + 4)
                + chunk * (p + 4) + n * (p + 4) + 4 * chunk)


def takes(h: int, g: int, n: int, p: int, chunk: int,
          cfg: CoarseningConfig) -> bool:
    """Whether the card's kernel takes this geometry under ``cfg`` (beyond
    the Pallas kernel's raises, which `make_kernel` keeps): 4-wide tiles of
    N and P, a chunk the prefix-sum warp splits evenly (a multiple of 32),
    and the chunk's tiles within a block's shared memory.  The degree does
    not enter: the states live in the workspace."""
    del h, g, cfg
    return (n >= 4 and n % 4 == 0 and p >= 4 and p % 4 == 0
            and chunk >= 32 and chunk % 32 == 0
            and smem_bytes(chunk, n, p) <= _build.MAX_SMEM)


def head_owners(h: int, cfg: CoarseningConfig) -> torch.Tensor:
    """(H,) int64: the head program that owns each head."""
    c = cfg.degree
    heads = torch.arange(h)
    return heads % (h // c) if cfg.kind == KIND_GAPPED else heads // c


def make_kernel(b: int, h: int, g: int, s: int, p: int, n: int,
                cfg: CoarseningConfig | str = BASE, *, chunk: int = 64):
    """``run(x, dt, a, bmat, cmat, probe=False)`` in the kernel layout,
    with the Pallas `make_kernel`'s raises (`repro/kernels/ssd.py:37-44`)."""
    cfg = resolve(cfg)
    c = cfg.degree
    rep = h // g
    gapped = cfg.kind == KIND_GAPPED
    if s % chunk:
        raise ValueError("seq not divisible by chunk")
    if gapped and g != 1:
        raise ValueError("gapped head-coarsening requires n_groups == 1")
    if not gapped and c > 1 and rep % c != 0:
        raise ValueError("consecutive head-coarsening requires group_size "
                         "% C == 0")
    if h % c:
        raise ValueError("heads not divisible by degree")

    def run(x, dt, a, bmat, cmat, *, probe: bool = False) -> torch.Tensor:
        global launches
        args = (x, dt, a, bmat, cmat)
        shapes = ((b, h, s, p), (b, h, s), (h,), (b, g, s, n), (b, g, s, n))
        if tuple(tuple(t.shape) for t in args) != shapes:
            raise ValueError(f"ssd kernel built for {shapes}, got "
                             f"{[tuple(t.shape) for t in args]}")
        if all(t.device.type == "cpu" for t in args):
            if probe:
                own = head_owners(h, cfg).float()
                return own[None, :, None, None].expand(b, h, s, p) \
                    .contiguous()
            y = ref.ssd(x.transpose(1, 2), dt.transpose(1, 2), a,
                        bmat.transpose(1, 2), cmat.transpose(1, 2),
                        chunk=chunk)
            return y.transpose(1, 2).contiguous()
        if not takes(h, g, n, p, chunk, cfg):
            raise ValueError(f"ssd kernel takes N and P multiples of 4 and a "
                             f"chunk a multiple of 32 whose tiles fit "
                             f"{_build.MAX_SMEM} bytes, got N={n}, P={p}, "
                             f"chunk={chunk} ({smem_bytes(chunk, n, p)} "
                             f"bytes)")
        _build.check_f32_cuda("ssd", args)
        y = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
        ws = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
        rc = _build.library("ssd").ssd_f32(
            *(t.data_ptr() for t in args), y.data_ptr(), ws.data_ptr(),
            b, h, g, s, p, n, chunk, c, int(gapped), int(probe),
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(rc, "ssd_f32")
        launches += 1
        return y

    return run
