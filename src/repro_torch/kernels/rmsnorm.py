"""Row RMSNorm of the decode and verify steps: the wrapper of
``rmsnorm_bf16`` in ``csrc/rmsnorm.cu``.

It replaces no Pallas kernel (the reference's `rmsnorm`,
`repro/models/layers.py:87`, is plain jnp).  It exists for batch
invariance: PyTorch's reduction over the last dim sizes its blocks by the
row count, so a row normalised in a decode step (B rows) and in a verify
pass (B*T rows) may round otherwise.  The kernel sums each row in one
order, one warp a row, whatever the row count or the row's place.  Bound
on the H100: the bytes, 4 * rows * d + 4 * d, at 3.35 TB/s.

On CPU tensors the wrapper computes the plain version (`ref.rmsnorm`, the
reference's arithmetic in PyTorch); on CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0                        # kernel launches since the last reset


def takes(d: int) -> bool:
    """Whether the kernel takes rows of ``d`` values (16-byte chunks)."""
    return d >= 8 and d % 8 == 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) float32 -> x * rsqrt(mean(x^2) + eps) * (1 +
    scale) in x's dtype, float32 statistics."""
    global launches
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} for rows of "
                         f"{d}")
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    if not takes(d):
        raise ValueError(f"rmsnorm kernel takes d % 8 == 0, got d={d}")
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("rmsnorm operands must share one CUDA device")
    if x.dtype != torch.bfloat16 or scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes bf16 rows and a float32 "
                        f"scale, got {x.dtype}, {scale.dtype}")
    xc = x.contiguous()
    if xc.data_ptr() % 16 or not scale.is_contiguous() \
            or scale.data_ptr() % 16:
        raise ValueError("rmsnorm kernel takes 16-byte aligned operands")
    out = torch.empty_like(xc)
    rc = _build.library("rmsnorm").rmsnorm_bf16(
        xc.data_ptr(), scale.data_ptr(), out.data_ptr(), xc.numel() // d, d,
        float(eps), torch._C._cuda_getCurrentRawStream(x.device.index))
    _build.check(rc, "rmsnorm_bf16")
    launches += 1
    return out
