"""Coarsened blocked matmul: the wrapper of the CUDA kernel in
``csrc/matmul.cu`` (it replaces `repro/kernels/matmul.py` `make_kernel`).

A thread block owns C row blocks of ``BM`` rows, adjacent (consecutive) or
M/C rows apart (gapped), and ``BN * vector_width`` columns; the B tile of
each contraction step is staged in shared memory once and shared by all C
row blocks.  bf16 inputs, float32 accumulation and output, as the Pallas
kernel.  Bound on the H100: max(2mnk / 989 TFLOP/s, bytes / 3.35 TB/s);
see the source for what the design does about it.

On CPU tensors the wrapper computes the plain version (`ref.matmul`); on
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.coarsening import KIND_GAPPED, CoarseningConfig, resolve
from repro_torch.kernels import _build, ref

BM, BN, BK = 64, 64, 32             # the kernel's row, column and depth tiles
MAX_TILE_PRODUCT = 4                # degree * vector_width, register budget

launches = 0                        # kernel launches since the last reset


def tileable(m: int, n: int, k: int, cfg: CoarseningConfig) -> bool:
    """Whether the kernel takes an (m,k) @ (k,n) product under ``cfg``."""
    c, vw = cfg.degree, cfg.vector_width
    return (c in (1, 2, 4) and vw in (1, 2, 4)
            and c * vw <= MAX_TILE_PRODUCT
            and m % (c * BM) == 0 and n % (BN * vw) == 0 and k % BK == 0)


def coarsened_matmul(a: torch.Tensor, b: torch.Tensor,
                     cfg: CoarseningConfig | str = "auto") -> torch.Tensor:
    """(m,k) @ (k,n) -> (m,n) float32 through the coarsened kernel."""
    global launches
    cfg = resolve(cfg)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if not tileable(m, n, k, cfg):
        raise ValueError(
            f"matmul ({m},{n},{k}) under {cfg.label} is not tileable by the "
            f"kernel: needs degree, vector_width in (1,2,4) with product <= "
            f"{MAX_TILE_PRODUCT}, m % (degree*{BM}), n % ({BN}*vector_width), "
            f"k % {BK}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.matmul(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul operands on {a.device} and {b.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul kernel takes bf16, got {a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous operands")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("matmul kernel needs 16-byte aligned operands")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    lib = _build.library("matmul")
    rc = lib.coarsened_matmul_bf16(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, cfg.degree,
        cfg.vector_width, int(cfg.kind == KIND_GAPPED),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "coarsened_matmul_bf16")
    launches += 1
    return out
