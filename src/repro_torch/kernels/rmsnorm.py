"""Row RMSNorm of the decode and verify steps, and their q/k norms with
RoPE: the wrappers of ``rmsnorm_bf16`` and ``qk_norm_rope_bf16`` in
``csrc/rmsnorm.cu``.

It replaces no Pallas kernel (the reference's `rmsnorm`,
`repro/models/layers.py:87`, is plain jnp).  It exists for batch
invariance: PyTorch's reduction over the last dim sizes its blocks by the
row count, so a row normalised in a decode step (B rows) and in a verify
pass (B*T rows) may round otherwise.  The kernel sums each row in one
order, one warp a row, whatever the row count or the row's place.  Bound
on the H100: the bytes, 4 * rows * d + 4 * d, at 3.35 TB/s.

Since the norms that a product reads became that product's prologue
(`matmul.step_matmul` with ``norm``), the row norm serves an MoE layer's
ln2 only, which the router, the experts and the shared expert read.

`qk_norm_rope` is one launch for a step's q and k: one warp a (row, head)
normalises the head over D as the row norm does (the same lane walk and
shuffle tree, skipped without qk-norm), rounds it to bf16 and rotates its
interleaved pairs with `rope`'s operations in its order, cos and sin of
``pos * freqs`` computed in the kernel (`cosf`, `sinf`).  Its output
equals the row norm kernel then `layers.apply_rope` bit for bit.  Bound:
the bytes, 4 * (q + k elements) + the scales, freqs and positions.

On CPU tensors the wrappers compute the plain versions (`ref.rmsnorm`,
`ref.qk_norm_rope`: the reference's arithmetic in PyTorch); on CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0                        # kernel launches since the last reset
qk_launches = 0                     # `qk_norm_rope` launches since then
MAX_HEAD = 256                      # the head dims `qk_norm_rope` takes


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


def qk_takes(d: int) -> bool:
    """Whether `qk_norm_rope` takes heads of ``d`` values: one 16-byte
    chunk a lane."""
    return 8 <= d <= MAX_HEAD and d % 8 == 0


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, pos: torch.Tensor,
                 q_scale, k_scale, eps: float, theta: float):
    """A decode or verify step's q (..., H, D) and k (..., Hkv, D), their
    leading dims (B, T) or B * T, the rows of ``pos`` (B, T) int -> (q, k)
    in their shapes, normed per head (q_scale, k_scale (D,) float32, or
    both None: RoPE only) and rotated at ``pos`` with
    `ref.rope_freqs(D, theta)`, in one launch."""
    global qk_launches
    d = q.shape[-1]
    if k.shape[-1] != d or pos.dim() != 2 or q.shape[:-2].numel() != \
            pos.numel() or k.shape[:-2].numel() != pos.numel():
        raise ValueError(f"qk_norm_rope: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} for positions "
                         f"{tuple(pos.shape)}")
    if (q_scale is None) != (k_scale is None) or (
            q_scale is not None and (q_scale.shape != (d,)
                                     or k_scale.shape != (d,))):
        raise ValueError("qk_norm_rope: q and k scales of (D,) or neither")
    freqs = ref.rope_freqs(d, theta, q.device)
    if q.device.type == "cpu":
        return ref.qk_norm_rope(q, k, pos, q_scale, k_scale, eps, freqs)
    if not qk_takes(d):
        raise ValueError(f"qk_norm_rope kernel takes D % 8 == 0 up to "
                         f"{MAX_HEAD}, got D={d}")
    norm = q_scale is not None
    ops_ = (q, k, pos) + ((q_scale, k_scale) if norm else ())
    if q.device.type != "cuda" or any(t.device != q.device for t in ops_):
        raise ValueError("qk_norm_rope operands must share one CUDA device")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or (
            norm and (q_scale.dtype != torch.float32
                      or k_scale.dtype != torch.float32)) \
            or pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"qk_norm_rope kernel takes bf16 q and k, float32 "
                        f"scales and int32 or int64 positions, got "
                        f"{q.dtype}, {k.dtype}, {pos.dtype}")
    qc, kc, pc = q.contiguous(), k.contiguous(), pos.contiguous()
    sq, sk = (q_scale.contiguous(), k_scale.contiguous()) if norm else (
        freqs, freqs)
    if any(t.data_ptr() % 16 for t in (qc, kc, sq, sk)):
        raise ValueError("qk_norm_rope kernel takes 16-byte aligned "
                         "operands")
    qo, ko = torch.empty_like(qc), torch.empty_like(kc)
    rc = _build.library("rmsnorm").qk_norm_rope_bf16(
        qc.data_ptr(), kc.data_ptr(), sq.data_ptr(), sk.data_ptr(),
        freqs.data_ptr(), pc.data_ptr(), qo.data_ptr(), ko.data_ptr(),
        pos.numel(), q.shape[-2], k.shape[-2], d, int(norm),
        int(pos.dtype == torch.int64), float(eps),
        torch._C._cuda_getCurrentRawStream(q.device.index))
    _build.check(rc, "qk_norm_rope_bf16")
    qk_launches += 1
    return qo, ko
