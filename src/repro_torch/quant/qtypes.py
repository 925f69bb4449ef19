"""Weight-only quantization formats: per-channel int8 and group-wise int4.

A copy of `repro.quant.qtypes` on PyTorch tensors (the port imports
nothing of the JAX package).  Payloads and scales equal the reference's
bit for bit: scales are divided by, never multiplied by a reciprocal, and
`torch.round` rounds half to even as `jnp.round` does.

Formats
-------
int8  per-(output-)channel symmetric: for a weight laid out (..., K, N) with
      K the contraction axis, ``scale = absmax over K / 127`` has shape
      (..., 1, N); the payload is int8 of the same logical shape.

int4  group-wise symmetric: the contraction axis is cut into groups of
      ``group`` rows; ``scale`` has shape (..., K/group, N) and the payload
      packs two 4-bit values per byte along K -> (..., K/2, N) uint8.
      Values are stored offset-binary (q + 8 in [1, 15]), even rows in the
      low nibble; the symmetric range is [-7, 7].

``QTensor`` is a plain frozen dataclass (the reference registers it as a
pytree); the port's parameter trees are dicts of tensors and QTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

INT8_QMAX = 127.0
INT4_QMAX = 7.0
DEFAULT_GROUP = 32

# param-dict keys quantize_params converts (FFN + MoE expert weights +
# attention projections); everything else — embeddings, lm_head, norms,
# router, shared-expert gate — stays dense.
QUANT_KEYS = frozenset({"w1", "w3", "w2", "wq", "wk", "wv", "wo"})


@dataclasses.dataclass(frozen=True)
class QTensor:
    """A quantized weight: packed payload + scales + static metadata.

    q      int8 payload (int8 mode) or uint8 nibble-packed payload (int4)
    scale  f32 scales: (..., 1, N) per-channel / (..., K/group, N) grouped
    bits   8 | 4
    group  contraction-group size (0 for per-channel int8)
    shape  the LOGICAL (unpacked, dense) weight shape
    """

    q: torch.Tensor
    scale: torch.Tensor
    bits: int
    group: int
    shape: tuple

    @property
    def nbytes(self) -> int:
        return int(self.q.numel() * self.q.element_size()
                   + self.scale.numel() * self.scale.element_size())


# -- int4 nibble packing ------------------------------------------------------

def pack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack int values in [-7, 7] two-per-byte along ``axis`` (offset-binary:
    stored nibble = q + 8).  The packed axis must have even length."""
    k = q.shape[axis]
    if k % 2:
        raise ValueError(f"int4 pack axis length {k} must be even")
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    lo, hi = _stride2(u, axis, 0), _stride2(u, axis, 1)
    return lo | (hi << 4)


def _stride2(u: torch.Tensor, axis: int, start: int) -> torch.Tensor:
    idx = [slice(None)] * u.dim()
    idx[axis % u.dim()] = slice(start, None, 2)
    return u[tuple(idx)]


def unpack_int4(packed: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of pack_int4: (..., K/2, ...) uint8 -> (..., K, ...) f32 in
    [-7, 7] (even logical rows from the low nibble, odd from the high)."""
    lo = (packed & 0xF).float() - 8.0
    hi = (packed >> 4).float() - 8.0
    ax = axis % packed.dim()
    stacked = torch.stack([lo, hi], dim=ax + 1)       # (..., K/2, 2, ...)
    shape = list(packed.shape)
    shape[ax] = 2 * shape[ax]
    return stacked.reshape(shape)


# -- quantize / dequantize ----------------------------------------------------

def _absmax(w: torch.Tensor, axis: int, keepdims: bool = True):
    return torch.clamp(w.float().abs().amax(dim=axis, keepdim=keepdims),
                       min=1e-8)


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Per-channel symmetric int8 over the contraction axis (-2)."""
    if w.dim() < 2:
        raise ValueError(f"need a >=2-D weight, got shape {tuple(w.shape)}")
    scale = _absmax(w, axis=-2) / INT8_QMAX               # (..., 1, N)
    q = torch.clamp(torch.round(w.float() / scale), -INT8_QMAX,
                    INT8_QMAX).to(torch.int8)
    return QTensor(q=q, scale=scale.float(), bits=8, group=0,
                   shape=tuple(w.shape))


def quantize_int4(w: torch.Tensor, group: int = DEFAULT_GROUP) -> QTensor:
    """Group-wise symmetric int4 along the contraction axis (-2), packed
    two-per-byte."""
    if w.dim() < 2:
        raise ValueError(f"need a >=2-D weight, got shape {tuple(w.shape)}")
    k, n = w.shape[-2], w.shape[-1]
    if group < 2 or group % 2:
        raise ValueError(f"int4 group must be even and >= 2, got {group}")
    if k % group:
        raise ValueError(f"contraction dim {k} not divisible by group {group}")
    lead = tuple(w.shape[:-2])
    wg = w.float().reshape(lead + (k // group, group, n))
    scale = _absmax(wg, axis=-2) / INT4_QMAX              # (..., K/g, 1, N)
    q = torch.clamp(torch.round(wg / scale), -INT4_QMAX, INT4_QMAX)
    q = q.reshape(lead + (k, n)).to(torch.int8)
    return QTensor(q=pack_int4(q, axis=-2),
                   scale=scale.reshape(lead + (k // group, n)).float(),
                   bits=4, group=group, shape=tuple(w.shape))


def quantize(w: torch.Tensor, mode: str, group: int = DEFAULT_GROUP):
    if mode == "int8":
        return quantize_int8(w)
    if mode == "int4":
        return quantize_int4(w, group=group)
    raise ValueError(f"unknown quant mode {mode!r} (want 'int8' or 'int4')")


def dequantize(qt: QTensor) -> torch.Tensor:
    """QTensor -> dense f32 of the logical shape (the parity oracle every
    fused dequant kernel is tested against)."""
    if qt.bits == 8:
        return qt.q.float() * qt.scale
    vals = unpack_int4(qt.q, axis=-2)                     # (..., K, N)
    return vals * torch.repeat_interleave(qt.scale, qt.group, dim=-2)


def asdense(w, dtype=None):
    """QTensor -> dequantized dense tensor; dense tensor -> (cast)
    passthrough."""
    out = dequantize(w) if isinstance(w, QTensor) else w
    return out if dtype is None else out.to(dtype)


# -- KV-cache quantization (per-token, per-kv-head) ---------------------------

def quantize_kv(x: torch.Tensor):
    """Quantize cache rows on append: x (..., D) -> (int8 (..., D),
    scale (...,) f32) with a symmetric absmax scale per leading index
    (per token x kv-head)."""
    scale = _absmax(x, axis=-1, keepdims=False) / INT8_QMAX
    q = torch.clamp(torch.round(x.float() / scale[..., None]), -INT8_QMAX,
                    INT8_QMAX).to(torch.int8)
    return q, scale.float()


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


# -- params-tree conversion ---------------------------------------------------

def _eligible(key, leaf) -> bool:
    return (key in QUANT_KEYS and isinstance(leaf, torch.Tensor)
            and leaf.dim() >= 2 and leaf.is_floating_point())


def _map(tree, fn, key=None):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, key) for v in tree)
    return fn(key, tree)


def quantize_params(params, mode: str, *, group: int = DEFAULT_GROUP,
                    eligible: Callable = _eligible):
    """Quantize every eligible weight leaf of a params tree.

    Returns (new_params, report) where report counts converted leaves and
    the byte saving.  mode: 'int8' | 'int4'.  int4 leaves whose contraction
    dim the group can't tile stay dense (counted in report['skipped']).
    The reference stacks the layers of a pattern position into one leaf;
    here every layer has its own, so the counts are per layer (the bytes
    are the same)."""
    stats = {"quantized": 0, "skipped": 0, "bytes_before": 0,
             "bytes_after": 0}

    def conv(key, leaf):
        if not eligible(key, leaf):
            return leaf
        nbytes = leaf.numel() * leaf.element_size()
        stats["bytes_before"] += nbytes
        try:
            qt = quantize(leaf, mode, group=group)
        except ValueError:
            stats["skipped"] += 1
            stats["bytes_after"] += nbytes
            return leaf
        stats["quantized"] += 1
        stats["bytes_after"] += qt.nbytes
        return qt

    return _map(params, conv), stats


def tree_nbytes(tree) -> int:
    """Total payload bytes of a (possibly quantized) params or cache tree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, QTensor):
        return tree.nbytes
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
