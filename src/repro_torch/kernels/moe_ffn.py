"""Grouped-expert MoE FFN, bf16 and dequant-fused: the wrappers of the CUDA
kernels in ``csrc/moe_ffn.cu`` (they replace `repro/kernels/moe_ffn.py`
`make_kernel` and `make_qkernel`).

Each is two launches of one blocked tensor-core tile: per (F tile, expert
group) h = silu(x@w1) * (x@w3), then per (d tile, expert group)
y = (h @ w2) * comb.  A block owns ``degree`` experts, adjacent
(consecutive) or E/degree apart (gapped).  Experts and 16-row tiles whose
combine weights are all 0 read no weight byte.  Bound on the H100: the
live experts' weight bytes (plus x, comb and y) at 3.35 TB/s.

On CPU tensors the wrappers compute the plain versions (`ref.moe_ffn`,
`ref.quant_moe_ffn`); on CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref
from repro_torch.quant.qtypes import QTensor

TILE_N, TILE_K = 64, 32            # the kernel's column and depth tiles

launches = 0                       # bf16 kernel launches since the last reset
q_launches = 0                     # dequant-fused launches since the reset


def takes(d: int, f: int, bits: int | None = None, group: int = 0) -> bool:
    """Whether the kernels take widths d and F (tiles of 64 columns) and,
    for packed weights, ``bits``-bit values (int4 in groups of ``group``
    rows, tiling d and F, a multiple of 16)."""
    if d % TILE_N or f % TILE_N:
        return False
    return bits != 4 or (group > 0 and group % 16 == 0 and d % group == 0
                         and f % group == 0)


def _check(xe, w1, w3, w2, comb, cfg: CoarseningConfig):
    e, c, d = xe.shape
    f = w1.shape[-1]
    if tuple(w1.shape) != (e, d, f) or tuple(w3.shape) != (e, d, f) \
            or tuple(w2.shape) != (e, f, d) or tuple(comb.shape) != (e, c):
        raise ValueError(
            f"moe_ffn shapes: xe {tuple(xe.shape)}, w1 {tuple(w1.shape)}, "
            f"w3 {tuple(w3.shape)}, w2 {tuple(w2.shape)}, comb "
            f"{tuple(comb.shape)}")
    if e % cfg.degree:
        raise ValueError(f"experts {e} not tileable by degree {cfg.degree}")
    return e, c, d, f


def _cuda_checks(what, tensors, d, f, bits=None, group=0):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} operands must share one CUDA device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous, 16-byte aligned "
                         f"operands")
    if not takes(d, f, bits, group):
        raise ValueError(f"{what} kernel takes d and F multiples of "
                         f"{TILE_N} (and int4 groups multiples of 16 that "
                         f"tile both), got d={d}, F={f}, group={group}")
    return dev


def moe_ffn(xe, w1, w3, w2, comb, cfg: CoarseningConfig | str = BASE):
    """xe (E,C,d); w1, w3 (E,d,F); w2 (E,F,d); comb (E,C) combine weights
    -> (E,C,d) f32: per expert ``(silu(xe@w1) * (xe@w3)) @ w2 * comb``, h
    rounded once to xe's dtype."""
    global launches
    cfg = resolve(cfg)
    e, c, d, f = _check(xe, w1, w3, w2, comb, cfg)
    if xe.device.type == "cpu":
        return ref.moe_ffn(xe, w1, w3, w2, comb)
    dev = _cuda_checks("moe_ffn", (xe, w1, w3, w2, comb), d, f)
    if any(t.dtype != torch.bfloat16 for t in (xe, w1, w3, w2)) \
            or comb.dtype != torch.float32:
        raise TypeError("moe_ffn kernel takes bf16 xe and weights and f32 "
                        "combine weights")
    h = torch.empty((e, c, f), dtype=torch.bfloat16, device=dev)
    out = torch.empty((e, c, d), dtype=torch.float32, device=dev)
    rc = _build.library("moe_ffn").moe_ffn_bf16(
        xe.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        comb.data_ptr(), h.data_ptr(), out.data_ptr(), e, c, d, f,
        cfg.degree, int(cfg.kind == KIND_GAPPED),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "moe_ffn_bf16")
    launches += 1
    return out


def quant_moe_ffn(xe, qw1: QTensor, qw3: QTensor, qw2: QTensor, comb,
                  cfg: CoarseningConfig | str = BASE):
    """The same chain with packed expert panes (int8: (E,d,F) + (E,1,F)
    scales; int4: (E,d/2,F) nibbles + (E,d/group,F) scales, w2 alike),
    f32 throughout (h is not rounded) -> (E,C,d) f32."""
    global q_launches
    cfg = resolve(cfg)
    e, c, d, f = _check(xe, qw1, qw3, qw2, comb, cfg)
    bits, group = qw1.bits, qw1.group
    if any((w.bits, w.group) != (bits, group) for w in (qw3, qw2)):
        raise ValueError("quant_moe_ffn: w1, w3 and w2 differ in format")
    if bits == 4 and (d % group or f % group or group % 2):
        raise ValueError(f"int4 needs even group tiling d={d} and f={f}, "
                         f"got group={group}")
    if xe.device.type == "cpu":
        return ref.quant_moe_ffn(xe, qw1, qw3, qw2, comb)
    ws = [t for w in (qw1, qw3, qw2) for t in (w.q, w.scale)]
    dev = _cuda_checks("quant_moe_ffn", [xe, *ws, comb], d, f, bits, group)
    if xe.dtype != torch.bfloat16 or comb.dtype != torch.float32:
        raise TypeError("quant_moe_ffn kernel takes bf16 xe and f32 combine "
                        "weights")
    h = torch.empty((e, c, f), dtype=torch.float32, device=dev)
    out = torch.empty((e, c, d), dtype=torch.float32, device=dev)
    rc = _build.library("moe_ffn").quant_moe_ffn(
        xe.data_ptr(), *(t.data_ptr() for t in ws), comb.data_ptr(),
        h.data_ptr(), out.data_ptr(), e, c, d, f, bits, group,
        cfg.degree, int(cfg.kind == KIND_GAPPED),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "quant_moe_ffn")
    q_launches += 1
    return out
