"""Coarsened flash attention: the wrappers of the three CUDA kernels in
``csrc/flash_attention.cu`` (they replace `repro/kernels/flash_attention.py`
`make_kernel`, `make_bwd_dq_kernel` and `make_bwd_dkv_kernel`).

* forward — one thread block per (batch, q-head, q-program); a q-program
  is C q-blocks of ``bq`` rows, adjacent (consecutive) or Sq/C apart
  (gapped).  A producer warp streams each K/V tile of the program's walk
  (`fwd_walk`) by TMA into a ring in shared memory, once for all the
  program's rows; each consumer warpgroup of 64 rows multiplies it with
  wgmma and carries the online softmax in registers; o is float32, and
  (m, l) are written when residuals are asked for.
* dQ — the forward's programs; p is recomputed from (m, l) and
  ``dq = p (dO V^T - delta) K scale``.
* dK/dV — one block per (batch, q-head, kv-program) of C kv-blocks of
  ``bkv`` rows; it sweeps the q blocks and writes per-q-head partials,
  which `flash_bwd_dkv` sums over each GQA group with one reduction (as
  the Pallas ``run`` does outside its call).

Bound on the H100: max(bytes / 3.35 TB/s, flops / 989 TFLOP/s) at the
shapes of the call; the source's note says what the design does about it.

On CPU tensors each wrapper computes its plain version (`ref.flash_*`); on
CUDA tensors it launches the kernel or raises.  The kernels take bf16 q,
k, v, head dims 64, 128 and 256, programs of 64, 128 or 256 rows (16 a
warp; 64 or 128 at head dim 256, where 256 rows pass the shared memory
and registers a block has), ``bkv`` a multiple of 64 on the q axis and
``bq`` a multiple of 32 on the kv axis; anything else raises
``ValueError``.  At head dim 256 the dK/dV pass runs two blocks a program,
one per half of the head dim.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 128, 256)
PROGRAM_ROWS = (64, 128, 256)       # C * block rows a thread block holds

# kernel launches since the last reset, one count per kernel
fwd_launches = 0
dq_launches = 0
dkv_launches = 0


def _geometry(q, k, cfg: CoarseningConfig, bq, bkv, causal, window, *,
              kv_axis: bool) -> None:
    """Check shapes and the Pallas tiling rule (both devices)."""
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"n_heads {h} not divisible by n_kv_heads "
                         f"{k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    ref.flash_check(sq, k.shape[2], degree=cfg.degree, bq=bq, bkv=bkv,
                    causal=causal, window=window, kv_axis=kv_axis)


def takes(d: int, degree: int, bq: int, bkv: int, *, kv_axis: bool) -> bool:
    """Whether the kernels hold head dim ``d`` and a program of ``degree``
    blocks of ``bq`` q rows (``bkv`` kv rows for the dK/dV pass,
    ``kv_axis``); the layer dispatch sends any other geometry to the plain
    path.  Head dim 256 holds programs of 64 and 128 rows only (`valid` in
    the source states the same rule)."""
    rows = degree * (bkv if kv_axis else bq)
    return (d in HEAD_DIMS and rows in PROGRAM_ROWS
            and (rows < 256 or d < 256) and bq % 32 == 0
            and bkv % (16 if kv_axis else 64) == 0)


def fwd_kv_tile(d: int, rows: int) -> int:
    """kv rows of one stage of the forward kernel's ring (`fwd_kt` in the
    source) for head dim ``d`` and programs of ``rows`` rows: 64, or 32
    where four consumer warpgroups at head dim 128 or more leave too few
    registers for a 64-column score tile beside O."""
    return 32 if rows >= 256 and d >= 128 else 64


@dataclasses.dataclass(frozen=True)
class FwdProgram:
    """One q program of the forward kernel's walk."""
    program: int             # q program index along the sequence
    position: int            # its launch position among a head's programs
    rows: tuple              # its global q rows, in local (shared) order
    # the kv tiles it loads, in order: (first kv row, the tile's class for
    # each consumer warpgroup of 64 rows, "full" or "edge")
    tiles: tuple


def fwd_walk(sq: int, sk: int, degree: int, gapped: bool, bq: int,
             bkv: int, kt: int, causal: bool,
             window: int | None) -> list[FwdProgram]:
    """The rule the forward kernel follows (its source cites this), in
    plain Python, one entry per q program.

    The live kv blocks are those of the Pallas whole-block skip
    (`_q_axis_mask_live`) on the program's extreme rows, a contiguous
    range; each is loaded as ``bkv // kt`` tiles of ``kt`` rows.  A tile
    is "full" for a warpgroup when every (row, col) pair of its rows is
    allowed by the causal / window mask, so no mask is applied, and "edge"
    otherwise.  Under causal masking the programs launch in reverse, the
    ones with the most live blocks first; otherwise in order."""
    r_prog = degree * bq
    nprog, sg, nk = sq // r_prog, sq // degree, sk // bkv
    out = []
    for qi in range(nprog):
        rows = tuple((r // bq) * sg + qi * bq + r % bq if gapped
                     else qi * r_prog + r for r in range(r_prog))
        k_lo, k_hi = 0, nk - 1
        if causal:
            k_hi = min(k_hi, rows[-1] // bkv)
        if window is not None and rows[0] - window + 1 > 0:
            k_lo = (rows[0] - window + 1) // bkv
        tiles = []
        for c0 in range(k_lo * bkv, (k_hi + 1) * bkv, kt):
            kinds = []
            for w in range(r_prog // 64):
                w_lo, w_hi = rows[64 * w], rows[64 * w + 63]
                whole = ((not causal or c0 + kt - 1 <= w_lo)
                         and (window is None or c0 > w_hi - window))
                kinds.append("full" if whole else "edge")
            tiles.append((c0, tuple(kinds)))
        out.append(FwdProgram(qi, nprog - 1 - qi if causal else qi, rows,
                              tuple(tiles)))
    return out


def _launchable(tensors, cfg: CoarseningConfig, d, bq, bkv, *,
                kv_axis: bool) -> torch.device:
    """What the CUDA kernels take; raises on anything else."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash attention operands must share one CUDA "
                         "device")
    if any(t.dtype != torch.bfloat16 for t in tensors[:3]):
        raise TypeError(f"flash kernels take bf16 q, k, v, got "
                        f"{[t.dtype for t in tensors[:3]]}")
    if any(t.dtype != torch.float32 for t in tensors[3:]):
        raise TypeError("flash backward kernels take float32 do, m, l, "
                        "delta")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash kernels take contiguous operands")
    q, k, v = tensors[:3]
    if v.shape != k.shape or (len(tensors) > 3 and (
            tensors[3].shape != q.shape
            or any(t.shape != q.shape[:3] for t in tensors[4:]))):
        raise ValueError("flash shapes: v must match k, do must match q, "
                         "and m, l, delta be (B,H,Sq)")
    rows = cfg.degree * (bkv if kv_axis else bq)
    if not takes(d, cfg.degree, bq, bkv, kv_axis=kv_axis):
        raise ValueError(
            f"flash kernel holds head dims {HEAD_DIMS}, programs of "
            f"{PROGRAM_ROWS} rows (up to 128 at head dim 256), bq % 32 == 0 "
            f"and bkv % "
            f"{16 if kv_axis else 64} == 0; got D={d}, {cfg.label} x "
            f"{bkv if kv_axis else bq} = {rows} rows, bq={bq}, bkv={bkv}")
    return dev


def _args(q, k, cfg, bq, bkv, causal, window, scale):
    b, h, sq, d = q.shape
    return (b, h, k.shape[1], sq, k.shape[2], d, cfg.degree, bq, bkv,
            int(cfg.kind == KIND_GAPPED), int(causal), window or 0,
            float(scale))


def flash_forward(q, k, v, cfg: CoarseningConfig | str = BASE, *,
                  bq: int = 128, bkv: int = 128, causal: bool = True,
                  window: int | None = None, scale: float | None = None,
                  residuals: bool = False):
    """q: (B,H,Sq,D); k, v: (B,Hkv,Sk,D) -> o (B,H,Sq,D) float32, or
    (o, m, l) with m, l (B,H,Sq) float32 when ``residuals``."""
    global fwd_launches
    cfg = resolve(cfg)
    _geometry(q, k, cfg, bq, bkv, causal, window, kv_axis=False)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return ref.flash_forward(q, k, v, degree=cfg.degree,
                                 gapped=cfg.kind == KIND_GAPPED, bq=bq,
                                 bkv=bkv, causal=causal, window=window,
                                 scale=scale, residuals=residuals)
    dev = _launchable((q, k, v), cfg, q.shape[3], bq, bkv, kv_axis=False)
    b, h, sq, d = q.shape
    o = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
    m = l = None
    if residuals:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
    rc = _build.library("flash_attention").flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(),
        *_args(q, k, cfg, bq, bkv, causal, window, scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_fwd_bf16")
    fwd_launches += 1
    return (o, m, l) if residuals else o


def flash_bwd_dq(q, k, v, do, m, l, delta,
                 cfg: CoarseningConfig | str = BASE, *, bq: int = 128,
                 bkv: int = 128, causal: bool = True,
                 window: int | None = None, scale: float | None = None):
    """dQ from the forward residuals.  do: (B,H,Sq,D) float32; m, l,
    delta: (B,H,Sq) float32 -> dq (B,H,Sq,D) float32.  ``cfg`` is the
    forward's (the same q programs)."""
    global dq_launches
    cfg = resolve(cfg)
    _geometry(q, k, cfg, bq, bkv, causal, window, kv_axis=False)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return ref.flash_bwd_dq(q, k, v, do, m, l, delta, degree=cfg.degree,
                                gapped=cfg.kind == KIND_GAPPED, bq=bq,
                                bkv=bkv, causal=causal, window=window,
                                scale=scale)
    dev = _launchable((q, k, v, do, m, l, delta), cfg, q.shape[3], bq, bkv,
                      kv_axis=False)
    dq = torch.empty(q.shape, dtype=torch.float32, device=dev)
    rc = _build.library("flash_attention").flash_dq_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_args(q, k, cfg, bq, bkv, causal, window, scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_dq_bf16")
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, m, l, delta,
                  cfg: CoarseningConfig | str = BASE, *, bq: int = 128,
                  bkv: int = 128, causal: bool = True,
                  window: int | None = None, scale: float | None = None):
    """dK/dV from the forward residuals, coarsened on the kv-block axis by
    ``cfg`` -> (dk, dv) (B,Hkv,Sk,D) float32, summed over each GQA group."""
    global dkv_launches
    cfg = resolve(cfg)
    _geometry(q, k, cfg, bq, bkv, causal, window, kv_axis=True)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return ref.flash_bwd_dkv(q, k, v, do, m, l, delta,
                                 degree=cfg.degree,
                                 gapped=cfg.kind == KIND_GAPPED, bq=bq,
                                 bkv=bkv, causal=causal, window=window,
                                 scale=scale)
    dev = _launchable((q, k, v, do, m, l, delta), cfg, q.shape[3], bq, bkv,
                      kv_axis=True)
    b, h, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dkh = torch.empty((b, h, sk, d), dtype=torch.float32, device=dev)
    dvh = torch.empty_like(dkh)
    rc = _build.library("flash_attention").flash_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dkh.data_ptr(),
        dvh.data_ptr(), *_args(q, k, cfg, bq, bkv, causal, window, scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_dkv_bf16")
    dkv_launches += 1
    # GQA: sum the per-q-head partials onto the shared kv heads
    return (dkh.reshape(b, hkv, h // hkv, sk, d).sum(dim=2),
            dvh.reshape(b, hkv, h // hkv, sk, d).sum(dim=2))
