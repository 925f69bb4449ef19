"""Coarsened flash attention: the wrappers of the CUDA kernels in
``csrc/flash_attention.cu`` (they replace `repro/kernels/flash_attention.py`
`make_kernel`, `make_bwd_dq_kernel` and `make_bwd_dkv_kernel`).

* forward — one thread block per (batch, q-head, q-program); a q-program
  is C q-blocks of ``bq`` rows, adjacent (consecutive) or Sq/C apart
  (gapped).  A producer warp streams each K/V tile of the program's walk
  (`fwd_walk`) by TMA into a ring in shared memory, once for all the
  program's rows; each consumer warpgroup of 64 rows multiplies it with
  wgmma and carries the online softmax in registers; o is float32, and
  (m, l) are written when residuals are asked for.
* prep — `flash_bwd_prep`: delta = sum(g * o) and the cotangent rounded to
  bf16, in one pass, for both backward kernels.
* dQ — the forward's programs and walk (with `dq_kv_tile` rows a tile); p
  is recomputed from (m, l) and ``dq = p (dO V^T - delta) K scale``.
* dK/dV — programs of C kv-blocks of ``bkv`` rows; K and V stay in shared
  memory while the program's live q tiles (`dkv_walk`, `dkv_q_tile` rows
  a tile) stream through; the q heads of one GQA group run as a
  thread-block cluster that sums their partials on chip in rank order
  (`dkv_clusters`), so dk, dv come out summed over each group.

Bound on the H100: max(bytes / 3.35 TB/s, flops / 989 TFLOP/s) at the
shapes of the call; the source's note says what the design does about it.

On CPU tensors each wrapper computes its plain version (`ref.flash_*`); on
CUDA tensors it launches the kernel or raises.  The kernels take bf16 q,
k, v (and the backward's dO), head dims 64, 128 and 256, programs of 64,
128 or 256 rows (64 or 128 at head dim 256), ``bkv`` a multiple of 64 on
the q axis and ``bq`` a multiple of 32 on the kv axis; anything else
raises ``ValueError``.  Programs taller than a block holds (256 rows, or
128 kv rows at head dim 256 in the dK/dV pass) run as consecutive blocks
of the same program, each loading the streamed tiles itself.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref

HEAD_DIMS = (64, 128, 256)
PROGRAM_ROWS = (64, 128, 256)       # C * block rows of a program

# kernel launches since the last reset, one count per kernel
fwd_launches = 0
prep_launches = 0
dq_launches = 0
dkv_launches = 0
MAX_CLUSTER = 16                    # blocks of a dK/dV cluster


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


def dq_kv_tile(d: int) -> int:
    """kv rows of one stage of the dQ kernel's ring (`dq_kt` in the
    source): 64, or 32 at head dim 256, where the dQ sum takes 128
    registers a thread beside the S and dP tiles.  dQ walks `fwd_walk`
    with tiles of this many rows."""
    return 32 if d >= 256 else 64


def dkv_q_tile(bq: int) -> int:
    """q rows of one stage of the dK/dV kernel's ring (`dkv_qt` in the
    source): 64 where the q blocks tile by 64, else 32."""
    return 64 if bq % 64 == 0 else 32


@dataclasses.dataclass(frozen=True)
class DkvProgram:
    """One kv program of the dK/dV kernel's walk."""
    program: int             # kv program index along the sequence
    position: int            # its launch position among a head's programs
    cols: tuple              # its global kv rows, in local (shared) order
    # the q tiles it loads, in order: (first q row, the tile's class for
    # each group of 64 kv rows, "full" or "edge")
    tiles: tuple


def dkv_walk(sq: int, sk: int, degree: int, gapped: bool, bq: int,
             bkv: int, qt: int, causal: bool,
             window: int | None) -> list[DkvProgram]:
    """The rule the dK/dV kernel follows (its source cites this), in plain
    Python, one entry per kv program.

    The live q blocks are those of the Pallas whole-block skip
    (`repro/kernels/flash_attention.py:371-380`) on the program's extreme
    kv rows, a contiguous range; each is loaded as ``bq // qt`` tiles of
    ``qt`` rows.  A tile is "full" for a group of 64 kv rows (a consumer
    warpgroup's, or at head dim 256 the two warpgroups' shared rows) when
    every (q row, kv row) pair is allowed by the causal / window mask, so
    no mask is applied, and "edge" otherwise.  Programs launch in order:
    under causal masking the first have the most live q blocks."""
    c_prog = degree * bkv
    nprog, skg, nq = sk // c_prog, sk // degree, sq // bq
    out = []
    for ki in range(nprog):
        cols = tuple((r // bkv) * skg + ki * bkv + r % bkv if gapped
                     else ki * c_prog + r for r in range(c_prog))
        qb_lo, qb_hi = 0, nq
        if causal:
            qb_lo = cols[0] // bq
        if window is not None:
            qb_hi = min(nq, (cols[-1] + window - 1) // bq + 1)
        tiles = []
        for q0 in range(qb_lo * bq, qb_hi * bq, qt):
            kinds = []
            for w in range(c_prog // 64):
                w_lo, w_hi = cols[64 * w], cols[64 * w + 63]
                whole = ((not causal or w_hi <= q0)
                         and (window is None or w_lo > q0 + qt - 1 - window))
                kinds.append("full" if whole else "edge")
            tiles.append((q0, tuple(kinds)))
        out.append(DkvProgram(ki, ki, cols, tuple(tiles)))
    return out


def dkv_cluster(group: int) -> int:
    """Blocks of one dK/dV cluster for a GQA group of ``group`` q heads:
    the whole group up to 16 blocks (the non-portable limit), else the
    largest divisor of the group up to 16, and the wrapper sums the
    group's ``group // cluster`` cluster sums."""
    return max(c for c in range(1, min(group, MAX_CLUSTER) + 1)
               if group % c == 0)


def dkv_clusters(h: int, hkv: int) -> list[tuple[int, int, tuple]]:
    """The dK/dV kernel's clusters for one batch row and kv program:
    (kv head, the cluster's index in its group, its q heads in rank order,
    the order of the sum)."""
    group = h // hkv
    cl = dkv_cluster(group)
    return [(kvh, gi, tuple(kvh * group + gi * cl + r for r in range(cl)))
            for kvh in range(hkv) for gi in range(group // cl)]


def _launchable(tensors, cfg: CoarseningConfig, d, bq, bkv, *,
                kv_axis: bool) -> torch.device:
    """What the CUDA kernels take; raises on anything else."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash attention operands must share one CUDA "
                         "device")
    if any(t.dtype != torch.bfloat16 for t in tensors[:4]):
        raise TypeError(f"flash kernels take bf16 q, k, v (and the "
                        f"backward's do, from `flash_bwd_prep`), got "
                        f"{[t.dtype for t in tensors[:4]]}")
    if any(t.dtype != torch.float32 for t in tensors[4:]):
        raise TypeError("flash backward kernels take float32 m, l, delta")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash kernels take contiguous operands")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash kernels take 16-byte aligned operands")
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


def flash_bwd_prep(o, g):
    """The backward's preprocessing: o, g (B,H,Sq,D) float32 (the forward's
    output and its cotangent) -> (do (B,H,Sq,D) bf16, g rounded as both
    backward kernels read it; delta (B,H,Sq) float32 = sum(g * o), the
    reference's line `repro/kernels/ops.py:235`), in one pass."""
    global prep_launches
    if o.shape != g.shape or o.dim() != 4:
        raise ValueError(f"flash_bwd_prep shapes: o {tuple(o.shape)}, g "
                         f"{tuple(g.shape)}")
    if o.device.type == "cpu":
        return ref.flash_bwd_prep(o, g)
    _build.check_f32_cuda("flash_bwd_prep", (o, g))
    b, h, sq, d = o.shape
    do = torch.empty(o.shape, dtype=torch.bfloat16, device=o.device)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=o.device)
    rc = _build.library("flash_attention").flash_bwd_prep(
        o.data_ptr(), g.data_ptr(), do.data_ptr(), delta.data_ptr(),
        b * h * sq, d, torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(rc, "flash_bwd_prep")
    prep_launches += 1
    return do, delta


def flash_bwd_dq(q, k, v, do, m, l, delta,
                 cfg: CoarseningConfig | str = BASE, *, bq: int = 128,
                 bkv: int = 128, causal: bool = True,
                 window: int | None = None, scale: float | None = None):
    """dQ from the forward residuals.  do: (B,H,Sq,D), bf16 on the card
    (`flash_bwd_prep`'s), float32 or bf16 on the CPU; m, l, delta:
    (B,H,Sq) float32 -> dq (B,H,Sq,D) float32.  ``cfg`` is the forward's
    (the same q programs)."""
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
    """dK/dV from the forward residuals (``do`` as for `flash_bwd_dq`),
    coarsened on the kv-block axis by ``cfg`` -> (dk, dv) (B,Hkv,Sk,D)
    float32, summed over each GQA group: on the card inside the kernel, by
    clusters of `dkv_cluster` q heads (a group of more than 16 heads sums
    its clusters' sums here)."""
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
    cl = dkv_cluster(h // hkv)
    ng = h // hkv // cl
    dk = torch.empty((b, hkv, ng, sk, d), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    rc = _build.library("flash_attention").flash_dkv_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_args(q, k, cfg, bq, bkv, causal, window, scale),
        cl, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flash_dkv_bf16")
    dkv_launches += 1
    if ng == 1:
        return dk.view(b, hkv, sk, d), dv.view(b, hkv, sk, d)
    return dk.sum(dim=2), dv.sum(dim=2)


def dkv_max_clusters(d: int, rows: int, bq: int, bkv: int, h: int,
                     hkv: int) -> int:
    """How many dK/dV clusters for that geometry the card holds at once
    (`cudaOccupancyMaxActiveClusters`; 0: the launch would fail)."""
    n = _build.library("flash_attention").flash_dkv_clusters(
        d, rows, bq, bkv, h, hkv, dkv_cluster(h // hkv))
    if n < 0:
        raise ValueError(f"no dK/dV instance for D={d}, {rows} rows, bq={bq}, "
                         f"bkv={bkv}, {h}/{hkv} heads")
    return n


def bwd_instances() -> list[tuple[str, int, int]]:
    """(name, local bytes a thread, registers) of every dQ and dK/dV
    instance, read from the loaded module (`_build.instances`)."""
    return _build.instances("flash_attention", "flash_bwd_instance")
