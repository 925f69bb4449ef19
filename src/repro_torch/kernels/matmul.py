"""Coarsened blocked matmul: the wrappers of the CUDA kernels in
``csrc/matmul.cu`` (it replaces `repro/kernels/matmul.py` `make_kernel`)
and ``csrc/quant_matmul.cu`` (the dequant-fused twin, `make_qkernel`).

A thread block of the coarsened kernel owns C row blocks of ``BM`` rows,
adjacent (consecutive) or M/C rows apart (gapped), and ``BN *
vector_width`` columns.  It streams its K slice through a TMA ring of
``MM_KSTEP``-row stages: a consecutive program's rows as one box a stage,
a gapped program's as C boxes, and the weight tile once a stage for all C
row blocks (`mm_program` states the walk).  The products run on `wgmma`,
bf16 inputs, float32 accumulation and output, as the Pallas kernel.  K is
split over the blocks of a cluster where the output tiles leave SMs idle
(`mm_split_plan`).  Bound on the H100: max(2mnk / 989 TFLOP/s, bytes
/ 3.35 TB/s); see the source for what the design does about it.

`quant_matmul` takes a packed `QTensor` weight (int8 with per-column
scales, or int4 nibbles with per-group scales), widens it to bf16 in
registers and applies the scales after the exact products.  It keeps
the reference's tile rule (``m % (degree*128)``, ``n % (128*vector_width)``,
``k % 256``, ``256 % group``) and takes degree <= 2, vector_width 1.  Its
K is split the same way (`split_plan`).
Bound: max(2mnk / 989 TFLOP/s, (2mk + packed weight + 4mn) / 3.35 TB/s).

Both kernels add the slices' partial sums in slice order, so a call gives
the same bits every time.  `plan_split` is the one planner of both.

The decode and verify steps' products (`step_matmul`) run the coarsened
kernel at label base with the K split of ONE 64-row tile whatever the row
count (`step_plan`): every output element is then summed in an order fixed
by (n, k) alone, and a row's bits do not depend on the other rows, their
count or the row's place, so a row of a T-row verify pass equals the same
row of a decode step.  At base the kernel takes any row count and N % 8
(the last tiles read TMA's zero fill and are not stored, `step_takes`)
and a K-major weight (the transpose of a contiguous (n, k) tensor, such as
a tied embedding read as the head), read in place.  A step product may
take the RMSNorm of its rows as a prologue (``norm``): the decode and
verify steps' ln1, dense ln2 and final norm launch no kernel of their
own.

On CPU tensors the wrappers compute the plain versions (`ref.matmul`,
`ref.quant_matmul`); on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref
from repro_torch.quant.qtypes import QTensor

BM, BN, BK = 64, 64, 32             # row block, column box, the K rule
MAX_TILE_PRODUCT = 4                # degree * vector_width, register budget
MM_KSTEP = 64                       # K rows a stage of the ring (`KSTEP`)
MM_BLOCKS_PER_SM = 1                # the split's aim (`mm_split_plan`)
NORM_CLUSTER = 8                    # blocks sharing a tile's row statistic
NORM_BLOCKS_PER_SM = 2              # the normed instance's occupancy
NORM_OWN_ROWS = 8                   # a tile's rows a block norms alone

launches = 0                        # kernel launches since the last reset
norm_launches = 0                   # of them, with the norm prologue
q_launches = 0                      # dequant-fused launches since the reset

# the K split over a cluster's blocks, shared by both kernels
PORTABLE_SPLITS = 8                 # a portable cluster's blocks
MAX_SPLITS = 16                     # the most a cluster takes (non-portable)
MIN_STEPS = 4                       # K steps a slice keeps where it can

# the reference qkernel's blocks (`repro/kernels/matmul.py:87`)
Q_BM, Q_BN, Q_BK = 128, 128, 256
Q_MAX_DEGREE = 2                    # a warpgroup a row block, two at most
# the dequant-fused kernel's own tiles (`csrc/quant_matmul.cu`)
Q_WN, Q_KSTEP = 64, 64              # columns of a block, K rows of a stage
Q_PORTABLE_SPLITS = PORTABLE_SPLITS
Q_MAX_SPLITS = MAX_SPLITS
Q_BLOCKS_PER_SM = 2.7               # the grid's aim at degree 1 (see
                                    # `split_plan`); half of it at degree 2


def tileable(m: int, n: int, k: int, cfg: CoarseningConfig) -> bool:
    """Whether the kernel takes an (m,k) @ (k,n) product under ``cfg``."""
    c, vw = cfg.degree, cfg.vector_width
    return (c in (1, 2, 4) and vw in (1, 2, 4)
            and c * vw <= MAX_TILE_PRODUCT
            and m % (c * BM) == 0 and n % (BN * vw) == 0 and k % BK == 0)


def step_takes(n: int, k: int) -> bool:
    """Whether the kernel takes an (m,k) @ (k,n) product at base for any
    m >= 1: N % 8 (16-byte rows of the weight) and K % 32."""
    return n >= 8 and n % 8 == 0 and k >= BK and k % BK == 0


def quant_ref_tileable(m: int, n: int, k: int, cfg: CoarseningConfig,
                       bits: int, group: int) -> bool:
    """The reference qkernel's tile rule (`repro/kernels/matmul.py:87`),
    which the plain path keeps too: 8- or 4-bit weights, m, n and k tiled
    by C*128, 128*vector_width and 256, int4 groups even and tiling 256."""
    c, vw = cfg.degree, cfg.vector_width
    return (bits in (8, 4) and m % (c * Q_BM) == 0 and n % (Q_BN * vw) == 0
            and k % Q_BK == 0
            and (bits != 4 or (group >= 2 and group % 2 == 0
                               and Q_BK % group == 0)))


def quant_tileable(m: int, n: int, k: int, cfg: CoarseningConfig,
                   bits: int, group: int) -> bool:
    """Whether the dequant-fused kernel takes an (m,k) @ packed (k,n)
    product of ``bits``-bit weights (int4 in groups of ``group`` rows)
    under ``cfg``: the reference's tile rule and the kernel's own limits
    (degree <= 2, vector width 1, int4 groups a multiple of 16)."""
    return (quant_ref_tileable(m, n, k, cfg, bits, group)
            and cfg.degree <= Q_MAX_DEGREE and cfg.vector_width == 1
            and (bits != 4 or group % 16 == 0))


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How a K-split kernel cuts an (m,k) @ (k,n) product: K into
    ``splits`` slices of whole ``unit``-row pieces (the blocks of one
    cluster; the last piece may reach past K); the grid (splits, output
    tile columns, output tile rows); a cluster is ``splits`` x
    ``cluster_y`` blocks (`step_plan` with ``norm``)."""
    splits: int
    unit: int
    grid: tuple
    cluster_y: int = 1

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def bounds(self, k: int) -> list[tuple[int, int]]:
        """[k0, k1) of every slice, as the kernel computes them."""
        units = -(-k // self.unit)
        return [(i * units // self.splits * self.unit,
                 min((i + 1) * units // self.splits * self.unit, k))
                for i in range(self.splits)]


def plan_split(m: int, n: int, k: int, *, rows: int, cols: int, kstep: int,
               unit: int, sms: int, aim: float,
               fill: bool = True) -> SplitPlan:
    """The K split of a product whose output tiles are ``rows`` x ``cols``,
    walked in ``kstep``-row stages, on a card of ``sms`` SMs.  A slice is
    whole ``unit``-row pieces.  The grid aims at ``aim`` blocks, in a
    portable cluster of at most 8 slices of at least 4 K steps each (a
    slice shorter than that is mostly the fill of its ring): clusters
    leave some of an SM's places empty, and a block that finds none waits
    for a whole block's time.  With ``fill``, where that leaves SMs idle,
    up to 16 slices fill them."""
    units = -(-k // unit)
    deep = max(1, min(units, k // (MIN_STEPS * kstep)))
    tiles = (n // cols) * (m // rows)
    splits = min(int(aim) // tiles, PORTABLE_SPLITS, deep)
    if fill and tiles * splits < sms:
        splits = min(-(-sms // tiles), MAX_SPLITS, units)
    splits = max(splits, 1)
    return SplitPlan(splits, unit, (splits, n // cols, m // rows))


def split_plan(m: int, n: int, k: int, cfg: CoarseningConfig | str,
               bits: int, group: int, sms: int) -> SplitPlan:
    """The K split of a `quant_tileable` product on a card of ``sms`` SMs.
    A slice is whole K steps and, for int4, whole scale groups.  The grid
    aims at 2.7 blocks an SM at degree 1 (1.35 at degree 2, whose blocks
    are twice the size): three blocks' rings and registers fit an SM."""
    c = resolve(cfg).degree
    return plan_split(m, n, k, rows=c * Q_BM, cols=Q_WN, kstep=Q_KSTEP,
                      unit=max(Q_KSTEP, group) if bits == 4 else Q_KSTEP,
                      sms=sms, aim=Q_BLOCKS_PER_SM * sms / c)


def mm_split_plan(m: int, n: int, k: int, cfg: CoarseningConfig | str,
                  sms: int) -> SplitPlan:
    """The K split of a `tileable` product on a card of ``sms`` SMs: whole
    ``MM_KSTEP``-row steps (the last may reach past K), the grid (splits,
    n / (64 vector_width), m / (64 degree)), aiming at one block an SM
    and never past it (`plan_split` with ``fill`` off): on the H100 a
    split that puts a second block of the cluster grid on an SM costs more
    than it streams (`repro_torch.bench.mm_splits`)."""
    cfg = resolve(cfg)
    return _mm_plan(m, n, k, cfg.degree, cfg.vector_width, sms)


@functools.lru_cache(maxsize=1024)
def _mm_plan(m: int, n: int, k: int, c: int, vw: int, sms: int) -> SplitPlan:
    return plan_split(m, n, k, rows=c * BM, cols=BN * vw, kstep=MM_KSTEP,
                      unit=MM_KSTEP, sms=sms, aim=MM_BLOCKS_PER_SM * sms,
                      fill=False)


def step_plan(m: int, n: int, k: int, sms: int,
              norm: bool = False) -> SplitPlan:
    """The K split of a decode or verify step's (m,k) @ (k,n) product: the
    plan `mm_split_plan` makes for ONE 64-row tile (N padded to whole
    64-column boxes), whatever ``m``, and a grid of ceil(m / 64) row tiles.
    The splits depend on (n, k) alone, so every row is summed in one order
    at every row count.

    With ``norm`` (the norm prologue) the same split.  Where K is split
    and a tile holds more than `NORM_OWN_ROWS` rows (a verify pass's), the
    cluster grows to `NORM_CLUSTER` blocks (``cluster_y`` column tiles of
    the split's slices), whose consumer warps share out the tile's row
    statistics (`norm_stat_rows`); the grid's columns are then whole
    clusters (blocks past the tiles store nothing).  Without a split the
    grid's columns are the blocks that fit the card
    (`NORM_BLOCKS_PER_SM` an SM), each walking the column tiles that many
    apart and computing its rows' statistics itself."""
    one = _mm_plan(BM, -(-n // BN) * BN, k, 1, 1, sms)
    tiles, rows = -(-n // BN), -(-m // BM)
    if not norm:
        return SplitPlan(one.splits, one.unit, (one.splits, tiles, rows))
    shared = one.splits > 1 and min(m, BM) > NORM_OWN_ROWS
    cy = max(1, NORM_CLUSTER // one.splits) if shared else 1
    cols = tiles
    if one.splits == 1:
        places = NORM_BLOCKS_PER_SM * sms // rows // cy * cy
        if cy <= places < tiles:
            cols = places
    cols = -(-cols // cy) * cy
    return SplitPlan(one.splits, one.unit, (one.splits, cols, rows), cy)


def norm_stat_rows(gw: int, nw: int, live: int) -> list:
    """The rows of a tile of ``live`` rows whose statistic warp ``gw`` of
    ``nw`` consumer warps computes in the norm prologue (`row_stats`): 4,
    a block's own; 4 x the cluster's blocks where they share it (a tile of
    more than `NORM_OWN_ROWS` rows in a cluster of more than one block;
    the r of row j is then read from block (j % nw) // 4).  Rows gw + nw
    j, in passes of the rows read at once: 2 where a warp has at most 2
    (one round trip), else 4."""
    rows = list(range(gw, live, nw))
    r = 2 if live <= 2 * nw else 4
    return [rows[i:i + r] for i in range(0, len(rows), r)]


@dataclasses.dataclass(frozen=True)
class Box:
    """One TMA copy: columns [x, x + w) of rows [y, y + h) of its tensor
    (of A (m, k), x runs along k; of the weight (k, n), along n)."""
    x: int
    y: int
    w: int
    h: int


@dataclasses.dataclass(frozen=True)
class Program:
    """What one block of the coarsened kernel does: the output rows it
    owns, in its local order, its columns, and each stage's A boxes and
    weight boxes."""
    rows: tuple
    cols: range
    stages: tuple


def mm_program(m: int, n: int, k: int, cfg: CoarseningConfig | str,
               plan: SplitPlan, block: tuple) -> Program:
    """The walk of the block at grid position ``block`` = (slice, column
    tile, row program), as `csrc/matmul.cu` `cmm_kernel` issues it."""
    cfg = resolve(cfg)
    c, vw = cfg.degree, cfg.vector_width
    gapped = c > 1 and cfg.kind == KIND_GAPPED
    s, j, i = block
    steps = -(-k // MM_KSTEP)
    s0 = s * steps // plan.splits
    s1 = (s + 1) * steps // plan.splits
    n0 = j * BN * vw

    def grow(b):
        return b * (m // c) + i * BM if gapped else (i * c + b) * BM

    stages = []
    for step in range(s0, s1):
        kk = step * MM_KSTEP
        if gapped:
            a = tuple(Box(kk, grow(b), MM_KSTEP, BM) for b in range(c))
        else:
            a = (Box(kk, grow(0), MM_KSTEP, c * BM),)
        w = tuple(Box(n0 + v * BN, kk, BN, MM_KSTEP) for v in range(vw))
        stages.append((a, w))
    rows = tuple(grow(b) + r for b in range(c) for r in range(BM))
    return Program(rows, range(n0, n0 + BN * vw), tuple(stages))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def instances() -> list[tuple[str, int, int]]:
    """(name, local bytes a thread, registers) of every instance of the
    coarsened kernel, read from the loaded module."""
    return _build.instances("matmul", "coarsened_matmul_instance")


def coarsened_matmul(a: torch.Tensor, b: torch.Tensor,
                     cfg: CoarseningConfig | str = BASE,
                     plan: SplitPlan | None = None, *,
                     out_dtype: torch.dtype = torch.float32,
                     norm: tuple | None = None) -> torch.Tensor:
    """(m,k) @ (k,n) -> (m,n) float32 through the coarsened kernel (bf16
    with ``out_dtype``: the float32 sums rounded on the store, as a cast of
    the float32 result).  ``plan`` overrides `mm_split_plan` (to measure
    other splits, and the steps' `step_plan`).  At base (degree 1, vector
    width 1) the rows and N need not tile (`step_takes`) and ``b`` may be
    K-major (the transpose of a contiguous (n, k) tensor).

    ``norm`` = (scale (k,) float32, eps), base only: rmsnorm(a) @ b in one
    launch.  Each consumer warp computes its rows' statistic before the
    main loop (the row norm kernel's lane walk and shuffle tree) and forms
    wgmma's A operand in registers from the staged rows, normed and
    rounded to bf16 as the row norm kernel rounds them (`norm_frag_map`
    states the registers' places), so the product equals `rmsnorm` then
    the product bit for bit (on CPU tensors: `ref.rmsnorm`, then the
    plain product).  Its plan is `step_plan`'s with ``norm`` (the
    default): the blocks of a cluster share out the tile's row statistics,
    and without a K split each block walks column tiles ``plan.grid[1]``
    apart."""
    global launches, norm_launches
    cfg = resolve(cfg)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    ragged = cfg.degree == cfg.vector_width == 1
    if not (tileable(m, n, k, cfg) or (ragged and step_takes(n, k))):
        raise ValueError(
            f"matmul ({m},{n},{k}) under {cfg.label} is not tileable by the "
            f"kernel: needs degree, vector_width in (1,2,4) with product <= "
            f"{MAX_TILE_PRODUCT}, m % (degree*{BM}), n % ({BN}*vector_width), "
            f"k % {BK} (at base any m and n % 8)")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul kernel writes float32 or bf16, not "
                        f"{out_dtype}")
    if norm is not None:
        scale, eps = norm
        if not ragged:
            raise ValueError(f"matmul: the norm prologue is base's only, "
                             f"not {cfg.label}")
        if scale.shape != (k,):
            raise ValueError(f"matmul: norm scale {tuple(scale.shape)} for "
                             f"rows of {k}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        if norm is not None:
            a = ref.rmsnorm(a, scale, eps)
        return ref.matmul(a, b).to(out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul operands on {a.device} and {b.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul kernel takes bf16, got {a.dtype}, {b.dtype}")
    kmajor = ragged and not b.is_contiguous() and b.T.is_contiguous()
    if not (a.is_contiguous() and (b.is_contiguous() or kmajor)):
        raise ValueError("matmul kernel takes contiguous operands (at base "
                         "also a transposed contiguous weight)")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("matmul kernel needs 16-byte aligned operands")
    sp = 0
    if norm is not None:
        if scale.device != a.device or scale.dtype != torch.float32 \
                or not scale.is_contiguous() or scale.data_ptr() % 16:
            raise ValueError("matmul: the norm scale must be a contiguous, "
                             "16-byte aligned float32 tensor on a's device")
        sp = scale.data_ptr()
    if plan is None:
        plan = (step_plan(m, n, k, sm_count(a.device), norm=True)
                if norm is not None else
                mm_split_plan(m, n, k, cfg, sm_count(a.device)))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    rc = _build.library("matmul").coarsened_matmul_bf16(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), sp, m, n, k, cfg.degree,
        cfg.vector_width, int(cfg.kind == KIND_GAPPED), int(kmajor),
        int(out_dtype == torch.bfloat16), plan.splits, plan.grid[1],
        plan.cluster_y, float(norm[1]) if norm is not None else 0.0,
        torch._C._cuda_getCurrentRawStream(a.device.index))
    _build.check(rc, "coarsened_matmul_bf16")
    launches += 1
    norm_launches += norm is not None
    return out


def step_matmul(a: torch.Tensor, b: torch.Tensor,
                out_dtype: torch.dtype = torch.float32,
                norm: tuple | None = None) -> torch.Tensor:
    """(m,k) @ (k,n) -> (m,n) for a decode or verify step: the coarsened
    kernel at base under `step_plan`, so each row's bits depend on that
    row alone (on CPU tensors, the plain float32 product), float32 or
    rounded to ``out_dtype`` on the store; ``norm`` = (scale, eps):
    rmsnorm(a) @ b in the same launch (`coarsened_matmul`)."""
    plan = None if a.device.type == "cpu" else step_plan(
        a.shape[0], b.shape[1], a.shape[1], sm_count(a.device),
        norm=norm is not None)
    return coarsened_matmul(a, b, BASE, plan, out_dtype=out_dtype,
                            norm=norm)


def norm_frag_map(warp: int, lane: int, ks: int) -> list:
    """The norm prologue's A fragment of k16 step ``ks`` in consumer
    thread (warp, lane), as `csrc/matmul.cu` loads it: one ldmatrix.x4 for
    which lane i gives the address of row i % 8 of 8x8 matrix i // 8
    (rows 16 warp + i % 8 + 8 ((i // 8) & 1), 16-byte chunk 2 ks + i // 16
    of the swizzled stage); register j then holds matrix j's row g =
    lane // 4, elements 2t, 2t + 1 (t = lane % 4).  Returns, for registers
    0..3 and their low and high halves, the byte offsets in the stage (TMA
    stores a 64-row, 128-byte-row tile with the 128-byte swizzle: 16-byte
    chunk c of row r at chunk c ^ (r % 8))."""
    def address(i):
        row = 16 * warp + i % 8 + 8 * ((i // 8) & 1)
        chunk = 2 * ks + i // 16
        return row * 128 + ((chunk ^ (row % 8)) << 4)

    g, t = lane // 4, lane % 4
    return [[address(8 * j + g) + 4 * t + 2 * e for e in (0, 1)]
            for j in range(4)]


def quant_matmul(a: torch.Tensor, qw: QTensor,
                 cfg: CoarseningConfig | str = BASE,
                 plan: SplitPlan | None = None) -> torch.Tensor:
    """(m,k) @ packed (k,n) -> (m,n) float32 through the dequant-fused
    kernel (int8: qw.q (k,n) + scale (1,n); int4: (k/2,n) uint8 nibbles +
    (k/group,n)).  ``plan`` overrides `split_plan` (to measure other
    splits, `repro_torch.bench.qmm_splits`)."""
    global q_launches
    cfg = resolve(cfg)
    if a.dim() != 2 or len(qw.shape) != 2 or a.shape[1] != qw.shape[0]:
        raise ValueError(f"quant_matmul: a {tuple(a.shape)} vs qw "
                         f"{qw.shape}")
    m, k = a.shape
    n = qw.shape[1]
    if not quant_ref_tileable(m, n, k, cfg, qw.bits, qw.group):
        raise ValueError(
            f"quant_matmul ({m},{n},{k}) int{qw.bits} group {qw.group} "
            f"under {cfg.label} is not tileable: needs bits 8 or 4, "
            f"m % (degree*{Q_BM}), n % ({Q_BN}*vector_width), k % {Q_BK}, "
            f"and int4 groups even and tiling bk={Q_BK}")
    if a.device.type == "cpu":
        return ref.quant_matmul(a, qw)
    if not quant_tileable(m, n, k, cfg, qw.bits, qw.group):
        raise ValueError(f"quant_matmul kernel takes degree <= "
                         f"{Q_MAX_DEGREE}, vector_width 1 and int4 groups "
                         f"that are multiples of 16, got {cfg.label}, "
                         f"group {qw.group}")
    ops_ = (a, qw.q, qw.scale)
    if a.device.type != "cuda" or any(t.device != a.device for t in ops_):
        raise ValueError("quant_matmul operands must share one CUDA device")
    if a.dtype != torch.bfloat16 or qw.scale.dtype != torch.float32:
        raise TypeError(f"quant_matmul kernel takes bf16 a and f32 scales, "
                        f"got {a.dtype}, {qw.scale.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops_):
        raise ValueError("quant_matmul kernel takes contiguous, 16-byte "
                         "aligned operands")
    if plan is None:
        plan = split_plan(m, n, k, cfg, qw.bits, qw.group,
                          sm_count(a.device))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = _build.library("quant_matmul").quant_matmul(
        a.data_ptr(), qw.q.data_ptr(), qw.scale.data_ptr(), out.data_ptr(),
        m, n, k, qw.bits, qw.group, cfg.degree, int(cfg.kind == KIND_GAPPED),
        plan.splits, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "quant_matmul")
    q_launches += 1
    return out
