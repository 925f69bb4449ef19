"""Thread-coarsening configuration: the paper's (kind, degree) pair plus its
two competing mechanisms, as pure Python.

This is the label grammar of `repro.core.coarsening.CoarseningConfig`,
copied so the port never imports the JAX package.  On the GPU one Pallas
grid program becomes one CUDA thread block, so the coarsening degree is the
number of work blocks (row blocks of a matmul, kv pages of decode attention)
one thread block owns:

* ``consecutive`` — the C blocks are adjacent;
* ``gapped``      — the C blocks are strided far apart (the paper's C narrow
  load units).

``replication`` and ``vector_width`` keep their meaning in the label; the
matmul kernel reads ``vector_width`` (it widens the output tile's columns),
and the paper's streaming and stencil kernels read both (V-wide vector
loads; an (R, G/R) grid).

The stream and row plans below (`plan_stream`, `plan_rows`) are the
reference's, field for field, with the element-to-program maps the
microbenchmark kernels are held against (`stream_owners`, `row_owners`).
"""
from __future__ import annotations

import dataclasses

import torch

KIND_NONE = "none"
KIND_CONSECUTIVE = "consecutive"
KIND_GAPPED = "gapped"
KINDS = (KIND_NONE, KIND_CONSECUTIVE, KIND_GAPPED)


@dataclasses.dataclass(frozen=True)
class CoarseningConfig:
    """kind:         none | consecutive | gapped
    degree:       work blocks fused per thread block
    replication:  pipeline-replication analog
    vector_width: SIMD-vectorization analog (widens the column tile)
    """

    kind: str = KIND_NONE
    degree: int = 1
    replication: int = 1
    vector_width: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind == KIND_NONE and self.degree != 1:
            object.__setattr__(self, "degree", 1)
        if self.degree < 1 or self.replication < 1 or self.vector_width < 1:
            raise ValueError("degree/replication/vector_width must be >= 1")
        if self.kind != KIND_NONE and self.degree == 1:
            object.__setattr__(self, "kind", KIND_NONE)

    @property
    def label(self) -> str:
        bits = []
        if self.kind != KIND_NONE:
            bits.append(f"{'con' if self.kind == KIND_CONSECUTIVE else 'gap'}"
                        f"{self.degree}")
        if self.replication > 1:
            bits.append(f"pipe{self.replication}")
        if self.vector_width > 1:
            bits.append(f"simd{self.vector_width}")
        return "+".join(bits) if bits else "base"

    @staticmethod
    def parse(spec: str) -> "CoarseningConfig":
        """Parse e.g. 'consecutive:4', 'gapped:8', 'none', 'con4+pipe2'."""
        kind, degree, repl, vw = KIND_NONE, 1, 1, 1
        for part in spec.replace(",", "+").split("+"):
            part = part.strip().lower()
            if not part or part in ("none", "base"):
                continue
            if ":" in part:
                k, d = part.split(":")
                kind = {"con": KIND_CONSECUTIVE, "consecutive": KIND_CONSECUTIVE,
                        "gap": KIND_GAPPED, "gapped": KIND_GAPPED}[k]
                degree = int(d)
            elif part.startswith("con"):
                kind, degree = KIND_CONSECUTIVE, int(part[3:])
            elif part.startswith("gap"):
                kind, degree = KIND_GAPPED, int(part[3:])
            elif part.startswith("pipe"):
                repl = int(part[4:])
            elif part.startswith("simd"):
                vw = int(part[4:])
            else:
                raise ValueError(f"bad coarsening spec part: {part!r}")
        return CoarseningConfig(kind, degree, repl, vw)


BASE = CoarseningConfig()


def resolve(cfg) -> CoarseningConfig:
    """Normalise a kernel's ``cfg`` argument: a CoarseningConfig passes
    through and a label is parsed.  ``"auto"`` names no config by itself:
    `repro_torch.kernels.ops.resolve_cfg` resolves it per call, through
    the tuner, with the call's kernel family and shape; here it raises."""
    if isinstance(cfg, CoarseningConfig):
        return cfg
    if cfg == "auto":
        raise ValueError('cfg="auto" is resolved by repro_torch.kernels.ops.'
                         'resolve_cfg with the kernel family and shape')
    return CoarseningConfig.parse(cfg)


# ---------------------------------------------------------------------------
# Stream and row plans (`repro/core/coarsening.py:116-303`), copied field for
# field.  They hold the element-to-program map that is the whole content of
# the paper's consecutive/gapped distinction.
# ---------------------------------------------------------------------------

# default 1-D streaming block (the reference's 8 x 128 f32 tile)
DEFAULT_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Grid plan of a coarsened 1-D stream of N elements.  ``block`` is the
    block widened by the vector width; program i owns a ``(degree, block)``
    tile of the ``view_shape`` view: rows ``[(i*C + k)*B, +B)`` when
    consecutive, ``[k*G*B + i*B, +B)`` when gapped, for k < C."""

    n: int
    block: int
    cfg: CoarseningConfig
    grid: int
    view_shape: tuple
    block_shape: tuple
    dmas_per_operand: int
    dma_elems: int
    contiguous: bool

    @property
    def tile_shape(self) -> tuple:
        return (self.cfg.degree, self.block * self.cfg.vector_width)


def plan_stream(n: int, cfg: CoarseningConfig,
                block: int = DEFAULT_BLOCK) -> StreamPlan:
    """The reference's `plan_stream`: the vector width widens the block, and
    N must tile by degree * block."""
    block = block * cfg.vector_width
    c = cfg.degree
    if n % (block * c) != 0:
        raise ValueError(f"N={n} not divisible by degree*block={c * block}")
    grid = n // (block * c)
    if cfg.kind in (KIND_NONE, KIND_CONSECUTIVE):
        return StreamPlan(n=n, block=block, cfg=cfg, grid=grid,
                          view_shape=(grid, c, block),
                          block_shape=(1, c, block), dmas_per_operand=1,
                          dma_elems=c * block, contiguous=True)
    return StreamPlan(n=n, block=block, cfg=cfg, grid=grid,
                      view_shape=(c, grid, block), block_shape=(c, 1, block),
                      dmas_per_operand=c, dma_elems=block, contiguous=False)


def replicated(plan) -> bool:
    """Whether the launch grid is split ``(R, G/R)`` (`flat_pid`, :250):
    only when the replication R divides the grid."""
    r = plan.cfg.replication
    return r > 1 and plan.grid % r == 0


def flat_pid(plan, outer: int, inner: int) -> int:
    """The replication-aware flat program index of grid position
    ``(outer, inner)``: ``outer * (G/R) + inner`` on an (R, G/R) grid, the
    plain index ``outer`` on a 1-D one."""
    if replicated(plan):
        return outer * (plan.grid // plan.cfg.replication) + inner
    return outer


def stream_owners(plan: StreamPlan, device=None) -> torch.Tensor:
    """(N,) int64: the program that owns each element of the stream."""
    e = torch.arange(plan.n, device=device)
    if plan.contiguous:
        return e // (plan.cfg.degree * plan.block)
    return (e % (plan.grid * plan.block)) // plan.block


@dataclasses.dataclass(frozen=True)
class RowPlan:
    rows: int
    block_rows: int
    cfg: CoarseningConfig
    grid: int
    fused_rows: int             # rows handled per program
    stride_blocks: int          # distance (in blocks) between fused blocks
    dmas_per_operand: int
    contiguous: bool


def plan_rows(rows: int, cfg: CoarseningConfig, block_rows: int) -> RowPlan:
    c = cfg.degree
    if rows % (block_rows * c) != 0:
        raise ValueError(f"rows={rows} not divisible by degree*block="
                         f"{c * block_rows}")
    grid = rows // (block_rows * c)
    if cfg.kind in (KIND_NONE, KIND_CONSECUTIVE):
        return RowPlan(rows, block_rows, cfg, grid, fused_rows=c * block_rows,
                       stride_blocks=1, dmas_per_operand=1, contiguous=True)
    return RowPlan(rows, block_rows, cfg, grid, fused_rows=c * block_rows,
                   stride_blocks=grid, dmas_per_operand=c, contiguous=False)


def row_starts(plan: RowPlan, i: int) -> list:
    """Starting row (in units of block_rows) of each fused block of
    program i."""
    c = plan.cfg.degree
    if plan.contiguous:
        return [i * c + k for k in range(c)]
    return [i + k * plan.grid for k in range(c)]


def row_owners(plan: RowPlan, device=None) -> torch.Tensor:
    """(rows,) int64: the program that owns each row, from `row_starts`."""
    owner = torch.empty(plan.rows, dtype=torch.int64, device=device)
    for i in range(plan.grid):
        for s in row_starts(plan, i):
            owner[s * plan.block_rows:(s + 1) * plan.block_rows] = i
    return owner
