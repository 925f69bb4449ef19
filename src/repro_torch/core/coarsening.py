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
matmul kernel reads ``vector_width`` (it widens the output tile's columns).
"""
from __future__ import annotations

import dataclasses

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
    """Normalise an op's ``cfg`` argument: a CoarseningConfig passes
    through, a label is parsed, and ``"auto"`` is BASE — the port has no
    tuner yet, so "auto" means the uncoarsened kernel."""
    if isinstance(cfg, CoarseningConfig):
        return cfg
    if cfg == "auto":
        return BASE
    return CoarseningConfig.parse(cfg)
