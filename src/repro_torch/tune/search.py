"""Coarsening autotuner: enumerate, rank, (optionally) measure, pick
(`repro/tune/search.py`; `search` and `autotune` are the reference's code).

Three strategies, as in the reference:

  model       rank every valid candidate by `model_cost`, no execution
  exhaustive  measure every valid candidate and rank by measured time
  greedy      measure the first ``top_k`` of the model ranking only

Two things differ from the reference, and only these two:

* **The model.**  The reference ranks with `core/analysis`, a cost model
  of a TPU v5e (`repro/tune/search.py:27`, :257-386), which says nothing
  about an H100.  `model_cost` here is the H100 bound of the spec's work,
  max(bytes / 3.35 TB/s, operations / peak) with the peaks of
  `repro_torch.bench.common` (bf16 989 TFLOP/s, fp32 67 TFLOP/s).  The
  bound is the same for every label of a spec, so the stable sort keeps
  the enumeration order, base first: ``model`` (and ``"auto"`` on a cache
  miss) picks base, ``greedy`` measures the first ``top_k`` labels in
  enumeration order and ``exhaustive`` measures them all.
* **Legality.**  `enumerate_candidates` returns the reference's candidates
  for the spec intersected with what the port's kernel of that family
  takes (`kernel_takes`: the wrappers' own ``takes`` / ``tileable``
  rules), so a tuned label never reaches a wrapper that refuses it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

from repro_torch.bench.common import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S
from repro_torch.core.coarsening import (KIND_CONSECUTIVE, KIND_GAPPED,
                                         KIND_NONE, CoarseningConfig)
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import embed_gather as _embed
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import moe_ffn as _moe
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import sparse_attention as _sparse
from repro_torch.kernels import ssd as _ssd
from repro_torch.tune.cache import KernelSpec, TuningCache, default_cache

DEGREES = (1, 2, 4, 8)
REPLICATIONS = (1, 2, 4)
VECTOR_WIDTHS = (1, 2)

# ew_stream variants whose predicate depends on loaded data: like the
# OpenCL offline compiler, the reference refuses to vectorize these
DATA_DEPENDENT_VARIANTS = frozenset(
    {"if_in", "for_in_if_in", "div2", "div4"})

# the vector widths the streaming, gather and stencil kernels instantiate
STREAM_WIDTHS = (1, 2, 4, 8)
MAX_GRID_Y = 65535                  # the stencil's program axis

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
                "int8": 1}

# counts search() invocations; tests hold that cache hits skip it
SEARCH_COUNT = 0


class NoCandidate(ValueError):
    """No label of the family's port kernel fits the spec's geometry: the
    one error a warm treats as a skip."""


@dataclasses.dataclass(frozen=True)
class Candidate:
    cfg: CoarseningConfig
    modeled_s: float
    measured_s: Optional[float] = None

    @property
    def score(self) -> float:
        return self.modeled_s if self.measured_s is None else self.measured_s


@dataclasses.dataclass
class TuneResult:
    spec: KernelSpec
    best: CoarseningConfig
    candidates: list         # Candidates, ranked best-first
    source: str              # 'model' | 'measured' | 'cache'


# ---------------------------------------------------------------------------
# per-family candidate legality
# ---------------------------------------------------------------------------

def _kind_degree_pairs(degrees: Sequence[int]):
    yield KIND_NONE, 1
    for d in degrees:
        if d > 1:
            yield KIND_CONSECUTIVE, d
            yield KIND_GAPPED, d


def _reference_candidates(spec: KernelSpec, degrees, replications,
                          vector_widths) -> list:
    """The reference's `enumerate_candidates` (`repro/tune/search.py:
    76-232`), rule for rule, in its order."""
    fam, p = spec.family, spec.p
    out = []

    def stream_ok(n, cfg, block):
        if n % (block * cfg.vector_width * cfg.degree):
            return False
        grid = n // (block * cfg.vector_width * cfg.degree)
        return cfg.replication == 1 or grid % cfg.replication == 0

    if fam == "ew_stream":
        n, block = spec.shape[0], p.get("block", 1024)
        simd_ok = p.get("variant", "base") not in DATA_DEPENDENT_VARIANTS
        for kind, deg in _kind_degree_pairs(degrees):
            for r in replications:
                for vw in vector_widths:
                    if vw > 1 and not simd_ok:
                        continue
                    cfg = CoarseningConfig(kind, deg, r, vw)
                    if stream_ok(n, cfg, block):
                        out.append(cfg)
    elif fam in ("gather_stream", "embed_gather"):
        n, block = spec.shape[0], p.get(
            "block", 1024 if fam == "gather_stream" else 256)
        vws = vector_widths if fam == "gather_stream" else (1,)
        for kind, deg in _kind_degree_pairs(degrees):
            for vw in vws:
                cfg = CoarseningConfig(kind, deg, 1, vw)
                if stream_ok(n, cfg, block):
                    out.append(cfg)
    elif fam == "matmul":
        m, n, k = spec.shape
        bm, bn, bk = p.get("bm", 128), p.get("bn", 128), p.get("bk", 256)
        if k % bk == 0:
            for kind, deg in _kind_degree_pairs(degrees):
                for vw in vector_widths:
                    if m % (bm * deg) == 0 and n % (bn * vw) == 0:
                        out.append(CoarseningConfig(kind, deg, 1, vw))
    elif fam == "dp_scan":
        rows = spec.shape[0]
        for kind, deg in _kind_degree_pairs(degrees):
            if kind != KIND_GAPPED and rows % deg == 0:
                out.append(CoarseningConfig(kind, deg))
    elif fam == "stencil5":
        rows, br = spec.shape[0], p.get("block_rows", 8)
        for kind, deg in _kind_degree_pairs(degrees):
            if rows % (br * deg) == 0:
                out.append(CoarseningConfig(kind, deg))
    elif fam == "flash_attention":
        b, h, hkv, sq, sk, d = spec.shape
        bq, bkv = p.get("bq", 128), p.get("bkv", 128)
        if sk % bkv == 0:
            for kind, deg in _kind_degree_pairs(degrees):
                if sq % (bq * deg) == 0:
                    out.append(CoarseningConfig(kind, deg))
    elif fam == "flash_attention_sparse":
        b, h, hkv, sq, sk, d = spec.shape
        bq, bkv = p.get("bq", 128), p.get("bkv", 128)
        ml = p.get("max_live", 8)
        if sq % bq == 0 and sk % bkv == 0:
            for kind, deg in _kind_degree_pairs(degrees):
                if ml % deg == 0:
                    out.append(CoarseningConfig(kind, deg))
    elif fam == "flash_attention_bwd":
        b, h, hkv, sq, sk, d = spec.shape
        bq, bkv = p.get("bq", 128), p.get("bkv", 128)
        if sq % bq == 0:
            for kind, deg in _kind_degree_pairs(degrees):
                if sk % (bkv * deg) == 0:
                    out.append(CoarseningConfig(kind, deg))
    elif fam == "decode_attention":
        b, h, hkv, s, d = spec.shape
        bkv = p.get("bkv", 128)
        if s % bkv == 0:
            for kind, deg in _kind_degree_pairs(degrees):
                if s % (bkv * deg) == 0:
                    out.append(CoarseningConfig(kind, deg))
    elif fam in ("decode_attention_paged", "flash_attention_verify"):
        npp = spec.shape[-2]
        for kind, deg in _kind_degree_pairs(degrees):
            if npp % deg == 0:
                out.append(CoarseningConfig(kind, deg))
    elif fam == "moe_ffn":
        e = spec.shape[0]
        for kind, deg in _kind_degree_pairs(degrees):
            if e % deg == 0:
                out.append(CoarseningConfig(kind, deg))
    elif fam == "ssd":
        b, h, g, s, pp, nn = spec.shape
        if s % p.get("chunk", 64) == 0:
            for kind, deg in _kind_degree_pairs(degrees):
                if h % deg:
                    continue
                if kind == KIND_GAPPED and g != 1:
                    continue
                if kind == KIND_CONSECUTIVE and (h // g) % deg:
                    continue
                out.append(CoarseningConfig(kind, deg))
    elif fam == "rglru":
        b, s, d = spec.shape
        bd, bt = p.get("block_d", 128), p.get("block_t", 64)
        if s % bt == 0:
            for kind, deg in _kind_degree_pairs(degrees):
                if d % (bd * deg) == 0:
                    out.append(CoarseningConfig(kind, deg))
    else:
        raise ValueError(f"unknown tunable family {spec.family!r}")
    return out


def kernel_takes(spec: KernelSpec, cfg: CoarseningConfig) -> bool:
    """Whether the port's kernel of ``spec.family`` takes ``cfg`` at the
    spec's geometry: the wrapper's own ``takes`` / ``tileable`` rule."""
    fam, p = spec.family, spec.p
    elem = _DTYPE_BYTES.get(spec.dtype, 4)
    if fam in ("ew_stream", "gather_stream"):
        return cfg.vector_width in STREAM_WIDTHS
    if fam == "embed_gather":
        return _embed.takes(spec.shape[2])
    if fam == "matmul":
        m, n, k = spec.shape
        if not p.get("wbits"):
            return _matmul.tileable(m, n, k, cfg)
        return _matmul.quant_tileable(m, n, k, cfg, p["wbits"],
                                      p.get("group") or 0)
    if fam == "dp_scan":
        return cfg.kind != KIND_GAPPED
    if fam == "stencil5":
        rows, cols = spec.shape
        grid = rows // (p.get("block_rows", 8) * cfg.degree)
        return (cfg.vector_width in STREAM_WIDTHS
                and cols % cfg.vector_width == 0
                and grid // (cfg.replication if grid % cfg.replication == 0
                             else 1) <= MAX_GRID_Y)
    if fam in ("flash_attention", "flash_attention_bwd"):
        b, h, hkv, sq, sk, d = spec.shape
        return h % hkv == 0 and _flash.takes(
            d, cfg.degree, p.get("bq", 128), p.get("bkv", 128),
            kv_axis=fam == "flash_attention_bwd")
    if fam == "flash_attention_sparse":
        b, h, hkv, sq, sk, d = spec.shape
        return h % hkv == 0 and _sparse.takes(d, p.get("bq", 128),
                                              p.get("bkv", 128))
    if fam == "decode_attention":
        b, h, hkv, s, d = spec.shape
        return h % hkv == 0 and _decode.rows_takes(
            1, h // hkv, d, p.get("bkv", 128), elem)
    if fam == "decode_attention_paged":
        b, h, hkv, npp, d = spec.shape
        return h % hkv == 0 and _decode.rows_takes(
            1, h // hkv, d, p.get("page_size", 64), elem)
    if fam == "flash_attention_verify":
        b, h, hkv, t, npp, d = spec.shape
        return h % hkv == 0 and _decode.rows_takes(
            t, h // hkv, d, p.get("page_size", 64), elem)
    if fam == "moe_ffn":
        e, cap, d, f = spec.shape
        return _moe.takes(d, f, p.get("wbits"), p.get("group") or 0)
    if fam == "ssd":
        b, h, g, s, pp, n = spec.shape
        return _ssd.takes(h, g, n, pp, p.get("chunk", 64), cfg)
    if fam == "rglru":
        return _rglru.takes(spec.shape[1], cfg, p.get("block_d", 128))
    raise ValueError(f"unknown tunable family {spec.family!r}")


def enumerate_candidates(spec: KernelSpec,
                         degrees: Sequence[int] = DEGREES,
                         replications: Sequence[int] = REPLICATIONS,
                         vector_widths: Sequence[int] = VECTOR_WIDTHS,
                         ) -> list:
    """The reference's candidates for ``spec`` that the port's kernel of
    that family takes, in the reference's order."""
    return [cfg for cfg in _reference_candidates(spec, degrees, replications,
                                                 vector_widths)
            if kernel_takes(spec, cfg)]


# ---------------------------------------------------------------------------
# the model: the H100 bound of the spec's work
# ---------------------------------------------------------------------------

def work(spec: KernelSpec) -> tuple[float, float, float]:
    """(bytes, operations, peak operations/s) of one call at the spec's
    geometry: each input read once and each output written once."""
    fam, p = spec.family, spec.p
    elem = _DTYPE_BYTES.get(spec.dtype, 4)
    if fam == "ew_stream":
        n, nl = spec.shape[0], p.get("n_loads", 8)
        return 4 * n * (nl + 1), n * p.get("ai", 6) * (nl + 1), FP32_FLOPS
    if fam == "gather_stream":
        n, table = spec.shape
        nl = p.get("n_loads", 8)
        return (8 * n + 4 * nl * min(n, table),
                n * p.get("ai", 6) * (nl + 1), FP32_FLOPS)
    if fam == "embed_gather":
        n, _, d = spec.shape
        return 4 * n + n * d * elem + 4 * n * d, 0.0, FP32_FLOPS
    if fam == "matmul":
        m, n, k = spec.shape
        wbits = p.get("wbits")
        if wbits:
            group = p.get("group") or k
            w = k * n * wbits / 8 + 4 * n * max(1, k // group)
        else:
            w = k * n * elem
        return m * k * elem + w + 4 * m * n, 2.0 * m * n * k, BF16_FLOPS
    if fam in ("dp_scan", "stencil5"):
        rows, cols = spec.shape
        ops = (3 if fam == "dp_scan" else 6) * rows * cols
        return 8 * rows * cols, ops, FP32_FLOPS
    if fam in ("flash_attention", "flash_attention_bwd",
               "flash_attention_sparse"):
        b, h, hkv, sq, sk, d = spec.shape
        bq, bkv = p.get("bq", 128), p.get("bkv", 128)
        q, kv = b * h * sq * d, b * hkv * sk * d
        if fam == "flash_attention_sparse":
            pairs = b * h * p.get("n_live", (sq // bq) * (sk // bkv)) \
                * bq * bkv
        else:
            pairs = b * h * sq * sk * (0.5 if p.get("causal", True) else 1)
        if fam == "flash_attention_bwd":
            # q, k, v, do, m, l, delta in; dq, dk, dv out (float32)
            io = elem * (q + 2 * kv) + 4 * q + 12 * b * h * sq \
                + 4 * (q + 2 * kv)
            return io, 10.0 * pairs * d, BF16_FLOPS
        return elem * (q + 2 * kv) + 4 * q, 4.0 * pairs * d, BF16_FLOPS
    if fam in ("decode_attention", "decode_attention_paged",
               "flash_attention_verify"):
        if fam == "decode_attention":
            b, h, hkv, s, d = spec.shape
            t = 1
        else:
            b, h, hkv = spec.shape[:3]
            npp, d = spec.shape[-2:]
            t = spec.shape[3] if fam == "flash_attention_verify" else 1
            s = npp * p.get("page_size", 64)
        kv = 2 * b * s * hkv * (d * elem + (4 if p.get("kv_bits") else 0))
        return kv + 4 * b * t * h * d, 4.0 * b * t * h * s * d, BF16_FLOPS
    if fam == "moe_ffn":
        e, cap, d, f = spec.shape
        wbits = p.get("wbits")
        w = 3 * e * d * f * (wbits / 8 if wbits else elem)
        return (e * cap * d * elem + w + 4 * e * cap * (d + 1),
                6.0 * e * cap * d * f, BF16_FLOPS)
    if fam == "ssd":
        b, h, g, s, pp, n = spec.shape
        chunk = p.get("chunk", 64)
        nc = s // chunk
        # x, dt, B, C in and y out; what the function needs of the causal
        # products: the lower triangle of C.B^T once per (batch, group,
        # chunk) and of the intra-chunk W.x per (batch, head, chunk), the
        # state read after chunk 0 (the state is zero there) and the state
        # update before the last chunk per (batch, head)
        io = 4 * (2 * b * h * s * pp + b * h * s + h + 2 * b * g * s * n)
        tri = chunk * (chunk + 1)
        ops = float(b * (g * nc * n * tri + h * (
            nc * pp * tri + (nc - 1) * 4 * chunk * n * pp)))
        return io, ops, FP32_FLOPS
    if fam == "rglru":
        # x, r, i in and h out, a_param once; 17 f32 operations an element
        # (each exp, log1p and sqrt counted once), far below the bytes
        b, s, d = spec.shape
        return (4 * b * s * d + d) * 4, 17.0 * b * s * d, FP32_FLOPS
    raise ValueError(f"unknown tunable family {spec.family!r}")


def model_cost(spec: KernelSpec, cfg: CoarseningConfig) -> float:
    """Seconds of the H100 bound of one call at the spec's geometry: the
    larger of its bytes over 3.35 TB/s and its operations over the peak of
    their type.  The same for every ``cfg``: no model of this card ranks
    one label above another, only a measurement does."""
    del cfg
    io, ops, peak = work(spec)
    return max(io / HBM_BYTES_PER_S, ops / peak)


# ---------------------------------------------------------------------------
# search strategies (the reference's code)
# ---------------------------------------------------------------------------

def search(spec: KernelSpec, *,
           degrees: Sequence[int] = DEGREES,
           replications: Sequence[int] = REPLICATIONS,
           vector_widths: Sequence[int] = VECTOR_WIDTHS,
           measure: Optional[Callable] = None,
           strategy: str = "model",
           top_k: int = 3) -> TuneResult:
    """Rank all valid candidates for `spec` and return the winner.

    measure(spec, cfg) -> seconds enables the measured strategies:
      exhaustive — measure every candidate
      greedy     — measure the model's top_k, rank those by measured time
    """
    global SEARCH_COUNT
    SEARCH_COUNT += 1
    if strategy not in ("model", "exhaustive", "greedy"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy != "model" and measure is None:
        raise ValueError(f"strategy {strategy!r} needs a measure callable")

    cfgs = enumerate_candidates(spec, degrees, replications, vector_widths)
    if not cfgs:
        raise NoCandidate(f"no valid coarsening candidate for {spec.key}")
    cands = [Candidate(cfg, model_cost(spec, cfg)) for cfg in cfgs]
    cands = [c for c in cands if math.isfinite(c.modeled_s)]
    cands.sort(key=lambda c: c.modeled_s)

    if strategy == "model":
        return TuneResult(spec, cands[0].cfg, cands, source="model")

    to_measure = cands if strategy == "exhaustive" else cands[:top_k]
    measured = [dataclasses.replace(c, measured_s=float(measure(spec, c.cfg)))
                for c in to_measure]
    rest = cands[len(to_measure):] if strategy == "greedy" else []
    measured.sort(key=lambda c: c.measured_s)
    return TuneResult(spec, measured[0].cfg, measured + rest,
                      source="measured")


def autotune(spec: KernelSpec, *,
             cache: Optional[TuningCache] = None,
             measure: Optional[Callable] = None,
             strategy: str = "model",
             on_result: Optional[Callable] = None,
             **search_kw) -> CoarseningConfig:
    """Cache-through search: the winning config for `spec`, searching only
    on a cache miss and persisting the winner.  ``on_result(res)`` sees the
    full TuneResult on every miss (warm.py's calibration); hits carry no
    candidate list, so they do not call it."""
    if cache is None:
        cache = default_cache()
    hit = cache.get(spec)
    if hit is not None:
        return hit
    res = search(spec, measure=measure, strategy=strategy, **search_kw)
    best = res.candidates[0]
    cache.put(spec, res.best, modeled_s=best.modeled_s,
              measured_s=best.measured_s, source=res.source)
    if on_result is not None:
        on_result(res)
    return res.best
