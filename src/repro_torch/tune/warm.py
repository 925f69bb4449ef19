"""Cache warming for the launch drivers, and the measurer that times the
port's kernels on the card (`repro/tune/warm.py`).

`warm_for_model` derives the kernel specs a train or serve loop will file
from the ModelConfig, key for key as the reference does (the families,
shapes, dtypes and params of `repro/tune/warm.py:113-254`; only the
backend differs, "cuda"), and tunes each once, so that the first real step
already resolves ``cfg="auto"`` from the cache.  `wall_measurer` times
one candidate of a spec on the card.

Two deviations, stated:

* The reference skips a family on any ``ValueError`` around `autotune`
  (`warm.py:258-265`).  Here only `search`'s "no valid coarsening
  candidate" is a skip (`NoCandidate`: the port's kernel of the family
  takes no label at this geometry); every other error, a refused label or
  a failed launch among them, ends the warm.
* ``--tune auto|model`` ranks by the H100 bound, which is the same for
  every label (`search.model_cost`), so both pick base; ``greedy`` and
  ``exhaustive`` measure.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.tune.cache import KernelSpec, TuningCache, default_cache
from repro_torch.tune.search import (NoCandidate, autotune,
                                     enumerate_candidates)


def _round_down(n: int, q: int) -> int:
    return max(q, (n // q) * q)


# strategies the launch drivers accept for their --tune flag; "auto" is an
# alias of the bound-ranked "model"
TUNE_CHOICES = ("auto", "model", "greedy", "exhaustive")

# log(measured / modeled) buckets of the calibration histogram
RESIDUAL_BUCKETS = (-2.0, -1.0, -0.5, -0.25, -0.1, 0.0, 0.1, 0.25, 0.5,
                    1.0, 2.0)

# per-family calibration of the measured warms in this process
# (accumulated across warm_for_model calls); tune_report() formats it
LAST_CALIBRATION: dict[str, dict] = {}

DEFAULT_REPS = 10                   # timed calls a candidate, on the card


def warm_from_flag(cfg, tune: str, *, seq: int, batch: int,
                   cache: Optional[TuningCache] = None,
                   page_size: Optional[int] = None,
                   spec_k: Optional[int] = None, metrics=None) -> dict:
    """The launch drivers' --tune entry point: map the flag value to a
    (strategy, measurer) pair and warm the cache."""
    if tune not in TUNE_CHOICES:
        raise ValueError(f"tune must be one of {TUNE_CHOICES}, got {tune!r}")
    measure = wall_measurer() if tune in ("greedy", "exhaustive") else None
    strategy = "model" if tune == "auto" else tune
    return warm_for_model(cfg, seq=seq, batch=batch, cache=cache,
                          measure=measure, strategy=strategy,
                          page_size=page_size, spec_k=spec_k,
                          metrics=metrics)


def _calibration(res) -> Optional[dict]:
    """Model-vs-measured agreement for one TuneResult: pairwise rank
    concordance (ties skipped), top-1 pick match, and log(measured /
    modeled) residuals.  None when fewer than two candidates carry a
    measurement.  With the H100 bound as the model every pair ties on the
    model side, so the rank agreement reads 1.0 over 0 pairs, the model's
    pick is the first label in enumeration order (base, what the "model"
    strategy returns) and the residual is log(measured / bound)."""
    meas = [c for c in res.candidates if c.measured_s is not None
            and c.measured_s > 0 and c.modeled_s > 0]
    if len(meas) < 2:
        return None
    pairs = agree = 0
    for i in range(len(meas)):
        for j in range(i + 1, len(meas)):
            a, b = meas[i], meas[j]
            if a.modeled_s == b.modeled_s or a.measured_s == b.measured_s:
                continue
            pairs += 1
            agree += int((a.modeled_s < b.modeled_s)
                         == (a.measured_s < b.measured_s))
    order = [c.label for c in enumerate_candidates(res.spec)]
    model_pick = min(meas, key=lambda c: (c.modeled_s,
                                          order.index(c.cfg.label)))
    meas_pick = min(meas, key=lambda c: c.measured_s)
    resid = sorted(math.log(c.measured_s / c.modeled_s) for c in meas)
    return {
        "n_measured": len(meas),
        "rank_agreement": round(agree / pairs, 3) if pairs else 1.0,
        "top1_match": model_pick.cfg.label == meas_pick.cfg.label,
        "model_pick": model_pick.cfg.label,
        "measured_pick": meas_pick.cfg.label,
        "residuals": [round(r, 3) for r in resid],
        "residual_median": round(resid[len(resid) // 2], 3),
    }


def tune_report(cache: Optional[TuningCache] = None) -> str:
    """The --tune exit summary: cache hit/miss counts plus the per-family
    model-vs-measured calibration collected by this process's warms."""
    cache = default_cache() if cache is None else cache
    st = cache.stats
    lines = [f"tune: cache {st['hits']} hits / {st['misses']} misses "
             f"({len(cache)} entries at {cache.path})"]
    if not LAST_CALIBRATION:
        lines.append("tune: calibration n/a — no family measured this run "
                     "(cache hits, or --tune auto/model which never "
                     "measures)")
        return "\n".join(lines)
    lines.append("tune: model-vs-measured calibration "
                 "(rank agreement over measured candidates; residual = "
                 "median log(measured/modeled), 0 is perfect):")
    for fam in sorted(LAST_CALIBRATION):
        c = LAST_CALIBRATION[fam]
        pick = "top-1 MATCH" if c["top1_match"] else (
            f"top-1 MISS (model {c['model_pick']} vs measured "
            f"{c['measured_pick']})")
        lines.append(f"tune:   {fam}: rank {c['rank_agreement']:.0%} over "
                     f"{c['n_measured']} measured, {pick}, residual "
                     f"{c['residual_median']:+.3f}")
    return "\n".join(lines)


def model_specs(cfg, *, seq: int, batch: int,
                page_size: Optional[int] = None,
                spec_k: Optional[int] = None) -> dict:
    """{family: KernelSpec} of the kernels a step of ``cfg`` exercises at
    this geometry: `repro/tune/warm.py:113-254`, key for key."""
    toks = batch * seq
    d = cfg.d_model
    specs = {
        # elementwise residual/activation streams: toks*d elements
        "ew_stream": KernelSpec.make(
            "ew_stream", (_round_down(toks * d, 1024 * 16),),
            n_loads=2, ai=6, variant="base", block=1024),
        # embedding lookup: toks ids against the padded vocab table
        "embed_gather": KernelSpec.make(
            "embed_gather", (_round_down(toks, 256 * 8), cfg.vocab_padded, d),
            block=256),
        # the block matmul (toks, d) @ (d, d_ff)
        "matmul": KernelSpec.make(
            "matmul", (_round_down(toks, 128 * 8),
                       _round_down(cfg.d_ff, 128),
                       _round_down(d, 256)),
            dtype="bfloat16", bm=128, bn=128, bk=256),
        # split-KV decode attention at the full allocated cache length
        "decode_attention": KernelSpec.make(
            "decode_attention",
            (batch, cfg.n_heads, cfg.n_kv_heads, seq, cfg.hd),
            dtype="bfloat16", bkv=min(128, seq), window=0),
        # training flash attention: the forward (q-row axis) and the
        # dK/dV backward (kv-block axis) tune independent degrees
        "flash_attention": KernelSpec.make(
            "flash_attention",
            (batch, cfg.n_heads, cfg.n_kv_heads, seq, seq, cfg.hd),
            dtype="bfloat16", bq=min(128, seq), bkv=min(128, seq),
            causal=True),
        "flash_attention_bwd": KernelSpec.make(
            "flash_attention_bwd",
            (batch, cfg.n_heads, cfg.n_kv_heads, seq, seq, cfg.hd),
            dtype="bfloat16", bq=min(128, seq), bkv=min(128, seq),
            causal=True),
    }
    wbits = {"int8": 8, "int4": 4}.get(getattr(cfg, "quant", "none"))
    if wbits:
        specs["matmul_q"] = KernelSpec.make(
            "matmul", (_round_down(toks, 128 * 8),
                       _round_down(cfg.d_ff, 128),
                       _round_down(d, 256)),
            dtype="bfloat16", bm=128, bn=128, bk=256, wbits=wbits,
            group=cfg.quant_group if wbits == 4 else 0)
    if getattr(cfg, "kv_quant", "none") == "int8":
        specs["decode_attention_q"] = KernelSpec.make(
            "decode_attention",
            (batch, cfg.n_heads, cfg.n_kv_heads, seq, cfg.hd),
            dtype="int8", bkv=min(128, seq), window=0, kv_bits=8)
    if cfg.n_experts:
        from repro_torch.models.layers import moe_default_capacity
        cap = moe_default_capacity(toks, cfg.n_experts, cfg.top_k)
        specs["moe_ffn"] = KernelSpec.make(
            "moe_ffn", (cfg.n_experts_padded, cap, d, cfg.moe_d_ff),
            dtype="bfloat16")
        if wbits:
            specs["moe_ffn_q"] = KernelSpec.make(
                "moe_ffn", (cfg.n_experts_padded, cap, d, cfg.moe_d_ff),
                dtype="bfloat16", wbits=wbits,
                group=cfg.quant_group if wbits == 4 else 0)
        # the decode step's own capacity (a distinct key)
        cap_dec = min(batch, max(4, min(batch, 4 * cfg.top_k)))
        if cap_dec != cap:
            specs["moe_ffn_decode"] = KernelSpec.make(
                "moe_ffn", (cfg.n_experts_padded, cap_dec, d, cfg.moe_d_ff),
                dtype="bfloat16")
    if cfg.window:
        specs["decode_attention_local"] = KernelSpec.make(
            "decode_attention",
            (batch, cfg.n_heads, cfg.n_kv_heads, seq, cfg.hd),
            dtype="bfloat16", bkv=min(128, seq), window=cfg.window)
        bq_s, bkv_s = min(cfg.attn_bq, seq), min(cfg.attn_bkv, seq)
        if seq % bq_s == 0 and seq % bkv_s == 0:
            from repro_torch.kernels.sparse_attention import build_block_index
            gs = getattr(cfg, "attn_global_stride", None)
            sidx = build_block_index(seq, seq, bq_s, bkv_s, causal=True,
                                     window=cfg.window, global_stride=gs)
            specs["flash_attention_sparse"] = KernelSpec.make(
                "flash_attention_sparse",
                (batch, cfg.n_heads, cfg.n_kv_heads, seq, seq, cfg.hd),
                dtype="bfloat16", bq=bq_s, bkv=bkv_s, causal=True,
                window=cfg.window, gstride=gs or 0,
                max_live=int(sidx.shape[1]), n_live=int((sidx >= 0).sum()))
    if page_size:
        npp = max(1, seq // page_size)
        kv_q = getattr(cfg, "kv_quant", "none") == "int8"
        kvp = {"kv_bits": 8} if kv_q else {}
        specs["decode_attention_paged"] = KernelSpec.make(
            "decode_attention_paged",
            (batch, cfg.n_heads, cfg.n_kv_heads, npp, cfg.hd),
            dtype="int8" if kv_q else "bfloat16", page_size=page_size,
            window=0, **kvp)
        if cfg.window:
            specs["decode_attention_paged_local"] = KernelSpec.make(
                "decode_attention_paged",
                (batch, cfg.n_heads, cfg.n_kv_heads, npp, cfg.hd),
                dtype="int8" if kv_q else "bfloat16", page_size=page_size,
                window=cfg.window, **kvp)
        if spec_k:
            # the batched-verify family at T = K+1 rows
            specs["flash_attention_verify"] = KernelSpec.make(
                "flash_attention_verify",
                (batch, cfg.n_heads, cfg.n_kv_heads, spec_k + 1, npp,
                 cfg.hd),
                dtype="int8" if kv_q else "bfloat16", page_size=page_size,
                window=0, **kvp)
    return specs


def warm_for_model(cfg, *, seq: int, batch: int,
                   cache: Optional[TuningCache] = None,
                   measure=None, strategy: str = "model",
                   verbose: bool = True,
                   page_size: Optional[int] = None,
                   spec_k: Optional[int] = None, metrics=None) -> dict:
    """Tune the kernel families a model step exercises; returns {family:
    winning label}.  ``cfg`` is a repro_torch ModelConfig.

    With ``metrics`` (an obs Registry), each measured family's calibration
    lands in ``tune_rank_agreement{family=...}`` / ``tune_top1_match`` /
    the ``tune_residual_logratio`` histogram, and in LAST_CALIBRATION for
    tune_report()."""
    cache = default_cache() if cache is None else cache
    out = {}
    for fam, spec in model_specs(cfg, seq=seq, batch=batch,
                                 page_size=page_size,
                                 spec_k=spec_k).items():
        results = []
        try:
            best = autotune(spec, cache=cache, measure=measure,
                            strategy=strategy, on_result=results.append)
        except NoCandidate as e:   # no label the port's kernel takes here
            if verbose:
                print(f"tune: {fam}: skipped ({e})")
            continue
        out[fam] = best.label
        if verbose:
            print(f"tune: {fam} {spec.shape} -> {best.label}")
        cal = _calibration(results[0]) if results else None
        if cal is not None:
            LAST_CALIBRATION[fam] = cal
            if metrics is not None:
                metrics.gauge("tune_rank_agreement",
                              family=fam).set(cal["rank_agreement"])
                metrics.gauge("tune_top1_match",
                              family=fam).set(int(cal["top1_match"]))
                h = metrics.histogram("tune_residual_logratio",
                                      RESIDUAL_BUCKETS,
                                      "log(measured_s / modeled_s)")
                for r in cal["residuals"]:
                    h.observe(r)
    return out


def _case(spec: KernelSpec, cfg, device="cuda"):
    """() -> output: one call of the port's op for ``spec`` under ``cfg``,
    on inputs at the reference measurer's shapes and scales
    (`repro/tune/warm.py:284-516`) from a generator seeded with 0 on
    ``device`` (the card; the CPU tests build the same calls at small
    shapes, where they take the plain versions)."""
    from repro_torch.core.coarsening import BASE
    from repro_torch.kernels import gather_stream as gs
    from repro_torch.kernels import ops
    from repro_torch.quant import quantize, quantize_kv

    fam, p = spec.family, spec.p
    gen = torch.Generator(device=device).manual_seed(0)
    dt = torch.bfloat16 if spec.dtype in ("bfloat16", "int8") \
        else torch.float32

    def _normal(gen, shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=gen, device=device)
        return (x * scale).to(dtype)

    def _uniform(gen, shape):
        return torch.rand(shape, generator=gen, device=device)

    def kv_quant(x):
        return quantize_kv(x.float())

    if fam == "ew_stream":
        n = spec.shape[0]
        xs = tuple(_normal(gen, (n,)) for _ in range(p.get("n_loads", 8)))
        return lambda: ops.ew_stream(xs, cfg, ai=p.get("ai", 6),
                                     variant=p.get("variant", "base"),
                                     block=p.get("block", 1024))
    if fam == "gather_stream":
        n, table = spec.shape
        idx = torch.from_numpy(gs.make_indices(
            n, table, int(p.get("window_elems", 8192)), seed=0)).to(device)
        tabs = tuple(_normal(gen, (table,))
                     for _ in range(p.get("n_loads", 8)))
        return lambda: ops.gather_stream(idx, tabs, cfg, ai=p.get("ai", 6),
                                         block=p.get("block", 1024))
    if fam == "embed_gather":
        n, vocab, d = spec.shape
        ids = torch.randint(0, vocab, (n,), generator=gen, device=device,
                            dtype=torch.int32)
        table = _normal(gen, (vocab, d), dt)
        return lambda: ops.embed_gather(ids, table, cfg,
                                        block=p.get("block", 256))
    if fam == "matmul":
        m, n, k = spec.shape
        a = _normal(gen, (m, k), dt)
        b = _normal(gen, (k, n), dt)
        if p.get("wbits"):
            qw = quantize(b.float(), "int8" if p["wbits"] == 8 else "int4",
                          group=p.get("group") or 32)
            return lambda: ops.quant_matmul(a, qw, cfg)
        return lambda: ops.matmul(a, b, cfg)
    if fam == "dp_scan":
        c = _uniform(gen, spec.shape)
        return lambda: ops.dp_scan(c, cfg)
    if fam == "stencil5":
        x = _normal(gen, spec.shape)
        return lambda: ops.stencil5(x, cfg,
                                    block_rows=p.get("block_rows", 8))
    if fam == "decode_attention":
        b, h, hkv, s, d = spec.shape
        q = _normal(gen, (b, 1, h, d), torch.bfloat16)
        kc = _normal(gen, (b, s, hkv, d), torch.bfloat16)
        vc = _normal(gen, (b, s, hkv, d), torch.bfloat16)
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=device)
        kw = dict(bkv=p.get("bkv", 128), window=p.get("window", 0) or None)
        if p.get("kv_bits"):
            (kq, ks), (vq, vs) = kv_quant(kc), kv_quant(vc)
            return lambda: ops.decode_attention(q, kq, vq, pos, cfg,
                                                k_scale=ks, v_scale=vs, **kw)
        return lambda: ops.decode_attention(q, kc, vc, pos, cfg, **kw)
    if fam in ("decode_attention_paged", "flash_attention_verify"):
        b, h, hkv = spec.shape[:3]
        t = spec.shape[3] if fam == "flash_attention_verify" else 1
        npp, d = spec.shape[-2:]
        ps = p.get("page_size", 64)
        # a worst-case fragmented pool: every slot's pages permuted
        n_pages = b * npp + 1
        q = _normal(gen, (b, t, h, d), torch.bfloat16)
        kp = _normal(gen, (n_pages, ps, hkv, d), torch.bfloat16)
        vp = _normal(gen, (n_pages, ps, hkv, d), torch.bfloat16)
        bt = (torch.randperm(n_pages - 1, generator=gen, device=device) + 1
              ).reshape(b, npp).to(torch.int32)
        pos = torch.full((b,), npp * ps - t, dtype=torch.int32,
                         device=device)
        op = ops.flash_attention_verify if fam == "flash_attention_verify" \
            else ops.paged_decode_attention
        w = p.get("window", 0) or None
        if p.get("kv_bits"):
            (kq, ks), (vq, vs) = kv_quant(kp), kv_quant(vp)
            return lambda: op(q, kq, vq, bt, pos, cfg, window=w, k_scale=ks,
                              v_scale=vs)
        return lambda: op(q, kp, vp, bt, pos, cfg, window=w)
    if fam in ("flash_attention", "flash_attention_bwd",
               "flash_attention_sparse"):
        b, h, hkv, sq, sk, d = spec.shape
        q = _normal(gen, (b, h, sq, d), dt, 0.5)
        kk = _normal(gen, (b, hkv, sk, d), dt, 0.5)
        vv = _normal(gen, (b, hkv, sk, d), dt)
        kw = dict(bq=p.get("bq", 128), bkv=p.get("bkv", 128),
                  causal=bool(p.get("causal", True)))
        if fam == "flash_attention":
            return lambda: ops.flash_attention(q, kk, vv, cfg, **kw)
        if fam == "flash_attention_sparse":
            return lambda: ops.flash_attention_sparse(
                q, kk, vv, cfg, window=p.get("window") or None,
                global_stride=p.get("gstride") or None, **kw)
        # the backward cfg controls: gradients through the op at a base
        # forward with bwd_cfg pinned (the reference's jax.grad, :444-467)
        kk.requires_grad_(True)
        vv.requires_grad_(True)

        def bwd():
            with torch.enable_grad():
                o = ops.flash_attention(q, kk, vv, BASE, bwd_cfg=cfg, **kw)
                return torch.autograd.grad(o.sum(), (kk, vv))
        return bwd
    if fam == "moe_ffn":
        e, cap, d, f = spec.shape
        xe = _normal(gen, (e, cap, d), dt)
        w1 = _normal(gen, (e, d, f), dt)
        w3 = _normal(gen, (e, d, f), dt)
        w2 = _normal(gen, (e, f, d), dt)
        wts = _uniform(gen, (e, cap))
        if p.get("wbits"):
            mode = "int8" if p["wbits"] == 8 else "int4"
            q1, q3, q2 = (quantize(w.float(), mode, group=p.get("group") or 32)
                          for w in (w1, w3, w2))
            return lambda: ops.quant_moe_ffn(xe, q1, q3, q2, wts, cfg)
        return lambda: ops.moe_ffn(xe, w1, w3, w2, wts, cfg)
    if fam == "ssd":
        args = ssd_inputs(spec.shape, gen, device)
        return lambda: ops.ssd(*args, cfg, chunk=p.get("chunk", 64))
    if fam == "rglru":
        args = rglru_inputs(spec.shape, gen, device)
        return lambda: ops.rglru(*args, cfg, block_d=p.get("block_d", 128),
                                 block_t=p.get("block_t", 64))
    raise ValueError(f"wall_measurer: unsupported family {fam!r}")


def ssd_inputs(shape, gen: torch.Generator, device) -> tuple:
    """(x, dt, a, bmat, cmat) of an SSD spec's shape (b, h, g, s, p, n),
    at the reference measurer's scales (`repro/tune/warm.py:422-434`):
    x and B, C normal * 0.5, dt = softplus(normal), a = -softplus(normal)
    (softplus as JAX writes it)."""
    from repro_torch.kernels.ref import softplus
    b, h, g, s, p, n = shape
    x, dt, a, bm, cm = (torch.randn(size, generator=gen, device=device)
                        for size in ((b, h, s, p), (b, h, s), (h,),
                                     (b, g, s, n), (b, g, s, n)))
    return x * 0.5, softplus(dt), -softplus(a), bm * 0.5, cm * 0.5


def rglru_inputs(shape, gen: torch.Generator, device) -> tuple:
    """(x, r, i, a_param) of an RG-LRU spec's shape (b, s, d), at the
    reference measurer's scales (`repro/tune/warm.py:435-441`): x normal *
    0.5, the gates and a_param normal."""
    b, s, d = shape
    x, r, i, a_param = (torch.randn(size, generator=gen, device=device)
                        for size in ((b, s, d),) * 3 + ((d,),))
    return x * 0.5, r, i, a_param


def wall_measurer(reps: int = DEFAULT_REPS):
    """measure(spec, cfg) -> seconds: the median device time of one call of
    the port's op on the card (`repro_torch.bench.common.time_ms`: CUDA
    events, L2 flushed and a device sleep queued ahead of each call).  The
    card only: there is no CPU timing of plain versions."""
    if not torch.cuda.is_available():
        raise ValueError("wall_measurer times the port's kernels on a CUDA "
                         "card, and none is available (--tune greedy and "
                         "exhaustive need the card; auto and model do not "
                         "measure)")
    from repro_torch.bench.common import time_ms

    def measure(spec: KernelSpec, cfg) -> float:
        with torch.no_grad():
            fn = _case(spec, cfg)
            return time_ms(fn, reps=reps) / 1e3

    return measure
