"""The port's coarsening autotuner (`repro_torch.tune`) and the embed-gather
kernel's plain version, held against the JAX package on the CPU.

* Legality: the port's candidates are a subset of the reference's for every
  spec the warm builds, and every one of them is taken by its kernel's own
  rule; for the SSD and RG-LRU families (which no warm spec selects) they
  are the reference's intersected with the kernels' ``takes``.
* Keys: `warm_for_model` files the reference's spec keys, and every op and
  layer dispatch files the reference op's key for the same call (backend
  aside: the reference files "pallas", the port "cuda", or "ref" on its
  plain path).
* Search: with one deterministic stub measurer, exhaustive search picks the
  reference's label wherever the two candidate sets are equal.
* The cache: round trip, version invalidation, hits that skip the search,
  "auto" resolved from a persisted winner, and the plain path that writes
  nothing; a measurer's error ends a warm instead of skipping a family.
* The launchers' ``--tune model --device cpu`` lines.
* Row 14: `ref.embed_gather` bit for bit against the reference's plain
  version and its Pallas kernel in interpret mode under all 7 labels, ids
  in range and clamped.

Inputs are made from seeds with numpy.  The reference's `resolve_cfg` is
replaced by a recorder wherever a reference op is called with "auto", so no
test writes the reference's tuning cache; the port's cache is a file under
``tmp_path`` named by ``REPRO_TORCH_TUNE_CACHE``.  No test builds or
launches a kernel.
"""
import dataclasses
import importlib
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.coarsening import CoarseningConfig as JCfg
from repro.kernels import embed_gather as jeg
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.quant import quantize as j_quantize
from repro.quant import quantize_kv as j_quantize_kv
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.coarsening import (BASE, CoarseningConfig, plan_stream,
                                         stream_owners)
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import embed_gather as teg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import moe_ffn as tmoe
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru as trg
from repro_torch.kernels import sparse_attention as tsp
from repro_torch.kernels import ssd as tssd
from repro_torch.models import layers as TL
from repro_torch.quant import quantize as t_quantize
from repro_torch.quant import quantize_kv as t_quantize_kv
# both packages re-export search() under the submodule's name
tcache = importlib.import_module("repro_torch.tune.cache")
tsearch = importlib.import_module("repro_torch.tune.search")
twarm = importlib.import_module("repro_torch.tune.warm")
jsearch = importlib.import_module("repro.tune.search")
jwarm = importlib.import_module("repro.tune.warm")
jcache = importlib.import_module("repro.tune.cache")

# the reference's warm divides by mamba2's zero kv heads
# (`repro/core/analysis.py:512`), so the parity grid leaves it out
PARITY_ARCHS = [a for a in ARCHS if a != "mamba2-370m"]
# (seq, batch, page_size, spec_k): serve, spec serve, train, long-context
# and tiny geometries
GEOMETRIES = [(1024, 8, 16, None), (1024, 8, 16, 4), (1024, 4, None, None),
              (4096, 1, 16, 4), (512, 2, 64, 2), (64, 2, 8, 2)]
QUANTS = [("none", "none"), ("int8", "int8"), ("int4", "none")]


@pytest.fixture(autouse=True)
def scratch_caches(tmp_path, monkeypatch):
    """Every test reads and writes tuning caches under tmp_path only."""
    monkeypatch.setenv(tcache.ENV_VAR, str(tmp_path / "port_tune.json"))
    monkeypatch.setenv(jcache.ENV_VAR, str(tmp_path / "ref_tune.json"))
    tops._auto_cfg.cache_clear()
    twarm.LAST_CALIBRATION.clear()
    yield
    tops._auto_cfg.cache_clear()
    twarm.LAST_CALIBRATION.clear()
    jwarm.LAST_CALIBRATION.clear()


def _configs(arch):
    for quant, kv in QUANTS:
        yield (dataclasses.replace(j_get_config(arch), quant=quant,
                                   kv_quant=kv),
               dataclasses.replace(t_get_config(arch), quant=quant,
                                   kv_quant=kv))


def _jspec(spec):
    """The reference's KernelSpec of a port spec (backend "pallas")."""
    return jcache.KernelSpec(family=spec.family, shape=spec.shape,
                             dtype=spec.dtype, backend="pallas",
                             params=spec.params)


def _nobackend(key: str) -> str:
    fam, shp, dt, _, prm = key.split("|")
    return "|".join((fam, shp, dt, prm))


def _labels(cfgs) -> list:
    return [c.label for c in cfgs]


def _port_specs():
    for arch in PARITY_ARCHS:
        for _, tcfg in _configs(arch):
            for seq, batch, ps, k in GEOMETRIES:
                yield from twarm.model_specs(tcfg, seq=seq, batch=batch,
                                             page_size=ps,
                                             spec_k=k).values()


# -- legality -----------------------------------------------------------------

@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_candidates_are_a_subset_of_the_reference(arch):
    for _, tcfg in _configs(arch):
        for seq, batch, ps, k in GEOMETRIES:
            for spec in twarm.model_specs(tcfg, seq=seq, batch=batch,
                                          page_size=ps, spec_k=k).values():
                ours = _labels(tsearch.enumerate_candidates(spec))
                theirs = _labels(jsearch.enumerate_candidates(_jspec(spec)))
                assert set(ours) <= set(theirs), spec.key
                # in the reference's order
                assert ours == [x for x in theirs if x in set(ours)]


def _taken(spec, cfg) -> bool:
    """The family's kernel rule, read off the wrappers one by one."""
    fam, p = spec.family, spec.p
    elem = {"int8": 1, "bfloat16": 2}.get(spec.dtype, 4)
    if fam == "ew_stream":
        return cfg.vector_width in (1, 2, 4, 8)
    if fam == "embed_gather":
        return teg.takes(spec.shape[2])
    if fam == "matmul":
        if p.get("wbits"):
            return tmm.quant_tileable(*spec.shape, cfg, p["wbits"],
                                      p["group"])
        return tmm.tileable(*spec.shape, cfg)
    if fam in ("flash_attention", "flash_attention_bwd"):
        return tfa.takes(spec.shape[5], cfg.degree, p["bq"], p["bkv"],
                         kv_axis=fam == "flash_attention_bwd")
    if fam == "flash_attention_sparse":
        return tsp.takes(spec.shape[5], p["bq"], p["bkv"])
    b, h, hkv = spec.shape[:3]
    if fam == "decode_attention":
        return tdec.rows_takes(1, h // hkv, spec.shape[4], p["bkv"], elem)
    if fam == "decode_attention_paged":
        return tdec.rows_takes(1, h // hkv, spec.shape[4], p["page_size"],
                               elem)
    if fam == "flash_attention_verify":
        return tdec.rows_takes(spec.shape[3], h // hkv, spec.shape[5],
                               p["page_size"], elem)
    if fam == "moe_ffn":
        e, c, d, f = spec.shape
        return tmoe.takes(d, f, p.get("wbits"), p.get("group", 0))
    if fam == "ssd":
        b, h, g, s, pp, n = spec.shape
        return tssd.takes(h, g, n, pp, p["chunk"], cfg)
    if fam == "rglru":
        return trg.takes(spec.shape[1], cfg, p["block_d"])
    raise AssertionError(fam)


def test_every_candidate_is_taken_by_its_kernel():
    seen = set()
    for spec in _port_specs():
        for cfg in tsearch.enumerate_candidates(spec):
            assert _taken(spec, cfg), (spec.key, cfg.label)
            seen.add(spec.family)
    assert seen >= {"ew_stream", "embed_gather", "matmul", "moe_ffn",
                    "decode_attention", "decode_attention_paged",
                    "flash_attention", "flash_attention_bwd",
                    "flash_attention_sparse", "flash_attention_verify"}


def test_labels_the_kernels_refuse_are_not_enumerated():
    """The reference enumerates con8 / gap8 matmuls, flash programs of
    1024 rows and dequant-fused degrees past 2; the port does not."""
    mm = tcache.KernelSpec.make("matmul", (8192, 3072, 1024),
                                dtype="bfloat16", bm=128, bn=128, bk=256)
    assert {"con8", "gap8", "con4+simd2"} <= set(_labels(
        jsearch.enumerate_candidates(_jspec(mm))))
    assert not {"con8", "gap8", "con4+simd2"} & set(_labels(
        tsearch.enumerate_candidates(mm)))
    qmm = tcache.KernelSpec.make("matmul", (8192, 3072, 1024),
                                 dtype="bfloat16", bm=128, bn=128, bk=256,
                                 wbits=8, group=0)
    assert _labels(tsearch.enumerate_candidates(qmm)) == ["base", "con2",
                                                          "gap2"]
    fa = tcache.KernelSpec.make("flash_attention", (1, 4, 1, 4096, 4096, 256),
                                dtype="bfloat16", bq=128, bkv=128,
                                causal=True)
    assert _labels(tsearch.enumerate_candidates(fa)) == ["base"]
    eg = tcache.KernelSpec.make("embed_gather", (2048, 100, 6), block=256)
    with pytest.raises(tsearch.NoCandidate):
        tsearch.search(eg)
    # ssd and rglru: the reference's candidates that `takes` admits
    for spec, refused in (
            (tcache.KernelSpec.make("ssd", (1, 8, 1, 128, 64, 16), chunk=64),
             set()),
            (tcache.KernelSpec.make("ssd", (1, 8, 2, 128, 64, 16), chunk=32),
             set()),
            (tcache.KernelSpec.make("ssd", (1, 8, 1, 128, 64, 16), chunk=16),
             {"base", "con2", "gap2", "con4", "gap4", "con8", "gap8"}),
            (tcache.KernelSpec.make("rglru", (1, 128, 256), block_d=128,
                                    block_t=64), set()),
            (tcache.KernelSpec.make("rglru", (1, 128, 2048), block_d=256,
                                    block_t=64), {"con8", "gap8"})):
        theirs = _labels(jsearch.enumerate_candidates(_jspec(spec)))
        ours = _labels(tsearch.enumerate_candidates(spec))
        assert ours == [lab for lab in theirs
                        if _taken(spec, CoarseningConfig.parse(lab))]
        assert set(theirs) - set(ours) == refused, spec.key


# -- keys ---------------------------------------------------------------------

def _stub(spec, cfg) -> float:
    """One deterministic pseudo-time a (spec, label)."""
    return 1.0 + zlib.crc32(f"{spec.family}|{cfg.label}".encode()) / 2**32


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_warm_files_the_reference_keys(arch, tmp_path, monkeypatch, capsys):
    for i, (jcfg, tcfg) in enumerate(_configs(arch)):
        for j, (seq, batch, ps, k) in enumerate(GEOMETRIES):
            monkeypatch.setenv(jcache.ENV_VAR, str(tmp_path / f"r{i}_{j}"))
            jwarm.warm_for_model(jcfg, seq=seq, batch=batch, page_size=ps,
                                 spec_k=k, strategy="model", verbose=False)
            theirs = {_nobackend(key) for key in jcache.default_cache()
                      .entries}
            cache = tcache.TuningCache(str(tmp_path / f"p{i}_{j}"))
            out = twarm.warm_for_model(tcfg, seq=seq, batch=batch,
                                       page_size=ps, spec_k=k, cache=cache,
                                       measure=_stub, strategy="exhaustive")
            ours = {_nobackend(key) for key in cache.entries}
            assert all(key.split("|")[3] == "cuda" for key in cache.entries)
            assert ours <= theirs
            specs = {_nobackend(s.key): s for s in twarm.model_specs(
                tcfg, seq=seq, batch=batch, page_size=ps,
                spec_k=k).values()}
            for key in theirs - ours:  # only where the port's kernel takes
                assert not tsearch.enumerate_candidates(specs[key])  # none
            assert all(cache.entries[s.key]["cfg"] == out[f] for f, s in
                       twarm.model_specs(tcfg, seq=seq, batch=batch,
                                         page_size=ps, spec_k=k).items()
                       if f in out)
    capsys.readouterr()


def test_model_specs_build_the_reference_specs(monkeypatch):
    """Every spec the reference's warm builds (its `autotune` calls,
    recorded) is a spec of `model_specs`, key for key."""
    recorded = []
    monkeypatch.setattr(jwarm, "autotune", lambda spec, **kw: (
        recorded.append(spec), JCfg())[1])
    for arch in PARITY_ARCHS:
        for jcfg, tcfg in _configs(arch):
            for seq, batch, ps, k in GEOMETRIES:
                recorded.clear()
                jwarm.warm_for_model(jcfg, seq=seq, batch=batch,
                                     page_size=ps, spec_k=k, verbose=False)
                ours = [_nobackend(s.key) for s in twarm.model_specs(
                    tcfg, seq=seq, batch=batch, page_size=ps,
                    spec_k=k).values()]
                assert ours == [_nobackend(s.key) for s in recorded]


def _reference(call):
    """Run a reference call whose key is filed before its kernel runs; a
    Pallas kernel that calls the removed ``pl.load`` fails after that
    (ROADMAP, faults of the reference)."""
    try:
        return call()
    except AttributeError as e:
        if "has no attribute 'load'" not in str(e):
            raise
        return None


class _Recorder:
    """Stands in for a package's `resolve_cfg`: records the key and returns
    that package's base config."""

    def __init__(self, base):
        self.base, self.keys = base, []

    def __call__(self, cfg, family, shape, *, dtype="float32",
                 backend="pallas", **params):
        if cfg == "auto":
            prm = ",".join(f"{k}={v}" for k, v in sorted(params.items()))
            self.keys.append("|".join((family, "x".join(
                str(int(s)) for s in shape), str(dtype), prm)))
            return self.base
        return cfg if not isinstance(cfg, str) else type(self.base).parse(cfg)


@pytest.fixture
def recorders(monkeypatch):
    jrec, trec = _Recorder(JCfg()), _Recorder(BASE)
    monkeypatch.setattr(jops, "resolve_cfg", jrec)
    monkeypatch.setattr(tops, "resolve_cfg", trec)
    return jrec, trec


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(x: np.ndarray, dtype: str):
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32,
          "int8": jnp.int8, "int32": jnp.int32}[dtype]
    td = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8, "int32": torch.int32}[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(np.array(x)).to(td)


def _ops_cases():
    r = _rng(0)
    cases = {}
    xs = [r.standard_normal(2048).astype(np.float32) for _ in range(3)]
    js, ts = zip(*(_pair(x, "float32") for x in xs))
    cases["ew_stream"] = (lambda: jops.ew_stream(js, "auto", ai=4),
                          lambda: tops.ew_stream(ts, "auto", ai=4))
    idx = r.integers(0, 512, 2048).astype(np.int32)
    (ji, ti), tabs = _pair(idx, "int32"), [
        _pair(r.standard_normal(512).astype(np.float32), "float32")
        for _ in range(2)]
    cases["gather_stream"] = (
        lambda: jops.gather_stream(ji, [t[0] for t in tabs], "auto"),
        lambda: tops.gather_stream(ti, [t[1] for t in tabs], "auto"))
    a, b = (r.standard_normal(s).astype(np.float32)
            for s in ((128, 256), (256, 256)))
    (ja, ta), (jb, tb) = _pair(a, "bfloat16"), _pair(b, "bfloat16")
    cases["matmul"] = (lambda: jops.matmul(ja, jb, "auto"),
                       lambda: tops.matmul(ta, tb, "auto"))
    for mode in ("int8", "int4"):
        jq, tq = j_quantize(jnp.asarray(b), mode, group=32), t_quantize(
            torch.from_numpy(b), mode, group=32)
        cases[f"quant_matmul_{mode}"] = (
            lambda jq=jq: jops.quant_matmul(ja, jq, "auto"),
            lambda tq=tq: tops.quant_matmul(ta, tq, "auto"))
    g = r.standard_normal((64, 256)).astype(np.float32)
    (jg, tg) = _pair(g, "float32")
    cases["stencil5"] = (lambda: jops.stencil5(jg, "auto"),
                         lambda: tops.stencil5(tg, "auto"))
    cases["dp_scan"] = (lambda: jops.dp_scan(jg, "auto"),
                        lambda: tops.dp_scan(tg, "auto"))
    ids = r.integers(0, 300, 512).astype(np.int32)
    table = r.standard_normal((300, 64)).astype(np.float32)
    (jid, tid), (jt, tt) = _pair(ids, "int32"), _pair(table, "float32")
    cases["embed_gather"] = (lambda: jops.embed_gather(jid, jt, "auto"),
                             lambda: tops.embed_gather(tid, tt, "auto"))
    # decode families: B 2, H 4 / Hkv 2, D 32
    q1 = r.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc, vc = (r.standard_normal((2, 64, 2, 32)).astype(np.float32)
              for _ in range(2))
    pos = np.array([40, 63], np.int32)
    (jq1, tq1), (jp, tp) = _pair(q1, "bfloat16"), _pair(pos, "int32")
    (jk, tk), (jv, tv) = _pair(kc, "bfloat16"), _pair(vc, "bfloat16")
    cases["decode_attention"] = (
        lambda: jops.decode_attention(jq1, jk, jv, jp, "auto", bkv=32,
                                      window=16),
        lambda: tops.decode_attention(tq1, tk, tv, tp, "auto", bkv=32,
                                      window=16))
    jkq, jks = j_quantize_kv(jnp.asarray(kc))
    jvq, jvs = j_quantize_kv(jnp.asarray(vc))
    tkq, tks = t_quantize_kv(torch.from_numpy(kc))
    tvq, tvs = t_quantize_kv(torch.from_numpy(vc))
    cases["decode_attention_int8"] = (
        lambda: jops.decode_attention(jq1, jkq, jvq, jp, "auto", bkv=32,
                                      k_scale=jks, v_scale=jvs),
        lambda: tops.decode_attention(tq1, tkq, tvq, tp, "auto", bkv=32,
                                      k_scale=tks, v_scale=tvs))
    kp, vp = (r.standard_normal((9, 8, 2, 32)).astype(np.float32)
              for _ in range(2))
    bt = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    qt = r.standard_normal((2, 3, 4, 32)).astype(np.float32)
    (jkp, tkp), (jvp, tvp) = _pair(kp, "bfloat16"), _pair(vp, "bfloat16")
    (jbt, tbt), (jqt, tqt) = _pair(bt, "int32"), _pair(qt, "bfloat16")
    pos0 = np.array([20, 25], np.int32)
    (jp0, tp0) = _pair(pos0, "int32")
    jkpq, jkps = j_quantize_kv(jnp.asarray(kp))
    jvpq, jvps = j_quantize_kv(jnp.asarray(vp))
    tkpq, tkps = t_quantize_kv(torch.from_numpy(kp))
    tvpq, tvps = t_quantize_kv(torch.from_numpy(vp))
    for quant in (False, True):
        jkw = dict(k_scale=jkps, v_scale=jvps) if quant else {}
        tkw = dict(k_scale=tkps, v_scale=tvps) if quant else {}
        jkk, jvv = (jkpq, jvpq) if quant else (jkp, jvp)
        tkk, tvv = (tkpq, tvpq) if quant else (tkp, tvp)
        tag = "_int8" if quant else ""
        cases["paged" + tag] = (
            lambda jkk=jkk, jvv=jvv, jkw=jkw: jops.paged_decode_attention(
                jq1, jkk, jvv, jbt, jp0, "auto", **jkw),
            lambda tkk=tkk, tvv=tvv, tkw=tkw: tops.paged_decode_attention(
                tq1, tkk, tvv, tbt, tp0, "auto", **tkw))
        cases["verify" + tag] = (
            lambda jkk=jkk, jvv=jvv, jkw=jkw: jops.flash_attention_verify(
                jqt, jkk, jvv, jbt, jp0, "auto", window=8, **jkw),
            lambda tkk=tkk, tvv=tvv, tkw=tkw: tops.flash_attention_verify(
                tqt, tkk, tvv, tbt, tp0, "auto", window=8, **tkw))
    xe = r.standard_normal((4, 8, 64)).astype(np.float32)
    w1, w3 = (r.standard_normal((4, 64, 64)).astype(np.float32) * 0.1
              for _ in range(2))
    w2 = r.standard_normal((4, 64, 64)).astype(np.float32) * 0.1
    comb = r.uniform(size=(4, 8)).astype(np.float32)
    (jxe, txe) = _pair(xe, "bfloat16")
    jw = [_pair(w, "bfloat16") for w in (w1, w3, w2)]
    (jc, tc) = _pair(comb, "float32")
    cases["moe_ffn"] = (
        lambda: jops.moe_ffn(jxe, *[w[0] for w in jw], jc, "auto"),
        lambda: tops.moe_ffn(txe, *[w[1] for w in jw], tc, "auto"))
    jqw = [j_quantize(jnp.asarray(w), "int8") for w in (w1, w3, w2)]
    tqw = [t_quantize(torch.from_numpy(w), "int8") for w in (w1, w3, w2)]
    cases["quant_moe_ffn"] = (
        lambda: jops.quant_moe_ffn(jxe, *jqw, jc, "auto"),
        lambda: tops.quant_moe_ffn(txe, *tqw, tc, "auto"))
    # ssd: B 1, H 4, G 2, S 128, P 8, N 4 (kernel layout); rglru (1, 64, 256)
    sargs = [_pair(a, "float32") for a in (
        r.standard_normal((1, 4, 128, 8)) * 0.5,
        r.uniform(0.01, 0.2, (1, 4, 128)), -r.uniform(0.5, 1.5, 4),
        r.standard_normal((1, 2, 128, 4)) * 0.3,
        r.standard_normal((1, 2, 128, 4)) * 0.3)]
    cases["ssd"] = (
        lambda: jops.ssd(*[a[0] for a in sargs], "auto", chunk=64),
        lambda: tops.ssd(*[a[1] for a in sargs], "auto", chunk=64))
    rargs = [_pair(r.standard_normal(shape).astype(np.float32), "float32")
             for shape in ((1, 64, 256),) * 3 + ((256,),)]
    cases["rglru"] = (
        lambda: jops.rglru(*[a[0] for a in rargs], "auto", block_d=64,
                           block_t=32),
        lambda: tops.rglru(*[a[1] for a in rargs], "auto", block_d=64,
                           block_t=32))
    return cases


OPS_CASES = sorted(_ops_cases())


@pytest.mark.parametrize("case", OPS_CASES)
def test_ops_file_the_reference_keys(case, recorders):
    jrec, trec = recorders
    jcall, tcall = _ops_cases()[case]
    _reference(jcall)
    tcall()
    assert trec.keys and trec.keys == jrec.keys


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "grad"])
def test_flash_ops_file_the_reference_keys(sparse, grad, recorders):
    """The forward family always, the dK/dV family only when a backward
    runs (the reference resolves it inside its VJP rule, which runs when
    its jitted function is traced: the reference's per-geometry caches are
    emptied first, so that this test traces it)."""
    jops._flash_vjp_fn.cache_clear()
    jops._flash_sparse_fn.cache_clear()
    jrec, trec = recorders
    r = _rng(1)
    q = r.standard_normal((1, 2, 128, 64)).astype(np.float32) * 0.5
    k, v = (r.standard_normal((1, 1, 128, 64)).astype(np.float32) * 0.5
            for _ in range(2))
    kw = dict(bq=32, bkv=32, causal=True,
              **({"window": 48} if sparse else {}))
    jop = jops.flash_attention_sparse if sparse else jops.flash_attention
    top = tops.flash_attention_sparse if sparse else tops.flash_attention
    jqkv = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    tqkv = [torch.from_numpy(x).bfloat16().requires_grad_(grad)
            for x in (q, k, v)]
    if grad:
        _reference(lambda: jax.grad(
            lambda a, b, c: jnp.sum(jop(a, b, c, "auto", **kw)),
            argnums=(0, 1, 2))(*jqkv))
        top(*tqkv, "auto", **kw).sum().backward()
    else:
        _reference(lambda: jop(*jqkv, "auto", **kw))
        with torch.no_grad():
            top(*tqkv, "auto", **kw)
    fams = [key.split("|")[0] for key in trec.keys]
    assert ("flash_attention_bwd" in fams) == grad
    if sparse and grad:
        # the reference's sparse kernel fails on this JAX (pl.load) before
        # its backward files the dense flash_attention_bwd key
        # (`repro/kernels/ops.py:338`); that key is the dense grad's
        assert jrec.keys == trec.keys[:1]
        jrec.keys.clear()
        del kw["window"]
        jax.grad(lambda a, b, c: jnp.sum(jops.flash_attention(
            a, b, c, "auto", **kw)), argnums=(0, 1, 2))(*jqkv)
        assert trec.keys[1:] == jrec.keys[1:]
    else:
        assert trec.keys == jrec.keys


def _layer_cases():
    r = _rng(2)
    cases = {}
    q = r.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc, vc = (r.standard_normal((2, 64, 2, 32)).astype(np.float32)
              for _ in range(2))
    pos = np.array([30, 63], np.int32)
    jq, tq = _pair(q, "bfloat16")
    jk, tk = _pair(kc, "bfloat16")
    jv, tv = _pair(vc, "bfloat16")
    jp, tp = _pair(pos, "int32")
    cases["decode"] = (
        lambda: JL.decode_attention(jq, jk, jv, jp, backend="pallas",
                                    bkv=32),
        lambda: TL.decode_attention(tq, tk, tv, tp, backend="cuda", bkv=32))
    kp, vp = (r.standard_normal((9, 8, 2, 32)).astype(np.float32)
              for _ in range(2))
    bt = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    (jkp, tkp), (jvp, tvp) = _pair(kp, "bfloat16"), _pair(vp, "bfloat16")
    jbt, tbt = _pair(bt, "int32")
    p0 = np.array([20, 25], np.int32)
    jp0, tp0 = _pair(p0, "int32")
    cases["paged"] = (
        lambda: JL.paged_decode_attention(jq, jkp, jvp, jbt, jp0,
                                          backend="pallas", window=8),
        lambda: TL.paged_decode_attention(tq, tkp, tvp, tbt, tp0,
                                          backend="cuda", window=8))
    qt = r.standard_normal((2, 3, 4, 32)).astype(np.float32)
    jqt, tqt = _pair(qt, "bfloat16")
    jks, jkss = j_quantize_kv(jnp.asarray(kp))
    jvs, jvss = j_quantize_kv(jnp.asarray(vp))
    tks, tkss = t_quantize_kv(torch.from_numpy(kp))
    tvs, tvss = t_quantize_kv(torch.from_numpy(vp))
    cases["verify_int8"] = (
        lambda: JL.verify_attention(jqt, jks, jvs, jbt, jp0,
                                    backend="pallas", k_scale=jkss,
                                    v_scale=jvss),
        lambda: TL.verify_attention(tqt, tks, tvs, tbt, tp0, backend="cuda",
                                    k_scale=tkss, v_scale=tvss))
    x = r.standard_normal((2, 64, 256)).astype(np.float32)
    ws = {n: r.standard_normal(s).astype(np.float32) * 0.05
          for n, s in (("w1", (256, 256)), ("w3", (256, 256)),
                       ("w2", (256, 256)))}
    jx, tx = _pair(x, "bfloat16")
    jws = {n: jnp.asarray(w).astype(jnp.bfloat16) for n, w in ws.items()}
    tws = {n: torch.from_numpy(w).bfloat16() for n, w in ws.items()}
    cases["ffn"] = (lambda: JL.ffn(jws, jx, backend="pallas"),
                    lambda: TL.ffn(tws, tx, backend="cuda"))
    jqws = {n: j_quantize(jnp.asarray(w), "int4", group=32)
            for n, w in ws.items()}
    tqws = {n: t_quantize(torch.from_numpy(w), "int4", group=32)
            for n, w in ws.items()}
    cases["ffn_int4"] = (lambda: JL.ffn(jqws, jx, backend="pallas"),
                         lambda: TL.ffn(tqws, tx, backend="cuda"))
    xe = r.standard_normal((4, 8, 64)).astype(np.float32)
    w = [r.standard_normal(s).astype(np.float32) * 0.1
         for s in ((4, 64, 64), (4, 64, 64), (4, 64, 64))]
    comb = r.uniform(size=(4, 8)).astype(np.float32)
    jcfg = dataclasses.replace(j_get_config("qwen2-moe-a2.7b").reduced(),
                               moe_backend="pallas")
    tcfg = dataclasses.replace(t_get_config("qwen2-moe-a2.7b").reduced(),
                               moe_backend="cuda")
    jxe, txe = _pair(xe, "bfloat16")
    cases["moe"] = (
        lambda: JL.moe_expert_ffn(jxe, *[jnp.asarray(a).astype(jnp.bfloat16)
                                         for a in w], jnp.asarray(comb),
                                  jcfg),
        lambda: TL.moe_expert_ffn(txe, *[torch.from_numpy(a).bfloat16()
                                         for a in w],
                                  torch.from_numpy(comb), tcfg))
    qf = r.standard_normal((1, 128, 2, 64)).astype(np.float32) * 0.5
    kf, vf = (r.standard_normal((1, 128, 1, 64)).astype(np.float32) * 0.5
              for _ in range(2))
    for window in (None, 48):
        (jqf, tqf), (jkf, tkf), (jvf, tvf) = (_pair(a, "bfloat16")
                                              for a in (qf, kf, vf))
        cases[f"flash_window{window}"] = (
            lambda jqf=jqf, jkf=jkf, jvf=jvf, w=window: JL.flash_attention(
                jqf, jkf, jvf, causal=True, window=w, pos_trivial=True,
                backend="pallas", bq=32, bkv=32),
            lambda tqf=tqf, tkf=tkf, tvf=tvf, w=window: TL.flash_attention(
                tqf, tkf, tvf, causal=True, window=w, pos_trivial=True,
                backend="cuda", bq=32, bkv=32))
    return cases


@pytest.mark.parametrize("case", sorted(_layer_cases()))
def test_layer_dispatch_files_the_reference_keys(case, recorders):
    """The dispatch resolves "auto" under the reference's key before it
    applies the port's own rules (`*_kernel_takes`, tiling)."""
    jrec, trec = recorders
    jcall, tcall = _layer_cases()[case]
    _reference(jcall)
    with torch.no_grad():
        tcall()
    assert trec.keys and trec.keys == jrec.keys


# -- search -------------------------------------------------------------------

def test_exhaustive_search_picks_the_reference_label():
    equal = 0
    seen = set()
    for spec in _port_specs():
        if spec.key in seen:
            continue
        seen.add(spec.key)
        ours = tsearch.enumerate_candidates(spec)
        theirs = jsearch.enumerate_candidates(_jspec(spec))
        if not ours or set(_labels(ours)) != set(_labels(theirs)):
            continue
        equal += 1
        t = tsearch.search(spec, measure=_stub, strategy="exhaustive")
        j = jsearch.search(_jspec(spec), measure=_stub,
                           strategy="exhaustive")
        assert t.best.label == j.best.label, spec.key
        assert [c.cfg.label for c in t.candidates] \
            == [c.cfg.label for c in j.candidates]
    assert equal >= 20


def test_the_bound_ranks_base_first_and_greedy_measures_in_order():
    spec = tcache.KernelSpec.make("decode_attention_paged",
                                  (8, 16, 8, 64, 128), dtype="bfloat16",
                                  page_size=16, window=0)
    cands = _labels(tsearch.enumerate_candidates(spec))
    res = tsearch.search(spec)
    assert res.best == BASE and _labels(c.cfg for c in res.candidates) \
        == cands
    assert len({c.modeled_s for c in res.candidates}) == 1
    # 2 * 8 * 1024 * 8 * 128 * 2 bytes of K/V over 3.35 TB/s
    assert res.candidates[0].modeled_s == pytest.approx(
        (2 * 8 * 1024 * 8 * 128 * 2 + 4 * 8 * 16 * 128) / 3.35e12)
    measured = []

    def measure(s, cfg):
        measured.append(cfg.label)
        return 1.0 / (1 + len(measured))
    res = tsearch.search(spec, measure=measure, strategy="greedy", top_k=3)
    assert measured == cands[:3] and res.best.label == cands[2]
    assert res.source == "measured"


@pytest.mark.parametrize("shape", [(1, 2, 1, 8, 4, 4), (2, 4, 2, 12, 8, 4),
                                   (1, 2, 2, 4, 4, 8)])
def test_the_ssd_bound_counts_what_the_function_needs(shape):
    # counted term by term: C.B^T and W.x only where u <= t, no state read
    # in the first chunk (it is zero) and no state update after the last
    b, h, g, s, p, n = shape
    chunk = 4
    nc = s // chunk
    ops = 0
    for ci in range(nc):
        for t in range(chunk):
            for u in range(t + 1):
                ops += b * g * 2 * n + b * h * 2 * p
            if ci > 0:
                ops += b * h * 2 * n * p
            if ci < nc - 1:
                ops += b * h * 2 * n * p
    io = 4 * (2 * b * h * s * p + b * h * s + h + 2 * b * g * s * n)
    spec = tcache.KernelSpec.make("ssd", shape, chunk=chunk)
    assert tsearch.work(spec) == (io, ops, tsearch.FP32_FLOPS)


# -- the cache ----------------------------------------------------------------

SPEC = tcache.KernelSpec.make("matmul", (1024, 512, 256), dtype="bfloat16",
                              bm=128, bn=128, bk=256)


def test_cache_round_trip_and_layout(tmp_path):
    path = tmp_path / "c.json"
    c = tcache.TuningCache(str(path))
    c.put(SPEC, CoarseningConfig.parse("con2"), modeled_s=1e-5,
          measured_s=2e-5, source="measured")
    blob = json.loads(path.read_text())
    assert blob["version"] == tcache.CACHE_VERSION == jcache.CACHE_VERSION
    assert blob["entries"][SPEC.key] == {"cfg": "con2", "modeled_s": 1e-5,
                                         "measured_s": 2e-5,
                                         "source": "measured"}
    assert SPEC.key == "matmul|1024x512x256|bfloat16|cuda|bk=256,bm=128," \
        "bn=128"
    assert _nobackend(SPEC.key) == _nobackend(_jspec(SPEC).key)
    again = tcache.TuningCache(str(path))
    assert again.get(SPEC).label == "con2"
    assert again.stats == {"hits": 1, "misses": 0}


def test_cache_of_another_version_loads_empty(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"version": tcache.CACHE_VERSION - 1,
                                "entries": {SPEC.key: {"cfg": "con2"}}}))
    c = tcache.TuningCache(str(path))
    assert len(c) == 0 and c.get(SPEC) is None
    path.write_text("{not json")
    assert len(tcache.TuningCache(str(path))) == 0


def test_default_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(tcache.ENV_VAR)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert tcache.default_cache_path() == str(
        tmp_path / "repro_torch" / f"tune_v{tcache.CACHE_VERSION}.json")
    assert tcache.ENV_VAR == "REPRO_TORCH_TUNE_CACHE" != jcache.ENV_VAR


def test_second_autotune_hits_without_searching(tmp_path):
    c = tcache.TuningCache(str(tmp_path / "c.json"))
    before = tsearch.SEARCH_COUNT
    first = tsearch.autotune(SPEC, cache=c, measure=_stub,
                             strategy="exhaustive")
    second = tsearch.autotune(SPEC, cache=c, measure=_stub,
                              strategy="exhaustive")
    assert first == second and tsearch.SEARCH_COUNT == before + 1
    assert c.stats == {"hits": 1, "misses": 1}
    assert c.entries[SPEC.key]["source"] == "measured"


def test_auto_resolves_from_a_persisted_cache(tmp_path, monkeypatch):
    path = tmp_path / "persisted.json"
    tcache.TuningCache(str(path)).put(SPEC, CoarseningConfig.parse("gap2"),
                                      modeled_s=1e-5)
    monkeypatch.setenv(tcache.ENV_VAR, str(path))
    tops._auto_cfg.cache_clear()
    before = tsearch.SEARCH_COUNT
    got = tops.resolve_cfg("auto", "matmul", (1024, 512, 256),
                           dtype="bfloat16", backend="cuda", bm=128, bn=128,
                           bk=256)
    assert got.label == "gap2" and tsearch.SEARCH_COUNT == before
    # a miss ranks by the bound (base first) and persists it
    miss = tops.resolve_cfg("auto", "matmul", (2048, 512, 256),
                            dtype="bfloat16", backend="cuda", bm=128,
                            bn=128, bk=256)
    assert miss == BASE and len(tcache.TuningCache(str(path))) == 2
    # the plain path resolves "auto" to base without the cache
    assert tops.resolve_cfg("auto", "matmul", (1024, 512, 256),
                            dtype="bfloat16", backend="ref", bm=128, bn=128,
                            bk=256) == BASE


def test_the_plain_path_writes_no_cache(tmp_path, monkeypatch):
    """A reduced qwen3-0.6b prefill and decode on CPU tensors with every
    coarsening field "auto" and the kernel backend: base everywhere, no
    search, no cache file."""
    from repro_torch.models import model as M
    path = tmp_path / "never.json"
    monkeypatch.setenv(tcache.ENV_VAR, str(path))
    cfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                              decode_backend="cuda", ffn_backend="cuda",
                              attn_backend="cuda")
    params = M.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = tsearch.SEARCH_COUNT
    toks = torch.from_numpy(_rng(3).integers(1, cfg.vocab, (2, 16)))
    with torch.no_grad():
        hidden = M.lm_apply(params, {"tokens": toks}, cfg)
        cache = M.lm_init_cache(cfg, 2, 32, device="cpu")
        logits = M.lm_prefill(params, toks, cfg, cache=cache)[0]
        for spec in SMALL_SPECS:
            twarm._case(spec, "auto", device="cpu")()
    assert torch.isfinite(hidden.float()).all()
    assert torch.isfinite(logits.float()).all()
    assert tsearch.SEARCH_COUNT == before and not path.exists()


def test_a_measurer_error_ends_the_warm(tmp_path, capsys):
    cfg = t_get_config("qwen3-0.6b")
    for err in (ValueError("kernel refused the label"),
                RuntimeError("launch failed")):
        def measure(spec, c, err=err):
            raise err
        with pytest.raises(type(err), match=str(err)):
            twarm.warm_for_model(cfg, seq=1024, batch=8, measure=measure,
                                 strategy="exhaustive",
                                 cache=tcache.TuningCache(
                                     str(tmp_path / "e.json")))
    assert "skipped" not in capsys.readouterr().out
    with pytest.raises(ValueError, match="CUDA card"):
        twarm.wall_measurer()
    with pytest.raises(ValueError, match="CUDA card"):
        twarm.warm_from_flag(cfg, "exhaustive", seq=1024, batch=8)


def test_warm_skips_only_a_geometry_no_label_fits(tmp_path, capsys):
    """Reduced qwen3-0.6b has head dim 32, which the flash kernels do not
    hold: those two families are skipped, the rest filed."""
    cfg = t_get_config("qwen3-0.6b").reduced()
    out = twarm.warm_for_model(cfg, seq=64, batch=2, page_size=8,
                               cache=tcache.TuningCache(
                                   str(tmp_path / "s.json")))
    text = capsys.readouterr().out
    assert "tune: flash_attention: skipped (no valid coarsening candidate" \
        in text and "flash_attention" not in out
    assert set(out) == {"ew_stream", "embed_gather", "matmul",
                        "decode_attention", "decode_attention_paged"}


SMALL_SPECS = [
    tcache.KernelSpec.make("ew_stream", (4096,), n_loads=2, ai=6,
                           variant="base", block=1024),
    tcache.KernelSpec.make("gather_stream", (2048, 512), n_loads=2, ai=6,
                           block=1024),
    tcache.KernelSpec.make("embed_gather", (512, 300, 64), block=256),
    tcache.KernelSpec.make("matmul", (128, 256, 256), dtype="bfloat16",
                           bm=128, bn=128, bk=256),
    tcache.KernelSpec.make("matmul", (128, 256, 256), dtype="bfloat16",
                           bm=128, bn=128, bk=256, wbits=4, group=32),
    tcache.KernelSpec.make("dp_scan", (16, 64)),
    tcache.KernelSpec.make("stencil5", (64, 64), block_rows=8),
    tcache.KernelSpec.make("decode_attention", (2, 4, 2, 64, 32),
                           dtype="int8", bkv=32, window=0, kv_bits=8),
    tcache.KernelSpec.make("decode_attention_paged", (2, 4, 2, 4, 32),
                           dtype="bfloat16", page_size=8, window=0),
    tcache.KernelSpec.make("flash_attention_verify", (2, 4, 2, 3, 4, 32),
                           dtype="int8", page_size=8, window=0, kv_bits=8),
    tcache.KernelSpec.make("flash_attention", (1, 2, 1, 64, 64, 32),
                           dtype="bfloat16", bq=32, bkv=32, causal=True),
    tcache.KernelSpec.make("flash_attention_bwd", (1, 2, 1, 64, 64, 32),
                           dtype="bfloat16", bq=32, bkv=32, causal=True),
    tcache.KernelSpec.make("flash_attention_sparse", (1, 2, 1, 128, 128, 64),
                           dtype="bfloat16", bq=32, bkv=32, causal=True,
                           window=48, gstride=0, max_live=8, n_live=10),
    tcache.KernelSpec.make("moe_ffn", (4, 8, 64, 64), dtype="bfloat16"),
    tcache.KernelSpec.make("moe_ffn", (4, 8, 64, 64), dtype="bfloat16",
                           wbits=8, group=0),
    tcache.KernelSpec.make("ssd", (1, 4, 1, 64, 8, 4), chunk=64),
    tcache.KernelSpec.make("rglru", (1, 64, 256), block_d=64, block_t=32),
]


@pytest.mark.parametrize("spec", SMALL_SPECS, ids=lambda s: s.key)
def test_measurer_builds_every_family(spec):
    """`wall_measurer`'s calls at small shapes on the CPU (plain versions):
    each builds its inputs and runs the port's op under a label."""
    cfg = tsearch.enumerate_candidates(spec)[-1] \
        if tsearch.enumerate_candidates(spec) else BASE
    out = twarm._case(spec, cfg, device="cpu")()
    leaves = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(t.float()).all() for t in leaves)
    rg = twarm._case(tcache.KernelSpec.make("rglru", (1, 64, 128)), BASE,
                     device="cpu")()
    assert rg.shape == (1, 64, 128) and torch.isfinite(rg).all()


# -- the launchers ------------------------------------------------------------

def _tune_lines(text: str) -> dict:
    """{family: shape text} of the ``tune: <family> <shape> -> <label>``
    lines, and the families skipped."""
    got, skipped = {}, set()
    for ln in text.splitlines():
        if not ln.startswith("tune: ") or ln.startswith("tune:  ") \
                or ln.startswith("tune: cache") \
                or ln.startswith("tune: calibration") \
                or ln.startswith("tune: model-vs"):
            continue
        if ": skipped (" in ln:
            skipped.add(ln.split()[1].rstrip(":"))
        else:
            fam, rest = ln[len("tune: "):].split(" ", 1)
            got[fam] = rest.split(" -> ")[0]
    return got, skipped


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_tune_model_prints_the_reference_lines(launcher, capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    if launcher == "train":
        seq, batch, ps = 64, 2, None
        ttrain.main(["--reduced", "--device", "cpu", "--steps", "1",
                     "--batch", "2", "--seq", "64", "--tune", "model"])
    else:
        seq, batch, ps = 32, 3, 8
        tserve.main(["--reduced", "--device", "cpu", "--slots", "3",
                     "--requests", "2", "--prompt-len", "8", "--gen-tokens",
                     "4", "--max-len", "32", "--page-size", "8", "--chunk",
                     "8", "--tune", "model"])
    printed = capsys.readouterr().out
    assert "tune: cache " in printed and "tune: calibration n/a" in printed
    ours, skipped = _tune_lines(printed)
    jwarm.warm_for_model(j_get_config("qwen3-0.6b").reduced(), seq=seq,
                         batch=batch, page_size=ps, strategy="model")
    text = capsys.readouterr().out
    theirs, _ = _tune_lines(text)
    assert ours == {f: s for f, s in theirs.items() if f not in skipped}
    assert skipped == {"flash_attention", "flash_attention_bwd"}


def test_launchers_print_the_report(capsys):
    from repro_torch.launch import train as ttrain
    ttrain.main(["--reduced", "--device", "cpu", "--steps", "1", "--batch",
                 "2", "--seq", "64", "--tune", "auto"])
    text = capsys.readouterr().out
    assert "tune: cache 0 hits / 6 misses" in text
    assert "tune: calibration n/a" in text


# -- row 14: embed gather -----------------------------------------------------

LABELS7 = ("base", "con2", "gap2", "con4", "gap4", "con8", "gap8")


def _embed_inputs(seed, n=2048, vocab=300, d=64, clamp=False):
    r = _rng(seed)
    ids = r.integers(0, vocab, n).astype(np.int32)
    if clamp:   # ids past the table, below -V, and in [-V, 0) (wrapped)
        ids[::7] = vocab + r.integers(0, 50, ids[::7].shape[0])
        ids[3::11] = -vocab - 1 - r.integers(0, 50, ids[3::11].shape[0])
        ids[5::13] = -1 - r.integers(0, vocab, ids[5::13].shape[0])
    table = r.standard_normal((vocab, d)).astype(np.float32)
    return ids, table


def test_embed_gather_plain_matches_the_reference_plain():
    ids, table = _embed_inputs(0)
    want = np.asarray(jeg.ref_embed_gather(jnp.asarray(ids),
                                           jnp.asarray(table)))
    got = tref.embed_gather(torch.from_numpy(ids), torch.from_numpy(table))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("clamp", [False, True], ids=["in_range", "clamped"])
@pytest.mark.parametrize("label", LABELS7)
def test_embed_gather_matches_the_pallas_kernel(label, clamp):
    ids, table = _embed_inputs(1 + clamp, clamp=clamp)
    want = np.asarray(jops.embed_gather(jnp.asarray(ids), jnp.asarray(table),
                                        JCfg.parse(label)))
    ti, tt = torch.from_numpy(ids), torch.from_numpy(table)
    for got in (tref.embed_gather(ti, tt),
                tops.embed_gather(ti, tt, label),
                teg.embed_gather(ti, tt, label)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_embed_gather_bf16_table_widens_exactly():
    ids, table = _embed_inputs(4)
    tb = torch.from_numpy(table).bfloat16()
    got = tref.embed_gather(torch.from_numpy(ids), tb)
    want = tb.float().numpy()[ids]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("label", LABELS7)
def test_embed_gather_probe_is_the_plan_owner_map(label):
    ids, table = _embed_inputs(5)
    plan = plan_stream(ids.shape[0], CoarseningConfig.parse(label), 256)
    got = teg.embed_gather(torch.from_numpy(ids), torch.from_numpy(table),
                           label, probe=True)
    want = stream_owners(plan).float()[:, None].expand(-1, table.shape[1])
    assert torch.equal(got, want)


def test_embed_gather_takes_refuses_without_a_launch():
    """Rows that are not a multiple of 4 values are refused on a device
    request before anything is built or launched; so are labels with a
    vector width and an untileable id stream."""
    before = teg.launches
    ids = torch.zeros(512, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="d % 4"):
        teg.embed_gather(ids, torch.empty((300, 66), device="meta"))
    assert teg.takes(64) and not teg.takes(66) and not teg.takes(2)
    with pytest.raises(ValueError, match="vector width"):
        teg.embed_gather(ids, torch.empty((300, 64)), "simd2")
    with pytest.raises(ValueError, match="not divisible"):
        teg.embed_gather(ids[:300], torch.empty((300, 64)), "con2")
    assert teg.launches == before
