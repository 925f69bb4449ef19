"""The port's MoE against the reference's: the grouped-expert kernels'
plain versions against the Pallas kernels in interpret mode, `layers.moe`
against `repro.models.layers.moe`, `params_from_numpy` on the MoE leaves,
and greedy serving of reduced qwen2-moe-a2.7b and olmoe-1b-7b through the
port's `PagedEngine` against the reference's, under preemption, with and
without int8 weights and int8 KV pools.

Inputs are made with numpy from fixed seeds (or carried across from the
reference's seeded init) and handed to both sides.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.coarsening import CoarseningConfig as JCfg
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import model as JM
from repro.quant import qtypes as JQ
from repro.serve import PagedEngine as JEngine
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.interop import layer_leaves, params_from_numpy
from repro_torch.quant import qtypes as TQ
from repro_torch.serve import PagedEngine as TEngine
from repro_torch.serve import Scheduler as TScheduler
from repro_torch.serve import State

E, C, D, F = 8, 16, 64, 128
LABELS = ("base", "con2", "gap2")
ARCHS = ("qwen2-moe-a2.7b", "olmoe-1b-7b")


def _experts(seed=0):
    """Dispatch buffer with a live prefix per expert (dead rows zeroed, as
    `layers.moe` leaves them), one dead expert, and the weights."""
    rng = np.random.default_rng(seed)
    n_live = rng.integers(0, C + 1, E)
    n_live[3] = 0
    live = np.arange(C)[None, :] < n_live[:, None]
    xe = rng.normal(size=(E, C, D)).astype(np.float32) * live[..., None]
    comb = (rng.uniform(size=(E, C)) * live).astype(np.float32)
    w1 = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    w3 = (rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)
    w2 = (rng.normal(size=(E, F, D)) / np.sqrt(F)).astype(np.float32)
    return xe, w1, w3, w2, comb


def _h(xe, w1, w3):
    return torch.nn.functional.silu(xe.float() @ w1.float()) \
        * (xe.float() @ w3.float())


@pytest.mark.parametrize("label", LABELS)
def test_moe_ffn_matches_pallas_kernel(label):
    """bf16 operands, f32 accumulation and h rounded once to bf16 on both
    sides.  The sums run in another order, so a rounding of h can land one
    bf16 ulp apart: |diff| <= 2^-7 * comb * (|h| @ |w2|) per element."""
    xe, w1, w3, w2, comb = _experts()
    j = [jnp.asarray(a, jnp.bfloat16) for a in (xe, w1, w3, w2)]
    want = np.asarray(jops.moe_ffn(*j, jnp.asarray(comb), JCfg.parse(label)))
    t = [torch.from_numpy(a).bfloat16() for a in (xe, w1, w3, w2)]
    tc = torch.from_numpy(comb)
    got = tops.moe_ffn(*t, tc, label)
    assert got.dtype == torch.float32
    h = _h(t[0], t[1], t[2]).bfloat16().float()
    tol = 2.0 ** -7 * (h.abs() @ t[3].float().abs()) * tc[..., None]
    assert (np.abs(got.numpy() - want) <= tol.numpy()).all()
    assert (got[3] == 0).all() and (got[comb == 0] == 0).all()


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_moe_ffn_matches_pallas_qkernel(mode, label):
    """The dequant-fused kernel's plain version against the Pallas qkernel
    (`moe_ffn.py:110`): both dequantize to f32 and keep h in f32, so they
    differ in summation order only: |diff| <= 2^-16 * comb * (|h| @ |w2|)
    (f32 sums over d = 64 and F = 128 terms, with margin)."""
    xe, w1, w3, w2, comb = _experts(1)
    jx = jnp.asarray(xe, jnp.bfloat16)
    jq = [JQ.quantize(jnp.asarray(w), mode, group=32) for w in (w1, w3, w2)]
    want = np.asarray(jops.quant_moe_ffn(jx, *jq, jnp.asarray(comb),
                                         JCfg.parse(label)))
    tx = torch.from_numpy(xe).bfloat16()
    tq = [TQ.quantize(torch.from_numpy(w), mode, group=32)
          for w in (w1, w3, w2)]
    tc = torch.from_numpy(comb)
    got = tops.quant_moe_ffn(tx, *tq, tc, label)
    dq = [TQ.dequantize(w) for w in tq]
    h = _h(tx, dq[0], dq[1])
    tol = 2.0 ** -16 * (h.abs() @ dq[2].abs()) * tc[..., None]
    assert (np.abs(got.numpy() - want) <= tol.numpy()).all()


def test_moe_ffn_rejects_what_the_kernel_does_not_take():
    xe, w1, w3, w2, comb = (torch.from_numpy(a).bfloat16()
                            for a in _experts())
    comb = comb.float()
    with pytest.raises(ValueError, match="not tileable"):
        tops.moe_ffn(xe, w1, w3, w2, comb, "con3")
    with pytest.raises(ValueError, match="shapes"):
        tops.moe_ffn(xe, w1, w3, w2[:, :, :8], comb)
    q = [TQ.quantize(w.float(), "int4", group=32) for w in (w1, w3, w2)]
    q8 = TQ.quantize(w2.float(), "int8")
    with pytest.raises(ValueError, match="format"):
        tops.quant_moe_ffn(xe, q[0], q[1], q8, comb)


# -- the layer ------------------------------------------------------------------

def _layer(arch, quant=None, seed=3):
    """Reference MoE parameters (f32, optionally quantized on both sides
    from the same f32 values), a bf16 input, and both configs."""
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = JL.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = {k: (torch.from_numpy(np.array(v, np.float32))
              if not isinstance(v, dict) else
              {kk: torch.from_numpy(np.array(vv, np.float32))
               for kk, vv in v.items()}) for k, v in jp.items()}
    if quant:
        jp, _ = JQ.quantize_params(jp, quant)
        tp, _ = TQ.quantize_params(tp, quant)
    x = np.random.default_rng(seed).normal(size=(2, 16, jcfg.d_model))
    return (jcfg, jp, jnp.asarray(x, jnp.bfloat16), tcfg, tp,
            torch.from_numpy(x.astype(np.float32)).bfloat16())


def _close(got, want, ulps=4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=ulps * 2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("capacity", [None, 4, 32],
                         ids=["default", "drop", "nodrop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, capacity):
    """Plain paths on both sides (the reference's einsum fallback, which
    rounds at every einsum, mirrored by the port's): routing, capacity
    drops, pad experts, shared experts and the f32 combine-scatter.  bf16
    outputs within 4 bf16 ulps of the largest: the chain rounds to bf16 at
    six points (three einsums, silu, the gated shared FFN, the sum), and
    XLA and PyTorch may take an element-wise bf16 op in different
    precisions, so a rounding can land an ulp apart at each; aux to
    1e-6."""
    jcfg, jp, jx, tcfg, tp, tx = _layer(arch)
    want, jaux = JL.moe(jp, jx, jcfg, capacity=capacity)
    got, taux = TL.moe(tp, tx, tcfg, capacity=capacity)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    _close(got, want)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_kernel_backend_matches_reference(arch):
    """The kernel backend (on the CPU, the kernel's plain version) against
    the reference's Pallas kernel in interpret mode, label con2: both round
    h once; 4 bf16 ulps of the largest output, as above."""
    jcfg, jp, jx, tcfg, tp, tx = _layer(arch, seed=4)
    want, _ = JL.moe(jp, jx, dataclasses.replace(
        jcfg, moe_backend="pallas", moe_ffn_cfg="con2"), capacity=32)
    got, _ = TL.moe(tp, tx, dataclasses.replace(
        tcfg, moe_backend="cuda", moe_ffn_cfg="con2"), capacity=32)
    _close(got, want)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_moe_layer_matches_reference(mode):
    """Quantized experts and shared experts on the plain paths (both sides
    dequantize densely, then round as the einsum fallback does)."""
    jcfg, jp, jx, tcfg, tp, tx = _layer("qwen2-moe-a2.7b", quant=mode)
    assert isinstance(tp["w1"], TQ.QTensor)
    want, _ = JL.moe(jp, jx, jcfg)
    got, _ = TL.moe(tp, tx, tcfg)
    _close(got, want)


def test_moe_kernel_backend_falls_back_on_bad_degree():
    """An explicit degree the padded expert count cannot tile takes the
    einsum path, as the reference's dispatch does."""
    _, _, _, tcfg, tp, tx = _layer("olmoe-1b-7b")
    want, _ = TL.moe(tp, tx, tcfg, capacity=32)
    got, _ = TL.moe(tp, tx, dataclasses.replace(
        tcfg, moe_backend="cuda", moe_ffn_cfg="con3"), capacity=32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- parameters -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_takes_the_moe_leaves(arch):
    jcfg = j_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, JM.lm_init(jax.random.PRNGKey(0), jcfg))
    tp = params_from_numpy(jp, tcfg, "cpu", torch.float32)
    n_j = sum(a.size for a in jax.tree.leaves(jp))
    n_t = sum(t.numel() for layer in tp["layers"] for t in _tensors(layer)) \
        + sum(t.numel() for k, v in tp.items() if k != "layers"
              for t in _tensors(v))
    assert n_t == n_j
    moe = tp["layers"][1]["moe"]
    assert tuple(moe["w1"].shape) == (tcfg.n_experts_padded, tcfg.d_model,
                                      tcfg.moe_d_ff)
    assert tuple(moe["w2"].shape) == (tcfg.n_experts_padded, tcfg.moe_d_ff,
                                      tcfg.d_model)
    np.testing.assert_array_equal(moe["w3"].numpy(),
                                  jp["blocks"][0]["moe"]["w3"][1])
    assert ("moe.shared_gate" in layer_leaves(tcfg)) \
        == bool(tcfg.n_shared_experts)
    blk = dict(jp["blocks"][0])
    blk["moe"] = {k: v for k, v in blk["moe"].items() if k != "router"}
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy({**jp, "blocks": [blk]}, tcfg, "cpu")
    blk["moe"] = {**jp["blocks"][0]["moe"], "stray": blk["moe"]["w1"]}
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_numpy({**jp, "blocks": [blk]}, tcfg, "cpu")


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


# -- the paged model ------------------------------------------------------------

SLOTS, PS, MAX_LEN, CHUNK, PROMPT, STEPS = 3, 4, 32, 4, 12, 6
# int8 KV codes: K and V rows, and their absmax scales, differ between the
# two sides by summation order (measured <= 1.3e-6 relative; allowed 2^-16).
# A code x/scale (|x/scale| <= 127) can then round the other way only where
# it lies within 127 * 2 * 2^-16 ~ 2^-8 of a half-integer: a near-tie.
KV_SCALE_RTOL = 2.0 ** -16
KV_NEAR_TIE = 2.0 ** -8


class CarriedKV:
    """Stand-in for `blocks._write_rows` on int8 pools: the port quantizes
    each appended row itself, its codes are held equal to the reference's
    for the same rows except at near-ties (and there within one code), its
    scales within KV_SCALE_RTOL, and then the reference's codes and scales
    are written, so that one near-tie rounded the other way (a code one
    step apart, ~1% of the row's absmax) cannot carry into later layers and
    steps and hide or fake a difference of the port's arithmetic."""

    def __init__(self, write):
        self.write, self.ref, self.layer, self.flips = write, None, None, 0

    def step(self, ref_cache) -> None:
        """The reference's pools after the step about to run on the port."""
        self.ref = [{k: torch.from_numpy(np.array(v[li]))
                     for k, v in ref_cache["blocks"][0].items()}
                    for li in range(ref_cache["blocks"][0]["k"].shape[0])]
        self.layer = itertools.count()

    def __call__(self, cache, page, row, k, v):
        if "k_scale" not in cache:
            return self.write(cache, page, row, k, v)
        ref = self.ref[next(self.layer)]
        for name, x in (("k", k), ("v", v)):
            q, scale = TQ.quantize_kv(x.float())
            rq, rscale = ref[name][page, row], ref[name + "_scale"][page, row]
            np.testing.assert_allclose(scale, rscale, rtol=KV_SCALE_RTOL,
                                       atol=0)
            y = x.float() / scale[..., None]
            off = q != rq
            tie = (y - torch.floor(y) - 0.5).abs() <= KV_NEAR_TIE
            assert bool((tie | ~off).all()), "a KV code differs off a tie"
            assert int((q.int() - rq.int()).abs().max()) <= 1
            self.flips += int(off.sum())
            cache[name + "_scale"][page, row] = rscale
            cache[name][page, row] = rq


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_float32(arch, quant, monkeypatch):
    """`lm_prefill` chunks and teacher-forced `lm_decode_step`s of the port
    (kernel backends, on the CPU their plain versions; float32 compute and
    pools) against the reference's (its Pallas MoE kernels in interpret
    mode, label base; its plain decode attention).  ``quant``: the weights
    quantized from the same float32 values on both sides, and int8 KV
    pools, whose codes the port computes and `CarriedKV` holds against the
    reference's before carrying the reference's across.  The same
    arithmetic up to summation order through 4 layers: atol 1e-4 on logits
    of scale ~3 (the measured gap is ~3e-6)."""
    carried = CarriedKV(TB._write_rows)
    monkeypatch.setattr(TB, "_write_rows", carried)
    kv = "int8" if quant else "none"
    jcfg = dataclasses.replace(
        j_get_config(arch).reduced(), compute_dtype="float32",
        kv_quant=kv, moe_backend="pallas", moe_ffn_cfg="base")
    tcfg = dataclasses.replace(
        get_config(arch).reduced(), compute_dtype="float32", kv_quant=kv,
        decode_backend="cuda", ffn_backend="cuda", moe_backend="cuda",
        decode_attn_cfg="con2")
    jparams = JM.lm_init(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu", torch.float32)
    if quant:
        jparams, _ = JQ.quantize_params(jparams, quant)
        tparams, _ = TQ.quantize_params(tparams, quant)
    npp = MAX_LEN // PS
    n_pages = SLOTS * npp + 2
    rng = np.random.default_rng(7)
    table = rng.permutation(np.arange(1, n_pages))[: SLOTS * npp]
    table = table.reshape(SLOTS, npp).astype(np.int32)
    table[2] = 0                            # slot 2 is not admitted
    prompt = rng.integers(1, jcfg.vocab, (SLOTS, PROMPT)).astype(np.int32)
    jc = JM.lm_init_cache_paged(jcfg, SLOTS, n_pages, PS, dtype=jnp.float32)
    tc = TM.lm_init_cache_paged(tcfg, n_pages, PS, dtype=torch.float32,
                                device="cpu")
    assert tc["layers"][0]["k"].dtype == (torch.int8 if quant
                                          else torch.float32)
    jpre = jax.jit(lambda c, t, p0, b: JM.lm_prefill(
        jparams, {"tokens": t}, jcfg, cache=c, pos0=p0, block_table=b))
    jdec = jax.jit(lambda c, t, pos, b: JM.lm_decode_step(
        jparams, c, t, pos, jcfg, block_table=b))
    bt = torch.from_numpy(table)
    pairs = []
    for i in range(0, PROMPT, CHUNK):
        t = prompt[:, i:i + CHUNK]
        p0 = np.full((SLOTS,), i, np.int32)
        jl, jc = jpre(jc, t, p0, table)
        carried.step(jc)
        tl, _ = TM.lm_prefill(tparams, torch.from_numpy(t), tcfg, cache=tc,
                              pos0=torch.from_numpy(p0), block_table=bt)
        pairs.append((np.asarray(jl), tl.numpy()))
    tok = pairs[-1][0].argmax(-1).astype(np.int32)[:, None]
    for s in range(STEPS):
        pos = np.full((SLOTS,), PROMPT + s, np.int32)
        jl, jc = jdec(jc, tok, pos, table)
        carried.step(jc)
        tl, _ = TM.lm_decode_step(tparams, tc, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcfg,
                                  block_table=bt)
        pairs.append((np.asarray(jl), tl.numpy()))
        tok = pairs[-1][0].argmax(-1).astype(np.int32)[:, None]
    for want, got in pairs:
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-4)


# -- greedy serving ---------------------------------------------------------------

ENGINE = dict(slots=3, num_pages=8, page_size=8, max_len=32, chunk=8,
              decode_block=4)
GEN = 12
# A differing greedy token is accepted only where the reference's own
# top-1/top-2 margin is below this.  The logits are bf16 (steps of 1/64 at
# |logit| 2-4), and the two sides round the expert chain, the router and
# decode attention at different points; their logits differ by up to
# ~0.06 (4 steps), so two top logits can swap within twice that plus a
# step.  `test_paged_prefill_and_decode_float32` holds the same paths to
# 1e-4 in float32.
MARGIN_TOL = 0.25


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, vocab, n))) for n in (6, 7, 5, 8)]


def _margin(jcfg, jparams, tokens) -> float:
    """Reference top-1 minus top-2 logit after ``tokens``, from the
    reference's prefill (MoE capacity B*T: no token is dropped)."""
    t = jnp.asarray([tokens], jnp.int32)
    logits, _ = JM.lm_prefill(jparams, {"tokens": t}, jcfg,
                              s_max=len(tokens))
    top = np.sort(np.asarray(logits[0], np.float32))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_under_preemption(arch, quant):
    """The port's engine on its kernel path (CPU plain versions) against
    the reference's engine with its expert kernels (the Pallas MoE kernels
    in interpret mode, label base: the port's kernels compute what they
    compute) and its plain decode attention (its Pallas paged kernel cannot
    run on the installed JAX), recompute preemption on both; with
    ``int8``: int8 weights and int8 KV pools on both sides, quantized from
    the same float32 weights."""
    jcfg = dataclasses.replace(j_get_config(arch).reduced(),
                               moe_ffn_cfg="base")
    tcfg = get_config(arch).reduced()
    jparams = JM.lm_init(jax.random.PRNGKey(0), jcfg)
    prompts = _prompts(jcfg.vocab)
    q = dict(quant=quant, kv_quant=quant) if quant else {}
    jeng = JEngine(jcfg, jparams, decode_backend="ref",
                   moe_backend="pallas", **q, **ENGINE)
    jsched = JScheduler(jeng, host_swap_bytes=0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                get_config(arch).reduced(), "cpu",
                                torch.float32)
    teng = TEngine(tcfg, tparams,
                   decode_backend="cuda", ffn_backend="cuda",
                   moe_backend="cuda", device="cpu", **q, **ENGINE)
    tsched = TScheduler(teng)
    for p in prompts:
        jsched.submit(p, GEN)
        tsched.submit(p, GEN)
    jdone, tdone = jsched.run_until_done(), tsched.run_until_done()
    assert sum(r.preemptions for r in tdone) > 0, "no preemption"
    assert teng.pool.num_live == 0 and not teng.active.any()
    if quant:
        assert teng.cache["layers"][0]["k"].dtype == torch.int8
        assert teng.weight_mib < teng.weight_mib_dense
        assert teng.quant_report["quantized"] \
            == jcfg.n_layers * jeng.quant_report["quantized"]
    compared = 0
    for jr, tr, p in zip(jdone, tdone, prompts):
        assert jr.rid == tr.rid and tr.state is State.FINISHED
        assert len(tr.output) == len(jr.output) == GEN
        for i, (a, b) in enumerate(zip(jr.output, tr.output)):
            if a != b:
                margin = _margin(jeng.cfg, jeng.params, p + jr.output[:i])
                assert margin < MARGIN_TOL, (
                    f"request {jr.rid} token {i}: {b} != {a} with a "
                    f"reference margin of {margin:.4f}")
                break
            compared += 1
    assert compared >= len(prompts) * GEN // 2, compared
