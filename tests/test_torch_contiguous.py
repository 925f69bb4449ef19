"""Contiguous-cache serving: the port's contiguous split-KV decode (plain
version of the row 3 kernel), its layer dispatch, chunked masked prefill
and decode on the contiguous cache, and `BatchedServer`, each against the
reference (`repro`), with the reference's parameters carried across by
`params_from_numpy`.

The reference's contiguous decode kernel (`make_kernel`) runs in Pallas
interpret mode on the installed JAX (it needs no ``pl.load``); its
explicit labels are passed, never ``"auto"``.  Inputs are made with numpy
from fixed seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.launch.serve import BatchedServer as JServer
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.coarsening import CoarseningConfig
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.serve import BatchedServer as TServer
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.interop import params_from_numpy

B, H, HKV, D, S, BKV = 3, 4, 2, 32, 64, 16


def _operands(seed, quant):
    """q (B,1,H,D), caches (B,S,Hkv,D) and pos as numpy; int8 caches come
    with random f32 scales (B,S,Hkv)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    pos = np.array([5, 37, S - 1], np.int32)
    if quant:
        k = rng.integers(-127, 128, (B, S, HKV, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, S, HKV, D)).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (B, S, HKV)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (B, S, HKV)).astype(np.float32)
        return q, k, v, pos, ks, vs
    k = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    return q, k, v, pos, None, None


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("label", ["base", "con2", "gap2"])
def test_split_kv_matches_the_pallas_kernel(label, window, kind):
    """`ref.split_kv` (and the wrapper's CPU path through `ops`) against
    the reference's `make_kernel` in interpret mode: the same splits,
    live-split skip, masks and combine, f32 arithmetic on both sides.
    float32 and int8 operands: atol 1e-5 on outputs of unit scale; bf16
    operands and outputs: one bf16 rounding of outputs below 2, which the
    two sides may land an ulp apart (atol 2^-7)."""
    q, k, v, pos, ks, vs = _operands(0, kind == "int8")
    if kind == "bf16":
        q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jops.decode_attention(
        _j(q), _j(k), _j(v), _j(pos), label, bkv=BKV, window=window,
        backend="pallas", k_scale=_j(ks), v_scale=_j(vs)), np.float32)
    tq, tk, tv = (_t(np.asarray(x, np.float32)) for x in (q, k, v))
    if kind == "bf16":
        tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
    elif kind == "int8":
        tk, tv = _t(k), _t(v)
    cfg = CoarseningConfig.parse(label)
    got = tref.split_kv(tq, tk, tv, _t(pos), degree=cfg.degree,
                        gapped=cfg.kind == "gapped", bkv=BKV, window=window,
                        k_scale=_t(ks), v_scale=_t(vs))
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 if kind == "bf16" else 1e-5)
    via_ops = tops.decode_attention(tq, tk, tv, _t(pos), label, bkv=BKV,
                                    window=window, k_scale=_t(ks),
                                    v_scale=_t(vs))
    assert torch.equal(via_ops, got)


def test_split_kv_reads_every_row_of_a_slot_past_the_cache():
    """A finished slot rides along with pos >= S: every row counts (the
    dense oracle's answer) and the split arithmetic needs no row past S."""
    q, k, v, _, _, _ = _operands(1, False)
    pos = torch.tensor([S + 6, 3, S - 1], dtype=torch.int32)
    got = tref.split_kv(_t(q), _t(k), _t(v), pos, degree=2, bkv=BKV)
    want = tref.decode_attention(_t(q), _t(k), _t(v), pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_decode_wrapper_rejects_what_the_kernel_cannot_tile():
    q, k, v, pos, _, _ = _operands(2, False)
    with pytest.raises(ValueError, match="tileable"):
        tdec.decode_attention(_t(q), _t(k), _t(v), _t(pos), "con4", bkv=32)
    with pytest.raises(ValueError, match="k_scale"):
        tdec.decode_attention(_t(q), _t(k), _t(v), _t(pos), bkv=BKV,
                              k_scale=torch.ones(B, S, HKV))
    with pytest.raises(RuntimeError, match="no backward"):
        tops.decode_attention(_t(q).requires_grad_(), _t(k), _t(v), _t(pos),
                              bkv=BKV)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("t_backend,j_backend,label",
                         [("ref", "ref", "auto"), ("cuda", "pallas", "con2"),
                          ("cuda", "pallas", "gap4")])
def test_layer_decode_attention_matches_the_reference(t_backend, j_backend,
                                                      label, quant):
    """`layers.decode_attention`: the dense path against the reference's
    (bf16 q rounded to the cache dtype, bf16 probabilities: atol 1e-2 on
    bf16 outputs, 2 ulps at the outputs' scale), and the kernel dispatch
    (plain split-KV on the CPU) against the reference's Pallas dispatch
    with the same label.  int8 caches carry their scales."""
    q, k, v, pos, ks, vs = _operands(3, quant)
    qb = q.astype(jnp.bfloat16)
    kc = k if quant else k.astype(jnp.bfloat16)
    vc = v if quant else v.astype(jnp.bfloat16)
    want = np.asarray(JL.decode_attention(
        jnp.asarray(qb), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        window=20, backend=j_backend, cfg=label, bkv=BKV, k_scale=_j(ks),
        v_scale=_j(vs)), np.float32)
    tk = _t(k) if quant else _t(k).bfloat16()
    tv = _t(v) if quant else _t(v).bfloat16()
    got = TL.decode_attention(_t(q).bfloat16(), tk, tv, _t(pos), window=20,
                              backend=t_backend, cfg=label, bkv=BKV,
                              k_scale=_t(ks), v_scale=_t(vs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-2)


# -- the model on the contiguous cache ----------------------------------------

SLOTS, MAX_LEN, CHUNK, PROMPT, STEPS = 3, 32, 4, 12, 6
ADMITTED = [0, 1]        # slot 2 is not prefilled: mask False


@pytest.fixture(scope="module")
def jparams():
    cfg = get_config("qwen3-0.6b").reduced()
    return jax.tree.map(np.asarray, JM.lm_init(jax.random.PRNGKey(0), cfg))


def _model_run(jparams, t_backend, kv_quant="none"):
    """Chunked masked prefill then teacher-forced decode, float32 compute,
    on both sides -> [(reference logits, port logits, reference cache
    leaf, port cache leaf) per chunk and step], admitted slots only for
    the logits."""
    jcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               compute_dtype="float32", kv_quant=kv_quant)
    tcfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                               compute_dtype="float32", kv_quant=kv_quant,
                               decode_backend=t_backend,
                               ffn_backend=t_backend, decode_attn_cfg="con2",
                               decode_bkv=8)
    tparams = params_from_numpy(jparams, tcfg, "cpu", torch.float32)
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, jcfg.vocab, (SLOTS, PROMPT)).astype(np.int32)
    mask = np.isin(np.arange(SLOTS), ADMITTED)
    jcache = JM.lm_init_cache(jcfg, SLOTS, MAX_LEN, dtype=jnp.float32)
    tcache = TM.lm_init_cache(tcfg, SLOTS, MAX_LEN, dtype=torch.float32,
                              device="cpu")
    jpre = jax.jit(lambda c, t, p0, m: JM.lm_prefill(
        jparams, {"tokens": t}, jcfg, cache=c, pos0=p0, mask=m))
    jdec = jax.jit(lambda c, t, pos: JM.lm_decode_step(jparams, c, t, pos,
                                                       jcfg))
    out = []

    def leaf(jc, tc):
        return (np.asarray(jc["blocks"][0]["k"][1]),
                tc["layers"][1]["k"].float().clone().numpy())

    for i in range(0, PROMPT, CHUNK):
        t = prompt[:, i:i + CHUNK]
        # slot 2 stands near the end of its cache: unmasked, its chunk rows
        # would run past S
        p0 = np.array([i, i, MAX_LEN - 2], np.int32)
        jl, jcache = jpre(jcache, t, p0, mask)
        tl, _ = TM.lm_prefill(tparams, torch.from_numpy(t), tcfg,
                              cache=tcache, pos0=torch.from_numpy(p0),
                              mask=torch.from_numpy(mask))
        out.append((np.asarray(jl)[ADMITTED], tl.numpy()[ADMITTED],
                    *leaf(jcache, tcache)))
    tok = out[-1][0].argmax(-1)
    tok = np.concatenate([tok, [7]]).astype(np.int32)[:, None]
    for s in range(STEPS):
        # slot 2 is a finished slot at max_len - 1 riding along: its rows
        # past S are dropped by the reference, and must be here
        pos = np.array([PROMPT + s, PROMPT + s, MAX_LEN - 1 + s], np.int32)
        jl, jcache = jdec(jcache, tok, pos)
        tl, _ = TM.lm_decode_step(tparams, tcache, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcfg)
        jl = np.asarray(jl)
        out.append((jl[ADMITTED], tl.numpy()[ADMITTED], *leaf(jcache,
                                                              tcache)))
        tok = jl.argmax(-1).astype(np.int32)[:, None]   # teacher forcing
    return out


@pytest.mark.parametrize("t_backend", ["ref", "cuda"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_contiguous_prefill_and_decode_match_the_reference(jparams,
                                                           t_backend,
                                                           kv_quant):
    """float32 compute and cache: the same arithmetic up to summation order
    through 4 layers, atol 1e-5 on logits of unit scale (as the paged
    model test).  The caches (every slot, layer 1's K, int8 payloads
    compared as values) agree to the same limit after every call: the
    unmasked slot's rows are left as they were in prefill, and the
    finished slot's writes past S are dropped in decode."""
    for want, got, jk, tk in _model_run(jparams, t_backend, kv_quant):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tk, np.asarray(jk, np.float32), rtol=0,
                                   atol=1e-5 if kv_quant == "none" else 1)


def test_inactive_slot_at_the_last_row_survives_a_decode_block_of_8():
    """Fault of a naive port: a finished slot keeps pos = max_len - 1 and
    still rides in every decode block, so its writes reach rows S..S+6.
    The reference drops them; an in-place index write would raise here
    (and fault on the card).  Eight steps must run, write the running
    slot's rows, and leave the finished slot's cache exactly as it was
    apart from row S-1, which is in bounds."""
    cfg = t_get_config("qwen3-0.6b").reduced()
    params = TM.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = TM.lm_init_cache(cfg, 2, MAX_LEN, device="cpu")
    for layer in cache["layers"]:
        layer["k"][1].normal_()
    before = cache["layers"][0]["k"][1].clone()
    tok = torch.tensor([[3], [4]], dtype=torch.int32)
    pos = torch.tensor([5, MAX_LEN - 1], dtype=torch.int32)
    for _ in range(8):
        logits, _ = TM.lm_decode_step(params, cache, tok, pos, cfg)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    after = cache["layers"][0]["k"]
    assert torch.equal(after[1, :MAX_LEN - 1], before[:MAX_LEN - 1])
    assert not torch.equal(after[1, MAX_LEN - 1], before[MAX_LEN - 1])
    assert after[0, 5:13].abs().sum(dim=(1, 2)).gt(0).all()


# -- BatchedServer ------------------------------------------------------------

SERVER = dict(slots=3, max_len=32, chunk=8, decode_block=4)
GEN = 10
# logit tolerance of the bf16 model comparison plus the difference between
# recomputing a step by prefill and decoding it (tests/test_torch_serve.py)
MARGIN_TOL = 0.05


def _margin(jcfg, jparams, tokens) -> float:
    """Reference top-1 minus top-2 logit after ``tokens``."""
    t = jnp.asarray([tokens], jnp.int32)
    logits, _ = JM.lm_prefill(jparams, {"tokens": t}, jcfg, s_max=32)
    top = np.sort(np.asarray(logits[0], np.float32))[-2:]
    return float(top[1] - top[0])


def _drive(server, prompts):
    """Serve ``prompts`` -> outputs in prompt order (either server archives
    finished outputs in completion order)."""
    owner, order = {}, []
    finish = server._maybe_finish

    def maybe_finish(s):
        n = len(server.completed)
        finish(s)
        if len(server.completed) > n:
            order.append(owner[s])
    server._maybe_finish = maybe_finish
    pending = list(range(len(prompts)))
    while pending or server.any_active:
        while pending:
            free = np.flatnonzero(~server.active)
            if free.size:
                owner[int(free[0])] = pending[0]
            if not server.try_admit(prompts[pending[0]], GEN):
                break
            pending.pop(0)
        server.step()
    return [o for _, o in sorted(zip(order, server.completed))]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_batched_server_matches_the_reference(kv_quant):
    """Greedy tokens of the port's `BatchedServer` (plain paths) against
    the reference's on one trace of 5 requests through 3 slots: equal up
    to each request's first differing token, whose reference margin must
    be below ``MARGIN_TOL`` (a near-tie either side may break; after it
    the contexts differ)."""
    jcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               kv_quant=kv_quant)
    jparams = JM.lm_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, jcfg.vocab, n)))
               for n in (6, 9, 5, 12, 7)]
    jdone = _drive(JServer(jcfg, jparams, decode_backend="ref", **SERVER),
                   prompts)
    tcfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                               kv_quant=kv_quant)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    server = TServer(tcfg, tparams, decode_backend="ref", ffn_backend="ref",
                     device="cpu", **SERVER)
    tdone = _drive(server, prompts)
    assert len(tdone) == len(jdone) == len(prompts)
    assert server.nan_steps == 0 and not server.any_active
    compared = 0
    for jo, to, p in zip(jdone, tdone, prompts):
        assert len(jo) == len(to) == GEN
        for i, (a, b) in enumerate(zip(jo, to)):
            if a != b:
                margin = _margin(jcfg, jparams, p + jo[:i])
                assert margin < MARGIN_TOL, (i, b, a, margin)
                break
            compared += 1
    assert compared >= len(prompts) * GEN // 2, compared


def test_batched_server_rejects_oversized_prompts_and_reports_memory():
    cfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                              kv_quant="int8")
    params = TM.lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    server = TServer(cfg, params, device="cpu", **SERVER)
    with pytest.raises(ValueError, match="max_len"):
        server.try_admit([1] * 32, 4)
    assert server.cache["layers"][0]["k"].dtype == torch.int8
    assert server.cache_mib < server.cache_mib_dense
    assert server.try_admit([1, 2, 3], 1)          # one token: done at once
    assert not server.any_active and server.completed == [
        server.outputs[0]]


def test_launch_serve_contiguous_front_end_on_cpu(capsys):
    """``--cache contiguous`` end to end on the CPU plain versions."""
    from repro_torch.launch import serve
    done = serve.main(["--reduced", "--device", "cpu", "--cache",
                       "contiguous", "--slots", "3", "--requests", "5",
                       "--prompt-len", "8", "--gen-tokens", "10",
                       "--max-len", "32", "--chunk", "8", "--decode-block",
                       "4", "--kv-quant", "int8"])
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "contiguous" in out
    assert "NaN steps 0" in out and "on cpu" in out
    assert len(done) == 5 and all(len(o) == 10 for o in done)
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--cache", "contiguous",
                    "--spec-k", "4"])
