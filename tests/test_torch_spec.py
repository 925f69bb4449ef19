"""Speculative decoding in the port: the verify kernel's plain version
against the reference's plain verify and against T successive decode rows,
`lm_verify_step` against the reference's, and `SpecPagedEngine` against the
port's own `PagedEngine` (mirroring `tests/test_spec.py` where the port has
the feature: no suspend/resume and no fault injection yet).

The reference's Pallas verify kernel calls ``pl.load``, which the installed
JAX lacks, so the reference's plain (``"ref"``) paths are the oracle.
Inputs are made with numpy from fixed seeds.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.models import model as JM
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.coarsening import CoarseningConfig
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.interop import params_from_numpy
from repro_torch.serve import (BlockTables, PagedEngine, PagePool, Request,
                               Scheduler, SpecPagedEngine, State, draft_of,
                               pages_needed)

B, T, H, HKV, D, PS, NPP = 3, 5, 4, 2, 32, 4, 8
N_PAGES = B * NPP + 3


def _operands(seed, quant):
    """q (B,T,H,D), pools (P,ps,Hkv,D), a permuted table and pos0 as numpy
    (int8 pools with random f32 scales)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, N_PAGES))[:B * NPP]
    table = table.reshape(B, NPP).astype(np.int32)
    pos0 = np.array([0, 13, NPP * PS - T], np.int32)
    shape = (N_PAGES, PS, HKV, D)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
        return q, k, v, table, pos0, ks, vs
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return q, k, v, table, pos0, None, None


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("label", ["base", "con2", "gap2", "gap4"])
def test_verify_split_kv_matches_the_reference_plain_verify(label, window,
                                                            quant):
    """`ref.verify_split_kv` (and the wrapper's CPU path through `ops`)
    against `repro.kernels.ops.flash_attention_verify(backend="ref")`: the
    gather-to-contiguous dense oracle, row t at pos0 + t.  float32
    arithmetic on both sides: atol 1e-5 on outputs of unit scale."""
    q, k, v, table, pos0, ks, vs = _operands(0, quant)
    want = np.asarray(jops.flash_attention_verify(
        _j(q), _j(k), _j(v), _j(table), _j(pos0), label, window=window,
        backend="ref", k_scale=_j(ks), v_scale=_j(vs)))
    cfg = CoarseningConfig.parse(label)
    got = tref.verify_split_kv(_t(q), _t(k), _t(v), _t(table), _t(pos0),
                               degree=cfg.degree, gapped=cfg.kind == "gapped",
                               window=window, k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    via_ops = tops.flash_attention_verify(_t(q), _t(k), _t(v), _t(table),
                                          _t(pos0), label, window=window,
                                          k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_verify_rows_equal_successive_decode_rows(backend):
    """Row t of `layers.verify_attention` is `layers.paged_decode_attention`
    at pos0 + t on the same pools (bf16 q and pools): bit for bit on the
    plain path (the same contraction, one more row axis), and within
    float32 summation order on the kernel path's plain version."""
    q, k, v, table, pos0, _, _ = _operands(1, False)
    qb, kb, vb = (_t(x).bfloat16() for x in (q, k, v))
    got = TL.verify_attention(qb, kb, vb, _t(table), _t(pos0),
                              backend=backend, cfg="con2")
    rows = torch.cat([TL.paged_decode_attention(
        qb[:, t:t + 1], kb, vb, _t(table), _t(pos0) + t, backend=backend,
        cfg="con2") for t in range(T)], dim=1)
    if backend == "ref":
        assert torch.equal(got, rows)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   rows.float().numpy(), rtol=0,
                                   atol=2 * 2.0 ** -8)


def test_verify_wrapper_rejects_what_the_kernel_cannot_tile():
    q, k, v, table, pos0, _, _ = _operands(2, False)
    with pytest.raises(ValueError, match="tileable"):
        tops.flash_attention_verify(_t(q), _t(k), _t(v), _t(table[:, :6]),
                                    _t(pos0), "con4")
    with pytest.raises(ValueError, match="k_scale"):
        tops.flash_attention_verify(_t(q), _t(k), _t(v), _t(table),
                                    _t(pos0), v_scale=torch.ones(1))
    with pytest.raises(RuntimeError, match="no backward"):
        tops.flash_attention_verify(_t(q).requires_grad_(), _t(k), _t(v),
                                    _t(table), _t(pos0))


# -- lm_verify_step -----------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    cfg = get_config("qwen3-0.6b").reduced()
    return jax.tree.map(np.asarray, JM.lm_init(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("t_backend", ["ref", "cuda"])
def test_lm_verify_step_matches_the_reference(jparams, t_backend):
    """Prefill a prompt through the paged cache, then one verify of T rows
    with one slot padded (``valid_len``), on both sides in float32: logits
    of every valid row within atol 1e-5 (as the paged model test), and the
    pools written alike (the padded rows' writes on the NULL page)."""
    slots, ps, npp, prompt_len = 3, 4, 8, 9
    n_pages = slots * npp + 2
    jcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                               compute_dtype="float32",
                               decode_backend=t_backend,
                               ffn_backend=t_backend, decode_attn_cfg="con2")
    tparams = params_from_numpy(jparams, tcfg, "cpu", torch.float32)
    rng = np.random.default_rng(3)
    table = rng.permutation(np.arange(1, n_pages))[:slots * npp]
    table = table.reshape(slots, npp).astype(np.int32)
    prompt = rng.integers(1, jcfg.vocab, (slots, prompt_len)).astype(np.int32)
    draft = rng.integers(1, jcfg.vocab, (slots, T)).astype(np.int32)
    pos0 = np.full((slots,), prompt_len, np.int32)
    valid = np.array([T, 2, T], np.int32)

    jcache = JM.lm_init_cache_paged(jcfg, slots, n_pages, ps,
                                    dtype=jnp.float32)
    tcache = TM.lm_init_cache_paged(tcfg, n_pages, ps, dtype=torch.float32,
                                    device="cpu")
    _, jcache = JM.lm_prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcfg,
                              cache=jcache, block_table=jnp.asarray(table))
    TM.lm_prefill(tparams, torch.from_numpy(prompt), tcfg, cache=tcache,
                  block_table=torch.from_numpy(table))
    jl, jcache = JM.lm_verify_step(jparams, jcache, jnp.asarray(draft),
                                   jnp.asarray(pos0), jcfg,
                                   block_table=jnp.asarray(table),
                                   valid_len=jnp.asarray(valid))
    tl, _ = TM.lm_verify_step(tparams, tcache, torch.from_numpy(draft),
                              torch.from_numpy(pos0), tcfg,
                              block_table=torch.from_numpy(table),
                              valid_len=torch.from_numpy(valid))
    jl, tl = np.asarray(jl), tl.numpy()
    assert tl.shape == (slots, T, jcfg.vocab)
    for s in range(slots):
        np.testing.assert_allclose(tl[s, :valid[s]], jl[s, :valid[s]],
                                   rtol=0, atol=1e-5)
    jk = np.asarray(jcache["blocks"][0]["k"][2])
    tk = tcache["layers"][2]["k"].numpy()
    np.testing.assert_allclose(tk[1:], jk[1:], rtol=0, atol=1e-5)


def test_lm_verify_rows_equal_decode_steps(jparams):
    """The accept rule's premise on the port itself: row t of one verify
    pass equals `lm_decode_step` at pos0 + t fed the same tokens, from the
    same cache (bf16, the kernel path's plain versions): the same greedy
    argmax on every row, logits within 2% of the largest."""
    slots, ps, npp = 2, 4, 8
    cfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                              decode_backend="cuda", ffn_backend="cuda")
    params = params_from_numpy(jparams, cfg, "cpu")
    table = torch.arange(1, 1 + slots * npp, dtype=torch.int32).reshape(
        slots, npp)
    cache = TM.lm_init_cache_paged(cfg, slots * npp + 1, ps, device="cpu")
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab, (slots, 7)))
    TM.lm_prefill(params, prompt, cfg, cache=cache, block_table=table)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (slots, T)))
    pos0 = torch.full((slots,), 7, dtype=torch.int32)
    snapshot = {"layers": [{n: x.clone() for n, x in c.items()}
                           for c in cache["layers"]]}
    vl, _ = TM.lm_verify_step(params, cache, toks, pos0, cfg,
                              block_table=table)
    rows = []
    for t in range(T):
        lg, _ = TM.lm_decode_step(params, snapshot, toks[:, t:t + 1],
                                  pos0 + t, cfg, block_table=table)
        rows.append(lg)
    dl = torch.stack(rows, dim=1)
    assert torch.equal(vl.argmax(-1), dl.argmax(-1))
    assert (vl - dl).abs().max() <= 0.02 * dl.abs().max()


@pytest.mark.parametrize("step", ["decode", "verify"])
def test_step_products_take_the_route(jparams, monkeypatch, step):
    """With the kernel backends on CPU tensors, one reduced-qwen3
    `lm_decode_step` or `lm_verify_step` sends every product (q, k, v, o,
    gate, up, down a layer, and the head) to row 2's wrapper under the
    steps' one-tile plan (`matmul.step_matmul`): 7 L + 1 calls, each on
    all the step's rows, and calls `torch.matmul` or ``@`` from the model
    code for none of them."""
    slots, ps, npp = 2, 4, 8
    cfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                              decode_backend="cuda", ffn_backend="cuda")
    params = params_from_numpy(jparams, cfg, "cpu")
    table = torch.arange(1, 1 + slots * npp, dtype=torch.int32).reshape(
        slots, npp)
    cache = TM.lm_init_cache_paged(cfg, slots * npp + 1, ps, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (slots, T)))
    pos = torch.full((slots,), 7, dtype=torch.int32)
    route, plain = [], []
    cmm, mm, at = tmm.coarsened_matmul, torch.matmul, torch.Tensor.__matmul__

    def routed(a, b, *args, **kw):
        route.append(a.shape[0])
        return cmm(a, b, *args, **kw)

    def from_models():
        return "repro_torch/models/" in sys._getframe(2).f_code.co_filename

    def matmul(*a, **kw):
        if from_models():
            plain.append("torch.matmul")
        return mm(*a, **kw)

    def matmul_op(x, y):
        if from_models():
            plain.append("@")
        return at(x, y)

    monkeypatch.setattr(tmm, "coarsened_matmul", routed)
    monkeypatch.setattr(torch, "matmul", matmul)
    monkeypatch.setattr(torch.Tensor, "__matmul__", matmul_op)
    if step == "decode":
        TM.lm_decode_step(params, cache, toks[:, :1], pos, cfg,
                          block_table=table)
    else:
        TM.lm_verify_step(params, cache, toks, pos, cfg, block_table=table)
    rows = slots * (1 if step == "decode" else T)
    assert route == [rows] * (7 * cfg.n_layers + 1)
    assert plain == []


# -- the engine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_model(jparams):
    cfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                              decode_backend="cuda", ffn_backend="cuda")
    return cfg, params_from_numpy(jparams, cfg, "cpu")


def _trace(cfg):
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, int(n))))
               for n in (9, 17, 5, 24, 12)]
    gens = [12, 6, 1, 16, 9]
    return prompts, gens


def _run(make, prompts, gens):
    eng = make()
    sched = Scheduler(eng)
    for p, g in zip(prompts, gens):
        sched.submit(p, g)
    done = sched.run_until_done()
    assert eng.pool.num_live == 0 and not eng.active.any(), "leaked pages"
    assert eng.pool.num_free == eng.pool.capacity
    eng.pool.check()
    assert all(r.state is State.FINISHED for r in done)
    return eng, [r.output for r in done], done


KW = dict(slots=3, num_pages=40, page_size=8, max_len=64, chunk=8,
          device="cpu")


def _base_outputs(cfg, params, prompts, gens, **kw):
    kw = {**KW, **kw}
    _, out, _ = _run(lambda: PagedEngine(cfg, params, decode_block=4, **kw),
                     prompts, gens)
    return out


def test_parity_under_forced_rejection(tiny_model):
    """A fresh random draft (`draft_of`) agrees with the target only by
    chance, so nearly every step rejects at row 0 and emits the target's
    correction — the rollback path and the rescue pass at their busiest —
    and the outputs still equal the base engine's."""
    cfg, params = tiny_model
    prompts, gens = _trace(cfg)
    base = _base_outputs(cfg, params, prompts, gens)
    eng, out, _ = _run(
        lambda: SpecPagedEngine(cfg, params, spec_k=4,
                                generator=torch.Generator().manual_seed(7),
                                **KW), prompts, gens)
    assert out == base
    assert eng.draft_cfg.n_layers < cfg.n_layers or \
        eng.draft_cfg.d_model <= cfg.d_model
    assert eng.acceptance_rate < 0.3          # the draft really is garbage
    assert eng.spec_steps > 0


def test_parity_and_multi_token_steps_with_self_draft(tiny_model):
    """Target as its own draft: every proposal whose verify row clears the
    tie guard is accepted, so steps emit more than one token on average,
    and the outputs still equal the base engine's.  With the guard off
    (``tie_tau=0``) the CPU verify rows agree with the draft's decode rows
    on every argmax: acceptance 1.0."""
    cfg, params = tiny_model
    prompts, gens = _trace(cfg)
    base = _base_outputs(cfg, params, prompts, gens)
    eng, out, _ = _run(
        lambda: SpecPagedEngine(cfg, params, spec_k=4, draft_cfg=cfg,
                                draft_params=params, **KW), prompts, gens)
    assert out == base
    assert eng.acceptance_rate > 0.2
    assert eng.decoded_tokens / eng.spec_steps > 1.2
    eng, out, _ = _run(
        lambda: SpecPagedEngine(cfg, params, spec_k=4, draft_cfg=cfg,
                                draft_params=params, tie_tau=0.0, **KW),
        prompts, gens)
    assert eng.acceptance_rate == 1.0 and eng.rescue_steps == 0
    assert out == base


def test_parity_under_preemption(tiny_model):
    """A pool small enough to force preemption: rollback, requeue and
    re-prefill (target AND draft caches) still land on the base outputs,
    with no page leaked."""
    cfg, params = tiny_model
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, 6)))
               for _ in range(3)]
    gens = [18] * 3
    kw = dict(num_pages=8, max_len=32)
    base = _base_outputs(cfg, params, prompts, gens, **kw)
    eng, out, done = _run(
        lambda: SpecPagedEngine(cfg, params, spec_k=4,
                                generator=torch.Generator().manual_seed(7),
                                **{**KW, **kw}), prompts, gens)
    assert sum(r.preemptions for r in done) > 0, \
        "pool failed to force preemption"
    assert out == base


def test_int8_kv_spec_engine_matches_its_base_engine(tiny_model):
    """int8 KV pools on both engines (the draft inherits the target's
    kv_quant through `draft_of`): the same greedy outputs."""
    cfg, params = tiny_model
    cfg = dataclasses.replace(cfg, kv_quant="int8")
    prompts, gens = _trace(cfg)
    base = _base_outputs(cfg, params, prompts, gens)
    eng, out, _ = _run(
        lambda: SpecPagedEngine(cfg, params, spec_k=3, draft_cfg=cfg,
                                draft_params=params, **KW), prompts, gens)
    assert out == base
    assert eng.cache["layers"][0]["k"].dtype == torch.int8
    assert eng.draft_cache["layers"][0]["k"].dtype == torch.int8


# -- construction and accounting ----------------------------------------------

def test_draft_of_shrinks_but_shares_vocab(tiny_model):
    cfg, _ = tiny_model
    d = draft_of(cfg)
    assert d.vocab == cfg.vocab
    assert d.n_layers <= cfg.n_layers and d.d_model <= cfg.d_model
    full = t_get_config("qwen3-0.6b")
    assert draft_of(full).vocab == full.vocab == 151936
    assert draft_of(full).d_model == 128


def test_vocab_mismatch_and_spec_k_rejected(tiny_model):
    cfg, params = tiny_model
    bad = dataclasses.replace(draft_of(cfg), vocab=cfg.vocab // 2)
    with pytest.raises(ValueError, match="vocab"):
        SpecPagedEngine(cfg, params, spec_k=2, draft_cfg=bad, **KW)
    with pytest.raises(ValueError, match="spec_k"):
        SpecPagedEngine(cfg, params, spec_k=0, **KW)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-370m"])
def test_recurrent_target_and_draft_rejected(tiny_model, arch):
    """The reference's attention-only checks (`repro/serve/spec.py:100-117`)
    on the target and on the draft, with its messages: recurrent and SSM
    state cannot be rewound past rejected rows."""
    cfg, params = tiny_model
    other = t_get_config(arch).reduced()
    with pytest.raises(NotImplementedError,
                       match="needs an attention-only stack"):
        SpecPagedEngine(other, None, spec_k=2, **KW)
    draft = dataclasses.replace(other, vocab=cfg.vocab)
    with pytest.raises(NotImplementedError,
                       match="draft model must be attention-only"):
        SpecPagedEngine(cfg, params, spec_k=2, draft_cfg=draft, **KW)


def test_step_growth_bound_accounts_k_plus_1_rows(tiny_model):
    """The scheduler's admission headroom hook (missing from the port's
    engine before): a verify step may append K+1 rows per running slot,
    and an incoming request needs its prompt pages plus its own first
    step's growth — counted by hand here."""
    cfg, params = tiny_model
    eng = SpecPagedEngine(cfg, params, spec_k=4,
                          generator=torch.Generator().manual_seed(7), **KW)
    ps = eng.page_size
    eng.admit(0, Request(rid=0, prompt=[1] * 9, gen=12))      # 9 rows
    eng.admit(1, Request(rid=1, prompt=[2] * 3, gen=12))      # 3 rows
    # slot 0: rows 9..13 -> 2 pages needed, 2 held; slot 1: rows 3..7 ->
    # 1 page needed, 1 held: no growth yet
    assert eng.bt.num_pages(0) == 2 and eng.bt.num_pages(1) == 1
    assert eng.step_growth_bound() == 0
    eng.written[1] = 6              # rows 6..10 now cross into page 2
    assert eng.step_growth_bound() == 1
    incoming = Request(rid=2, prompt=[1] * 11, gen=8)         # 11 + 5 rows
    assert eng.step_growth_bound(incoming) == 1 + 2
    assert eng._step_rows() == 5
    for s in (0, 1):
        eng.pool.release(eng.bt.drop(s))
    eng.pool.check()


def test_base_engine_growth_bound_counts_a_decode_block(tiny_model):
    """`PagedEngine._growth_bound` counts ``decode_block`` rows a slot (the
    reference's `engine.py:551-570`); the base engine does not offer it to
    the scheduler, as in the reference."""
    cfg, params = tiny_model
    eng = PagedEngine(cfg, params, decode_block=8, **KW)
    eng.admit(0, Request(rid=0, prompt=[1] * 7, gen=12))      # 1 page
    assert eng._step_rows() == 8
    assert eng._growth_bound() == pages_needed(7 + 8, 8) - 1 == 1
    assert eng._growth_bound(Request(rid=1, prompt=[1] * 9, gen=2)) == \
        1 + pages_needed(9 + 8, 8)
    assert not hasattr(eng, "step_growth_bound")
    eng.finish(0)


def test_scheduler_holds_admission_for_verify_growth(tiny_model):
    """With K+1 rows of growth a step, a nearly full pool makes the
    scheduler hold a waiting request until decode progress frees pages
    (instead of admitting and preempting at once); every request still
    finishes and no page leaks."""
    cfg, params = tiny_model
    rng = np.random.default_rng(9)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, 7)))
               for _ in range(3)]
    eng, out, done = _run(
        lambda: SpecPagedEngine(cfg, params, spec_k=4, draft_cfg=cfg,
                                draft_params=params,
                                **{**KW, "num_pages": 9, "max_len": 32}),
        prompts, [12] * 3)
    base = _base_outputs(cfg, params, prompts, [12] * 3, num_pages=9,
                         max_len=32)
    assert out == base


def test_launch_serve_spec_front_end_on_cpu(capsys):
    """``--spec-k 4`` end to end on the CPU plain versions, self draft and
    the default draft: every request finishes, the acceptance line prints,
    an undersized pool forces preemption."""
    from repro_torch.launch import serve
    common = ["--reduced", "--device", "cpu", "--slots", "3", "--requests",
              "5", "--prompt-len", "8", "--gen-tokens", "10", "--max-len",
              "32", "--page-size", "8", "--num-pages", "8", "--chunk", "8",
              "--spec-k", "4"]
    for draft in ("self", "draft_of"):
        done = serve.main(common + ["--draft-config", draft])
        out = capsys.readouterr().out
        assert f"speculative: K=4 draft={draft}" in out
        assert len(done) == 5
        assert all(r.state is State.FINISHED and len(r.output) == 10
                   for r in done)
        assert sum(r.preemptions for r in done) > 0


# -- page bookkeeping of the spec step ----------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_spec_walk_conserves_pages(seed):
    """The decode step's page dance, abstracted from the model: grow to the
    worst case (written + K + 1 rows), emit 1..K+1 tokens, truncate back to
    the accepted rows.  After every step the pool conserves (free + live ==
    capacity) and the table holds exactly pages_needed(written) pages."""
    rng = np.random.default_rng(seed)
    ps, spec_k = 4, int(rng.integers(1, 9))
    pool, bt = PagePool(64, ps), BlockTables(1, 64)
    written = int(rng.integers(1, 18))
    bt.append(0, pool.alloc(pages_needed(written, ps)))
    for acc in rng.integers(0, 10, 40):
        need = pages_needed(written + spec_k + 1, ps) - bt.num_pages(0)
        if need > 0:
            bt.append(0, pool.alloc(need))
        written += min(int(acc), spec_k) + 1
        pool.release(bt.truncate(0, pages_needed(written, ps)))
        assert pool.num_free + pool.num_live == pool.capacity
        assert bt.num_pages(0) == pages_needed(written, ps)
        pool.check()
    pool.release(bt.drop(0))
    assert pool.num_free == pool.capacity
