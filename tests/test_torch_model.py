"""Paged chunked prefill and paged decode of reduced qwen3-0.6b: the port
against `repro.models.model`, with `repro`'s parameters carried across by
`params_from_numpy`.  Logits of every prefill chunk and every decode step
are compared, the decode teacher-forced on the reference's greedy tokens.

The reference's decode attention runs its plain path (``decode_backend=
"ref"``): its paged Pallas kernel cannot run in interpret mode on the
installed JAX (``pl.load`` is gone).  The port runs both its plain path
and its kernel path (whose CPU version is the split-KV arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import model as TM
from repro_torch.models.interop import layer_leaves, params_from_numpy

SLOTS, PS, MAX_LEN, CHUNK, PROMPT, STEPS = 3, 4, 32, 4, 12, 6
NPP = MAX_LEN // PS
N_PAGES = SLOTS * NPP + 2
ACTIVE = [0, 1]          # slot 2 is not admitted: its table row is nulled


@pytest.fixture(scope="module")
def jparams():
    cfg = get_config("qwen3-0.6b").reduced()
    return jax.tree.map(np.asarray, JM.lm_init(jax.random.PRNGKey(0), cfg))


def _leaves(tree):
    if isinstance(tree, dict):
        return sum((_leaves(v) for v in tree.values()), [])
    if isinstance(tree, list):
        return sum((_leaves(v) for v in tree), [])
    return [tree]


def test_params_from_numpy_consumes_every_leaf(jparams):
    cfg = t_get_config("qwen3-0.6b").reduced()
    tp = params_from_numpy(jparams, cfg, "cpu", torch.float32)
    n_j = sum(a.size for a in _leaves(jparams))
    n_t = sum(t.numel() for t in _leaves(tp))
    assert n_t == n_j                       # every value carried, once
    assert len(tp["layers"]) == cfg.n_layers
    assert {".".join(k) for k in _paths(tp["layers"][1])} \
        == layer_leaves(cfg)
    np.testing.assert_array_equal(
        tp["layers"][2]["attn"]["wq"].numpy(),
        np.asarray(jparams["blocks"][0]["attn"]["wq"][2], np.float32))
    extra = {**jparams, "blocks": [{**jparams["blocks"][0],
                                    "stray": jparams["blocks"][0]["ln1"]}]}
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_numpy(extra, cfg, "cpu")
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_numpy({**jparams, "extra": jparams["embed"]}, cfg,
                          "cpu")
    bf = params_from_numpy(jparams, cfg, "cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["layers"][0]["ln1"]["scale"].dtype == torch.float32


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _run(jparams, compute_dtype, t_backend):
    """-> list of (reference logits, port logits) per chunk and step."""
    jcfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                               compute_dtype=compute_dtype,
                               decode_backend=t_backend,
                               ffn_backend=t_backend, decode_attn_cfg="con2")
    jdt, tdt = jnp.dtype(compute_dtype), getattr(torch, compute_dtype)
    tparams = params_from_numpy(jparams, tcfg, "cpu", tdt)
    rng = np.random.default_rng(7)
    table = rng.permutation(np.arange(1, N_PAGES))[: SLOTS * NPP]
    table = table.reshape(SLOTS, NPP).astype(np.int32)
    pre_table = table.copy()
    pre_table[2] = 0
    prompt = rng.integers(1, jcfg.vocab, (SLOTS, PROMPT)).astype(np.int32)

    jcache = JM.lm_init_cache_paged(jcfg, SLOTS, N_PAGES, PS, dtype=jdt)
    tcache = TM.lm_init_cache_paged(tcfg, N_PAGES, PS, dtype=tdt,
                                    device="cpu")
    jpre = jax.jit(lambda c, t, p0, bt: JM.lm_prefill(
        jparams, {"tokens": t}, jcfg, cache=c, pos0=p0, block_table=bt))
    jdec = jax.jit(lambda c, t, pos, bt: JM.lm_decode_step(
        jparams, c, t, pos, jcfg, block_table=bt))
    out = []
    for i in range(0, PROMPT, CHUNK):
        t = prompt[:, i:i + CHUNK]
        p0 = np.full((SLOTS,), i, np.int32)
        jl, jcache = jpre(jcache, t, p0, pre_table)
        tl, _ = TM.lm_prefill(tparams, torch.from_numpy(t), tcfg,
                              cache=tcache, pos0=torch.from_numpy(p0),
                              block_table=torch.from_numpy(pre_table))
        out.append((np.asarray(jl)[ACTIVE], tl.numpy()[ACTIVE]))
    tok = np.asarray(out[-1][0]).argmax(-1)
    tok = np.concatenate([tok, [0]]).astype(np.int32)[:, None]
    dec_table = table.copy()
    dec_table[2] = 0
    for s in range(STEPS):
        pos = np.full((SLOTS,), PROMPT + s, np.int32)
        jl, jcache = jdec(jcache, tok, pos, dec_table)
        tl, _ = TM.lm_decode_step(tparams, tcache, torch.from_numpy(tok),
                                  torch.from_numpy(pos), tcfg,
                                  block_table=torch.from_numpy(dec_table))
        jl = np.asarray(jl)
        out.append((jl[ACTIVE], tl.numpy()[ACTIVE]))
        tok = jl.argmax(-1).astype(np.int32)[:, None]   # teacher forcing
    return out


@pytest.mark.parametrize("t_backend", ["ref", "cuda"])
def test_paged_prefill_and_decode_float32(jparams, t_backend):
    """float32 compute and pools: the same arithmetic up to summation order
    and library transcendentals, carried through 4 layers: atol 1e-5 on
    logits of unit scale (about 100 float32 ulps)."""
    for want, got in _run(jparams, "float32", t_backend):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("t_backend", ["ref", "cuda"])
def test_paged_prefill_and_decode_bfloat16(jparams, t_backend):
    """bf16 compute, weights and pools (the serving configuration).  Each
    matmul, norm and attention output rounds to bf16 (2^-8 relative) at
    slightly different points on the two sides; through 4 layers that
    stays within 0.03 absolute (8 bf16 ulps) on logits whose scale is ~1.
    The kernel path also keeps q and the probabilities in f32 where the
    reference's plain decode path rounds them to bf16."""
    worst = 0.0
    for want, got in _run(jparams, "bfloat16", t_backend):
        assert np.isfinite(got).all()
        worst = max(worst, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=0.03)
    assert worst > 0          # the two sides really ran separately


def test_write_mask_routes_a_slot_to_the_null_page(jparams):
    """``write_mask`` False sends that slot's new K/V row to the NULL page
    (page 0); the other slots write through their tables in place."""
    tcfg = t_get_config("qwen3-0.6b").reduced()
    tparams = params_from_numpy(jparams, tcfg, "cpu", torch.float32)
    cache = TM.lm_init_cache_paged(tcfg, N_PAGES, PS, dtype=torch.float32,
                                   device="cpu")
    table = torch.arange(1, 1 + SLOTS * NPP, dtype=torch.int32).reshape(
        SLOTS, NPP)
    pos = torch.tensor([5, 9, 2], dtype=torch.int32)
    tok = torch.tensor([[3], [4], [5]], dtype=torch.int32)
    TM.lm_decode_step(tparams, cache, tok, pos, tcfg, block_table=table,
                      write_mask=torch.tensor([True, False, True]))
    k = cache["layers"][0]["k"]
    page = table[torch.arange(SLOTS), pos.long() // PS].long()
    row = pos.long() % PS
    assert k[page[0], row[0]].abs().sum() > 0
    assert k[page[2], row[2]].abs().sum() > 0
    assert k[page[1]].abs().sum() == 0          # slot 1's page untouched
    assert k[0, row[1]].abs().sum() > 0         # its row went to NULL
