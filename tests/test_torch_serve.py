"""Paged serving: the port's page pool and block tables, and the port's
`PagedEngine` + `Scheduler` against the reference's on one request trace
through an undersized pool that forces preemption.

Both schedulers recompute on preemption: the reference's gets
``host_swap_bytes=0``; the port's engine has no ``suspend``.  The
reference engine decodes through its plain attention path
(``decode_backend="ref"``; its Pallas paged kernel cannot run in interpret
mode on the installed JAX), the port's through its kernel path (on CPU the
split-KV arithmetic) and the matmul wrapper.

Greedy tokens must agree wherever the reference's top-1/top-2 logit margin
exceeds the logit tolerance: up to a request's first differing token that
token's reference margin must be below ``MARGIN_TOL`` (a near-tie either
side may break), and after it the two contexts differ, so the comparison
of that request stops there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as JM
from repro.serve import PagedEngine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve.paging import BlockTables as JTables
from repro.serve.paging import PagePool as JPool
from repro.serve.paging import PoolExhausted as JExhausted
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.interop import params_from_numpy
from repro_torch.serve import PagedEngine as TEngine
from repro_torch.serve import Scheduler as TScheduler
from repro_torch.serve import State
from repro_torch.serve.paging import (NULL_PAGE, BlockTables, PagePool,
                                      PoolExhausted, pages_needed)

ENGINE = dict(slots=3, num_pages=8, page_size=8, max_len=32, chunk=8,
              decode_block=4)
# logit tolerance of the bf16 model comparison (tests/test_torch_model.py)
# plus the difference between recomputing a step by prefill and decoding it
MARGIN_TOL = 0.05


# -- pool and tables ------------------------------------------------------------

def _walk(pool_cls, tables_cls, exhausted, seed, steps=200):
    """Random admit/grow/finish walk; returns the allocation log."""
    rng = np.random.default_rng(seed)
    pool, bt = pool_cls(12, 4), tables_cls(3, 6)
    log = []
    for _ in range(steps):
        slot = int(rng.integers(3))
        op = rng.choice(["alloc", "drop", "truncate"])
        try:
            if op == "alloc":
                pages = pool.alloc(int(rng.integers(1, 3)))
                try:
                    bt.append(slot, pages)
                except exhausted:
                    pool.release(pages)
                    raise
                log.append(("alloc", slot, tuple(pages)))
            elif op == "drop":
                pool.release(bt.drop(slot))
                log.append(("drop", slot))
            else:
                pool.release(bt.truncate(slot, int(rng.integers(0, 3))))
                log.append(("truncate", slot))
        except Exception as e:          # both implementations raise alike
            log.append(("raise", type(e).__name__))
        pool.check()
        live = sum(bt.num_pages(s) for s in range(3))
        assert pool.num_free + live == pool.capacity
        owners = bt.owners()
        assert all(len(v) == 1 for v in owners.values()), "page aliased"
        dev = bt.device()
        assert dev.shape == (3, 6) and dev.dtype == np.int32
        assert (dev[dev != NULL_PAGE] > 0).all()
    for s in range(3):
        pool.release(bt.drop(s))
    assert pool.num_free == pool.capacity
    return log


@pytest.mark.parametrize("seed", range(4))
def test_pool_and_tables_walk_like_the_reference(seed):
    """Invariants on every step (free + live == capacity, no aliasing, no
    leak) and the same allocation sequence as the reference's copy."""
    got = _walk(PagePool, BlockTables, PoolExhausted, seed)
    assert got == _walk(JPool, JTables, JExhausted, seed)


def test_pool_refuses_without_side_effects():
    pool = PagePool(4, 8)
    a = pool.alloc(2)
    with pytest.raises(PoolExhausted):
        pool.alloc(2)
    assert pool.num_free == 1 and pool.num_live == 2
    pool.release(a)
    with pytest.raises(ValueError, match="double free"):
        pool.release(a[:1])
    assert pages_needed(17, 8) == 3 and pages_needed(0, 8) == 0


# -- engine parity ---------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = get_config("qwen3-0.6b").reduced()
    jparams = JM.lm_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams


def _trace(vocab):
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, vocab, n))) for n in (6, 7, 5, 8)]


GEN = 16


def _serve(sched_cls, engine, prompts):
    sched = sched_cls(engine, **({"host_swap_bytes": 0}
                                 if sched_cls is JScheduler else {}))
    for p in prompts:
        sched.submit(p, GEN)
    done = sched.run_until_done()
    return done


def _margin(jcfg, jparams, tokens) -> float:
    """Reference top-1 minus top-2 logit after ``tokens``."""
    t = jnp.asarray([tokens], jnp.int32)
    logits, _ = JM.lm_prefill(jparams, {"tokens": t}, jcfg, s_max=len(tokens))
    top = np.sort(np.asarray(logits[0], np.float32))[-2:]
    return float(top[1] - top[0])


def test_engine_matches_reference_under_preemption(model):
    jcfg, jparams = model
    prompts = _trace(jcfg.vocab)
    jeng = JEngine(jcfg, jparams, decode_backend="ref", **ENGINE)
    jdone = _serve(JScheduler, jeng, prompts)

    tcfg = dataclasses.replace(t_get_config("qwen3-0.6b").reduced(),
                               decode_attn_cfg="con2")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    teng = TEngine(tcfg, tparams, decode_backend="cuda", ffn_backend="cuda",
                   device="cpu", **ENGINE)
    tdone = _serve(TScheduler, teng, prompts)

    assert sum(r.preemptions for r in jdone) > 0
    assert sum(r.preemptions for r in tdone) > 0, "pool forced no preemption"
    assert not hasattr(teng, "suspend")          # recompute path only
    for eng in (jeng, teng):
        eng.pool.check()
        assert eng.pool.num_free + eng.pool.num_live == eng.pool.capacity
        assert eng.pool.num_live == 0 and not eng.active.any()
    compared = 0
    for jr, tr, p in zip(jdone, tdone, prompts):
        assert jr.rid == tr.rid and tr.state is State.FINISHED
        assert len(tr.output) == len(jr.output) == GEN
        for i, (a, b) in enumerate(zip(jr.output, tr.output)):
            if a != b:
                margin = _margin(jcfg, jparams, p + jr.output[:i])
                assert margin < MARGIN_TOL, (
                    f"request {jr.rid} token {i}: {b} != {a} with a "
                    f"reference margin of {margin:.4f}")
                break
            compared += 1
    # the comparison must not be vacuous: most tokens were compared
    assert compared >= len(prompts) * GEN // 2, compared


def test_engine_rejects_what_is_not_ported(model):
    jcfg, jparams = model
    tcfg = t_get_config("qwen3-0.6b").reduced()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    eng = TEngine(tcfg, tparams, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError):
        eng.register_prefix("sys", [1] * 16)
    sched = TScheduler(eng)
    with pytest.raises(ValueError, match="max_len"):
        sched.submit([1] * 30, 8)
    req = sched.submit([1, 2, 3], 2, prefix="sys")
    with pytest.raises(NotImplementedError, match="prefix"):
        sched.run_until_done()
    assert req.state is State.WAITING
    assert eng.pool.num_live == 0
    assert torch.is_tensor(eng.cache["layers"][0]["k"])


def test_launch_serve_front_end_on_cpu(capsys):
    """The port's front end end to end on the CPU plain versions: an
    undersized pool forces preemption, every request finishes, no leak."""
    from repro_torch.launch import serve
    done = serve.main(["--reduced", "--device", "cpu", "--slots", "3",
                       "--requests", "5", "--prompt-len", "8",
                       "--gen-tokens", "10", "--max-len", "32",
                       "--page-size", "8", "--num-pages", "8",
                       "--chunk", "8", "--decode-block", "4"])
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "on cpu" in out
    assert len(done) == 5 and all(r.state is State.FINISHED for r in done)
    assert sum(r.preemptions for r in done) > 0
