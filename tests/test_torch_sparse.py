"""The port's block-sparse flash attention against the reference, on the CPU.

* The live-KV index: the port's `build_block_index` / `max_live_blocks`
  equal the reference's arrays over a grid of geometries (global stride
  and non-causal included), and a hypothesis property holds the port's
  index against the reference's elementwise `_element_mask`.
* `ref.flash_sparse` (the walk of the index in the kernel's slot order,
  what the wrapper computes on CPU tensors and what the card check holds
  the CUDA kernel against) against the reference's
  `ops.flash_attention_sparse(backend="ref")` for every label; its (m, l)
  against the reference's dense Pallas flash forward in interpret mode
  (the Pallas sparse kernel does not run on the installed JAX); NULL
  slots never read (NaN outside the live set).
* Gradients of the port's `ops.flash_attention_sparse` against
  ``jax.vjp`` of the reference's dense-mask oracle, with and without a
  global stride.
* The layer dispatch: the sparse branch, ``sparse="off"``, a slot degree
  that does not divide max_live, the global-stride branch, and an unheld
  geometry (plain route on the CPU, NotImplementedError off it).
* A reduced gemma3-1b train step (head dim 64 so the port's kernels hold
  it) against the reference's `M.lm_loss` + ``jax.value_and_grad``.

Inputs are float32, made with numpy from a seed.  Tolerances: atol 1e-5
for o and m (float32 summation order), rtol 1e-5 for l (row sums up to
~1e2); gradients rtol 1e-3 / atol 1e-4 and the train-step loss rtol 1e-5,
as in `tests/test_torch_train.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config
from repro.core.coarsening import CoarseningConfig as JCfg
from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro.kernels import sparse_attention as JSA
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import accumulate_grads as j_accumulate
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.tree import leaves
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sparse_attention as TSA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.interop import params_from_numpy
from repro_torch.optim import accumulate_grads

B, H, HKV, S, D = 1, 4, 2, 256, 16
BQ = BKV = 32
O_TOL = dict(rtol=0, atol=1e-5)
L_TOL = dict(rtol=1e-5, atol=1e-5)
G_TOL = dict(rtol=1e-3, atol=1e-4)
LABELS = ("base", "con2", "gap2", "con4", "gap4", "con8", "gap8")
PATTERNS = {
    "causal": dict(causal=True, window=None, global_stride=None),
    "window": dict(causal=True, window=64, global_stride=None),
    "window+gstride": dict(causal=True, window=64, global_stride=96),
}
# (sq, sk, bq, bkv, causal, window, global_stride)
GEOMETRIES = [
    (4096, 4096, 128, 128, True, 512, None),     # gemma3-1b's train shape
    (1024, 1024, 128, 128, True, 512, None),
    (32768, 32768, 128, 128, True, 512, None),
    (256, 256, 32, 32, True, 64, 96),
    (256, 256, 32, 64, True, 48, 16),
    (512, 256, 64, 32, False, None, None),
    (256, 512, 32, 64, False, 100, 7),
    (128, 128, 16, 32, True, None, None),
    (4096, 4096, 64, 128, True, 1000, 512),
]


def _operands(seed=0, s=S, d=D):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, s, d)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, HKV, s, d)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, HKV, s, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


# -- the live-KV index --------------------------------------------------------

@pytest.mark.parametrize("geo", GEOMETRIES,
                         ids=lambda g: "-".join(map(str, g)))
def test_index_equals_reference(geo):
    sq, sk, bq, bkv, causal, window, gs = geo
    pat = dict(causal=causal, window=window, global_stride=gs)
    got = TSA.build_block_index(sq, sk, bq, bkv, **pat)
    want = JSA.build_block_index(sq, sk, bq, bkv, **pat)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert TSA.max_live_blocks(sq, sk, bq, bkv, **pat) == \
        JSA.max_live_blocks(sq, sk, bq, bkv, **pat) == want.shape[1]


_GEOMS = st.tuples(
    st.integers(1, 6), st.integers(1, 6),           # nq, nk blocks
    st.sampled_from([8, 16, 32]),                   # bq
    st.sampled_from([8, 16, 32]),                   # bkv
    st.booleans(),                                  # causal
    st.one_of(st.none(), st.integers(1, 128)),      # window
    st.one_of(st.none(), st.integers(1, 96)),       # global_stride
)


@settings(max_examples=60, deadline=None)
@given(g=_GEOMS)
def test_index_lists_exactly_the_live_blocks(g):
    """Every block holding a live pair of the reference's element mask is
    listed once, ascending, no other block is, and NULL pads a tail."""
    nq, nk, bq, bkv, causal, window, gs = g
    sq, sk = nq * bq, nk * bkv
    pat = dict(causal=causal, window=window,
               global_stride=gs if window else None)
    idx = TSA.build_block_index(sq, sk, bq, bkv, **pat)
    em = np.asarray(JSA._element_mask(np.arange(sq)[:, None],
                                      np.arange(sk)[None, :], **pat))
    live = em.reshape(nq, bq, nk, bkv).any(axis=(1, 3))
    assert idx.shape[0] == nq and idx.shape[1] % 8 == 0
    for i in range(nq):
        row = idx[i][idx[i] >= 0]
        np.testing.assert_array_equal(row, np.nonzero(live[i])[0])
        assert (idx[i][len(row):] == TSA.NULL_BLOCK).all()
    # the port's mask is the reference's on torch tensors too
    tm = TSA._element_mask(torch.arange(sq)[:, None],
                           torch.arange(sk)[None, :], **pat)
    np.testing.assert_array_equal(tm.numpy(), em)


def test_index_rejects_untileable_and_uploads_once():
    with pytest.raises(ValueError, match="not tileable"):
        TSA.build_block_index(100, 100, 32, 32)
    kw = dict(causal=True, window=64, global_stride=None, device="cpu")
    a = TSA.device_index(S, S, BQ, BKV, **kw)
    assert a is TSA.device_index(S, S, BQ, BKV, **kw)
    assert a.dtype == torch.int32
    np.testing.assert_array_equal(
        a.numpy(), JSA.build_block_index(S, S, BQ, BKV, causal=True,
                                         window=64))


# -- the plain version of the kernel ------------------------------------------

@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("pat", PATTERNS, ids=str)
def test_flash_sparse_matches_reference_oracle(pat, label):
    q, k, v = _operands()
    kw = PATTERNS[pat]
    want = jops.flash_attention_sparse(
        *map(jnp.asarray, (q, k, v)), bq=BQ, bkv=BKV, backend="ref", **kw)
    idx = TSA.build_block_index(S, S, BQ, BKV, **kw)
    cfg = JCfg.parse(label)
    o, m, l = tref.flash_sparse(*_t(q, k, v), idx, degree=cfg.degree,
                                gapped=cfg.kind == "gapped", bq=BQ, bkv=BKV,
                                **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **O_TOL)
    # the wrapper's CPU path is the same function
    got = TSA.flash_sparse_fwd(*_t(q, k, v), idx, label, bq=BQ, bkv=BKV,
                               **kw)
    np.testing.assert_allclose(got.numpy(), o.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("label", ("base", "con2", "gap4"))
def test_flash_sparse_residuals_match_dense_pallas(label):
    """(m, l) equal the dense-mask Pallas forward's (interpret mode): the
    invariant that lets the backward reuse the dense dQ and dK/dV."""
    q, k, v = _operands(1)
    w = 64
    run = jflash.make_kernel(B, H, HKV, S, D, JCfg.parse("base"), bq=BQ,
                             bkv=BKV, causal=True, window=w,
                             return_residuals=True, interpret=True)
    jo, jm, jl = map(np.asarray, run(*map(jnp.asarray, (q, k, v))))
    cfg = JCfg.parse(label)
    idx = TSA.build_block_index(S, S, BQ, BKV, causal=True, window=w)
    o, m, l = tref.flash_sparse(*_t(q, k, v), idx, degree=cfg.degree,
                                gapped=cfg.kind == "gapped", bq=BQ, bkv=BKV,
                                causal=True, window=w)
    np.testing.assert_allclose(m.numpy(), jm, **O_TOL)
    np.testing.assert_allclose(l.numpy(), jl, **L_TOL)
    np.testing.assert_allclose(o.numpy(), jo, **O_TOL)


def test_flash_sparse_never_reads_a_null_slot():
    """K/V blocks no index row lists hold NaN; the output stays finite
    and equals the oracle over the listed blocks."""
    q, k, v = _operands(2)
    nq = nkb = S // BQ
    rng = np.random.default_rng(3)
    dead = {3, 5, 7}
    idx = np.full((nq, 4), TSA.NULL_BLOCK, np.int32)
    for i in range(nq):
        picks = sorted(rng.choice([j for j in range(nkb) if j not in dead],
                                  size=rng.integers(1, 5), replace=False))
        idx[i, :len(picks)] = picks
    kp, vp = k.copy(), v.copy()
    for j in dead:
        kp[:, :, j * BKV:(j + 1) * BKV] = np.nan
        vp[:, :, j * BKV:(j + 1) * BKV] = np.nan
    mask = np.zeros((S, S), bool)
    for i in range(nq):
        for j in idx[i][idx[i] >= 0]:
            mask[i * BQ:(i + 1) * BQ, j * BKV:(j + 1) * BKV] = True
    ke = np.repeat(k, H // HKV, axis=1)
    ve = np.repeat(v, H // HKV, axis=1)
    lg = np.where(mask, np.einsum("bhqd,bhkd->bhqk", q, ke) / np.sqrt(D),
                  -1e30)
    p = np.exp(lg - lg.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), ve)
    for label in ("con2", "gap4"):
        cfg = JCfg.parse(label)
        o, _, _ = tref.flash_sparse(*_t(q, kp, vp), idx, degree=cfg.degree,
                                    gapped=cfg.kind == "gapped", bq=BQ,
                                    bkv=BKV, causal=False)
        assert torch.isfinite(o).all()
        np.testing.assert_allclose(o.numpy(), want, **O_TOL)


def test_flash_sparse_refuses_a_degree_that_does_not_divide_max_live():
    q, k, v = _t(*_operands())
    idx = TSA.build_block_index(S, S, BQ, BKV, window=64)
    with pytest.raises(ValueError, match="not tileable by degree"):
        TSA.flash_sparse_fwd(q, k, v, idx, "con3", bq=BQ, bkv=BKV, window=64)


# -- gradients ----------------------------------------------------------------

@pytest.mark.parametrize("pat", ("window", "window+gstride"))
def test_gradients_match_reference_oracle(pat):
    """The port's autograd Function (dense dQ / dK/dV plain versions on the
    sparse forward's residuals; the oracle's gradient for a global stride)
    against ``jax.vjp`` of the reference's dense-mask oracle."""
    q, k, v = _operands(4, s=128)
    rng = np.random.default_rng(5)
    g = rng.normal(size=q.shape).astype(np.float32)
    kw = PATTERNS[pat]
    _, vjp = jax.vjp(lambda *a: JSA.ref_sparse_attention(*a, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = tops.flash_attention_sparse(tq, tk, tv, "con2", bq=BQ, bkv=BKV,
                                    bwd_cfg="base", **kw)
    o.backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **G_TOL)


# -- the layer dispatch -------------------------------------------------------

def _bshd(seed=6, s=128, d=64):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(1, s, n, d)) * 0.5).astype(np.float32)
            for n in (H, HKV, HKV)]


@pytest.fixture
def sparse_calls(monkeypatch):
    """Record every call of the port's `ops.flash_attention_sparse`."""
    calls = []
    real = tops.flash_attention_sparse

    def spy(*a, **kw):
        calls.append(kw.get("backend", "cuda"))
        return real(*a, **kw)

    monkeypatch.setattr(tops, "flash_attention_sparse", spy)
    return calls


@pytest.mark.parametrize("case", ("sparse", "off", "con3", "gstride"))
def test_layer_dispatch(case, sparse_calls):
    """``sparse="auto"`` takes the sparse kernel's path; ``"off"`` and a
    degree not dividing max_live (3 of 8) take the dense kernel's; a
    global stride takes the sparse kernel with the strided columns.  Each
    equals the reference's plain path."""
    q, k, v = _bshd()
    kw = dict(causal=True, window=32, bq=64, bkv=64, pos_trivial=True)
    gs = 48 if case == "gstride" else None
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), backend="ref",
                              global_stride=gs, **kw)
    before = TL.sparse_plain_routes
    got = TL.flash_attention(
        *_t(q, k, v), backend="cuda", global_stride=gs,
        sparse="off" if case == "off" else "auto",
        sparse_cfg="con3" if case == "con3" else "auto", cfg="base",
        bwd_cfg="base", **kw)
    assert sparse_calls == ([] if case in ("off", "con3") else ["cuda"])
    assert TL.sparse_plain_routes == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)


def test_layer_global_stride_branch_takes_the_oracle(sparse_calls):
    """Off the sparse branch (the plain backend), a global stride takes
    the dense-mask oracle, as the reference, since no other path holds
    the strided columns."""
    q, k, v = _bshd(7)
    kw = dict(causal=True, window=32, global_stride=48, pos_trivial=True)
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), backend="ref",
                              **kw)
    got = TL.flash_attention(*_t(q, k, v), backend="ref", **kw)
    assert sparse_calls == ["ref"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)


def test_layer_unheld_geometry(sparse_calls):
    """Head dim 96 (no kernel holds it): the dense-mask oracle on CPU
    tensors, counted; NotImplementedError on a device tensor, uncounted."""
    q, k, v = _bshd(8, d=96)
    kw = dict(causal=True, window=32, bq=64, bkv=64, pos_trivial=True,
              backend="cuda")
    before = TL.sparse_plain_routes
    got = TL.flash_attention(*_t(q, k, v), **kw)
    assert TL.sparse_plain_routes - before == 1
    assert sparse_calls == ["ref"]
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              window=32, backend="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)
    meta = [torch.empty(x.shape, device="meta") for x in (q, k, v)]
    with pytest.raises(NotImplementedError, match="does not hold"):
        TL.flash_attention(*meta, **kw)
    assert TL.sparse_plain_routes - before == 1


# -- a reduced gemma3-1b train step -------------------------------------------

GEMMA = dict(compute_dtype="float32", head_dim=64, window=64, attn_bq=64,
             attn_bkv=64, attn_cfg="base", attn_bwd_cfg="base")


@pytest.mark.parametrize("sparse", ("auto", "off"))
def test_reduced_gemma3_train_step_matches_reference(sparse, monkeypatch):
    """Loss and every gradient of the port's step (its flash branch:
    sparse on the 10 local layers, or the dense kernels) against the
    reference's plain attention, float32, batch 2 x 256 tokens."""
    jcfg = dataclasses.replace(get_config("gemma3-1b").reduced(), **GEMMA)
    tcfg = dataclasses.replace(t_get_config("gemma3-1b").reduced(),
                               attn_backend="cuda", attn_sparse=sparse,
                               **GEMMA)
    jparams = jax.tree.map(np.asarray, JM.lm_init(jax.random.PRNGKey(0),
                                                  jcfg))
    rng = np.random.default_rng(9)
    batch = {n: rng.integers(0, jcfg.vocab, (2, 256), dtype=np.int32)
             for n in ("tokens", "labels")}
    jloss, jgrads, _ = j_accumulate(lambda p, b: JM.lm_loss(p, b, jcfg),
                                    jparams, batch, 1)
    walks = []
    real = tref.flash_sparse
    monkeypatch.setattr(tref, "flash_sparse",
                        lambda *a, **kw: walks.append(1) or real(*a, **kw))
    tparams = params_from_numpy(jparams, tcfg, "cpu", torch.float32)
    for p in leaves(tparams):
        p.requires_grad_(True)
    tloss, tgrads, _ = accumulate_grads(
        lambda p, b: TM.lm_loss(p, b, tcfg), tparams,
        {n: torch.from_numpy(a.astype(np.int64)) for n, a in batch.items()},
        1)
    n_local = sum(k == "L" for k in tcfg.layer_kinds())
    assert len(walks) == (n_local if sparse == "auto" else 0)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    want = params_from_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu",
                             torch.float32)
    assert len(leaves(tgrads)) == len(leaves(want))
    for g, w in zip(leaves(tgrads), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **G_TOL)
