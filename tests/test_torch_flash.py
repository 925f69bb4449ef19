"""The port's flash attention against the reference's Pallas kernels.

* The plain versions (`repro_torch.kernels.ref.flash_*`, what the port's
  wrappers compute on CPU tensors and what the card check holds each CUDA
  kernel against) against `repro/kernels/flash_attention.py`'s three
  kernels in interpret mode: forward (o, m, l), dQ, and dK/dV after the
  GQA reduction.
* Gradients through the port's `ops.flash_attention` (a
  `torch.autograd.Function`) against ``jax.grad`` through the reference's
  custom VJP, with the loss ``sum(sin(o))`` of the reference's own test.
* The layer dispatch `models.layers.flash_attention`: the kernel branch,
  the `mea_attention` fallbacks, and the block-sparse and global-stride
  branches (held against the reference in `tests/test_torch_sparse.py`).
* The gradient-less kernel wrappers refuse to run under autograd.

Inputs are float32, made with numpy from a seed, at the sizes of
`tests/test_flash_attention_grad.py` (B 1, H 4, Hkv 2, S 128, D 16,
bq = bkv = 32).  Coarsening labels are explicit (never "auto").
Tolerances: atol 1e-5 for o and m (float32 summation order); rtol 1e-5
for the row sums l (sums of up to S terms near 1, so ~1e2: an absolute
1e-5 is below float32 resolution there); rtol 1e-3 and atol 1e-4 for
gradients, the reference test's own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coarsening import CoarseningConfig as JCfg
from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL

B, H, HKV, S, D = 1, 4, 2, 128, 16
BQ = BKV = 32
O_TOL = dict(rtol=0, atol=1e-5)
L_TOL = dict(rtol=1e-5, atol=1e-5)
G_TOL = dict(rtol=1e-3, atol=1e-4)
# (causal, window, Sk): causal, a sliding window, non-causal cross attention
MASKS = {"causal": (True, None, S), "window48": (True, 48, S),
         "cross": (False, None, 2 * S)}


def _operands(seed=0, sk=S, hkv=HKV):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, S, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, hkv, sk, D)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, hkv, sk, D)).astype(np.float32)
    do = rng.normal(size=(B, H, S, D)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("label", ["base", "con2", "gap2", "con4"])
def test_plain_versions_match_pallas_kernels(label, mask):
    causal, window, sk = MASKS[mask]
    q, k, v, do = _operands(sk=sk)
    jc = JCfg.parse(label)
    geo = dict(bq=BQ, bkv=BKV, causal=causal, window=window, sk=sk)
    o, m, l = jflash.make_kernel(B, H, HKV, S, D, jc, return_residuals=True,
                                 **geo)(q, k, v)
    delta = np.sum(do * np.asarray(o), axis=-1)
    args = (q, k, v, do, np.asarray(m), np.asarray(l), delta)
    dq = jflash.make_bwd_dq_kernel(B, H, HKV, S, D, jc, **geo)(*args)
    dk, dv = jflash.make_bwd_dkv_kernel(B, H, HKV, S, D, jc, **geo)(*args)

    kw = dict(degree=jc.degree, gapped=jc.kind == "gapped", bq=BQ, bkv=BKV,
              causal=causal, window=window)
    tq, tk, tv, tdo = _t(q, k, v, do)
    to, tm, tl = tref.flash_forward(tq, tk, tv, residuals=True, **kw)
    for got, want in ((to, o), (tm, m)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(l), **L_TOL)
    targs = (tq, tk, tv, tdo, *_t(np.asarray(m), np.asarray(l), delta))
    tdq = tref.flash_bwd_dq(*targs, **kw)
    tdk, tdv = tref.flash_bwd_dkv(*targs, **kw)
    for got, want in ((tdq, dq), (tdk, dk), (tdv, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **G_TOL)


def test_plain_versions_raise_on_untileable_geometry():
    tq, tk, tv, _ = _t(*_operands())
    with pytest.raises(ValueError, match="not tileable"):
        tref.flash_forward(tq, tk, tv, degree=8, bq=BQ, bkv=BKV)
    with pytest.raises(ValueError, match="sq == sk"):
        tref.flash_forward(tq, tk[:, :, :64], tv[:, :, :64], bq=BQ, bkv=BKV)


@pytest.mark.parametrize("cfg,bwd,mask", [
    ("base", "base", "causal"), ("con2", "gap2", "causal"),
    ("gap2", "con4", "window48"), ("con4", "con2", "cross")])
def test_autograd_function_matches_reference_vjp(cfg, bwd, mask):
    causal, window, sk = MASKS[mask]
    q, k, v, _ = _operands(seed=1, sk=sk)

    def loss(a, b, c):
        return jnp.sum(jnp.sin(jops.flash_attention(
            a, b, c, JCfg.parse(cfg), bwd_cfg=JCfg.parse(bwd), bq=BQ,
            bkv=BKV, causal=causal, window=window)))

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = tops.flash_attention(tq, tk, tv, cfg, bwd_cfg=bwd, bq=BQ, bkv=BKV,
                             causal=causal, window=window)
    assert o.dtype == torch.float32 and o.shape == (B, H, S, D)
    torch.sin(o).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **G_TOL)


def test_forward_without_grad_needs_no_residuals(monkeypatch):
    """With grad off the op runs the residual-free forward, once."""
    calls = []
    real = tflash.flash_forward

    def spy(*a, **kw):
        calls.append(kw.get("residuals", False))
        return real(*a, **kw)

    monkeypatch.setattr(tflash, "flash_forward", spy)
    tq, tk, tv, _ = _t(*_operands())
    with torch.no_grad():
        tops.flash_attention(tq.requires_grad_(), tk, tv, bq=BQ, bkv=BKV)
    tops.flash_attention(tq, tk, tv, bq=BQ, bkv=BKV)
    assert calls == [False, True]


def _bshd(seed=2, s=64, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or s
    q = (rng.normal(size=(2, s, H, D)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(2, sk, HKV, D)) * 0.5).astype(np.float32)
    v = rng.normal(size=(2, sk, HKV, D)).astype(np.float32)
    return q, k, v


def test_layer_dispatch_takes_the_kernel():
    """backend="cuda" on CPU tensors takes the plain flash versions and
    matches the reference layer's Pallas branch, values and gradients."""
    q, k, v = _bshd()

    def jloss(a, b, c):
        return jnp.sum(jnp.sin(JL.flash_attention(
            a, b, c, causal=True, pos_trivial=True, backend="pallas",
            cfg=JCfg.parse("con2"), bwd_cfg=JCfg.parse("gap2"), bq=BQ,
            bkv=BKV)))

    want, wgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    launches = tflash.fwd_launches
    o = TL.flash_attention(tq, tk, tv, causal=True, pos_trivial=True,
                           backend="cuda", cfg="con2", bwd_cfg="gap2",
                           bq=BQ, bkv=BKV)
    assert tflash.fwd_launches == launches        # CPU: no kernel launch
    got = torch.sin(o).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in zip((tq.grad, tk.grad, tv.grad), wgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **G_TOL)


@pytest.mark.parametrize("case", ["q_pos", "k_len", "ragged", "cross"])
def test_layer_dispatch_fallbacks_match_reference(case):
    """Ineligible geometries take `mea_attention` in both packages:
    explicit positions (no ``pos_trivial``), a valid length ``k_len``, a
    sequence that does not tile by the block, and non-causal cross
    attention (eligible: the kernel branch in both)."""
    s = 48 if case == "ragged" else 64
    q, k, v = _bshd(seed=3, s=s, sk=96 if case == "cross" else None)
    kw = dict(causal=case != "cross", bq=BQ, bkv=BKV)
    jkw, tkw = dict(kw), dict(kw)
    if case == "q_pos":
        pos = np.tile(np.arange(s, dtype=np.int32)[None] + 5, (2, 1))
        jkw["q_pos"], tkw["q_pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    elif case == "k_len":
        jkw["k_len"] = tkw["k_len"] = 40
    else:
        jkw["pos_trivial"] = tkw["pos_trivial"] = True
    want = JL.flash_attention(q, k, v, backend="pallas", cfg=JCfg.parse("base"),
                              bwd_cfg=JCfg.parse("base"), **jkw)
    got = TL.flash_attention(*_t(q, k, v), backend="cuda", cfg="base",
                             bwd_cfg="base", **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if case != "cross":
        ref = JL.mea_attention(q, k, v, causal=True, q_pos=jkw.get("q_pos"),
                               k_len=jkw.get("k_len"))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_unported_branches_raise():
    """The block-sparse and global-stride branches, once unported (they
    raised), now answer as the reference's plain path does; sparse="off"
    pins the dense kernel for a window, as the reference."""
    q, k, v = _t(*_bshd())
    want = TL.mea_attention(q, k, v, causal=True, window=16)
    o = TL.flash_attention(q, k, v, causal=True, window=16,
                           pos_trivial=True, backend="cuda", bq=BQ, bkv=BKV)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    want_gs = JL.flash_attention(jq, jk, jv, causal=True, window=16,
                                 global_stride=8, pos_trivial=True,
                                 backend="ref")
    o = TL.flash_attention(q, k, v, causal=True, window=16, global_stride=8,
                           pos_trivial=True, backend="ref")
    np.testing.assert_allclose(o.numpy(), np.asarray(want_gs), rtol=1e-5,
                               atol=1e-5)
    o = TL.flash_attention(q, k, v, causal=True, window=16,
                           pos_trivial=True, backend="cuda", sparse="off",
                           cfg="base", bwd_cfg="base", bq=BQ, bkv=BKV)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_without_backward_refuse_autograd():
    a = torch.randn(128, 256, requires_grad=True)
    b = torch.randn(256, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.matmul(a, b)
    with torch.no_grad():
        assert tops.matmul(a, b).shape == (128, 64)
    q = torch.randn(2, 1, 4, 16, requires_grad=True)
    pool = torch.randn(5, 8, 2, 16)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.paged_decode_attention(q, pool, pool, table, pos)
    with torch.no_grad():
        out = tops.paged_decode_attention(q, pool, pool, table, pos)
    assert out.shape == q.shape
