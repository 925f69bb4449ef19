"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the reference, with explicit coarsening labels.

Paged decode: the reference's Pallas paged kernel cannot run in interpret
mode on the installed JAX (it calls ``pl.load``, which JAX 0.9 removed), so
each coarsening label of the port's split-KV version is held against the
reference op through its plain reference (``backend="ref"``, the gather-
to-contiguous oracle its own tests hold the kernel against).  Permuted and
fragmented block tables, GQA, sliding window, and rows past each slot's
``pos`` (page tails and never-referenced pages) poisoned with 1e4, as
`tests/test_paged_attention.py` builds them.  Inputs are float32 on both
sides, so the tolerance is float32 reordering: rtol = atol = 2e-5 (the
reference's own kernel-vs-oracle tolerance).

Matmul: bf16 operands, float32 accumulation on both sides; sums of exact
bf16 products differ only in order, so rtol = 1e-5 of the output scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coarsening import CoarseningConfig as JCfg
from repro.kernels import ops as jops
from repro.kernels.decode_attention import _combine as j_combine
from repro_torch.kernels import decode_attention as t_dec
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

B, HKV, G, D = 2, 2, 2, 16
H = HKV * G
PS, NPP = 8, 8
S = PS * NPP
N_PAGES = B * NPP + 3
DECODE_LABELS = ("base", "con2", "gap2", "con4", "gap4")


def _fragmented(seed=11):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(N_PAGES, PS, HKV, D)).astype(np.float32)
    vp = rng.normal(size=(N_PAGES, PS, HKV, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, N_PAGES))[: B * NPP].reshape(B, NPP)
    pos = np.asarray([PS * 3 + 2, S - 1], np.int32)       # mid-page + full
    for bb in range(B):
        for lp in range(NPP):
            dead = max(0, min(PS, pos[bb] + 1 - lp * PS))
            kp[perm[bb, lp], dead:] = 1e4
            vp[perm[bb, lp], dead:] = 1e4
    unref = sorted(set(range(1, N_PAGES)) - set(perm.ravel()))
    kp[unref] = 1e4
    vp[unref] = 1e4
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    return q, kp, vp, perm.astype(np.int32), pos


@pytest.fixture(scope="module")
def paged():
    return _fragmented()


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


@pytest.mark.parametrize("label", DECODE_LABELS)
@pytest.mark.parametrize("window", [None, 11], ids=["causal", "window"])
def test_paged_decode_matches_reference(paged, label, window):
    (jq, jk, jv, jbt, jpos), (tq, tk, tv, tbt, tpos) = _both(paged)
    want = jops.paged_decode_attention(jq, jk, jv, jbt, jpos,
                                       JCfg.parse(label), backend="ref",
                                       window=window)
    got = tops.paged_decode_attention(tq, tk, tv, tbt, tpos, label,
                                      window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert got.abs().max() < 100, "poisoned row leaked in"


@pytest.mark.parametrize("window", [None, 11], ids=["causal", "window"])
def test_gather_oracle_matches_reference_oracle(paged, window):
    (jq, jk, jv, jbt, jpos), (tq, tk, tv, tbt, tpos) = _both(paged)
    want = jops.paged_decode_attention(jq, jk, jv, jbt, jpos,
                                       backend="ref", window=window)
    got = tref.paged_decode_attention(tq, tk, tv, tbt, tpos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_paged_decode_bf16_matches_reference(paged):
    """bf16 q and pools, as the serving path stores them: both sides read
    the same bf16 values and compute in f32; the bf16 output rounding
    allows one bf16 ulp each side (2^-7 relative)."""
    q, kp, vp, bt, pos = paged
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, kp, vp))
    want = jops.paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                       jnp.asarray(pos), JCfg.parse("con2"),
                                       backend="ref")
    got = tops.paged_decode_attention(tq, tk, tv, torch.from_numpy(bt),
                                      torch.from_numpy(pos), "con2")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_combine_matches_reference():
    """Partials with dead splits (m = -1e30, l = acc = 0) merge exactly."""
    rng = np.random.default_rng(3)
    m = rng.normal(size=(2, 2, 2, 4)).astype(np.float32)
    l = rng.uniform(0.5, 2, size=m.shape).astype(np.float32)
    acc = rng.normal(size=m.shape + (D,)).astype(np.float32)
    m[0, 0, :, 1:] = -1e30
    l[0, 0, :, 1:] = 0.0
    acc[0, 0, :, 1:] = 0.0
    m[1, 1, 1, :] = -1e30                    # a row with no live split
    l[1, 1, 1, :] = 0.0
    acc[1, 1, 1, :] = 0.0
    want = j_combine(jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc))
    got = tref.combine(*(torch.from_numpy(a) for a in (m, l, acc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_paged_decode_rejects_what_the_kernel_does_not_take(paged):
    _, (tq, tk, tv, tbt, tpos) = _both(paged)
    with pytest.raises(ValueError, match="not tileable"):
        tops.paged_decode_attention(tq, tk, tv, tbt[:, :6], tpos, "con4")
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tops.paged_decode_attention(tq, tk, tv, tbt, tpos,
                                    k_scale=tk[:, :, :, 0],
                                    v_scale=tv[:, :, 0])  # not (P, ps, Hkv)
    with pytest.raises(ValueError, match="shapes"):
        tops.paged_decode_attention(tq, tk, tv, tbt, tpos[:1])
    with pytest.raises(ValueError, match="divisible"):
        tops.paged_decode_attention(tq[:, :, :3], tk, tv, tbt, tpos)


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    return a, b


# (label, (m, k, n)): every label both the Pallas kernel (blocks 128 x
# 128*vector_width x 256) and the port's `tileable` take
MATMUL_CASES = ([(label, (256, 512, 256))
                 for label in ("base", "con2", "gap2", "simd2")]
                + [(label, (512, 512, 512))
                   for label in ("con4", "gap4", "simd4", "con2+simd2",
                                 "gap2+simd2")])


@pytest.mark.parametrize("label,shape", [pytest.param(label, shape, id=label)
                                         for label, shape in MATMUL_CASES])
def test_matmul_matches_pallas_kernel(label, shape):
    m, k, n = shape
    assert t_mm.tileable(m, n, k, t_mm.resolve(label))
    a, b = _operands(m, k, n)
    want = jops.matmul(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16), JCfg.parse(label))
    got = tops.matmul(torch.from_numpy(a).bfloat16(),
                      torch.from_numpy(b).bfloat16(), label)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_matmul_rejects_untileable_shapes():
    a = torch.zeros(96, 64, dtype=torch.bfloat16)
    b = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not tileable"):
        tops.matmul(a, b, "base")                 # 96 % 64
    a = torch.zeros(128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not tileable"):
        tops.matmul(a, b, "con4")                 # 128 % 256
    with pytest.raises(ValueError, match="not tileable"):
        tops.matmul(torch.zeros(256, 64, dtype=torch.bfloat16),
                    torch.zeros(64, 256, dtype=torch.bfloat16),
                    "con4+simd2")                 # over the register budget
    assert t_mm.tileable(128, 3072, 1024, JCfg())


def test_cpu_wrappers_count_no_launches(paged):
    """Launch counters move only where a CUDA kernel launches."""
    from repro_torch.kernels import moe_ffn as t_moe
    from repro_torch.quant import quantize

    def counts():
        return (t_dec.launches, t_dec.int8_launches, t_mm.launches,
                t_mm.q_launches, t_moe.launches, t_moe.q_launches)

    _, (tq, tk, tv, tbt, tpos) = _both(paged)
    before = counts()
    tops.paged_decode_attention(tq, tk, tv, tbt, tpos)
    tops.paged_decode_attention(tq, tk, tv, tbt, tpos,
                                k_scale=tk[..., 0], v_scale=tv[..., 0])
    tops.matmul(torch.zeros(128, 64, dtype=torch.bfloat16),
                torch.zeros(64, 64, dtype=torch.bfloat16))
    tops.quant_matmul(torch.zeros(128, 256, dtype=torch.bfloat16),
                      quantize(torch.ones(256, 128), "int8"))
    xe, w = torch.zeros(4, 8, 64), torch.ones(4, 64, 64)
    tops.moe_ffn(xe, w, w, w, torch.zeros(4, 8))
    q = quantize(w, "int4")
    tops.quant_moe_ffn(xe, q, q, q, torch.zeros(4, 8))
    assert counts() == before
