"""The port's layers against `repro.models.layers` on the same float32
inputs (made with numpy from a seed) and the same parameters.

Tolerance: both sides compute in float32 with the same rounding points, so
results differ only by float32 summation order and transcendental
implementations: rtol = atol = 1e-5 unless a test states otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(tree):
    """numpy copy of a JAX tree as float32 torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32, copy=True))


def _np(x):
    return np.asarray(x, np.float32)


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64, scale=3.0)
    p = {"scale": _rand(rng, 64, scale=0.1)}
    want = JL.rmsnorm({"scale": jnp.asarray(p["scale"])},
                      jnp.asarray(x, dtype), 1e-6)
    got = TL.rmsnorm(_t(p), torch.from_numpy(x).to(getattr(torch, dtype)),
                     1e-6)
    # bf16: one output rounding on each side (2^-8 relative)
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 6, 3, 32)
    pos = rng.integers(0, 64, size=(2, 6)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # angles up to 63 rad: f32 sin/cos of the two libraries differ by a few
    # ulps of the angle, ~1e-5 absolute
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=3e-5)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-4b", "yi-34b"])
def test_qkv_project(arch):
    """qk-norm (qwen3), qkv bias (qwen1.5) and GQA (qwen3, yi)."""
    jcfg = get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    p = JL.attn_init(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(2)
    if jcfg.qkv_bias:                  # the init zeroes biases: exercise them
        p = {**p, **{n: jnp.asarray(_rand(rng, p[n].shape[0], scale=0.1))
                     for n in ("bq", "bk", "bv")}}
    if jcfg.qk_norm:
        p = {**p, "qnorm": {"scale": jnp.asarray(_rand(rng, jcfg.hd,
                                                       scale=0.1))}}
    x = _rand(rng, 2, 5, jcfg.d_model)
    pos = np.tile(np.arange(3, 8, dtype=np.int32), (2, 1))
    want = JL.qkv_project(p, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = TL.qkv_project(_t(p), torch.from_numpy(x), tcfg,
                         torch.from_numpy(pos))
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=3e-5)


@pytest.mark.parametrize("window", [None, 5], ids=["causal", "window"])
@pytest.mark.parametrize("kv_chunk", [512, 8], ids=["one-chunk", "chunked"])
def test_mea_attention_ragged_q_pos(window, kv_chunk):
    """Chunk rows at ragged global positions against a longer padded cache,
    as chunked prefill calls it (GQA, 2 query heads per kv head)."""
    rng = np.random.default_rng(3)
    b, sq, sk, hkv, g, d = 2, 4, 24, 2, 2, 16
    q = _rand(rng, b, sq, hkv * g, d)
    k = _rand(rng, b, sk, hkv, d)
    v = _rand(rng, b, sk, hkv, d)
    q_pos = np.stack([np.arange(5, 5 + sq), np.arange(17, 17 + sq)]
                     ).astype(np.int32)
    want = JL.mea_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window,
                            q_pos=jnp.asarray(q_pos), kv_chunk=kv_chunk)
    got = TL.mea_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window,
                           q_pos=torch.from_numpy(q_pos), kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_decode_attention_plain_path():
    rng = np.random.default_rng(5)
    q = _rand(rng, 2, 1, 4, 16)
    k = _rand(rng, 2, 12, 2, 16)
    v = _rand(rng, 2, 12, 2, 16)
    pos = np.asarray([3, 11], np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), window=6)
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(pos),
                              window=6)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("t_backend", ["ref", "cuda"])
@pytest.mark.parametrize("rows", [128, 6], ids=["tiled", "fallback"])
def test_ffn(t_backend, rows):
    """SwiGLU FFN against the reference's plain path (its ``ref`` backend:
    the ``pallas`` one resolves cfg through the tuner).  On the port, a
    kernel backend with tileable rows takes the matmul wrapper, whose CPU
    path is the same float32 product; d = 256, d_ff = 512 tile."""
    rng = np.random.default_rng(6)
    p = JL.ffn_init(jax.random.PRNGKey(6), 256, 512)
    x = _rand(rng, 2, rows // 2, 256)
    want = JL.ffn(p, jnp.asarray(x, jnp.bfloat16), backend="ref")
    got = TL.ffn({k: v.bfloat16() for k, v in _t(p).items()},
                 torch.from_numpy(x).bfloat16(), backend=t_backend)
    assert got.dtype == torch.bfloat16
    # bf16 activations: each product is rounded to bf16 on both sides, and
    # silu/multiply round again; allow 2 bf16 ulps of the output scale
    w = _np(want)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(w).max())


@pytest.mark.parametrize("label", ["con4", "con4+simd2"])
def test_ffn_kernel_backend_raises_on_a_label_the_kernel_cannot_tile(label):
    """Rows that tile by the reference's rule (T % 128, d % 256, d_ff % 256)
    go to the kernel whatever the label; a label its tiling cannot take at
    T = 128 raises, as the reference's kernel builder does, and never
    falls back to the plain product."""
    p = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in
         (("w1", (256, 512)), ("w3", (256, 512)), ("w2", (512, 256)))}
    x = torch.zeros(2, 64, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not tileable"):
        TL.ffn(p, x, backend="cuda", cfg=label)


def test_unknown_backend_raises():
    """The port names its kernel path "cuda"; anything else but "ref" is a
    configuration error, never a silent fallback."""
    p = {n: torch.zeros(256, 256) for n in ("w1", "w3", "w2")}
    with pytest.raises(ValueError, match="backend"):
        TL.ffn(p, torch.zeros(2, 256), backend="pallas")
