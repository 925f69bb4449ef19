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
from repro_torch.core.coarsening import BASE
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


# -- the port's kernel-eligibility rules (geometries its kernels do not hold
#    go to the plain path on CPU tensors, counted, and raise on the card;
#    the reference's Pallas kernels take them)

# arch: (flash fwd/bwd at the config's blocks, paged decode at page 16 (the
# rows kernel at T = 1), verify at T = 5 (--spec-k 4), contiguous decode
# at the config's bkv)
ROUTES = {
    "qwen3-0.6b": (True, True, True, True),
    "qwen2-moe-a2.7b": (True, True, True, True),
    "olmoe-1b-7b": (True, True, True, True),
    "qwen1.5-4b": (True, True, True, True),
    "seamless-m4t-large-v2": (True, True, True, True),
    "gemma3-1b": (True, True, True, True),
    "recurrentgemma-2b": (True, True, True, True),      # paged G 10
    "yi-34b": (True, True, True, True),                 # T*G = 35
    "qwen2-vl-7b": (True, True, True, True),            # T*G = 35
}


@pytest.mark.parametrize("arch", sorted(ROUTES))
def test_kernel_routes_of_the_shipped_configs(arch):
    """Which kernel each shipped config's attention geometry reaches on
    the card; qwen3-0.6b and qwen2-moe-a2.7b (the served paths of
    `chip_smoke.py`) reach every one."""
    c = t_get_config(arch)
    g = (c.n_heads, c.n_kv_heads, c.hd)
    for elem in (2, 1):                       # bf16 and int8 caches
        got = (TL.flash_kernel_takes(c.hd, c.attn_bq, c.attn_bkv, BASE,
                                     BASE),
               TL.rows_kernel_takes(1, *g, 16, elem),
               TL.rows_kernel_takes(5, *g, 16, elem),
               TL.rows_kernel_takes(1, *g, c.decode_bkv, elem))
        assert got == ROUTES[arch]


def _pools(rng, b, h, hkv, d, ps=4, npp=4):
    n_pages = b * npp + 1
    q = torch.from_numpy(_rand(rng, b, 1, h, d))
    kp = torch.from_numpy(_rand(rng, n_pages, ps, hkv, d))
    vp = torch.from_numpy(_rand(rng, n_pages, ps, hkv, d))
    bt = torch.from_numpy(rng.permutation(np.arange(1, n_pages))
                          .reshape(b, npp).astype(np.int32))
    pos = torch.from_numpy(rng.integers(1, npp * ps, b).astype(np.int32))
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("h,hkv,plain", [(72, 1, True), (10, 1, False),
                                          (4, 2, False)])
def test_paged_decode_route_beyond_the_kernel(h, hkv, plain):
    """G > 64 takes the plain path under the kernel backend, counted; G 10
    (recurrentgemma-2b's, held since paged decode runs the rows kernel at
    T = 1) and G 2 take the kernel's wrapper."""
    q, kp, vp, bt, pos = _pools(np.random.default_rng(1), 2, h, hkv, 32)
    before = TL.paged_plain_routes
    got = TL.paged_decode_attention(q, kp, vp, bt, pos, backend="cuda")
    assert TL.paged_plain_routes - before == int(plain)
    want = TL.paged_decode_attention(q, kp, vp, bt, pos, backend="ref")
    if plain:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("h,hkv,plain", [(26, 2, True), (14, 2, False),
                                          (4, 2, False)])
def test_verify_route_beyond_the_kernel(h, hkv, plain):
    """T*G > 64 query rows a kv head (5 * 13) takes the plain path under
    the kernel backend, counted; yi-34b's 5 * 7 at --spec-k 4 and 5 * 2
    take the kernel's wrapper."""
    rng = np.random.default_rng(2)
    _, kp, vp, bt, pos = _pools(rng, 2, h, hkv, 32)
    q = torch.from_numpy(_rand(rng, 2, 5, h, 32))
    pos0 = pos.clamp(max=8)
    before = TL.verify_plain_routes
    got = TL.verify_attention(q, kp, vp, bt, pos0, backend="cuda")
    assert TL.verify_plain_routes - before == int(plain)
    want = TL.verify_attention(q, kp, vp, bt, pos0, backend="ref")
    if plain:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("d,plain", [(96, True), (64, False)])
def test_flash_route_beyond_the_kernel(d, plain):
    """Head dim 96 (no kernel holds it) takes `mea_attention` under the
    kernel backend, counted; head dim 64 takes the kernel's wrapper."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_rand(rng, 1, 128, 2, d))
    k = torch.from_numpy(_rand(rng, 1, 128, 1, d))
    v = torch.from_numpy(_rand(rng, 1, 128, 1, d))
    before = TL.flash_plain_routes
    got = TL.flash_attention(q, k, v, pos_trivial=True, backend="cuda",
                             sparse="off")
    assert TL.flash_plain_routes - before == int(plain)
    want = TL.mea_attention(q, k, v, causal=True)
    if plain:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, **TOL)


def test_contiguous_decode_route_beyond_the_kernel():
    """G > 64 query rows a kv head takes the dense path, counted."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_rand(rng, 2, 1, 72, 32))
    kc = torch.from_numpy(_rand(rng, 2, 16, 1, 32))
    vc = torch.from_numpy(_rand(rng, 2, 16, 1, 32))
    pos = torch.tensor([3, 15], dtype=torch.int32)
    before = TL.decode_plain_routes
    got = TL.decode_attention(q, kc, vc, pos, backend="cuda", bkv=8)
    assert TL.decode_plain_routes - before == 1
    torch.testing.assert_close(
        got, TL.decode_attention(q, kc, vc, pos, backend="ref"), rtol=0,
        atol=0)


def _unheld(route):
    """A dispatch of `route` at a geometry the port's kernel does not hold,
    on tensors of no CPU device (``meta``: shapes without data)."""
    m = dict(device="meta")
    if route == "flash":
        q = torch.empty(1, 128, 2, 96, **m)
        k = torch.empty(1, 128, 1, 96, **m)
        return lambda: TL.flash_attention(q, k, k, pos_trivial=True,
                                          backend="cuda", sparse="off")
    if route == "decode":
        q, kc = torch.empty(2, 1, 72, 32, **m), torch.empty(2, 16, 1, 32, **m)
        pos = torch.empty(2, dtype=torch.int32, **m)
        return lambda: TL.decode_attention(q, kc, kc, pos, backend="cuda",
                                           bkv=8)
    t, h = (1, 72) if route == "paged" else (5, 26)
    q = torch.empty(2, t, h, 32, **m)
    kp = torch.empty(9, 4, h // 13 if route == "verify" else 1, 32, **m)
    bt = torch.empty(2, 4, dtype=torch.int32, **m)
    pos = torch.empty(2, dtype=torch.int32, **m)
    fn = TL.paged_decode_attention if route == "paged" else \
        TL.verify_attention
    return lambda: fn(q, kp, kp, bt, pos, backend="cuda")


@pytest.mark.parametrize("route", ["flash", "decode", "paged", "verify"])
def test_unheld_geometry_raises_off_the_cpu(route):
    """Off the CPU a geometry the port's kernel does not hold raises
    NotImplementedError naming it, uncounted: the plain path never stands
    in for a kernel on the card."""
    before = getattr(TL, f"{route}_plain_routes")
    with pytest.raises(NotImplementedError, match="does not hold"):
        _unheld(route)()
    assert getattr(TL, f"{route}_plain_routes") == before


def test_step_norm_takes_the_row_kernel_wrapper():
    """On a decode or verify step under a kernel backend the norm takes
    the row kernel's wrapper, whose CPU path is the plain norm bit for bit
    (counted as no launch); the plain backend keeps the torch norm."""
    from repro_torch.kernels import rmsnorm as t_norm
    rng = np.random.default_rng(7)
    p = {"scale": torch.from_numpy(rng.normal(size=64).astype(np.float32))}
    x = torch.from_numpy(_rand(rng, 3, 5, 64)).bfloat16()
    before = t_norm.launches
    got = TL.rmsnorm(p, x, 1e-6, kernel=True)
    want = TL.rmsnorm(p, x, 1e-6)
    assert t_norm.launches == before
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(ValueError, match="scale"):
        t_norm.rmsnorm(x, p["scale"][:32])
