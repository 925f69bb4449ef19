"""The port's quantization against the reference's: `repro_torch.quant`
against `repro.quant` bit for bit, the dequant-fused matmul's plain version
against the Pallas `make_qkernel` in interpret mode, the quantized FFN
against `repro.models.layers.ffn`, and the int8-pool paged decode's plain
version against the reference's plain path with scales.

Inputs are made with numpy from fixed seeds and handed to both sides.
"""
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
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
from repro_torch.models.interop import params_from_numpy
from repro_torch.quant import qtypes as TQ

# shapes: a plain (K, N) weight, a stacked expert weight, and a contraction
# axis of 16 (one int4 group of 16)
SHAPES = [(64, 48), (3, 64, 32), (16, 24)]


def _weight(shape, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    # values on a rounding boundary of the first scale: w / scale = k + 1/2
    w[..., 1, 0] = 0.5 * w[..., 0, 0]
    w[..., 2, 1] = 0.0
    return w


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_is_bit_exact(mode, shape):
    """Payload, scales and the dequantized values equal the reference's
    bit for bit (division by the scale, round half to even)."""
    w = _weight(shape)
    group = 16
    want = JQ.quantize(jnp.asarray(w), mode, group=group)
    got = TQ.quantize(torch.from_numpy(w), mode, group=group)
    assert (got.bits, got.group, got.shape) == (want.bits, want.group,
                                                want.shape)
    assert got.q.dtype == (torch.int8 if mode == "int8" else torch.uint8)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(TQ.dequantize(got).numpy(),
                                  np.asarray(JQ.dequantize(want)))
    assert got.nbytes == want.nbytes


def test_int4_nibble_order_and_round_trip():
    """Even rows in the low nibble, offset-binary q + 8, as the reference;
    unpack inverts pack along either axis."""
    rng = np.random.default_rng(1)
    q = rng.integers(-7, 8, size=(6, 5)).astype(np.int8)
    got = TQ.pack_int4(torch.from_numpy(q), axis=0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.pack_int4(jnp.asarray(q), axis=0)))
    assert got[0, 0].item() == (q[0, 0] + 8) | ((q[1, 0] + 8) << 4)
    for axis in (0, 1):
        qa = q if axis == 0 else q[:, :4]
        packed = TQ.pack_int4(torch.from_numpy(qa), axis=axis)
        np.testing.assert_array_equal(
            TQ.unpack_int4(packed, axis=axis).numpy(), qa.astype(np.float32))
    with pytest.raises(ValueError, match="even"):
        TQ.pack_int4(torch.zeros(3, 2, dtype=torch.int8), axis=0)


def test_quantize_kv_is_bit_exact():
    x = _weight((5, 3, 16), seed=2)
    x[0, 0] = 0.0                                   # an all-zero row
    jq, js = JQ.quantize_kv(jnp.asarray(x))
    tq, ts = TQ.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.dequantize_kv(tq, ts).numpy(),
        np.asarray(JQ.dequantize_kv(jq, js)))


def test_int4_rejects_bad_groups_like_the_reference():
    w = torch.zeros(48, 8)
    with pytest.raises(ValueError, match="divisible"):
        TQ.quantize_int4(w, group=32)
    with pytest.raises(ValueError, match="even"):
        TQ.quantize_int4(w, group=3)
    with pytest.raises(ValueError, match="mode"):
        TQ.quantize(w, "int2")


@pytest.fixture(scope="module")
def moe_params():
    cfg = j_get_config("qwen2-moe-a2.7b").reduced()
    return cfg, jax.tree.map(np.asarray,
                             JM.lm_init(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_matches_reference(moe_params, mode):
    """Same bytes before and after, the same leaves quantized (the reference
    counts one stacked leaf per pattern position, the port one per layer),
    and every layer's payload equal to the reference's slice of it."""
    jcfg, jparams = moe_params
    tparams = params_from_numpy(jparams, get_config(
        "qwen2-moe-a2.7b").reduced(), "cpu", torch.float32)
    jq, jrep = JQ.quantize_params(jax.tree.map(jnp.asarray, jparams), mode)
    tq, trep = TQ.quantize_params(tparams, mode)
    n = jcfg.n_layers
    assert trep["quantized"] == n * jrep["quantized"]
    assert trep["skipped"] == n * jrep["skipped"]
    assert (trep["bytes_before"], trep["bytes_after"]) \
        == (jrep["bytes_before"], jrep["bytes_after"])
    jblk = jq["blocks"][0]
    for i, layer in enumerate(tq["layers"]):
        for path in (("attn", "wq"), ("attn", "wo"), ("moe", "w1"),
                     ("moe", "w2"), ("moe", "shared", "w3")):
            got, want = layer, jblk
            for key in path:
                got, want = got[key], want[key]
            np.testing.assert_array_equal(got.q.numpy(),
                                          np.asarray(want.q)[i])
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(want.scale)[i])
        assert not isinstance(layer["moe"]["router"], TQ.QTensor)
        assert not isinstance(layer["moe"]["shared_gate"], TQ.QTensor)
    assert TQ.tree_nbytes(tq) < TQ.tree_nbytes(tparams)


# -- the dequant-fused matmul (`repro/kernels/matmul.py:87`) --------------------

@pytest.mark.parametrize("label", ["base", "con2", "gap2"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_matmul_matches_pallas_kernel(mode, label):
    """Plain version against the Pallas qkernel (interpret mode) with the
    reference's default blocks: both take a in f32 against the dequantized
    f32 weight and sum in f32, so they differ in summation order only:
    |diff| <= k * 2^-24 * (|a| @ |w|)."""
    m, k, n = 256, 512, 256
    rng = np.random.default_rng(3)
    a = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    jqw = JQ.quantize(jnp.asarray(w), mode)
    tqw = TQ.quantize(torch.from_numpy(w), mode)
    ja = jnp.asarray(a, jnp.bfloat16)
    ta = torch.from_numpy(a).bfloat16()
    want = np.asarray(jops.quant_matmul(ja, jqw, JCfg.parse(label)))
    got = tops.quant_matmul(ta, tqw, label)
    assert got.dtype == torch.float32
    mag = ta.float().abs() @ TQ.dequantize(tqw).abs()
    tol = k * 2.0 ** -24 * mag.numpy()
    assert (np.abs(got.numpy() - want) <= tol).all()


def test_quant_matmul_rejects_what_the_reference_rejects():
    qw = TQ.quantize(torch.zeros(256, 128), "int4", group=32)
    a = torch.zeros(128, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not tileable"):
        tops.quant_matmul(a, qw, "con2")            # 128 % 256
    with pytest.raises(ValueError, match="not tileable"):
        tops.quant_matmul(a[:, :128], TQ.quantize(torch.zeros(128, 128),
                                                  "int8"))   # k % 256
    bad = TQ.quantize(torch.zeros(768, 128), "int4", group=6)
    with pytest.raises(ValueError, match="group"):
        tops.quant_matmul(torch.zeros(128, 768, dtype=torch.bfloat16),
                          bad)                      # 256 % 6
    with pytest.raises(ValueError, match="qw"):
        tops.quant_matmul(a[:, :64], qw)


# -- the quantized FFN (`repro/models/layers.py:631-661`) ------------------------

@pytest.mark.parametrize("rows", [128, 8], ids=["kernel", "fallback"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_ffn_matches_reference(mode, rows):
    """T = 128 rows take the dequant-fused matmul on both sides (the
    reference's Pallas kernel in interpret mode, the port's plain version);
    T = 8 takes the dense-dequant fallback on both.  bf16 activations: the
    products round to bf16 at the same points, so 2 bf16 ulps of the
    largest output."""
    d, d_ff = 256, 512
    rng = np.random.default_rng(4)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    ws = {"w1": rng.normal(size=(d, d_ff)) / np.sqrt(d),
          "w3": rng.normal(size=(d, d_ff)) / np.sqrt(d),
          "w2": rng.normal(size=(d_ff, d)) / np.sqrt(d_ff)}
    jp = {n: JQ.quantize(jnp.asarray(w, jnp.float32), mode)
          for n, w in ws.items()}
    tp = {n: TQ.quantize(torch.from_numpy(w.astype(np.float32)), mode)
          for n, w in ws.items()}
    want = JL.ffn(jp, jnp.asarray(x, jnp.bfloat16), backend="pallas",
                  cfg=JCfg())
    got = TL.ffn(tp, torch.from_numpy(x).bfloat16(), backend="cuda",
                 cfg="base")
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2.0 ** -8 * np.abs(want).max())


# -- int8 paged decode (`repro/kernels/decode_attention.py:208`, kv_bits=8) -------

def _int8_pools(seed=5):
    b, hkv, g, d, ps, npp = 2, 2, 2, 16, 8, 8
    n_pages = b * npp + 3
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)
    kq, ks = JQ.quantize_kv(jnp.asarray(k))
    vq, vs = JQ.quantize_kv(jnp.asarray(v))
    bt = rng.permutation(np.arange(1, n_pages))[: b * npp].reshape(b, npp)
    pos = np.asarray([ps * 3 + 2, ps * npp - 1], np.int32)
    q = rng.normal(size=(b, 1, hkv * g, d)).astype(np.float32)
    return (q, np.array(kq), np.array(vq), np.array(ks), np.array(vs),
            bt.astype(np.int32), pos)


@pytest.mark.parametrize("label", ["base", "con2", "gap2", "con4"])
@pytest.mark.parametrize("window", [None, 11], ids=["causal", "window"])
def test_int8_paged_decode_matches_reference(label, window):
    """The kernel's plain version (int8 panes dequantized as they are
    read, split-KV arithmetic) and the layer's plain path against the
    reference's `layers.paged_decode_attention` with scales on its plain
    path (the Pallas paged kernel cannot run on the installed JAX).  All
    f32 after the exact dequantization: rtol = atol = 2e-5."""
    q, kq, vq, ks, vs, bt, pos = _int8_pools()
    want = JL.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
        jnp.asarray(pos), window=window, backend="ref",
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t = [torch.from_numpy(np.array(a)) for a in (q, kq, vq, bt, pos)]
    tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    got = tops.paged_decode_attention(*t, label, window=window, k_scale=tks,
                                      v_scale=tvs)
    plain = TL.paged_decode_attention(*t, window=window, backend="ref",
                                      k_scale=tks, v_scale=tvs)
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
