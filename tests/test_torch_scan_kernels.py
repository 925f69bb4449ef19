"""The port's Mamba-2 SSD (row 12) and RG-LRU (row 13) against the JAX
package on the CPU.

* Plain versions: `ref.ssd` and `ref.rglru` against `repro.kernels.ref`'s
  at rtol and atol 1e-5 (the same float32 arithmetic, summed in other
  orders).
* Ops and wrappers: `ops.ssd` / `ops.rglru` (the plain versions on CPU
  tensors) against the Pallas kernels in interpret mode, for the labels and
  shapes of the reference's tests (`tests/test_kernels.py:172-195`,
  `:252-262`), at their tolerances: 2e-3 for the SSD (the chunked sums
  against the naive oracle's order), 1e-4 for the RG-LRU (the Pallas scan
  against the sequential recurrence).
* Refusals: every raise of the Pallas `make_kernel` is a `ValueError` of
  the port's; the card's extra limits (`takes`) raise on non-CPU tensors
  before any launch (``meta`` tensors stand in for the card's).
* Owner maps: ``probe=True`` on the CPU equals the map the Pallas
  BlockSpecs give, for every label the kernels take.

Inputs are made with numpy from fixed seeds and handed to both sides.  No
kernel is built or launched here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coarsening import CoarseningConfig as JCfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.coarsening import CoarseningConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru as trg
from repro_torch.kernels import ssd as tssd

SSD_SHAPE = (2, 8, 2, 256, 32, 16)              # b, h, g, s, p, n
RGLRU_SHAPE = (2, 128, 512)                     # b, s, d


def _ssd_inputs(seed, b, h, g, s, p, n, layout="kernel"):
    """The reference tests' scales (`tests/test_kernels.py:175-180`)."""
    r = np.random.default_rng(seed)
    lead = (b, h, s) if layout == "kernel" else (b, s, h)
    x = (r.standard_normal((*lead, p)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(r.standard_normal(lead))) * 0.1).astype(np.float32)
    a = (-np.exp(r.standard_normal(h) * 0.3)).astype(np.float32)
    bc = (b, g, s, n) if layout == "kernel" else (b, s, g, n)
    bm = (r.standard_normal(bc) * 0.3).astype(np.float32)
    cm = (r.standard_normal(bc) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


def _rglru_inputs(seed, b, s, d):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, d), (b, s, d), (b, s, d), (d,)))


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _meta(arrays):
    return [torch.empty(a.shape, device="meta") for a in arrays]


# -- plain versions -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 128, 4, 16, 1, 8),
                                   (1, 96, 8, 8, 2, 4)])
def test_ssd_plain_version_matches_the_reference(shape):
    b, s, h, p, g, n = shape
    args = _ssd_inputs(0, b, h, g, s, p, n, layout="ref")
    want = np.asarray(jref.ssd(*[jnp.asarray(a) for a in args]))
    got = tref.ssd(*_torch(args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rglru_plain_version_matches_the_reference():
    args = _rglru_inputs(1, 2, 64, 96)
    want = np.asarray(jref.rglru(*[jnp.asarray(a) for a in args]))
    got = tref.rglru(*_torch(args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert tref.RGLRU_C == jref.RGLRU_C


def test_softplus_is_jax_s_without_a_threshold():
    import jax
    x = np.array([-50.0, -3.0, 0.0, 1.5, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(tref.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)


# -- ops against the Pallas kernels in interpret mode ---------------------------

@pytest.mark.parametrize("spec,g", [("none", 2), ("con2", 2), ("con4", 2),
                                    ("gap4", 1)])
def test_ssd_matches_the_pallas_kernel(spec, g):
    b, h, _, s, p, n = SSD_SHAPE
    args = _ssd_inputs(600, b, h, g, s, p, n)
    want = np.asarray(jops.ssd(*[jnp.asarray(a) for a in args],
                               JCfg.parse(spec), chunk=64))
    got = tops.ssd(*_torch(args), spec, chunk=64)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    run = tssd.make_kernel(b, h, g, s, p, n, spec, chunk=64)
    np.testing.assert_array_equal(run(*_torch(args)).numpy(), got.numpy())


@pytest.mark.parametrize("spec", ["none", "con2", "con4", "gap2", "gap4"])
def test_rglru_matches_the_pallas_kernel(spec):
    args = _rglru_inputs(700, *RGLRU_SHAPE)
    want = np.asarray(jops.rglru(*[jnp.asarray(a) for a in args],
                                 JCfg.parse(spec), block_d=64, block_t=32))
    got = tops.rglru(*_torch(args), spec, block_d=64, block_t=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ops_have_no_backward():
    args = _torch(_rglru_inputs(2, 1, 32, 128))
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.rglru(*args, block_d=64, block_t=32)
    sargs = _torch(_ssd_inputs(3, 1, 2, 1, 64, 4, 4))
    sargs[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.ssd(*sargs)


# -- refusals -----------------------------------------------------------------

SSD_RAISES = [
    ("none", (1, 8, 1, 100, 16, 8), "seq not divisible by chunk"),
    ("gap2", (1, 8, 2, 128, 16, 8), "requires n_groups == 1"),
    ("con4", (1, 8, 4, 128, 16, 8), "group_size % C == 0"),
    ("gap4", (1, 6, 1, 128, 16, 8), "heads not divisible by degree"),
]


@pytest.mark.parametrize("spec,shape,msg", SSD_RAISES)
def test_ssd_raises_as_the_pallas_kernel(spec, shape, msg):
    from repro.kernels import ssd as jssd
    b, h, g, s, p, n = shape
    with pytest.raises(ValueError, match=msg):
        jssd.make_kernel(b, h, g, s, p, n, JCfg.parse(spec), chunk=64)
    with pytest.raises(ValueError, match=msg):
        tssd.make_kernel(b, h, g, s, p, n, spec, chunk=64)
    args = _ssd_inputs(4, b, h, g, s, p, n)
    with pytest.raises(ValueError, match=msg):
        tops.ssd(*_torch(args), spec)


def test_ssd_gapped_multigroup_raises_as_the_reference_test():
    """`tests/test_kernels.py:198-202`, on both sides."""
    shapes = [(1, 8, 128, 16), (1, 8, 128), (8,), (1, 2, 128, 8),
              (1, 2, 128, 8)]
    with pytest.raises(ValueError):
        jops.ssd(*[jnp.ones(s) for s in shapes], JCfg.parse("gap2"))
    with pytest.raises(ValueError):
        tops.ssd(*[torch.ones(s) for s in shapes], "gap2")


@pytest.mark.parametrize("shape,chunk", [
    ((1, 4, 1, 128, 30, 16), 64),       # P not a multiple of 4
    ((1, 4, 1, 128, 32, 18), 64),       # N not a multiple of 4
    ((1, 4, 1, 128, 32, 16), 16),       # chunk not a multiple of 32
    ((1, 4, 1, 256, 256, 256), 128),    # the chunk's tiles past 227 KB
])
@pytest.mark.parametrize("spec", ["none", "con2", "gap2"])
def test_ssd_card_limits_raise_before_a_launch(shape, chunk, spec):
    b, h, g, s, p, n = shape
    cfg = CoarseningConfig.parse(spec)
    assert not tssd.takes(h, g, n, p, chunk, cfg)
    run = tssd.make_kernel(b, h, g, s, p, n, cfg, chunk=chunk)  # Pallas-legal
    before = tssd.launches
    with pytest.raises(ValueError, match="ssd kernel takes"):
        run(*_meta(_ssd_inputs(5, *shape)))
    assert tssd.launches == before


def test_ssd_takes_every_label_at_mamba2_width():
    """The states live in the workspace, so the degree never refuses."""
    for spec in ("none", "con2", "gap2", "con4", "gap4", "con8", "gap8"):
        assert tssd.takes(32, 1, 128, 64, 64, CoarseningConfig.parse(spec))
    assert tssd.smem_bytes(64, 128, 64) == 191488


@pytest.mark.parametrize("spec,shape,bt", [("con4", (1, 64, 384), 32),
                                           ("none", (1, 48, 128), 32)])
def test_rglru_raises_as_the_pallas_kernel(spec, shape, bt):
    from repro.kernels import rglru as jrg
    b, s, d = shape
    with pytest.raises(ValueError, match="shape not tileable"):
        jrg.make_kernel(b, s, d, JCfg.parse(spec), block_d=64, block_t=bt)
    with pytest.raises(ValueError, match="shape not tileable"):
        trg.make_kernel(b, s, d, spec, block_d=64, block_t=bt)


@pytest.mark.parametrize("spec,shape,block_d,block_t", [
    ("con8", (1, 64, 2048), 256, 32),   # 2048 threads a block
    ("gap8", (1, 64, 2048), 256, 32),
    ("none", (1, 12, 128), 128, 4),     # S not a multiple of 8
])
def test_rglru_card_limits_raise_before_a_launch(spec, shape, block_d,
                                                 block_t):
    b, s, d = shape
    cfg = CoarseningConfig.parse(spec)
    assert not trg.takes(s, cfg, block_d)
    run = trg.make_kernel(b, s, d, cfg, block_d=block_d, block_t=block_t)
    before = trg.launches
    with pytest.raises(ValueError, match="rglru kernel takes"):
        run(*_meta(_rglru_inputs(6, b, s, d)))
    assert trg.launches == before


# -- owner maps ---------------------------------------------------------------

def _pallas_head_owners(h, spec):
    """Each head's program under the Pallas BlockSpecs
    (`repro/kernels/ssd.py:87-99`): consecutive programs read x block
    (1, C, chunk, P) at head-block hh; gapped ones view x as (B, C, H/C, S,
    P) and read block (1, C, 1, chunk, P) at (0, hh)."""
    cfg = JCfg.parse(spec)
    c, nh = cfg.degree, h // cfg.degree
    heads = np.arange(h)
    owner = np.full(h, -1)
    for hh in range(nh):
        if cfg.kind == "gapped":
            owner[heads.reshape(c, nh)[:, hh]] = hh
        else:
            owner[heads[hh * c:(hh + 1) * c]] = hh
    return owner


def _pallas_channel_owners(d, spec, block_d):
    """Each channel's program under the Pallas BlockSpecs
    (`repro/kernels/rglru.py:63-72`): consecutive programs read (1, bt,
    C*block_d) at di; gapped ones view (B, S, C, D/C) and read (1, bt, C,
    block_d) at (0, di)."""
    cfg = JCfg.parse(spec)
    c = cfg.degree
    ch = np.arange(d)
    owner = np.full(d, -1)
    for di in range(d // (c * block_d)):
        if cfg.kind == "gapped":
            owner[ch.reshape(c, d // c)[:, di * block_d:(di + 1) * block_d]
                  .ravel()] = di
        else:
            owner[ch[di * c * block_d:(di + 1) * c * block_d]] = di
    return owner


@pytest.mark.parametrize("spec", ["none", "con2", "gap2", "con4", "gap4",
                                  "con8", "gap8"])
def test_ssd_probe_owner_map_is_the_pallas_index_map(spec):
    b, h, g, s, p, n = 2, 8, 1, 64, 4, 4
    args = _torch(_ssd_inputs(7, b, h, g, s, p, n))
    got = tssd.make_kernel(b, h, g, s, p, n, spec)(*args, probe=True)
    want = _pallas_head_owners(h, spec)[None, :, None, None]
    np.testing.assert_array_equal(got.numpy(),
                                  np.broadcast_to(want, (b, h, s, p)))


@pytest.mark.parametrize("spec", ["none", "con2", "gap2", "con4", "gap4"])
def test_rglru_probe_owner_map_is_the_pallas_index_map(spec):
    b, s, d = 1, 32, 512
    args = _torch(_rglru_inputs(8, b, s, d))
    got = trg.make_kernel(b, s, d, spec, block_d=64, block_t=32)(
        *args, probe=True)
    want = _pallas_channel_owners(d, spec, 64)[None, None, :]
    np.testing.assert_array_equal(got.numpy(),
                                  np.broadcast_to(want, (b, s, d)))
