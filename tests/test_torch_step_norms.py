"""The decode and verify steps' norms folded into what reads them: the
normed step product (`matmul.step_matmul` with ``norm``: ln1, a dense
FFN's ln2 and the final norm as the prologue of row 2's step products)
and `rmsnorm.qk_norm_rope` (the q/k norms with RoPE in one rows kernel).

Their plain versions (the CPU paths) against the reference's `rmsnorm`
and `apply_rope` (`repro/models/layers.py:87`, `:103`) on numpy inputs
from a seed; the prologue's fragment map through the 128-byte swizzle
against wgmma's documented m64k16 A layout; and the route of a reduced
decode and verify step.  The kernels themselves run only on the card
(`chip_smoke.py`: bit for bit against the row norm kernel then the
product, and then `apply_rope`).
"""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import rmsnorm as tnorm
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

EPS = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ref_norm_rope(x, pos, scale, theta, jdt):
    """The reference's per-head `rmsnorm` (where ``scale`` is given) then
    `apply_rope`, as numpy float32."""
    y = jnp.asarray(x, jdt)
    if scale is not None:
        y = JL.rmsnorm({"scale": jnp.asarray(scale)}, y, EPS)
    return np.asarray(JL.apply_rope(y, jnp.asarray(pos), theta), np.float32)


@pytest.mark.parametrize("norm", [True, False], ids=["qk-norm", "rope-only"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qk_norm_rope_plain_matches_the_reference(dtype, d, norm):
    """`qk_norm_rope` on CPU tensors (its plain version) against the
    reference's `rmsnorm` per head then `apply_rope`, positions up to 1023.

    Tolerance: float32, the angle pos * freq (up to ~1023 rad) carries the
    two libraries' rounding of freq (1 ulp) and their sin/cos reductions:
    2e-4 of the head's scale.  bfloat16: in addition one output rounding
    on each side and, with the norm, the normed value's rounding before
    the rotation: 2^-6 of the head's largest |value|."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(11 + d)
    b, t, h, hkv, theta = 2, 3, 4, 2, 1e6
    q = _rand(rng, b, t, h, d, scale=3.0)
    k = _rand(rng, b, t, hkv, d, scale=3.0)
    pos = rng.integers(0, 1024, size=(b, t)).astype(np.int32)
    pos[0, 0], pos[1, 2] = 0, 1023
    qs, ks = (_rand(rng, d, scale=0.1), _rand(rng, d, scale=0.1)) if norm \
        else (None, None)
    got = tnorm.qk_norm_rope(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(pos), None if qs is None else torch.from_numpy(qs),
        None if ks is None else torch.from_numpy(ks), EPS, theta)
    for g, x, sc in zip(got, (q, k), (qs, ks)):
        want = _ref_norm_rope(x, pos, sc, theta, jdt)
        assert g.dtype == tdt and g.shape == x.shape
        lim = np.abs(want).max(axis=-1, keepdims=True)
        rel = 2e-4 if dtype == "float32" else 2.0 ** -6
        np.testing.assert_array_less(np.abs(g.float().numpy() - want),
                                     np.broadcast_to(rel * lim + 1e-6,
                                                     want.shape))


def test_qk_norm_rope_flattened_rows_and_refusals():
    """q and k may come as (B*T, H, D) against positions (B, T); a scale
    of the wrong width, one scale without the other, or a head dim the
    kernel does not take off the CPU raise."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_rand(rng, 6, 1, 4, 32)).bfloat16()
    k = torch.from_numpy(_rand(rng, 6, 1, 2, 32)).bfloat16()
    pos = torch.from_numpy(rng.integers(0, 512, size=(6, 1)))
    sc = torch.from_numpy(_rand(rng, 32, scale=0.1))
    want = tnorm.qk_norm_rope(q, k, pos, sc, sc, EPS, 1e4)
    got = tnorm.qk_norm_rope(q.reshape(6, 4, 32), k.reshape(6, 2, 32),
                             pos, sc, sc, EPS, 1e4)
    assert torch.equal(got[0], want[0].reshape(6, 4, 32))
    assert torch.equal(got[1], want[1].reshape(6, 2, 32))
    with pytest.raises(ValueError, match="scales"):
        tnorm.qk_norm_rope(q, k, pos, sc[:16], sc, EPS, 1e4)
    with pytest.raises(ValueError, match="scales"):
        tnorm.qk_norm_rope(q, k, pos, sc, None, EPS, 1e4)
    m = dict(device="meta")
    with pytest.raises(ValueError, match="takes D"):
        tnorm.qk_norm_rope(torch.empty(2, 1, 4, 264, **m),
                           torch.empty(2, 1, 2, 264, **m),
                           torch.empty(2, 1, dtype=torch.int32, **m),
                           None, None, EPS, 1e4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_normed_step_product_plain_matches_the_reference(dtype):
    """`step_matmul(x, w, norm=(scale, eps))` on CPU tensors against the
    reference's `rmsnorm` then the float32 product, and bit for bit against
    the port's own `rmsnorm` then `step_matmul` (the CPU route before the
    fusion).

    Tolerance: float32, summation order only: 1e-5 relative to the
    largest |x| @ |w|.  bfloat16: the normed rows may round one bf16 ulp
    apart between the libraries, and the store rounds to bf16: 2^-6 of
    the largest |x| @ |w|."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = _rand(rng, 5, 96, scale=3.0)
    sc = _rand(rng, 96, scale=0.1)
    w = _rand(rng, 96, 40, scale=0.1)
    tx, tw, ts = (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                  torch.from_numpy(sc))
    got = tmm.step_matmul(tx, tw, tdt, norm=(ts, EPS))
    assert got.dtype == tdt and got.shape == (5, 40)
    assert torch.equal(got, tmm.step_matmul(tnorm.rmsnorm(tx, ts, EPS), tw,
                                            tdt))
    h = np.asarray(JL.rmsnorm({"scale": jnp.asarray(sc)},
                              jnp.asarray(x, jdt), EPS), np.float32)
    wf = tw.float().numpy()
    want = h @ wf
    mag = (np.abs(h) @ np.abs(wf)).max()
    tol = (1e-5 if dtype == "float32" else 2.0 ** -6) * mag
    np.testing.assert_array_less(np.abs(got.float().numpy() - want), tol)


def test_normed_product_refusals():
    """The prologue is base's only and takes a (K,) scale."""
    a, b = torch.zeros(128, 64).bfloat16(), torch.zeros(64, 64).bfloat16()
    with pytest.raises(ValueError, match="base's only"):
        tmm.coarsened_matmul(a, b, "con2", norm=(torch.zeros(64), EPS))
    with pytest.raises(ValueError, match="norm scale"):
        tmm.step_matmul(a, b, norm=(torch.zeros(32), EPS))
    with pytest.raises(ValueError, match="norm prologue"):
        TL.dense(a, b, norm=(torch.zeros(64), EPS))


def _normed_shapes():
    """(name, n, k) of every product that takes the norm prologue:
    qwen3-0.6b's q, k (= v), gate (= up) and tied head, qwen2-moe-a2.7b's
    q and k (= v) at K 2048."""
    q3, moe = get_config("qwen3-0.6b"), get_config("qwen2-moe-a2.7b")
    return [("qwen3 q", q3.n_heads * q3.hd, q3.d_model),
            ("qwen3 k", q3.n_kv_heads * q3.hd, q3.d_model),
            ("qwen3 gate", q3.d_ff, q3.d_model),
            ("qwen3 head", q3.vocab_padded, q3.d_model),
            ("qwen2-moe q", moe.n_heads * moe.hd, moe.d_model),
            ("qwen2-moe k", moe.n_kv_heads * moe.hd, moe.d_model)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("name,n,k", _normed_shapes(),
                         ids=[s[0] for s in _normed_shapes()])
def test_normed_plan_shares_the_statistic(name, n, k, sms):
    """`step_plan` with ``norm`` for every M in 1..128: the plain step
    plan's K split (so the sums and their bits do not change); under a K
    split a tile of more than `NORM_OWN_ROWS` rows takes a cluster of
    `NORM_CLUSTER` blocks where the split has fewer slices, whole clusters
    along the grid's columns; every column tile walked by one column of
    blocks (persistent, fewer columns than tiles, only without a split and
    at most `NORM_BLOCKS_PER_SM` blocks an SM).  Each row's statistic is
    computed by one warp (`norm_stat_rows`: of the cluster's where it
    shares them, else of its own block) and read from that warp's block;
    a decode step's 8 rows and a shared tile take one pass a warp."""
    tiles = -(-n // tmm.BN)
    for m in range(1, 129):
        plain = tmm.step_plan(m, n, k, sms)
        plan = tmm.step_plan(m, n, k, sms, norm=True)
        assert (plan.splits, plan.unit) == (plain.splits, plain.unit)
        assert plan.bounds(k) == plain.bounds(k)
        tall = plan.splits > 1 and min(m, tmm.BM) > tmm.NORM_OWN_ROWS
        assert plan.cluster_y == (
            max(1, tmm.NORM_CLUSTER // plan.splits) if tall else 1)
        cs = plan.splits * plan.cluster_y
        assert cs <= tmm.MAX_SPLITS
        s, cols, rows = plan.grid
        assert s == plan.splits and rows == -(-m // tmm.BM)
        assert cols % plan.cluster_y == 0
        walked = sorted(t for y in range(cols) for t in range(y, tiles, cols))
        assert walked == list(range(tiles))
        if cols < tiles:
            assert plan.splits == 1
            assert plan.blocks <= tmm.NORM_BLOCKS_PER_SM * sms
        else:
            assert cols - tiles < plan.cluster_y
        for row0 in range(0, m, tmm.BM):
            live = min(m - row0, tmm.BM)
            shared = cs > 1 and live > tmm.NORM_OWN_ROWS
            nw = 4 * cs if shared else 4
            owned = {}
            for gw in range(nw):
                passes = tmm.norm_stat_rows(gw, nw, live)
                if shared and nw >= 32 or live <= tmm.NORM_OWN_ROWS:
                    assert len(passes) <= 1
                for r in (r for p in passes for r in p):
                    assert r not in owned
                    owned[r] = gw // 4
            assert sorted(owned) == list(range(live))
            assert all(owned[r] == (r % nw) // 4 for r in owned)


def _wgmma_a(warp, lane, j, e):
    """wgmma's documented m64k16 A fragment (PTX ISA, register operand):
    register j, half e of lane 4g + t in warp w holds row 16w + g (+ 8 for
    j = 1, 3) and k 2t + e (+ 8 for j = 2, 3)."""
    g, t = lane // 4, lane % 4
    return 16 * warp + g + 8 * (j & 1), 8 * (j >> 1) + 2 * t + e


def _tma_swizzle_128(row, k):
    """Where TMA's 128-byte swizzle puts element (row, k) of a box of
    128-byte rows: 16-byte chunk c of row r at chunk c XOR (r mod 8)."""
    return row * 128 + 16 * ((k // 8) ^ (row % 8)) + 2 * (k % 8)


def test_norm_fragment_map_covers_the_stage():
    """Every consumer thread's A registers of every k16 step, as the
    prologue loads them (`matmul.norm_frag_map`: ldmatrix.x4 through the
    swizzle), hold wgmma's documented fragment, and the four warps cover
    each element of a 64 x 64 stage exactly once; each 8x8 matrix's eight
    row addresses are 16-byte aligned and fall in eight different 16-byte
    bank groups (no conflict)."""
    seen = {}
    for warp in range(4):
        for ks in range(tmm.MM_KSTEP // 16):
            for lane in range(32):
                regs = tmm.norm_frag_map(warp, lane, ks)
                for j in range(4):
                    for e in range(2):
                        row, k = _wgmma_a(warp, lane, j, e)
                        off = regs[j][e]
                        assert off == _tma_swizzle_128(row, 16 * ks + k)
                        assert off not in seen
                        seen[off] = (warp, lane, ks, j, e)
            for j in range(4):
                starts = {tmm.norm_frag_map(warp, 4 * g, ks)[j][0]
                          for g in range(8)}
                assert all(s % 16 == 0 for s in starts)
                assert len({(s // 16) % 8 for s in starts}) == 8
    assert sorted(seen) == list(range(0, 64 * tmm.MM_KSTEP * 2, 2))


@contextlib.contextmanager
def _recorded(monkeypatch):
    """Count the row-norm wrapper's, the normed products' and
    `qk_norm_rope`'s calls while passing them through."""
    n = {"rmsnorm": 0, "normed": 0, "qk_norm_rope": 0}
    norm, cmm, qk = tnorm.rmsnorm, tmm.coarsened_matmul, tnorm.qk_norm_rope

    def rmsnorm(*a, **kw):
        n["rmsnorm"] += 1
        return norm(*a, **kw)

    def coarsened(*a, **kw):
        n["normed"] += kw.get("norm") is not None
        return cmm(*a, **kw)

    def qk_norm_rope(*a, **kw):
        n["qk_norm_rope"] += 1
        return qk(*a, **kw)

    monkeypatch.setattr(tnorm, "rmsnorm", rmsnorm)
    monkeypatch.setattr(tmm, "coarsened_matmul", coarsened)
    monkeypatch.setattr(tnorm, "qk_norm_rope", qk_norm_rope)
    yield n
    monkeypatch.undo()


@contextlib.contextmanager
def _unfused(monkeypatch):
    """The steps' route before the fusion: the row-norm wrapper, then the
    product; the q/k norms on the row-norm wrapper, then `apply_rope`."""
    cmm = tmm.coarsened_matmul

    def coarsened(a, b, *args, norm=None, **kw):
        if norm is not None:
            a = tnorm.rmsnorm(a, *norm)
        return cmm(a, b, *args, **kw)

    def qk_norm_rope(q, k, pos, q_scale, k_scale, eps, theta):
        def one(x, sc):
            x = x.reshape(*pos.shape, *x.shape[-2:])
            if sc is not None:
                x = tnorm.rmsnorm(x, sc, eps)
            return TL.apply_rope(x, pos, theta)
        return one(q, q_scale), one(k, k_scale)

    monkeypatch.setattr(tmm, "coarsened_matmul", coarsened)
    monkeypatch.setattr(tnorm, "qk_norm_rope", qk_norm_rope)
    yield
    monkeypatch.undo()


def _model(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              decode_backend="cuda", ffn_backend="cuda",
                              moe_backend="cuda")
    gen = torch.Generator().manual_seed(0)
    params = TM.lm_init(cfg, gen, device="cpu")
    # the init's norm scales are 0: draw them, so that (1 + s) matters
    for s in ([params["final_norm"]]
              + [p[n] for p in params["layers"] for n in ("ln1", "ln2")]
              + [p["attn"][n] for p in params["layers"]
                 for n in ("qnorm", "knorm") if n in p["attn"]]):
        s["scale"] = 0.1 * torch.randn(s["scale"].shape, generator=gen)
    return cfg, params


@pytest.mark.parametrize("step", ["decode", "verify"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
def test_step_route_folds_the_norms(arch, step, monkeypatch):
    """A reduced step on CPU tensors under the kernel backends: the row-norm
    wrapper runs 0 times (n_layers for an MoE config: its ln2), the normed
    product 5 n_layers + 1 times (3 n_layers + 1 with MoE layers: q, k, v
    and the head), `qk_norm_rope` n_layers times; the logits are bit-equal
    to the route before the fusion (row norm, then the product; row norm
    per head, then `apply_rope`)."""
    cfg, params = _model(arch)
    slots, ps, npp, t = 2, 4, 8, 5
    table = torch.arange(1, 1 + slots * npp, dtype=torch.int32).reshape(
        slots, npp)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (slots, t)))
    pos = torch.tensor([7, 11], dtype=torch.int32)

    def run():
        cache = TM.lm_init_cache_paged(cfg, slots * npp + 1, ps,
                                       device="cpu")
        if step == "decode":
            return TM.lm_decode_step(params, cache, toks[:, :1], pos, cfg,
                                     block_table=table)[0]
        return TM.lm_verify_step(params, cache, toks, pos, cfg,
                                 block_table=table)[0]

    with _recorded(monkeypatch) as n:
        got = run()
    moe = bool(cfg.n_experts)
    assert n == {"rmsnorm": cfg.n_layers if moe else 0,
                 "normed": (3 if moe else 5) * cfg.n_layers + 1,
                 "qk_norm_rope": cfg.n_layers}
    with _unfused(monkeypatch):
        want = run()
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
