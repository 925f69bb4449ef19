"""The dequant-fused MoE kernel's plan (`repro_torch.kernels.moe_ffn`
`plan`, `pass_stages`), pure Python: no kernel is built or launched.

At the shipped MoE widths (qwen2-moe-a2.7b: d 2048, F 1408; olmoe-1b-7b:
d 2048, F 1024), int8 and int4, capacities 8 and 128: the tuner enumerates
every label for the ``moe_ffn`` family; the walk (at base, con2 and gap8)
covers every (expert, column, K row) of every live 16-row tile once; the
int4 scale rows a stage stages are the groups of its K rows; the experts a
block owns are the Pallas index maps' (`repro/kernels/moe_ffn.py:174-187`);
the ring keeps at least `INFLIGHT_MIN` packed weight bytes in flight an SM
in 227 KB; `takes` holds every shipped configuration.
"""
import collections
import importlib

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core.coarsening import KIND_GAPPED, resolve
from repro_torch.kernels import moe_ffn as moe
from repro_torch.quant.qtypes import DEFAULT_GROUP
from repro_torch.tune import KernelSpec

tsearch = importlib.import_module("repro_torch.tune.search")

E = 64
WIDTHS = {"qwen2-moe-a2.7b": (2048, 1408), "olmoe-1b-7b": (2048, 1024)}
CAPS = (8, 128)


def _labels(d, f, bits):
    spec = KernelSpec.make("moe_ffn", (E, 128, d, f), dtype="bfloat16",
                           wbits=bits, group=DEFAULT_GROUP if bits == 4
                           else 0)
    return [cfg.label for cfg in tsearch.enumerate_candidates(spec)]


def _comb(c, seed):
    """Combine weights of E experts at capacity c: the last four experts
    dead (padding), one expert with every row live, one with rows live on
    non-leading tiles only, the rest a few scattered rows."""
    rng = np.random.default_rng(seed)
    comb = np.zeros((E, c), np.float32)
    for ex in range(E - 4):
        rows = rng.choice(c, size=min(c, int(rng.integers(1, 12))),
                          replace=False)
        comb[ex, rows] = rng.uniform(0.05, 1.0, rows.size)
    comb[3] = rng.uniform(0.05, 1.0, c)
    comb[5] = 0
    comb[5, c // 2:] = rng.uniform(0.05, 1.0, c - c // 2)
    return comb


@pytest.mark.parametrize("model", sorted(WIDTHS))
@pytest.mark.parametrize("bits", (8, 4))
def test_takes_holds_the_shipped_configs(model, bits):
    cfg = get_config(model)
    assert (cfg.d_model, cfg.moe_d_ff) == WIDTHS[model]
    assert moe.takes(cfg.d_model, cfg.moe_d_ff, bits,
                     DEFAULT_GROUP if bits == 4 else 0)
    assert moe.takes(cfg.d_model, cfg.moe_d_ff, None)
    assert _labels(cfg.d_model, cfg.moe_d_ff, bits) == [
        "base", "con2", "gap2", "con4", "gap4", "con8", "gap8"]


@pytest.mark.parametrize("group", (16, 32, 64, 128, DEFAULT_GROUP))
def test_takes_the_groups_that_tile_d_and_f(group):
    assert moe.takes(256, 128, 4, group) == (256 % group == 0
                                             and 128 % group == 0)
    assert not moe.takes(2048, 1408, 4, 48)          # does not tile F
    assert not moe.takes(2048, 1400, 8)              # F not a multiple of 64


@pytest.mark.parametrize("label", ("base", "con2", "gap2", "con4", "gap4",
                                   "con8", "gap8"))
def test_item_experts_are_the_pallas_index_maps(label):
    cfg = resolve(label)
    c, gapped = cfg.degree, cfg.kind == KIND_GAPPED
    grid = E // c
    experts = np.arange(E)
    for i in range(grid):
        # the reference's views: gapped (c, grid) with block (c, 1) at
        # (0, i); consecutive block (c,) at (i,)
        want = (experts.reshape(c, grid)[:, i] if gapped
                else experts.reshape(grid, c)[i])
        assert moe.item_experts(i, E, c, gapped) == want.tolist()


@pytest.mark.parametrize("model", sorted(WIDTHS))
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("bits", (8, 4))
def test_ring_keeps_the_stated_bytes_in_flight(model, cap, bits):
    d, f = WIDTHS[model]
    for pp in moe.plan(bits, DEFAULT_GROUP if bits == 4 else 0, E, cap, d, f):
        need = 2 * pp.w_bytes + pp.nt_cap * pp.tile_bytes \
            + 2 * pp.srows * moe.Q_WN * 4
        assert pp.stage_bytes >= need and pp.stage_bytes % 1024 == 0
        assert pp.smem <= moe.Q_SMEM and 2 <= pp.stages <= moe.Q_MAX_STAGES
        assert pp.inflight >= moe.INFLIGHT_MIN
        assert pp.blocks == min(pp.items, moe.SMS)
    if bits == 4:
        # pass B: int4's smaller stages are more of them; pass A: stages of
        # 256 rows whose weight boxes are int8's 8 KB
        (a8, b8), (a4, b4) = (moe.plan(8, 0, E, cap, d, f),
                              moe.plan(4, DEFAULT_GROUP, E, cap, d, f))
        assert b4.stages >= b8.stages and a4.w_bytes == a8.w_bytes


@pytest.mark.parametrize("bk", (128, 256))
@pytest.mark.parametrize("group,k", [(g, k) for g in (16, 32, 64, 128)
                                     for k in (1408, 1024, 2048, 192)
                                     if k % g == 0])
def test_stage_scale_rows_are_its_groups(group, k, bk):
    srows = moe.scale_rows(k, group, bk)
    assert srows == (bk // group if group <= bk else 1)
    kpad = -(-k // bk) * bk
    for kk in range(0, kpad, bk):
        rows = [r for r in range(kk, kk + bk) if r < k]
        want = sorted({r // group for r in rows})
        got = moe.stage_groups(kk, group, bk)
        # the box starts at the stage's first group and holds srows rows
        assert got.start == kk // group and len(got) <= srows
        assert want == [g for g in got if g < k // group]


@pytest.mark.parametrize("label", ("base", "con2", "gap8"))
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("bits", (8, 4))
def test_walk_covers_each_live_element_once(label, cap, bits):
    """Every (expert, live tile, column, K row) of both passes is staged
    exactly once, dead tiles and experts never; K rows past K only in a
    last stage; the chunks' N and the scale rows as the plan says."""
    d, f = WIDTHS["qwen2-moe-a2.7b"]
    cfg = resolve(label)
    group = DEFAULT_GROUP if bits == 4 else 0
    comb = _comb(cap, seed=cap + bits)
    live = {ex: moe.live_tiles(comb[ex], cap) for ex in range(E)}
    assert live[5] and live[5][0] == (cap // 2) // moe.Q_TILE
    assert not live[E - 1]
    for pp in moe.plan(bits, group, E, cap, d, f, cfg.degree):
        seen = collections.Counter()
        pass_a = pp.cols == moe.Q_WN
        assert pp.bk == moe.stage_rows(bits, pass_a)
        kpad = -(-pp.k // pp.bk) * pp.bk
        for item, ex, streams, rows, tiles, n, groups in moe.pass_stages(
                pp, E, cfg.degree, cfg.kind == KIND_GAPPED, comb, cap, bits,
                group):
            assert ex in moe.item_experts(item // pp.col_tiles, E,
                                          cfg.degree,
                                          cfg.kind == KIND_GAPPED)
            assert len(tiles) <= moe.Q_NT_MAX and set(tiles) <= set(live[ex])
            assert n == (8 if cap <= 8 else 16 * len(tiles))
            assert rows.start % pp.bk == 0 and rows.stop <= kpad
            if bits == 4:
                assert len(groups) <= pp.srows
            # pass A: w1's and w3's same 64 columns; pass B: w2's two halves
            for si, s0 in enumerate(streams):
                for t in tiles:
                    # rows are whole stages: coverage at that grain
                    seen[(ex, t, si if pass_a else 0, s0, rows.start)] += 1
        want = {(ex, t, m, s0, kk) for ex in range(E) for t in live[ex]
                for m in ((0, 1) if pass_a else (0,))
                for s0 in range(0, pp.n, moe.Q_WN)
                for kk in range(0, kpad, pp.bk)}
        assert set(seen) == want and set(seen.values()) == {1}


def test_chunks_split_live_tiles_in_fours():
    assert moe.chunks([0], 8) == [((0,), 8)]
    assert moe.chunks([0], 12) == [((0,), 16)]
    assert moe.chunks([1, 2, 4, 5, 7], 128) == [((1, 2, 4, 5), 64),
                                                ((7,), 16)]
    assert moe.chunks([], 128) == []
