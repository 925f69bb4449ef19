"""The flash backward kernels' plan, pure Python: the walks they follow,
the dK/dV cluster plan, and the plain version of the backward's prep pass.

* `dkv_walk` (each kv program's kv rows, launch position and, in order,
  the q tiles it loads, each full or edge for each group of 64 kv rows),
  for every label the dK/dV kernel takes at small geometries (causal,
  causal with a window, and non-causal cross attention), against the
  reference: every allowed (row, col) pair of the exact mask
  (`ref._flash_mask`) lies in a loaded tile; a full tile has no masked
  pair for its group's kv rows and an edge tile has one; the loaded q
  blocks are exactly those the Pallas whole-block rule
  (`repro/kernels/flash_attention.py:371-380`, executed from the
  reference's own source) keeps, each loaded whole; launch positions are a
  permutation, heaviest first under causal masking.
* dQ's walk: `fwd_walk` with `dq_kv_tile` rows a tile, for the tile and
  program heights the forward's tests do not reach (32-row tiles at head
  dim 256, 64-row tiles for programs of 256 rows), against the same.
* The cluster plan (`dkv_cluster`, `dkv_clusters`): the q heads of each
  cluster, the rank order of the sum, the divisor rule for groups of more
  than 16 heads, and the kernel's block order grouping them.
* `ref.flash_bwd_prep` against ``jnp.sum(g * o, axis=-1)`` within the f32
  bound of two summation orders (2 D 2^-24 of sum |g o| per row), and its
  bf16 dO bit for bit against ``g.astype(jnp.bfloat16)``.
No kernel is built or launched.
"""
import inspect
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro_torch.core.coarsening import KIND_GAPPED, resolve
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref

S = 512
LABELS = ("base", "con2", "gap2", "con4", "gap4", "con8", "gap8")
# (causal, window, Sk): the masks the kernels hold
MASKS = {"causal": (True, None, S), "window96": (True, 96, S),
         "window200": (True, 200, S), "cross": (False, None, 2 * S)}


def _rule():
    """The Pallas dK/dV whole-block skip, as its source states it."""
    src = textwrap.dedent(inspect.getsource(jflash.make_bwd_dkv_kernel))
    lines = src.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.strip() == "live = jnp.bool_(True)")
    end = next(i for i in range(start, len(lines))
               if lines[i].strip() == "@pl.when(live)")
    return compile(textwrap.dedent("\n".join(lines[start:end])),
                   "make_bwd_dkv_kernel", "exec")


RULE = _rule()


def _pallas_live_q(degree, gapped, bq, bkv, causal, window, sk, ki):
    """The q blocks the reference's rule keeps for kv program ``ki``."""
    live = set()
    for qi in range(S // bq):
        env = dict(jnp=jnp, causal=causal, window=window, gapped=gapped,
                   ki=ki, qi=qi, bq=bq, bkv=bkv, c=degree, skg=sk // degree,
                   cols_per_prog=degree * bkv)
        exec(RULE, env)
        if bool(env["live"]):
            live.add(qi)
    return live


def _dkv_cases():
    for label in LABELS:
        degree = resolve(label).degree
        for bq in (32, 64, 128):
            for bkv in (16, 32, 64, 128):
                if tflash.takes(128, degree, bq, bkv, kv_axis=True):
                    for mask in MASKS:
                        yield label, bq, bkv, mask


DKV_CASES = list(_dkv_cases())


def test_dkv_cases_cover_every_program_height_and_tile():
    rows = {resolve(c[0]).degree * c[2] for c in DKV_CASES}
    assert rows == {64, 128, 256}
    assert {tflash.dkv_q_tile(c[1]) for c in DKV_CASES} == {32, 64}
    assert len(DKV_CASES) > 100


@pytest.mark.parametrize("case", DKV_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_dkv_walk_against_the_reference_masks(case):
    label, bq, bkv, mask = case
    cfg = resolve(label)
    gapped = cfg.kind == KIND_GAPPED
    causal, window, sk = MASKS[mask]
    rows_per = cfg.degree * bkv
    qt = tflash.dkv_q_tile(bq)
    assert bq % qt == 0
    walk = tflash.dkv_walk(S, sk, cfg.degree, gapped, bq, bkv, qt, causal,
                           window)
    allowed = tref._flash_mask(S, sk, causal, window, "cpu").numpy()
    assert [p.program for p in walk] == list(range(sk // rows_per))
    covered = set()
    for prog in walk:
        cols = np.array(prog.cols)
        assert len(cols) == rows_per and (np.diff(cols) > 0).all()
        covered.update(prog.cols)
        loaded = np.zeros(S, dtype=bool)
        for q0, kinds in prog.tiles:
            assert q0 % qt == 0 and not loaded[q0:q0 + qt].any()
            loaded[q0:q0 + qt] = True
            assert len(kinds) == rows_per // 64
            for w, kind in enumerate(kinds):
                pairs = allowed[q0:q0 + qt, cols[64 * w:64 * (w + 1)]]
                assert kind == ("full" if pairs.all() else "edge")
        # every allowed pair of the program's kv rows lies in a loaded tile
        assert not allowed[~loaded][:, cols].any()
        # the loaded q blocks are the Pallas rule's, each loaded whole
        blocks = loaded.reshape(S // bq, bq)
        assert (blocks.all(1) | ~blocks.any(1)).all()
        assert set(np.flatnonzero(blocks.all(1))) == _pallas_live_q(
            cfg.degree, gapped, bq, bkv, causal, window, sk, prog.program)
    assert covered == set(range(sk))
    # launch positions: a permutation, heaviest first under causal masking
    order = sorted(walk, key=lambda p: p.position)
    assert [p.position for p in order] == list(range(len(walk)))
    if causal and window is None:
        loads = [len(p.tiles) for p in order]
        assert loads == sorted(loads, reverse=True)


def _dq_cases():
    for label in LABELS:
        degree = resolve(label).degree
        for bq in (32, 64, 128):
            for bkv in (64, 128):
                for d in (128, 256):
                    rows = degree * bq
                    if not tflash.takes(d, degree, bq, bkv, kv_axis=False):
                        continue
                    # the forward's walk tests cover the forward's tiles
                    if tflash.dq_kv_tile(d) == tflash.fwd_kv_tile(d, rows):
                        continue
                    for mask in MASKS:
                        yield label, bq, bkv, d, mask


DQ_CASES = list(_dq_cases())


def test_dq_cases_reach_the_tiles_the_forward_does_not():
    assert {(c[3], tflash.dq_kv_tile(c[3])) for c in DQ_CASES} \
        == {(128, 64), (256, 32)}


@pytest.mark.parametrize("case", DQ_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_dq_walk_against_the_reference_masks(case):
    label, bq, bkv, d, mask = case
    cfg = resolve(label)
    gapped = cfg.kind == KIND_GAPPED
    causal, window, sk = MASKS[mask]
    rows_per = cfg.degree * bq
    kt = tflash.dq_kv_tile(d)
    assert bkv % kt == 0
    walk = tflash.fwd_walk(S, sk, cfg.degree, gapped, bq, bkv, kt, causal,
                           window)
    allowed = tref._flash_mask(S, sk, causal, window, "cpu").numpy()
    for prog in walk:
        rows = np.array(prog.rows)
        loaded = np.zeros(sk, dtype=bool)
        for c0, kinds in prog.tiles:
            assert c0 % kt == 0 and not loaded[c0:c0 + kt].any()
            loaded[c0:c0 + kt] = True
            for w, kind in enumerate(kinds):
                pairs = allowed[rows[64 * w:64 * (w + 1)], c0:c0 + kt]
                assert kind == ("full" if pairs.all() else "edge")
        assert not allowed[rows][:, ~loaded].any()
        blocks = loaded.reshape(sk // bkv, bkv)
        assert (blocks.all(1) | ~blocks.any(1)).all()
        live = {ki for ki in range(sk // bkv) if bool(
            jflash._q_axis_mask_live(prog.program, ki, c=cfg.degree, bq=bq,
                                     bkv=bkv, sg=S // cfg.degree,
                                     gapped=gapped, causal=causal,
                                     window=window)[1])}
        assert set(np.flatnonzero(blocks.all(1))) == live
    if causal:
        order = sorted(walk, key=lambda p: p.position)
        assert [p.program for p in order] == list(range(len(walk)))[::-1]


# -- the cluster plan ----------------------------------------------------------

@pytest.mark.parametrize("group", range(1, 41))
def test_cluster_size_is_the_largest_divisor_up_to_16(group):
    cl = tflash.dkv_cluster(group)
    assert group % cl == 0 and 1 <= cl <= tflash.MAX_CLUSTER
    assert not any(group % c == 0 for c in range(cl + 1, min(group, 16) + 1))
    if group <= 16:
        assert cl == group


@pytest.mark.parametrize("h,hkv,cl", [
    (16, 8, 2), (4, 1, 4), (10, 1, 10), (8, 8, 1), (16, 1, 16),
    (32, 1, 16), (40, 2, 10), (17, 1, 1), (36, 2, 9)])
def test_clusters_hold_each_group_in_rank_order(h, hkv, cl):
    """Each cluster's q heads belong to one kv head's group, in ascending
    order (the order of the sum); a group of more than 16 heads splits into
    group / cluster clusters, which the wrapper sums."""
    plan = tflash.dkv_clusters(h, hkv)
    group = h // hkv
    assert len(plan) == hkv * (group // cl)
    heads = [hh for _, _, hs in plan for hh in hs]
    assert sorted(heads) == list(range(h))
    for kvh, gi, hs in plan:
        assert len(hs) == cl
        assert hs == tuple(range(kvh * group + gi * cl,
                                 kvh * group + (gi + 1) * cl))
        assert all(hh // group == kvh for hh in hs)


@pytest.mark.parametrize("h,hkv", [(16, 8), (4, 1), (10, 1), (32, 1)])
@pytest.mark.parametrize("rows,rb", [(128, 128), (256, 128), (128, 64)])
def test_kernel_block_order_forms_the_clusters(h, hkv, rows, rb):
    """The dK/dV kernel's launch order (`flash_dkv_ws`: position, part,
    batch, kv head, cluster, rank) puts each cluster's q heads in
    consecutive blocks, and every (kv program, part, batch, q head) in one
    block."""
    b, sk = 2, 1024
    cl = tflash.dkv_cluster(h // hkv)
    ng, parts, nprog = h // hkv // cl, rows // rb, sk // rows
    grid = (sk // rb) * b * h
    planes = grid // cl // (nprog * parts)
    seen, clusters = set(), {}
    for x in range(grid):
        rank, unit, plane = x % cl, x // cl // planes, x // cl % planes
        ki, part = unit // parts, unit % parts
        gi, kvh, bb = plane % ng, plane // ng % hkv, plane // ng // hkv
        hh = kvh * (h // hkv) + gi * cl + rank
        seen.add((ki, part, bb, hh))
        clusters.setdefault(x // cl, []).append((kvh, gi, hh))
    assert len(seen) == grid == nprog * parts * b * h
    plan = {(kvh, gi): hs for kvh, gi, hs in tflash.dkv_clusters(h, hkv)}
    for members in clusters.values():
        kvh, gi = members[0][:2]
        assert tuple(m[2] for m in members) == plan[(kvh, gi)]


# -- the prep pass -------------------------------------------------------------

@pytest.mark.parametrize("d", (16, 64, 128, 256))
def test_prep_plain_version_matches_the_reference_line(d):
    rng = np.random.default_rng(d)
    o = rng.normal(size=(2, 3, 40, d)).astype(np.float32)
    g = (rng.normal(size=(2, 3, 40, d)) * 10.0 ** rng.uniform(
        -3, 3, size=(2, 3, 40, 1))).astype(np.float32)
    do, delta = tref.flash_bwd_prep(torch.from_numpy(o), torch.from_numpy(g))
    want = np.asarray(jnp.sum(jnp.asarray(g) * jnp.asarray(o), axis=-1))
    assert delta.dtype == torch.float32 and delta.shape == want.shape
    bound = 2 * d * 2.0 ** -24 * np.abs(g * o).sum(-1)
    assert (np.abs(delta.numpy() - want) <= bound).all()
    want_do = np.asarray(jnp.asarray(g).astype(jnp.bfloat16))
    assert do.dtype == torch.bfloat16 and do.shape == g.shape
    np.testing.assert_array_equal(do.view(torch.int16).numpy(),
                                  want_do.view(np.int16))

