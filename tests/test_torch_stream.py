"""The port's paper microbenchmarks against the reference's: the stream and
row plans (fields and element-to-program maps, every label), the index
generator, the four ops (`ew_stream`, `gather_stream`, `stencil5`,
`dp_scan`) against `repro.kernels.ops` in interpret mode at the reference
tests' sizes (`tests/test_kernels.py`), the windowed gather (row 17: its
`make_kernel` against the Pallas one in interpret mode, the host planner,
the staged windows, the refusals and owner maps), and the figure sweeps'
rows.

Every product in these functions is by a power of two and both sides add
in the same order, so the port's plain versions must equal the reference
bit for bit: the tolerance is 0.  Inputs are made with numpy from fixed
seeds and handed to both sides.  No kernel is built here: the CPU tensors
take the plain versions.
"""
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coarsening as JC
from repro.kernels import ew_stream as jew
from repro.kernels import gather_stream as jgs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bench import common as bench
from repro_torch.core import coarsening as TC
from repro_torch.kernels import ew_stream as tew
from repro_torch.kernels import gather_stream as tgs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil as tst
from repro_torch.kernels import windowed_gather as twg

ROOT = Path(__file__).resolve().parents[1]
LABELS = bench.labels() + ["gap2+pipe4", "gap4+simd2"]


def _both(spec):
    return JC.CoarseningConfig.parse(spec), TC.CoarseningConfig.parse(spec)


def _streams(seed, n, k):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


# -- plans --------------------------------------------------------------------

def _ref_stream_owners(plan) -> np.ndarray:
    """Each element's program under the reference's BlockSpec: program i
    reads block ``index_map(i)`` of ``block_shape`` from the view."""
    view = np.arange(plan.n).reshape(plan.view_shape)
    owner = np.full(plan.n, -1)
    for i in range(plan.grid):
        idx = plan.index_map(i)
        sl = tuple(slice(a * s, (a + 1) * s)
                   for a, s in zip(idx, plan.block_shape))
        owner[view[sl].ravel()] = i
    return owner


@pytest.mark.parametrize("spec", LABELS)
@pytest.mark.parametrize("n,block", [(8192, 512), (1 << 16, 1024)])
def test_stream_plan_and_owner_map(spec, n, block):
    jcfg, tcfg = _both(spec)
    jp = JC.plan_stream(n, jcfg, block=block)
    tp = TC.plan_stream(n, tcfg, block=block)
    for f in ("n", "block", "grid", "view_shape", "block_shape",
              "dmas_per_operand", "dma_elems", "contiguous", "tile_shape"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.cfg.label == jp.cfg.label
    owners = TC.stream_owners(tp)
    np.testing.assert_array_equal(owners.numpy(), _ref_stream_owners(jp))
    for i in (0, jp.grid - 1):              # program i's tile ids
        gids = tref._global_ids(tp, i)
        np.testing.assert_array_equal(gids.numpy(),
                                      np.asarray(jew._global_ids(jp, i)))
        assert bool((owners[gids] == i).all())
    # replication: the reference's (R, G/R) grid remaps (p, i) to p*inner+i
    r = jcfg.replication
    split = r > 1 and jp.grid % r == 0
    assert TC.replicated(tp) == split
    if split:
        inner = jp.grid // r
        assert [TC.flat_pid(tp, p, i) for p in range(r)
                for i in range(inner)] == list(range(jp.grid))


def test_stream_plan_rejects_what_does_not_tile():
    for mod in (JC, TC):
        with pytest.raises(ValueError, match="not divisible"):
            mod.plan_stream(3000, mod.CoarseningConfig.parse("con4"),
                            block=512)


@pytest.mark.parametrize("spec", LABELS)
@pytest.mark.parametrize("rows,block_rows", [(128, 8), (512, 16)])
def test_row_plan_and_owner_map(spec, rows, block_rows):
    jcfg, tcfg = _both(spec)
    jp = JC.plan_rows(rows, jcfg, block_rows)
    tp = TC.plan_rows(rows, tcfg, block_rows)
    for f in ("rows", "block_rows", "grid", "fused_rows", "stride_blocks",
              "dmas_per_operand", "contiguous"):
        assert getattr(tp, f) == getattr(jp, f), f
    owner = np.full(rows, -1)
    for i in range(jp.grid):
        assert TC.row_starts(tp, i) == JC.row_starts(jp, i)
        for s in JC.row_starts(jp, i):
            owner[s * block_rows:(s + 1) * block_rows] = i
    np.testing.assert_array_equal(TC.row_owners(tp).numpy(), owner)


@pytest.mark.parametrize("seed", [0, 1, 3])
@pytest.mark.parametrize("n,table,window", [(4096, 2048, 64),
                                            (4096, 2048, 2048),
                                            (5000, 1 << 14, 4096)])
def test_make_indices_equal_for_a_seed(seed, n, table, window):
    np.testing.assert_array_equal(
        tgs.make_indices(n, table, window, seed=seed),
        jgs.make_indices(n, table, window, seed=seed))


# -- the ops against the reference's Pallas kernels (interpret mode) ----------

@pytest.mark.parametrize("variant", tref.VARIANTS)
def test_ew_stream_matches_the_reference(variant):
    xs = _streams(10, 8192, 8)
    want = jref.ew_stream([jnp.asarray(x) for x in xs], ai=6,
                          variant=variant)
    got_plain = tref.ew_stream([torch.from_numpy(x) for x in xs], ai=6,
                               variant=variant)
    _bits_equal(got_plain, want)
    for spec in ("base", "con2", "gap2", "con2+simd2", "pipe2"):
        jcfg, tcfg = _both(spec)
        want = jops.ew_stream(tuple(jnp.asarray(x) for x in xs), jcfg, ai=6,
                              variant=variant, block=512)
        got = tops.ew_stream([torch.from_numpy(x) for x in xs], tcfg, ai=6,
                             variant=variant, block=512)
        _bits_equal(got, want)


@pytest.mark.parametrize("ai,n_loads", [(1, 4), (10, 3)])
def test_ew_stream_other_intensities_and_widths(ai, n_loads):
    xs = _streams(11, 2048, n_loads)
    for variant in ("base", "div4", "for_in_if_in"):
        want = jref.ew_stream([jnp.asarray(x) for x in xs], ai=ai,
                              variant=variant)
        got = tops.ew_stream([torch.from_numpy(x) for x in xs], "gap4",
                             ai=ai, variant=variant, block=128)
        _bits_equal(got, want)


def test_ew_stream_rejects_bad_arguments():
    xs = [torch.zeros(4096)]
    with pytest.raises(ValueError, match="variant"):
        tops.ew_stream(xs, "base", variant="bogus")
    with pytest.raises(ValueError, match="two streams"):
        tops.ew_stream(xs, "base", variant="for_in_if_in")
    with pytest.raises(ValueError, match="not divisible"):
        tops.ew_stream(xs, "con8", block=1024)
    with pytest.raises(ValueError, match="1 to 8"):
        tops.ew_stream(xs * 9, "base")


@pytest.mark.parametrize("window", [64, 2048])
def test_gather_stream_matches_the_reference(window):
    n, table = 4096, 2048
    idx = jgs.make_indices(n, table, window, seed=3)
    tables = _streams(12, table, 4)
    want = jref.gather_stream([jnp.asarray(t) for t in tables],
                              jnp.asarray(idx), ai=6)
    _bits_equal(tref.gather_stream([torch.from_numpy(t) for t in tables],
                                   torch.from_numpy(idx), ai=6), want)
    for spec in ("base", "con2", "gap4", "con2+simd2"):
        jcfg, tcfg = _both(spec)
        want = jops.gather_stream(jnp.asarray(idx),
                                  tuple(jnp.asarray(t) for t in tables),
                                  jcfg, ai=6, block=256)
        got = tops.gather_stream(torch.from_numpy(idx),
                                 [torch.from_numpy(t) for t in tables],
                                 tcfg, ai=6, block=256)
        _bits_equal(got, want)


@pytest.mark.parametrize("spec", bench.labels())
def test_stencil5_matches_both_reference_forms(spec):
    """The reference's Pallas kernel (vertical halo as shifted copies) and
    its oracle (edge padding) are the same function; the port's one plain
    version equals both."""
    x = np.random.default_rng(13).standard_normal((128, 256)) \
        .astype(np.float32)
    jcfg, tcfg = _both(spec)
    got = tops.stencil5(torch.from_numpy(x), tcfg, block_rows=8)
    _bits_equal(got, jops.stencil5(jnp.asarray(x), jcfg, block_rows=8))
    _bits_equal(got, jref.stencil5(jnp.asarray(x)))


@pytest.mark.parametrize("spec", ["base", "con2", "con4"])
def test_dp_scan_matches_the_reference(spec):
    cost = np.random.default_rng(14).random((64, 256)).astype(np.float32)
    jcfg, tcfg = _both(spec)
    got = tops.dp_scan(torch.from_numpy(cost), tcfg)
    _bits_equal(got, jops.dp_scan(jnp.asarray(cost), jcfg))
    _bits_equal(got, jref.dp_scan(jnp.asarray(cost)))


def test_dp_scan_rejects_gapped():
    for cfg in ("gap2", "gap4"):
        with pytest.raises(ValueError, match="gapped"):
            tops.dp_scan(torch.ones(8, 256), cfg)
    with pytest.raises(ValueError, match="gapped"):
        jops.dp_scan(jnp.ones((8, 256)), JC.CoarseningConfig.parse("gap2"))


def test_probe_owner_maps_on_the_cpu():
    """On CPU tensors ``probe=True`` returns the plan's own map (the card's
    kernels are held against the same map in `chip_smoke.py`)."""
    cfg = TC.CoarseningConfig.parse("gap4")
    xs = [torch.zeros(8192)]
    plan = TC.plan_stream(8192, cfg, block=512)
    assert torch.equal(tew.ew_stream(xs, cfg, block=512, probe=True),
                       TC.stream_owners(plan).float())
    owners = tst.stencil5(torch.zeros(64, 32), cfg, probe=True)
    assert torch.equal(owners[:, 0],
                       TC.row_owners(TC.plan_rows(64, cfg, 8)).float())


# -- row 17: the windowed gather ----------------------------------------------

WG_N = 1 << 13


def _wg_inputs(n, table, window, seed=7):
    idx = jgs.make_indices(n, table, window, seed=seed)
    tbl = np.random.default_rng(seed + 1).standard_normal(table) \
        .astype(np.float32)
    return idx, tbl


def _reference_planner(run):
    """The reference's host planner, a local of its `make_kernel`
    (`repro/kernels/windowed_gather.py:87`), read off `run`'s closure."""
    cells = dict(zip(run.__code__.co_freevars, run.__closure__))
    return cells["plan_bases"].cell_contents


def _staged(run, idx, tbl, window):
    """The card kernel's reads, emulated: each (program, slice) stages rows
    clamp(base) and clamp(base + 1) of the (T/L, L) view and reads each id
    at its offset from base * L, clamped into the 2L window."""
    plan, bases = run.plan, run.plan_bases(idx)
    rows = tbl.reshape(-1, window)
    view = idx.reshape(plan.view_shape)
    out = np.empty(view.shape, np.float32)
    for i in range(plan.grid):
        for k in range(plan.cfg.degree):
            at = (i, k) if plan.contiguous else (k, i)
            r0, r1 = (np.clip(bases[i, k] + d, 0, rows.shape[0] - 1)
                      for d in (0, 1))
            win = np.concatenate([rows[r0], rows[r1]])
            local = np.clip(view[at] - bases[i, k] * window, 0,
                            2 * window - 1)
            out[at] = win[local]
    return out.reshape(-1)


WG_LABELS = ["none", "con2", "con4", "gap2", "gap4"]
WG_MORE = ["pipe8", "con4+pipe2", "con2+simd2", "simd4"]


@pytest.mark.parametrize("spec,window,block",
                         [(s, 1024, 256) for s in WG_LABELS + WG_MORE]
                         + [(s, 512, 512) for s in WG_LABELS])
def test_windowed_gather_matches_the_pallas_kernel(spec, window, block):
    """`tests/test_kernels.py:217-230` and more labels, bit for bit; the
    port's planner equals the reference's, and the windows the card's
    kernel stages hold every id of their slice."""
    from repro.kernels import windowed_gather as jwg
    jcfg, tcfg = _both(spec)
    idx, tbl = _wg_inputs(WG_N, WG_N, window)
    jrun = jwg.make_kernel(WG_N, WG_N, jcfg, window=window, block=block)
    want = np.asarray(jrun(jnp.asarray(idx), jnp.asarray(tbl)))
    run = twg.make_kernel(WG_N, WG_N, tcfg, window=window, block=block)
    _bits_equal(run(torch.from_numpy(idx), torch.from_numpy(tbl)), want)
    np.testing.assert_array_equal(run.plan_bases(idx),
                                  _reference_planner(jrun)(idx))
    # row 16's gather with one table is the same function, unwindowed
    _bits_equal(tref.gather_stream([torch.from_numpy(tbl)],
                                   torch.from_numpy(idx), ai=6), want)
    np.testing.assert_array_equal(_staged(run, idx, tbl, window),
                                  tbl[idx])


def test_windowed_gather_plain_version_matches_the_reference():
    from repro.kernels import windowed_gather as jwg
    idx, tbl = _wg_inputs(4096, 2048, 64, seed=9)
    for ai in (1, 6, 10):
        _bits_equal(tref.windowed_gather(torch.from_numpy(idx),
                                         torch.from_numpy(tbl), ai),
                    jwg.ref(jnp.asarray(idx), jnp.asarray(tbl), ai))


def test_windowed_gather_table_equal_to_window():
    """The reference's planner gives base row -1 here (n_rows - 2); its
    clamped block index reads the right rows, and so do the port's clamped
    window rows."""
    from repro.kernels import windowed_gather as jwg
    n, table, window = 4096, 1024, 1024
    idx, tbl = _wg_inputs(n, table, window)
    for spec in ("none", "con2", "gap2"):
        jcfg, tcfg = _both(spec)
        jrun = jwg.make_kernel(n, table, jcfg, window=window, block=256)
        want = np.asarray(jrun(jnp.asarray(idx), jnp.asarray(tbl)))
        run = twg.make_kernel(n, table, tcfg, window=window, block=256)
        assert (run.plan_bases(idx) == -1).all()
        np.testing.assert_array_equal(run.plan_bases(idx),
                                      _reference_planner(jrun)(idx))
        _bits_equal(run(torch.from_numpy(idx), torch.from_numpy(tbl)), want)
        np.testing.assert_array_equal(_staged(run, idx, tbl, window),
                                      tbl[idx])


def test_windowed_gather_rejects_bad_geometry():
    """`tests/test_kernels.py:232-236` on both sides."""
    from repro.kernels import windowed_gather as jwg
    with pytest.raises(ValueError):
        jwg.make_kernel(1 << 12, 1 << 12, JC.CoarseningConfig(), window=100,
                        block=256)
    with pytest.raises(ValueError, match="block <= window"):
        twg.make_kernel(1 << 12, 1 << 12, TC.CoarseningConfig(), window=100,
                        block=256)


@pytest.mark.parametrize("spec", ["simd8", "con2+simd8", "gap2+simd8"])
def test_windowed_gather_refuses_a_slice_longer_than_the_window(spec):
    """simd8 at window 1024, block 256: slices of 2048 ids span two
    locality runs, which the reference computes wrongly (ROADMAP, faults of
    the reference); the port refuses at `make_kernel`, before any launch."""
    before = twg.launches
    with pytest.raises(ValueError, match="must divide the window"):
        twg.make_kernel(1 << 14, 1 << 14, spec, window=1024, block=256)
    assert twg.launches == before


def test_windowed_gather_refuses_a_window_it_cannot_stage():
    n = table = 1 << 16
    assert twg.takes(1 << 14) and not twg.takes(1 << 15)
    run = twg.make_kernel(n, table, "base", window=1 << 15, block=256)
    before = twg.launches
    with pytest.raises(ValueError, match="shared memory"):
        run(torch.empty(n, dtype=torch.int32, device="meta"),
            torch.empty(table, device="meta"))
    assert twg.launches == before


@pytest.mark.parametrize("spec", bench.labels())
def test_windowed_gather_probe_owner_map(spec):
    """``probe=True`` on the CPU is the plan's map, which is the
    reference plan's BlockSpec map, for every label the port takes."""
    jcfg, tcfg = _both(spec)
    n, window, block = 1 << 14, 4096, 512
    idx, tbl = _wg_inputs(n, n, window)
    run = twg.make_kernel(n, n, tcfg, window=window, block=block)
    got = run(torch.from_numpy(idx), torch.from_numpy(tbl), probe=True)
    np.testing.assert_array_equal(
        got.numpy(), _ref_stream_owners(JC.plan_stream(n, jcfg, block)))


# -- the figure sweeps --------------------------------------------------------

FIGS = ["fig8_apps", "fig10_mem_divergence", "fig11_ai", "fig13_divdeg"]


def _reference_names(fig: str, monkeypatch) -> set:
    """The row names the reference's sweep emits (its timed calls stubbed
    out: only the names are compared)."""
    monkeypatch.syspath_prepend(str(ROOT))
    mod = importlib.import_module(f"benchmarks.{fig}")
    names = []
    monkeypatch.setattr(mod, "wall_us", lambda *a, **k: -1.0)
    monkeypatch.setattr(mod, "emit", lambda name, *a, **k: names.append(name))
    mod.main()
    return set(names)


@pytest.mark.parametrize("fig", FIGS)
def test_figure_sweep_rows_on_the_cpu(fig, monkeypatch, capsys):
    """``main(["--device", "cpu"])`` runs the plain versions at the
    reference's sizes and prints one row per label and app, a superset of
    the reference's rows (it prints the family's best degree only)."""
    want = _reference_names(fig, monkeypatch)
    capsys.readouterr()
    rows = importlib.import_module(f"repro_torch.bench.{fig}").main(
        ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    printed = [line for line in out if line.startswith("fig")]
    names = [r["name"] for r in rows]
    assert len(printed) == len(names) == len(set(names))
    assert all(line.startswith(name + ",")
               for line, name in zip(printed, names))
    assert want <= set(names), sorted(want - set(names))
    for r in rows:
        assert r["ms"] is None or (r["ms"] > 0 and r["speedup"] > 0)
    assert "host wall time" in out[0]
