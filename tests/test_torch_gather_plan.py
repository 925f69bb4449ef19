"""The plans of the two gather kernels, on the CPU: row 14's split of a
program into consecutive thread blocks (`embed_gather.split_plan`) and
row 16's walk and window decisions (`gather_stream.walk`, which emulates
`csrc/stream.cu` `gather_window_kernel` decision for decision).

Row 14: every row of every program in exactly one block, each block's
rows owned by its program as `stream_owners(plan_stream(...))` says, the
grid at least four blocks an SM at the tuner's qwen3-0.6b spec.  Row 16, at
N 2^16 for every label of the paper's sweeps, on `make_indices` at
locality 4096, fully random, and locality 4096 with every 997th id
replaced by a random table entry: every element served once, by the block
that owns its program; every staged lookup inside its staged span; the
span inside the shared-memory budget; every base and conN program staged
at locality 4096 and none at fully random; the output computed along the
walk equal to `ref.gather_stream` bit for bit.

Pure Python: nothing here builds or launches a kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.bench import common as bench
from repro_torch.bench import gather_ab
from repro_torch.core.coarsening import (CoarseningConfig, plan_stream,
                                         stream_owners)
from repro_torch.kernels import _build, ref
from repro_torch.kernels import embed_gather as eg
from repro_torch.kernels import gather_stream as gs

SMS = 132
N16, TABLE, LOCALITY, AI = 1 << 16, 1 << 14, 4096, 6


# -- row 14 -------------------------------------------------------------------

def _split_owners(n: int, cfg: CoarseningConfig, sp) -> torch.Tensor:
    """(N,) the program each stream position is written by, from the
    split's blocks (each position's count of writers must be one)."""
    plan = plan_stream(n, cfg, block=eg.BLOCK)
    c, b, g = cfg.degree, plan.block, plan.grid
    owner = torch.full((n,), -1, dtype=torch.int64)
    writes = torch.zeros(n, dtype=torch.int64)
    for x in range(sp.grid):
        i, s = divmod(x, sp.per_program)
        r = torch.arange(s * sp.rows, (s + 1) * sp.rows)
        k, j = r // b, r % b
        pos = (k * g + i) * b + j if not plan.contiguous \
            else (i * c + k) * b + j
        owner[pos] = i
        writes[pos] += 1
    assert torch.equal(writes, torch.ones(n, dtype=torch.int64))
    return owner


@pytest.mark.parametrize("label", gather_ab.EMBED_LABELS)
@pytest.mark.parametrize("n", [8192, 2048, 256])
def test_embed_split_covers_every_row_once(n, label):
    cfg = CoarseningConfig.parse(label)
    rows = cfg.degree * eg.BLOCK
    if n % rows:                    # the plan does not tile: both refuse
        with pytest.raises(ValueError, match="not divisible"):
            eg.split_plan(n, cfg, sms=SMS)
        return
    sp = eg.split_plan(n, cfg, sms=SMS)
    assert sp.programs == plan_stream(n, cfg, block=eg.BLOCK).grid
    assert sp.per_program * sp.rows == rows and sp.rows <= eg.MAX_ROWS
    owner = _split_owners(n, cfg, sp)
    assert torch.equal(owner, stream_owners(plan_stream(n, cfg,
                                                        block=eg.BLOCK)))
    if n == gather_ab.EMBED_SPEC[0]:
        assert sp.grid >= eg.BLOCKS_PER_SM * SMS
        assert sp.grid == 1024 and sp.rows == 8


def test_embed_split_keeps_one_block_a_program_where_the_plan_fills_the_card():
    cfg = CoarseningConfig.parse("con2")
    sp = eg.split_plan(1 << 20, cfg, sms=SMS)
    assert sp.per_program == 1 and sp.grid == (1 << 20) // 512
    # an odd row count falls back to a divisor, and to one row a block
    sp = eg.split_plan(3 * 7, CoarseningConfig(), block=21, sms=SMS)
    assert sp.per_program == 21 and sp.rows == 1


# -- row 16 -------------------------------------------------------------------

def _indices(cell: str) -> np.ndarray:
    if cell == "locality 4096":
        return gs.make_indices(N16, TABLE, LOCALITY, seed=3)
    if cell == "fully random":
        return gs.make_indices(N16, TABLE, TABLE, seed=4)
    idx = gs.make_indices(N16, TABLE, LOCALITY, seed=5)
    rng = np.random.default_rng(6)
    idx[::997] = rng.integers(0, TABLE, size=idx[::997].shape[0])
    return idx


def _tables(n_tables: int = 8):
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.standard_normal(TABLE).astype(np.float32))
            for _ in range(n_tables)]


CELLS = ("locality 4096", "fully random", "locality 4096 with outliers")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("label", bench.labels())
def test_gather_walk(label, cell):
    cfg = CoarseningConfig.parse(label)
    idx = torch.from_numpy(_indices(cell))
    tables = _tables()
    w = gs.walk(idx, len(tables), TABLE, cfg, block=1024, sms=SMS)
    plan = plan_stream(N16, cfg, block=1024)
    assert w.blocks == min(plan.grid, SMS)
    assert plan.block % w.piece == 0 and w.piece % cfg.vector_width == 0
    assert w.piece * w.batch <= gs.BATCH_IDS
    # every element served once, by the block that owns its program
    pos = (w.start[:, None] + torch.arange(w.piece)).reshape(-1)
    assert torch.equal(torch.sort(pos).values, torch.arange(N16))
    owners = stream_owners(plan)
    assert torch.equal(owners[pos], w.program.repeat_interleave(w.piece))
    first = plan.grid * w.block // w.blocks
    last = plan.grid * (w.block + 1) // w.blocks
    assert bool(((w.program >= first) & (w.program < last)).all())
    # each block walks its programs in order
    for blk in range(w.blocks):
        progs = w.program[w.block == blk]
        assert bool((progs[1:] >= progs[:-1]).all())
    # every staged lookup inside its staged span, the span in the budget
    staged = w.base >= 0
    ids = idx.long().view(-1, w.piece)[w.start // w.piece]
    off = ids - w.base[:, None]
    assert bool((off[staged] >= 0).all())
    assert bool((off[staged] < w.count[staged][:, None]).all())
    assert bool((w.count <= w.window).all()) and bool(
        (w.base[staged] % 4 == 0).all())
    assert gs.smem_bytes(len(tables)) + gs.STATIC_SMEM <= _build.MAX_SMEM
    assert bool(w.restaged[staged].any() or not staged.any())
    # the paths the issue fixes per cell
    if cell == "locality 4096" and cfg.vector_width == 1 \
            and cfg.kind != "gapped":
        assert bool(w.staged.all()), f"{label}: a program read directly"
    if cell == "fully random":
        assert not bool(w.staged.any())
    # the output along the walk equals the plain version bit for bit
    got = gs.emulate(idx, tables, w, ai=AI)
    want = ref.gather_stream(tables, idx, ai=AI)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gather_walk_reuses_one_span_a_run():
    """At locality 4096 on 8 SMs (8 base programs a block): the four
    programs of a 4096-run share one staged span, so base and con4 stage
    at most once a run (less where two runs' windows overlap within the
    window); gap4's consecutive rows lie in different runs and restage
    most of the time (the window lost, F2)."""
    idx = torch.from_numpy(_indices("locality 4096"))
    restages = {lab: int(gs.walk(idx, 8, TABLE, lab, block=1024,
                                 sms=8).restaged.sum())
                for lab in ("base", "con4", "gap4")}
    runs = N16 // LOCALITY
    assert 0 < restages["base"] <= runs and 0 < restages["con4"] <= runs
    assert restages["gap4"] >= 2 * max(restages["base"], restages["con4"])


def test_gather_walk_mixes_paths_on_outliers():
    idx = torch.from_numpy(_indices("locality 4096 with outliers"))
    staged = gs.walk(idx, 8, TABLE, "base", block=1024, sms=SMS).staged
    assert 0.0 < float(staged.float().mean()) < 1.0


def test_gather_window_sizes():
    assert gs.window_entries(8) == 4352 and gs.window_entries(1) == 34816
    assert all(gs.smem_bytes(n) + gs.STATIC_SMEM <= _build.MAX_SMEM
               for n in range(1, gs.MAX_TABLES + 1))
    assert gs.piece_size(1024, 1) == 1024
    assert gs.piece_size(8192, 8) == 1024
    assert gs.piece_size(256, 1) == 256
    assert gs.piece_size(3 * 1024, 4) == 1024
    assert gs.piece_size(1536, 1) == 768


def test_gather_paths_on_the_cpu_are_the_walks():
    idx = torch.from_numpy(_indices("locality 4096 with outliers"))
    tables = _tables(3)
    got = gs.gather_stream(idx, tables, "con2", paths=True)
    want = gs.walk(idx, 3, TABLE, "con2", block=1024).staged.float()
    assert torch.equal(got, want)


def test_gather_ab_lists_the_plans_on_the_cpu(capsys):
    gather_ab.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for lab in gather_ab.EMBED_LABELS:
        assert f"row14,{lab}," in out
    for lab in bench.labels():
        assert f"row16,{lab}," in out
