"""The coarsened matmul's K split and box walk, pure Python: the plan the
wrapper hands `csrc/matmul.cu` (`repro_torch.kernels.matmul.mm_split_plan`)
on a card of 132 SMs (the H100 SXM) and of 114 (the H100 PCIe), and the
mirror of the kernel's walk (`mm_program`), built from the module's own
tile constants.

Every K row lies in exactly one slice and slices are whole K steps; the
grid fills the card at qwen3-0.6b's FFN products at a prefill chunk of 128
rows and takes no split at M = 8192; consecutive and gapped coarsening get
the same plan; every output element lies in exactly one block's tile; a
consecutive program stages its rows as one box a stage, a gapped program
as C boxes whose rows are the reference's gapped view's
(`a.reshape(c, m // c, k)`); the weight is staged once a stage for all C
row blocks; a split's stages cover its slice.
"""
import numpy as np
import pytest

from repro_torch.core.coarsening import (KIND_CONSECUTIVE, KIND_GAPPED,
                                         CoarseningConfig)
from repro_torch.kernels import matmul as mm

SMS = (132, 114)
# (m, k, n): qwen3-0.6b's FFN (hf:Qwen/Qwen3-0.6B, d 1024, d_ff 3072) at
# a prefill chunk of T = 128 rows (gate = up, down), at the tuner's key
# M = 8192, and at M = 1024; one K with k % 64 == 32
FFN = [(128, 1024, 3072), (128, 3072, 1024)]
BIG = [(8192, 1024, 3072), (8192, 3072, 1024)]
SHAPES = FFN + BIG + [(1024, 1024, 3072), (128, 1056, 1024)]


def _labels():
    for kind in (KIND_CONSECUTIVE, KIND_GAPPED):
        for c in (1, 2, 4):
            for vw in (1, 2, 4):
                if (kind == KIND_GAPPED and c == 1     # = consecutive
                        or c * vw > mm.MAX_TILE_PRODUCT):
                    continue
                yield CoarseningConfig(kind, c, 1, vw).label


LABELS = list(_labels())
CASES = [(shape, label) for shape in SHAPES for label in LABELS
         if mm.tileable(shape[0], shape[2], shape[1], mm.resolve(label))]


def _id(case):
    (m, k, n), label = case
    return f"{m}x{k}x{n}-{label}"


def test_every_label_is_a_case():
    """The shapes take every label the kernel has an instance for."""
    assert len(LABELS) == 9
    assert {label for _, label in CASES} == set(LABELS)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_slices_cover_k_once_on_whole_steps(case, sms):
    (m, k, n), label = case
    plan = mm.mm_split_plan(m, n, k, label, sms)
    bounds = plan.bounds(k)
    assert plan.unit == mm.MM_KSTEP
    assert len(bounds) == plan.splits == plan.grid[0]
    assert 1 <= plan.splits <= mm.MAX_SPLITS
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    for (_, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0                            # no gap, no overlap
    for k0, k1 in bounds:
        assert k1 > k0                             # no empty slice
        assert k0 % mm.MM_KSTEP == 0
        assert k1 % mm.MM_KSTEP == 0 or k1 == k
    covered = np.zeros(k, np.int64)
    for k0, k1 in bounds:
        covered[k0:k1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_grid_matches_the_kernel_tiles(case, sms):
    """The grid is (slices, n / (64 vector_width), m / (64 degree)); more
    than a portable cluster's 8 slices only where 8 would leave SMs idle."""
    (m, k, n), label = case
    cfg = mm.resolve(label)
    plan = mm.mm_split_plan(m, n, k, cfg, sms)
    assert plan.grid == (plan.splits, n // (mm.BN * cfg.vector_width),
                         m // (mm.BM * cfg.degree))
    if plan.splits > mm.PORTABLE_SPLITS:
        assert plan.blocks // plan.splits * mm.PORTABLE_SPLITS < sms


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("label", ["base", "con2", "gap2", "simd2"])
@pytest.mark.parametrize("shape", FFN, ids=str)
def test_grid_fills_the_card_at_the_ffn_shapes(shape, label, sms):
    """As many slices as keep to one block an SM: one slice more would put
    a second block on some SM (or break a cap: a portable cluster, four K
    steps a slice)."""
    m, k, n = shape
    plan = mm.mm_split_plan(m, n, k, label, sms)
    tiles = plan.blocks // plan.splits
    assert plan.blocks <= sms
    assert (tiles * (plan.splits + 1) > sms
            or plan.splits == mm.PORTABLE_SPLITS
            or k // (plan.splits + 1) < mm.MIN_STEPS * mm.MM_KSTEP)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", [c for c in CASES if c[0] in BIG], ids=_id)
def test_no_split_at_the_tuner_key(case, sms):
    (m, k, n), label = case
    assert mm.mm_split_plan(m, n, k, label, sms).splits == 1


def test_ffn_plans_at_132_sms():
    """The plans the H100 runs at base (the numbers in PERF.md)."""
    got = {(m, k, n): (p.splits, p.blocks) for m, k, n in FFN + BIG
           for p in [mm.mm_split_plan(m, n, k, "base", 132)]}
    assert got == {(128, 1024, 3072): (1, 96), (128, 3072, 1024): (4, 128),
                   (8192, 1024, 3072): (1, 6144),
                   (8192, 3072, 1024): (1, 2048)}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[1].startswith("con")], ids=_id)
def test_con_and_gap_share_one_plan(case, sms):
    (m, k, n), label = case
    gap = label.replace("con", "gap")
    assert mm.mm_split_plan(m, n, k, label, sms) == \
        mm.mm_split_plan(m, n, k, gap, sms)


def test_more_sms_never_fewer_blocks():
    for (m, k, n), label in CASES:
        small = mm.mm_split_plan(m, n, k, label, 114)
        big = mm.mm_split_plan(m, n, k, label, 132)
        assert big.blocks >= small.blocks


def _gapped_view_rows(m, c, i):
    """Global rows of program i's C row blocks in the reference's gapped
    view `a.reshape(c, m // c, k)` (`repro/kernels/matmul.py:31-33`)."""
    view = np.arange(m).reshape(c, m // c)
    return [view[b, i * mm.BM:(i + 1) * mm.BM].tolist() for b in range(c)]


def _blocks(plan, every):
    s_, j_, i_ = plan.grid
    blocks = [(s, j, i) for s in range(s_) for j in range(j_)
              for i in range(i_)]
    return blocks if every else blocks[:s_ * 3] + blocks[-s_ * 3:]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_each_output_element_in_one_tile(case):
    """Over the grid's tiles (slice 0; every slice owns the same tile),
    every (row, column) of the output lies in exactly one block's tile."""
    (m, k, n), label = case
    plan = mm.mm_split_plan(m, n, k, label, 132)
    count = np.zeros((m, n), np.int8)
    for j in range(plan.grid[1]):
        for i in range(plan.grid[2]):
            prog = mm.mm_program(m, n, k, label, plan, (0, j, i))
            assert len(prog.rows) == len(set(prog.rows))
            for s in range(1, plan.splits):
                other = mm.mm_program(m, n, k, label, plan, (s, j, i))
                assert (other.rows, other.cols) == (prog.rows, prog.cols)
            rows = np.asarray(prog.rows)
            count[rows[:, None], np.arange(prog.cols.start,
                                           prog.cols.stop)[None, :]] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_box_walk(case):
    """Each stage: a consecutive program's C*64 rows as one box, a gapped
    program's as C boxes of 64 rows M/C apart holding the reference's
    gapped view's rows; the weight's vector_width boxes of 64 columns once
    a stage, over the program's columns; the stages walk the slice's K rows
    in whole steps.  At M = 8192 the first and last blocks of the grid."""
    (m, k, n), label = case
    cfg = mm.resolve(label)
    c, vw = cfg.degree, cfg.vector_width
    gapped = c > 1 and cfg.kind == KIND_GAPPED
    plan = mm.mm_split_plan(m, n, k, cfg, 132)
    bounds = plan.bounds(k)
    for s, j, i in _blocks(plan, every=m < 8192):
        prog = mm.mm_program(m, n, k, cfg, plan, (s, j, i))
        if gapped:
            want = _gapped_view_rows(m, c, i)
        else:
            r0 = i * c * mm.BM
            want = [list(range(r0 + b * mm.BM, r0 + (b + 1) * mm.BM))
                    for b in range(c)]
        assert list(prog.rows) == [r for block in want for r in block]
        k0, k1 = bounds[s]
        steps = [w[0].y for _, w in prog.stages]
        assert steps == list(range(k0, k1, mm.MM_KSTEP))
        for a_boxes, w_boxes in prog.stages:
            kk = w_boxes[0].y
            if gapped:
                assert len(a_boxes) == c
                for b, box in enumerate(a_boxes):
                    assert (box.x, box.w, box.h) == (kk, mm.MM_KSTEP, mm.BM)
                    assert list(range(box.y, box.y + box.h)) == want[b]
                assert [box.y - a_boxes[0].y for box in a_boxes] == \
                    [b * (m // c) for b in range(c)]
            else:
                assert a_boxes == (mm.Box(kk, want[0][0], mm.MM_KSTEP,
                                          c * mm.BM),)
            assert len(w_boxes) == vw
            cols = [x for box in w_boxes for x in range(box.x, box.x + box.w)]
            assert cols == list(prog.cols)
            assert all((box.y, box.h) == (kk, mm.MM_KSTEP)
                       for box in w_boxes)
            assert all(box.w == mm.BN for box in w_boxes)


def test_tail_step_reaches_past_k():
    """k % 64 == 32: the last slice's last stage reaches 32 rows past K
    (TMA fills them with zeros), and no slice starts past K."""
    m, k, n = 128, 1056, 1024
    plan = mm.mm_split_plan(m, n, k, "base", 132)
    last = mm.mm_program(m, n, k, "base", plan, (plan.splits - 1, 0, 0))
    a_boxes, w_boxes = last.stages[-1]
    assert a_boxes[0].x + a_boxes[0].w == k + 32
    assert w_boxes[0].y + w_boxes[0].h == k + 32
    assert all(k0 < k for k0, _ in plan.bounds(k))


def test_split_sweep_lists_every_split_and_marks_the_plan(capsys):
    """`repro_torch.bench.mm_splits` on the CPU: a row for every split
    count each product takes under each label, one of them the plan's, and
    no time."""
    from repro_torch.bench import mm_splits
    mm_splits.main(["--device", "cpu"])
    rows = [r for r in capsys.readouterr().out.splitlines()
            if not r.startswith("#")]
    assert rows and all(r.endswith(",-") for r in rows)
    for label in mm_splits.LABELS:
        for m, k, n in mm_splits.PRODUCTS:
            name = f"{label} {m}x{k}x{n} "
            mine = [r for r in rows if r.startswith(name)]
            plan = mm.mm_split_plan(m, n, k, label, 132)
            assert [r for r in mine if "*" in r] == \
                [f"{name}S={plan.splits}*,-"]
            assert len(mine) == len({s for s in mm_splits.SPLITS
                                     if s <= -(-k // mm.MM_KSTEP)}
                                    | {plan.splits})


# -- the decode and verify steps' route (`step_plan`) --------------------------

def _step_products(arch):
    """(name, n, k) of a decode step's products (q, k and v, o, gate and up,
    down, the head) at ``arch``'s published widths."""
    from repro_torch.configs import get_config
    c = get_config(arch)
    return [("q", c.n_heads * c.hd, c.d_model),
            ("kv", c.n_kv_heads * c.hd, c.d_model),
            ("o", c.d_model, c.n_heads * c.hd), ("gate", c.d_ff, c.d_model),
            ("down", c.d_model, c.d_ff), ("head", c.vocab_padded, c.d_model)]


STEP_CASES = [(arch, *p) for arch in ("qwen3-0.6b", "gemma3-1b")
              for p in _step_products(arch)]


@pytest.mark.parametrize("arch,name,n,k", STEP_CASES,
                         ids=[f"{a}-{p}" for a, p, _, _ in STEP_CASES])
def test_step_plan_is_one_plan_for_every_row_count(arch, name, n, k):
    """The steps' K split is the plan of ONE 64-row tile for every M in
    1..128 at 132 SMs: the same slices (so every row's sums run in one
    order whatever the rows), ceil(M / 64) row tiles, the column tiles
    covering N; the kernel takes each product at base for any M."""
    assert mm.step_takes(n, k)
    one = mm.mm_split_plan(mm.BM, -(-n // mm.BN) * mm.BN, k, "base", 132)
    for m in range(1, 129):
        plan = mm.step_plan(m, n, k, 132)
        assert (plan.splits, plan.unit) == (one.splits, one.unit)
        assert plan.grid == (one.splits, -(-n // mm.BN), -(-m // mm.BM))
        assert plan.bounds(k) == one.bounds(k)
        assert plan.blocks <= one.blocks * -(-m // mm.BM)
