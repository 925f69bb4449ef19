"""The dequant-fused matmul's K split (`repro_torch.kernels.matmul.split_plan`),
pure Python: the plan the wrapper hands the CUDA kernel, on a card of 132
SMs (the H100 SXM) and of 114 (the H100 PCIe).

Every K row lies in exactly one slice; slices are whole K steps and, for
int4, whole scale groups; the grid fills the card at the shared-expert
and qwen3-0.6b FFN shapes; consecutive and gapped coarsening get the same
plan; a plan is a function of its arguments.
"""
import pytest

from repro_torch.bench import qmm_splits
from repro_torch.kernels import matmul as mm

SMS = (132, 114)
# (m, k, n): qwen2-moe-a2.7b's shared-expert FFN at a prefill chunk of 128
# rows (gate / up, down), qwen3-0.6b's FFN (up, down), and others the
# reference's tile rule admits
FFN = [(128, 2048, 5632), (128, 5632, 2048), (128, 1024, 3072),
       (128, 3072, 1024)]
OTHER = [(256, 2048, 5632), (256, 1024, 1024), (1024, 2048, 5632),
         (128, 256, 128), (512, 8192, 256)]
# (bits, group): int8 per column, int4 in every group the kernel takes
FORMATS = [(8, 0), (4, 16), (4, 32), (4, 64), (4, 128), (4, 256)]
LABELS = ("base", "con2", "gap2")


def _cases(shapes):
    for m, k, n in shapes:
        for label in LABELS:
            if m % (128 * (2 if label != "base" else 1)):
                continue
            for bits, group in FORMATS:
                if mm.quant_tileable(m, n, k, mm.resolve(label), bits,
                                     group):
                    yield (m, k, n), label, bits, group


CASES = list(_cases(FFN + OTHER))


def _id(case):
    (m, k, n), label, bits, group = case
    return f"{m}x{k}x{n}-{label}-int{bits}" + (f"g{group}" if group else "")


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_slices_cover_k_once_on_whole_steps_and_groups(case, sms):
    (m, k, n), label, bits, group = case
    plan = mm.split_plan(m, n, k, label, bits, group, sms)
    bounds = plan.bounds(k)
    assert len(bounds) == plan.splits == plan.grid[0]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0                            # no gap, no overlap
    for k0, k1 in bounds:
        assert k1 > k0                             # no empty slice
        assert k0 % mm.Q_KSTEP == 0 and k1 % mm.Q_KSTEP == 0
        if bits == 4:
            assert k0 % group == 0 and k1 % group == 0
    covered = [0] * k
    for k0, k1 in bounds:
        for r in range(k0, k1):
            covered[r] += 1
    assert covered == [1] * k


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_grid_matches_the_kernel_limits(case, sms):
    """The grid is (slices, n / 64, m / (degree*128)); at most 16 slices
    (a cluster), and more than a portable cluster's 8 only where 8 would
    leave SMs idle."""
    (m, k, n), label, bits, group = case
    c = mm.resolve(label).degree
    plan = mm.split_plan(m, n, k, label, bits, group, sms)
    assert plan.grid == (plan.splits, n // mm.Q_WN, m // (c * mm.Q_BM))
    assert 1 <= plan.splits <= mm.Q_MAX_SPLITS
    if plan.splits > mm.Q_PORTABLE_SPLITS:
        assert plan.blocks // plan.splits * mm.Q_PORTABLE_SPLITS < sms
    assert plan.unit == (max(mm.Q_KSTEP, group) if bits == 4
                         else mm.Q_KSTEP)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("bits,group", [(8, 0), (4, 32)])
@pytest.mark.parametrize("shape", FFN, ids=str)
def test_grid_fills_the_card_at_the_ffn_shapes(shape, bits, group, sms):
    m, k, n = shape
    plan = mm.split_plan(m, n, k, "base", bits, group, sms)
    assert plan.blocks >= sms
    # and stays within one wave of three blocks an SM
    assert plan.blocks <= 3 * sms


def test_shared_expert_plans_at_132_sms():
    """The plans the H100 runs at the shared-expert FFN (the numbers in
    PERF.md): gate and up 4 slices (352 blocks), down 8 (256), int8 and
    int4 alike."""
    got = {(bits, k): (p.splits, p.blocks)
           for bits, group in [(8, 0), (4, 32)]
           for m, k, n in FFN[:2]
           for p in [mm.split_plan(m, n, k, "base", bits, group, 132)]}
    assert got == {(8, 2048): (4, 352), (8, 5632): (8, 256),
                   (4, 2048): (4, 352), (4, 5632): (8, 256)}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "con2"],
                         ids=_id)
def test_con_and_gap_share_one_plan(case, sms):
    (m, k, n), _, bits, group = case
    con = mm.split_plan(m, n, k, "con2", bits, group, sms)
    gap = mm.split_plan(m, n, k, "gap2", bits, group, sms)
    assert con == gap
    assert con.bounds(k) == gap.bounds(k)


@pytest.mark.parametrize("case", CASES[::7], ids=_id)
def test_plan_is_deterministic(case):
    (m, k, n), label, bits, group = case
    plans = {mm.split_plan(m, n, k, label, bits, group, 132)
             for _ in range(3)}
    assert len(plans) == 1
    cfg = mm.resolve(label)
    assert mm.split_plan(m, n, k, cfg, bits, group, 132) in plans


def test_more_sms_never_fewer_blocks():
    for (m, k, n), label, bits, group in CASES:
        small = mm.split_plan(m, n, k, label, bits, group, 114)
        big = mm.split_plan(m, n, k, label, bits, group, 132)
        assert big.blocks >= small.blocks


def test_split_sweep_lists_every_split_and_marks_the_plan(capsys):
    """`repro_torch.bench.qmm_splits` on the CPU: a row for every split
    count each product takes, one of them the plan's, and no time."""
    qmm_splits.main(["--device", "cpu"])
    rows = [r for r in capsys.readouterr().out.splitlines()
            if not r.startswith("#")]
    assert rows and all(r.endswith(",-") for r in rows)
    for bits, group in [(8, 0), (4, 32)]:
        for m, k, n in qmm_splits.PRODUCTS:
            name = f"int{bits} {m}x{k}x{n} "
            mine = [r for r in rows if r.startswith(name)]
            plan = mm.split_plan(m, n, k, "base", bits, group, 132)
            assert [r for r in mine if "*" in r] == \
                [f"{name}S={plan.splits}*,-"]
            assert len(mine) == len({s for s in qmm_splits.SPLITS
                                     if s <= k // plan.unit}
                                    | {plan.splits})
