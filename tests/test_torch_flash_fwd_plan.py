"""The flash forward kernel's plan, pure Python: what the kernel admits
(`repro_torch.kernels.flash_attention.takes`) and the walk it follows
(`fwd_walk`: each q program's launch position and, in order, the kv tiles
it loads, each full or edge for each consumer warpgroup of 64 rows).

* `takes` answers exactly as it did before the forward's redesign, over
  head dims 32-512, degrees 1-8 and blocks 32-128, on both axes: the tuner
  (`tune/search.py` `kernel_takes`) and the train paths' labels read it.
* The walk, for every label the kernel takes at small geometries (causal,
  causal with a window, and non-causal cross attention), against the
  reference: every allowed (row, col) pair of the exact mask
  (`ref._flash_mask`) lies in a loaded tile; a full tile has no masked
  pair for its warpgroup's rows and an edge tile has one; the loaded kv
  blocks are exactly those the Pallas whole-block rule
  (`repro/kernels/flash_attention.py` `_q_axis_mask_live`) keeps, each
  loaded whole; launch positions are a permutation, heaviest first under
  causal masking.
No kernel is built or launched.
"""
import numpy as np
import pytest

from repro.kernels import flash_attention as jflash
from repro_torch.core.coarsening import KIND_GAPPED, resolve
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref as tref

HEAD_DIMS = (32, 64, 128, 256, 512)
DEGREES = (1, 2, 4, 8)
BLOCKS = (32, 64, 128)


def _took(d, degree, bq, bkv, kv_axis):
    """What the kernels admitted before the forward's redesign."""
    rows = degree * (bkv if kv_axis else bq)
    return (d in (64, 128, 256) and rows in (64, 128, 256)
            and (rows < 256 or d < 256) and bq % 32 == 0
            and bkv % (16 if kv_axis else 64) == 0)


@pytest.mark.parametrize("kv_axis", (False, True), ids=("q_axis", "kv_axis"))
@pytest.mark.parametrize("bkv", BLOCKS)
@pytest.mark.parametrize("bq", BLOCKS)
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_takes_answers_as_before(d, degree, bq, bkv, kv_axis):
    assert tflash.takes(d, degree, bq, bkv, kv_axis=kv_axis) \
        == _took(d, degree, bq, bkv, kv_axis)


def test_takes_admits_as_many_geometries_as_before():
    admitted = [(d, c, bq, bkv, kv) for d in HEAD_DIMS for c in DEGREES
                for bq in BLOCKS for bkv in BLOCKS for kv in (False, True)
                if tflash.takes(d, c, bq, bkv, kv_axis=kv)]
    assert len(admitted) == 105


S = 512
LABELS = ("base", "con2", "gap2", "con4", "gap4", "con8", "gap8")
# (causal, window, Sk): the masks the forward kernel holds
MASKS = {"causal": (True, None, S), "window96": (True, 96, S),
         "window200": (True, 200, S), "cross": (False, None, 2 * S)}


def _cases():
    for label in LABELS:
        degree = resolve(label).degree
        for bq in (32, 64, 128):
            for bkv in (64, 128):
                for d in (64, 128, 256):
                    if tflash.takes(d, degree, bq, bkv, kv_axis=False):
                        for mask in MASKS:
                            yield label, bq, bkv, d, mask


CASES = list(_cases())
_LIVE = {}


def _pallas_live(degree, gapped, bq, bkv, causal, window, sk):
    """{q program: the kv blocks the Pallas whole-block rule keeps}."""
    key = (degree, gapped, bq, bkv, causal, window, sk)
    if key not in _LIVE:
        nprog, nk = S // (degree * bq), sk // bkv
        _LIVE[key] = {
            qi: {ki for ki in range(nk) if bool(jflash._q_axis_mask_live(
                qi, ki, c=degree, bq=bq, bkv=bkv, sg=S // degree,
                gapped=gapped, causal=causal, window=window)[1])}
            for qi in range(nprog)}
    return _LIVE[key]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_walk_against_the_reference_masks(case):
    label, bq, bkv, d, mask = case
    cfg = resolve(label)
    gapped = cfg.kind == KIND_GAPPED
    causal, window, sk = MASKS[mask]
    rows_per = cfg.degree * bq
    kt = tflash.fwd_kv_tile(d, rows_per)
    assert bkv % kt == 0
    walk = tflash.fwd_walk(S, sk, cfg.degree, gapped, bq, bkv, kt, causal,
                           window)
    allowed = tref._flash_mask(S, sk, causal, window, "cpu").numpy()
    live = _pallas_live(cfg.degree, gapped, bq, bkv, causal, window, sk)
    assert [p.program for p in walk] == list(range(S // rows_per))
    covered = set()
    for prog in walk:
        rows = np.array(prog.rows)
        assert len(rows) == rows_per
        covered.update(prog.rows)
        loaded = np.zeros(sk, dtype=bool)
        for c0, kinds in prog.tiles:
            assert c0 % kt == 0 and not loaded[c0:c0 + kt].any()
            loaded[c0:c0 + kt] = True
            assert len(kinds) == rows_per // 64
            for w, kind in enumerate(kinds):
                pairs = allowed[rows[64 * w:64 * (w + 1)], c0:c0 + kt]
                assert kind == ("full" if pairs.all() else "edge")
        # every allowed pair of the program's rows lies in a loaded tile
        assert not allowed[rows][:, ~loaded].any()
        # the loaded blocks are the Pallas rule's, each loaded whole
        blocks = loaded.reshape(sk // bkv, bkv)
        assert (blocks.all(1) | ~blocks.any(1)).all()
        assert set(np.flatnonzero(blocks.all(1))) == live[prog.program]
    assert covered == set(range(S))
    # launch positions: a permutation, heaviest first under causal masking
    order = sorted(walk, key=lambda p: p.position)
    assert [p.position for p in order] == list(range(len(walk)))
    if causal:
        assert [p.program for p in order] == list(range(len(walk)))[::-1]
        if window is None:
            loads = [len(p.tiles) for p in order]
            assert loads == sorted(loads, reverse=True)
    else:
        assert [p.program for p in order] == list(range(len(walk)))


@pytest.mark.parametrize("d", (64, 128, 256))
@pytest.mark.parametrize("rows", (64, 128, 256))
def test_kv_tile_divides_every_kv_block_the_kernel_takes(d, rows):
    kt = tflash.fwd_kv_tile(d, rows)
    assert kt in (32, 64) and 64 % kt == 0
    assert kt == (32 if rows == 256 and d >= 128 else 64)
