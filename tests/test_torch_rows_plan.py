"""The rows kernel's walk on the CPU: `decode_attention.rows_program`, the
Python mirror of `rows_kernel` (``csrc/decode_attention.cu``: contiguous
decode, row 3, and verify, row 4), held against the reference's split-KV
programs, whose live rule and segment maps are executed here from the
reference's own source lines.

For every label of `chip_smoke.py`'s ``DEC_LABELS`` at its shapes
(contiguous S 1024 in kv blocks of 128 at T 1; verify through 64 pages of
16 rows at T 1 and T 5), with and without a window: every kv row that some
query row's mask allows is staged exactly once, by a live split; a split
is live exactly when the reference's program is; gapped segments are the
reference's strided ones; no staged row lies at or past S or outside the
slot's pages; a block's tiles take its ring's stages in turn; the merge
reads the live splits in split order.  A float32 model of the kernel's
order of operations, run on the program, shows that masked tiles and
splits add exact zeros: T rows give the bits of T calls of one row.
"""
from __future__ import annotations

import math
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.kernels.decode_attention as jdec
from repro_torch.core.coarsening import CoarseningConfig
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ref

LABELS = ("base", "con2", "con4", "gap2", "gap4")
WINDOWS = (None, 100)
CONTIG = dict(s=1024, bkv=128)
VERIFY = dict(ps=16, npp=64)
POSITIONS = (0, 1, 15, 16, 100, 127, 128, 300, 511, 575, 1000)

_SRC = Path(jdec.__file__).read_text().splitlines()


def _ref_code(first: int, last: int, starts: str):
    """Lines ``first..last`` of the reference's decode_attention.py,
    compiled (their first line must start with ``starts``)."""
    lines = _SRC[first - 1:last]
    assert lines[0].strip().startswith(starts), lines[0]
    return compile(textwrap.dedent("\n".join(lines)),
                   f"{jdec.__file__}:{first}", "exec")


CONTIG_LIVE = _ref_code(91, 99, "if gapped:")        # make_kernel
CONTIG_START = _ref_code(116, 117, "start =")
VERIFY_PAGE = _ref_code(422, 423, "def logical_page")  # make_verify_kernel
VERIFY_LIVE = _ref_code(433, 443, "if gapped:")


def _run(code, **env):
    exec(code, env)
    return env


def _ref_contig(si, j, *, c, gapped, pos, window):
    s, bkv = CONTIG["s"], CONTIG["bkv"]
    live = _run(CONTIG_LIVE, si=si, bkv=bkv, c=c, gapped=gapped, pos=pos,
                window=window, sg=s // c)["live"]
    start = _run(CONTIG_START, si=si, j=j, bkv=bkv, c=c, gapped=gapped,
                 sg=s // c)["start"]
    return bool(live), start // bkv


def _ref_verify(si, j, *, c, gapped, pos0, t, window):
    ps, npp = VERIFY["ps"], VERIFY["npp"]
    env = _run(VERIFY_PAGE, seg=npp // c, gapped=gapped, c=c)
    live = _run(VERIFY_LIVE, si=si, ps=ps, c=c, seg=npp // c, gapped=gapped,
                pos0=pos0, t=t, window=window)["live"]
    return bool(live), env["logical_page"](si, j)


def _allowed(pos0: int, t: int, window, n_rows: int) -> set:
    """kv rows some query row's mask allows (row t' at pos0 + t')."""
    out = set()
    for tq in range(t):
        p = pos0 + tq
        lo = -1 if window is None else p - window
        out.update(range(max(lo + 1, 0), min(p, n_rows - 1) + 1))
    return out


def _check(prog, *, c, nseg, seg, ref_of, allowed):
    n_rows, ln = nseg * seg, prog.launch
    assert ln.stages <= dec.MAX_STAGES and ln.tile_rows in (16, 32)
    assert ln.blocks <= dec.MAX_BLOCKS
    assert ln.blocks * ln.per_block == nseg // c
    staged, walks = [], {}
    for sp in prog.splits:
        assert sp.block == sp.si % ln.blocks
        want_live = set()
        for j, lseg in enumerate(sp.segments):
            live, ref_seg = ref_of(sp.si, j)
            assert lseg == ref_seg                  # the reference's segment
            want_live.add(live)
        assert want_live == {sp.live}               # the reference's rule
        if not sp.live:
            assert sp.tiles == ()
        for tile in sp.tiles:
            assert tile.seg in sp.segments
            assert 1 <= tile.rows <= ln.tile_rows
            assert tile.seg * seg <= tile.row0
            assert tile.row0 + tile.rows <= (tile.seg + 1) * seg <= n_rows
            staged += range(tile.row0, tile.row0 + tile.rows)
        walks.setdefault(sp.block, []).extend(sp.tiles)
    for walk in walks.values():                     # a ring a block
        assert [tile.stage for tile in walk] == [
            i % ln.stages for i in range(len(walk))]
    assert len(staged) == len(set(staged))          # each row at most once
    assert allowed <= set(staged)                   # every allowed row
    assert prog.merge == tuple(sp.si for sp in prog.splits if sp.live)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("label", LABELS)
def test_contiguous_walk(label, window):
    cfg = CoarseningConfig.parse(label)
    c, gapped = cfg.degree, cfg.kind == "gapped"
    s, bkv = CONTIG["s"], CONTIG["bkv"]
    for pos in POSITIONS + (s + 6, s + 200):       # inactive slots too
        prog = dec.rows_program(pos, t=1, seg=bkv, nseg=s // bkv, c=c,
                                gapped=gapped, window=window, g=2)
        _check(prog, c=c, nseg=s // bkv, seg=bkv,
               ref_of=lambda si, j: _ref_contig(si, j, c=c, gapped=gapped,
                                                pos=pos, window=window),
               allowed=_allowed(pos, 1, window, s))


@pytest.mark.parametrize("t", (1, 5))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("label", LABELS)
def test_verify_walk(label, window, t):
    cfg = CoarseningConfig.parse(label)
    c, gapped = cfg.degree, cfg.kind == "gapped"
    ps, npp = VERIFY["ps"], VERIFY["npp"]
    for pos0 in POSITIONS:
        prog = dec.rows_program(pos0, t=t, seg=ps, nseg=npp, c=c,
                                gapped=gapped, window=window, g=2)
        _check(prog, c=c, nseg=npp, seg=ps,
               ref_of=lambda si, j: _ref_verify(si, j, c=c, gapped=gapped,
                                                pos0=pos0, t=t,
                                                window=window),
               allowed=_allowed(pos0, t, window, npp * ps))


@pytest.mark.parametrize("t,g,d,seg,elem,takes", [
    (5, 2, 128, 16, 2, True),       # qwen3-0.6b verify at --spec-k 4
    (1, 2, 128, 128, 1, True),      # its contiguous decode, int8 cache
    (5, 7, 128, 16, 2, True),       # yi-34b, qwen2-vl-7b: T*G 35
    (5, 10, 256, 16, 2, True),      # recurrentgemma-2b: T*G 50 at D 256
    (1, 64, 256, 128, 2, True),     # the most rows at the widest head
    (5, 13, 128, 16, 2, False),     # T*G 65
    (1, 2, 288, 128, 2, False),     # D past 256
    (1, 2, 48, 128, 2, False),      # D not a multiple of 32
])
def test_rows_takes(t, g, d, seg, elem, takes):
    assert dec.rows_takes(t, g, d, seg, elem) is takes
    if takes:                       # a 64-page table in splits of 4
        ln = dec.rows_launch(t * g, d, seg, 64, 4, elem)
        assert 2 <= ln.stages <= dec.MAX_STAGES
        assert ln.blocks * ln.per_block == 16 and ln.smem <= dec.ROWS_SMEM


def _model(q, k, v, pos0, prog, *, g, window, scale):
    """A float32 model of `rows_kernel` for one (slot, kv head): q (T*G, D)
    t-major, k / v (rows, D) in logical order.  Per split the tiles in
    walk order, per row the masked scores, the online softmax with exact
    zeros for masked entries, P.V kv row by kv row; then the merge of the
    live splits in split order."""
    f = np.float32
    rr, d = q.shape

    def partial(sp):
        m = np.full(rr, -1e30, f)
        l = np.zeros(rr, f)
        acc = np.zeros((rr, d), f)
        for tile in sp.tiles:
            cols = np.arange(tile.row0, tile.row0 + tile.rows)
            # elementwise products, one sum per score: no row's bits
            # depend on another's
            s = (q[:, None, :] * k[cols][None]).sum(-1, dtype=f) * f(scale)
            rp = pos0 + np.arange(rr) // g
            ok = cols[None, :] <= rp[:, None]
            if window:
                ok &= cols[None, :] > rp[:, None] - window
            s = np.where(ok, s, f(-1e30))
            mn = np.maximum(m, s.max(1))
            alpha = np.exp(m - mn).astype(f)
            p = np.where(s <= f(-5e29), f(0), np.exp(s - mn[:, None]))
            l = l * alpha + p.sum(1, dtype=f)
            acc = acc * alpha[:, None]
            for j in range(len(cols)):
                acc = acc + p[:, j:j + 1] * v[cols[j]][None, :]
            m = mn
        return m, l, acc

    parts = {sp.si: partial(sp) for sp in prog.splits if sp.live}
    if not parts:
        return np.zeros((rr, d), f)
    ms = np.stack([parts[s][0] for s in prog.merge])
    mm = ms.max(0)
    lt, o = np.zeros(rr, f), np.zeros((rr, d), f)
    for s in prog.merge:
        m, l, acc = parts[s]
        w = np.where(m <= f(-5e29), f(0), np.exp(m - mm)).astype(f)
        lt = lt + l * w
        o = o + acc * w[:, None]
    return o / np.where(lt == 0, f(1), lt)[:, None]


@pytest.mark.parametrize("window", (None, 6))
@pytest.mark.parametrize("label", LABELS)
def test_model_rows_are_independent(label, window):
    """The kernel's order of operations on the program: within the plain
    version's limit, and T rows equal T calls of one row bit for bit."""
    cfg = CoarseningConfig.parse(label)
    c, gapped = cfg.degree, cfg.kind == "gapped"
    rng = np.random.default_rng(7)
    t, g, d, ps, npp, pos0 = 3, 2, 32, 4, 8, 13
    q = rng.standard_normal((t * g, d)).astype(np.float32)
    k = rng.standard_normal((npp * ps, d)).astype(np.float32)
    v = rng.standard_normal((npp * ps, d)).astype(np.float32)
    scale = 1 / math.sqrt(d)

    def run(qr, p0, tt):
        prog = dec.rows_program(p0, t=tt, seg=ps, nseg=npp, c=c,
                                gapped=gapped, window=window, g=g, d=d)
        return _model(qr, k, v, p0, prog, g=g, window=window, scale=scale)

    whole = run(q, pos0, t)
    rows = np.concatenate([run(q[i * g:(i + 1) * g], pos0 + i, 1)
                           for i in range(t)])
    assert np.array_equal(whole, rows)
    kp = torch.from_numpy(k.reshape(npp, ps, 1, d))
    vp = torch.from_numpy(v.reshape(npp, ps, 1, d))
    bt = torch.arange(npp, dtype=torch.int32)[None]
    want = ref.verify_split_kv(
        torch.from_numpy(q.reshape(1, t, g, d)), kp, vp, bt,
        torch.tensor([pos0], dtype=torch.int32), degree=c, gapped=gapped,
        window=window, scale=scale)
    np.testing.assert_allclose(whole, want.reshape(t * g, d).numpy(),
                               rtol=0, atol=1e-5)
