"""Grouped-expert MoE FFN, bf16 and dequant-fused: the wrappers of the CUDA
kernels in ``csrc/moe_ffn.cu`` (bf16, replacing `repro/kernels/moe_ffn.py`
`make_kernel`) and ``csrc/quant_moe_ffn.cu`` (packed int8 / int4 panes,
replacing `make_qkernel`).

The bf16 kernel is two launches of one blocked tensor-core tile
(``csrc/gemm_tile.cuh``): per (F tile, expert group) h = silu(x@w1) *
(x@w3), then per (d tile, expert group) y = (h @ w2) * comb.  The
dequant-fused kernel is two persistent launches on a TMA ring of packed
expert tiles with `wgmma` (the widened weight as its register operand,
the expert's live rows as its N side); `plan` sizes its ring in bytes.  A
block owns ``degree`` experts, adjacent (consecutive) or E/degree apart
(gapped).  Experts and 16-row tiles whose combine weights are all 0 read no
weight byte.  Bound on the H100: the live experts' weight bytes (plus x,
comb and y) at 3.35 TB/s.

On CPU tensors the wrappers compute the plain versions (`ref.moe_ffn`,
`ref.quant_moe_ffn`); on CUDA tensors they launch the kernels or raise.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         resolve)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import sm_count
from repro_torch.quant.qtypes import QTensor

TILE_N, TILE_K = 64, 32            # the bf16 kernel's column and depth tiles

launches = 0                       # bf16 kernel launches since the last reset
q_launches = 0                     # dequant-fused launches since the reset


def takes(d: int, f: int, bits: int | None = None, group: int = 0) -> bool:
    """Whether the kernels take widths d and F (tiles of 64 columns) and,
    for packed weights, ``bits``-bit values (int4 in groups of ``group``
    rows, tiling d and F, a multiple of 16)."""
    if d % TILE_N or f % TILE_N:
        return False
    return bits != 4 or (group > 0 and group % 16 == 0 and d % group == 0
                         and f % group == 0)


def _check(xe, w1, w3, w2, comb, cfg: CoarseningConfig):
    e, c, d = xe.shape
    f = w1.shape[-1]
    if tuple(w1.shape) != (e, d, f) or tuple(w3.shape) != (e, d, f) \
            or tuple(w2.shape) != (e, f, d) or tuple(comb.shape) != (e, c):
        raise ValueError(
            f"moe_ffn shapes: xe {tuple(xe.shape)}, w1 {tuple(w1.shape)}, "
            f"w3 {tuple(w3.shape)}, w2 {tuple(w2.shape)}, comb "
            f"{tuple(comb.shape)}")
    if e % cfg.degree:
        raise ValueError(f"experts {e} not tileable by degree {cfg.degree}")
    return e, c, d, f


def _cuda_checks(what, tensors, d, f, bits=None, group=0):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} operands must share one CUDA device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous, 16-byte aligned "
                         f"operands")
    if not takes(d, f, bits, group):
        raise ValueError(f"{what} kernel takes d and F multiples of "
                         f"{TILE_N} (and int4 groups multiples of 16 that "
                         f"tile both), got d={d}, F={f}, group={group}")
    return dev


# -- the dequant-fused kernel's plan (`csrc/quant_moe_ffn.cu`) ----------------

Q_BK = 128                         # K rows a stage (int4's pass A: 256)
Q_WN = 64                          # weight columns a consumer warpgroup
Q_TILE = 16                        # rows of a staged x / h tile
Q_CHUNK = Q_TILE * 64 * 2          # its 64 columns: one swizzled block
Q_NT_MAX = 4                       # live tiles a chunk: 64 rows
Q_MAX_STAGES = 32
Q_SMEM = 227 * 1024                # one block an SM
Q_XCHG = Q_NT_MAX * Q_TILE // 2 * 128 * 4   # pass A's exchange of sums
Q_HDR = 32                         # bytes of a stage header (+ 2 mbarriers)
SMS = 132                          # the H100 SXM's SMs
# packed weight bytes each SM keeps in flight, at least (the stages other
# than the one being multiplied): ~25 B/ns an SM over ~1 us of latency
INFLIGHT_MIN = 32 * 1024


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """One pass of the dequant-fused kernel: pass A (h = silu(x@w1) *
    (x@w3), K = d, N = F, 64 columns an item, w1 and w3 as its two weight
    streams) or pass B (y = (h@w2) * comb, K = F, N = d, 128 columns an
    item, w2's two 64-column halves).  An item is (expert group, column
    tile); ``blocks`` persistent blocks take items in turn.  A stage holds
    ``bk`` K rows of both streams' packed tiles (``w_bytes`` each), up to
    ``nt_cap`` live row tiles of ``tile_bytes`` (the stage's 64-column
    chunks of x, or of h's two bf16 planes) and, at int4, ``srows`` scale
    rows of each stream."""
    k: int
    n: int
    bk: int
    cols: int
    col_tiles: int
    items: int
    blocks: int
    w_bytes: int
    tile_bytes: int
    srows: int
    nt_cap: int
    stage_bytes: int
    stages: int
    smem: int

    @property
    def args(self) -> tuple:
        """The C entry's ints for this pass."""
        return (self.blocks, self.stage_bytes, self.stages, self.srows,
                self.nt_cap)

    @property
    def inflight(self) -> int:
        """Packed weight bytes in flight an SM while one stage is
        multiplied (one block an SM)."""
        return (self.stages - 1) * 2 * self.w_bytes


def stage_rows(bits: int, pass_a: bool) -> int:
    """K rows a stage: 256 for int4's pass A (its weight boxes then hold 8
    KB, as int8's do at 128), else 128."""
    return 2 * Q_BK if bits == 4 and pass_a else Q_BK


def scale_rows(k: int, group: int, bk: int = Q_BK) -> int:
    """The most int4 scale rows (groups) one stage of bk K rows overlaps."""
    return max((kk + bk - 1) // group - kk // group + 1
               for kk in range(0, k, bk))


def stage_groups(kk: int, group: int, bk: int = Q_BK) -> range:
    """The scale rows (groups) of the stage at K row kk: the rows its TMA
    box starts at, in order."""
    return range(kk // group, (kk + bk - 1) // group + 1)


@functools.lru_cache(maxsize=256)
def plan(bits: int, group: int, e: int, c: int, d: int, f: int,
         degree: int = 1, sms: int = SMS) -> tuple:
    """(pass A, pass B) of the dequant-fused kernel at these widths: as many
    stages as one block's 227 KB hold at the stage's bytes, at most
    ``Q_MAX_STAGES``."""
    nt_cap = min(Q_NT_MAX, -(-c // Q_TILE))
    out = []
    for k, n, cols, planes, xchg in ((d, f, Q_WN, 1, Q_XCHG),
                                     (f, d, 2 * Q_WN, 2, 0)):
        bk = stage_rows(bits, planes == 1)
        w_bytes = (bk if bits == 8 else bk // 2) * Q_WN
        srows = scale_rows(k, group, bk) if bits == 4 else 0
        tile_bytes = bk // 64 * planes * Q_CHUNK
        need = 2 * w_bytes + nt_cap * tile_bytes + 2 * srows * Q_WN * 4
        stage = -(-need // 1024) * 1024
        room = Q_SMEM - 1024 - xchg - Q_MAX_STAGES * (Q_HDR + 16)
        stages = min(Q_MAX_STAGES, room // stage)
        col_tiles = -(-n // cols)
        items = e // degree * col_tiles
        out.append(PassPlan(k, n, bk, cols, col_tiles, items,
                            min(items, sms),
                            w_bytes, tile_bytes, srows, nt_cap, stage, stages,
                            1024 + stages * stage + xchg
                            + stages * (Q_HDR + 16)))
    return tuple(out)


def item_experts(i: int, e: int, degree: int, gapped: bool) -> list:
    """The experts of expert group i in the block's order, as the Pallas
    index maps cut them (`repro/kernels/moe_ffn.py:174-187`): consecutive
    i*degree + j, gapped j*(E/degree) + i."""
    return [j * (e // degree) + i if gapped else i * degree + j
            for j in range(degree)]


def live_tiles(comb_row, c: int) -> list:
    """The 16-row tiles of one expert with a nonzero combine weight, in
    order (the producer's ballot over ``comb``)."""
    return [t for t in range(-(-c // Q_TILE))
            if any(float(w) != 0.0 for w in comb_row[t * Q_TILE:
                                                     (t + 1) * Q_TILE])]


def chunks(tiles: list, c: int) -> list:
    """The chunks a pass stages for one expert: up to ``Q_NT_MAX`` live
    tiles each, and the product's N (8 where one tile holds at most 8
    rows, else 16 a tile)."""
    out = []
    for q in range(0, len(tiles), Q_NT_MAX):
        ts = tiles[q:q + Q_NT_MAX]
        n = 8 if len(ts) == 1 and c - Q_TILE * ts[0] <= 8 else 16 * len(ts)
        out.append((tuple(ts), n))
    return out


def pass_stages(pp: PassPlan, e: int, degree: int, gapped: bool, comb,
                c: int, bits: int, group: int) -> list:
    """Every stage a pass fills, item by item: (item, expert, the two
    streams' first columns, the K rows, the live tiles, N, the scale rows
    (int4)), the walk `csrc/quant_moe_ffn.cu` `produce` makes whatever block
    takes the item.  K runs in whole stages; a last stage's rows past K
    meet x / h boxes of TMA's zero fill."""
    kpad = -(-pp.k // pp.bk) * pp.bk
    staged = [chunks(live_tiles(comb[ex], c), c) for ex in range(e)]
    out = []
    for item in range(pp.items):
        i, ct = divmod(item, pp.col_tiles)
        n0 = ct * pp.cols
        streams = (n0, n0) if pp.cols == Q_WN else (n0, n0 + Q_WN)
        for ex in item_experts(i, e, degree, gapped):
            for ts, n in staged[ex]:
                for kk in range(0, kpad, pp.bk):
                    out.append((item, ex, streams, range(kk, kk + pp.bk),
                                ts, n, stage_groups(kk, group, pp.bk)
                                if bits == 4 else range(0)))
    return out


def instances() -> list[tuple[str, int, int]]:
    """(name, local bytes a thread, registers) of every instance of the
    dequant-fused kernel, read from the loaded module."""
    return _build.instances("quant_moe_ffn", "quant_moe_ffn_instance")


def moe_ffn(xe, w1, w3, w2, comb, cfg: CoarseningConfig | str = BASE):
    """xe (E,C,d); w1, w3 (E,d,F); w2 (E,F,d); comb (E,C) combine weights
    -> (E,C,d) f32: per expert ``(silu(xe@w1) * (xe@w3)) @ w2 * comb``, h
    rounded once to xe's dtype."""
    global launches
    cfg = resolve(cfg)
    e, c, d, f = _check(xe, w1, w3, w2, comb, cfg)
    if xe.device.type == "cpu":
        return ref.moe_ffn(xe, w1, w3, w2, comb)
    dev = _cuda_checks("moe_ffn", (xe, w1, w3, w2, comb), d, f)
    if any(t.dtype != torch.bfloat16 for t in (xe, w1, w3, w2)) \
            or comb.dtype != torch.float32:
        raise TypeError("moe_ffn kernel takes bf16 xe and weights and f32 "
                        "combine weights")
    h = torch.empty((e, c, f), dtype=torch.bfloat16, device=dev)
    out = torch.empty((e, c, d), dtype=torch.float32, device=dev)
    rc = _build.library("moe_ffn").moe_ffn_bf16(
        xe.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        comb.data_ptr(), h.data_ptr(), out.data_ptr(), e, c, d, f,
        cfg.degree, int(cfg.kind == KIND_GAPPED),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "moe_ffn_bf16")
    launches += 1
    return out


def quant_moe_ffn(xe, qw1: QTensor, qw3: QTensor, qw2: QTensor, comb,
                  cfg: CoarseningConfig | str = BASE):
    """The same chain with packed expert panes (int8: (E,d,F) + (E,1,F)
    scales; int4: (E,d/2,F) nibbles + (E,d/group,F) scales, w2 alike),
    f32 throughout (h is not rounded) -> (E,C,d) f32."""
    global q_launches
    cfg = resolve(cfg)
    e, c, d, f = _check(xe, qw1, qw3, qw2, comb, cfg)
    bits, group = qw1.bits, qw1.group
    if any((w.bits, w.group) != (bits, group) for w in (qw3, qw2)):
        raise ValueError("quant_moe_ffn: w1, w3 and w2 differ in format")
    if bits == 4 and (d % group or f % group or group % 2):
        raise ValueError(f"int4 needs even group tiling d={d} and f={f}, "
                         f"got group={group}")
    if xe.device.type == "cpu":
        return ref.quant_moe_ffn(xe, qw1, qw3, qw2, comb)
    ws = [t for w in (qw1, qw3, qw2) for t in (w.q, w.scale)]
    dev = _cuda_checks("quant_moe_ffn", [xe, *ws, comb], d, f, bits, group)
    if xe.dtype != torch.bfloat16 or comb.dtype != torch.float32:
        raise TypeError("quant_moe_ffn kernel takes bf16 xe and f32 combine "
                        "weights")
    pa, pb = plan(bits, group if bits == 4 else 0, e, c, d, f, cfg.degree,
                  sm_count(dev))
    # the h planes (2, E*C, F) bf16, then the passes' two item counters
    scratch = torch.empty(4 * e * c * f + 16, dtype=torch.uint8, device=dev)
    out = torch.empty((e, c, d), dtype=torch.float32, device=dev)
    rc = _build.library("quant_moe_ffn").quant_moe_ffn(
        xe.data_ptr(), *(t.data_ptr() for t in ws), comb.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), e, c, d, f, bits, group,
        cfg.degree, int(cfg.kind == KIND_GAPPED), *pa.args, *pb.args,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "quant_moe_ffn")
    q_launches += 1
    return out
