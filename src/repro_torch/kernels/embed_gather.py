"""Coarsened embedding gather: the wrapper of ``embed_gather`` in
``csrc/embed_gather.cu`` (it replaces `repro/kernels/embed_gather.py`
`make_kernel`).

``out[i, :] = table[ids[i], :]`` as float32, for ids (N,) int32 and a
(V, d) float32 or bf16 table.  The id stream is planned as the reference
plans it, `plan_stream(N, cfg, block=256)`: a program owns C id blocks,
adjacent (consecutive) or G*256 ids apart (gapped); the tuner offers
vector width 1 only, so the labels are base, con2/4/8 and gap2/4/8.  On
the card a program runs as S consecutive thread blocks, each taking a
contiguous share of the program's C*256 rows (`split_plan`: S chosen so
that the grid holds at least four blocks an SM); a float32 table's rows
move whole by bulk copies where a block's rows fit 64 KB, otherwise (and
on a bf16 table) each lane stores one 16-byte unit at a time.  Ids out of
range are read as the Pallas body's index reads them: -V <= id < 0 wraps
to id + V, then the index clamps to [0, V-1].
The kernel equals `ref.embed_gather` bit for bit: it moves values and
widens bf16 exactly.  Bound on the H100: (4N + N*d*elem + 4N*d) bytes /
3.35 TB/s.

The model embeds with plain indexing, as the reference's does
(`jnp.take`); the tuner's measurer is this kernel's caller.

On CPU tensors the wrapper computes the plain version; on CUDA tensors it
launches the kernel or raises.  ``probe=True`` returns the owner map: each
output row filled with its program index as float32 (on the CPU, the
plan's `stream_owners`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.coarsening import (BASE, KIND_GAPPED, CoarseningConfig,
                                         plan_stream, resolve, stream_owners)
from repro_torch.kernels import _build, ref
from repro_torch.kernels.matmul import sm_count

BLOCK = 256                         # ids a block of the plan (the reference's)
UNIT = 4                            # the row length must tile by 16 bytes
MAX_ROWS = 1024                     # rows a thread block stages (the kernel's)
BLOCKS_PER_SM = 4                   # the least grid, in blocks an SM

launches = 0                        # kernel launches since the last reset


def takes(d: int) -> bool:
    """Whether the kernel takes rows of ``d`` values (a lane moves 4 values
    a unit: 16 bytes of a float32 row, 8 of a bf16 row)."""
    return d >= UNIT and d % UNIT == 0


@dataclasses.dataclass(frozen=True)
class Split:
    """A program of the plan run as ``per_program`` consecutive thread
    blocks of ``rows`` rows each: block ``i * per_program + s`` takes rows
    ``[s * rows, (s + 1) * rows)`` of program i's C*B rows."""

    programs: int
    per_program: int
    rows: int

    @property
    def grid(self) -> int:
        return self.programs * self.per_program


def split_plan(n: int, cfg: CoarseningConfig, block: int = BLOCK,
               sms: int = 132) -> Split:
    """The fewest blocks a program, S, that divide its C*B rows, fill the
    card with at least ``BLOCKS_PER_SM`` blocks an SM and stage at most
    ``MAX_ROWS`` rows a block; one row a block where no S reaches the
    grid."""
    plan = plan_stream(n, cfg, block=block)
    rows = cfg.degree * plan.block
    want = -(-BLOCKS_PER_SM * sms // plan.grid)
    s = next((s for s in range(1, rows + 1) if rows % s == 0 and s >= want
              and rows // s <= MAX_ROWS), rows)
    return Split(plan.grid, s, rows // s)


def embed_gather(ids: torch.Tensor, table: torch.Tensor,
                 cfg: CoarseningConfig | str = BASE, *, block: int = BLOCK,
                 probe: bool = False) -> torch.Tensor:
    """ids (N,) int32, table (V, d) float32 or bf16 -> (N, d) float32."""
    global launches
    cfg = resolve(cfg)
    if ids.dim() != 1 or table.dim() != 2:
        raise ValueError(f"embed_gather takes (N,) ids and a (V, d) table, "
                         f"got {tuple(ids.shape)} and {tuple(table.shape)}")
    n, (vocab, d) = ids.shape[0], table.shape
    if cfg.vector_width != 1 or cfg.replication != 1:
        raise ValueError(f"embed_gather takes no vector width or "
                         f"replication, got {cfg.label}")
    plan = plan_stream(n, cfg, block=block)
    if ids.device.type == "cpu" and table.device.type == "cpu":
        if probe:
            return stream_owners(plan).float()[:, None].expand(n, d) \
                .contiguous()
        return ref.embed_gather(ids, table)
    if not takes(d):
        raise ValueError(f"embed_gather kernel takes rows of d % {UNIT} == 0 "
                         f"values, got d={d}")
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError("embed_gather operands must share one CUDA device")
    if ids.dtype != torch.int32 or table.dtype not in (torch.float32,
                                                       torch.bfloat16):
        raise TypeError(f"embed_gather kernel takes int32 ids and a float32 "
                        f"or bf16 table, got {ids.dtype}, {table.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (ids, table)):
        raise ValueError("embed_gather kernel takes contiguous, 16-byte "
                         "aligned operands")
    split = split_plan(n, cfg, block, sm_count(table.device))
    out = torch.empty((n, d), dtype=torch.float32, device=table.device)
    rc = _build.library("embed_gather").embed_gather(
        ids.data_ptr(), table.data_ptr(), out.data_ptr(), n, vocab, d,
        int(table.dtype == torch.bfloat16), block, cfg.degree,
        int(cfg.kind == KIND_GAPPED), split.per_program, int(probe),
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(rc, "embed_gather")
    launches += 1
    return out
