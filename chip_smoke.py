"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--phases kernels,tune,serve,...]

With no arguments it runs every phase below; ``--phases`` runs the named
ones (names in ``PHASES``) and the phases they read.  The device and build
phases always run.

Phases, each of which fails the run (non-zero exit, no result line):

1. device — the card's name and power limit; TF32 off for every float32
   product; no CUDA device means exit 1.
2. build  — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and print the build time.
3. kernels — each kernel against its plain PyTorch version on the card at
   its path's full-width shapes, for every coarsening label listed, with
   the stated tolerance; then its time (CUDA events, L2 flushed before each
   launch, median), its plain version's time, one PyTorch library call's
   time and the least time the card could take (``bound_ms``). The
   coarsened matmul under every label it takes at qwen3-0.6b's FFN
   products at T = 128, at M = 1024 and at K = 1056 (k % 64 == 32), each
   case launched twice and bit-equal, with its K split and grid, beside a
   dropped K slice and swapped gapped row blocks that must exceed its
   limit; its instances' local memory (any fails the run); the three
   products timed beside `torch.matmul` and `torch.mm` with float32 out,
   each product with its split, a call's host microseconds, and every
   label at M = 8192. The flash
   kernels (forward, the backward's prep pass, dQ, dK/dV) are held row by
   row (see FLASH_ULPS), causal and with a window of FLASH_WINDOW, and
   plain-version models of a lost kv block, a lost block of the causal
   edge and a kv block lost by the last q block only show that the limits
   catch each, a model of an edge tile read unmasked (the diagonal blocks'
   mask dropped) that every limit catches it (the backward's full tiles
   read across the diagonal), and one of a q head's partial dropped from
   the dK/dV cluster sum that the dk and dv limits catch it; prep's dO
   must equal the cotangent rounded to bf16 and its delta lie within
   PREP_SUMS; every label's forward, dQ and dK/dV are launched twice and
   must give the same bits; each timed forward is also timed without
   residuals beside its instance's registers and spills, every dQ and
   dK/dV instance's registers and local memory are read from the loaded
   module and local memory (a spill) fails the run, and
   prep + dQ + dK/dV are timed together beside SDPA's backward. The same
   kernels at head dim 256 on the gemma3-1b train shape (B 1, H 4/1, S
   4096), causal and with window 512 (base at blocks of 128, con2 and gap2
   at 64), under the same limits and fault models. The forward at eleven
   more geometries (FLASH_GEOMETRIES: every program height at head dims
   64, 128 and 256, gapped 32-row blocks, 64-row kv blocks, windows, and
   non-causal cross attention), and dQ and dK/dV at ten
   (FLASH_BWD_GEOMETRIES: 32-row q tiles, gapped 16-row kv blocks, GQA
   groups of 1 to 32, so clusters of 1, 2, 4, 10 and 16, windows, cross
   attention), each beside the card's room for its cluster. The
   block-sparse flash
   forward on that shape (window 512) for base, con2, gap2, con4 and gap4:
   o against the plain walk of the live index, (m, l) against the dense D
   256 forward's; for five q blocks every K/V row outside that block's live
   set NaN, its rows still held; a plain model of a skipped live slot must
   exceed the limit; base and gap2 again with global columns (stride
   1024); its time beside the dense windowed forward's. Paged decode
   (row 1, the rows kernel at T = 1, verify's call with pos0 = pos) for
   every label, with and without a window, and at recurrentgemma-2b's G 10
   (one kv head, D 256; bf16 and int8 pools, two launches bit-equal). The
   row norm of the decode and verify steps at their shapes (ln over d
   1024, the q and k norms over hd 128; 8 and 40 rows), each element
   within 1 bf16 ulp of its plain version, launched twice bit-equal,
   lane 0's values lost from the sum of squares shown to exceed it, and
   timed beside `F.rms_norm`. The qwen2-moe-a2.7b kernels: the int8-pool paged decode, the grouped-expert
   MoE FFN (capacities 128 and 8), its dequant-fused twin (int8 and int4;
   also on a mixed dispatch, each case launched twice bit-equal, with a
   dropped K stage, a skipped live tile, swapped nibbles and scales a group
   off as fault models, its instances' local memory read from the module)
   and the dequant-fused matmul (int8 and int4), each error printed as a
   ratio of its limit beside a fault model (a lost page of V scales, a lost
   expert, a lost scale, swapped nibbles) that must exceed it; the
   dequant-fused matmul also at qwen3-0.6b's FFN products, each case
   launched twice with bit-equal outputs, and each product timed alone
   beside its K split, grid and the build's registers and spills. The
   contiguous split-KV decode (bf16 and int8 caches, B 8, S 1024, bkv 128,
   one slot at pos S + 6) and the short-q verify (bf16 and int8 pools, T 5,
   page 16) for every label, with and without a window, beside their fault
   models (a lost kv block or page, lost V scales, and for verify row t's
   mask shifted by one), each case launched twice with bit-equal outputs;
   verify at T 5 bit-equal to five calls at T 1 (row t at pos0 + t), also
   at G 7 (D 128) and at G 10 with one kv head (D 256); the rows kernel's
   instances read from the loaded module (any local memory fails), and the
   host time of a call beside SDPA's. The paper's microbenchmark kernels at
   the paper's sizes (64M-element f32 streams, an 8192^2 stencil, a 1024 x
   2^20 DP scan): the streaming kernel under every label and every divergence
   variant at AI 6, the gather (tables of 2^14 at locality 4096, and of
   2^24 fully random), the stencil and the DP scan (base, con2/4/8, gap2
   refused), each bit-equal to its plain version; the stream and stencil
   kernels' owner maps (a probe build stores each element's flat program
   index) equal to the plan's for every label; the DP's rows/C launches a
   call; fault models (a lost sub-block, con and gap swapped, a block's
   first row reading itself as its upper neighbour, the DP carry from row
   t-2) shown to fail the checks.  The embed-gather kernel (row 14) at
   the tuner's qwen3-0.6b spec (8192 ids, a 152064 x 1024 table, float32
   and bf16): every label bit-equal to the plain version (ids past the
   table and below -V clamped, ids in [-V, 0) wrapped), owner maps equal
   to the plan's, a block read from its neighbour and con/gap swapped
   shown to fail the checks; its time beside `F.embedding`'s.  The
   Mamba-2 SSD (row 12) at mamba2-370m's geometry (H 32, P 64, N 128, G 1,
   chunk 64; B 4 x 2048): every label within SSD_K * 2^-24 of the terms'
   magnitude against the float64 plain version, owner maps equal to the
   Pallas index maps, a state reset at every chunk and con/gap swapped
   shown to fail.  The RG-LRU (row 13) at recurrentgemma-2b's width (D
   2560; B 8 x 2048): base, con2/4, gap2/4 within RGLRU_ULPS of each row's
   largest |h|, owner maps, h dropped every block_t steps and con/gap
   swapped shown to fail.  The windowed gather (row 17) at row 16's
   locality cell (N 2^26, table 2^14, window 4096, block 1024) and at a
   2^24 table: every label of the sweep bit-equal (simd8 refused), owner
   maps, a slice reading the next slice's window and con/gap swapped
   shown to fail; its launch timed with bases planned once, beside row
   16's gather with one table on the same ids.
   invariance — each op of a full-width qwen3-0.6b decode step on 8 rows
   alone and on the same 8 rows at rows {0, 8, 13, 32} of a 40-row batch
   (a verify pass at K 4), bit for bit, in 4 draws: the 7 products and
   the head on the steps' route (row 2's kernel at base, the K split of
   one 64-row tile; the bf16 store the steps run, and the float32 sums),
   the norm over d and the qk-norm over hd on the row norm, each beside
   the torch op it replaced (a probe, reported: the products, and the
   float32 statistic mean(x^2) of the torch norm), RoPE and SiLU*up
   (elementwise torch ops the steps keep), and the paged attention at
   T = 1 against T = 5 (bf16 and int8 pools); any op of the steps that
   parts fails the run.  Then each route product at M 8 and M 40 (ragged
   rows, the bf16 store, the tied head read K-major) against its plain
   version rounded to bf16, within one bf16 ulp (plus the f32 sums' order
   bound), launched twice bit-equal, beside fault models that must exceed
   the limit (a K slice dropped, two column tiles swapped, the head's
   weight read MN-major).  The route's products timed at M 8 and M 40
   beside the plain version and `torch.matmul`, and the host time of one
   call.  (``--phases invariance`` runs it alone.)
   tune — `warm_from_flag(qwen3-0.6b, "exhaustive")` at the paged serve
   geometry (8 slots x 1024, page 16) into a fresh cache under
   `build/chip_smoke_tune/<pid>/`: every family's candidates with their
   measured ms, the winner and the H100 bound; no family skipped; every
   candidate's measurement launched its kernel; the cache file reloads
   with the same winners; `tune_report()`.  The launch counts are zeroed
   just before the warm and read just after it (the embed-gather kernel's
   main path is the tuner's measurer).  Then exhaustive searches of the
   ``ssd`` and ``rglru`` families at rows 12 and 13's shapes into the same
   cache (every candidate launching its kernel), and ``ops.ssd`` /
   ``ops.rglru`` with ``"auto"``, each of which must hit the cache and
   launch the winner.  Every other ``cfg="auto"`` of the
   process resolves through caches under the same directory, removed at
   the end.
4. serve  — full-width qwen3-0.6b (28 layers, random bf16 weights from a
   seeded torch.Generator) through `Scheduler` over `PagedEngine`: 16
   requests, an undersized pool that forces preemption.  The launch counts
   are zeroed just before this run and read just after it: 28 paged decode
   launches, 113 of the row norm (ln1, ln2, the q and k norms of 28
   layers and the final norm) and 197 of row 2 (q, k, v, o, gate, up and
   down of 28 layers and the head, the steps' route) a decode step, 84 of
   row 2 a full prefill chunk.  Then the same trace through the plain paths, and one full-width `lm_decode_step` on a
   shared cache, kernel path against plain path.  From the same weights
   (phases ``contig`` and ``spec``, each in a process of its own that
   runs beside these serve runs, and whose output is printed, tagged, when
   it ends): the trace through `BatchedServer` (contiguous caches), bf16
   and then int8 KV, each with one contiguous-decode launch a layer per
   decode step and a contiguous `lm_decode_step`, kernel path against
   plain path;
   a verify-vs-decode check on bf16 and on int8 pools (row t of
   `lm_verify_step` against `lm_decode_step` at pos0 + t, kernel path, 16
   draws of random draft tokens: every row and the pools each pass leaves
   behind bit for bit, 197 launches of row 2, 113 of the row norm and 28
   of the rows kernel a step, a shifted mask shown to part); and 8 requests of 32 tokens
   through `Scheduler` over `SpecPagedEngine` (K 4, an undersized pool)
   four times: a `draft_of` draft, a self draft, a `draft_of` draft whose
   tie guard voids every verify row, and a `draft_of` draft on int8 KV
   pools, each with every request FINISHED, no page leak, a preemption
   and one verify launch a layer per verify step, and each emitting a
   `PagedEngine` run's tokens (on pools of its kind) on every request,
   preemptions per request printed beside the first divergence.  Then (phase
   ``tuned-serve``) the paged trace again through `PagedEngine(tune="exhaustive")` on the tune
   phase's cache, under phase 4's hard checks (28 paged decode launches
   per decode step), with the keys the run filed, the label each resolved
   to and whether the warm filled it, the cache hits and misses, token
   agreement with the base run (reported) and a full-width
   `lm_decode_step` at the tuned labels, kernel path against plain path.
5. train  — full-width qwen3-0.6b training through `launch.train.train`
   (float32 master weights from a seeded generator, bf16 compute, batch 4
   x 1024 tokens, AdamW, remat none): 4 steps on the flash kernels with
   the launch counts zeroed just before and read just after (28 of each
   kernel per step: forward, prep, dQ, dK/dV), 4 steps on the plain attention from the same weights
   and data, whose step-0 loss, step-0 gradient norm and step-1 loss the
   kernel path must match within limits that three planted faults of the
   kernel path (dQ zeroed, dK/dV zeroed, a V tile read as zeros) exceed,
   and a resume check (2 steps, checkpoint, 2 resumed steps) that must
   repeat the kernel path's losses exactly.  Then `train(...,
   tune="exhaustive")`, 2 steps from a fresh cache (its warm printed
   candidate by candidate first), whose step-0 loss and grad norm must lie
   within the same limits of the plain path's (28 launches of each flash
   kernel a step, prep included).  Then full-width gemma3-1b (26
   layers, 22 local with window 512, hd 256, vocab 262144, tied
   embeddings; batch 1 x 4096 tokens) for 4 steps three times: (a) the
   kernels with the block-sparse forward on the local layers (launches
   exactly 22 x 4 sparse, 4 x 4 dense forward, 26 x 4 prep, dQ and
   dK/dV), (b)
   the kernels dense-mask on every layer, (c) the plain attention; (a) and
   (b) held against (c) on step-0 loss, step-0 grad norm and step-1 loss,
   four planted faults of (a) shown to exceed those limits, and the step
   seconds of the three printed side by side.
6. serve MoE — full-width qwen2-moe-a2.7b (24 layers, 64 padded experts,
   random bf16 weights from a seeded generator) through `Scheduler` over
   `PagedEngine`: 8 requests of 64-255 prompt tokens and 32 generated
   tokens, a pool of 60% of the pages they hold at completion.  Twice on
   the kernel path, counts zeroed before and read after each run: bf16
   weights and KV (MoE kernel, paged decode, shared-expert matmul), then
   int8 weights and int8 KV pools (their dequant-fused and int8 twins);
   24 MoE launches per prefill chunk and decode step, 24 decode launches
   per decode step, 169 launches of row 2 per decode step (q, k, v, o and
   the shared FFN of 24 layers and the head, the steps' route, weights
   dequantized first under int8), 49 of the row norm per decode step and
   72 shared-FFN launches per full prefill chunk are checked.  One full-width `lm_decode_step`, kernel path against plain
   path.
7. paper — the figure sweeps `repro_torch.bench.fig8_apps`, `fig11_ai`,
   `fig10_mem_divergence` and `fig13_divdeg` at the paper's sizes, every
   label, each output held bit for bit against its base label's and the
   base label's against its plain version (the matmul app within K *
   2^-24), then the windowed gather's own `make_kernel` at row 16's
   locality cell (planning on the call, bit-equal to its plain version),
   with the launch counts zeroed just before and read just after.
8. result — the card's name and power limit again, the kernels' JSON
   line (launches summed over the main-path runs: the tune phase and
   phases 4-7, side processes included), then the device JSON line, last.
   Each phase prints its seconds.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.bench import common as bench  # noqa: E402
from repro_torch.bench import (fig8_apps, fig10_mem_divergence,  # noqa: E402
                               fig13_divdeg)
from repro_torch.bench import fig11_ai as fig11  # noqa: E402
from repro_torch.bench.common import (BF16_FLOPS, FP32_FLOPS,  # noqa: E402
                                      HBM_BYTES_PER_S, smi_line, time_ms)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coarsening import (BASE,  # noqa: E402
                                         KIND_GAPPED, CoarseningConfig,
                                         plan_rows, plan_stream, resolve,
                                         row_owners, stream_owners)
from repro_torch.kernels import chunk_scan as scan_mod  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import embed_gather as eg_mod  # noqa: E402
from repro_torch.kernels import ew_stream as ew_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import gather_stream as gs_mod  # noqa: E402
from repro_torch.kernels import matmul as mm_mod  # noqa: E402
from repro_torch.kernels import moe_ffn as moe_mod  # noqa: E402
from repro_torch.kernels import rglru as rg_mod  # noqa: E402
from repro_torch.kernels import rmsnorm as norm_mod  # noqa: E402
from repro_torch.kernels import sparse_attention as sp_mod  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.kernels import stencil as st_mod  # noqa: E402
from repro_torch.kernels import windowed_gather as wg_mod  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.quant import (dequantize, quantize, quantize_kv,  # noqa: E402
                               tree_nbytes)
from repro_torch.launch.serve import BatchedServer  # noqa: E402
from repro_torch.serve import (PagedEngine, Request, Scheduler,  # noqa: E402
                               SpecPagedEngine, State, draft_of)
from repro_torch.serve.paging import pages_needed  # noqa: E402
from repro_torch.serve.spec import clears_tie_guard  # noqa: E402
from repro_torch.obs import Registry  # noqa: E402
from repro_torch.tune import (ENV_VAR, KernelSpec, TuningCache,  # noqa: E402
                              autotune, default_cache, enumerate_candidates,
                              model_cost, tune_report, warm_from_flag)
from repro_torch.tune.warm import model_specs  # noqa: E402

# the package re-exports functions under some submodules' names
tune_warm = importlib.import_module("repro_torch.tune.warm")
tsearch = importlib.import_module("repro_torch.tune.search")

SEED = 0

# decode kernel: the serving path's full-width shapes (qwen3-0.6b, 8 slots,
# max_len 1024 at page size 16)
DEC = dict(b=8, h=16, hkv=8, d=128, ps=16, npp=64)
DEC_LABELS = ("base", "con2", "con4", "gap2", "gap4")
# outputs are bf16 averages of unit-variance V rows (|x| well below 1): the
# kernel and the plain versions differ by f32 summation order (and the gather
# oracle by its bf16 probabilities), then both round to bf16 — allow 2 bf16
# ulps of the largest reference output.  One lost live row moves outputs by
# its softmax weight times |v|, far above that.
DEC_ULPS = 2


def dec_tol(want: torch.Tensor) -> float:
    return DEC_ULPS * 2.0 ** -8 * want.float().abs().max().item()
# matmul: the prefill FFN's products at T = slots*chunk = 128, plus m=1024
MM_MAIN = ((128, 1024, 3072), (128, 1024, 3072), (128, 3072, 1024))
MM_CASES = [((128, 1024, 3072), "base"), ((128, 3072, 1024), "base"),
            ((1024, 1024, 3072), "con2"), ((1024, 1024, 3072), "gap2"),
            ((1024, 1024, 3072), "simd2")]
# every label the kernel takes (degree and vector width in 1, 2, 4, their
# product <= 4), held at those shapes and at a K with k % 64 == 32, whose
# last stage reaches past K; then timed at the tuner's key M = 8192, both
# orders of qwen3-0.6b's FFN
MM_LABELS = ("base", "simd2", "simd4", "con2", "con2+simd2", "con4", "gap2",
             "gap2+simd2", "gap4")
MM_SHAPES = ((128, 1024, 3072), (128, 3072, 1024), (1024, 1024, 3072),
             (128, 1056, 1024))
MM_BIG = ((8192, 1024, 3072), (8192, 3072, 1024))


def mm_tol(k: int, ref_max: float) -> float:
    """f32 sums of exact bf16 products taken in another order: at most
    k * 2^-24 of the largest magnitude."""
    return k * 2.0 ** -24 * ref_max


# flash kernels: the train phase's attention (qwen3-0.6b, batch 4 x 1024
# tokens, causal, GQA 16/8, the config's bq = bkv = 128)
FLASH = dict(b=4, h=16, hkv=8, s=1024, d=128, bq=128, bkv=128)
FLASH_LABELS = ("base", "con2", "gap2")
# the same shape under a sliding window whose edges fall off the block grid
FLASH_WINDOW = 200
# The kernels read dO as bf16 (the plain versions are handed dO rounded the
# same way) and round p and dS to bf16 where they enter a tensor-core
# product (2^-9 relative each), summing in f32.  Those roundings move each
# row of o and dQ (per q row) and of dK and dV (per kv row) by a fraction
# of that row's own size, so every row must agree within 4 bf16 ulps of its
# largest reference value.  dS = p (dP - delta) can cancel (in row 0 of dQ
# it is 0), so dQ and dK also allow that difference's f32 error when dP's
# D-term sums run in another order: 2^-16 (twice the 2^-17 linear bound
# over 128 terms) of p (|dO| |V|^T + |delta|), carried through |K| or |Q|.
# A plain-version model of a lost kv block, of a lost block of the causal
# edge and of one kv block lost by the last q block only must exceed these
# limits (checked on every run below).  m is an f32 row maximum of the
# scores: 2^-16 of the largest; l an f32 row sum of exponentials (>= 1):
# 2^-16 of itself.
FLASH_ULPS = 4
F32_SUMS = 2.0 ** -16


def flash_tol(want: torch.Tensor, cond: torch.Tensor | None = None):
    """Per-row limits: FLASH_ULPS bf16 ulps of each row's largest |want|,
    plus the dS cancellation term ``cond`` where given."""
    tol = FLASH_ULPS * 2.0 ** -8 * want.abs().amax(-1, keepdim=True)
    return tol if cond is None else tol + cond


def tol_ratio(got: torch.Tensor, want: torch.Tensor, tol: torch.Tensor):
    """Largest |got - want| / limit over all elements (<= 1 passes)."""
    return ((got - want).abs() / tol).max().item()


# -- phase 1 ------------------------------------------------------------------

def device_phase() -> str:
    if not torch.cuda.is_available():
        print("no CUDA device: the chip smoke test needs one", flush=True)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(smi_line())
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return name


# -- phase 3: decode attention -----------------------------------------------

def decode_inputs(gen: torch.Generator):
    """Pools + a permuted block table; every row past each slot's pos (page
    tails and never-referenced pages) is poisoned with 1e4."""
    b, h, hkv, d, ps, npp = (DEC[k] for k in ("b", "h", "hkv", "d", "ps",
                                               "npp"))
    n_pages = b * npp + 5
    kp = torch.randn(n_pages, ps, hkv, d, generator=gen, device="cuda")
    vp = torch.randn(n_pages, ps, hkv, d, generator=gen, device="cuda")
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")[: b * npp]
    bt = (perm + 1).reshape(b, npp).to(torch.int32)
    # live lengths as the serve phase sees them: prompt 128-511 + generated
    pos = torch.randint(128, 576, (b,), generator=gen, device="cuda")
    rows = torch.arange(npp * ps, device="cuda")
    dead = rows[None, :] > pos[:, None]                       # (b, npp*ps)
    page_of = bt.long()[:, rows // ps]
    kp[page_of[dead], (rows % ps).expand(b, -1)[dead]] = 1e4
    vp[page_of[dead], (rows % ps).expand(b, -1)[dead]] = 1e4
    unref = torch.ones(n_pages, dtype=torch.bool, device="cuda")
    unref[bt.long().flatten()] = False
    kp[unref] = 1e4
    vp[unref] = 1e4
    return (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), bt,
            pos.to(torch.int32))


# recurrentgemma-2b's paged decode: G 10 at head dim 256, one kv head (row
# 1's old kernel took G <= 8; the rows kernel takes T*G <= 64)
PAGED_WIDE = dict(b=4, h=10, hkv=1, d=256, ps=16, npp=64, t=1)


def paged_geometry_check(gen: torch.Generator) -> None:
    """Paged decode at `PAGED_WIDE` (bf16 and int8 pools, base) against its
    plain version, each launched twice bit-equal."""
    for quant in (False, True):
        q, kp, vp, bt, pos0, sc = verify_operands(gen, PAGED_WIDE, quant)
        got = ops.paged_decode_attention(q, kp, vp, bt, pos0, **sc)
        again = ops.paged_decode_attention(q, kp, vp, bt, pos0, **sc)
        torch.cuda.synchronize()
        want = ref.verify_split_kv(q, kp, vp, bt, pos0, **sc)
        err, tol = (got.float() - want.float()).abs().max().item(), \
            dec_tol(want)
        print(f"paged decode G 10, D 256 ({'int8' if quant else 'bf16'} "
              f"pools): max|kernel-plain| {err:.3e} (tol {tol:.3e}); two "
              f"launches bit-equal: {torch.equal(got, again)}", flush=True)
        if not (err <= tol and torch.equal(got, again)):
            raise SystemExit("paged decode at G 10 disagrees with its plain "
                             "version or between launches")


def decode_phase(gen: torch.Generator) -> dict:
    q, kp, vp, bt, pos = decode_inputs(gen)
    worst = 0.0
    for label in DEC_LABELS:
        for window in (None, 100):
            got = ops.paged_decode_attention(q, kp, vp, bt, pos, label,
                                             window=window)
            torch.cuda.synchronize()
            cfg = CoarseningConfig.parse(label)
            want = ref.verify_split_kv(q, kp, vp, bt, pos,
                                       degree=cfg.degree,
                                       gapped=cfg.kind == "gapped",
                                       window=window)
            oracle = ref.paged_decode_attention(q, kp, vp, bt, pos,
                                                window=window)
            err = (got.float() - want.float()).abs().max().item()
            err_o = (got.float() - oracle.float()).abs().max().item()
            tol, tol_o = dec_tol(want), dec_tol(oracle)
            print(f"decode {label:5s} window={window}: max|kernel-plain| "
                  f"{err:.3e} (tol {tol:.3e}), max|kernel-gather oracle| "
                  f"{err_o:.3e} (tol {tol_o:.3e})")
            if not (err <= tol and err_o <= tol_o):
                raise SystemExit(f"decode kernel {label} disagrees with its "
                                 f"plain version")
            worst = max(worst, err, err_o)

    paged_geometry_check(gen)
    b, h, hkv, d, ps = (DEC[k] for k in ("b", "h", "hkv", "d", "ps"))
    live = pos.long() + 1
    kv_bytes = int(2 * live.sum().item() * hkv * d * 2)
    pages = int(((live + ps - 1) // ps).sum().item())
    io_bytes = kv_bytes + 2 * b * h * d * 2 + pages * 4 + b * 4
    flops = int(4 * live.sum().item() * h * d)
    bound_ms = max(io_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    ms = time_ms(lambda: ops.paged_decode_attention(q, kp, vp, bt, pos))
    plain_ms = time_ms(lambda: ref.verify_split_kv(q, kp, vp, bt, pos))
    # yardstick: SDPA over the slots' pre-gathered contiguous views (the
    # gather itself is not timed), K/V heads expanded for GQA, pos masked
    kv = ref.gather_pages(kp, bt).transpose(1, 2)             # (b,hkv,S,d)
    vv = ref.gather_pages(vp, bt).transpose(1, 2)
    kv = kv.repeat_interleave(h // hkv, dim=1).contiguous()
    vv = vv.repeat_interleave(h // hkv, dim=1).contiguous()
    qs = q.transpose(1, 2).contiguous()                       # (b,h,1,d)
    mask = (torch.arange(kv.shape[2], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kv, vv, attn_mask=mask))
    print(f"decode timing (base, B={b} H={h} Hkv={hkv} D={d} ps={ps}, "
          f"live rows {int(live.sum())}): kernel {ms:.4f} ms | bound "
          f"{bound_ms:.4f} ms (bytes) | plain {plain_ms:.4f} ms | sdpa "
          f"{lib_ms:.4f} ms", flush=True)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:342",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if io_bytes / HBM_BYTES_PER_S
            >= flops / BF16_FLOPS else "operations",
            "library_ms": lib_ms}


# -- phase 3: matmul ----------------------------------------------------------

def mm_f32(a: torch.Tensor, b: torch.Tensor):
    """One PyTorch call of the kernel's own function, bf16 in and float32
    out (``torch.mm(..., out_dtype=torch.float32)``, `aten::mm.dtype`); None
    where this PyTorch lacks it."""
    try:
        return torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return None


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds a call takes to enqueue (no synchronise inside)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def matmul_phase(gen: torch.Generator) -> dict:
    """Row 2 (`matmul.py:69`): every label the kernel takes at qwen3-0.6b's
    FFN products at T = 128, at M = 1024 and at k % 64 == 32, each launched
    twice and bit-equal, beside two fault models (one K slice's partial
    dropped, a gapped program's row blocks swapped) that must exceed the
    limit; every instance's local memory read from the loaded module (any
    fails the run); the three products of one prefill chunk timed, each
    product with its K split, a call's host time, and every label at the
    tuner's key M = 8192."""
    def operands(m, k, n):
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        b = torch.randn(k, n, generator=gen, device="cuda").bfloat16() \
            / math.sqrt(k)
        return a, b.bfloat16()

    sms = mm_mod.sm_count(torch.device("cuda"))
    for name, local, regs in mm_mod.instances():
        print(f"matmul instance {name}: {regs} registers, {local} bytes of "
              f"local memory a thread")
        if local:
            raise SystemExit(f"matmul instance {name} spills ({local} bytes "
                             f"of local memory)")
    worst = 0.0
    cases = list(MM_CASES) + [
        ((m, k, n), label) for m, k, n in MM_SHAPES for label in MM_LABELS
        if mm_mod.tileable(m, n, k, resolve(label))
        and ((m, k, n), label) not in MM_CASES]
    for (m, k, n), label in cases:
        cfg = resolve(label)
        a, b = operands(m, k, n)
        got = ops.matmul(a, b, label)
        again = ops.matmul(a, b, label)
        torch.cuda.synchronize()
        want = ref.matmul(a, b)
        err = (got - want).abs().max().item()
        tol = mm_tol(k, want.abs().max().item())
        same = torch.equal(got, again)
        plan = mm_mod.mm_split_plan(m, n, k, cfg, sms)
        faults = []
        if plan.splits > 1:
            k0, k1 = plan.bounds(k)[0]
            part = ref.matmul(a[:, k0:k1].contiguous(), b[k0:k1].contiguous())
            faults.append(("slice 0's partial dropped",
                           part.abs().max().item() / tol))
        if cfg.kind == KIND_GAPPED and cfg.degree > 1:
            seg, bad = m // cfg.degree, want.clone()
            bad[:mm_mod.BM] = want[seg:seg + mm_mod.BM]
            bad[seg:seg + mm_mod.BM] = want[:mm_mod.BM]
            faults.append(("program 0's row blocks 0 and 1 swapped",
                           (bad - want).abs().max().item() / tol))
        print(f"matmul ({m}x{k})@({k}x{n}) {label:5s}: max|kernel-plain| "
              f"{err:.3e} (tol {tol:.3e}); S {plan.splits}, grid "
              f"{plan.grid}; two launches bit-equal: {same}"
              + "".join(f"; fault model ({what}) / limit {r:.1f}"
                        for what, r in faults), flush=True)
        if not err <= tol:
            raise SystemExit(f"matmul kernel {label} disagrees with its "
                             f"plain version")
        if not same:
            raise SystemExit(f"matmul kernel {label} gave other bits on a "
                             f"second launch")
        for what, r in faults:
            if not r > 1:
                raise SystemExit(f"the matmul limit would not catch {what}")
        worst = max(worst, err)

    # timing: one FFN's three products in one prefill chunk (gate, up, down)
    ops_ = [operands(m, k, n) for m, k, n in MM_MAIN]
    flops = sum(2 * m * n * k for m, k, n in MM_MAIN)
    io_bytes = sum(2 * m * k + 2 * k * n + 4 * m * n for m, k, n in MM_MAIN)
    bound_ms, bound_by = bound(io_bytes, flops)
    has_f32 = mm_f32(*ops_[0]) is not None
    ms = time_ms(lambda: [ops.matmul(a, b) for a, b in ops_])
    plain_ms = time_ms(lambda: [ref.matmul(a, b) for a, b in ops_])
    lib_ms = time_ms(lambda: [torch.matmul(a, b) for a, b in ops_])
    f32_ms = (time_ms(lambda: [mm_f32(a, b) for a, b in ops_]) if has_f32
              else None)
    f32_text = (f"{f32_ms:.4f} ms" if has_f32 else
                "not measured (this PyTorch has no aten::mm.dtype)")
    print(f"matmul timing (ffn gate+up+down at T=128, base): kernel "
          f"{ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}) | plain (f32) "
          f"{plain_ms:.4f} ms | torch.matmul bf16 {lib_ms:.4f} ms | torch.mm "
          f"f32 out {f32_text}", flush=True)
    for (m, k, n), (a, b) in zip(MM_MAIN[1:], ops_[1:]):
        plan = mm_mod.mm_split_plan(m, n, k, BASE, sms)
        one, one_by = bound(2 * m * k + 2 * k * n + 4 * m * n, 2 * m * n * k)
        f32 = (f"{time_ms(lambda: mm_f32(a, b)):.4f}" if has_f32 else "-")
        print(f"matmul ({m}x{k})@({k}x{n}) base: kernel "
              f"{time_ms(lambda: ops.matmul(a, b)):.4f} ms | bound {one:.4f} "
              f"ms ({one_by}) | torch.matmul "
              f"{time_ms(lambda: torch.matmul(a, b)):.4f} | torch.mm f32 out "
              f"{f32} | S {plan.splits}, grid {plan.grid} = {plan.blocks} "
              f"blocks on {sms} SMs | build: "
              f"{build_line('matmul', 'cmm_kernelILi1ELi1E')}", flush=True)
    a, b = ops_[0]
    print(f"matmul host time of one call (128x1024)@(1024x3072): kernel "
          f"{host_us(lambda: ops.matmul(a, b)):.1f} us | torch.matmul "
          f"{host_us(lambda: torch.matmul(a, b)):.1f} us", flush=True)
    # the tuner's key: every label, the fastest as a search would pick it
    for m, k, n in MM_BIG:
        a, b = operands(m, k, n)
        one, one_by = bound(2 * m * k + 2 * k * n + 4 * m * n, 2 * m * n * k)
        times = {label: time_ms(lambda: ops.matmul(a, b, label))
                 for label in MM_LABELS
                 if mm_mod.tileable(m, n, k, resolve(label))}
        best = min(times, key=times.get)
        f32 = (f"{time_ms(lambda: mm_f32(a, b)):.4f}" if has_f32 else "-")
        print(f"matmul ({m}x{k})@({k}x{n}): base {times['base']:.4f} ms, "
              f"fastest {best} {times[best]:.4f} ms | bound {one:.4f} ms "
              f"({one_by}) | torch.matmul "
              f"{time_ms(lambda: torch.matmul(a, b)):.4f} | torch.mm f32 out "
              f"{f32} | every label: "
              + ", ".join(f"{lb} {t:.4f}" for lb, t in times.items()),
              flush=True)
        del a, b
    return {"name": "coarsened_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:69",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": f32_ms if has_f32 else lib_ms}


# -- phase 3: the row norm of the decode and verify steps ---------------------

def rmsnorm_phase(gen: torch.Generator) -> dict:
    """The row norm (`kernels/rmsnorm.py`, added for batch invariance) at a
    qwen3-0.6b decode step's shapes (ln over d 1024, the q and k norms over
    hd 128) and a verify pass's (K 4), each launched twice and bit-equal,
    every element within 1 bf16 ulp (2^-7 of its magnitude) of the plain
    version (the two sum the squares in other orders); a model of lane
    0's values lost from the sum of squares must exceed it.  Timed at one
    ln call of a decode step."""
    cfg = get_config("qwen3-0.6b")
    worst = 0.0
    for rows_, d in ((SLOTS, cfg.d_model), (SLOTS * (SPEC_K + 1),
                                            cfg.d_model),
                     (SLOTS * cfg.n_heads, cfg.hd),
                     (SLOTS * (SPEC_K + 1) * cfg.n_kv_heads, cfg.hd)):
        x = (4 * torch.randn(rows_, d, generator=gen, device="cuda")
             ).bfloat16()
        sc = 0.1 * torch.randn(d, generator=gen, device="cuda")
        got = norm_mod.rmsnorm(x, sc, cfg.norm_eps)
        again = norm_mod.rmsnorm(x, sc, cfg.norm_eps)
        torch.cuda.synchronize()
        want = ref.rmsnorm(x, sc, cfg.norm_eps).float()
        lim = 2.0 ** -7 * want.abs()
        ratio = ((got.float() - want).abs() / lim.clamp(min=1e-30)).max()
        keep = torch.ones(d, dtype=torch.bool, device="cuda")
        keep[(torch.arange(d, device="cuda") % 256) < 8] = False
        xf = x.float()
        var = (xf.square() * keep).sum(-1, keepdim=True) / d
        bad = (xf * torch.rsqrt(var + cfg.norm_eps) * (1 + sc)
               ).bfloat16().float()
        fault = ((bad - want).abs() / lim.clamp(min=1e-30)).max().item()
        same = torch.equal(got, again)
        print(f"rmsnorm ({rows_}x{d}): max |kernel-plain| / (2^-7 |plain|) "
              f"{ratio.item():.3f}; fault model (lane 0's values lost from "
              f"the sum of squares) / limit {fault:.1f}; two launches "
              f"bit-equal: {same}", flush=True)
        if not (ratio.item() <= 1 and same):
            raise SystemExit("the row norm disagrees with its plain version "
                             "or between launches")
        if not fault > 1:
            raise SystemExit("the row norm's limit would not catch a lost "
                             "lane")
        worst = max(worst, (got.float() - want).abs().max().item())
    x = torch.randn(SLOTS, cfg.d_model, generator=gen, device="cuda"
                    ).bfloat16()
    sc = 0.1 * torch.randn(cfg.d_model, generator=gen, device="cuda")
    w1 = 1 + sc
    bms, by = bound(4 * x.numel() + 4 * cfg.d_model, 4 * x.numel())
    ms = time_ms(lambda: norm_mod.rmsnorm(x, sc, cfg.norm_eps))
    plain_ms = time_ms(lambda: ref.rmsnorm(x, sc, cfg.norm_eps))
    lib_ms = time_ms(lambda: F.rms_norm(x, (cfg.d_model,), weight=w1,
                                        eps=cfg.norm_eps)) \
        if hasattr(F, "rms_norm") else None
    print(f"rmsnorm timing ({SLOTS}x{cfg.d_model}, a decode step's ln): "
          f"kernel {ms:.4f} ms | bound {bms:.4f} ms ({by}) | plain "
          f"{plain_ms:.4f} ms | F.rms_norm (weight 1 + scale) "
          f"{lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'} | host "
          f"{host_us(lambda: norm_mod.rmsnorm(x, sc, cfg.norm_eps)):.1f} us a "
          f"call, plain "
          f"{host_us(lambda: ref.rmsnorm(x, sc, cfg.norm_eps)):.1f} us",
          flush=True)
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/models/layers.py:87",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


# -- phase 3: flash attention (forward, dQ, dK/dV) ---------------------------

def build_line(source: str, tag: str) -> str:
    """The ptxas registers / spills of the kernel instance whose mangled
    name holds ``tag`` (from this run's build), or "not printed"."""
    lines = [ln.split(":", 1)[1].strip() for ln in
             _build.REPORTS.get(source, []) if tag in ln]
    return lines[0] if lines else "not printed"


def flash_build_line(d: int, rows: int) -> str:
    """The forward kernel's instance for head dim ``d`` and programs of
    ``rows`` rows (a consumer warpgroup per 64)."""
    return build_line("flash_attention", f"flash_fwd_wsILi{d}ELi{rows // 64}E")


def flash_inputs(gen: torch.Generator, shape: dict):
    b, h, hkv, s, d = (shape[k] for k in ("b", "h", "hkv", "s", "d"))
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, hkv, s, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, h, s, d, generator=gen, device="cuda")
    return q, k, v, do


def flash_planes(q, k, v, do, m, l, keep):
    """The plain attention's (q, kv) planes in f32 from the residuals, with
    the pairs outside ``keep`` dropped -> p, dP, K and V expanded over each
    GQA group, scale."""
    h, d = q.shape[1], q.shape[3]
    g, scale = h // k.shape[1], 1.0 / math.sqrt(d)
    ke = k.float().repeat_interleave(g, dim=1)
    ve = v.float().repeat_interleave(g, dim=1)
    s_ = torch.einsum("bhqd,bhkd->bhqk", q.float(), ke) * scale
    p = torch.exp(torch.where(keep, s_ - m[..., None], -1e30)) / l[..., None]
    del s_
    return p, torch.einsum("bhqd,bhkd->bhqk", do, ve), ke, ve, scale


def group_sum(x, hkv):
    """(B, H, ...) per-q-head partials -> (B, Hkv, ...) sums per group."""
    return x.reshape(x.shape[0], hkv, -1, *x.shape[2:]).sum(2)


def flash_keep(n, window, device):
    """The causal (and sliding-window) mask over (q row, kv row)."""
    keep = torch.ones(n, n, dtype=torch.bool, device=device).tril()
    if window is not None:
        keep &= torch.ones_like(keep).triu(-window + 1)
    return keep


def flash_cond(q, k, v, do, m, l, delta, keep):
    """The f32 error allowance of dS = p (dP - delta) carried into dQ and
    dK (see FLASH_ULPS) -> (cond_dq, cond_dk)."""
    p, _, ke, ve, scale = flash_planes(q, k, v, do, m, l, keep)
    c = p * (torch.einsum("bhqd,bhkd->bhqk", do.abs(), ve.abs())
             + delta.abs()[..., None])
    del p
    cq = torch.einsum("bhqk,bhkd->bhqd", c, ke.abs()) * scale
    ck = torch.einsum("bhqk,bhqd->bhkd", c, q.float().abs()) * scale
    return F32_SUMS * cq, F32_SUMS * group_sum(ck, k.shape[1])


def flash_fault_model(q, k, v, do, m, l, delta, keep, drop_head=None):
    """Plain-PyTorch model of kernels that attend to the (q, kv) pairs of
    ``keep`` instead of the mask's: the forward renormalises over what it
    saw, the backward sums the terms of those pairs -> {o, dq, dk, dv}.
    ``drop_head``: the GQA sum of dk, dv leaves that q head's partial out."""
    p, dp, ke, ve, scale = flash_planes(q, k, v, do, m, l, keep)
    lf = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / torch.where(lf == 0, 1, lf), ve)
    ds = p * (dp - delta[..., None])
    del dp
    hkv = k.shape[1]
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    if drop_head is not None:
        dk[:, drop_head] = 0
        dv[:, drop_head] = 0
    return {"o": o, "dq": torch.einsum("bhqk,bhkd->bhqd", ds, ke) * scale,
            "dk": group_sum(dk, hkv), "dv": group_sum(dv, hkv)}


# delta's f32 sum over D terms, in the kernel's order and the plain
# version's: each within D 2^-24 of sum |g o| of its row (the linear bound)
PREP_SUMS = 2.0 * 2.0 ** -24


def prep_hold(tag: str, o, g) -> float:
    """Hold the prep kernel against its plain version: dO bit for bit,
    delta within PREP_SUMS * D of each row's sum |g o| -> max|delta error|."""
    do_k, delta_k = fa_mod.flash_bwd_prep(o, g)
    again = fa_mod.flash_bwd_prep(o, g)
    do_r, delta_r = ref.flash_bwd_prep(o, g)
    torch.cuda.synchronize()
    lim = PREP_SUMS * o.shape[-1] * (g * o).abs().sum(-1)
    r = ((delta_k - delta_r).abs() / lim).max().item()
    # a fault model: delta summed over the first half of D only
    half = o.shape[-1] // 2
    bad = (g[..., :half] * o[..., :half]).sum(-1)
    r_bad = ((bad - delta_r).abs() / lim).max().item()
    same = torch.equal(do_k, do_r) and all(
        torch.equal(x, y) for x, y in zip((do_k, delta_k), again))
    print(f"{tag} prep: dO bit-equal to g rounded to bf16, two launches "
          f"bit-equal: {same}; delta max error / limit {r:.3f} (fault "
          f"model, half of D summed: {r_bad:.1f})", flush=True)
    if not (same and r <= 1 < r_bad):
        raise SystemExit(f"{tag} prep kernel disagrees with its plain "
                         f"version (or the limit misses its fault model)")
    return (delta_k - delta_r).abs().max().item()


def flash_faults(s: int, blk: int, window) -> dict:
    """Lost blocks the limits must catch: a whole kv block, the last
    causal-edge block, and a block lost by the last q block only (kv block
    0 under causal attention; the trailing edge of its window under a
    sliding window, where block 0 lies outside it)."""
    edge = slice(0, blk) if window is None else \
        slice(s - window - blk, s - window)
    return {"kv block 3 lost": (slice(None), slice(3 * blk, 4 * blk)),
            "last causal-edge block lost": (slice(s - blk, s),
                                            slice(s - blk, s)),
            "kv block lost by the last q block only": (slice(s - blk, s),
                                                       edge)}


def flash_hold(tag: str, q, k, v, do, cases, window=None) -> tuple:
    """Hold the forward, dQ and dK/dV kernels against their plain versions
    for every (label, block rows) in ``cases``, each row within its own
    limit, after showing that the fault models exceed those limits ->
    (worst max|kernel - plain| per kernel, the kernels' residual inputs
    (do, m, l, delta))."""
    s = q.shape[2]
    keep = flash_keep(s, window, q.device)
    geo = dict(bq=cases[0][1], bkv=cases[0][1], window=window)
    o_r, m_r, l_r = ref.flash_forward(q, k, v, residuals=True, **geo)
    # the prep pass from the f32 cotangent, as ops runs it
    do_b, delta = ref.flash_bwd_prep(o_r, do)
    err_prep = prep_hold(tag, o_r, do)
    res = (do_b, m_r, l_r, delta)           # the kernels' inputs
    res_p = (do_b.float(), m_r, l_r, delta)  # dO as they read it
    dq_r = ref.flash_bwd_dq(q, k, v, *res_p, **geo)
    dk_r, dv_r = ref.flash_bwd_dkv(q, k, v, *res_p, **geo)
    want = {"o": o_r, "dq": dq_r, "dk": dk_r, "dv": dv_r}
    cond_dq, cond_dk = flash_cond(q, k, v, *res_p, keep)
    tol = {"o": flash_tol(o_r), "dq": flash_tol(dq_r, cond_dq),
           "dk": flash_tol(dk_r, cond_dk), "dv": flash_tol(dv_r)}
    del cond_dq, cond_dk
    tol_m = 2.0 ** -16 * m_r.abs().max().item()
    tol_l = 2.0 ** -16 * l_r

    for what, (rows, cols) in flash_faults(s, cases[0][1], window).items():
        lost = keep.clone()
        lost[rows, cols] = False
        bad = flash_fault_model(q, k, v, *res_p, lost)
        dev = {n: tol_ratio(bad[n], want[n], tol[n]) for n in want}
        print(f"{tag} fault model, {what}: max deviation / limit "
              + ", ".join(f"{n} {dev[n]:.2f}" for n in want), flush=True)
        if not all(dev[n] > 1 for n in want):
            raise SystemExit(f"{tag} limits would not catch: {what}")
        del bad, lost
    # the forward's edge tiles read as full: every diagonal (q block, kv
    # block) pair, an edge tile under the causal mask, unmasked
    blk = cases[0][1]
    diag = torch.zeros_like(keep)
    for i in range(0, s, blk):
        diag[i:i + blk, i:i + blk] = True
    bad = flash_fault_model(q, k, v, *res_p, keep | diag)
    dev = {n: tol_ratio(bad[n], want[n], tol[n]) for n in want}
    print(f"{tag} fault model, an edge tile read unmasked (the diagonal "
          f"blocks' mask dropped; o: the forward's, dq, dk, dv: the "
          f"backward's full tiles read across the diagonal): max "
          f"deviation / limit "
          + ", ".join(f"{n} {dev[n]:.2f}" for n in want), flush=True)
    if not all(dev[n] > 1 for n in want):
        raise SystemExit(f"{tag} limits would not catch an edge tile read "
                         f"unmasked")
    # one q head's partial dropped from the cluster sum (q head 1, rank 1
    # of kv head 0's cluster)
    lost = flash_fault_model(q, k, v, *res_p, keep, drop_head=1)
    dev = {n: tol_ratio(lost[n], want[n], tol[n]) for n in ("dk", "dv")}
    print(f"{tag} fault model, q head 1's partial dropped from the cluster "
          f"sum: max deviation / limit "
          + ", ".join(f"{n} {dev[n]:.2f}" for n in dev), flush=True)
    if not all(x > 1 for x in dev.values()):
        raise SystemExit(f"{tag} limits would not catch a q head's partial "
                         f"dropped from the cluster sum")
    del bad, lost, keep, diag

    worst = {"flash_forward": 0.0, "flash_bwd_prep": err_prep,
             "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for label, blk in cases:
        kw = dict(bq=blk, bkv=blk, window=window)
        o, m, l = fa_mod.flash_forward(q, k, v, label, residuals=True, **kw)
        again = fa_mod.flash_forward(q, k, v, label, residuals=True, **kw)
        o_nr = fa_mod.flash_forward(q, k, v, label, **kw)
        dq = fa_mod.flash_bwd_dq(q, k, v, *res, label, **kw)
        dk, dv = fa_mod.flash_bwd_dkv(q, k, v, *res, label, **kw)
        dq2 = fa_mod.flash_bwd_dq(q, k, v, *res, label, **kw)
        dk2, dv2 = fa_mod.flash_bwd_dkv(q, k, v, *res, label, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip((o, m, l), again))
        same_b = all(torch.equal(x, y) for x, y in
                     zip((dq, dk, dv), (dq2, dk2, dv2)))
        print(f"{tag} {label:4s} (blocks {blk}): forward launched twice, "
              f"o, m, l bit-equal: {same}; o without residuals bit-equal "
              f"to o: {torch.equal(o, o_nr)}; dQ and dK/dV launched twice, "
              f"dq, dk, dv bit-equal: {same_b}", flush=True)
        if not (same and same_b):
            raise SystemExit(f"{tag} kernels under {label} gave other bits "
                             f"on a second launch")
        del again, dq2, dk2, dv2
        got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
        ratio = {n: tol_ratio(got[n], want[n], tol[n]) for n in want}
        ratio["o (no residuals)"] = tol_ratio(o_nr, o_r, tol["o"])
        ratio["m"] = (m - m_r).abs().max().item() / tol_m
        ratio["l"] = tol_ratio(l, l_r, tol_l)
        err = {n: (got[n] - want[n]).abs().max().item() for n in want}
        print(f"{tag} {label:4s} (blocks {blk}): max|kernel-plain| "
              + ", ".join(f"{n} {e:.3e}" for n, e in err.items())
              + "; max error / limit "
              + ", ".join(f"{n} {r:.3f}" for n, r in ratio.items()),
              flush=True)
        if not all(r <= 1 for r in ratio.values()):
            raise SystemExit(f"{tag} kernels under {label} disagree with "
                             f"their plain versions")
        err_f = max((o - o_r).abs().max().item(),
                    (o_nr - o_r).abs().max().item(),
                    (m - m_r).abs().max().item(),
                    (l - l_r).abs().max().item())
        worst["flash_forward"] = max(worst["flash_forward"], err_f)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], err["dq"])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], err["dk"],
                                     err["dv"])
    return worst, res


def flash_time(tag: str, q, k, v, res, blk: int, window=None,
               o=None, g=None) -> dict:
    """Time the kernels (base), their plain versions and SDPA at one shape
    -> {kernel: (ms, plain_ms, bound_ms, bound_by, library_ms)}; the prep
    pass too when the forward's o and the f32 cotangent g are given.
    Bound: each input read once, each output written once; the work of
    the live (q, kv) pairs of the causal (window) mask.  dQ and dK/dV
    read prep's bf16 dO; the backward's f32 cotangent is read once, in
    prep's bound, which also writes the bf16 copy."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    geo = dict(bq=blk, bkv=blk, window=window)
    keep = flash_keep(s, window, q.device)
    pairs = b * h * int(keep.sum().item())
    qb, kvb = b * h * s * d * 2, 2 * b * hkv * s * d * 2   # bf16 q; k + v
    f32_q, stat = b * h * s * d * 4, b * h * s * 4
    dob = qb                                               # bf16 dO
    work = {"flash_forward": (qb + kvb + f32_q + 2 * stat, 4 * d * pairs),
            "flash_bwd_dq": (qb + kvb + dob + 3 * stat + f32_q,
                             6 * d * pairs),
            "flash_bwd_dkv": (qb + kvb + dob + 3 * stat
                              + 2 * b * hkv * s * d * 4, 8 * d * pairs),
            # o and g read, dO (bf16) and delta written; 2 D flops a row
            "flash_bwd_prep": (2 * f32_q + qb + stat, 2 * b * h * s * d)}
    calls = {
        "flash_forward": (
            lambda: fa_mod.flash_forward(q, k, v, residuals=True, **geo),
            lambda: ref.flash_forward(q, k, v, residuals=True, **geo)),
        "flash_bwd_prep": (
            lambda: fa_mod.flash_bwd_prep(o, g),
            lambda: ref.flash_bwd_prep(o, g)),
        "flash_bwd_dq": (
            lambda: fa_mod.flash_bwd_dq(q, k, v, *res, **geo),
            lambda: ref.flash_bwd_dq(q, k, v, *res, **geo)),
        "flash_bwd_dkv": (
            lambda: fa_mod.flash_bwd_dkv(q, k, v, *res, **geo),
            lambda: ref.flash_bwd_dkv(q, k, v, *res, **geo))}
    # yardsticks: SDPA's forward, and its backward (dQ, dK and dV together)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = dict(is_causal=True) if window is None else dict(attn_mask=keep)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o_s = sdpa(qs, ks, vs, enable_gqa=True, **mask)
    g_s = res[0].bfloat16()
    lib_fwd = time_ms(lambda: sdpa(q, k, v, enable_gqa=True, **mask))
    lib_bwd = time_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), g_s,
                                                  retain_graph=True))
    library = {"flash_forward": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd, "flash_bwd_prep": None}
    if o is None:
        del calls["flash_bwd_prep"]
    out = {}
    for name, (kernel, plain) in calls.items():
        io_bytes, flops = work[name]
        peak = FP32_FLOPS if name == "flash_bwd_prep" else BF16_FLOPS
        t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, flops / peak
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ms, plain_ms = time_ms(kernel), time_ms(plain, reps=5)
        fwd = ""
        if name == "flash_forward":
            fwd = (f" | no residuals "
                   f"{time_ms(lambda: fa_mod.flash_forward(q, k, v, **geo)):.4f}"
                   f" ms | build: {flash_build_line(d, blk)}")
        elif name != "flash_bwd_prep":
            fwd = (" (backward: dQ, dK, dV together) | build: "
                   + flash_bwd_build_line(name, d, blk, blk))
        lib = ("none (no one call)" if library[name] is None
               else f"sdpa {library[name]:.4f} ms")
        print(f"{tag} {name} timing (base, B={b} H={h} Hkv={hkv} S={s} "
              f"D={d} window={window}): kernel {ms:.4f} ms | bound "
              f"{bound_ms:.4f} ms ({bound_by}) | plain {plain_ms:.4f} ms | "
              f"{lib}{fwd}", flush=True)
        out[name] = (ms, plain_ms, bound_ms, bound_by, library[name])
    if o is not None:
        pair = sum(out[n][0] for n in ("flash_bwd_prep", "flash_bwd_dq",
                                       "flash_bwd_dkv"))
        bound = sum(out[n][2] for n in ("flash_bwd_prep", "flash_bwd_dq",
                                        "flash_bwd_dkv"))
        print(f"{tag} backward (prep + dQ + dK/dV) {pair:.4f} ms, bound "
              f"{bound:.4f} ms | sdpa backward {lib_bwd:.4f} ms "
              f"({pair / lib_bwd:.2f}x)", flush=True)
    return out


def flash_bwd_build_line(name: str, d: int, bq: int, bkv: int,
                         degree: int = 1) -> str:
    """The registers / spills of the dQ or dK/dV instance a geometry runs
    (`flash_dq_ws<D, NWG>`, `flash_dkv_ws<D, NWG, QT>`)."""
    if name == "flash_bwd_dq":
        nwg = 2 if degree * bq >= 128 else 1
        return build_line("flash_attention", f"flash_dq_wsILi{d}ELi{nwg}E")
    nwg = 1 if d >= 256 or degree * bkv < 128 else 2
    return build_line("flash_attention", f"flash_dkv_wsILi{d}ELi{nwg}ELi"
                      f"{fa_mod.dkv_q_tile(bq)}E")


def bwd_spills() -> None:
    """Every dQ and dK/dV instance: its ptxas line when this process built
    the library, and its local memory and registers as the loaded module
    reports them; local memory (a spill or a stack frame) fails the run,
    whether or not the build was cached."""
    for ln in _build.REPORTS.get("flash_attention", []):
        if "flash_dq_ws" in ln or "flash_dkv_ws" in ln:
            print(f"flash backward build:{ln}", flush=True)
    insts = fa_mod.bwd_instances()
    for name, local, regs in insts:
        print(f"flash backward instance {name}: {regs} registers, {local} "
              f"bytes local memory", flush=True)
    spilled = [name for name, local, _ in insts if local]
    if not insts or spilled:
        raise SystemExit(f"flash backward kernels: {len(insts)} instances, "
                         f"local memory in {spilled}")


def flash_label_times(tag: str, q, k, v, labels, window=None,
                      res=None) -> None:
    """The forward under coarsened labels ((label, block rows) pairs),
    with and without residuals, beside its instance's registers; dQ and
    dK/dV too when their inputs ``res`` are given."""
    d = q.shape[3]
    for label, blk in labels:
        geo = dict(bq=blk, bkv=blk, window=window)
        t = time_ms(lambda: fa_mod.flash_forward(q, k, v, label,
                                                 residuals=True, **geo))
        t_nr = time_ms(lambda: fa_mod.flash_forward(q, k, v, label, **geo))
        deg = resolve(label).degree
        bwd = ""
        if res is not None:
            t_dq = time_ms(lambda: fa_mod.flash_bwd_dq(q, k, v, *res, label,
                                                       **geo))
            t_dkv = time_ms(lambda: fa_mod.flash_bwd_dkv(q, k, v, *res,
                                                         label, **geo))
            bwd = (f" | dQ {t_dq:.4f} ms, build: "
                   f"{flash_bwd_build_line('flash_bwd_dq', d, blk, blk, deg)}"
                   f" | dK/dV {t_dkv:.4f} ms, build: "
                   f"{flash_bwd_build_line('flash_bwd_dkv', d, blk, blk, deg)}")
        print(f"{tag} flash_forward {label} (blocks {blk}) timing: "
              f"{t:.4f} ms | no residuals {t_nr:.4f} ms | build: "
              f"{flash_build_line(d, deg * blk)}{bwd}", flush=True)


def flash_phase(gen: torch.Generator) -> list:
    bwd_spills()
    q, k, v, do = flash_inputs(gen, FLASH)
    blk = FLASH["bq"]
    cases = [(label, blk) for label in FLASH_LABELS]
    worst, res = flash_hold("flash", q, k, v, do, cases)
    # the same labels under a sliding window (edges off the block grid)
    w_worst, _ = flash_hold(f"flash window={FLASH_WINDOW}", q, k, v, do,
                            cases, FLASH_WINDOW)
    worst = {n: max(x, w_worst[n]) for n, x in worst.items()}
    o = ref.flash_forward(q, k, v, bq=blk, bkv=blk)
    times = flash_time("flash", q, k, v, res, blk, o=o, g=do)
    del o
    # the prep pass computes the reference's line outside its kernels
    replaces = {"flash_forward": "kernels/flash_attention.py:196",
                "flash_bwd_prep": "kernels/ops.py:235",
                "flash_bwd_dq": "kernels/flash_attention.py:291",
                "flash_bwd_dkv": "kernels/flash_attention.py:421"}
    out = []
    for name, (ms, plain_ms, bound_ms, bound_by, lib_ms) in times.items():
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "flash_attention.cu",
                    "replaces": f"src/repro/{replaces[name]}",
                    "max_abs_err": worst[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})
    # the coarsened programs against base (the main path's label)
    geo = dict(bq=blk, bkv=blk)
    for label in FLASH_LABELS[1:]:
        t = [time_ms(lambda: fa_mod.flash_forward(q, k, v, label,
                                                  residuals=True, **geo)),
             time_ms(lambda: fa_mod.flash_bwd_dq(q, k, v, *res, label,
                                                 **geo)),
             time_ms(lambda: fa_mod.flash_bwd_dkv(q, k, v, *res, label,
                                                  **geo)),
             time_ms(lambda: fa_mod.flash_forward(q, k, v, label, **geo))]
        deg = resolve(label).degree
        print(f"flash {label} timing: forward {t[0]:.4f} ms | dQ "
              f"{t[1]:.4f} ms | dK/dV {t[2]:.4f} ms (base: "
              + " | ".join(f"{o['name']} {o['ms']:.4f}" for o in out)
              + f"); forward without residuals {t[3]:.4f} ms | build: "
              f"{flash_build_line(q.shape[3], deg * blk)} | dQ "
              f"{flash_bwd_build_line('flash_bwd_dq', q.shape[3], blk, blk, deg)}"
              f" | dK/dV "
              f"{flash_bwd_build_line('flash_bwd_dkv', q.shape[3], blk, blk, deg)}",
              flush=True)
    return out


# -- phase 3: flash attention at head dim 256, block-sparse flash -------------

# the gemma3-1b train phase's attention: batch 1 x 4096 tokens, 4/1 heads,
# head dim 256, the config's bq = bkv = 128, window 512 on the local layers
SPARSE = dict(b=1, h=4, hkv=1, s=4096, d=256, bq=128, bkv=128, window=512)
SPARSE_LABELS = ("base", "con2", "gap2", "con4", "gap4")
# head dim 256 holds programs of up to 128 rows: the coarsened labels run
# at blocks of 64
FLASH256_CASES = (("base", 128), ("con2", 64), ("gap2", 64))
# q blocks whose K/V rows outside their own live set are poisoned with NaN:
# the first, one inside and one past the first window, a middle and the last
SPARSE_POISONED = (0, 3, 4, 17, 31)
# global columns of the stride check (`--attn-global-stride`): every 1024th
SPARSE_GLOBAL_STRIDE = 1024


def flash256_phase(gen: torch.Generator) -> dict:
    """Rows 5-7 at head dim 256 on the gemma3 train shape, global (causal)
    and windowed, under the D 128 checks and limits -> {window: times}."""
    q, k, v, do = flash_inputs(gen, SPARSE)
    out = {}
    for window in (None, SPARSE["window"]):
        tag = f"flash D=256 window={window}"
        _, res = flash_hold(tag, q, k, v, do, FLASH256_CASES, window)
        o = ref.flash_forward(q, k, v, bq=SPARSE["bq"], bkv=SPARSE["bkv"],
                              window=window)
        out[window] = flash_time(tag, q, k, v, res, SPARSE["bq"], window,
                                 o=o, g=do)
        flash_label_times(tag, q, k, v, FLASH256_CASES[1:], window, res)
        del res, o
        gc.collect()
        torch.cuda.empty_cache()
    return out


# forward geometries off the two train shapes (B 2, H 4/2, Sq 1024): every
# program height at each head dim, gapped programs of 32-row blocks (a
# warpgroup's 64 rows from two blocks far apart), 64-row kv blocks, a
# window, and non-causal cross attention (Sk = 2 Sq) -> (D, label, bq,
# bkv, causal, window, Sk)
FLASH_GEOMETRIES = (
    (64, "base", 64, 64, True, None, 1024),
    (64, "con2", 64, 128, True, 200, 1024),
    (64, "gap4", 64, 64, True, None, 1024),
    (128, "gap2", 32, 64, True, None, 1024),
    (128, "con8", 32, 128, True, 200, 1024),
    (128, "gap8", 32, 64, True, 200, 1024),
    (128, "base", 128, 64, False, None, 2048),
    (128, "con2", 128, 128, False, None, 2048),
    (256, "gap2", 32, 64, True, None, 1024),
    (256, "con2", 64, 128, False, None, 2048),
    (256, "base", 64, 64, True, 200, 1024),
)


def flash_geometry_phase(gen: torch.Generator) -> None:
    """The forward at FLASH_GEOMETRIES: o (with and without residuals), m
    and l within the flash limits of the plain version, two launches
    bit-equal."""
    for d, label, bq, bkv, causal, window, sk in FLASH_GEOMETRIES:
        q = torch.randn(2, 4, 1024, d, generator=gen, device="cuda")
        k = torch.randn(2, 2, sk, d, generator=gen, device="cuda")
        v = torch.randn(2, 2, sk, d, generator=gen, device="cuda")
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
        o_r, m_r, l_r = ref.flash_forward(q, k, v, residuals=True, **kw)
        o, m, l = fa_mod.flash_forward(q, k, v, label, residuals=True, **kw)
        again = fa_mod.flash_forward(q, k, v, label, residuals=True, **kw)
        o_nr = fa_mod.flash_forward(q, k, v, label, **kw)
        torch.cuda.synchronize()
        tol = flash_tol(o_r)
        r = {"o": tol_ratio(o, o_r, tol),
             "o (no residuals)": tol_ratio(o_nr, o_r, tol),
             "m": (m - m_r).abs().max().item()
             / (2.0 ** -16 * m_r.abs().max().item()),
             "l": tol_ratio(l, l_r, 2.0 ** -16 * l_r)}
        same = all(torch.equal(x, y) for x, y in zip((o, m, l), again))
        print(f"flash forward D={d} {label} bq={bq} bkv={bkv} causal="
              f"{causal} window={window} Sk={sk}: max error / limit "
              + ", ".join(f"{n} {x:.3f}" for n, x in r.items())
              + f"; two launches bit-equal: {same}", flush=True)
        if not (all(x <= 1 for x in r.values()) and same):
            raise SystemExit(f"flash forward D={d} {label} bq={bq} "
                             f"bkv={bkv} window={window} Sk={sk} disagrees "
                             f"with its plain version")


# backward geometries off the two train shapes -> (B, H, Hkv, Sq, Sk, D,
# label, bq, bkv, causal, window): every program height and q tile (bq 32
# takes 32-row tiles), gapped 16-row kv blocks (dK/dV only: the q axis
# needs bkv % 64), GQA groups of 1, 4, 10 (one cluster of 10) and 32 (two
# clusters of 16, summed by the wrapper), windows, non-causal cross
# attention; each pass the kernels take is held
FLASH_BWD_GEOMETRIES = (
    (2, 4, 2, 1024, 1024, 64, "base", 64, 64, True, None),
    (2, 8, 2, 1024, 1024, 64, "gap4", 64, 64, True, 200),
    (2, 4, 2, 1024, 1024, 128, "gap4", 32, 16, True, None),
    (2, 4, 2, 1024, 1024, 128, "con4", 64, 16, True, 200),
    (2, 4, 2, 1024, 1024, 128, "gap2", 32, 64, True, 200),
    (2, 4, 4, 1024, 2048, 128, "con2", 128, 128, False, None),
    (1, 10, 1, 1024, 1024, 128, "base", 64, 64, True, None),
    (1, 32, 1, 512, 512, 128, "con2", 64, 64, True, None),
    (2, 4, 1, 1024, 1024, 256, "gap2", 32, 64, True, None),
    (2, 4, 2, 1024, 2048, 256, "con2", 64, 64, False, None),
)


def flash_bwd_geometry_phase(gen: torch.Generator) -> None:
    """dQ and dK/dV at FLASH_BWD_GEOMETRIES: each row within the flash
    limits of its plain version, two launches bit-equal; the card's room
    for the dK/dV cluster printed (and required)."""
    for b, h, hkv, sq, sk, d, label, bq, bkv, causal, window in \
            FLASH_BWD_GEOMETRIES:
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").bfloat16()
        g = torch.randn(b, h, sq, d, generator=gen, device="cuda")
        kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
        o_r, m_r, l_r = ref.flash_forward(q, k, v, residuals=True, **kw)
        do_b, delta = fa_mod.flash_bwd_prep(o_r, g)
        res, res_p = (do_b, m_r, l_r, delta), (do_b.float(), m_r, l_r, delta)
        keep = ref._flash_mask(sq, sk, causal, window, q.device)
        cond_dq, cond_dk = flash_cond(q, k, v, *res_p, keep)
        deg = resolve(label).degree
        r, same = {}, True
        if fa_mod.takes(d, deg, bq, bkv, kv_axis=False):
            dq_r = ref.flash_bwd_dq(q, k, v, *res_p, **kw)
            dq = fa_mod.flash_bwd_dq(q, k, v, *res, label, **kw)
            same &= torch.equal(dq, fa_mod.flash_bwd_dq(q, k, v, *res, label,
                                                        **kw))
            r["dq"] = tol_ratio(dq, dq_r, flash_tol(dq_r, cond_dq))
        dk_r, dv_r = ref.flash_bwd_dkv(q, k, v, *res_p, **kw)
        dk, dv = fa_mod.flash_bwd_dkv(q, k, v, *res, label, **kw)
        again = fa_mod.flash_bwd_dkv(q, k, v, *res, label, **kw)
        torch.cuda.synchronize()
        same &= all(torch.equal(x, y) for x, y in zip((dk, dv), again))
        r["dk"] = tol_ratio(dk, dk_r, flash_tol(dk_r, cond_dk))
        r["dv"] = tol_ratio(dv, dv_r, flash_tol(dv_r))
        rows = deg * bkv
        room = fa_mod.dkv_max_clusters(d, rows, bq, bkv, h, hkv)
        print(f"flash backward B={b} H={h}/{hkv} Sq={sq} Sk={sk} D={d} "
              f"{label} bq={bq} bkv={bkv} causal={causal} window={window}: "
              f"max error / limit "
              + ", ".join(f"{n} {x:.3f}" for n, x in r.items())
              + f"; two launches bit-equal: {same}; dK/dV clusters of "
              f"{fa_mod.dkv_cluster(h // hkv)}, {room} at once | dK/dV "
              f"{flash_bwd_build_line('flash_bwd_dkv', d, bq, bkv, deg)}",
              flush=True)
        if not (all(x <= 1 for x in r.values()) and same and room > 0):
            raise SystemExit(f"flash backward D={d} {label} bq={bq} "
                             f"bkv={bkv} window={window} Sk={sk} H={h}/{hkv}"
                             f" disagrees with its plain version")


def sparse_phase(gen: torch.Generator, dense_ms: float) -> dict:
    """Row 8 on the gemma3 train shape for every label: o within the flash
    per-row limits of the plain walk (`ref.flash_sparse`), (m, l) within
    2^-16 of the dense D 256 forward's residuals (kernel and plain); for
    each q block of SPARSE_POISONED, every K/V row outside its live set
    NaN and its rows still held; a plain model of a skipped live slot
    shown to exceed the limit; then the times beside the dense forward's
    (``dense_ms``, windowed, same shape)."""
    b, h, hkv, s, d, bq, bkv, w = (SPARSE[k] for k in (
        "b", "h", "hkv", "s", "d", "bq", "bkv", "window"))
    q, k, v, _ = flash_inputs(gen, SPARSE)
    kw = dict(bq=bq, bkv=bkv, window=w)
    idx = sp_mod.device_index(s, s, bq, bkv, causal=True, window=w,
                              global_stride=None, device="cuda")
    want, m_r, l_r = ref.flash_sparse(q, k, v, idx, **kw)
    tol = flash_tol(want)
    _, m_d, l_d = fa_mod.flash_forward(q, k, v, residuals=True, **kw)
    _, m_p, l_p = ref.flash_forward(q, k, v, residuals=True, **kw)
    tol_m = 2.0 ** -16 * m_p.abs().max().item()
    tol_l = 2.0 ** -16 * l_p
    for name, m_, l_ in (("dense kernel", m_d, l_d),
                         ("dense plain", m_p, l_p), ("plain walk", m_r, l_r)):
        print(f"sparse: (m, l) of the {name} against the dense plain "
              f"forward's: {(m_ - m_p).abs().max().item() / tol_m:.3f}, "
              f"{tol_ratio(l_, l_p, tol_l):.3f} of the limits", flush=True)
    # the fault model: every q block but the first (whose only block it
    # is) skips its first live slot
    lost = idx.clone()
    lost[1:, 0] = sp_mod.NULL_BLOCK
    bad = ref.flash_sparse(q, k, v, lost, **kw)[0]
    ratio = tol_ratio(bad, want, tol)
    print(f"sparse fault model, first live slot skipped: max deviation / "
          f"limit {ratio:.2f}", flush=True)
    if not ratio > 1:
        raise SystemExit("the sparse limit would not catch a skipped slot")
    del bad

    worst = 0.0
    idx_h = idx.cpu()
    for label in SPARSE_LABELS:
        o, m, l = sp_mod.flash_sparse_fwd(q, k, v, idx, label, residuals=True,
                                          **kw)
        o_nr = sp_mod.flash_sparse_fwd(q, k, v, idx, label, **kw)
        torch.cuda.synchronize()
        r = {"o": tol_ratio(o, want, tol),
             "o (no residuals)": tol_ratio(o_nr, want, tol),
             "m vs dense kernel": (m - m_d).abs().max().item() / tol_m,
             "l vs dense kernel": tol_ratio(l, l_d, tol_l),
             "m vs plain": (m - m_p).abs().max().item() / tol_m,
             "l vs plain": tol_ratio(l, l_p, tol_l)}
        err = max((o - want).abs().max().item(),
                  (o_nr - want).abs().max().item())
        # NaN outside the live set of one q block at a time: that block's
        # rows must come out finite and within the limit
        for qb in SPARSE_POISONED:
            live = idx_h[qb][idx_h[qb] >= 0].tolist()
            dead = torch.ones(s, dtype=torch.bool, device="cuda")
            for j in live:
                dead[j * bkv:(j + 1) * bkv] = False
            kp, vp = k.clone(), v.clone()
            kp[:, :, dead] = float("nan")
            vp[:, :, dead] = float("nan")
            rows = slice(qb * bq, (qb + 1) * bq)
            op = sp_mod.flash_sparse_fwd(q, kp, vp, idx, label, **kw)
            op, wq = op[:, :, rows], want[:, :, rows]
            r[f"poisoned q block {qb}"] = (
                tol_ratio(op, wq, tol[:, :, rows])
                if torch.isfinite(op).all() else math.inf)
            err = max(err, (op - wq).abs().max().item())
            del kp, vp
        print(f"sparse {label:4s}: max|kernel-plain| {err:.3e}; max error / "
              f"limit " + ", ".join(f"{n} {x:.3f}" for n, x in r.items()),
              flush=True)
        if not all(x <= 1 for x in r.values()):
            raise SystemExit(f"sparse kernel under {label} disagrees with "
                             f"its plain version")
        worst = max(worst, err)

    # LongFormer-style global columns on the window (the kernel's other
    # mask): the index lists their blocks too
    gs = SPARSE_GLOBAL_STRIDE
    idx_g = sp_mod.device_index(s, s, bq, bkv, causal=True, window=w,
                                global_stride=gs, device="cuda")
    want_g = ref.flash_sparse(q, k, v, idx_g, global_stride=gs, **kw)[0]
    for label in ("base", "gap2"):
        got = sp_mod.flash_sparse_fwd(q, k, v, idx_g, label, global_stride=gs,
                                      **kw)
        r, err = (tol_ratio(got, want_g, flash_tol(want_g)),
                  (got - want_g).abs().max().item())
        print(f"sparse {label:4s} global stride {gs} (index width "
              f"{idx_g.shape[1]}): max|kernel-plain| {err:.3e}; max error / "
              f"limit {r:.3f}", flush=True)
        if not r <= 1:
            raise SystemExit(f"sparse kernel under {label} with global "
                             f"columns disagrees with its plain version")
        worst = max(worst, err)
    del want_g

    # bound: q, k, v bf16 in, o f32 and (m, l) out, the index; the work of
    # the live (q, k) pairs only
    keep = flash_keep(s, w, q.device)
    pairs = b * h * int(keep.sum().item())
    io_bytes = (b * h * s * d * 2 + 2 * b * hkv * s * d * 2
                + b * h * s * d * 4 + 2 * b * h * s * 4 + idx.numel() * 4)
    flops = 4 * d * pairs
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    ms = time_ms(lambda: sp_mod.flash_sparse_fwd(q, k, v, idx, residuals=True,
                                                 **kw))
    plain_ms = time_ms(lambda: ref.flash_sparse(q, k, v, idx, **kw), reps=5)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=keep, enable_gqa=True))
    labels = {label: time_ms(lambda: sp_mod.flash_sparse_fwd(
        q, k, v, idx, label, residuals=True, **kw))
        for label in SPARSE_LABELS[1:]}
    print(f"flash_sparse timing (base, B={b} H={h} Hkv={hkv} S={s} D={d} "
          f"window={w}, {int((idx >= 0).sum())} live of "
          f"{(s // bq) * (s // bkv + 1) // 2} causal kv blocks): kernel "
          f"{ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}) | plain "
          f"{plain_ms:.4f} ms | sdpa (window mask) {lib_ms:.4f} ms | dense "
          f"flash forward, same shape and mask, {dense_ms:.4f} ms; labels "
          + ", ".join(f"{n} {t:.4f}" for n, t in labels.items()), flush=True)
    return {"name": "flash_sparse_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_attention.cu",
            "replaces": "src/repro/kernels/sparse_attention.py:287",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms}


# -- phase 3: the MoE kernels, the dequant-fused matmul, int8-pool decode ----

# qwen2-moe-a2.7b (hf:Qwen/Qwen1.5-MoE-A2.7B): 60 routed experts padded to 64,
# top-4, expert width 1408, d 2048; its shared experts are one SwiGLU of
# width 4 x 1408 = 5632.  Capacities as the serve phase gives them: 128 in a
# prefill chunk (8 slots x 16 tokens), 8 in a decode step (max(4, min(8, 16))).
MOE = dict(e=64, n_routed=60, top_k=4, d=2048, f=1408)
MOE_CAPS = (128, 8)
MOE_LABELS = ("base", "con2", "gap2")
# Row 9 rounds h to bf16 once, as its plain version does, but its f32 sums
# run in another order, so a rounding of h can land one bf16 ulp (2^-7 of
# |h| at most) apart: per element |kernel - plain| <= 2^-7 * comb *
# (|h| @ |w2|) covers every h term landing an ulp apart; the f32 sums' own
# order error (F * 2^-24 of the same product) is far below it.
MOE_EPS = 2.0 ** -7
# Row 11 keeps h in f32 (hi + lo bf16 in the second product, 2^-17 of h),
# forms exact products and applies the scales after them, and sums in f32:
# 2^-12 of the same magnitude product is far above those errors (f32 sums
# over 2048 and 1408 terms with random signs) and far below a lost scale
# group.
QMOE_EPS = 2.0 ** -12
# Row 10: an f32 dot of K exact products in any order is within K * 2^-24
# of |a| @ |w|; the scale applied after the sum adds one rounding.  The
# kernel splits K over the blocks of a cluster and adds the slices' sums in
# slice order: two launches must give the same bits.
QMM_MAIN = ((128, 2048, 5632), (128, 2048, 5632), (128, 5632, 2048))
# qwen3-0.6b's FFN (hf:Qwen/Qwen3-0.6B, d 1024, d_ff 3072) at a prefill
# chunk of 128 rows, where the split differs most (S 4 and S 9 > 8)
QMM_QWEN3 = ((128, 1024, 3072), (128, 3072, 1024))
QMM_CASES = [((128, 2048, 5632), "base"), ((128, 5632, 2048), "base"),
             ((256, 2048, 5632), "con2"), ((256, 2048, 5632), "gap2"),
             *((shape, "base") for shape in QMM_QWEN3)]
# int8-pool decode at qwen2-moe's attention (16/16 heads, hd 128), 8 slots,
# max_len 512 at page size 16; the limit is the bf16 kernel's (DEC_ULPS)
DEC8 = dict(b=8, h=16, hkv=16, d=128, ps=16, npp=32)


def limit_ratio(got, want, tol) -> float:
    """Largest |got - want| / tol; where tol is 0 (a row whose combine
    weight is 0) the two must be equal."""
    diff = (got - want).abs()
    r = torch.where(tol > 0, diff / tol.clamp_min(1e-30),
                    torch.where(diff > 0, math.inf, 0.0))
    return r.max().item()


def bound(io_bytes: float, flops: float):
    t_b, t_o = io_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def moe_dispatch(gen, t: int, cap: int):
    """The MoE layer's dispatch of t random tokens (`layers.moe`): softmax
    top-4 over the 60 routed experts, renormalised, top-``cap`` tokens per
    expert -> xe (64, cap, d) bf16 with dead rows zeroed, comb (64, cap)."""
    e, d = MOE["e"], MOE["d"]
    xt = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
    logits = torch.randn(t, e, generator=gen, device="cuda") * 2.0
    logits[:, MOE["n_routed"]:] = -1e30
    w, idx = torch.topk(torch.softmax(logits, -1), MOE["top_k"], dim=-1)
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    tokw = torch.einsum("tke,tk->et",
                        torch.nn.functional.one_hot(idx, e).float(), w)
    topw, topi = torch.topk(tokw, cap, dim=-1)
    live = topw > 0
    xe = xt[topi.reshape(-1)].reshape(e, cap, d) * live[..., None]
    return xe.bfloat16().contiguous(), (topw * live).contiguous()


def moe_weights(gen):
    e, d, f = MOE["e"], MOE["d"], MOE["f"]

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                ).bfloat16()
    return (normal((e, d, f), d ** -0.5), normal((e, d, f), d ** -0.5),
            normal((e, f, d), f ** -0.5))


def moe_mag(xe, w1, w3, w2, comb, round_h: bool):
    """comb * (|h| @ |w2|), the scale of each output's error; weights are
    bf16 panes or dequantized f32 panes."""
    x = xe.float()
    h = torch.nn.functional.silu(x @ w1.float()) * (x @ w3.float())
    if round_h:
        h = h.bfloat16().float()
    return (h.abs() @ w2.float().abs()) * comb[..., None]


def moe_work(xe, comb, wbytes_per_expert: float):
    """Bytes and operations the function needs on these inputs: the live
    experts' weights and the live rows of x read once, comb read and the
    whole f32 y written once; 6 d F per live row."""
    e, c, d = xe.shape
    live_e = int((comb > 0).any(dim=1).sum().item())
    rows = int((comb > 0).sum().item())
    io = live_e * wbytes_per_expert + rows * d * 2 + e * c * 4 \
        + e * c * d * 4
    return io, 6 * rows * d * MOE["f"], live_e, rows


def bmm_chain(xe, w1, w3, w2, comb):
    """Yardstick: cuBLAS batched bf16 products of the same chain."""
    h = torch.nn.functional.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    return torch.bmm(h, w2) * comb[..., None]


def moe_phase(gen) -> dict:
    """Row 9 (`moe_ffn.py:90`): every label at both capacities, a lost
    expert as its fault model, then times at capacity 128."""
    w1, w3, w2 = moe_weights(gen)
    worst, timing = 0.0, {}
    for cap in MOE_CAPS:
        xe, comb = moe_dispatch(gen, cap, cap)
        want = ref.moe_ffn(xe, w1, w3, w2, comb)
        tol = MOE_EPS * moe_mag(xe, w1, w3, w2, comb, round_h=True)
        e0 = int((comb > 0).any(dim=1).nonzero()[0].item())
        bad = want.clone()
        bad[e0] = 0
        fault = limit_ratio(bad, want, tol)
        for label in MOE_LABELS:
            got = ops.moe_ffn(xe, w1, w3, w2, comb, label)
            torch.cuda.synchronize()
            r = limit_ratio(got, want, tol)
            err = (got - want).abs().max().item()
            print(f"moe_ffn C={cap} {label}: max|kernel-plain| {err:.3e}; "
                  f"max error / limit {r:.4f}; fault model (expert {e0} "
                  f"lost) / limit {fault:.1f}", flush=True)
            if not r <= 1:
                raise SystemExit(f"moe_ffn kernel {label} at C={cap} "
                                 f"disagrees with its plain version")
            worst = max(worst, err)
        if not fault > 1:
            raise SystemExit("the moe_ffn limit would not catch a lost "
                             "expert")
        io, flops, live_e, rows = moe_work(xe, comb,
                                           3 * MOE["d"] * MOE["f"] * 2)
        bms, by = bound(io, flops)
        t = {"ms": time_ms(lambda: ops.moe_ffn(xe, w1, w3, w2, comb)),
             "plain_ms": time_ms(lambda: ref.moe_ffn(xe, w1, w3, w2, comb),
                                 reps=5),
             "library_ms": time_ms(lambda: bmm_chain(xe, w1, w3, w2, comb)),
             "bound_ms": bms, "bound_by": by}
        timing[cap] = t
        print(f"moe_ffn timing (E=64 C={cap} d=2048 F=1408, base, "
              f"{live_e} live experts, {rows} live rows): kernel "
              f"{t['ms']:.4f} ms | bound {bms:.4f} ms ({by}) | plain "
              f"{t['plain_ms']:.4f} ms | torch.bmm chain "
              f"{t['library_ms']:.4f} ms", flush=True)
        del xe, comb, want, tol, bad
    return {"name": "moe_ffn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_ffn.cu",
            "replaces": "src/repro/kernels/moe_ffn.py:90",
            "max_abs_err": worst, **timing[MOE_CAPS[0]]}


def mixed_dispatch(gen, cap: int):
    """A dispatch the layer's rule rarely makes, at capacity ``cap``: expert
    e1 with 24 live rows, expert e2 with every row live, expert e3 all dead
    between live neighbours, and every expert's rows (x with comb) shuffled
    along C, so that live rows lie over non-leading 16-row tiles."""
    e, d = MOE["e"], MOE["d"]
    xe, comb = moe_dispatch(gen, cap, cap)
    live_e = (comb > 0).any(dim=1).nonzero().flatten().tolist()
    e1, e2 = live_e[0], live_e[1]
    e3 = next(x for x in live_e[2:] if x - 1 in live_e and x + 1 in live_e)
    for ex, rows in ((e1, 24), (e2, cap)):
        comb[ex] = 0
        comb[ex, :rows] = torch.rand(rows, generator=gen, device="cuda") \
            * 0.9 + 0.05
        xe[ex, :rows] = torch.randn(rows, d, generator=gen,
                                    device="cuda").bfloat16()
    comb[e3], xe[e3] = 0, 0
    perm = torch.randperm(cap, generator=gen, device="cuda")
    return (xe[:, perm].contiguous(), comb[:, perm].contiguous(),
            (e1, e2, e3))


def quant_moe_faults(xe, qs, comb, want, tol, bits: int) -> dict:
    """Plain-version models of what can go wrong in row 11 (each must exceed
    the limit): a lost scale (int8: w2's column 0, int4: w2's group row 0),
    one 128-row K stage of x@w1 dropped, a live 16-row tile skipped, and at
    int4 w1's nibbles swapped and its group scales off by one group."""
    e0 = int((comb > 0).any(dim=1).nonzero()[0].item())
    out = {}
    sc = qs[2].scale.clone()
    if bits == 8:
        sc[e0, 0, 0] = 0.0           # column 0's scale
    else:
        sc[e0, 0] = 0.0              # group row 0
    out["lost scale"] = ref.quant_moe_ffn(
        xe, qs[0], qs[1], dataclasses.replace(qs[2], scale=sc), comb)
    bad_x = xe.clone()
    bad_x[e0, :, 128:256] = 0
    out["K stage dropped"] = ref.quant_moe_ffn(bad_x, *qs, comb)
    skipped = want.clone()
    t = int((comb[e0] > 0).nonzero()[-1].item()) // 16
    skipped[e0, 16 * t:16 * t + 16] = 0
    out["live tile skipped"] = skipped
    if bits == 4:
        out["nibbles swapped"] = ref.quant_moe_ffn(
            xe, swapped_nibbles(qs[0]), qs[1], qs[2], comb)
        sc1 = qs[0].scale.clone()
        sc1[e0] = torch.roll(sc1[e0], 1, dims=0)
        out["scales a group off"] = ref.quant_moe_ffn(
            xe, dataclasses.replace(qs[0], scale=sc1), qs[1], qs[2], comb)
    return {k: limit_ratio(v, want, tol) for k, v in out.items()}


def quant_moe_phase(gen) -> dict:
    """Row 11 (`moe_ffn.py:190`): int8 and int4, every label at both
    capacities on the layer's dispatch and, at C 128, on `mixed_dispatch`;
    every case launched twice and bit-equal; the fault models of
    `quant_moe_faults`; each instance's local memory (any fails); times at
    both capacities, with a call's host microseconds."""
    for name, local, regs in moe_mod.instances():
        print(f"quant_moe_ffn instance {name}: {regs} registers, {local} "
              f"bytes of local memory", flush=True)
        if local:
            raise SystemExit(f"quant_moe_ffn instance {name} uses local "
                             f"memory")
    w1, w3, w2 = moe_weights(gen)
    worst, timing = 0.0, {}
    smi = smi_line()
    for bits in (8, 4):
        qs = [quantize(w, f"int{bits}") for w in (w1, w3, w2)]
        dq = [dequantize(q) for q in qs]
        dqb = [d.bfloat16() for d in dq]
        for cap in MOE_CAPS:
            cases = [("layer", *moe_dispatch(gen, cap, cap))]
            if cap == MOE_CAPS[0]:
                xm, cm, (e1, e2, e3) = mixed_dispatch(gen, cap)
                cases.append((f"mixed (e{e1} 24 rows shuffled, e{e2} all "
                              f"{cap} rows, e{e3} dead)", xm, cm))
            for what, xe, comb in cases:
                want = ref.quant_moe_ffn(xe, *qs, comb)
                tol = QMOE_EPS * moe_mag(xe, *dq, comb, round_h=False)
                faults = quant_moe_faults(xe, qs, comb, want, tol, bits)
                for label in MOE_LABELS:
                    got = ops.quant_moe_ffn(xe, *qs, comb, label)
                    again = ops.quant_moe_ffn(xe, *qs, comb, label)
                    torch.cuda.synchronize()
                    r = limit_ratio(got, want, tol)
                    err = (got - want).abs().max().item()
                    print(f"quant_moe_ffn int{bits} C={cap} {what} {label}: "
                          f"max|kernel-plain| {err:.3e}; max error / limit "
                          f"{r:.4f}; two launches "
                          f"{bits_differ(again, got)} bits apart",
                          flush=True)
                    if not r <= 1:
                        raise SystemExit(f"quant_moe_ffn int{bits} {label} "
                                         f"at C={cap} ({what}) disagrees "
                                         f"with its plain version")
                    hold_equal(f"quant_moe_ffn int{bits} C={cap} {label} "
                               f"relaunch", again, got)
                    worst = max(worst, err)
                print(f"quant_moe_ffn int{bits} C={cap} {what}: fault models "
                      f"/ limit: " + ", ".join(f"{k} {v:.1f}"
                                               for k, v in faults.items()),
                      flush=True)
                bad = [k for k, v in faults.items() if not v > 1]
                if bad:
                    raise SystemExit(f"the quant_moe_ffn limit would not "
                                     f"catch: {', '.join(bad)}")
            xe, comb = cases[0][1], cases[0][2]
            wb = sum(q.nbytes for q in qs) / MOE["e"]
            io, flops, live_e, rows = moe_work(xe, comb, wb)
            bms, by = bound(io, flops)
            t = {"ms": time_ms(lambda: ops.quant_moe_ffn(xe, *qs, comb)),
                 "plain_ms": time_ms(
                     lambda: ref.quant_moe_ffn(xe, *qs, comb), reps=5),
                 "library_ms": time_ms(lambda: bmm_chain(xe, *dqb, comb)),
                 "bound_ms": bms, "bound_by": by}
            us = host_us(lambda: ops.quant_moe_ffn(xe, *qs, comb))
            timing[(bits, cap)] = t
            print(f"quant_moe_ffn int{bits} timing (C={cap}, base, {live_e} "
                  f"live experts, {rows} live rows; {smi}): kernel "
                  f"{t['ms']:.4f} ms | bound {bms:.4f} ms ({by}) | plain "
                  f"{t['plain_ms']:.4f} ms | torch.bmm chain on dequantized "
                  f"bf16 panes {t['library_ms']:.4f} ms | host {us:.1f} us "
                  f"a call", flush=True)
            del xe, comb
        del qs, dq, dqb
    return {"name": "quant_moe_ffn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quant_moe_ffn.cu",
            "replaces": "src/repro/kernels/moe_ffn.py:190",
            "max_abs_err": worst, **timing[(8, MOE_CAPS[0])]}


def swapped_nibbles(qw):
    """Fault model: the packed int4 weight with its two nibbles swapped."""
    q = (qw.q >> 4) | ((qw.q & 0xF) << 4)
    return dataclasses.replace(qw, q=q)


def qmm_build_line(bits: int, degree: int) -> str:
    """The ptxas registers / spills of the dequant-fused kernel's instance
    (from this run's build), or "not printed"."""
    return build_line("quant_matmul", f"qmm_kernelILi{bits}ELi{degree}E")


def quant_matmul_phase(gen) -> dict:
    """Row 10 (`matmul.py:142`): int8 and int4 at the shared-expert FFN's
    prefill products (and con2 / gap2 at M = 256) and at qwen3-0.6b's;
    swapped nibbles (int4) and a lost column scale (int8) as fault models;
    two launches bit-equal; times of the three products of one prefill
    chunk, then of each product with its K split."""
    worst = 0.0
    sms = mm_mod.sm_count(torch.device("cuda"))
    for bits in (8, 4):
        for (m, k, n), label in QMM_CASES:
            a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
            qw = quantize(w, f"int{bits}")
            want = ref.quant_matmul(a, qw)
            tol = k * 2.0 ** -24 * (a.float().abs() @ dequantize(qw).abs())
            if bits == 4:
                bad_w, what = swapped_nibbles(qw), "swapped nibbles"
            else:
                sc = qw.scale.clone()
                sc[0, 0] = 0.0
                bad_w, what = dataclasses.replace(qw, scale=sc), \
                    "column 0's scale lost"
            fault = limit_ratio(ref.quant_matmul(a, bad_w), want, tol)
            got = ops.quant_matmul(a, qw, label)
            again = ops.quant_matmul(a, qw, label)
            torch.cuda.synchronize()
            r = limit_ratio(got, want, tol)
            err = (got - want).abs().max().item()
            same = torch.equal(got, again)
            plan = mm_mod.split_plan(m, n, k, label, bits, qw.group, sms)
            print(f"quant_matmul int{bits} ({m}x{k})@({k}x{n}) {label}: "
                  f"max|kernel-plain| {err:.3e}; max error / limit {r:.4f}; "
                  f"fault model ({what}) / limit {fault:.1f}; S "
                  f"{plan.splits}; two launches bit-equal: {same}",
                  flush=True)
            if not r <= 1:
                raise SystemExit(f"quant_matmul int{bits} {label} disagrees "
                                 f"with its plain version")
            if not same:
                raise SystemExit(f"quant_matmul int{bits} {label} gave "
                                 f"other bits on a second launch")
            if not fault > 1:
                raise SystemExit(f"the quant_matmul limit would not catch "
                                 f"{what}")
            worst = max(worst, err)
    timing = {}
    for bits in (8, 4):
        prods = []
        for m, k, n in QMM_MAIN:
            a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            qw = quantize(torch.randn(k, n, generator=gen, device="cuda")
                          / math.sqrt(k), f"int{bits}")
            prods.append((a, qw, dequantize(qw).bfloat16()))
        io = sum(2 * m * k + qw.nbytes + 4 * m * n
                 for (m, k, n), (_, qw, _) in zip(QMM_MAIN, prods))
        bms, by = bound(io, sum(2 * m * n * k for m, k, n in QMM_MAIN))
        has_f32 = mm_f32(prods[0][0], prods[0][2]) is not None
        bf16_ms = time_ms(lambda: [torch.matmul(a, wd)
                                   for a, _, wd in prods])
        f32_ms = (time_ms(lambda: [mm_f32(a, wd) for a, _, wd in prods])
                  if has_f32 else None)
        t = {"ms": time_ms(lambda: [ops.quant_matmul(a, qw)
                                    for a, qw, _ in prods]),
             "plain_ms": time_ms(lambda: [ref.quant_matmul(a, qw)
                                          for a, qw, _ in prods]),
             "library_ms": f32_ms if has_f32 else bf16_ms,
             "bound_ms": bms, "bound_by": by}
        timing[bits] = t
        f32_text = (f"{f32_ms:.4f} ms" if has_f32 else
                    "not measured (this PyTorch has no aten::mm.dtype)")
        print(f"quant_matmul int{bits} timing (shared-expert FFN gate+up+"
              f"down at T=128, base): kernel {t['ms']:.4f} ms | bound "
              f"{bms:.4f} ms ({by}) | plain {t['plain_ms']:.4f} ms | "
              f"torch.matmul on the dequantized bf16 weight {bf16_ms:.4f} "
              f"ms | torch.mm f32 out on it {f32_text}", flush=True)
        # each product alone: the shared expert's gate (= up) and down,
        # qwen3-0.6b's up and down
        for m, k, n in (*QMM_MAIN[1:], *QMM_QWEN3):
            a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            qw = quantize(torch.randn(k, n, generator=gen, device="cuda")
                          / math.sqrt(k), f"int{bits}")
            wd = dequantize(qw).bfloat16()
            plan = mm_mod.split_plan(m, n, k, BASE, bits, qw.group, sms)
            one, one_by = bound(2 * m * k + qw.nbytes + 4 * m * n,
                                2 * m * n * k)
            print(f"quant_matmul int{bits} ({m}x{k})@({k}x{n}) base: kernel "
                  f"{time_ms(lambda: ops.quant_matmul(a, qw)):.4f} ms | "
                  f"bound {one:.4f} ms ({one_by}) | torch.matmul "
                  f"{time_ms(lambda: torch.matmul(a, wd)):.4f} ms | S "
                  f"{plan.splits}, grid {plan.grid} = {plan.blocks} blocks "
                  f"on {sms} SMs | build: {qmm_build_line(bits, 1)}",
                  flush=True)
            del a, qw, wd
    return {"name": "quant_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:142",
            "max_abs_err": worst, **timing[8]}


def decode_int8_phase(gen) -> dict:
    """Row 1's int8-pool variant (`decode_attention.py:342`, kv_bits=8):
    int8 pools quantized per row and kv head, a permuted block table, rows
    past each slot's pos and unreferenced pages poisoned (payload 127,
    scale 1e4); every label with and without a window; the V scales of one
    live page read as 0 as the fault model."""
    b, h, hkv, d, ps, npp = (DEC8[k] for k in ("b", "h", "hkv", "d", "ps",
                                                "npp"))
    n_pages = b * npp + 5
    kq, ks = quantize_kv(torch.randn(n_pages, ps, hkv, d, generator=gen,
                                     device="cuda"))
    vq, vs = quantize_kv(torch.randn(n_pages, ps, hkv, d, generator=gen,
                                     device="cuda"))
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")[:b * npp]
    bt = (perm + 1).reshape(b, npp).to(torch.int32)
    # live lengths as the serve phase sees them: prompt 64-255 + generated
    pos = torch.randint(64, 287, (b,), generator=gen, device="cuda")
    rows = torch.arange(npp * ps, device="cuda")
    dead = rows[None, :] > pos[:, None]
    page_of = bt.long()[:, rows // ps]
    r_of = (rows % ps).expand(b, -1)
    unref = torch.ones(n_pages, dtype=torch.bool, device="cuda")
    unref[bt.long().flatten()] = False
    for pool, sc in ((kq, ks), (vq, vs)):
        pool[page_of[dead], r_of[dead]] = 127
        sc[page_of[dead], r_of[dead]] = 1e4
        pool[unref] = 127
        sc[unref] = 1e4
    pos = pos.to(torch.int32)
    worst = 0.0
    vs_bad = vs.clone()               # a page of slot 0 live in any window
    vs_bad[bt[0, (pos[0].item() - 20) // ps].long()] = 0.0
    for label in MOE_LABELS:
        cfg = CoarseningConfig.parse(label)
        for window in (None, 100):
            kw = dict(degree=cfg.degree, gapped=cfg.kind == "gapped",
                      window=window)
            got = ops.paged_decode_attention(q, kq, vq, bt, pos, label,
                                             window=window, k_scale=ks,
                                             v_scale=vs)
            torch.cuda.synchronize()
            want = ref.verify_split_kv(q, kq, vq, bt, pos, k_scale=ks,
                                      v_scale=vs, **kw)
            oracle = ref.paged_decode_attention(q, kq, vq, bt, pos,
                                                window=window, k_scale=ks,
                                                v_scale=vs)
            bad = ref.verify_split_kv(q, kq, vq, bt, pos, k_scale=ks,
                                     v_scale=vs_bad, **kw)
            tol, tol_o = dec_tol(want), dec_tol(oracle)
            err = (got.float() - want.float()).abs().max().item()
            err_o = (got.float() - oracle.float()).abs().max().item()
            fault = (bad.float() - want.float()).abs().max().item() / tol
            print(f"decode int8 {label:4s} window={window}: max|kernel-"
                  f"plain| / limit {err / tol:.3f}, max|kernel-gather "
                  f"oracle| / limit {err_o / tol_o:.3f}; fault model (V "
                  f"scales of a live page lost) / limit {fault:.1f}",
                  flush=True)
            if not (err <= tol and err_o <= tol_o):
                raise SystemExit(f"int8 decode kernel {label} disagrees "
                                 f"with its plain version")
            if not fault > 1:
                raise SystemExit("the int8 decode limit would not catch a "
                                 "lost page of V scales")
            worst = max(worst, err, err_o)
    live = pos.long() + 1
    pages = int(((live + ps - 1) // ps).sum().item())
    io = int(live.sum().item()) * hkv * 2 * (d + 4) + 2 * b * h * d * 2 \
        + pages * 4 + b * 4
    bms, by = bound(io, 4 * int(live.sum().item()) * h * d)
    ms = time_ms(lambda: ops.paged_decode_attention(q, kq, vq, bt, pos,
                                                    k_scale=ks, v_scale=vs))
    plain_ms = time_ms(lambda: ref.verify_split_kv(q, kq, vq, bt, pos,
                                                  k_scale=ks, v_scale=vs))
    kv = (ref.gather_pages(kq, bt).float() * ref.gather_scales(ks, bt)[
        ..., None]).bfloat16().transpose(1, 2).contiguous()
    vv = (ref.gather_pages(vq, bt).float() * ref.gather_scales(vs, bt)[
        ..., None]).bfloat16().transpose(1, 2).contiguous()
    mask = (torch.arange(kv.shape[2], device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qs = q.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kv, vv, attn_mask=mask))
    print(f"decode int8 timing (base, B={b} H={h} Hkv={hkv} D={d} ps={ps}, "
          f"live rows {int(live.sum())}): kernel {ms:.4f} ms | bound "
          f"{bms:.4f} ms ({by}) | plain {plain_ms:.4f} ms | sdpa on "
          f"dequantized pre-gathered bf16 views {lib_ms:.4f} ms", flush=True)
    return {"name": "paged_decode_attention_int8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:342",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


# -- phase 3: contiguous decode (row 3) and short-q verify (row 4) ------------

# row 3: BatchedServer's decode at qwen3-0.6b's widths, 8 slots, max_len 1024,
# the reference's decode_bkv of 128; row 4: SpecPagedEngine's verify at the
# same widths with K = 4 (T = 5 rows a slot), page 16, 64 pages a slot.  Both
# are held at DEC_ULPS like the paged decode.
CONTIG = dict(b=8, h=16, hkv=8, d=128, s=1024, bkv=128)
VER = dict(b=8, h=16, hkv=8, d=128, ps=16, npp=64, t=5)
# the widened geometries of the rows kernel: yi-34b / qwen2-vl-7b verify at
# --spec-k 4 (G 7, T*G 35) and recurrentgemma-2b's (G 10, one kv head,
# D 256, T*G 50)
VER_WIDE = (dict(b=4, h=56, hkv=8, d=128, ps=16, npp=64, t=5),
            dict(b=4, h=10, hkv=1, d=256, ps=16, npp=64, t=5))


def kv_operands(k, v, dead, quant: bool):
    """bf16 K/V, or int8 K/V quantized per row and kv head with their f32
    scales; rows under ``dead`` poisoned (1e4, or payload 127 at scale
    1e4) -> (k, v, scales kwargs)."""
    if not quant:
        k, v = k.bfloat16(), v.bfloat16()
        k[dead], v[dead] = 1e4, 1e4
        return k, v, {}
    (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    for x, sc in ((k, ks), (v, vs)):
        x[dead], sc[dead] = 127, 1e4
    return k, v, {"k_scale": ks, "v_scale": vs}


def dequant(x, sc):
    """int8 rows times their scales in f32; bf16 rows as they are."""
    return x if sc is None else x.float() * sc[..., None]


def contig_phase(gen: torch.Generator, quant: bool) -> dict:
    """Row 3 (`decode_attention.py:171`, bf16 or int8 caches): every label
    with and without a window; slot 7 carries pos = S + 6, a finished
    slot's position after a decode block of 8, so every row of it counts
    and none past S may be read; rows past each other slot's pos are
    poisoned.  Fault model: one live kv block of slot 0 lost (bf16: its K
    and V rows read as 0; int8: its V scales)."""
    b, h, hkv, d, s, bkv = (CONTIG[k] for k in ("b", "h", "hkv", "d", "s",
                                                 "bkv"))
    tag = "int8" if quant else "bf16"
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda").bfloat16()
    pos = torch.randint(128, 576, (b,), generator=gen, device="cuda")
    pos[-1] = s + 6
    dead = torch.arange(s, device="cuda")[None, :] > pos[:, None]
    k, v, sc = kv_operands(
        torch.randn(b, s, hkv, d, generator=gen, device="cuda"),
        torch.randn(b, s, hkv, d, generator=gen, device="cuda"), dead, quant)
    pos = pos.to(torch.int32)
    blk0 = (pos[0].item() - 20) // bkv * bkv          # live in any window
    if quant:
        bad = dict(sc, v_scale=sc["v_scale"].clone())
        bad["v_scale"][0, blk0:blk0 + bkv] = 0.0
        kb, vb = k, v
    else:
        bad, kb, vb = sc, k.clone(), v.clone()
        kb[0, blk0:blk0 + bkv], vb[0, blk0:blk0 + bkv] = 0.0, 0.0
    worst = 0.0
    for label in DEC_LABELS:
        cfg = CoarseningConfig.parse(label)
        for window in (None, 100):
            kw = dict(degree=cfg.degree, gapped=cfg.kind == "gapped",
                      bkv=bkv, window=window)
            got = ops.decode_attention(q, k, v, pos, label, bkv=bkv,
                                       window=window, **sc)
            again = ops.decode_attention(q, k, v, pos, label, bkv=bkv,
                                         window=window, **sc)
            torch.cuda.synchronize()
            want = ref.split_kv(q, k, v, pos, **kw, **sc)
            fault = ref.split_kv(q, kb, vb, pos, **kw, **bad)
            tol = dec_tol(want)
            err = (got.float() - want.float()).abs().max().item()
            ratio = (fault.float() - want.float()).abs().max().item() / tol
            line = (f"contiguous decode {tag} {label:5s} window={window}: "
                    f"max|kernel-plain| / limit {err / tol:.3f}; fault "
                    f"model (a live kv block lost) / limit {ratio:.1f}; "
                    f"two launches bit-equal: {torch.equal(got, again)}")
            ok = err <= tol
            if window is None:             # the dense oracle, every row
                oracle = ref.decode_attention(
                    q, dequant(k, sc.get("k_scale")),
                    dequant(v, sc.get("v_scale")), pos)
                err_o = (got.float() - oracle.float()).abs().max().item()
                tol_o = dec_tol(oracle)
                line += (f"; max|kernel-dense oracle| / limit "
                         f"{err_o / tol_o:.3f}")
                ok = ok and err_o <= tol_o
                err = max(err, err_o)
            print(line, flush=True)
            if not ok:
                raise SystemExit(f"contiguous decode kernel {tag} {label} "
                                 f"disagrees with its plain version")
            if not ratio > 1:
                raise SystemExit("the contiguous decode limit would not "
                                 "catch a lost kv block")
            if not torch.equal(got, again):
                raise SystemExit(f"contiguous decode kernel {tag} {label} "
                                 f"gave other bits on a second launch")
            worst = max(worst, err)

    live = torch.clamp(pos.long() + 1, max=s)
    n_live = int(live.sum().item())
    io = n_live * hkv * 2 * (d * k.element_size() + (4 if quant else 0)) \
        + 2 * b * h * d * 2 + b * 4
    bms, by = bound(io, 4 * n_live * h * d)
    ms = time_ms(lambda: ops.decode_attention(q, k, v, pos, bkv=bkv, **sc))
    plain_ms = time_ms(lambda: ref.split_kv(q, k, v, pos, bkv=bkv, **sc))
    # yardstick: SDPA on the contiguous (dequantized) cache with a length
    # mask, K/V heads expanded for GQA outside the timing
    kx, vx = (dequant(x, sc.get(n)).bfloat16().transpose(1, 2)
              .repeat_interleave(h // hkv, dim=1).contiguous()
              for x, n in ((k, "k_scale"), (v, "v_scale")))
    mask = (torch.arange(s, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qs = q.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kx, vx, attn_mask=mask))
    print(f"contiguous decode {tag} timing (base, B={b} H={h} Hkv={hkv} "
          f"D={d} S={s} bkv={bkv}, live rows {n_live}): kernel {ms:.4f} ms "
          f"| bound {bms:.4f} ms ({by}) | plain {plain_ms:.4f} ms | sdpa "
          f"{lib_ms:.4f} ms", flush=True)
    call_us = host_us(lambda: ops.decode_attention(q, k, v, pos, bkv=bkv,
                                                   **sc))
    sdpa_us = host_us(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kx, vx, attn_mask=mask))
    print(f"contiguous decode {tag} host time of one call: ops."
          f"decode_attention {call_us:.1f} us | sdpa {sdpa_us:.1f} us",
          flush=True)
    return {"name": "contig_decode_attention" + ("_int8" if quant else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:171",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def verify_operands(gen: torch.Generator, shape: dict, quant: bool):
    """Pools, a permuted block table and T query rows a slot at pos0 + t;
    rows past pos0 + T and unreferenced pages poisoned (row pos0 + T stays
    clean: it is what a shifted mask would read)."""
    b, h, hkv, d, ps, npp, t = (shape[k] for k in ("b", "h", "hkv", "d",
                                                    "ps", "npp", "t"))
    n_pages = b * npp + 5
    q = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda")[:b * npp]
    bt = (perm + 1).reshape(b, npp).to(torch.int32)
    pos0 = torch.randint(128, 572, (b,), generator=gen, device="cuda")
    rows = torch.arange(npp * ps, device="cuda")
    dead_rows = rows[None, :] > (pos0 + t)[:, None]
    dead = torch.ones(n_pages, ps, dtype=torch.bool, device="cuda")
    dead[bt.long()[:, rows // ps], (rows % ps).expand(b, -1)] = dead_rows
    kp, vp, sc = kv_operands(
        torch.randn(n_pages, ps, hkv, d, generator=gen, device="cuda"),
        torch.randn(n_pages, ps, hkv, d, generator=gen, device="cuda"), dead,
        quant)
    return q, kp, vp, bt, pos0.to(torch.int32), sc


def verify_rows_split(q, kp, vp, bt, pos0, label, window, sc, got) -> bool:
    """Whether verify at T rows equals T verify calls at T = 1, row t at
    pos0 + t, bit for bit (the rows kernel's row-independent arithmetic)."""
    one = [ops.flash_attention_verify(q[:, ti:ti + 1].contiguous(), kp, vp,
                                      bt, pos0 + ti, label, window=window,
                                      **sc)
           for ti in range(q.shape[1])]
    return torch.equal(got, torch.cat(one, dim=1))


def verify_checks(tag, q, kp, vp, bt, pos0, sc, quant, faults=True):
    """Every label with and without a window: within `dec_tol` of the plain
    version and of the gather oracle, two launches bit-equal, T rows equal
    to T calls of one row bit for bit; with ``faults``, a live page of slot
    0 lost (bf16: its K and V rows read as 0; int8: its V scales) and row
    t's mask shifted by one (row t sees pos0 + t + 1), the fault that would
    break the greedy accept rule, must exceed the limit.  Returns the
    largest error and the gathered (dequantized) K/V views."""
    ps = kp.shape[1]
    if faults:
        pg0 = bt[0, (pos0[0].item() - 20) // ps].long()   # live in any window
        if quant:
            bad = dict(sc, v_scale=sc["v_scale"].clone())
            bad["v_scale"][pg0] = 0.0
            kb, vb = kp, vp
        else:
            bad, kb, vb = sc, kp.clone(), vp.clone()
            kb[pg0], vb[pg0] = 0.0, 0.0
    kg = dequant(ref.gather_pages(kp, bt), None if not quant else
                 ref.gather_scales(sc["k_scale"], bt))
    vg = dequant(ref.gather_pages(vp, bt), None if not quant else
                 ref.gather_scales(sc["v_scale"], bt))
    worst = 0.0
    for label in DEC_LABELS:
        cfg = CoarseningConfig.parse(label)
        for window in (None, 100):
            kw = dict(degree=cfg.degree, gapped=cfg.kind == "gapped",
                      window=window)
            got = ops.flash_attention_verify(q, kp, vp, bt, pos0, label,
                                             window=window, **sc)
            again = ops.flash_attention_verify(q, kp, vp, bt, pos0, label,
                                               window=window, **sc)
            split = verify_rows_split(q, kp, vp, bt, pos0, label, window, sc,
                                      got)
            torch.cuda.synchronize()
            want = ref.verify_split_kv(q, kp, vp, bt, pos0, **kw, **sc)
            oracle = ref.verify_attention(q, kg, vg, pos0, window=window)
            tol, tol_o = dec_tol(want), dec_tol(oracle)
            err = (got.float() - want.float()).abs().max().item()
            err_o = (got.float() - oracle.float()).abs().max().item()
            line = (f"verify {tag} {label:5s} window={window}: max|kernel-"
                    f"plain| / limit {err / tol:.3f}, max|kernel-gather "
                    f"oracle| / limit {err_o / tol_o:.3f}; two launches "
                    f"bit-equal: {torch.equal(got, again)}; T rows == T "
                    f"calls of one row: {split}")
            if faults:
                lost = ref.verify_split_kv(q, kb, vb, bt, pos0, **kw, **bad)
                shifted = ref.verify_split_kv(q, kp, vp, bt, pos0 + 1, **kw,
                                              **sc)
                r_lost, r_shift = ((f.float() - want.float()).abs().max()
                                   .item() / tol for f in (lost, shifted))
                line += (f"; fault models / limit: a live page lost "
                         f"{r_lost:.1f}, row t's mask shifted by one "
                         f"{r_shift:.1f}")
            print(line, flush=True)
            if not (err <= tol and err_o <= tol_o):
                raise SystemExit(f"verify kernel {tag} {label} disagrees "
                                 f"with its plain version")
            if not torch.equal(got, again):
                raise SystemExit(f"verify kernel {tag} {label} gave other "
                                 f"bits on a second launch")
            if not split:
                raise SystemExit(f"verify kernel {tag} {label}: T rows "
                                 f"differ from T calls of one row")
            if faults and not (r_lost > 1 and r_shift > 1):
                raise SystemExit("the verify limit would not catch a lost "
                                 "page or a shifted mask")
            worst = max(worst, err, err_o)
    return worst, kg, vg


def rows_spills() -> None:
    """Every rows-kernel instance's registers and local memory, read from
    the loaded module; any local memory fails the run."""
    for name, local, regs in dec_mod.rows_instances():
        print(f"rows kernel instance {name}: {regs} registers, {local} "
              f"bytes of local memory a thread")
        if local:
            raise SystemExit(f"rows kernel instance {name} spills ({local} "
                             f"bytes of local memory)")


def verify_phase(gen: torch.Generator, quant: bool) -> dict:
    """Row 4 (`decode_attention.py:510`, bf16 or int8 pools): T = 5 rows a
    slot at pos0 + t through a permuted block table, `verify_checks` at
    qwen3-0.6b's shape and at the widened geometries `VER_WIDE` (T*G 35 at
    D 128, 50 at D 256), then timed beside SDPA with the host time of a
    call."""
    b, h, hkv, d, ps, npp, t = (VER[k] for k in ("b", "h", "hkv", "d", "ps",
                                                  "npp", "t"))
    tag = "int8" if quant else "bf16"
    q, kp, vp, bt, pos0, sc = verify_operands(gen, VER, quant)
    worst, kg, vg = verify_checks(tag, q, kp, vp, bt, pos0, sc, quant)
    for shape in VER_WIDE:
        wq, wk, wv, wbt, wp0, wsc = verify_operands(gen, shape, quant)
        wtag = (f"{tag} G={shape['h'] // shape['hkv']} Hkv={shape['hkv']} "
                f"D={shape['d']}")
        worst = max(worst, verify_checks(wtag, wq, wk, wv, wbt, wp0, wsc,
                                         quant, faults=False)[0])
        del wq, wk, wv

    p0 = pos0.long()
    n_live = int((p0 + t).sum().item())               # rows 0..pos0+T-1
    pages = int(((p0 + t + ps - 1) // ps).sum().item())
    io = n_live * hkv * 2 * (d * kp.element_size() + (4 if quant else 0)) \
        + 2 * b * t * h * d * 2 + pages * 4 + b * 4
    flops = 4 * h * d * int((t * p0 + t * (t + 1) // 2).sum().item())
    bms, by = bound(io, flops)
    ms = time_ms(lambda: ops.flash_attention_verify(q, kp, vp, bt, pos0,
                                                    **sc))
    plain_ms = time_ms(lambda: ref.verify_split_kv(q, kp, vp, bt, pos0,
                                                   **sc))
    # yardstick: SDPA on the pre-gathered (dequantized) views, K/V heads
    # expanded for GQA, with the per-row boolean mask
    kx, vx = (x.bfloat16().transpose(1, 2).repeat_interleave(
        h // hkv, dim=1).contiguous() for x in (kg, vg))
    mask = (torch.arange(npp * ps, device="cuda")[None, None, :]
            <= (p0[:, None] + torch.arange(t, device="cuda"))[:, :, None]
            )[:, None]
    qs = q.transpose(1, 2).contiguous()
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        qs, kx, vx, attn_mask=mask)
    lib_ms = time_ms(sdpa)
    print(f"verify {tag} timing (base, B={b} T={t} H={h} Hkv={hkv} D={d} "
          f"ps={ps}, live rows {n_live}): kernel {ms:.4f} ms | bound "
          f"{bms:.4f} ms ({by}) | plain {plain_ms:.4f} ms | sdpa on "
          f"pre-gathered views {lib_ms:.4f} ms", flush=True)
    call_us = host_us(lambda: ops.flash_attention_verify(q, kp, vp, bt, pos0,
                                                         **sc))
    print(f"verify {tag} host time of one call: ops.flash_attention_verify "
          f"{call_us:.1f} us | sdpa {host_us(sdpa):.1f} us", flush=True)
    return {"name": "verify_attention" + ("_int8" if quant else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:510",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


# -- phase 3: the paper's microbenchmarks (rows 15, 16, 18, 19) ---------------

# the paper's 64M-element f32 streams (`benchmarks/fig8_apps.py:26`), 8 input
# streams, AI 6, block 1024; the stencil's 8192^2 grid; the DP's 1024 rows of
# 2^20 columns; gathers into 8 tables of 2^14 at locality 4096 (fig8's) and
# of 2^24 read fully at random (8 x 64 MiB, beyond the 50 MB L2)
PAPER_N, PAPER_AI, PAPER_BLOCK = 1 << 26, 6, 1024
STENCIL_SHAPE = (8192, 8192)
SCAN_SHAPE = (1024, 1 << 20)
SCAN_LABELS = ("base", "con2", "con4", "con8")
GATHERS = {"locality 4096": (1 << 14, 4096),
           "fully random": (1 << 24, 1 << 24)}
# Every product in these kernels is by a power of two and the kernels add
# in the plain versions' order without contraction, so each must equal its
# plain version bit for bit: the limit is 0 differing elements.


def bits_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements whose float32 bit patterns differ."""
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def hold_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    n = bits_differ(got, want)
    if n:
        raise SystemExit(f"{what}: {n} elements differ from the plain "
                         f"version (max |diff| "
                         f"{(got - want).abs().max().item():.3e})")


def caught(what: str, faulty: torch.Tensor, want: torch.Tensor) -> str:
    """A fault model must differ from the plain version somewhere."""
    n = bits_differ(faulty, want)
    if not n:
        raise SystemExit(f"fault model '{what}' would pass the check")
    return f"{what}: {n} elements differ (caught)"


def sub_block(plan, device) -> torch.Tensor:
    """(N,) the index k < C of the fused block each stream element lies in."""
    e = torch.arange(plan.n, device=device)
    if plan.contiguous:
        return (e // plan.block) % plan.cfg.degree
    return e // (plan.grid * plan.block)


def hold_owners(what: str, probe: torch.Tensor, owners: torch.Tensor):
    torch.cuda.synchronize()
    if not torch.equal(probe, owners.float()):
        raise SystemExit(f"{what}: the kernel's element-to-program map "
                         f"differs from the plan's")


def kernel_row(name, source, replaces, worst, ms, plain_ms, bound, lib_ms):
    b_ms, by = bound
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms}


def ew_stream_phase() -> dict:
    inputs = fig11.streams(PAPER_N, 8, "cuda", seed=SEED + 10)
    for variant in ref.VARIANTS:
        want = ref.ew_stream(inputs, ai=PAPER_AI, variant=variant)
        for lab in bench.labels():
            hold_equal(f"ew_stream {variant} {lab}",
                       ew_mod.ew_stream(inputs, lab, ai=PAPER_AI,
                                        variant=variant), want)
        print(f"ew_stream {variant} (N 2^26, 8 streams, AI {PAPER_AI}): "
              f"every label bit-equal to the plain version", flush=True)
        del want
    for lab in bench.labels():
        plan = plan_stream(PAPER_N, CoarseningConfig.parse(lab), PAPER_BLOCK)
        hold_owners(f"ew_stream {lab}", ew_mod.ew_stream(
            inputs, lab, probe=True), stream_owners(plan, "cuda"))
    print("ew_stream: the owner map of every label equals its plan's",
          flush=True)
    want = ref.ew_stream(inputs, ai=PAPER_AI)
    got = ew_mod.ew_stream(inputs, "con4", ai=PAPER_AI)
    plan = plan_stream(PAPER_N, CoarseningConfig.parse("con4"), PAPER_BLOCK)
    lost = got.clone()
    lost[sub_block(plan, "cuda") == 3] = 0.0
    gap = plan_stream(PAPER_N, CoarseningConfig.parse("gap4"), PAPER_BLOCK)
    swapped = ew_mod.ew_stream(inputs, "con4", probe=True)
    print("ew_stream fault models: "
          + caught("con4's 4th sub-block left unwritten", lost, want) + "; "
          + caught("con4 and gap4 swapped (owner map against gap4's plan)",
                   swapped, stream_owners(gap, "cuda").float()), flush=True)
    ms = time_ms(lambda: ew_mod.ew_stream(inputs, "base", ai=PAPER_AI))
    plain_ms = time_ms(lambda: ref.ew_stream(inputs, ai=PAPER_AI), reps=5)
    bound = bench.bound_ms(4 * PAPER_N * 9,
                           bench.stream_ops(inputs, PAPER_AI, "base"))
    print(f"ew_stream timing (base, N 2^26, 8 streams, AI {PAPER_AI}): "
          f"kernel {ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}) | "
          f"plain {plain_ms:.4f} ms | library none", flush=True)
    return kernel_row("ew_stream", "src/repro_torch/kernels/csrc/stream.cu",
                      "src/repro/core/coarsening.py:233", 0.0, ms, plain_ms,
                      bound, None)


def outlier_ids(idx: torch.Tensor, table: int, seed: int) -> torch.Tensor:
    """Locality-4096 ids with every 997th replaced by a random entry of the
    table: most pieces' spans then outgrow the window, some do not."""
    gen = torch.Generator(device=idx.device).manual_seed(seed)
    out = idx.clone()
    out[::997] = torch.randint(0, table, out[::997].shape, generator=gen,
                               device=idx.device, dtype=torch.int32)
    return out


def staged_shares(paths: torch.Tensor, plan) -> tuple:
    """(share of programs whose every element was served from the window,
    share of elements so served)."""
    owners = stream_owners(plan, paths.device)
    per = torch.zeros(plan.grid, device=paths.device).index_add_(
        0, owners, paths)
    whole = plan.n // plan.grid
    return float((per == whole).float().mean()), float(paths.mean())


def span_off_by_one(idx, tables, staged, ai: int) -> torch.Tensor:
    """Fault model: every lookup served from a staged span reads the entry
    after its own (a span staged one entry off)."""
    shifted = torch.where(staged, (idx.long() + 1).clamp(
        max=tables[0].shape[0] - 1), idx.long())
    return ref._arith_chain([t[shifted] for t in tables],
                            ai * (len(tables) + 1))


WALK_LABELS = ("base", "con4", "gap4", "simd4")   # path maps held to `walk`


def gather_stream_phase() -> dict:
    """Row 16 at the paper's cells plus the locality cell with outliers:
    every label bit-equal to the plain version and launched twice
    bit-equal, owner maps equal to the plans', the kernel's window
    decisions (its path map) equal to `gather_stream.walk`'s for
    `WALK_LABELS`, the share of programs staged, two fault models."""
    out = None
    cells = dict(GATHERS)
    cells["locality 4096 with outliers"] = GATHERS["locality 4096"]
    for tag, (table, window) in cells.items():
        idx, tables = fig11.gather_inputs(PAPER_N, table, window, "cuda",
                                          seed=SEED + 11)
        if tag.endswith("outliers"):
            idx = outlier_ids(idx, table, SEED + 12)
        want = ref.gather_stream(tables, idx, ai=PAPER_AI)
        shares, staged_base = [], None
        for lab in bench.labels():
            got = gs_mod.gather_stream(idx, tables, lab, ai=PAPER_AI)
            hold_equal(f"gather_stream {tag} {lab}", got, want)
            hold_equal(f"gather_stream {tag} {lab} (second launch)",
                       gs_mod.gather_stream(idx, tables, lab, ai=PAPER_AI),
                       got)
            del got
            plan = plan_stream(PAPER_N, CoarseningConfig.parse(lab),
                               PAPER_BLOCK)
            hold_owners(f"gather_stream {lab}", gs_mod.gather_stream(
                idx, tables, lab, probe=True), stream_owners(plan, "cuda"))
            paths = gs_mod.gather_stream(idx, tables, lab, paths=True)
            if lab in WALK_LABELS:
                walked = gs_mod.walk(idx.cpu(), len(tables), table, lab,
                                     block=PAPER_BLOCK).staged
                if not torch.equal(paths.cpu(), walked.float()):
                    raise SystemExit(f"gather_stream {tag} {lab}: the "
                                     f"kernel's window decisions differ "
                                     f"from gather_stream.walk's")
            if lab == "base":
                staged_base = paths.bool()
            progs, elems = staged_shares(paths, plan)
            shares.append(f"{lab} {progs:.4f}/{elems:.4f}")
            del paths
        print(f"gather_stream {tag}: programs / elements served from the "
              f"window: " + ", ".join(shares), flush=True)
        if tag == "locality 4096" and not bool(staged_base.all()):
            raise SystemExit("gather_stream locality 4096: a base program "
                             "read the tables directly")
        faults = []
        if bool(staged_base.any()):
            faults.append(caught("a staged span read one entry off (base)",
                                 span_off_by_one(idx, tables, staged_base,
                                                 PAPER_AI), want))
        ms = time_ms(lambda: gs_mod.gather_stream(idx, tables, "base",
                                                  ai=PAPER_AI))
        plain_ms = time_ms(lambda: ref.gather_stream(tables, idx,
                                                     ai=PAPER_AI), reps=5)
        bound = bench.bound_ms(bench.gather_bytes(idx, len(tables)),
                               PAPER_N * PAPER_AI * 9)
        print(f"gather_stream {tag} (N 2^26, 8 tables of {table}): every "
              f"label bit-equal to the plain version and to a second "
              f"launch, owner maps equal the plans', window decisions "
              f"equal gather_stream.walk's ({', '.join(WALK_LABELS)})"
              + (f"; fault models: {'; '.join(faults)}" if faults else "")
              + f"; base kernel {ms:.4f} ms | bound {bound[0]:.4f} ms "
              f"({bound[1]}) | plain {plain_ms:.4f} ms | library none",
              flush=True)
        if out is None:            # the JSON line keeps fig8's locality
            out = kernel_row("gather_stream",
                             "src/repro_torch/kernels/csrc/stream.cu",
                             "src/repro/kernels/gather_stream.py:65", 0.0,
                             ms, plain_ms, bound, None)
        del idx, tables, want, staged_base
    return out


def stencil_self_up(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Fault model: the first row of every row block reads itself in place
    of its upper neighbour."""
    up = torch.cat([x[:1], x[:-1]])
    up[::block_rows] = x[::block_rows]
    dn = torch.cat([x[1:], x[-1:]])
    w = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    e = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    return 0.5 * x + 0.125 * up + 0.125 * dn + 0.125 * w + 0.125 * e


def stencil_phase() -> dict:
    rows, cols = STENCIL_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    x = torch.randn(rows, cols, generator=gen, device="cuda")
    want = ref.stencil5(x)
    for lab in bench.labels():
        cfg = CoarseningConfig.parse(lab)
        hold_equal(f"stencil5 {lab}", st_mod.stencil5(x, cfg), want)
        owners = row_owners(plan_rows(rows, cfg, 8), "cuda")
        hold_owners(f"stencil5 {lab}", st_mod.stencil5(x, cfg, probe=True),
                    owners[:, None].expand(rows, cols))
    got = st_mod.stencil5(x, "gap4")
    lost = got.clone()
    lost[3 * rows // 4:] = 0.0             # gap4's 4th row block of each program
    swapped = st_mod.stencil5(x, "con4", probe=True)
    gap_owners = row_owners(plan_rows(rows, CoarseningConfig.parse("gap4"),
                                      8), "cuda")
    print(f"stencil5 ({rows}x{cols}): every label bit-equal to the plain "
          f"version, owner maps equal the plans'; fault models: "
          + caught("gap4's 4th row block left unwritten", lost, want) + "; "
          + caught("con4 and gap4 swapped", swapped,
                   gap_owners[:, None].expand(rows, cols).float()) + "; "
          + caught("a block's first row reads itself as its upper "
                   "neighbour", stencil_self_up(x, 8), want), flush=True)
    cross = torch.tensor([[0.0, 0.125, 0.0], [0.125, 0.5, 0.125],
                          [0.0, 0.125, 0.0]], device="cuda")[None, None]
    xp = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                 mode="replicate")
    conv = torch.nn.functional.conv2d(xp, cross)[0, 0]
    ms = time_ms(lambda: st_mod.stencil5(x, "base"))
    plain_ms = time_ms(lambda: ref.stencil5(x), reps=5)
    lib_ms = time_ms(lambda: torch.nn.functional.conv2d(xp, cross))
    bound = bench.bound_ms(8 * rows * cols, 9 * rows * cols)
    print(f"stencil5 timing (base): kernel {ms:.4f} ms | bound "
          f"{bound[0]:.4f} ms ({bound[1]}) | plain {plain_ms:.4f} ms | "
          f"conv2d of the edge-padded grid {lib_ms:.4f} ms (max |conv - "
          f"plain| {(conv - want).abs().max().item():.3e})", flush=True)
    return kernel_row("stencil5", "src/repro_torch/kernels/csrc/stencil.cu",
                      "src/repro/kernels/stencil.py:58", 0.0, ms, plain_ms,
                      bound, lib_ms)


def dp_carry_t2(cost: torch.Tensor) -> torch.Tensor:
    """Fault model: row t's carry taken from row t-2 (row 1 from row 0)."""
    out = torch.empty_like(cost)
    out[0] = cost[0]
    for t in range(1, cost.shape[0]):
        prev = out[max(t - 2, 0)]
        left = torch.cat([prev[:1], prev[:-1]])
        right = torch.cat([prev[1:], prev[-1:]])
        out[t] = cost[t] + torch.minimum(prev, torch.minimum(left, right))
    return out


def dp_scan_phase() -> dict:
    rows, cols = SCAN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    cost = torch.rand(rows, cols, generator=gen, device="cuda")
    want = ref.dp_scan(cost)
    for lab in SCAN_LABELS:
        c = CoarseningConfig.parse(lab).degree
        scan_mod.launches = 0
        got = scan_mod.dp_scan(cost, lab)
        hold_equal(f"dp_scan {lab}", got, want)
        if scan_mod.launches != rows // c:
            raise SystemExit(f"dp_scan {lab}: {scan_mod.launches} launches "
                             f"for one call, not rows/C = {rows // c}")
        del got
    try:
        scan_mod.dp_scan(cost, "gap2")
        raise SystemExit("dp_scan took gapped coarsening")
    except ValueError:
        pass
    print(f"dp_scan ({rows}x{cols}): base, con2, con4, con8 bit-equal to "
          f"the plain version with rows/C launches a call; gap2 refused; "
          f"fault model: " + caught("carry from row t-2", dp_carry_t2(cost),
                                    want), flush=True)
    ms = time_ms(lambda: scan_mod.dp_scan(cost, "base"))
    plain_ms = time_ms(lambda: ref.dp_scan(cost), reps=3)
    bound = bench.bound_ms(8 * rows * cols, 3 * rows * cols)
    print(f"dp_scan timing (base, {rows} launches): kernel {ms:.4f} ms | "
          f"bound {bound[0]:.4f} ms ({bound[1]}) | plain {plain_ms:.4f} ms "
          f"| library none", flush=True)
    return kernel_row("dp_scan", "src/repro_torch/kernels/csrc/chunk_scan.cu",
                      "src/repro/kernels/chunk_scan.py:55", 0.0, ms,
                      plain_ms, bound, None)


# -- row 14: embed gather, at the tuner's qwen3-0.6b spec ---------------------

EMBED_LABELS = ("base", "con2", "gap2", "con4", "gap4", "con8", "gap8")


def embed_gather_phase(gen: torch.Generator) -> dict:
    """The embed-gather kernel at the spec the tuner measures for
    qwen3-0.6b serving (8 slots x 1024: N 8192 ids into the padded vocab,
    d 1024), float32 and bf16 tables: every label bit-equal to the plain
    version (among the ids some past the table, some in [-V, 0) and
    some below -V, read as the Pallas body's index reads them), owner
    maps equal to the plan's, each label launched twice bit-equal, three
    fault models caught, then the times of every label."""
    spec = model_specs(get_config("qwen3-0.6b"), seq=MAX_LEN, batch=SLOTS,
                       page_size=PAGE)["embed_gather"]
    n, vocab, d = spec.shape
    ids = torch.randint(0, vocab, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids[::97] = vocab + 5                   # past the table: row V-1
    ids[5::101] = -3                        # in [-V, 0): row V-3
    ids[7::103] = -vocab - 2                # below -V: row 0
    table = torch.randn((vocab, d), generator=gen, device="cuda")
    for tab in (table, table.bfloat16()):
        want = ref.embed_gather(ids, tab)
        for lab in EMBED_LABELS:
            got = eg_mod.embed_gather(ids, tab, lab)
            hold_equal(f"embed_gather {tab.dtype} {lab}", got, want)
            hold_equal(f"embed_gather {tab.dtype} {lab} (second launch)",
                       eg_mod.embed_gather(ids, tab, lab), got)
            del got
        print(f"embed_gather ({n} ids, {tab.dtype} table {vocab} x {d}): "
              f"every label bit-equal to the plain version and to a "
              f"second launch", flush=True)
        del want
    for lab in EMBED_LABELS:
        plan = plan_stream(n, CoarseningConfig.parse(lab), eg_mod.BLOCK)
        for tab in (table, table.bfloat16()):
            hold_owners(f"embed_gather {tab.dtype} {lab}",
                        eg_mod.embed_gather(ids, tab, lab, probe=True),
                        stream_owners(plan, "cuda")[:, None].expand(n, d))
    print("embed_gather: the owner map of every label equals its plan's "
          "(float32: the bulk-copy path; bf16: the lane path)", flush=True)
    # a float32 table whose block rows outgrow the bulk budget takes the
    # lane path: d 4096 (8 rows of 16 KB a block)
    wide = torch.randn((8192, 4096), generator=gen, device="cuda")
    wide_ids = torch.randint(0, 8192, (n,), generator=gen, device="cuda",
                             dtype=torch.int32)
    want = ref.embed_gather(wide_ids, wide)
    for lab in EMBED_LABELS:
        got = eg_mod.embed_gather(wide_ids, wide, lab)
        hold_equal(f"embed_gather wide float32 {lab}", got, want)
        hold_equal(f"embed_gather wide float32 {lab} (second launch)",
                   eg_mod.embed_gather(wide_ids, wide, lab), got)
        del got
    print(f"embed_gather ({n} ids, float32 table 8192 x 4096, the lane "
          f"path): every label bit-equal to the plain version and to a "
          f"second launch", flush=True)
    del wide, wide_ids, want
    want = ref.embed_gather(ids, table)
    # an id block read from its neighbour: block 0 takes block 1's ids
    shifted = ids.clone()
    shifted[:eg_mod.BLOCK] = ids[eg_mod.BLOCK:2 * eg_mod.BLOCK]
    gap = plan_stream(n, CoarseningConfig.parse("gap4"), eg_mod.BLOCK)
    swapped = eg_mod.embed_gather(ids, table, "con4", probe=True)
    # a block's share one row late: block 1 of program 0 (base) writes
    # rows [R, 2R) from the ids of rows [R + 1, 2R + 1)
    split = eg_mod.split_plan(n, BASE, sms=torch.cuda.get_device_properties(
        0).multi_processor_count)
    late = ids.clone()
    late[split.rows:2 * split.rows] = ids[split.rows + 1:2 * split.rows + 1]
    print(f"embed_gather split at base: {split.per_program} blocks a "
          f"program of {split.rows} rows, grid {split.grid}", flush=True)
    print("embed_gather fault models: "
          + caught("id block 0 read from block 1",
                   ref.embed_gather(shifted, table), want) + "; "
          + caught("block 1's share shifted by one row",
                   ref.embed_gather(late, table), want) + "; "
          + caught("con4 and gap4 swapped (owner map against gap4's plan)",
                   swapped, stream_owners(gap, "cuda").float()[:, None]
                   .expand(n, d).contiguous()), flush=True)
    rows = {}
    inside = ids.clamp(0, vocab - 1)
    for tab in (table, table.bfloat16()):
        elem = tab.element_size()
        ms = time_ms(lambda: eg_mod.embed_gather(ids, tab, "base"))
        plain_ms = time_ms(lambda: ref.embed_gather(ids, tab), reps=5)
        # F.embedding asserts on ids outside the table: in-range ids
        lib_ms = time_ms(lambda: torch.nn.functional.embedding(inside, tab))
        bound = bench.bound_ms(4 * n + n * d * elem + 4 * n * d, 0)
        labs = ", ".join(
            f"{lab} {time_ms(lambda: eg_mod.embed_gather(ids, tab, lab)):.4f}"
            for lab in EMBED_LABELS[1:])
        print(f"embed_gather timing (base, {n} ids, {tab.dtype} table): "
              f"kernel {ms:.4f} ms | bound {bound[0]:.4f} ms ({bound[1]}) "
              f"| plain {plain_ms:.4f} ms | F.embedding {lib_ms:.4f} ms; "
              f"the other labels: {labs} ms", flush=True)
        rows[tab.dtype] = (ms, plain_ms, bound, lib_ms)
    del table, want, swapped
    gc.collect()
    torch.cuda.empty_cache()
    return kernel_row("embed_gather",
                      "src/repro_torch/kernels/csrc/embed_gather.cu",
                      "src/repro/kernels/embed_gather.py:50", 0.0,
                      *rows[torch.float32])


# -- rows 12, 13, 17: Mamba-2 SSD, RG-LRU, windowed gather --------------------

# mamba2-370m's SSD geometry (configs/mamba2_370m.py: d_inner 2048 = 32
# heads of 64, state 128, one group), chunk 64, batch 4 x 2048 tokens
SSD_SPEC = KernelSpec.make("ssd", (4, 32, 1, 2048, 64, 128), chunk=64)
SSD_LABELS = ("base", "con2", "gap2", "con4", "gap4", "con8", "gap8")
# |y - y64| <= SSD_K * 2^-24 * (the plain version on |x|, |B|, |C|), y64 the
# plain version in float64: the chunked sums, per-chunk prefix sums and
# exps round otherwise than the naive oracle.  The float32 plain version is
# no yardstick here: its prefix sums over 2048 steps reach |cum| ~ 10^3,
# whose differences lose ~10 bits, and the script prints its own ratio
SSD_K = 512
# recurrentgemma-2b's RG-LRU width (lru_width 2560), batch 8 x 2048 tokens
RGLRU_SPEC = KernelSpec.make("rglru", (8, 2048, 2560), block_d=128,
                             block_t=64)
RGLRU_LABELS = ("base", "con2", "gap2", "con4", "gap4")   # con8 does not tile
# |h - plain| <= RGLRU_ULPS * 2^-24 * max |plain| over the row's channels:
# the kernel repeats the plain version's operations in its order; expf,
# log1pf and the recurrence may differ by ulps
RGLRU_ULPS = 8
# row 16's locality cell (table 2^14) and a table beyond L2 (2^24), both at
# locality = window 4096; block 1024 as row 16
WG_CELLS = {"locality 4096": (1 << 14, 4096),
            "table 2^24, locality 4096": (1 << 24, 4096)}
WG_BLOCK = 1024


def ssd_plain(x, dt, a, bm, cm) -> torch.Tensor:
    """`ref.ssd` in the kernel layout (B,H,S,P), a batch row at a time."""
    return torch.cat([ref.ssd(x[i:i + 1].transpose(1, 2),
                              dt[i:i + 1].transpose(1, 2), a,
                              bm[i:i + 1].transpose(1, 2),
                              cm[i:i + 1].transpose(1, 2)).transpose(1, 2)
                      for i in range(x.shape[0])])


def ssd_chunk_reset(x, dt, a, bm, cm, chunk: int) -> torch.Tensor:
    """Fault model: the state reset at every chunk boundary."""
    return torch.cat([ssd_plain(x[:, :, t:t + chunk], dt[:, :, t:t + chunk],
                                a, bm[:, :, t:t + chunk],
                                cm[:, :, t:t + chunk])
                      for t in range(0, x.shape[2], chunk)], dim=2)


def ssd_phase(gen: torch.Generator) -> dict:
    """Row 12 at mamba2-370m's geometry: every label against the plain
    version in float64 within SSD_K * 2^-24 of the terms' magnitude, owner
    maps equal to the Pallas index maps, two fault models, the times."""
    b, h, g, s, p, n = SSD_SPEC.shape
    chunk = SSD_SPEC.p["chunk"]
    args = tune_warm.ssd_inputs(SSD_SPEC.shape, gen, "cuda")
    x, dt, a, bm, cm = args
    a64 = [t.double() for t in args]
    want = ssd_plain(*a64)
    mag = ssd_plain(a64[0].abs(), a64[1], a64[2], a64[3].abs(), a64[4].abs())
    lim = SSD_K * 2.0 ** -24 * mag
    worst, err = {}, 0.0
    for lab in SSD_LABELS:
        cfg = CoarseningConfig.parse(lab)
        if not ssd_mod.takes(h, g, n, p, chunk, cfg):
            raise SystemExit(f"ssd: the kernel refuses {lab} at "
                             f"{SSD_SPEC.shape}")
        got = ssd_mod.make_kernel(b, h, g, s, p, n, cfg, chunk=chunk)(*args)
        torch.cuda.synchronize()
        worst[lab] = tol_ratio(got.double(), want, lim)
        if lab == "base":
            err = (got.double() - want).abs().max().item()
        if not worst[lab] <= 1.0:
            raise SystemExit(f"ssd {lab}: {worst[lab]:.3f} of the limit")
        own = ssd_mod.head_owners(h, cfg).to("cuda").float()
        hold_owners(f"ssd {lab}", ssd_mod.make_kernel(
            b, h, g, s, p, n, cfg, chunk=chunk)(*args, probe=True),
            own[None, :, None, None].expand(b, h, s, p))
        del got
    plain32 = ssd_plain(*args).double()
    reset = ssd_chunk_reset(*a64, chunk)
    swapped = ssd_mod.make_kernel(b, h, g, s, p, n, "con4",
                                  chunk=chunk)(*args, probe=True)
    gap_own = ssd_mod.head_owners(h, CoarseningConfig.parse("gap4")).to(
        "cuda").float()[None, :, None, None].expand(b, h, s, p)
    print(f"ssd (B {b}, H {h}, G {g}, S {s}, P {p}, N {n}, chunk {chunk}): "
          f"every label within {SSD_K} * 2^-24 of the terms' magnitude "
          f"against the float64 plain version (worst "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
          + f" of the limit; base max |err| {err:.3e}; the float32 plain "
          f"version {tol_ratio(plain32, want, lim):.3f}); owner maps equal "
          f"the Pallas index maps; fault models: state reset at every chunk "
          f"{tol_ratio(reset, want, lim):.3e} of the limit (caught); "
          + caught("con4 and gap4 swapped (owner map against gap4's)",
                   swapped, gap_own), flush=True)
    if not tol_ratio(reset, want, lim) > 1.0:
        raise SystemExit("fault model 'state reset at every chunk' would "
                         "pass the check")
    del want, mag, lim, a64, plain32, reset, swapped
    gc.collect()
    torch.cuda.empty_cache()
    run = ssd_mod.make_kernel(b, h, g, s, p, n, "base", chunk=chunk)
    ms = time_ms(lambda: run(*args))
    plain_ms = time_ms(lambda: ref.ssd(
        x.transpose(1, 2), dt.transpose(1, 2), a, bm.transpose(1, 2),
        cm.transpose(1, 2)), reps=3)
    io, ops_, _ = tsearch.work(SSD_SPEC)
    bnd = bench.bound_ms(io, ops_)
    print(f"ssd timing (base, {b * h} blocks): kernel {ms:.4f} ms | bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}; {io / 1e6:.1f} MB, {ops_ / 1e9:.2f} "
          f"GFLOP f32) | plain {plain_ms:.4f} ms | library none", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return kernel_row("ssd", "src/repro_torch/kernels/csrc/ssd.cu",
                      "src/repro/kernels/ssd.py:100", err, ms, plain_ms, bnd,
                      None)


def rglru_block_reset(x, r, i, a_param, block_t: int) -> torch.Tensor:
    """Fault model: h dropped at every block_t boundary."""
    return torch.cat([ref.rglru(x[:, t:t + block_t], r[:, t:t + block_t],
                                i[:, t:t + block_t], a_param)
                      for t in range(0, x.shape[1], block_t)], dim=1)


def rglru_phase(gen: torch.Generator) -> dict:
    """Row 13 at recurrentgemma-2b's width: every label that tiles within
    RGLRU_ULPS of each row's largest |h|, owner maps, two fault models,
    the times."""
    b, s, d = RGLRU_SPEC.shape
    bd, bt = RGLRU_SPEC.p["block_d"], RGLRU_SPEC.p["block_t"]
    args = tune_warm.rglru_inputs(RGLRU_SPEC.shape, gen, "cuda")
    want = ref.rglru(*args)
    lim = RGLRU_ULPS * 2.0 ** -24 * want.abs().amax(dim=2, keepdim=True)
    worst, err = {}, 0.0
    for lab in RGLRU_LABELS:
        cfg = CoarseningConfig.parse(lab)
        run = rg_mod.make_kernel(b, s, d, cfg, block_d=bd, block_t=bt)
        got = run(*args)
        torch.cuda.synchronize()
        worst[lab] = tol_ratio(got, want, lim)
        if lab == "base":
            err = (got - want).abs().max().item()
            bits = bits_differ(got, want)
        if not worst[lab] <= 1.0:
            raise SystemExit(f"rglru {lab}: {worst[lab]:.3f} of the limit")
        own = rg_mod.channel_owners(d, cfg, bd).to("cuda").float()
        hold_owners(f"rglru {lab}", run(*args, probe=True),
                    own[None, None, :].expand(b, s, d))
    reset = rglru_block_reset(*args, bt)
    swapped = rg_mod.make_kernel(b, s, d, "con4", block_d=bd,
                                 block_t=bt)(*args, probe=True)
    gap_own = rg_mod.channel_owners(d, CoarseningConfig.parse("gap4"),
                                    bd).to("cuda").float()
    print(f"rglru (B {b}, S {s}, D {d}, block_d {bd}): every label within "
          f"{RGLRU_ULPS} ulps of each row's largest |h| (worst "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
          + f" of the limit; base max |err| {err:.3e}, {bits} elements not "
          f"bit-equal); owner maps equal the Pallas index maps; fault "
          f"models: h dropped every {bt} steps "
          f"{tol_ratio(reset, want, lim):.3e} of the limit (caught); "
          + caught("con4 and gap4 swapped (owner map against gap4's)",
                   swapped, gap_own[None, None, :].expand(b, s, d)),
          flush=True)
    if not tol_ratio(reset, want, lim) > 1.0:
        raise SystemExit("fault model 'h dropped every block_t steps' would "
                         "pass the check")
    del want, lim, reset, swapped
    run = rg_mod.make_kernel(b, s, d, "base", block_d=bd, block_t=bt)
    ms = time_ms(lambda: run(*args))
    plain_ms = time_ms(lambda: ref.rglru(*args), reps=3)
    io, ops_, _ = tsearch.work(RGLRU_SPEC)
    bnd = bench.bound_ms(io, ops_)
    print(f"rglru timing (base, {b * d // bd} blocks of {bd} threads): "
          f"kernel {ms:.4f} ms | bound {bnd[0]:.4f} ms ({bnd[1]}; "
          f"{io / 1e6:.1f} MB) | plain {plain_ms:.4f} ms | library none",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return kernel_row("rglru", "src/repro_torch/kernels/csrc/rglru.cu",
                      "src/repro/kernels/rglru.py:77", err, ms, plain_ms, bnd,
                      None)


def windowed_gather_phase() -> dict:
    """Row 17 at row 16's locality cell and at a table beyond L2: every
    label of the paper's sweep that the kernel takes bit-equal to the plain
    version (simd8 refused: its slices of 8192 ids pass the window), owner
    maps equal to the plan's, two fault models; the launch timed with
    bases planned once, the planning on its own, and row 16's gather with
    one table on the same ids beside it (the same function, unwindowed)."""
    out = None
    for tag, (table, window) in WG_CELLS.items():
        idx, tables = fig11.gather_inputs(PAPER_N, table, window, "cuda",
                                          seed=SEED + 11)
        tbl = tables[0]
        del tables
        idx_np = idx.cpu().numpy()
        want = ref.windowed_gather(idx, tbl, PAPER_AI)
        refused, times = [], {}
        for lab in bench.labels():
            try:
                run = wg_mod.make_kernel(PAPER_N, table, lab, window=window,
                                         block=WG_BLOCK, ai=PAPER_AI)
            except ValueError:
                refused.append(lab)
                continue
            bases = torch.from_numpy(run.plan_bases(idx_np)).to("cuda")
            hold_equal(f"windowed_gather {tag} {lab}",
                       run(idx, tbl, bases), want)
            hold_owners(f"windowed_gather {tag} {lab}",
                        run(idx, tbl, bases, probe=True),
                        stream_owners(run.plan, "cuda"))
            times[lab] = time_ms(lambda: run(idx, tbl, bases))
        if refused != ["simd8"]:
            raise SystemExit(f"windowed_gather {tag}: refused {refused}, "
                             f"not simd8 alone")
        run = wg_mod.make_kernel(PAPER_N, table, "base", window=window,
                                 block=WG_BLOCK, ai=PAPER_AI)
        t0 = time.perf_counter()
        bases = torch.from_numpy(run.plan_bases(idx_np)).to("cuda")
        plan_ms = (time.perf_counter() - t0) * 1e3
        # each slice reads the next slice's window
        shifted = torch.roll(bases.flatten(), -1).reshape(bases.shape)
        swapped = wg_mod.make_kernel(PAPER_N, table, "con4", window=window,
                                     block=WG_BLOCK)(idx, tbl, probe=True)
        gap = plan_stream(PAPER_N, CoarseningConfig.parse("gap4"), WG_BLOCK)
        print(f"windowed_gather {tag} (N 2^26, table {table}, window "
              f"{window}, block {WG_BLOCK}): every label but simd8 (refused) "
              f"bit-equal to the plain version, owner maps equal the "
              f"plans'; fault models: "
              + caught("each slice reads the next slice's window",
                       run(idx, tbl, shifted), want) + "; "
              + caught("con4 and gap4 swapped (owner map against gap4's "
                       "plan)", swapped, stream_owners(gap, "cuda").float()),
              flush=True)
        ms = times["base"]
        one_ms = time_ms(lambda: gs_mod.gather_stream(idx, (tbl,), "base",
                                                      ai=PAPER_AI,
                                                      block=WG_BLOCK))
        plain_ms = time_ms(lambda: ref.windowed_gather(idx, tbl, PAPER_AI),
                           reps=5)
        bnd = bench.bound_ms(bench.gather_bytes(idx, 1),
                             PAPER_N * 2 * PAPER_AI)
        print(f"windowed_gather timing {tag} (base): kernel {ms:.4f} ms "
              f"with bases planned once (planning {plan_ms:.1f} ms on the "
              f"host) | row 16's gather, one table, same ids {one_ms:.4f} "
              f"ms | bound {bnd[0]:.4f} ms ({bnd[1]}) | plain "
              f"{plain_ms:.4f} ms | library none; every label, bases "
              f"planned once: " + ", ".join(f"{lab} {t:.4f}"
                                           for lab, t in times.items())
              + " ms", flush=True)
        if out is None:            # the JSON line keeps row 16's cell
            out = kernel_row("windowed_gather",
                             "src/repro_torch/kernels/csrc/windowed_gather.cu",
                             "src/repro/kernels/windowed_gather.py:81", 0.0,
                             ms, plain_ms, bnd, None)
        del idx, tbl, want, swapped
        gc.collect()
        torch.cuda.empty_cache()
    return out


def paper_kernels_phase() -> list:
    rows = []
    for phase in (ew_stream_phase, gather_stream_phase, stencil_phase,
                  dp_scan_phase):
        rows.append(phase())
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def paper_sweeps_phase() -> dict:
    """The four figure sweeps at the paper's sizes and one call of the
    windowed gather's `make_kernel`, launch counts zeroed just before and
    read just after."""
    table, window = WG_CELLS["locality 4096"]
    idx, tables = fig11.gather_inputs(PAPER_N, table, window, "cuda",
                                      seed=SEED + 15)
    zero_counts()
    t0 = time.perf_counter()
    for fig in (fig8_apps, fig11, fig10_mem_divergence, fig13_divdeg):
        fig.main([])
        gc.collect()
        torch.cuda.empty_cache()
    # the windowed gather's own entry point, planning on the call
    got = wg_mod.make_kernel(PAPER_N, table, "base", window=window,
                             block=WG_BLOCK, ai=PAPER_AI)(idx, tables[0])
    counts = read_counts()
    hold_equal("windowed_gather (paper path)", got,
               ref.windowed_gather(idx, tables[0], PAPER_AI))
    del idx, tables, got
    path = ("ew_stream", "gather_stream", "stencil5", "dp_scan",
            "windowed_gather")
    print(f"paper sweeps: {time.perf_counter() - t0:.1f}s; kernel launches "
          f"{ {k: counts[k] for k in path} }", flush=True)
    if min(counts[k] for k in path) < 1:
        raise SystemExit(f"a kernel of the paper's path never launched: "
                         f"{counts}")
    return counts


# -- phase 4: serve -----------------------------------------------------------

SLOTS, CHUNK, PAGE, MAX_LEN, BLOCK = 8, 16, 16, 1024, 8
N_REQ, GEN = 16, 64
# full-width qwen3-0.6b, made once a process for its serve phases
WEIGHTS: dict = {}


def qwen3() -> tuple:
    """(cfg, params) of full-width qwen3-0.6b: 28 layers of random bf16
    weights from a torch.Generator seeded with SEED, so that every process
    of the run serves the same model."""
    if not WEIGHTS:
        cfg = get_config("qwen3-0.6b")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t0 = time.perf_counter()
        params = M.lm_init(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        leaves = list(_leaves(params))
        print(f"qwen3-0.6b full width: {cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
              f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
              f"{sum(t.numel() for t in leaves) / 1e6:.1f}M params, "
              f"{sum(t.nbytes for t in leaves) / 2**30:.2f} GiB, init "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        WEIGHTS.update(cfg=cfg, params=params)
    return WEIGHTS["cfg"], WEIGHTS["params"]


def trace(vocab: int):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 512, N_REQ)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lens]


def prefills(eng) -> list:
    """The token count of every prefill ``eng`` runs from now on
    (admissions, and the recompute of preempted requests), in a list that
    fills as it runs."""
    lens, run = [], eng._run_prefill

    def recorded(slot, tokens, rid=None):
        lens.append(len(tokens))
        return run(slot, tokens, rid=rid)
    eng._run_prefill = recorded
    return lens


def serve(cfg, params, prompts, num_pages, backend: str, tune=None):
    """The trace through the Scheduler over a PagedEngine (warmed first
    when ``tune`` is given) -> (requests, preemptions, decode steps, full
    prefill chunks)."""
    eng = PagedEngine(cfg, params, slots=SLOTS, num_pages=num_pages,
                      page_size=PAGE, max_len=MAX_LEN, chunk=CHUNK,
                      decode_block=BLOCK, decode_backend=backend,
                      ffn_backend=backend, tune=tune, device="cuda")
    lens = prefills(eng)
    sched = Scheduler(eng)
    for p in prompts:
        sched.submit(p, GEN)
    t0 = time.perf_counter()
    done = sched.run_until_done()
    wall = time.perf_counter() - t0
    eng.pool.check()
    if eng.pool.num_live or eng.pool.num_free != eng.pool.capacity \
            or eng.any_active:
        raise SystemExit(f"{backend} serve leaked pages: "
                         f"{eng.pool.num_live} live")
    if any(r.state is not State.FINISHED or len(r.output) != GEN
           for r in done):
        raise SystemExit(f"{backend} serve: not every request finished")
    if eng.nan_rescues:
        raise SystemExit(f"{backend} serve: NaN logits")
    npre = sum(r.preemptions for r in done)
    backend += f", tune {tune}" if tune else ""
    print(f"serve [{backend}]: {len(done)} requests, {npre} preemptions, "
          f"{eng.prefill_steps} prefill chunks, {eng.decode_steps} decode "
          f"steps, {wall:.2f}s wall | prefill {eng.prefill_tokens} tok "
          f"{eng.prefill_tokens / eng.prefill_device_s:.1f} tok/s | decode "
          f"{eng.decoded_tokens} tok "
          f"{eng.decoded_tokens / eng.decode_device_s:.1f} tok/s",
          flush=True)
    return done, npre, eng.decode_steps, sum(n // CHUNK for n in lens)


def decode_step_parity(cfg, params, prompts) -> None:
    """One full-width lm_decode_step at 8 slots on one shared cache state,
    kernel path against plain path."""
    eng = PagedEngine(cfg, params, slots=SLOTS,
                      num_pages=SLOTS * pages_needed(MAX_LEN, PAGE) + 1,
                      page_size=PAGE, max_len=MAX_LEN, chunk=CHUNK,
                      decode_block=BLOCK, decode_backend="cuda",
                      ffn_backend="cuda", device="cuda")
    for s, p in enumerate(prompts[:SLOTS]):
        eng.admit(s, Request(rid=s, prompt=p, gen=GEN))
        grow = pages_needed(len(p) + 1, PAGE) - eng.bt.num_pages(s)
        eng.bt.append(s, eng.pool.alloc(grow))    # room for the next row
    tok = torch.as_tensor(eng.last[:, None], device="cuda")
    pos = torch.as_tensor(eng.written, device="cuda")
    bt = torch.as_tensor(eng.bt.device(), device="cuda")
    logits = {}
    for backend in ("cuda", "ref"):
        c = dataclasses.replace(cfg, decode_backend=backend,
                                ffn_backend=backend)
        cache = {"layers": [{k: v.clone() for k, v in layer.items()}
                            for layer in eng.cache["layers"]]}
        logits[backend], _ = M.lm_decode_step(params, cache, tok, pos, c,
                                              block_table=bt)
    torch.cuda.synchronize()
    diff = (logits["cuda"] - logits["ref"]).abs().max().item()
    scale = logits["ref"].abs().max().item()
    # the paths differ in decode attention's rounding (kernel: f32
    # probabilities; plain: bf16 probabilities before PV) and in the order
    # of the products' and norms' sums, which the bf16 residual stream
    # carries through 28 layers: allow 5% of the largest logit
    tol = 0.05 * scale
    same = (logits["cuda"].argmax(-1) == logits["ref"].argmax(-1)).float()
    print(f"lm_decode_step parity (full width, 8 slots): max|kernel-plain| "
          f"{diff:.4e} of max|logit| {scale:.4e} (tol {tol:.4e}); greedy "
          f"argmax agrees on {int(same.sum())}/{SLOTS} slots", flush=True)
    if not (math.isfinite(diff) and diff <= tol):
        raise SystemExit("kernel path and plain path logits disagree")


def serve_phase() -> dict:
    cfg, params = qwen3()
    prompts = trace(cfg.vocab)
    # pool: 60% of the pages the first SLOTS requests hold at completion,
    # so the running set outgrows it and the scheduler must preempt
    need = sum(pages_needed(len(p) + GEN, PAGE) for p in prompts[:SLOTS])
    num_pages = int(0.6 * need) + 1
    print(f"pool: {num_pages} pages of {PAGE} (first {SLOTS} requests need "
          f"{need} at completion)", flush=True)

    zero_counts()
    done, npre, steps, chunks = serve(cfg, params, prompts, num_pages,
                                      "cuda")
    SERVED["base tokens"] = [r.output for r in done]
    counts = read_counts()
    # row 2: every product of a decode step on the steps' route, and the
    # FFN's three products of every full prefill chunk (8 x 16 rows tile;
    # a shorter chunk's products are plain)
    want = {"paged_decode_attention": cfg.n_layers * steps,
            "rmsnorm": step_norms(cfg) * steps,
            "coarsened_matmul": step_products(cfg) * steps
            + 3 * cfg.n_layers * chunks}
    print(f"kernel launches on the served path: "
          f"{ {k: counts[k] for k in want} } over {steps} decode steps and "
          f"{chunks} full prefill chunks ({step_products(cfg)} matmul, "
          f"{step_norms(cfg)} row norm and {cfg.n_layers} paged decode a "
          f"step, {3 * cfg.n_layers} matmul a chunk: {want})", flush=True)
    if npre < 1:
        raise SystemExit("the undersized pool forced no preemption")
    if any(counts[k] != v for k, v in want.items()) or chunks < 1:
        raise SystemExit(f"the served path's launches are not {want}: "
                         f"{ {k: counts[k] for k in want} }")

    plain, *_ = serve(cfg, params, prompts, num_pages, "ref")
    agree = [next((i for i, (a, b) in enumerate(zip(r.output, p.output))
                   if a != b), GEN) for r, p in zip(done, plain)]
    print(f"greedy tokens, kernel path vs plain path: "
          f"{sum(a == GEN for a in agree)}/{N_REQ} requests identical; "
          f"first divergence per request {agree}", flush=True)
    decode_step_parity(cfg, params, prompts)
    return counts


# -- phase 6: serve qwen2-moe-a2.7b, bf16 and int8 (counters of every phase) --

# every wrapper's launch counter: kernel name -> (module, attribute)
COUNTERS = {"paged_decode_attention": (dec_mod, "launches"),
            "paged_decode_attention_int8": (dec_mod, "int8_launches"),
            "contig_decode_attention": (dec_mod, "contig_launches"),
            "contig_decode_attention_int8": (dec_mod,
                                             "contig_int8_launches"),
            "verify_attention": (dec_mod, "verify_launches"),
            "verify_attention_int8": (dec_mod, "verify_int8_launches"),
            "coarsened_matmul": (mm_mod, "launches"),
            "quant_matmul": (mm_mod, "q_launches"),
            "moe_ffn": (moe_mod, "launches"),
            "quant_moe_ffn": (moe_mod, "q_launches"),
            "flash_forward": (fa_mod, "fwd_launches"),
            "flash_bwd_prep": (fa_mod, "prep_launches"),
            "flash_bwd_dq": (fa_mod, "dq_launches"),
            "flash_bwd_dkv": (fa_mod, "dkv_launches"),
            "flash_sparse_fwd": (sp_mod, "launches"),
            "ew_stream": (ew_mod, "launches"),
            "gather_stream": (gs_mod, "launches"),
            "stencil5": (st_mod, "launches"),
            "dp_scan": (scan_mod, "launches"),
            "embed_gather": (eg_mod, "launches"),
            "ssd": (ssd_mod, "launches"),
            "rglru": (rg_mod, "launches"),
            "windowed_gather": (wg_mod, "launches"),
            "rmsnorm": (norm_mod, "launches")}


def zero_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {n: getattr(mod, attr) for n, (mod, attr) in COUNTERS.items()}


MOE_SERVE = dict(slots=8, chunk=16, page=16, max_len=512, block=8)
MOE_REQ, MOE_GEN = 8, 32


def moe_trace(vocab: int):
    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(64, 256, MOE_REQ)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lens]


def moe_engine(cfg, params, num_pages, quant=None, backend="cuda"):
    m = MOE_SERVE
    return PagedEngine(cfg, params, slots=m["slots"], num_pages=num_pages,
                       page_size=m["page"], max_len=m["max_len"],
                       chunk=m["chunk"], decode_block=m["block"],
                       decode_backend=backend, ffn_backend=backend,
                       moe_backend=backend, quant=quant, kv_quant=quant,
                       device="cuda")


def moe_serve(cfg, params, prompts, num_pages, quant) -> dict:
    """One kernel-path run of the trace; checks the run and the launch
    counts of its kernels, returns the counts."""
    tag = f"qwen2-moe {quant or 'bf16'}"
    eng = moe_engine(cfg, params, num_pages, quant)
    lens = prefills(eng)
    sched = Scheduler(eng)
    for p in prompts:
        sched.submit(p, MOE_GEN)
    zero_counts()
    t0 = time.perf_counter()
    done = sched.run_until_done()
    wall = time.perf_counter() - t0
    counts = read_counts()
    eng.pool.check()
    if eng.pool.num_live or eng.pool.num_free != eng.pool.capacity \
            or eng.any_active:
        raise SystemExit(f"{tag} serve leaked pages")
    if any(r.state is not State.FINISHED or len(r.output) != MOE_GEN
           for r in done):
        raise SystemExit(f"{tag} serve: not every request finished")
    if eng.nan_rescues:
        raise SystemExit(f"{tag} serve: NaN logits")
    npre = sum(r.preemptions for r in done)
    print(f"serve [{tag}]: {len(done)} requests FINISHED, {npre} "
          f"preemptions, no page leak, no NaN; {eng.prefill_steps} prefill "
          f"chunks, {eng.decode_steps} decode steps, {wall:.2f}s wall | "
          f"prefill {eng.prefill_tokens} tok "
          f"{eng.prefill_tokens / eng.prefill_device_s:.1f} tok/s | decode "
          f"{eng.decoded_tokens} tok "
          f"{eng.decoded_tokens / eng.decode_device_s:.1f} tok/s | weights "
          f"{eng.weight_mib / 1024:.2f} GiB (dense "
          f"{eng.weight_mib_dense / 1024:.2f}) | kv pool "
          f"{eng.cache_mib / 1024:.3f} GiB (bf16 "
          f"{eng.cache_mib_dense / 1024:.3f})", flush=True)
    if eng.quant_report is not None:
        print(f"  quantize_params: {eng.quant_report}", flush=True)
    path = {k: v for k, v in counts.items() if v}
    print(f"  kernel launches on the served path: {path}", flush=True)
    if npre < 1:
        raise SystemExit(f"{tag}: the undersized pool forced no preemption")
    n_layers = cfg.n_layers
    moe_k, dec_k, mm_k = (("quant_moe_ffn", "paged_decode_attention_int8",
                           "quant_matmul") if quant else
                          ("moe_ffn", "paged_decode_attention",
                           "coarsened_matmul"))
    want = {moe_k: n_layers * (eng.prefill_steps + eng.decode_steps),
            dec_k: n_layers * eng.decode_steps,
            "rmsnorm": step_norms(cfg) * eng.decode_steps}
    # a decode step's q, k, v, o, shared-FFN products and head on the
    # steps' route (row 2, weights dequantized first under int8); the
    # shared FFN of a full prefill chunk on row 2 (bf16) or row 10 (int8)
    step_mm = step_products(cfg) * eng.decode_steps
    prefill_mm = 3 * n_layers * sum(n // MOE_SERVE["chunk"] for n in lens)
    if quant:
        want.update({"coarsened_matmul": step_mm, mm_k: prefill_mm})
    else:
        want[mm_k] = step_mm + prefill_mm
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad or not prefill_mm:
        raise SystemExit(f"{tag}: launch counts {path} are not 24 per "
                         f"prefill chunk and decode step (MoE), 24 per "
                         f"decode step (decode), {step_products(cfg)} and "
                         f"{step_norms(cfg)} per decode step (the steps' "
                         f"products and norms) and 72 per full prefill "
                         f"chunk (shared FFN): {bad}")
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def lost_expert():
    """Fault model of the half-layer check: both MoE wrappers lose the
    first live expert's output while the block runs."""
    saved = ops.moe_ffn, ops.quant_moe_ffn

    def lose(fn):
        def faulty(xe, w1, w3, w2, comb, *a, **kw):
            y = fn(xe, w1, w3, w2, comb, *a, **kw)
            y[int((comb > 0).any(dim=1).nonzero()[0].item())] = 0
            return y
        return faulty
    ops.moe_ffn, ops.quant_moe_ffn = map(lose, saved)
    try:
        yield
    finally:
        ops.moe_ffn, ops.quant_moe_ffn = saved


@contextlib.contextmanager
def recorded_routes(sets: list):
    """Append each MoE layer's top-k expert set per token ((T, k), sorted),
    routed as `layers.moe` routes, to ``sets`` while the block runs."""
    moe = L.moe

    def recording(p, x, cfg, **kw):
        xt = x.reshape(-1, x.shape[-1])
        logits = (xt @ p["router"].to(xt.dtype)).float()
        logits[:, cfg.n_experts:] = -1e30
        idx = torch.topk(torch.softmax(logits, -1), cfg.top_k, dim=-1)[1]
        sets.append(idx.sort(-1).values)
        return moe(p, x, cfg, **kw)
    L.moe = recording
    try:
        yield
    finally:
        L.moe = moe


def moe_decode_step_parity(cfg, params, prompts, quant) -> None:
    """One full-width decode step at 8 slots on one shared cache state
    (prompts prefilled on the kernel path), kernel path against plain
    path, on the engine's own (under ``quant``, int8) weights and pools.

    Half-layer by half-layer: each layer's attention half runs on both
    paths from the kernel path's hidden state and a copy of the same cache
    (its output must agree within MOE_LAYER_LIMIT of the half's update),
    then its MoE layer (router, experts, shared experts) on both paths from
    the kernel path's attention output, so both routers pick the same
    experts (its output must agree within MOE_LAYER_LIMIT of its largest
    value).  Two planted faults of the kernel path must exceed those limits
    at every layer: slot 0's first V page zeroed (its V scales, in an int8
    pool) and the first live expert lost.

    Whole `lm_decode_step`: each layer's top-k expert sets are recorded on
    both paths.  A rounding difference can flip a near-tie of the router's
    4th and 5th expert, which moves that slot's logits by far more than
    any rounding; every slot that no layer flipped must agree within
    MOE_LAYER_LIMIT of the largest |logit|, and at least one must be
    held."""
    tag = f"qwen2-moe {quant or 'bf16'}"
    m = MOE_SERVE
    eng = moe_engine(cfg, params,
                     m["slots"] * pages_needed(m["max_len"], m["page"]) + 1,
                     quant)
    params = eng.params
    for s_, p in enumerate(prompts[:m["slots"]]):
        eng.admit(s_, Request(rid=s_, prompt=p, gen=MOE_GEN))
        grow = pages_needed(len(p) + 1, m["page"]) - eng.bt.num_pages(s_)
        eng.bt.append(s_, eng.pool.alloc(grow))
    tok = torch.as_tensor(eng.last[:, None], device="cuda")
    pos = torch.as_tensor(eng.written, device="cuda")
    bt = torch.as_tensor(eng.bt.device(), device="cuda")
    cfgs = {b: dataclasses.replace(eng.cfg, decode_backend=b, ffn_backend=b,
                                   moe_backend=b) for b in ("cuda", "ref")}

    def copy(layer):
        return {k: v.clone() for k, v in layer.items()}

    def ratio(got, want, scale):
        gap = (got.float() - want.float()).abs().max().item()
        return gap / (MOE_LAYER_LIMIT * scale.float().abs().max().item())

    lost_v = "V-scale" if quant else "V"
    checks = ("attention", "moe")
    faults = (f"{lost_v} page 0 of slot 0 zeroed", "first live expert lost")
    ratios = {k: [] for k in checks + faults}
    cap = B.decode_moe_capacity(cfg, m["slots"])
    x = M._embed(params, tok, cfg)
    for p, layer, kind in zip(params["layers"], eng.cache["layers"],
                              cfg.layer_kinds()):
        def attn(c, cache):
            return B.attn_decode_paged(p, x, c, cache, kind=kind, pos=pos,
                                       block_table=bt)
        xo = {b: attn(c, copy(layer)) for b, c in cfgs.items()}
        ratios["attention"].append(ratio(xo["cuda"], xo["ref"],
                                         xo["cuda"] - x))
        bad = copy(layer)
        bad["v_scale" if quant else "v"][bt[0, 0]] = 0
        ratios[faults[0]].append(ratio(attn(cfgs["cuda"], bad), xo["ref"],
                                       xo["cuda"] - x))
        h = L.rmsnorm(p["ln2"], xo["cuda"], cfg.norm_eps)
        y = {b: L.moe(p["moe"], h, c, capacity=cap, step=True)[0]
             for b, c in cfgs.items()}
        ratios["moe"].append(ratio(y["cuda"], y["ref"], y["cuda"]))
        with lost_expert():
            yb = L.moe(p["moe"], h, cfgs["cuda"], capacity=cap,
                       step=True)[0]
        ratios[faults[1]].append(ratio(yb, y["ref"], y["cuda"]))
        x = xo["cuda"] + y["cuda"]
    logits, routes = {}, {}
    for b, c in cfgs.items():
        cache = {"layers": [copy(layer) for layer in eng.cache["layers"]]}
        routes[b] = []
        with recorded_routes(routes[b]):
            logits[b], _ = M.lm_decode_step(params, cache, tok, pos, c,
                                            block_table=bt)
        del cache
    torch.cuda.synchronize()
    if not len(routes["cuda"]) == len(routes["ref"]) == cfg.n_layers:
        raise SystemExit(f"{tag}: the route recorder missed MoE layers")
    flips = [sum(int(not torch.equal(a[s_], r[s_]))
                 for a, r in zip(routes["cuda"], routes["ref"]))
             for s_ in range(m["slots"])]
    gap = (logits["cuda"] - logits["ref"]).abs().amax(-1).flatten().tolist()
    limit = MOE_LAYER_LIMIT * logits["ref"].abs().max().item()
    held = [s_ for s_ in range(m["slots"]) if not flips[s_]]
    same = (logits["cuda"].argmax(-1) == logits["ref"].argmax(-1)).sum()
    print(f"{tag} decode step parity (full width, 8 slots), half-layer by "
          f"half-layer: max|kernel-plain| / limit per layer (limit "
          f"{MOE_LAYER_LIMIT} of the attention half's update, of the MoE "
          f"output's largest value)", flush=True)
    for k, v in ratios.items():
        print(f"  {'planted fault, ' if k in faults else ''}{k}: "
              f"{[round(r, 3) for r in v]}", flush=True)
    print(f"  whole lm_decode_step: layers whose top-{cfg.top_k} expert set "
          f"differs, per slot {flips}; max|kernel-plain| per slot "
          f"{[round(v, 4) for v in gap]}, limit {limit:.4f} "
          f"({MOE_LAYER_LIMIT} of max|logit|) held on slots {held}; greedy "
          f"argmax agrees on {int(same)}/{m['slots']} slots", flush=True)
    if not all(math.isfinite(r) and r <= 1 for k in checks
               for r in ratios[k]):
        raise SystemExit(f"{tag}: kernel path and plain path disagree "
                         f"within a half-layer")
    if not all(r > 1 for k in faults for r in ratios[k]):
        raise SystemExit(f"{tag}: the half-layer limit would not catch a "
                         f"planted fault at every layer")
    if not held or any(not gap[s_] <= limit for s_ in held) \
            or not all(map(math.isfinite, gap)):
        raise SystemExit(f"{tag}: a decode step's logits disagree on a "
                         f"slot whose experts no layer flipped, or no slot "
                         f"was free of flips")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


# The two paths round decode attention's probabilities (kernel: f32;
# plain: bf16) and the expert chain (kernel: h once; plain: every einsum)
# at different points, 2^-8 relative per rounding, a few roundings deep:
# 5%, as qwen3's end-to-end parity allows of the logits.  The attention
# half's output also rounds to bf16 at the residual's scale, which grows
# with depth; the MoE output is compared before the residual add.
MOE_LAYER_LIMIT = 0.05


def moe_serve_phase() -> dict:
    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.lm_init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"qwen2-moe-a2.7b full width: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, "
          f"{cfg.n_experts} experts (padded to {cfg.n_experts_padded}) top-"
          f"{cfg.top_k} of width {cfg.moe_d_ff}, {cfg.n_shared_experts} "
          f"shared, vocab {cfg.vocab}: {n_par / 1e9:.2f}B params, "
          f"{tree_nbytes(params) / 2**30:.2f} GiB bf16, init "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    prompts = moe_trace(cfg.vocab)
    m = MOE_SERVE
    need = sum(pages_needed(len(p) + MOE_GEN, m["page"]) for p in prompts)
    num_pages = int(0.6 * need) + 1
    print(f"pool: {num_pages} pages of {m['page']} (the {MOE_REQ} requests "
          f"need {need} at completion); prompts {sorted(map(len, prompts))}",
          flush=True)
    totals = dict.fromkeys(COUNTERS, 0)
    for quant in (None, "int8"):
        counts = moe_serve(cfg, params, prompts, num_pages, quant)
        for k, v in counts.items():
            totals[k] += v
        moe_decode_step_parity(cfg, params, prompts, quant)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# -- phase 7: contiguous serve of qwen3-0.6b (BatchedServer), bf16 and int8 ---

def contig_serve(cfg, params, prompts, kv_quant: str) -> tuple:
    """The serve trace through `BatchedServer` on the kernel path: every
    request completes, no NaN logits, and 28 contiguous-decode launches per
    decode step (counted from zero around the run).  Returns (counts,
    server)."""
    tag = f"contiguous {kv_quant if kv_quant != 'none' else 'bf16'}"
    server = BatchedServer(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                           chunk=CHUNK, decode_block=BLOCK,
                           decode_backend="cuda", ffn_backend="cuda",
                           kv_quant=kv_quant, device="cuda")
    pending = list(prompts)
    zero_counts()
    t0 = time.perf_counter()
    while pending or server.any_active:
        while pending and server.try_admit(pending[0], GEN):
            pending.pop(0)
        server.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if len(server.completed) != len(prompts) \
            or any(len(o) != GEN for o in server.completed):
        raise SystemExit(f"{tag} serve: not every request completed")
    if server.nan_steps:
        raise SystemExit(f"{tag} serve: NaN logits in {server.nan_steps} "
                         f"steps")
    print(f"serve [{tag}]: {len(server.completed)} requests completed, no "
          f"NaN; {server.prefill_steps} prefill chunks, "
          f"{server.decode_steps} decode steps, {wall:.2f}s wall | prefill "
          f"{server.prefill_tokens} tok "
          f"{server.prefill_tokens / server.prefill_device_s:.1f} tok/s | "
          f"decode {server.decoded_tokens} tok "
          f"{server.decoded_tokens / server.decode_device_s:.1f} tok/s | kv "
          f"cache {server.cache_mib / 1024:.3f} GiB (bf16 "
          f"{server.cache_mib_dense / 1024:.3f})", flush=True)
    path = {k: v for k, v in counts.items() if v}
    print(f"  kernel launches on the served path: {path}", flush=True)
    key = "contig_decode_attention" + ("_int8" if kv_quant == "int8" else "")
    want = cfg.n_layers * server.decode_steps
    if counts[key] != want or counts["coarsened_matmul"] < 1:
        raise SystemExit(f"{tag}: {counts[key]} contiguous decode launches, "
                         f"not {cfg.n_layers} per decode step ({want}), or "
                         f"no FFN matmul launch: {path}")
    return counts, server


def contig_decode_step_parity(cfg, params, server) -> None:
    """One full-width contiguous lm_decode_step for the 8 slots the serve
    run left behind (each slot's cache holds its last request up to its
    pos), kernel path against plain path from copies of that cache."""
    tok = torch.as_tensor([[o[-1]] for o in server.outputs], device="cuda",
                          dtype=torch.int32)
    pos = torch.as_tensor(np.minimum(server.pos, MAX_LEN - 1), device="cuda")
    logits = {}
    for backend in ("cuda", "ref"):
        c = dataclasses.replace(server.cfg, decode_backend=backend,
                                ffn_backend=backend)
        cache = {"layers": [{k: v.clone() for k, v in layer.items()}
                            for layer in server.cache["layers"]]}
        logits[backend], _ = M.lm_decode_step(params, cache, tok, pos, c)
    torch.cuda.synchronize()
    diff = (logits["cuda"] - logits["ref"]).abs().max().item()
    scale = logits["ref"].abs().max().item()
    tol = 0.05 * scale          # as the paged step check (phase 4)
    print(f"contiguous lm_decode_step parity ({server.cfg.kv_quant} kv, "
          f"full width, 8 slots): max|kernel-plain| {diff:.4e} of "
          f"max|logit| {scale:.4e} (tol {tol:.4e})", flush=True)
    if not (math.isfinite(diff) and diff <= tol):
        raise SystemExit("contiguous kernel path and plain path logits "
                         "disagree")


def contig_serve_phase() -> dict:
    cfg, params = qwen3()
    prompts = trace(cfg.vocab)
    totals = dict.fromkeys(COUNTERS, 0)
    for kv_quant in ("none", "int8"):
        counts, server = contig_serve(cfg, params, prompts, kv_quant)
        for k, v in counts.items():
            totals[k] += v
        contig_decode_step_parity(cfg, params, server)
        del server
        gc.collect()
        torch.cuda.empty_cache()
    return totals


# -- invariance: the decode and verify steps' ops, 8 rows alone and in 40 ----

INV_ROWS, INV_BATCH = 8, 40      # a decode step's rows, a verify pass's (K 4)
INV_PLACES = (0, 8, 13, 32)      # where the 8 rows sit in the 40-row batch
INV_DRAWS = 4                    # draws of the 8 rows an op


def placed(args: tuple, at: int, gen) -> tuple:
    """Each of ``args`` (8 rows each) at rows at .. at + 7 of a 40-row
    batch whose other rows are fresh draws of the same kind."""
    out = []
    for a in args:
        if a.is_floating_point():
            big = torch.randn((INV_BATCH,) + a.shape[1:], generator=gen,
                              device="cuda").to(a.dtype)
        else:
            big = torch.randint(64, 600, (INV_BATCH,) + a.shape[1:],
                                generator=gen, device="cuda").to(a.dtype)
        big[at:at + INV_ROWS] = a
        out.append(big)
    return tuple(out)


def parted(op, args: tuple, gen) -> list:
    """The places at which ``op``'s 8 rows inside the 40-row batch are not
    bit-equal to ``op`` on the 8 rows alone."""
    alone = op(*args)
    return [at for at in INV_PLACES
            if not torch.equal(op(*placed(args, at, gen))[at:at + INV_ROWS],
                               alone)]


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each v > 0: 2^(floor(log2 v) - 7)."""
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), e - 8)


def step_products_hold(w: dict, gen) -> float:
    """Each product of the steps' route as the steps call it (`layers.dense`
    with ``kernel``: ragged rows, the bf16 store, the tied head read
    K-major in place) at a decode step's 8 rows and a verify pass's 40,
    against its plain version rounded to bf16 (`ref.matmul(a, b)
    .bfloat16()`): within one bf16 ulp of each element plus the order
    bound of the float32 sums (`mm_tol`, which matters only near zero);
    launched twice, bit-equal; beside fault models that must exceed that
    limit somewhere: slice 0's partial dropped (where the plan splits K),
    the first two 64-column tiles swapped, and for the K-major head the
    weight's memory read MN-major.  A rounding that falls the other way
    reads just under 1 (one ulp against one ulp plus the order bound).
    Returns the largest error / limit."""
    sms = mm_mod.sm_count(torch.device("cuda"))
    worst = 0.0
    for m in (INV_ROWS, INV_BATCH):
        for name, wt in w.items():
            k, n = wt.shape
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            got = L.dense(x, wt, kernel=True)
            again = L.dense(x, wt, kernel=True)
            torch.cuda.synchronize()
            want32 = ref.matmul(x, wt)
            dlt = mm_tol(k, want32.abs().max().item())
            lim = bf16_ulp(want32.abs() + dlt) + dlt
            want = want32.bfloat16()

            def ratio(y):
                return ((y.float() - want.float()).abs() / lim).max().item()

            plan = mm_mod.step_plan(m, n, k, sms)
            faults = []
            if plan.splits > 1:
                k0, k1 = plan.bounds(k)[0]
                faults.append(("slice 0's partial dropped", ratio(
                    want32 - ref.matmul(x[:, k0:k1], wt[k0:k1]))))
            swapped = want.clone()
            swapped[:, :mm_mod.BN] = want[:, mm_mod.BN:2 * mm_mod.BN]
            swapped[:, mm_mod.BN:2 * mm_mod.BN] = want[:, :mm_mod.BN]
            faults.append(("column tiles 0 and 1 swapped", ratio(swapped)))
            if not wt.is_contiguous():
                faults.append(("the K-major weight read MN-major", ratio(
                    ref.matmul(x, wt.T.reshape(k, n)))))
            r, same = ratio(got), torch.equal(got, again)
            print(f"step product {name} at M {m} ({m}x{k})@({k}x{n}), "
                  f"{got.dtype} store, "
                  f"{'K-major' if not wt.is_contiguous() else 'MN-major'} "
                  f"weight, S {plan.splits}: max |route - plain| / limit "
                  f"(1 bf16 ulp + {dlt:.2e}) {r:.3f}; two launches "
                  f"bit-equal: {same}"
                  + "".join(f"; fault model ({what}) / limit {fr:.1f}"
                            for what, fr in faults), flush=True)
            if not (got.dtype == torch.bfloat16 and r <= 1):
                raise SystemExit(f"step product {name} at M {m} disagrees "
                                 f"with its plain version")
            if not same:
                raise SystemExit(f"step product {name} at M {m} gave other "
                                 f"bits on a second launch")
            for what, fr in faults:
                if not fr > 1:
                    raise SystemExit(f"the step product limit would not "
                                     f"catch {what} ({name}, M {m})")
            worst = max(worst, r)
    return worst


def invariance_phase() -> dict:
    """Each op of a full-width qwen3-0.6b decode step (layer 0's weights,
    the tied head) on 8 rows alone and on the same 8 rows at rows {0, 8,
    13, 32} of a 40-row batch, bit for bit, over `INV_DRAWS` draws: the 7
    products and the head on the steps' route (the bf16 store the steps
    run, `layers.dense` with ``kernel``, each beside the torch product it
    replaced, a probe, reported: bf16 cuBLAS for q, k, v, o and the head,
    the float32 product the FFN took at untiled rows; and their float32
    sums, `matmul.step_matmul`); the norm over d and the qk-norm over hd
    on the row kernel, each beside the float32 statistic of the torch
    norm it replaced (mean(x^2), a probe); RoPE and SiLU*up, elementwise
    torch ops the steps keep; then the paged attention at T = 1 against
    T = 5 (bf16 and int8 pools).  Any op of the steps that parts fails the
    run.  Then the route's products against their plain versions
    (`step_products_hold`), and timed at M 8 and M 40 beside the plain
    version and `torch.matmul` at the same shapes, with the host time of
    one call."""
    cfg, params = qwen3()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lay = params["layers"][0]
    w = {"q": lay["attn"]["wq"], "k": lay["attn"]["wk"],
         "v": lay["attn"]["wv"], "o": lay["attn"]["wo"],
         "gate": lay["ffn"]["w1"], "up": lay["ffn"]["w3"],
         "down": lay["ffn"]["w2"], "head": M._head(params, cfg)}

    def rows(*shape):
        return torch.randn((INV_ROWS,) + shape, generator=gen,
                           device="cuda").bfloat16()

    def norm(n):
        return {"scale": 0.1 * torch.randn(n, generator=gen, device="cuda")}

    def mean_sq(x):                  # the torch norm's f32 statistic
        return x.float().square().mean(dim=-1)

    ops_ = {}          # op -> (the step's op, the op it replaced, inputs)
    for name, wt in w.items():
        old = ((lambda x, wt=wt: torch.matmul(x.float(), wt.float()))
               if name in ("gate", "up", "down") else
               (lambda x, wt=wt: x @ wt))
        shape = f"({wt.shape[0]}x{wt.shape[1]})"
        ops_[f"product {name} {shape}, bf16 store"] = (
            lambda x, wt=wt: L.dense(x, wt, kernel=True), old,
            lambda wt=wt: (rows(wt.shape[0]),))
        ops_[f"product {name} {shape}, f32 sums"] = (
            lambda x, wt=wt: mm_mod.step_matmul(x, wt), None,
            lambda wt=wt: (rows(wt.shape[0]),))
    nd = norm(cfg.d_model)
    ops_["rmsnorm over d"] = (
        lambda x: L.rmsnorm(nd, x, cfg.norm_eps, kernel=True), mean_sq,
        lambda: (rows(cfg.d_model),))
    for name, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads)):
        sc = norm(cfg.hd)
        ops_[f"qk-norm over hd ({name})"] = (
            lambda x, sc=sc: L.rmsnorm(sc, x, cfg.norm_eps, kernel=True),
            mean_sq, lambda heads=heads: (rows(1, heads, cfg.hd),))
    ops_["RoPE"] = (lambda x, p: L.apply_rope(x, p, cfg.rope_theta), None,
                    lambda: (rows(1, cfg.n_heads, cfg.hd),
                             torch.randint(64, 600, (INV_ROWS, 1),
                                           generator=gen, device="cuda")))
    ops_["SiLU*up"] = (lambda g, u: F.silu(g) * u, None,
                       lambda: (rows(cfg.d_ff), rows(cfg.d_ff)))
    bad = []
    for name, (step_op, old_op, draw) in ops_.items():
        got, old = set(), []
        for _ in range(INV_DRAWS):
            args = draw()
            got.update(parted(step_op, args, gen))
            if old_op is not None:
                old.append(parted(old_op, args, gen))
        probe = ("" if old_op is None else
                 f"; the torch op it replaced parts in "
                 f"{sum(map(bool, old))} of {INV_DRAWS} draws (places "
                 f"{sorted(set().union(*old))})")
        print(f"invariance {name}: the step's op "
              f"{'(torch, kept) ' if name in ('RoPE', 'SiLU*up') else ''}"
              + (f"bit-equal at every place of {INV_PLACES} in "
                 f"{INV_DRAWS} draws" if not got else
                 f"PARTS at {sorted(got)}") + probe, flush=True)
        if got:
            bad.append(name)
    # the paged attention: five T = 1 calls at pos0 + t against T = 5
    for quant in (False, True):
        q, kp, vp, bt, pos0, sc = verify_operands(gen, VER, quant)
        ver = ops.flash_attention_verify(q, kp, vp, bt, pos0, **sc)
        same = [torch.equal(ops.paged_decode_attention(
            q[:, t:t + 1].contiguous(), kp, vp, bt, pos0 + t, **sc),
            ver[:, t:t + 1]) for t in range(SPEC_K + 1)]
        print(f"invariance paged attention ({'int8' if quant else 'bf16'} "
              f"pools): paged decode at pos0 + t bit-equal to verify row t "
              f"(T {SPEC_K + 1}): {same}", flush=True)
        if not all(same):
            bad.append(f"paged attention {'int8' if quant else 'bf16'}")
    if bad:
        raise SystemExit(f"step ops part from their rows alone: {bad}")
    step_products_hold(w, gen)
    # the route's products at a decode step's and a verify pass's rows
    sms = mm_mod.sm_count(torch.device("cuda"))
    for name, wt in w.items():
        k, n = wt.shape
        plan = mm_mod.step_plan(INV_ROWS, n, k, sms)
        line = []
        for m in (INV_ROWS, INV_BATCH):
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            one, _ = bound(2 * m * k + 2 * k * n + 2 * m * n, 2 * m * n * k)
            line.append(
                f"M {m}: route "
                f"{time_ms(lambda: L.dense(x, wt, kernel=True)):.4f} ms, "
                f"plain {time_ms(lambda: ref.matmul(x, wt)):.4f} ms, "
                f"torch.matmul {time_ms(lambda: torch.matmul(x, wt)):.4f} "
                f"ms, bound {one:.4f}")
        print(f"step product {name} ({k}x{n}), S {plan.splits}, "
              f"{plan.grid[1]} column tiles: " + "; ".join(line), flush=True)
    x = torch.randn(INV_ROWS, cfg.d_model, generator=gen,
                    device="cuda").bfloat16()
    print(f"step product host time of one call (8x1024)@(1024x2048): route "
          f"{host_us(lambda: L.dense(x, w['q'], kernel=True)):.1f} us (its "
          f"wrapper alone "
          f"{host_us(lambda: mm_mod.step_matmul(x, w['q'], torch.bfloat16)):.1f}"
          f" us) | torch.matmul "
          f"{host_us(lambda: torch.matmul(x, w['q'])):.1f} us", flush=True)
    return {}


# -- phase 8: speculative serve of qwen3-0.6b (SpecPagedEngine) ---------------

SPEC_K, SPEC_REQ, SPEC_GEN = 4, 8, 32
EXACT_DRAWS = 16                 # draft-token draws of the exactness check


def spec_engine(cfg, params, num_pages, draft: str, **kw):
    draft_cfg, draft_params = (cfg, params) if draft == "self" else (
        draft_of(cfg), None)
    return SpecPagedEngine(
        cfg, params, spec_k=SPEC_K, draft_cfg=draft_cfg,
        draft_params=draft_params,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
        slots=SLOTS, num_pages=num_pages, page_size=PAGE, max_len=MAX_LEN,
        chunk=CHUNK, decode_backend="cuda", ffn_backend="cuda",
        device="cuda", **kw)


def spec_serve(cfg, params, prompts, num_pages, draft: str, **kw) -> tuple:
    """The spec trace through the Scheduler over a SpecPagedEngine: every
    request FINISHED, ``pool.check()``, no page leak, at least one
    preemption, and 28 verify launches per verify step.  Returns (counts,
    outputs, preemptions per request)."""
    eng = spec_engine(cfg, params, num_pages, draft, **kw)
    draft = draft + (" " + ",".join(f"{k}={v}" for k, v in kw.items())
                     if kw else "")
    sched = Scheduler(eng)
    for p in prompts:
        sched.submit(p, SPEC_GEN)
    zero_counts()
    t0 = time.perf_counter()
    done = sched.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    eng.pool.check()
    if eng.pool.num_live or eng.pool.num_free != eng.pool.capacity \
            or eng.any_active:
        raise SystemExit(f"spec serve ({draft}) leaked pages")
    if any(r.state is not State.FINISHED or len(r.output) != SPEC_GEN
           for r in done):
        raise SystemExit(f"spec serve ({draft}): not every request finished")
    npre = sum(r.preemptions for r in done)
    print(f"serve [spec K={SPEC_K}, draft {draft}]: {len(done)} requests "
          f"FINISHED, {npre} preemptions, no page leak; acceptance "
          f"{eng.acceptance_rate:.3f} ({eng.accepted}/{eng.drafted}), "
          f"{eng.spec_steps} verify steps, {eng.rescue_steps} rescue steps, "
          f"{eng.nan_rows} NaN rows, "
          f"{eng.decoded_tokens / eng.spec_steps:.2f} tokens per verify "
          f"step, {wall:.2f}s wall | prefill {eng.prefill_tokens} tok "
          f"{eng.prefill_tokens / eng.prefill_device_s:.1f} tok/s (target "
          f"and draft) | decode {eng.decoded_tokens} tok "
          f"{eng.decoded_tokens / eng.decode_device_s:.1f} tok/s",
          flush=True)
    path = {k: v for k, v in counts.items() if v}
    print(f"  kernel launches on the served path: {path}", flush=True)
    if npre < 1:
        raise SystemExit(f"spec serve ({draft}): the undersized pool forced "
                         f"no preemption")
    want = cfg.n_layers * eng.spec_steps
    key = "verify_attention" + ("_int8" if eng.cfg.kv_quant == "int8"
                                else "")
    if counts[key] != want:
        raise SystemExit(f"spec serve ({draft}): {counts[key]} {key} "
                         f"launches, not {cfg.n_layers} per verify step "
                         f"({want})")
    outputs = [r.output for r in done]
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return counts, outputs, [r.preemptions for r in done]


@contextlib.contextmanager
def shifted_verify_mask():
    """Row t of every verify kernel call sees position pos0 + t + 1."""
    saved = dec_mod.verify_attention

    def faulty(q, k, v, bt, pos0, *a, **kw):
        return saved(q, k, v, bt, pos0 + 1, *a, **kw)
    dec_mod.verify_attention = faulty
    try:
        yield
    finally:
        dec_mod.verify_attention = saved


def step_products(cfg) -> int:
    """Row 2's launches a decode or verify step makes on the steps' route:
    q, k, v, o and the three (shared-expert) FFN products a layer, and the
    head."""
    return 7 * cfg.n_layers + 1


def step_norms(cfg) -> int:
    """The row norm's launches a decode or verify step makes: ln1, ln2
    (and the q and k norms) a layer, and the final norm."""
    return cfg.n_layers * (2 + 2 * int(cfg.qk_norm)) + 1


def verify_decode_exactness(cfg, params, prompts, kv_quant: str) -> None:
    """The accept rule's premise at full width: on a shared cache (8 slots,
    the trace's first 8 prompts cut to 64 tokens; bf16 or int8 pools), row
    t of one lm_verify_step over [last, d_1..d_4] against lm_decode_step at
    pos0 + t fed the same tokens, both on the kernel path, bit for bit on
    every slot, and the pools each leaves behind (the rows each wrote) bit
    for bit, over EXACT_DRAWS draws of random draft tokens; a verify whose
    mask is shifted by one must part.  Each step launches row 2's kernel
    for every product (`step_products`), the row norm for every norm
    (`step_norms`) and the rows kernel once a layer (paged decode,
    verify)."""
    eng = PagedEngine(cfg, params, slots=SLOTS,
                      num_pages=SLOTS * pages_needed(MAX_LEN, PAGE) + 1,
                      page_size=PAGE, max_len=MAX_LEN, chunk=CHUNK,
                      decode_backend="cuda", ffn_backend="cuda",
                      kv_quant=kv_quant, device="cuda")
    for s, p in enumerate(prompts[:SLOTS]):
        eng.admit(s, Request(rid=s, prompt=p[:64], gen=GEN))
        grow = pages_needed(64 + SPEC_K + 2, PAGE) - eng.bt.num_pages(s)
        eng.bt.append(s, eng.pool.alloc(grow))
    rng = np.random.default_rng(SEED + 2)
    pos0 = torch.as_tensor(eng.written, device="cuda")
    bt = torch.as_tensor(eng.bt.device(), device="cuda")
    c = eng.cfg
    int8 = "_int8" if kv_quant == "int8" else ""
    want = {"coarsened_matmul": step_products(cfg),
            "rmsnorm": step_norms(cfg),
            "paged_decode_attention" + int8: cfg.n_layers,
            "verify_attention" + int8: cfg.n_layers}

    def fresh():
        return {"layers": [{k: v.clone() for k, v in layer.items()}
                           for layer in eng.cache["layers"]]}

    def launches(run, what):
        zero_counts()
        out = run()
        got = {k: v for k, v in read_counts().items() if v}
        need = {k: v for k, v in want.items()
                if k in ("coarsened_matmul", "rmsnorm") or k.startswith(what)}
        if got != need:
            raise SystemExit(f"one {what} step launched {got}, not {need}")
        return out

    parted_rows = parted_pools = 0
    rows_seen = 0
    for draw in range(EXACT_DRAWS):
        toks = np.concatenate([eng.last[:, None], rng.integers(
            1, cfg.vocab, (SLOTS, SPEC_K))], axis=1)
        toks = torch.as_tensor(toks, dtype=torch.int32, device="cuda")
        dcache, vcache = fresh(), fresh()
        rows = []
        for t in range(SPEC_K + 1):
            step = functools.partial(M.lm_decode_step, params, dcache,
                                     toks[:, t:t + 1], pos0 + t, c,
                                     block_table=bt)
            lg, _ = launches(step, "paged_decode") if draw == t == 0 \
                else step()
            rows.append(lg)
        dec = torch.stack(rows, dim=1)
        verify = functools.partial(M.lm_verify_step, params, vcache, toks,
                                   pos0, c, block_table=bt)
        ver, _ = launches(verify, "verify") if draw == 0 else verify()
        parted_rows += sum(not torch.equal(ver[s, t], dec[s, t])
                           for s in range(SLOTS) for t in range(SPEC_K + 1))
        rows_seen += SLOTS * (SPEC_K + 1)
        parted_pools += sum(not torch.equal(a[name], b[name])
                            for a, b in zip(dcache["layers"],
                                            vcache["layers"]) for name in a)
        if draw == 0:
            with shifted_verify_mask():
                bad, _ = M.lm_verify_step(params, fresh(), toks, pos0, c,
                                          block_table=bt)
            fault = sum(not torch.equal(bad[s, t], dec[s, t])
                        for s in range(SLOTS) for t in range(SPEC_K + 1))
            clear = int(clears_tie_guard(ver, 0.1).sum())
    torch.cuda.synchronize()
    tag = "int8" if kv_quant == "int8" else "bf16"
    print(f"verify vs decode ({tag} pools, full width, {EXACT_DRAWS} draws "
          f"x {SLOTS} slots x {SPEC_K + 1} rows, kernel path): {parted_rows}"
          f" of {rows_seen} verify rows part from their decode rows; "
          f"{parted_pools} of {EXACT_DRAWS * len(dcache['layers']) * len(dcache['layers'][0])}"
          f" pools part after the two passes; fault model (row t's mask "
          f"shifted by one): {fault} of {SLOTS * (SPEC_K + 1)} rows part; "
          f"{clear} of {SLOTS * (SPEC_K + 1)} rows of draw 0 clear the tie "
          f"guard (0.1 sigma); launches of one step: {want}", flush=True)
    if parted_rows or parted_pools:
        raise SystemExit("verify rows or the cache rows they wrote are not "
                         "bit-equal to the decode steps'")
    if not fault:
        raise SystemExit("the verify-vs-decode check would not catch a "
                         "shifted mask")
    del eng, dcache, vcache, bad
    gc.collect()
    torch.cuda.empty_cache()


def paged_tokens(cfg, params, prompts, num_pages, kv_quant: str) -> tuple:
    """The spec trace through `Scheduler` over `PagedEngine` on the kernel
    path (bf16 or int8 pools): (outputs, preemptions per request)."""
    eng = PagedEngine(cfg, params, slots=SLOTS, num_pages=num_pages,
                      page_size=PAGE, max_len=MAX_LEN, chunk=CHUNK,
                      decode_block=BLOCK, decode_backend="cuda",
                      ffn_backend="cuda", kv_quant=kv_quant, device="cuda")
    sched = Scheduler(eng)
    for p in prompts:
        sched.submit(p, SPEC_GEN)
    done = sched.run_until_done()
    out = [r.output for r in done], [r.preemptions for r in done]
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_serve_phase() -> dict:
    cfg, params = qwen3()
    prompts = trace(cfg.vocab)[:SPEC_REQ]
    need = sum(pages_needed(len(p) + SPEC_GEN, PAGE) for p in prompts)
    num_pages = int(0.6 * need) + 1
    print(f"spec pool: {num_pages} pages of {PAGE} (the {SPEC_REQ} requests "
          f"need {need} at completion)", flush=True)
    for kv_quant in ("none", "int8"):
        verify_decode_exactness(cfg, params, prompts, kv_quant)
    totals = dict.fromkeys(COUNTERS, 0)
    outs = {}
    for draft, kw in (("draft_of", {}), ("self", {}),
                      ("draft_of", {"tie_tau": math.inf}),
                      ("draft_of", {"kv_quant": "int8"})):
        counts, *outs[draft, tuple(kw)] = spec_serve(
            cfg, params, prompts, num_pages, draft, **kw)
        for k, v in counts.items():
            totals[k] += v
    # Greedy tokens against the non-speculative kernel path on pools of the
    # same kind, held on every request of every run: verify rows and the
    # cache rows they write are bit-equal to decode steps' (the
    # verify-vs-decode check above), so the accept, rollback, rescue and
    # paging machinery must give PagedEngine's tokens.
    base = {kq: paged_tokens(cfg, params, prompts, num_pages, kq)
            for kq in ("none", "int8")}
    parted = []
    for (draft, kw), (out, npre) in outs.items():
        ref_out, ref_npre = base["int8" if "kv_quant" in kw else "none"]
        agree = [next((i for i, (a, b) in enumerate(zip(o, r)) if a != b),
                      SPEC_GEN) for o, r in zip(out, ref_out)]
        tag = draft + {(): "", ("tie_tau",): ", every row voided",
                       ("kv_quant",): ", int8 KV pools (against int8 "
                                      "pools)"}[kw]
        print(f"greedy tokens, spec ({tag}) vs PagedEngine kernel path: "
              f"{sum(a == SPEC_GEN for a in agree)}/{SPEC_REQ} requests "
              f"identical; first divergence per request {agree}; "
              f"preemptions per request {npre} (PagedEngine {ref_npre})",
              flush=True)
        if any(a != SPEC_GEN for a in agree):
            parted.append(tag)
    if parted:
        raise SystemExit(f"spec tokens differ from the PagedEngine run's: "
                         f"{parted}")
    return totals


# -- the tuner: warm, tuned serving, tuned training ---------------------------

# this process's caches (and its side processes' logs), removed at the end
TUNE_DIR = ROOT / "build" / "chip_smoke_tune" / str(os.getpid())
# what a tuned run shares with the runs before it
SERVED: dict = {}
# a warmed family's candidates launch these kernels (any of them)
FAMILY_COUNTERS = {
    "ew_stream": ("ew_stream",), "embed_gather": ("embed_gather",),
    "matmul": ("coarsened_matmul", "quant_matmul"),
    "decode_attention": ("contig_decode_attention",
                         "contig_decode_attention_int8"),
    "decode_attention_paged": ("paged_decode_attention",
                               "paged_decode_attention_int8"),
    "flash_attention_verify": ("verify_attention", "verify_attention_int8"),
    "flash_attention": ("flash_forward",),
    "flash_attention_bwd": ("flash_bwd_dkv",),
    "flash_attention_sparse": ("flash_sparse_fwd",),
    "moe_ffn": ("moe_ffn", "quant_moe_ffn"),
    "ssd": ("ssd",), "rglru": ("rglru",)}


def use_cache(name: str, fresh: bool) -> Path:
    """Point ``cfg="auto"`` at the tuning cache ``build/chip_smoke_tune/
    <name>.json`` (emptied first when ``fresh``)."""
    path = TUNE_DIR / f"{name}.json"
    if fresh:
        path.unlink(missing_ok=True)
    os.environ[ENV_VAR] = str(path)
    ops._auto_cfg.cache_clear()
    return path


@contextlib.contextmanager
def logged_measurer(log: list):
    """The tuner's measurer, wrapped: each candidate's time is logged, and
    a measurement that launched no kernel of its family fails the run."""
    make = tune_warm.wall_measurer

    def wrapped(*a, **kw):
        measure = make(*a, **kw)

        def logged(spec, cfg):
            before = read_counts()
            sec = measure(spec, cfg)
            after = read_counts()
            rose = sum(after[k] - before[k]
                       for k in FAMILY_COUNTERS[spec.family])
            if rose < 1:
                raise SystemExit(f"tune: measuring {spec.key} under "
                                 f"{cfg.label} launched no kernel")
            log.append((spec, cfg.label, sec * 1e3, rose))
            return sec
        return logged

    tune_warm.wall_measurer = wrapped
    try:
        yield
    finally:
        tune_warm.wall_measurer = make


@contextlib.contextmanager
def filed_keys(out: dict):
    """Record every key a CUDA call resolves "auto" under -> its label."""
    real = ops.resolve_cfg

    def recording(cfg, family, shape, **kw):
        got = real(cfg, family, shape, **kw)
        if cfg == "auto" and kw.get("backend") == "cuda":
            params = {k: v for k, v in kw.items()
                      if k not in ("dtype", "backend")}
            out[KernelSpec.make(family, shape, dtype=kw["dtype"],
                                **params).key] = got.label
        return got

    ops.resolve_cfg = recording
    try:
        yield
    finally:
        ops.resolve_cfg = real


def warm_exhaustive(cfg, **geom) -> tuple:
    """`warm_from_flag(cfg, "exhaustive", ...)` with every candidate's
    time printed beside its spec's bound -> (winners, launch counts)."""
    log = []
    zero_counts()
    t0 = time.perf_counter()
    with logged_measurer(log):
        won = warm_from_flag(cfg, "exhaustive", metrics=Registry(), **geom)
    counts = read_counts()
    specs = model_specs(cfg, **geom)
    for fam, spec in specs.items():
        cands = [(lab, ms) for sp, lab, ms, _ in log if sp.key == spec.key]
        print(f"tune {fam} {spec.shape} {spec.dtype}: "
              + ", ".join(f"{lab} {ms:.4f}" for lab, ms in cands)
              + f" ms -> {won.get(fam)} | bound "
              f"{model_cost(spec, BASE) * 1e3:.4f} ms", flush=True)
    print(f"tune: {len(log)} candidates measured in "
          f"{time.perf_counter() - t0:.1f}s, each launching its kernel",
          flush=True)
    skipped = sorted(set(specs) - set(won))
    if skipped:
        raise SystemExit(f"tune: families skipped: {skipped}")
    reload = TuningCache(default_cache().path)
    if any(reload.entries[s.key]["cfg"] != won[f] for f, s in specs.items()):
        raise SystemExit("tune: the cache file reloads with other winners")
    print(f"tune: the cache file reloads with the same {len(specs)} "
          f"winners", flush=True)
    print(tune_report(), flush=True)
    return won, counts


def tune_scan_families() -> dict:
    """Exhaustive searches of the ``ssd`` and ``rglru`` families (no model
    spec selects them, in the reference either) at rows 12 and 13's shapes,
    into the current cache: every candidate's ms beside the bound and the
    winner; then ``ops.ssd`` / ``ops.rglru`` with ``"auto"`` must hit the
    cache and launch the winner.  Counts zeroed before, read after."""
    log = []
    zero_counts()
    with logged_measurer(log):
        measure = tune_warm.wall_measurer()
    cache = default_cache()
    won = {}
    for spec in (SSD_SPEC, RGLRU_SPEC):
        won[spec.key] = autotune(spec, cache=cache, measure=measure,
                                 strategy="exhaustive").label
        cands = [(lab, ms) for sp, lab, ms, _ in log if sp.key == spec.key]
        if len(cands) != len(enumerate_candidates(spec)):
            raise SystemExit(f"tune {spec.family}: {len(cands)} candidates "
                             f"measured of {len(enumerate_candidates(spec))}")
        print(f"tune {spec.family} {spec.shape}: "
              + ", ".join(f"{lab} {ms:.4f}" for lab, ms in cands)
              + f" ms -> {won[spec.key]} | bound "
              f"{model_cost(spec, BASE) * 1e3:.4f} ms", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    calls = {SSD_SPEC.key: lambda: ops.ssd(
        *tune_warm.ssd_inputs(SSD_SPEC.shape, gen, "cuda"), "auto",
        chunk=SSD_SPEC.p["chunk"]),
        RGLRU_SPEC.key: lambda: ops.rglru(
        *tune_warm.rglru_inputs(RGLRU_SPEC.shape, gen, "cuda"), "auto",
        **RGLRU_SPEC.p)}
    for key, call in calls.items():
        filed, hits = {}, cache.stats["hits"]
        fam = key.split("|")[0]
        before = read_counts()[fam]
        with filed_keys(filed):
            call()
        if filed != {key: won[key]} or cache.stats["hits"] != hits + 1 \
                or read_counts()[fam] != before + 1:
            raise SystemExit(f"tune: {fam} \"auto\" filed {filed}, "
                             f"{cache.stats['hits'] - hits} hits, "
                             f"{read_counts()[fam] - before} launches; want "
                             f"the cached {won[key]}, one hit, one launch")
    print(f"tune: ssd and rglru \"auto\" hit the cache and launched "
          f"{list(won.values())}", flush=True)
    return read_counts()


def tune_phase() -> dict:
    """The exhaustive warm of qwen3-0.6b at the paged serve geometry, into
    a fresh cache that the tuned serve run reads; then the ssd and rglru
    searches into the same cache."""
    use_cache("serve", fresh=True)
    try:
        _, counts = warm_exhaustive(get_config("qwen3-0.6b"), seq=MAX_LEN,
                                    batch=SLOTS, page_size=PAGE)
        for k, v in tune_scan_families().items():
            counts[k] += v
    finally:
        use_cache("untuned", fresh=False)
    return counts


def report_filed(tag: str, filed: dict, warmed: dict) -> None:
    """The keys a tuned run filed, their labels, and which the warm
    filled (the rest missed and took the bound's pick, base)."""
    keys = {s.key for s in warmed.values()}
    for key, lab in sorted(filed.items()):
        print(f"  {tag} filed {key} -> {lab} "
              f"({'warmed' if key in keys else 'not warmed: base'})",
              flush=True)
    print(f"  {tag}: {len(set(filed) & keys)} of {len(filed)} keys filed "
          f"were warmed; warmed and never filed: "
          f"{sorted(keys - set(filed))}", flush=True)


def tuned_serve_phase() -> dict:
    """The phase-4 trace through PagedEngine(tune="exhaustive") on the
    tune phase's cache, with phase 4's hard checks, then a decode step at
    the tuned labels, kernel path against plain path."""
    cfg, params = qwen3()
    prompts = trace(cfg.vocab)
    need = sum(pages_needed(len(p) + GEN, PAGE) for p in prompts[:SLOTS])
    num_pages = int(0.6 * need) + 1
    cache = TuningCache(str(use_cache("serve", fresh=False)))
    default = default_cache()
    hits, misses = default.stats["hits"], default.stats["misses"]
    filed = {}
    try:
        zero_counts()
        with filed_keys(filed):
            done, npre, steps, _ = serve(cfg, params, prompts, num_pages,
                                         "cuda", tune="exhaustive")
        counts = read_counts()
        print(f"  kernel launches on the tuned served path: "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        report_filed("serve", filed, model_specs(
            cfg, seq=MAX_LEN, batch=SLOTS, page_size=PAGE))
        print(f"  serve tuned: cache {default.stats['hits'] - hits} hits / "
              f"{default.stats['misses'] - misses} misses in the run "
              f"({len(cache)} winners warmed)", flush=True)
        want = cfg.n_layers * steps
        if npre < 1:
            raise SystemExit("tuned serve: the pool forced no preemption")
        if counts["paged_decode_attention"] != want \
                or counts["coarsened_matmul"] < 1:
            raise SystemExit(f"tuned serve: {counts} launches, not "
                             f"{cfg.n_layers} paged decode launches per "
                             f"decode step ({want}) and an FFN matmul")
        base = SERVED["base tokens"]
        agree = [next((i for i, (a, b) in enumerate(zip(r.output, o))
                       if a != b), GEN) for r, o in zip(done, base)]
        print(f"greedy tokens, tuned vs base labels (reported): "
              f"{sum(a == GEN for a in agree)}/{N_REQ} requests identical; "
              f"first divergence per request {agree}", flush=True)
        decode_step_parity(cfg, params, prompts)
    finally:
        use_cache("untuned", fresh=False)
    return counts


def tuned_train_phase() -> dict:
    """train(tune="exhaustive") for qwen3-0.6b, 2 steps of 4 x 1024, from a
    fresh cache: step-0 loss and grad norm within phase 5's limits of its
    plain path."""
    cfg = get_config("qwen3-0.6b")
    use_cache("train", fresh=True)
    filed = {}
    try:
        # the warm train() runs first, here with every candidate printed;
        # train's own warm then hits, and the counts cover the steps only
        warm_exhaustive(cfg, seq=TRAIN["seq"], batch=TRAIN["batch"])
        zero_counts()
        with filed_keys(filed):
            losses, norms, secs = train_run(cfg, "cuda", steps=2,
                                            ckpt_dir=None, tune="exhaustive")
        counts = read_counts()
        report_filed("train", filed, model_specs(
            cfg, seq=TRAIN["seq"], batch=TRAIN["batch"]))
        print(tune_report(), flush=True)
    finally:
        use_cache("untuned", fresh=False)
    want = SERVED["train plain"]
    got = {"step-0 loss": losses[0], "step-0 grad norm": norms[0]}
    gap = rel_gaps(got, {n: want[n] for n in got})
    flash = {k: counts[k] for k in ("flash_forward", "flash_bwd_prep",
                                    "flash_bwd_dq", "flash_bwd_dkv")}
    print(f"train [cuda, tune exhaustive]: losses {losses}, grad norms "
          f"{norms}, step seconds {[round(x, 4) for x in secs]}; kernel "
          f"launches {flash}; tuned - plain, relative: "
          + ", ".join(f"{n} {gap[n]:.3e} (limit {TRAIN_LIMITS[n]:.3e})"
                      for n in gap), flush=True)
    if any(n != 2 * cfg.n_layers for n in flash.values()):
        raise SystemExit(f"tuned train: flash launches {flash}, not "
                         f"{cfg.n_layers} each a step")
    if not all(gap[n] <= TRAIN_LIMITS[n] for n in gap):
        raise SystemExit("tuned training and plain training disagree")
    return counts


# -- phase 5: train -----------------------------------------------------------

TRAIN = dict(batch=4, seq=1024, lr=3e-4, remat="none", seed=SEED,
             device="cuda", log_every=1)
TRAIN_STEPS = 4
# Kernel path against plain path, relative limits.  The paths differ only
# in where attention rounds to bf16: per-token losses differ by about 2^-9
# of themselves with random signs, so their mean over 4096 tokens by about
# 2^-15.  Each limit lies above that, above the H100's reading, and below
# what every planted fault moves the reading by (readings in PERF.md).
TRAIN_LIMITS = {"step-0 loss": 2.0 ** -13, "step-0 grad norm": 2.0 ** -10,
                "step-1 loss": 2.0 ** -12}
# Planted faults of the kernel path, each of which must move every reading
# it can reach past its limit: the backward faults leave the step-0 loss
# as it is.
TRAIN_FAULTS = {"dQ zeroed": ("step-0 grad norm", "step-1 loss"),
                "dK/dV zeroed": ("step-0 grad norm", "step-1 loss"),
                "V of kv block 3 read as zeros": tuple(TRAIN_LIMITS)}


@contextlib.contextmanager
def planted(fault: str):
    """Swap one kernel wrapper for a faulty one while the block runs."""
    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)

    def lost_v(fwd):
        def faulty(q, k, v, *a, bkv, **kw):
            v = v.clone()
            v[:, :, 3 * bkv:4 * bkv] = 0
            return fwd(q, k, v, *a, bkv=bkv, **kw)
        return faulty

    mod, name, faulty = {
        "dQ zeroed": (fa_mod, "flash_bwd_dq", lambda q, *a, **kw: zeros(q)),
        "dK/dV zeroed": (fa_mod, "flash_bwd_dkv",
                         lambda q, k, *a, **kw: (zeros(k), zeros(k))),
        "V of kv block 3 read as zeros": (fa_mod, "flash_forward",
                                          lost_v(fa_mod.flash_forward)),
        "sparse: V of kv block 3 read as zeros": (
            sp_mod, "flash_sparse_fwd", lost_v(sp_mod.flash_sparse_fwd)),
    }[fault]
    saved = getattr(mod, name)
    setattr(mod, name, faulty)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def readings(losses, norms) -> dict:
    return {"step-0 loss": losses[0], "step-0 grad norm": norms[0],
            "step-1 loss": losses[1]}


def rel_gaps(got: dict, want: dict) -> dict:
    return {n: abs(got[n] - want[n]) / abs(want[n]) for n in want}


def train_run(cfg, backend: str, **kw):
    """-> (losses, grad norms, step seconds) of one `train` call."""
    norms, secs = [], []

    def on_step(step, loss, gn, dt):
        norms.append(gn)
        secs.append(dt)

    losses, params = train(cfg, backend=backend, on_step=on_step,
                           **{**TRAIN, **kw})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    bad = [x for x in losses + norms if not math.isfinite(x)]
    if bad:
        raise SystemExit(f"train [{backend}]: non-finite loss or grad norm")
    return losses, norms, secs


def train_phase() -> dict:
    cfg = get_config("qwen3-0.6b")
    print(f"train: qwen3-0.6b full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), float32 master "
          f"weights, {cfg.compute_dtype} compute, batch {TRAIN['batch']} x "
          f"{TRAIN['seq']} tokens, AdamW lr {TRAIN['lr']}, remat "
          f"{TRAIN['remat']}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, norms, secs = train_run(cfg, "cuda", steps=TRAIN_STEPS,
                                    ckpt_dir=None)
    all_counts = read_counts()
    counts = {k: all_counts[k] for k in ("flash_forward", "flash_bwd_prep",
                                         "flash_bwd_dq", "flash_bwd_dkv")}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train [cuda]: losses {losses}, grad norms {norms}, step "
          f"seconds {[round(x, 4) for x in secs]}, peak memory {peak:.2f} "
          f"GiB; kernel launches {counts}", flush=True)
    want = TRAIN_STEPS * cfg.n_layers
    if any(n != want for n in counts.values()):
        raise SystemExit(f"flash kernels launched {counts}, expected {want} "
                         f"each ({TRAIN_STEPS} steps x {cfg.n_layers} layers)")

    plain, p_norms, p_secs = train_run(cfg, "ref", steps=TRAIN_STEPS,
                                       ckpt_dir=None)
    want = readings(plain, p_norms)
    SERVED["train plain"] = want
    gap = rel_gaps(readings(losses, norms), want)
    print(f"train [ref]: losses {plain}, grad norms {p_norms}, step seconds "
          f"{[round(x, 4) for x in p_secs]}; kernel - plain, relative: "
          + ", ".join(f"{n} {gap[n]:.3e} (limit {TRAIN_LIMITS[n]:.3e})"
                      for n in gap), flush=True)
    moved = {}
    for fault in TRAIN_FAULTS:
        with planted(fault):
            f_losses, f_norms, _ = train_run(cfg, "cuda", steps=2,
                                             ckpt_dir=None)
        moved[fault] = rel_gaps(readings(f_losses, f_norms), want)
        print(f"train planted fault, {fault}: relative move "
              + ", ".join(f"{n} {moved[fault][n]:.3e}" for n in want),
              flush=True)
    if not all(gap[n] <= TRAIN_LIMITS[n] for n in gap):
        raise SystemExit("kernel path and plain path training disagree")
    for fault, reach in TRAIN_FAULTS.items():
        if not all(moved[fault][n] > TRAIN_LIMITS[n] for n in reach):
            raise SystemExit(f"the train limits would not catch: {fault}")

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        first, _, _ = train_run(cfg, "cuda", steps=2, ckpt_dir=str(ckpt),
                                save_every=1000)
        rest, _, _ = train_run(cfg, "cuda", steps=TRAIN_STEPS,
                               ckpt_dir=str(ckpt), save_every=1000)
        print(f"train resume: 2 steps {first} + resumed {rest} against "
              f"uninterrupted {losses} ({time.perf_counter() - t0:.1f}s "
              f"with checkpoints)", flush=True)
        if first + rest != losses:
            raise SystemExit("resumed training does not repeat the "
                             "uninterrupted losses exactly")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return all_counts


# gemma3-1b (hf:google/gemma-3-1b-pt): one sequence of 4096 tokens, so the
# window-512 index prunes (at most 5 live of 32 kv blocks a q block); the
# same 4096 tokens a step as the qwen3 phase
GEMMA_TRAIN = dict(batch=1, seq=4096)
# Both kernel paths are held against the plain path within TRAIN_LIMITS,
# reasoned as for qwen3 (attention rounds to bf16 at other places; per-token
# loss differences average over 4096 tokens), below what every planted
# fault moves the readings by.
# Planted faults of the sparse run (a), each with the readings it must move
# past their limits: the two backward faults and a lost V block in the
# dense forward (the 4 global layers) and in the sparse forward (the 22
# local layers, where block 3 lies in the window of rows 384-1023 only).
# A fault confined to one part of the step (dQ alone, or the 4 global
# layers' forward) is held to the gradient norm only: one step of AdamW on
# the parameters it touches need not move the next loss by 2^-12.  (A
# skipped live slot, the kernel phase's fault model, leaves residuals the
# dense backward cannot use: its gradient norm is not finite.)
GEMMA_FAULTS = {"dQ zeroed": ("step-0 grad norm",),
                "dK/dV zeroed": ("step-0 grad norm", "step-1 loss"),
                "V of kv block 3 read as zeros": ("step-0 grad norm",),
                "sparse: V of kv block 3 read as zeros": (
                    "step-0 grad norm", "step-1 loss")}


def gemma_train_phase() -> dict:
    """Full-width gemma3-1b training, 4 steps each: (a) the kernels, sparse
    on the local layers; (b) the kernels, dense-mask on every layer; (c)
    the plain path.  (a) and (b) are held against (c), and each one's
    launches are checked exactly -> the launches of (a) and (b)."""
    t0 = time.perf_counter()
    cfg = get_config("gemma3-1b")
    kinds = cfg.layer_kinds()
    n_local, n_layers = kinds.count("L"), cfg.n_layers
    print(f"train: gemma3-1b full width ({n_layers} layers, {n_local} local "
          f"with window {cfg.window}, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, tied embeddings {cfg.tie_embeddings}), float32 "
          f"master weights, {cfg.compute_dtype} compute, batch "
          f"{GEMMA_TRAIN['batch']} x {GEMMA_TRAIN['seq']} tokens", flush=True)
    runs, totals = {}, dict.fromkeys(COUNTERS, 0)
    want_counts = {
        "auto": {"flash_sparse_fwd": n_local * TRAIN_STEPS,
                 "flash_forward": (n_layers - n_local) * TRAIN_STEPS,
                 "flash_bwd_prep": n_layers * TRAIN_STEPS,
                 "flash_bwd_dq": n_layers * TRAIN_STEPS,
                 "flash_bwd_dkv": n_layers * TRAIN_STEPS},
        "off": {"flash_sparse_fwd": 0,
                "flash_forward": n_layers * TRAIN_STEPS,
                "flash_bwd_prep": n_layers * TRAIN_STEPS,
                "flash_bwd_dq": n_layers * TRAIN_STEPS,
                "flash_bwd_dkv": n_layers * TRAIN_STEPS}}
    for sparse in ("auto", "off"):
        routes = (L.flash_plain_routes, L.sparse_plain_routes)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        runs[sparse] = train_run(dataclasses.replace(cfg, attn_sparse=sparse),
                                 "cuda", steps=TRAIN_STEPS, ckpt_dir=None,
                                 **GEMMA_TRAIN)
        counts = read_counts()
        got = {n: counts[n] for n in want_counts[sparse]}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses, norms, secs = runs[sparse]
        print(f"train gemma3 [cuda, sparse {sparse}]: losses {losses}, grad "
              f"norms {norms}, step seconds {[round(x, 4) for x in secs]}, "
              f"peak memory {peak:.2f} GiB; kernel launches {got}",
              flush=True)
        if got != want_counts[sparse]:
            raise SystemExit(f"gemma3 kernels launched {got}, expected "
                             f"{want_counts[sparse]}")
        if (L.flash_plain_routes, L.sparse_plain_routes) != routes:
            raise SystemExit("a gemma3 layer took a plain route")
        for n, c in counts.items():
            totals[n] += c
    plain = train_run(cfg, "ref", steps=TRAIN_STEPS, ckpt_dir=None,
                      **GEMMA_TRAIN)
    want = readings(*plain[:2])
    print(f"train gemma3 [ref]: losses {plain[0]}, grad norms {plain[1]}, "
          f"step seconds {[round(x, 4) for x in plain[2]]}", flush=True)
    print("train gemma3 step seconds, sparse | dense-mask | plain: "
          + "; ".join(f"{a:.4f} | {b:.4f} | {c:.4f}" for a, b, c in zip(
              runs["auto"][2], runs["off"][2], plain[2])), flush=True)
    gaps = {}
    for sparse, (losses, norms, _) in runs.items():
        gaps[sparse] = rel_gaps(readings(losses, norms), want)
        print(f"train gemma3 sparse {sparse} - plain, relative: "
              + ", ".join(f"{n} {x:.3e} (limit {TRAIN_LIMITS[n]:.3e})"
                          for n, x in gaps[sparse].items()), flush=True)
    moved = {}
    for fault in GEMMA_FAULTS:
        with planted(fault):
            f_losses, f_norms, _ = train_run(cfg, "cuda", steps=2,
                                             ckpt_dir=None, **GEMMA_TRAIN)
        moved[fault] = rel_gaps(readings(f_losses, f_norms), want)
        print(f"train gemma3 planted fault, {fault}: relative move "
              + ", ".join(f"{n} {moved[fault][n]:.3e}" for n in want),
              flush=True)
    if not all(x <= TRAIN_LIMITS[n] for g in gaps.values()
               for n, x in g.items()):
        raise SystemExit("gemma3 kernel paths and plain path disagree")
    for fault, reach in GEMMA_FAULTS.items():
        if not all(moved[fault][n] > TRAIN_LIMITS[n] for n in reach):
            raise SystemExit(f"the gemma3 limits would not catch: {fault}")
    print(f"train gemma3: {time.perf_counter() - t0:.1f}s", flush=True)
    return totals


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# the phases after the build, in order: name -> (function, phases it reads)
PHASES = {"kernels": (None, ()),
          "invariance": (invariance_phase, ()),
          "tune": (tune_phase, ()),
          "serve": (serve_phase, ()),
          "contig": (contig_serve_phase, ()),
          "spec": (spec_serve_phase, ()),
          "tuned-serve": (tuned_serve_phase, ("tune", "serve")),
          "train": (train_phase, ()),
          "tuned-train": (tuned_train_phase, ("train",)),
          "gemma3-train": (gemma_train_phase, ()),
          "serve-moe": (moe_serve_phase, ()),
          "paper": (paper_sweeps_phase, ())}
# the qwen3-0.6b serve phases, bound by the host's Python, not the card
SERVE = ("serve", "contig", "spec", "tuned-serve")
# serve phases that share nothing with the others: where the run holds more
# phases, each runs in a process of its own beside the other serve phases
# (the card idles in all of them; timed phases never overlap them)
SIDE = ("contig", "spec")
LAUNCHES = "kernel launches over the main-path runs: "


def chosen_phases(argv) -> list:
    ap = argparse.ArgumentParser(
        description="Chip smoke test of the PyTorch/CUDA port on one "
                    "NVIDIA GPU.  With no arguments it runs every phase.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run (with the phases "
                         "they read), of: " + ", ".join(PHASES))
    want = set(ap.parse_args(argv).phases.split(","))
    if want - set(PHASES):
        ap.error(f"unknown phases {sorted(want - set(PHASES))}")
    for name in list(want):
        want.update(PHASES[name][1])
    return [name for name in PHASES if name in want]


def start_side(phase: str) -> tuple:
    """`chip_smoke.py --phases <phase>` in a process of its own, its
    output to a log under TUNE_DIR."""
    TUNE_DIR.mkdir(parents=True, exist_ok=True)
    log = open(TUNE_DIR / f"{phase}.log", "w+")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--phases", phase], cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT)
    print(f"phase {phase}: started in process {proc.pid}", flush=True)
    return proc, log, time.perf_counter()


def join_side(phase: str, proc, log, t0) -> dict:
    """Wait for a side process, print its output (each line tagged) and
    return its launch counts; its failure fails the run."""
    rc = proc.wait()
    log.seek(0)
    lines = log.read().splitlines()
    log.close()
    for line in lines:
        print(f"  [{phase}] {line}")
    print(f"phase {phase}: exit {rc} in its own process, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    counts = [line[len(LAUNCHES):] for line in lines
              if line.startswith(LAUNCHES)]
    if rc or len(counts) != 1:
        raise SystemExit(f"phase {phase} failed in its own process (exit "
                         f"{rc})")
    return json.loads(counts[0])


def main(argv=None) -> None:
    t_start = time.perf_counter()
    phases = chosen_phases(argv)
    name = device_phase()
    # every cfg="auto" of the run resolves through caches under build/
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    use_cache("untuned", fresh=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    kernels = []
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        t_kernels = time.perf_counter()
        kernels = [decode_phase(gen), matmul_phase(gen), rmsnorm_phase(gen),
                   *flash_phase(gen)]
        d256 = flash256_phase(gen)
        flash_geometry_phase(gen)
        flash_bwd_geometry_phase(gen)
        rows_spills()
        dense_ms = d256[SPARSE["window"]]["flash_forward"][0]
        kernels += [sparse_phase(gen, dense_ms), decode_int8_phase(gen),
                    moe_phase(gen), quant_moe_phase(gen),
                    quant_matmul_phase(gen), contig_phase(gen, quant=False),
                    contig_phase(gen, quant=True),
                    verify_phase(gen, quant=False),
                    verify_phase(gen, quant=True)]
        kernels += paper_kernels_phase()
        kernels += [embed_gather_phase(gen), ssd_phase(gen),
                    rglru_phase(gen), windowed_gather_phase()]
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase kernels: {time.perf_counter() - t_kernels:.1f}s",
              flush=True)
    # launches: the sum over the main-path runs, each counted from zero
    totals = dict.fromkeys(COUNTERS, 0)
    sides = [p for p in SIDE if p in phases] if len(phases) > 1 else []
    running = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    try:
        for tag in phases[1:] if phases[0] == "kernels" else phases:
            if tag in SERVE and sides and not running:
                running = {p: start_side(p) for p in sides}
            if tag in sides:
                continue
            if tag not in SERVE and running:
                for p in sides:
                    add(join_side(p, *running.pop(p)))
            if tag not in SERVE and WEIGHTS:
                WEIGHTS.clear()
                gc.collect()
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            add(PHASES[tag][0]())
            print(f"phase {tag}: {time.perf_counter() - t0:.1f}s; elapsed "
                  f"{time.perf_counter() - t_start:.1f}s", flush=True)
        for p in list(running):
            add(join_side(p, *running.pop(p)))
    finally:
        for proc, log, _ in running.values():
            proc.kill()
            proc.wait()
            log.close()
    print(LAUNCHES + json.dumps(totals), flush=True)
    for k in kernels:
        k["launches"] = totals[k["name"]]
    if len(phases) == len(PHASES) \
            and any(k["launches"] < 1 for k in kernels):
        raise SystemExit(f"a kernel never launched on its path: {totals}")
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(smi_line())
    if kernels:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
