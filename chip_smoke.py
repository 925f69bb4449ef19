"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device — the card's name and power limit; TF32 off for every float32
   product; no CUDA device means exit 1.
2. build  — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and print the build time.
3. kernels — each kernel against its plain PyTorch version on the card at
   the serving path's full-width shapes, for every coarsening label listed,
   with the stated tolerance; then its time (CUDA events, L2 flushed before
   each launch, median), its plain version's time, one PyTorch library
   call's time and the least time the card could take (``bound_ms``).
4. serve  — full-width qwen3-0.6b (28 layers, random bf16 weights from a
   seeded torch.Generator) through `Scheduler` over `PagedEngine`: 16
   requests, an undersized pool that forces preemption.  The launch counts
   are zeroed just before this run and read just after it.  Then the same
   trace through the plain paths, and one full-width `lm_decode_step` on a
   shared cache, kernel path against plain path.
5. result — the kernels' JSON line, then the device JSON line, last.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coarsening import CoarseningConfig  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import matmul as mm_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import (PagedEngine, Request, Scheduler,  # noqa: E402
                               State)
from repro_torch.serve.paging import pages_needed  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                  # dense bf16 tensor-core peak
L2_FLUSH_BYTES = 64 << 20            # more than the 50 MB L2
SLEEP_CYCLES = 10_000_000            # ~5 ms of device sleep per timed rep

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


def mm_tol(k: int, ref_max: float) -> float:
    """f32 sums of exact bf16 products taken in another order: at most
    k * 2^-24 of the largest magnitude."""
    return k * 2.0 ** -24 * ref_max


# -- phase 1 ------------------------------------------------------------------

def device_phase() -> str:
    if not torch.cuda.is_available():
        print("no CUDA device: the chip smoke test needs one", flush=True)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(smi)
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return name


# -- timing -------------------------------------------------------------------

_FLUSH: torch.Tensor | None = None


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, with L2 flushed before each.  A
    device-side sleep queued ahead of each rep keeps the card busy while the
    host enqueues the flush and the call, so host launch gaps inside ``fn``
    (several launches) are not counted as device time."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        _FLUSH.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


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


def decode_phase(gen: torch.Generator) -> dict:
    q, kp, vp, bt, pos = decode_inputs(gen)
    worst = 0.0
    for label in DEC_LABELS:
        for window in (None, 100):
            got = ops.paged_decode_attention(q, kp, vp, bt, pos, label,
                                             window=window)
            torch.cuda.synchronize()
            cfg = CoarseningConfig.parse(label)
            want = ref.paged_split_kv(q, kp, vp, bt, pos, degree=cfg.degree,
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

    b, h, hkv, d, ps = (DEC[k] for k in ("b", "h", "hkv", "d", "ps"))
    live = pos.long() + 1
    kv_bytes = int(2 * live.sum().item() * hkv * d * 2)
    pages = int(((live + ps - 1) // ps).sum().item())
    io_bytes = kv_bytes + 2 * b * h * d * 2 + pages * 4 + b * 4
    flops = int(4 * live.sum().item() * h * d)
    bound_ms = max(io_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    ms = time_ms(lambda: ops.paged_decode_attention(q, kp, vp, bt, pos))
    plain_ms = time_ms(lambda: ref.paged_split_kv(q, kp, vp, bt, pos))
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

def matmul_phase(gen: torch.Generator) -> dict:
    def operands(m, k, n):
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        b = torch.randn(k, n, generator=gen, device="cuda").bfloat16() \
            / math.sqrt(k)
        return a, b.bfloat16()

    worst = 0.0
    for (m, k, n), label in MM_CASES:
        a, b = operands(m, k, n)
        got = ops.matmul(a, b, label)
        torch.cuda.synchronize()
        want = ref.matmul(a, b)
        err = (got - want).abs().max().item()
        tol = mm_tol(k, want.abs().max().item())
        print(f"matmul ({m}x{k})@({k}x{n}) {label:5s}: max|kernel-plain| "
              f"{err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise SystemExit(f"matmul kernel {label} disagrees with its "
                             f"plain version")
        worst = max(worst, err)

    # timing: one FFN's three products in one prefill chunk (gate, up, down)
    ops_ = [operands(m, k, n) for m, k, n in MM_MAIN]
    flops = sum(2 * m * n * k for m, k, n in MM_MAIN)
    io_bytes = sum(2 * m * k + 2 * k * n + 4 * m * n for m, k, n in MM_MAIN)
    bound_ms = max(io_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    ms = time_ms(lambda: [ops.matmul(a, b) for a, b in ops_])
    plain_ms = time_ms(lambda: [ref.matmul(a, b) for a, b in ops_])
    lib_ms = time_ms(lambda: [torch.matmul(a, b) for a, b in ops_])
    print(f"matmul timing (ffn gate+up+down at T=128, base): kernel "
          f"{ms:.4f} ms | bound {bound_ms:.4f} ms | plain (f32) "
          f"{plain_ms:.4f} ms | torch.matmul bf16 {lib_ms:.4f} ms",
          flush=True)
    return {"name": "coarsened_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul.py:69",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if io_bytes / HBM_BYTES_PER_S
            >= flops / BF16_FLOPS else "operations",
            "library_ms": lib_ms}


# -- phase 4: serve -----------------------------------------------------------

SLOTS, CHUNK, PAGE, MAX_LEN, BLOCK = 8, 16, 16, 1024, 8
N_REQ, GEN = 16, 64


def trace(vocab: int):
    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 512, N_REQ)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lens]


def serve(cfg, params, prompts, num_pages, backend: str):
    eng = PagedEngine(cfg, params, slots=SLOTS, num_pages=num_pages,
                      page_size=PAGE, max_len=MAX_LEN, chunk=CHUNK,
                      decode_block=BLOCK, decode_backend=backend,
                      ffn_backend=backend, device="cuda")
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
    print(f"serve [{backend}]: {len(done)} requests, {npre} preemptions, "
          f"{eng.prefill_steps} prefill chunks, {eng.decode_steps} decode "
          f"steps, {wall:.2f}s wall | prefill {eng.prefill_tokens} tok "
          f"{eng.prefill_tokens / eng.prefill_device_s:.1f} tok/s | decode "
          f"{eng.decoded_tokens} tok "
          f"{eng.decoded_tokens / eng.decode_device_s:.1f} tok/s",
          flush=True)
    return done, npre


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
    # the paths differ only in decode attention's rounding (kernel: f32
    # probabilities; plain: bf16 probabilities before PV), which the bf16
    # residual stream carries through 28 layers: allow 5% of the largest
    # logit
    tol = 0.05 * scale
    same = (logits["cuda"].argmax(-1) == logits["ref"].argmax(-1)).float()
    print(f"lm_decode_step parity (full width, 8 slots): max|kernel-plain| "
          f"{diff:.4e} of max|logit| {scale:.4e} (tol {tol:.4e}); greedy "
          f"argmax agrees on {int(same.sum())}/{SLOTS} slots", flush=True)
    if not (math.isfinite(diff) and diff <= tol):
        raise SystemExit("kernel path and plain path logits disagree")


def serve_phase(name: str) -> dict:
    cfg = get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.lm_init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"qwen3-0.6b full width: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}: {n_par / 1e6:.1f}M params, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f}"
          f" GiB, init {time.perf_counter() - t0:.1f}s", flush=True)
    prompts = trace(cfg.vocab)
    # pool: 60% of the pages the first SLOTS requests hold at completion,
    # so the running set outgrows it and the scheduler must preempt
    need = sum(pages_needed(len(p) + GEN, PAGE) for p in prompts[:SLOTS])
    num_pages = int(0.6 * need) + 1
    print(f"pool: {num_pages} pages of {PAGE} (first {SLOTS} requests need "
          f"{need} at completion)", flush=True)

    dec_mod.launches = mm_mod.launches = 0
    done, npre = serve(cfg, params, prompts, num_pages, "cuda")
    counts = {"paged_decode_attention": dec_mod.launches,
              "coarsened_matmul": mm_mod.launches}
    print(f"kernel launches on the served path: {counts}", flush=True)
    if npre < 1:
        raise SystemExit("the undersized pool forced no preemption")
    if min(counts.values()) < 1:
        raise SystemExit(f"a kernel of the path never launched: {counts}")

    plain, _ = serve(cfg, params, prompts, num_pages, "ref")
    agree = [next((i for i, (a, b) in enumerate(zip(r.output, p.output))
                   if a != b), GEN) for r, p in zip(done, plain)]
    print(f"greedy tokens, kernel path vs plain path: "
          f"{sum(a == GEN for a in agree)}/{N_REQ} requests identical; "
          f"first divergence per request {agree}", flush=True)
    decode_step_parity(cfg, params, prompts)
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> None:
    t_start = time.perf_counter()
    name = device_phase()
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kernels = [decode_phase(gen), matmul_phase(gen)]
    counts = serve_phase(name)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
