"""Shared helpers of the figure sweeps: device timing, H100 bounds, rows.

Every sweep runs on ``cuda`` unless ``--device cpu`` is given.  On the card
a row is ``name,ms,bound_ms,speedup``: the median device time of one call
(`time_ms`: CUDA events, L2 flushed before each call), the least time the
H100 could take for the call's work (`bound_ms`) and the measured speedup
over the ``base`` label.  On the CPU the sweeps run the plain versions at
the reference's small sizes, and a row is ``name,host_ms,-,speedup``: host
wall time, which says nothing about a device.  A label the kernel does not
take prints ``NA`` in place of the numbers.

The reference's ``derived`` column, a TPU v5e cost model, has no
counterpart here: every number is measured.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.coarsening import CoarseningConfig
from repro_torch.kernels import ref

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                   # fp32 on the CUDA cores, data sheet
BF16_FLOPS = 989e12                  # dense bf16 tensor-core peak
L2_FLUSH_BYTES = 64 << 20            # more than the 50 MB L2
SLEEP_CYCLES = 10_000_000            # ~5 ms of device sleep per timed rep
DEGREES = (2, 4, 8)
SWEEP_REPS = 10                      # timed calls a row, on the card


def labels() -> list[str]:
    """The labels of `benchmarks/fig8_apps.py` `_variants`, in its order:
    base, then con/gap/pipe/simd at degrees 2, 4 and 8, then the two
    combined mechanisms."""
    out = ["base"]
    for d in DEGREES:
        out += [f"con{d}", f"gap{d}", f"pipe{d}", f"simd{d}"]
    return out + ["con4+pipe2", "con2+simd2"]


_FLUSH: torch.Tensor | None = None


def time_ms(fn: Callable, reps: int = 25, warmup: int = 3) -> float:
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


def wall_ms(fn: Callable, reps: int = 3) -> float:
    """Median host wall time of one call (the CPU sweeps)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def bound_ms(io_bytes: float, ops: float, peak: float = FP32_FLOPS):
    """(least ms on the H100, "bytes" or "operations"): the larger of the
    bytes over 3.35 TB/s and the operations over ``peak``."""
    t_b, t_o = io_bytes / HBM_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def stream_ops(inputs, ai: int, variant: str) -> int:
    """Chain operations this run's data needs under ``variant`` (a path
    not taken, a masked trip or an unselected divergent path costs none)."""
    n, nl = inputs[0].shape[0], len(inputs)
    n_arith = ai * (nl + 1)
    even = (n + 1) // 2
    if variant in ("base", "div2", "div4"):
        return n * n_arith
    if variant == "if_id":
        return even * n_arith
    if variant == "if_in":
        return int((ref._bucket(inputs[-1], 16.0, 2) == 0).sum()) * n_arith
    if variant == "for_const_if_id":
        return even * 5 * max(1, n_arith // 5)
    if variant == "for_in_if_in":
        trips = ref._bucket(inputs[-1], 8.0, 8) \
            * (ref._bucket(inputs[-2], 16.0, 2) == 0)
        return int(trips.sum()) * max(1, n_arith // 8)
    raise ValueError(f"unknown variant {variant!r}")


def gather_bytes(idx: torch.Tensor, n_tables: int) -> int:
    """idx read and out written once, each touched table entry read once."""
    return 8 * idx.shape[0] + 4 * n_tables * int(torch.unique(idx).numel())


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def parse_device(argv=None, description: str = "") -> torch.device:
    """``--device`` (default cuda); a sweep asked for the card that finds
    none fails instead of timing the CPU."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu for the "
                         "plain versions at the reference's small sizes")
    return dev


class Sweep:
    """Times one app under every label and prints its rows."""

    def __init__(self, device: torch.device, fig: str):
        self.device = device
        self.on_card = device.type == "cuda"
        self.rows: list[dict] = []
        if self.on_card:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            print(f"# {fig} on {torch.cuda.get_device_name(device)} "
                  f"({smi_line()}): name,ms,bound_ms,speedup_vs_base",
                  flush=True)
        else:
            print(f"# {fig} on the CPU, plain versions at the reference's "
                  f"sizes: name,host_ms,-,speedup_vs_base (host wall time, "
                  f"no device metric)", flush=True)

    def time(self, fn: Callable) -> float:
        if self.on_card:
            return time_ms(fn, reps=SWEEP_REPS)
        return wall_ms(fn)

    def emit(self, name: str, ms: float | None, bound: float | None = None,
             speedup: float | None = None, status: str = "") -> dict:
        row = {"name": name, "ms": ms, "bound_ms": bound,
               "speedup": speedup, "status": status}
        self.rows.append(row)
        if ms is None:
            print(f"{name},NA,NA,NA" + (f",{status}" if status else ""),
                  flush=True)
        else:
            b = f"{bound:.4f}" if self.on_card and bound is not None else "-"
            print(f"{name},{ms:.4f},{b},{speedup:.3f}", flush=True)
        return row

    def app(self, prefix: str, run: Callable[[CoarseningConfig], object],
            plain: Callable[[], torch.Tensor], bound: float | None,
            exact: bool = True, tol: float = 0.0) -> None:
        """One row per label: ``run(cfg)`` timed, its output held against
        the base label's, and the base label's against ``plain()``, the
        plain version on the same inputs (bit for bit where ``exact``, else
        within ``tol`` of the largest |base|); a label whose plan does not
        tile is NA."""
        base_out, base_ms = None, None
        for lab in labels():
            cfg = CoarseningConfig.parse(lab)
            try:
                out = run(cfg)
            except ValueError as e:
                self.emit(f"{prefix},{lab}", None,
                          status="NA(" + str(e).replace(",", ";") + ")")
                continue
            if base_out is None:
                base_out = out
                _hold(f"{prefix},{lab}", out, plain(), "plain version's",
                      exact, tol)
            else:
                _hold(f"{prefix},{lab}", out, base_out, "base label's",
                      exact, tol)
            ms = self.time(lambda: run(cfg))
            base_ms = base_ms or ms
            self.emit(f"{prefix},{lab}", ms, bound, base_ms / ms)


def _hold(name: str, out: torch.Tensor, want: torch.Tensor, what: str,
          exact: bool, tol: float) -> None:
    """Fail unless ``out`` equals ``want`` bit for bit (``exact``) or lies
    within ``tol`` of the largest |want|."""
    if exact:
        if not torch.equal(out, want):
            raise SystemExit(f"{name}: output differs from the {what} bit "
                             f"for bit")
        return
    err = (out - want).abs().max().item()
    lim = tol * want.abs().max().item()
    if not err <= lim:
        raise SystemExit(f"{name}: |out - {what}| {err:.3e} over {lim:.3e}")
