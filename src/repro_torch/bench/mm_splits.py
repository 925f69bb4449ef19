"""The coarsened matmul's K split on the card: each product of qwen3-0.6b's
FFN at a prefill chunk of 128 rows (gate = up, down), bf16, timed at every
split count S it takes under ``base`` and ``con2``, beside the one
`mm_split_plan` picks.

  python -m repro_torch.bench.mm_splits [--device cpu]

A row is ``<label> MxKxN S=<s>[*],ms`` (``*``: the plan's S), the median
device time of one call with L2 flushed (`common.time_ms`).  With
``--device cpu`` it prints the plans only, with ``-`` for the time.
"""
from __future__ import annotations

import math

import torch

from repro_torch.bench.common import parse_device, smi_line, time_ms
from repro_torch.kernels import matmul as mm

# (m, k, n): qwen3-0.6b (hf:Qwen/Qwen3-0.6B, d 1024, d_ff 3072) up, down
PRODUCTS = ((128, 1024, 3072), (128, 3072, 1024))
LABELS = ("base", "con2")
SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16)
SMS_CPU = 132                        # the H100 SXM's, for the CPU listing


def main(argv=None) -> None:
    dev = parse_device(argv, __doc__.splitlines()[0])
    on_card = dev.type == "cuda"
    sms = mm.sm_count(dev) if on_card else SMS_CPU
    print(f"# mm_splits on {smi_line() if on_card else 'the CPU'}, "
          f"{sms} SMs: name,ms", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label in LABELS:
        for m, k, n in PRODUCTS:
            a = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            b = (torch.randn(k, n, generator=gen, device=dev)
                 / math.sqrt(k)).bfloat16()
            best = mm.mm_split_plan(m, n, k, label, sms)
            steps = -(-k // best.unit)
            for s in sorted({*SPLITS, best.splits}):
                if s > steps:
                    break
                plan = mm.SplitPlan(s, best.unit, (s,) + best.grid[1:])
                mark = "*" if s == best.splits else ""
                print(f"{label} {m}x{k}x{n} S={s}{mark},"
                      f"{_ms(on_card, a, b, label, plan)}", flush=True)


def _ms(on_card: bool, a, b, label, plan) -> str:
    if not on_card:
        return "-"
    return f"{time_ms(lambda: mm.coarsened_matmul(a, b, label, plan)):.4f}"


if __name__ == "__main__":
    main()
