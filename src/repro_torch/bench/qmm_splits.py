"""The dequant-fused matmul's K split on the card: each product of the
shared-expert FFN of qwen2-moe-a2.7b (gate = up, down) and of qwen3-0.6b's
FFN at a prefill chunk of 128 rows, int8 and int4, timed at every split
count S the product takes, beside the one `split_plan` picks.

  python -m repro_torch.bench.qmm_splits [--device cpu]

A row is ``int<bits> MxKxN S=<s>[*],ms`` (``*``: the plan's S), the
median device time of one call with L2 flushed (`common.time_ms`).  With
``--device cpu`` it prints the plans only, with ``-`` for the time.
"""
from __future__ import annotations

import math

import torch

from repro_torch.bench.common import parse_device, smi_line, time_ms
from repro_torch.core.coarsening import BASE
from repro_torch.kernels import matmul as mm
from repro_torch.quant import quantize

# (m, k, n): shared-expert gate (= up) and down, qwen3-0.6b up and down
PRODUCTS = ((128, 2048, 5632), (128, 5632, 2048), (128, 1024, 3072),
            (128, 3072, 1024))
SPLITS = (1, 2, 3, 4, 6, 8, 9, 12, 16)
SMS_CPU = 132                        # the H100 SXM's, for the CPU listing


def main(argv=None) -> None:
    dev = parse_device(argv, __doc__.splitlines()[0])
    on_card = dev.type == "cuda"
    sms = mm.sm_count(dev) if on_card else SMS_CPU
    print(f"# qmm_splits on {smi_line() if on_card else 'the CPU'}, "
          f"{sms} SMs: name,ms", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for bits in (8, 4):
        for m, k, n in PRODUCTS:
            qw = quantize(torch.randn(k, n, generator=gen, device=dev)
                          / math.sqrt(k), f"int{bits}")
            a = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            best = mm.split_plan(m, n, k, BASE, bits, qw.group, sms)
            for s in SPLITS:
                if s > k // best.unit:
                    break
                plan = mm.SplitPlan(s, best.unit, (s,) + best.grid[1:])
                mark = "*" if s == best.splits else ""
                print(f"int{bits} {m}x{k}x{n} S={s}{mark},"
                      f"{_ms(on_card, a, qw, plan)}", flush=True)
            if best.splits not in SPLITS:
                print(f"int{bits} {m}x{k}x{n} S={best.splits}*,"
                      f"{_ms(on_card, a, qw, best)}", flush=True)


def _ms(on_card: bool, a, qw, plan) -> str:
    if not on_card:
        return "-"
    return f"{time_ms(lambda: mm.quant_matmul(a, qw, BASE, plan)):.4f}"


if __name__ == "__main__":
    main()
