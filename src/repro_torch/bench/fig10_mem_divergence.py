"""Paper Fig. 10 on the card: memory access (direct / indirect) x
control-flow divergence under every label (port of
`benchmarks/fig10_mem_divergence.py`).  Direct rows run `ew_stream` under
each divergence variant at AI 6; indirect rows run `gather_stream` (the
fig8 gather's tables and locality) for ``base`` and print NA for a
divergent variant: no kernel takes a variant over a gather (the reference
prints -1 there).  N = 2^26 on the card, 2^15 on the CPU.

  python -m repro_torch.bench.fig10_mem_divergence [--device cpu]
"""
from __future__ import annotations

from repro_torch.bench import common as C
from repro_torch.bench.fig11_ai import (N_CARD, N_CPU, N_LOADS, TABLE,
                                        WINDOW, direct, gather_inputs,
                                        indirect, streams)

VARIANTS = ("base", "if_id", "if_in", "for_const_if_id", "for_in_if_in")
AI = 6


def main(argv=None) -> list:
    dev = C.parse_device(argv, __doc__)
    n = N_CARD if dev.type == "cuda" else N_CPU
    sweep = C.Sweep(dev, f"fig10 (N={n}, AI {AI})")
    inputs = streams(n, N_LOADS, dev)
    idx, tables = gather_inputs(n, TABLE, WINDOW, dev)
    for variant in VARIANTS:
        direct(sweep, f"fig10,direct,{variant}", inputs, AI, variant)
        if variant == "base":
            indirect(sweep, f"fig10,indirect,{variant}", idx, tables, AI)
        else:
            for lab in C.labels():
                sweep.emit(f"fig10,indirect,{variant},{lab}", None,
                           status="NA(no kernel takes a divergence variant "
                                  "over a gather)")
    return sweep.rows


if __name__ == "__main__":
    main()
