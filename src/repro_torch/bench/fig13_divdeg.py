"""Paper Fig. 13 on the card: work-item divergence degree {0, 2, 4} x
direct / indirect under every label (port of `benchmarks/fig13_divdeg.py`).
Direct rows run `ew_stream` with the variants base / div2 / div4 at AI 6;
indirect rows run `gather_stream` at degree 0 and print NA at 2 and 4 (no
kernel takes a variant over a gather).  N = 2^26 on the card, 2^15 on the
CPU.

  python -m repro_torch.bench.fig13_divdeg [--device cpu]
"""
from __future__ import annotations

from repro_torch.bench import common as C
from repro_torch.bench.fig11_ai import (N_CARD, N_CPU, N_LOADS, TABLE,
                                        WINDOW, direct, gather_inputs,
                                        indirect, streams)

DIV = {0: "base", 2: "div2", 4: "div4"}
AI = 6


def main(argv=None) -> list:
    dev = C.parse_device(argv, __doc__)
    n = N_CARD if dev.type == "cuda" else N_CPU
    sweep = C.Sweep(dev, f"fig13 (N={n}, AI {AI})")
    inputs = streams(n, N_LOADS, dev)
    idx, tables = gather_inputs(n, TABLE, WINDOW, dev)
    for deg, variant in DIV.items():
        direct(sweep, f"fig13,div{deg},direct", inputs, AI, variant)
        if deg == 0:
            indirect(sweep, f"fig13,div{deg},indirect", idx, tables, AI)
        else:
            for lab in C.labels():
                sweep.emit(f"fig13,div{deg},indirect,{lab}", None,
                           status="NA(no kernel takes a divergence variant "
                                  "over a gather)")
    return sweep.rows


if __name__ == "__main__":
    main()
