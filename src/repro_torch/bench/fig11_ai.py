"""Paper Fig. 11 on the card: arithmetic intensity {1, 4, 6, 10} x direct
(`ew_stream`, 8 streams) / indirect (`gather_stream`, 8 tables of 2^14 at
locality 4096, the fig8 gather's) under every label
(port of `benchmarks/fig11_ai.py`).  N = 2^26 on the card (the paper's
64M elements), 2^15 on the CPU.

  python -m repro_torch.bench.fig11_ai [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.bench import common as C
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gather_stream import make_indices

N_CARD = 1 << 26                     # paper: 64M-element arrays
N_CPU = 1 << 15                      # the reference's measured size
AIS = (1, 4, 6, 10)
N_LOADS = 8
TABLE, WINDOW = 1 << 14, 4096
BLOCK = 1024


def streams(n: int, k: int, device, seed: int = 0) -> tuple:
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(n, generator=gen, device=device)
                 for _ in range(k))


def gather_inputs(n: int, table: int, window: int, device, seed: int = 1):
    idx = torch.as_tensor(make_indices(n, table, window, seed=seed),
                          device=device)
    return idx, streams(table, N_LOADS, device, seed=seed + 3)


def direct(sweep: C.Sweep, prefix: str, inputs, ai: int,
           variant: str = "base") -> None:
    n = inputs[0].shape[0]
    bound, _ = C.bound_ms(4 * n * (len(inputs) + 1),
                          C.stream_ops(inputs, ai, variant))
    sweep.app(prefix, lambda cfg: ops.ew_stream(
        inputs, cfg, ai=ai, variant=variant, block=BLOCK),
        lambda: ref.ew_stream(inputs, ai=ai, variant=variant), bound)


def indirect(sweep: C.Sweep, prefix: str, idx, tables, ai: int) -> None:
    bound, _ = C.bound_ms(C.gather_bytes(idx, len(tables)),
                          idx.shape[0] * ai * (len(tables) + 1))
    sweep.app(prefix, lambda cfg: ops.gather_stream(
        idx, tables, cfg, ai=ai, block=BLOCK),
        lambda: ref.gather_stream(tables, idx, ai=ai), bound)


def main(argv=None) -> list:
    dev = C.parse_device(argv, __doc__)
    n = N_CARD if dev.type == "cuda" else N_CPU
    sweep = C.Sweep(dev, f"fig11 (N={n})")
    inputs = streams(n, N_LOADS, dev)
    idx, tables = gather_inputs(n, TABLE, WINDOW, dev)
    for ai in AIS:
        direct(sweep, f"fig11,AI{ai},direct", inputs, ai)
        indirect(sweep, f"fig11,AI{ai},indirect", idx, tables, ai)
    return sweep.rows


if __name__ == "__main__":
    main()
