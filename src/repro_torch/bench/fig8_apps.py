"""Paper Fig. 8/9 on the card: the application suite under every label
(port of `benchmarks/fig8_apps.py`).

  matmul   — dense linear algebra: the coarsened bf16 matmul kernel at
             2048^3 (512^3 on the CPU); a label it does not tile is NA
  stencil  — structured grid (Hotspot): 8192 x 8192 f32 (256 x 512)
  dp_scan  — dynamic programming (Pathfinder): 1024 x 2^20 f32 (128 x
             1024); base and con2/4/8 — gapped breaks the carry and the
             kernel reads no replication or vector width, so those are NA
  gather   — graph traversal (irregular access): 2^26 indices (2^16) into
             8 tables of 2^14 at locality 4096, as the reference;
             gather-random: 8 tables of 2^24 (64 MiB each, beyond the 50 MB
             L2; 2^14 on the CPU) read fully at random (locality = table)

  python -m repro_torch.bench.fig8_apps [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.bench import common as C
from repro_torch.bench.fig11_ai import gather_inputs, indirect
from repro_torch.kernels import ops, ref

SIZES = {  # card, cpu
    "matmul": (2048, 512),
    "stencil": ((8192, 8192), (256, 512)),
    "dp_scan": ((1024, 1 << 20), (128, 1024)),
    "gather": (1 << 26, 1 << 16),
    "gather_random_table": (1 << 24, 1 << 14),
}
TABLE, WINDOW, AI = 1 << 14, 4096, 6


def bench_matmul(sweep: C.Sweep, card: bool) -> None:
    m = SIZES["matmul"][0 if card else 1]
    gen = torch.Generator(device=sweep.device).manual_seed(0)
    a = torch.randn(m, m, generator=gen, device=sweep.device).bfloat16()
    b = (torch.randn(m, m, generator=gen, device=sweep.device)
         / m ** 0.5).bfloat16()
    bound, _ = C.bound_ms(8 * m * m, 2 * m ** 3, C.BF16_FLOPS)
    # f32 sums of exact bf16 products in another order: K * 2^-24
    sweep.app("fig8,matmul", lambda cfg: ops.matmul(a, b, cfg),
              lambda: ref.matmul(a, b), bound, exact=False,
              tol=m * 2.0 ** -24)


def bench_stencil(sweep: C.Sweep, card: bool) -> None:
    rows, cols = SIZES["stencil"][0 if card else 1]
    gen = torch.Generator(device=sweep.device).manual_seed(2)
    x = torch.randn(rows, cols, generator=gen, device=sweep.device)
    bound, _ = C.bound_ms(8 * rows * cols, 9 * rows * cols)
    sweep.app("fig8,stencil", lambda cfg: ops.stencil5(x, cfg, block_rows=8),
              lambda: ref.stencil5(x), bound)


def bench_dp_scan(sweep: C.Sweep, card: bool) -> None:
    rows, cols = SIZES["dp_scan"][0 if card else 1]
    gen = torch.Generator(device=sweep.device).manual_seed(3)
    cost = torch.rand(rows, cols, generator=gen, device=sweep.device)
    bound, _ = C.bound_ms(8 * rows * cols, 3 * rows * cols)

    def run(cfg):
        if cfg.replication > 1 or cfg.vector_width > 1:
            raise ValueError("the DP kernel reads no replication or vector "
                             "width")
        return ops.dp_scan(cost, cfg)
    sweep.app("fig8,dp_scan", run, lambda: ref.dp_scan(cost), bound)


def bench_gather(sweep: C.Sweep, card: bool) -> None:
    n = SIZES["gather"][0 if card else 1]
    idx, tables = gather_inputs(n, TABLE, WINDOW, sweep.device)
    indirect(sweep, "fig8,gather", idx, tables, AI)
    del idx, tables
    table = SIZES["gather_random_table"][0 if card else 1]
    idx, tables = gather_inputs(n, table, table, sweep.device, seed=5)
    indirect(sweep, "fig8,gather-random", idx, tables, AI)


def main(argv=None) -> list:
    dev = C.parse_device(argv, __doc__)
    card = dev.type == "cuda"
    sweep = C.Sweep(dev, "fig8")
    for bench in (bench_matmul, bench_stencil, bench_dp_scan, bench_gather):
        bench(sweep, card)
        if card:
            torch.cuda.empty_cache()
    return sweep.rows


if __name__ == "__main__":
    main()
