"""Paged serving front end of the port (mirrors `repro/launch/serve.py`
`_serve_paged`, :274): submit a seeded request trace to the `Scheduler`,
which admits, preempts and retires it against the `PagedEngine`.

The port serves the paged cache only.  Decode attention, the prefill FFN
and the MoE experts take the hand-written CUDA kernels (``--backend cuda``,
the default); ``--backend ref`` selects the plain PyTorch paths.
``--quant int8|int4`` quantizes the FFN / expert / attention weights at
engine construction (dequant-fused kernels where the geometry tiles) and
``--kv-quant int8`` stores the K/V pools as int8 with per-row scales.
Weights are random, from seed 0.  Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --slots 8 --requests 16 --prompt-len 256 --gen-tokens 64 \\
      --max-len 1024 --page-size 16 --chunk 16 --decode-block 8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --quant int8 --kv-quant int8 --slots 8 --requests 8 --prompt-len 128 \\
      --gen-tokens 32 --max-len 512 --chunk 16 --decode-block 8

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --slots 3 --requests 5 --prompt-len 8 --gen-tokens 10 --max-len 32 \\
      --page-size 8 --num-pages 8 --chunk 8 --decode-block 4

``--reduced`` is opt-in here: the reference's flag (`store_true`,
``default=True``) can never be switched off.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.obs import Registry, TraceRecorder
from repro_torch.serve import PagedEngine, Scheduler, State


def serve_paged(args, cfg, params, rng, device) -> list:
    """Run the request trace; prints the summary lines and returns the
    terminal requests in submission order."""
    reg = Registry()
    trace = TraceRecorder(enabled=bool(args.trace_out))
    num_pages = args.num_pages if args.num_pages is not None else \
        args.slots * -(-args.max_len // args.page_size) + 1
    engine = PagedEngine(cfg, params, slots=args.slots, num_pages=num_pages,
                         page_size=args.page_size, max_len=args.max_len,
                         chunk=args.chunk, decode_block=args.decode_block,
                         decode_backend=args.backend,
                         ffn_backend=args.backend, moe_backend=args.backend,
                         quant=args.quant, kv_quant=args.kv_quant,
                         metrics=reg, trace=trace, device=device)
    sched = Scheduler(engine, max_waiting=args.max_waiting, metrics=reg,
                      trace=trace)
    for _ in range(args.requests):
        sched.submit(list(map(int, rng.integers(1, cfg.vocab,
                                                args.prompt_len))),
                     args.gen_tokens, deadline=args.deadline,
                     max_queue_wait=args.max_queue_wait)
    t0 = time.perf_counter()
    try:
        if args.metrics_every:
            while sched.step():
                if sched.steps > 100_000:
                    raise RuntimeError("scheduler did not converge")
                if sched.steps % args.metrics_every == 0:
                    print(f"[q={sched.time}] {reg.line(prefix='sched')}")
            done = sorted(sched.finished, key=lambda r: r.rid)
        else:
            done = sched.run_until_done()
    except KeyboardInterrupt:
        done = sched.drain(reason="interrupted")
        print(f"\ninterrupted — drained {len(done)} requests")
    dt = time.perf_counter() - t0
    # shutdown leak check: every page is either free or live-refcounted
    engine.pool.check()
    if engine.pool.num_free + engine.pool.num_live != engine.pool.capacity:
        raise RuntimeError("page leak at shutdown")
    npre = sum(r.preemptions for r in done)
    total = args.requests * (args.prompt_len + args.gen_tokens)
    print(f"served {len(done)} requests / {total} tokens (paged: "
          f"{engine.pool.capacity} pages x {engine.page_size} tok) in "
          f"{engine.prefill_steps} prefill + {engine.decode_steps} decode "
          f"model steps, {npre} preemptions, {dt:.2f}s")
    by_state = {s.value: n for s in State
                if (n := sum(r.state is s for r in done))}
    print(f"states {by_state} | decode faults {sched.decode_faults}, NaN "
          f"rescues {engine.nan_rescues}")
    pdev, ddev = engine.prefill_device_s, engine.decode_device_s
    print(f"prefill: {engine.prefill_tokens} tok in {pdev:.3f}s "
          f"({engine.prefill_tokens / max(pdev, 1e-9):.1f} tok/s) | decode: "
          f"{engine.decoded_tokens} tok in {ddev:.3f}s "
          f"({engine.decoded_tokens / max(ddev, 1e-9):.1f} tok/s) on "
          f"{_device_name(engine.device)}")
    ovh = max(dt - pdev - ddev, 0.0)
    print(f"overhead: scheduler+host {ovh:.2f}s of {dt:.2f}s wall "
          f"({ovh / max(dt, 1e-9):.0%})")
    print(f"memory: weights {engine.weight_mib:.2f} MiB (dense "
          f"{engine.weight_mib_dense:.2f}) | paged kv pool "
          f"{engine.cache_mib:.2f} MiB (bf16 {engine.cache_mib_dense:.2f}; "
          f"{engine.pool.tokens_capacity} pooled tokens)")
    if engine.quant_report is not None:
        print(f"quant {engine.cfg.quant}: {engine.quant_report}")
    if done:
        print("sample output:", done[0].output[:8])
    if args.trace_out:
        trace.dump(args.trace_out)
        print(f"trace: {len(trace)} events -> {args.trace_out}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            if args.metrics_out.endswith(".prom"):
                f.write(reg.to_prometheus())
            else:
                json.dump(reg.snapshot(), f, indent=1, sort_keys=True)
        print(f"metrics: {len(reg)} series -> {args.metrics_out}")
    return done


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny same-family config (default: the "
                         "published widths)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk: prompt tokens per batched step")
    ap.add_argument("--decode-block", type=int, default=8,
                    help="decode steps run between host syncs")
    ap.add_argument("--backend", default="cuda", choices=["ref", "cuda"],
                    help="cuda = the paged split-KV decode kernel, the "
                         "coarsened FFN matmul and the grouped-expert MoE "
                         "kernels; ref = the plain paths")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4"],
                    help="weight-only quantization of FFN / MoE / attention "
                         "projections (dequant-fused kernels where the "
                         "geometry allows, dense-dequant elsewhere)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="int8 KV pools: quantize on append, dequant fused "
                         "into the split-KV decode kernel")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page (= the decode kernel's kv block)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool pages incl. the null page (default: "
                         "slots*max_len/page_size + 1)")
    ap.add_argument("--deadline", type=int, default=None,
                    help="cancel a request unfinished after this many "
                         "scheduler quanta")
    ap.add_argument("--max-queue-wait", type=int, default=None,
                    help="reject a request that waits more quanta than this")
    ap.add_argument("--max-waiting", type=int, default=None,
                    help="wait-queue bound; submits past it are REJECTED")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry (JSON, or Prometheus "
                         "text when the path ends in .prom)")
    ap.add_argument("--metrics-every", type=int, default=None, metavar="N",
                    help="print a compact metrics line every N quanta")
    return ap


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.lm_init(cfg, gen, device=device)
    rng = np.random.default_rng(0)
    return serve_paged(args, cfg, params, rng, device)


if __name__ == "__main__":
    main()
