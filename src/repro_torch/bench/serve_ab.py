"""Paged serving of full-width qwen3-0.6b through this checkout and another,
on the card, in turns: the other, this, this, the other (after one
unreported run of the other, a warm-up), each in a process of its own
that builds its own tree's kernels.

  python -m repro_torch.bench.serve_ab --other DIR

``DIR`` is a checkout (say an unpacked ``git archive`` of the parent commit
under ``build/``).  The workload is `chip_smoke.py`'s serve phase: random
bf16 weights from seed 0, 16 requests of 128-511 prompt tokens and 64
generated tokens through `Scheduler` over `PagedEngine` (8 slots, chunk
16, page 16, max_len 1024, decode block 8, a pool of 60% of the first 8
requests' pages), kernel backends.  A row is ``<tree> decode_tok_s,
prefill_tok_s, step_host_us, step_ms``: the engine's decode and prefill
tok/s (tokens over its device-boundary seconds), then one
`lm_decode_step` of 8 slots (prompts prefilled) timed 20 times, the card
drained between steps: the median host microseconds its enqueue takes,
and the median milliseconds a step takes with the device's work
included.  Each process resolves ``"auto"`` through a fresh tuning cache
of its own, as an untuned run does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SLOTS, CHUNK, PAGE, MAX_LEN, BLOCK = 8, 16, 16, 1024, 8
N_REQ, GEN, STEPS = 16, 64, 20


def child(root: Path) -> None:
    """Serve the trace on ``root``'s tree and print one JSON line."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import PagedEngine, Request, Scheduler
    from repro_torch.serve.paging import pages_needed

    cfg = get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.lm_init(cfg, gen, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, n)))
               for n in rng.integers(128, 512, N_REQ)]
    need = sum(pages_needed(len(p) + GEN, PAGE) for p in prompts[:SLOTS])
    kw = dict(slots=SLOTS, page_size=PAGE, max_len=MAX_LEN, chunk=CHUNK,
              decode_block=BLOCK, decode_backend="cuda", ffn_backend="cuda",
              device="cuda")
    eng = PagedEngine(cfg, params, num_pages=int(0.6 * need) + 1, **kw)
    sched = Scheduler(eng)
    for p in prompts:
        sched.submit(p, GEN)
    sched.run_until_done()
    out = {"decode_tok_s": eng.decoded_tokens / eng.decode_device_s,
           "prefill_tok_s": eng.prefill_tokens / eng.prefill_device_s}
    eng = PagedEngine(cfg, params,
                      num_pages=SLOTS * pages_needed(MAX_LEN, PAGE) + 1, **kw)
    for s, p in enumerate(prompts[:SLOTS]):
        eng.admit(s, Request(rid=s, prompt=p, gen=GEN))
        grow = pages_needed(len(p) + STEPS + 4, PAGE) - eng.bt.num_pages(s)
        eng.bt.append(s, eng.pool.alloc(grow))
    tok = torch.as_tensor(eng.last[:, None], device="cuda")
    pos = torch.as_tensor(eng.written, device="cuda")
    bt = torch.as_tensor(eng.bt.device(), device="cuda")
    with torch.no_grad():
        for i in range(3):
            M.lm_decode_step(params, eng.cache, tok, pos + i, cfg=eng.cfg,
                             block_table=bt)
        torch.cuda.synchronize()
        host, wall = [], []
        for i in range(STEPS):
            t0 = time.perf_counter()
            M.lm_decode_step(params, eng.cache, tok, pos + 3 + i,
                             cfg=eng.cfg, block_table=bt)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
    out["step_host_us"] = float(np.median(host)) * 1e6
    out["step_ms"] = float(np.median(wall)) * 1e3
    print(json.dumps(out), flush=True)


def run(root: Path) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ,
                   REPRO_TORCH_TUNE_CACHE=str(Path(tmp) / "tune.json"))
        cmd = [sys.executable, __file__, "--child", str(root)]
        res = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if res.returncode:
        raise SystemExit(f"{' '.join(cmd)} failed:\n{res.stdout}"
                         f"\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child(args.child.resolve())
    if args.other is None:
        ap.error("--other DIR is required")
    here = Path(__file__).resolve().parents[3]
    other = args.other.resolve()
    print("# serve_ab: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() + ": decode_tok_s,prefill_tok_s,"
        "step_host_us,step_ms", flush=True)
    run(other)                       # a warm-up, not reported
    for tag, root in (("other", other), ("this", here), ("this", here),
                      ("other", other)):
        r = run(root)
        print(f"{tag} {r['decode_tok_s']:.2f},{r['prefill_tok_s']:.1f},"
              f"{r['step_host_us']:.1f},{r['step_ms']:.3f}", flush=True)


if __name__ == "__main__":
    main()
