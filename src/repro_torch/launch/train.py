"""Training front end of the port (mirrors `repro/launch/train.py`: `train`
:40, `_train_in_mesh` :87 and `main` :161, on one device and without a
mesh): data pipeline -> train step -> checkpoints, with the step watchdog,
preemption handling and retry, in the reference's order.

Attention takes the hand-written flash kernels (forward, dQ, dK/dV) with
``--backend cuda``, the default, and the block-sparse flash forward on a
windowed (local) layer unless ``--attn-sparse off``; ``--backend ref``
takes the plain chunked attention.  The FFN always takes the plain float32
product (``ffn_backend="ref"``, as the reference trainer's default): the
matmul kernel has no backward.  Master weights and the AdamW state are float32,
compute is the config's dtype (bf16).  Runs on the card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 4 --batch 4 --seq 1024

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 4 --batch 1 --seq 4096

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 3 --batch 2 --seq 64

``--tune`` warms the coarsening cache (`repro_torch.tune`) at the run's
geometry before the first step, the flash forward and dK/dV families
included, and prints `tune_report` at the end; ``greedy`` and
``exhaustive`` time the labels on the card, while ``auto`` and ``model``
rank by the H100 bound, which is the same for every label, and so pick
base (the reference ranks by a TPU cost model).

Not ported: ``--quant`` and remat ``"dots"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.tree import leaves
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.steps import StepConfig, build_train_step
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import BACKENDS
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import (PreemptionHandler, SimulatedFailure,
                                 StepWatchdog, retry_step)
from repro_torch.tune import TUNE_CHOICES, tune_report


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str | None, n_micro: int = 1, remat: str = "none",
          lr: float = 3e-4, save_every: int = 50, seed: int = 0,
          log_every: int = 10, fail_at_step: int | None = None,
          device=None, backend: str = "cuda", tune: str | None = None,
          preemption: Optional[PreemptionHandler] = None,
          on_step: Optional[Callable[[int, float, float, float], None]] = None):
    """Train for ``steps`` steps (resuming from ``ckpt_dir``'s latest
    checkpoint when there is one) -> (losses of the steps run, params).

    ``backend`` sets the attention dispatch; ``tune`` warms the tuning
    cache at this geometry first (`repro/launch/train.py:46-53`);
    ``fail_at_step`` injects one
    `SimulatedFailure` that the retry absorbs; ``preemption`` (default: a
    new handler for SIGTERM / SIGUSR1) stops the loop at the next step
    boundary with a checkpoint, and is uninstalled on the way out;
    ``on_step(step, loss, grad_norm, seconds)`` sees every finished step
    (seconds: wall time of the step, the device synchronised)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, attn_backend=backend, ffn_backend="ref")
    if tune:
        from repro_torch.tune import warm_from_flag
        warm_from_flag(cfg, tune, seq=seq, batch=batch)
    step_fn = build_train_step(cfg, StepConfig(
        seq=seq, batch=batch, n_micro=n_micro, remat=remat,
        opt=AdamWConfig(lr=lr)))
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=seed + 7),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.lm_init(cfg, gen, device=dev, dtype=torch.float32)
    opt_state = adamw_init(params)

    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3,
                                save_interval_steps=save_every)
        if mgr.latest_step() is not None:
            restored, manifest = mgr.restore({"params": params,
                                              "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start_step = manifest["extra"]["step"]
            data.load_state_dict(manifest["extra"]["data"])
            print(f"resumed from step {start_step}")
    for p in leaves(params):
        p.requires_grad_(True)

    wd = StepWatchdog(threshold=4.0, hang_timeout=3600)
    pre = (preemption or PreemptionHandler()).install()
    losses = []
    step = start_step
    try:
        for step in range(start_step, steps):
            if pre.preempted:
                print(f"preempted at step {step}; checkpointing")
                break
            hb = data.next_batch()
            failed = []

            def run():
                if fail_at_step == step and not failed:
                    failed.append(step)
                    raise SimulatedFailure(f"injected failure at step {step}")
                return step_fn(params, opt_state, hb)

            t0 = time.perf_counter()
            with wd.step(step):
                params, opt_state, loss, gn = retry_step(
                    run, retries=2,
                    on_retry=lambda a, e: print(f"  retry {a}: {e}"))
                loss, gn = float(loss), float(gn)
                synchronize(dev)
            dt = time.perf_counter() - t0
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {loss:.4f} gnorm {gn:.3f} "
                      f"({dt:.3f}s)", flush=True)
            losses.append(loss)
            if on_step is not None:
                on_step(step, loss, gn, dt)
            if mgr and mgr.should_save(step):
                mgr.save(step, {"params": params, "opt": opt_state},
                         extra={"step": step + 1,
                                "data": data.state_dict()})
        else:
            step = steps
        if mgr:
            # ``step`` is the first step not run: after a preemption the
            # step the loop stopped before, else ``steps``
            mgr.save(step, {"params": params, "opt": opt_state},
                     extra={"step": step, "data": data.state_dict()},
                     blocking=True)
    finally:
        pre.uninstall()
    return losses, params


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="train the tiny same-family config (default: the "
                         "published widths)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=M.REMATS)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="cuda = the flash attention kernels (forward, dQ, "
                         "dK/dV); ref = the plain chunked attention")
    ap.add_argument("--tune", default=None, choices=TUNE_CHOICES,
                    help="warm the coarsening tuning cache before training: "
                         "greedy / exhaustive time the labels on the card; "
                         "auto / model rank by the H100 bound, the same for "
                         "every label, so they pick base")
    ap.add_argument("--attn-sparse", default=None, choices=["auto", "off"],
                    help="block-sparse dispatch for local-attention layers "
                         "(window set): 'auto' routes eligible geometries "
                         "through the live-index kernel, 'off' pins the "
                         "dense-mask kernel")
    ap.add_argument("--attn-global-stride", type=int, default=None,
                    help="LongFormer-style global columns on local layers: "
                         "every Nth kv position stays visible past the "
                         "window (needs a windowed arch; training through "
                         "a strided pattern differentiates the plain "
                         "dense-mask attention)")
    return ap


def main(argv=None) -> list:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn_sparse:
        cfg = dataclasses.replace(cfg, attn_sparse=args.attn_sparse)
    if args.attn_global_stride:
        cfg = dataclasses.replace(cfg,
                                  attn_global_stride=args.attn_global_stride)
    losses, _ = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt_dir, n_micro=args.n_micro,
                      remat=args.remat, lr=args.lr,
                      save_every=args.save_every, seed=args.seed,
                      device=args.device, backend=args.backend,
                      tune=args.tune)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    if args.tune:
        print(tune_report())
    return losses


if __name__ == "__main__":
    main()
