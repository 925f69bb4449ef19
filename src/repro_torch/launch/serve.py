"""Serving front end of the port (mirrors `repro/launch/serve.py`).

``--cache paged`` (the default here) submits a seeded request trace to the
`Scheduler`, which admits, preempts and retires it against the
`PagedEngine` (`_serve_paged`, :274); ``--spec-k K`` swaps in the
`SpecPagedEngine`: a draft model (``--draft-config``: ``draft_of``, the
default shrink of the target; ``self``; or an arch name) proposes K tokens
a slot a step and the target scores all K+1 in one verify pass.
``--cache contiguous`` runs `BatchedServer` (:100): fixed slots with one
(max_len, Hkv, hd) cache each, chunked prefill into the admitted slot and
decode blocks of up to ``--decode-block`` steps between host syncs.

Decode attention (paged, contiguous and verify), the prefill FFN and the
MoE experts take the hand-written CUDA kernels (``--backend cuda``, the
default); ``--backend ref`` selects the plain PyTorch paths.
``--quant int8|int4`` quantizes the FFN / expert / attention weights at
construction (dequant-fused kernels where the geometry tiles) and
``--kv-quant int8`` stores K/V as int8 with per-row scales.  Weights are
random, from seed 0.  Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --slots 8 --requests 16 --prompt-len 256 --gen-tokens 64 \\
      --max-len 1024 --page-size 16 --chunk 16 --decode-block 8

  PYTHONPATH=src python -m repro_torch.launch.serve --cache contiguous \\
      --slots 8 --requests 16 --prompt-len 256 --gen-tokens 64 \\
      --max-len 1024 --chunk 16 --decode-block 8 [--kv-quant int8]

  PYTHONPATH=src python -m repro_torch.launch.serve --spec-k 4 \\
      --draft-config self --slots 8 --requests 8 --prompt-len 128 \\
      --gen-tokens 32 --max-len 512

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --quant int8 --kv-quant int8 --slots 8 --requests 8 --prompt-len 128 \\
      --gen-tokens 32 --max-len 512 --chunk 16 --decode-block 8

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --slots 3 --requests 5 --prompt-len 8 --gen-tokens 10 --max-len 32 \\
      --page-size 8 --num-pages 8 --chunk 8 --decode-block 4

Deviations from the reference's flags: ``--reduced`` is opt-in here (the
reference's flag, `store_true` with ``default=True``, can never be
switched off), and ``--cache`` defaults to ``paged``, not ``contiguous``:
the port's paged path came first and its callers rely on the default.
`BatchedServer` samples greedily (the reference's ``temperature`` is never
set by its launcher).  ``--tune`` warms the coarsening cache
(`repro_torch.tune`) before serving and prints `tune_report` at the end;
``greedy`` and ``exhaustive`` time the labels on the card, while ``auto``
and ``model`` rank by the H100 bound, which is the same for every label,
and so pick base (the reference ranks by a TPU cost model).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Registry, TraceRecorder
from repro_torch.quant.qtypes import quantize_params, tree_nbytes
from repro_torch.serve import (PagedEngine, Scheduler, SpecPagedEngine,
                               State, draft_of)
from repro_torch.tune import TUNE_CHOICES, tune_report


def _slot_reset(cache, slot: int) -> None:
    """Zero one slot's rows of every cache leaf in place (int8 payloads
    and their scales included)."""
    for layer in cache["layers"]:
        for leaf in layer.values():
            leaf[slot].zero_()


class BatchedServer:
    """Fixed-slot continuous batching on the contiguous cache
    (`repro/launch/serve.py:100-271`).

    `try_admit` resets a free slot and prefills the prompt in chunks of
    ``chunk`` tokens, each one batched `lm_prefill` over all slots with
    only the admitted slot's rows written (``mask``); `step` runs up to
    ``decode_block`` greedy `lm_decode_step` calls over every slot, feeding
    each step's argmax to the next on the device, and syncs once.  Slots
    that have finished ride along at the position they stopped at; their
    writes past the cache are dropped (`blocks.attn_block_decode`).
    ``params`` must live on ``device`` (``cuda`` unless ``"cpu"``); with
    ``quant`` they are quantized here.  ``nan_steps`` counts prefill chunks
    and decode blocks whose logits for a running slot held a NaN."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int,
                 max_len: int, chunk: int = 16, decode_block: int = 1,
                 decode_backend: str | None = None,
                 ffn_backend: str | None = None,
                 moe_backend: str | None = None, quant: str | None = None,
                 kv_quant: str | None = None, tune: str | None = None,
                 device=None):
        for field, value in (("decode_backend", decode_backend),
                             ("ffn_backend", ffn_backend),
                             ("moe_backend", moe_backend), ("quant", quant),
                             ("kv_quant", kv_quant)):
            if value is not None:
                cfg = dataclasses.replace(cfg, **{field: value})
        self.device = resolve_device(device)
        self.weight_mib_dense = tree_nbytes(params) / 2**20
        self.quant_report = None
        if cfg.quant in ("int8", "int4"):
            params, self.quant_report = quantize_params(
                params, cfg.quant, group=cfg.quant_group)
        if tune:
            # the families this server's loops file, at the allocated
            # cache length (`repro/launch/serve.py:121-126`)
            from repro_torch.tune import warm_from_flag
            warm_from_flag(cfg, tune, seq=max_len, batch=slots)
        self.cfg, self.params = cfg, params
        self.slots, self.max_len = int(slots), int(max_len)
        self.chunk, self.decode_block = int(chunk), int(decode_block)
        self.weight_mib = tree_nbytes(params) / 2**20
        self.cache = M.lm_init_cache(cfg, self.slots, self.max_len,
                                     device=self.device)
        self.cache_mib = tree_nbytes(self.cache) / 2**20
        # what the same cache would take in bf16 (2 bytes per K/V value)
        self.cache_mib_dense = (2 * cfg.n_layers * self.slots * self.max_len
                                * cfg.n_kv_heads * cfg.hd * 2 / 2**20)
        self.pos = np.zeros((slots,), np.int32)
        self.active = np.zeros((slots,), bool)
        self.outputs: list[list[int]] = [[] for _ in range(slots)]
        self.completed: list[list[int]] = []   # finished sequences
        self.budget = np.zeros((slots,), np.int32)
        # prefill and decode accounted apart; the *_device_s timers cover
        # the model calls and the sync only, so tok/s is device-step time
        self.prefill_steps = self.decode_steps = 0
        self.prefill_tokens = self.decoded_tokens = 0
        self.prefill_device_s = self.decode_device_s = 0.0
        self.nan_steps = 0

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def try_admit(self, prompt: list[int], gen_tokens: int) -> bool:
        """Admit a request into the lowest free slot (False when none is
        free); its first greedy token comes from the prefill logits."""
        # the cache holds max_len-1 prompt rows + the decode row; an
        # oversized prompt is rejected, not silently truncated
        if len(prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the max_len "
                f"{self.max_len} cache (holds {self.max_len - 1} prompt "
                f"rows); rejecting instead of truncating")
        free = [s for s in range(self.slots) if not self.active[s]]
        if not free:
            return False
        s = free[0]
        _slot_reset(self.cache, s)
        mask = torch.zeros((self.slots,), dtype=torch.bool,
                           device=self.device)
        mask[s] = True
        td = time.perf_counter()
        for i in range(0, len(prompt), self.chunk):
            piece = prompt[i:i + self.chunk]
            tokens = np.zeros((self.slots, len(piece)), np.int32)
            tokens[s] = piece
            pos0 = self.pos.copy()
            pos0[s] = i
            logits, _ = M.lm_prefill(self.params, self._ints(tokens),
                                     self.cfg, cache=self.cache,
                                     pos0=self._ints(pos0), mask=mask)
            self.prefill_steps += 1
        first = int(torch.argmax(logits[s]))
        self.nan_steps += bool(torch.isnan(logits[s]).any())
        self.prefill_device_s += time.perf_counter() - td
        self.prefill_tokens += len(prompt)
        self.active[s] = True
        self.pos[s] = len(prompt)
        self.outputs[s] = [first]
        self.budget[s] = gen_tokens
        self._maybe_finish(s)
        return True

    def step(self) -> None:
        """One decode block of up to ``decode_block`` greedy steps for every
        slot, bounded by the shortest remaining budget and the cache."""
        if not self.active.any():
            return
        act = np.flatnonzero(self.active)
        remaining = int(min(self.budget[s] - len(self.outputs[s])
                            for s in act))
        headroom = int(self.max_len - 1 - self.pos[act].max())
        n = max(1, min(self.decode_block, remaining, headroom))
        tokens = np.zeros((self.slots, 1), np.int32)
        for s in act:
            tokens[s, 0] = self.outputs[s][-1]
        td = time.perf_counter()
        tok, pos = self._ints(tokens), self._ints(self.pos)
        rows = torch.as_tensor(act, device=self.device)
        toks, bad = [], torch.zeros((), dtype=torch.bool, device=self.device)
        for _ in range(n):
            logits, _ = M.lm_decode_step(self.params, self.cache, tok, pos,
                                         self.cfg)
            bad |= torch.isnan(logits[rows]).any()
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        toks = torch.stack(toks, dim=1).cpu().numpy()      # device sync
        self.nan_steps += bool(bad)
        self.decode_device_s += time.perf_counter() - td
        self.decode_steps += n
        for s in act:
            take = min(n, int(self.budget[s]) - len(self.outputs[s]))
            self.outputs[s].extend(int(v) for v in toks[s, :take])
            self.decoded_tokens += take
            self.pos[s] += n
            self._maybe_finish(s)

    def _maybe_finish(self, s: int) -> None:
        if len(self.outputs[s]) >= self.budget[s] \
                or self.pos[s] >= self.max_len - 1:
            self.active[s] = False
            self.completed.append(list(self.outputs[s]))

    @property
    def any_active(self) -> bool:
        return bool(self.active.any())


def serve_contiguous(args, cfg, params, rng, device) -> list:
    """Run the request trace through `BatchedServer`; prints the summary
    lines and returns the finished token sequences in completion order."""
    server = BatchedServer(cfg, params, slots=args.slots,
                           max_len=args.max_len, chunk=args.chunk,
                           decode_block=args.decode_block,
                           decode_backend=args.backend,
                           ffn_backend=args.backend, moe_backend=args.backend,
                           quant=args.quant, kv_quant=args.kv_quant,
                           tune=args.tune, device=device)
    pending = [list(map(int, rng.integers(1, cfg.vocab, args.prompt_len)))
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    try:
        while pending or server.any_active:
            while pending and server.try_admit(pending[0], args.gen_tokens):
                pending.pop(0)
            server.step()
    except KeyboardInterrupt:
        # keep the in-flight partial outputs, then report as usual
        for s in np.flatnonzero(server.active):
            server.active[s] = False
            server.completed.append(list(server.outputs[s]))
        print(f"\ninterrupted — {len(pending)} requests unserved, "
              f"{len(server.completed)} archived (partial output kept)")
    dt = time.perf_counter() - t0
    total = args.requests * (args.prompt_len + args.gen_tokens)
    print(f"served {len(server.completed)} requests / {total} tokens "
          f"(contiguous: {server.slots} slots x {server.max_len} rows) in "
          f"{server.prefill_steps} prefill + {server.decode_steps} decode "
          f"model steps, {dt:.2f}s; NaN steps {server.nan_steps}")
    pdev, ddev = server.prefill_device_s, server.decode_device_s
    print(f"prefill: {server.prefill_tokens} tok in {pdev:.3f}s "
          f"({server.prefill_tokens / max(pdev, 1e-9):.1f} tok/s) | decode: "
          f"{server.decoded_tokens} tok in {ddev:.3f}s "
          f"({server.decoded_tokens / max(ddev, 1e-9):.1f} tok/s) on "
          f"{_device_name(server.device)}")
    ovh = max(dt - pdev - ddev, 0.0)
    print(f"overhead: driver+host {ovh:.2f}s of {dt:.2f}s wall "
          f"({ovh / max(dt, 1e-9):.0%})")
    print(f"memory: weights {server.weight_mib:.2f} MiB (dense "
          f"{server.weight_mib_dense:.2f}) | kv cache "
          f"{server.cache_mib:.2f} MiB (bf16 {server.cache_mib_dense:.2f})")
    if server.quant_report is not None:
        print(f"quant {server.cfg.quant}: {server.quant_report}")
    if server.completed:
        print("sample output:", server.completed[0][:8])
    return server.completed


def serve_paged(args, cfg, params, rng, device) -> list:
    """Run the request trace through the `Scheduler` over a `PagedEngine`
    (or, with ``--spec-k``, a `SpecPagedEngine`); prints the summary lines
    and returns the terminal requests in submission order."""
    reg = Registry()
    trace = TraceRecorder(enabled=bool(args.trace_out))
    num_pages = args.num_pages if args.num_pages is not None else \
        args.slots * -(-args.max_len // args.page_size) + 1
    kw = dict(slots=args.slots, num_pages=num_pages,
              page_size=args.page_size, max_len=args.max_len,
              chunk=args.chunk, decode_backend=args.backend,
              ffn_backend=args.backend, moe_backend=args.backend,
              quant=args.quant, kv_quant=args.kv_quant, metrics=reg,
              trace=trace, tune=args.tune, device=device)
    if args.spec_k:
        draft_params = None            # a fresh draft at its own geometry
        if args.draft_config == "self":
            draft_cfg, draft_params = cfg, params
        elif args.draft_config == "draft_of":
            draft_cfg = draft_of(cfg)
        else:
            draft_cfg = get_config(args.draft_config)
            if args.reduced:
                draft_cfg = draft_cfg.reduced()
            draft_cfg = dataclasses.replace(draft_cfg, vocab=cfg.vocab)
        engine = SpecPagedEngine(
            cfg, params, spec_k=args.spec_k, draft_cfg=draft_cfg,
            draft_params=draft_params,
            generator=torch.Generator(device=device).manual_seed(1), **kw)
    else:
        engine = PagedEngine(cfg, params, decode_block=args.decode_block,
                             **kw)
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
    if args.spec_k:
        print(f"speculative: K={args.spec_k} draft={args.draft_config} | "
              f"acceptance {engine.acceptance_rate:.3f} ({engine.accepted}/"
              f"{max(engine.drafted, 1)} drafts) | {engine.spec_steps} "
              f"verify steps ({engine.rescue_steps} rescues) for "
              f"{engine.decoded_tokens} tokens "
              f"({engine.decoded_tokens / max(engine.spec_steps, 1):.2f} "
              f"tok/step)")
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
                    help="cuda = the split-KV decode and verify kernels, "
                         "the coarsened FFN matmul and the grouped-expert "
                         "MoE kernels; ref = the plain paths")
    ap.add_argument("--cache", default="paged",
                    choices=["paged", "contiguous"],
                    help="KV cache layout: the paged pool + block tables "
                         "under the Scheduler, or contiguous per-slot "
                         "caches (BatchedServer)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding (paged only): draft K tokens "
                         "a slot a step and verify them in one pass (0 = "
                         "off)")
    ap.add_argument("--draft-config", default="draft_of",
                    help="draft for --spec-k: draft_of (the target's "
                         "reduced shrink), self (the target: the acceptance "
                         "upper bound) or an arch name")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4"],
                    help="weight-only quantization of FFN / MoE / attention "
                         "projections (dequant-fused kernels where the "
                         "geometry allows, dense-dequant elsewhere)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="int8 KV pools: quantize on append, dequant fused "
                         "into the split-KV decode kernel")
    ap.add_argument("--tune", default=None, choices=TUNE_CHOICES,
                    help="warm the coarsening tuning cache before serving: "
                         "greedy / exhaustive time the labels on the card; "
                         "auto / model rank by the H100 bound, the same for "
                         "every label, so they pick base")
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
    ap = parser()
    args = ap.parse_args(argv)
    if args.cache != "paged" and (
            args.spec_k or args.trace_out or args.metrics_out
            or args.metrics_every or args.num_pages is not None
            or args.deadline is not None or args.max_queue_wait is not None
            or args.max_waiting is not None):
        ap.error("--spec-k, --num-pages, --deadline, --max-queue-wait, "
                 "--max-waiting, --trace-out, --metrics-out and "
                 "--metrics-every need --cache paged")
    if args.spec_k < 0:
        ap.error("--spec-k must be >= 0")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.lm_init(cfg, gen, device=device)
    rng = np.random.default_rng(0)
    if args.cache == "contiguous":
        out = serve_contiguous(args, cfg, params, rng, device)
    else:
        out = serve_paged(args, cfg, params, rng, device)
    if args.tune:
        print(tune_report())
    return out


if __name__ == "__main__":
    main()
