"""PagedEngine: the model-coupled paged-KV serving engine.

Mirrors `repro/serve/engine.py` `PagedEngine` (:83): it owns the paged
decode cache (`models.model.lm_init_cache_paged`), the page pool + block
tables (`serve.paging`), the per-slot generation state, and the prefill and
decode steps.  The `Scheduler` drives it through the admit / decode /
finish / preempt protocol; it never schedules on its own.

* **Admission** (`admit`, :416) allocates exactly the pages the prompt
  needs and prefills the prompt in chunks through the block table
  (`_run_prefill`, :385): every chunk runs all slots as one batch, with the
  other slots' table rows NULLed so their writes land on the null page.
  It returns the first greedy token from the prefill logits.
* **Decode** (`decode`, :478) grows each running slot's table to cover the
  rows the next block will write, then runs up to ``decode_block`` steps.
  The reference runs them as one jitted `lax.scan` (:455-476); here it is a
  plain loop that feeds each step's argmax to the next on the device and
  syncs once per block.  Pool exhaustion surfaces as PoolExhausted.
* **NaN guard**: a block whose logits for a running slot hold a NaN is
  re-run from the same cursors (bounded retries, then DecodeFault).  The
  cache rows it rewrites are the ones the failed run wrote, so the re-run
  is exact, as in the reference.
* **Preempt / finish** release the slot's pages and clear the slot.

In-place updates that replace the reference's functional ones: the cache's
pools are written in place by `lm_prefill` / `lm_decode_step`
(``self.cache`` is never reassigned), where the reference rebinds
``self.cache`` to each call's returned cache.

* **Quantization** (:106-116): ``quant="int8"|"int4"`` runs
  `quantize_params` over the weights at construction (``quant_report``);
  ``kv_quant="int8"`` builds int8 pools with f32 scale pools.  Both the
  dense and the quantized sizes are kept (``weight_mib_dense`` /
  ``weight_mib``, ``cache_mib_dense`` / ``cache_mib``).

* **Admission accounting** (:551-570): `_step_rows` and `_growth_bound`
  count the pages the next decode step may allocate; the speculative
  engine (`serve.spec`) exposes them to the scheduler as
  `step_growth_bound`.

* **Tuning** (:119-122): ``tune="auto"|"model"|"greedy"|"exhaustive"``
  warms the coarsening cache (`repro_torch.tune.warm_from_flag`) at this
  engine's geometry (seq = max_len, batch = slots, the page size) before
  the cache is built, so the first step's ``cfg="auto"`` resolves from it.

Not ported: host-swap ``suspend`` / ``resume`` (their absence makes the
scheduler take the recompute path on preemption) and shared prefixes
(`register_prefix` and `drop_prefix` raise NotImplementedError).

Greedy sampling only: a request's outputs equal its solo run, whatever its
co-residents.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.device import resolve_device, synchronize
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import ENGINE_TRACK, NULL_TRACER, Registry
from repro_torch.quant.qtypes import quantize_params, tree_nbytes
from repro_torch.serve.paging import (BlockTables, DecodeFault, PagePool,
                                      pages_needed)

MAX_NAN_RETRIES = 4


def _tree_mib(tree) -> float:
    return tree_nbytes(tree) / 2**20


class PagedEngine:
    """Paged-KV serving engine for one model instance.

    num_pages counts POOL pages including the reserved null page; the
    per-slot table holds ceil(max_len / page_size) entries and admission
    rejects any prompt_len + gen_tokens > max_len outright.  ``params`` must
    already live on ``device`` (``cuda`` unless ``device="cpu"``); with
    ``quant`` they are quantized here (the caller's tree is left as it
    is, so the caller may free it)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int,
                 num_pages: int, page_size: int, max_len: int,
                 chunk: int = 16, decode_block: int = 1,
                 tune: str | None = None,
                 decode_backend: str | None = None,
                 ffn_backend: str | None = None,
                 moe_backend: str | None = None, quant: str | None = None,
                 kv_quant: str | None = None,
                 metrics: Registry | None = None, trace=None, device=None):
        if cfg.is_encdec:
            raise NotImplementedError("PagedEngine: enc-dec models are not "
                                      "supported")
        for field, value in (("decode_backend", decode_backend),
                             ("ffn_backend", ffn_backend),
                             ("moe_backend", moe_backend), ("quant", quant),
                             ("kv_quant", kv_quant)):
            if value is not None:
                cfg = dataclasses.replace(cfg, **{field: value})
        self.device = resolve_device(device)
        self.weight_mib_dense = _tree_mib(params)
        self.quant_report = None
        if cfg.quant in ("int8", "int4"):
            params, self.quant_report = quantize_params(
                params, cfg.quant, group=cfg.quant_group)
        self.obs = metrics if metrics is not None else Registry()
        self.trace = trace if trace is not None else NULL_TRACER
        if tune:
            from repro_torch.tune import warm_from_flag
            warm_from_flag(cfg, tune, seq=max_len, batch=slots,
                           page_size=page_size, metrics=self.obs)
        self.cfg, self.params = cfg, params
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.chunk, self.decode_block = int(chunk), int(decode_block)
        self.pool = PagePool(num_pages, page_size)
        self.npp = pages_needed(max_len, page_size)
        self.bt = BlockTables(slots, self.npp)
        self.cache = M.lm_init_cache_paged(cfg, num_pages, page_size,
                                           device=self.device)
        self.cache_mib = _tree_mib(self.cache)
        # what the same pool would take in bf16 (2 bytes per K/V value)
        self.cache_mib_dense = (2 * cfg.n_layers * num_pages * page_size
                                * cfg.n_kv_heads * cfg.hd * 2 / 2**20)
        self.weight_mib = _tree_mib(params)

        self.active = np.zeros((slots,), bool)
        self.written = np.zeros((slots,), np.int32)   # cache rows filled
        self.last = np.zeros((slots,), np.int32)      # last sampled token
        self.remaining = np.zeros((slots,), np.int32)  # gen tokens left

        o = self.obs
        self._c_prefill_steps = o.counter("engine_prefill_steps_total")
        self._c_decode_steps = o.counter("engine_decode_steps_total")
        self._c_prefill_tokens = o.counter("engine_prefill_tokens_total")
        self._c_decode_tokens = o.counter("engine_decode_tokens_total")
        self._c_nan_rescues = o.counter(
            "engine_nan_rescues_total", "decode blocks re-run by the guard")
        # device-boundary timers: model calls + the device sync ONLY (no
        # host bookkeeping) — what the tok/s lines divide by
        self._c_prefill_dev = o.counter("engine_prefill_device_seconds_total")
        self._c_decode_dev = o.counter("engine_decode_device_seconds_total")

    # counters, as read-only views over the obs registry ------------------

    @property
    def prefill_steps(self) -> int:
        return self._c_prefill_steps.value

    @property
    def decode_steps(self) -> int:
        return self._c_decode_steps.value

    @property
    def prefill_tokens(self) -> int:
        return self._c_prefill_tokens.value

    @property
    def decoded_tokens(self) -> int:
        return self._c_decode_tokens.value

    @property
    def nan_rescues(self) -> int:
        return self._c_nan_rescues.value

    @property
    def prefill_device_s(self) -> float:
        return self._c_prefill_dev.value

    @property
    def decode_device_s(self) -> float:
        return self._c_decode_dev.value

    @property
    def page_size(self) -> int:
        return self.pool.page_size

    @property
    def pool_capacity(self) -> int:
        return self.pool.capacity

    @property
    def any_active(self) -> bool:
        return bool(self.active.any())

    @property
    def free_pages(self) -> int:
        return self.pool.num_free

    def _device_table(self, active) -> torch.Tensor:
        return torch.as_tensor(self.bt.device(active=active),
                               dtype=torch.int32, device=self.device)

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    # -- prefill ------------------------------------------------------------

    def _run_prefill(self, slot: int, tokens, rid=None):
        """Chunked prefill of ``tokens`` into ``slot`` from row 0; returns
        the final chunk's logits row."""
        only = np.zeros((self.slots,), bool)
        only[slot] = True
        bt_dev = self._device_table(only)    # other slots' writes -> null
        logits = None
        for i in range(0, len(tokens), self.chunk):
            piece = tokens[i:i + self.chunk]
            buf = np.zeros((self.slots, len(piece)), np.int32)
            buf[slot] = piece
            pos0 = self.written.copy()
            pos0[slot] = i
            with self.trace.span("prefill.chunk", "engine", slot,
                                 {"rid": rid, "pos": i,
                                  "n": len(piece)}):
                td = time.perf_counter()
                logits, _ = M.lm_prefill(
                    self.params, self._ints(buf), self.cfg, cache=self.cache,
                    block_table=bt_dev, pos0=self._ints(pos0))
                synchronize(self.device)
                self._c_prefill_dev.inc(time.perf_counter() - td)
            self._c_prefill_steps.inc()
        self._c_prefill_tokens.inc(len(tokens))
        return logits[slot]

    # -- engine protocol ----------------------------------------------------

    def admit(self, slot: int, req) -> int:
        """Allocate pages, ingest the prompt, return the first greedy token.
        Raises ValueError for prompts that can never fit, PoolExhausted when
        the pool can't serve the prompt right now (no partial effects)."""
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} is already running")
        prompt, gen = list(req.prompt), int(req.gen)
        if not prompt or gen < 1:
            raise ValueError("admit needs a non-empty prompt and gen >= 1")
        if len(prompt) + gen > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + gen ({gen}) tokens exceed "
                f"max_len {self.max_len}; rejecting instead of truncating")
        if getattr(req, "prefix", None):
            raise NotImplementedError("shared prefixes are not ported yet")
        fresh = self.pool.alloc(pages_needed(len(prompt), self.page_size))
        self.bt.append(slot, fresh)
        logits = self._run_prefill(slot, prompt,
                                   rid=getattr(req, "rid", None))
        first = int(torch.argmax(logits))
        self.active[slot] = True
        self.written[slot] = len(prompt)
        self.last[slot] = first
        self.remaining[slot] = gen - 1
        return first

    def _decode_block(self, n: int, slots):
        """Run ``n`` greedy decode steps for every slot from the current
        cursors; returns ((slots, n) tokens on the host, whether any running
        slot's logits held a NaN)."""
        last = np.zeros((self.slots, 1), np.int32)
        last[slots, 0] = self.last[slots]
        tok = self._ints(last)
        pos = self._ints(self.written)
        bt = self._device_table(self.active)
        rows = torch.as_tensor(slots, device=self.device)
        toks, bad = [], torch.zeros((), dtype=torch.bool, device=self.device)
        for _ in range(n):
            logits, _ = M.lm_decode_step(self.params, self.cache, tok, pos,
                                         self.cfg, block_table=bt)
            bad |= torch.isnan(logits[rows]).any()
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        out = torch.stack(toks, dim=1).cpu().numpy()
        return out, bool(bad)

    def decode(self, slots) -> dict[int, list[int]]:
        """Run a decode block for the running ``slots``; returns the new
        greedy tokens per slot.  Page growth happens BEFORE the block;
        PoolExhausted propagates to the scheduler (slots whose growth
        already succeeded keep their pages — consistent, not leaked)."""
        slots = [s for s in slots if self.active[s]]
        if not slots:
            return {}
        n = max(1, min(self.decode_block,
                       *(int(self.remaining[s]) for s in slots)))
        for s in slots:
            need = pages_needed(int(self.written[s]) + n, self.page_size) \
                - self.bt.num_pages(s)
            if need > 0:
                self.bt.append(s, self.pool.alloc(need))

        def launch():
            td = time.perf_counter()
            out = self._decode_block(n, slots)
            self._c_decode_dev.inc(time.perf_counter() - td)
            return out

        with self.trace.span("decode.block", "engine", ENGINE_TRACK,
                             {"slots": len(slots), "n": n}):
            toks, bad = launch()
            retries = 0
            while bad:
                retries += 1
                if retries > MAX_NAN_RETRIES:
                    raise DecodeFault(
                        f"non-finite logits persisted through {retries - 1} "
                        f"rescue re-runs")
                self._c_nan_rescues.inc()
                self.trace.event("nan.rescue", "engine", ENGINE_TRACK,
                                 {"retry": retries})
                toks, bad = launch()
        self._c_decode_steps.inc(n)
        self._c_decode_tokens.inc(n * len(slots))
        out = {}
        for s in slots:
            out[s] = [int(v) for v in toks[s]]
            self.last[s] = toks[s, -1]
            self.written[s] += n
            self.remaining[s] -= n
        return out

    # -- admission accounting -----------------------------------------------

    def _step_rows(self) -> int:
        """Worst-case cache rows one decode step appends per slot.  The
        speculative engine overrides this (K+1 rows a verify step) and
        exposes `_growth_bound` to the scheduler as `step_growth_bound`."""
        return self.decode_block

    def _growth_bound(self, req=None) -> int:
        """Worst-case pages the NEXT decode step may allocate across the
        running slots — plus, when ``req`` is given, the pages admitting it
        would take (its prompt) and its own first step's growth."""
        n, ps = self._step_rows(), self.page_size
        total = 0
        for s in range(self.slots):
            if self.active[s]:
                total += max(0, pages_needed(int(self.written[s]) + n, ps)
                             - self.bt.num_pages(s))
        if req is not None:
            total += pages_needed(len(req.prompt) + n, ps)
        return total

    # -- release ------------------------------------------------------------

    def _drop(self, slot: int) -> None:
        self.pool.release(self.bt.drop(slot))
        self.active[slot] = False
        self.written[slot] = self.last[slot] = self.remaining[slot] = 0

    def finish(self, slot: int) -> None:
        self._drop(slot)

    def preempt(self, slot: int) -> None:
        self._drop(slot)

    # -- not ported yet -------------------------------------------------------

    def register_prefix(self, name: str, tokens) -> int:
        raise NotImplementedError("shared prefixes are not ported yet")

    def drop_prefix(self, name: str) -> None:
        raise NotImplementedError("shared prefixes are not ported yet")
