"""Speculative decoding on the paged engine: draft K, verify in one pass.

Mirrors `repro/serve/spec.py` (:63-418).  A small DRAFT model proposes K
tokens per slot per step; the TARGET model scores all K+1 positions in ONE
batched pass (`models.model.lm_verify_step`, which takes the short-q
verify kernel), and the longest prefix of draft tokens matching the
target's greedy argmaxes is accepted.  Greedy verify is exact in exact
arithmetic: every emitted token is the target's own argmax given the
accepted prefix.

On the card under the kernel backends the T-row verify pass and the
1-row decode step give the same bits: paged decode is the verify
attention at T = 1, and every product and norm of both steps runs on a
row-invariant kernel (`models.layers.step_kernel`), so the cache rows a
verify pass writes are the rows decode steps would write, and the engine
emits `PagedEngine`'s greedy tokens.  On the plain paths (and under tuned
labels, where the decode and verify keys may resolve to different labels)
the two agree only up to rounding, enough to flip an argmax on a
near-tie.  The engine therefore trusts a verify row only when its
top-1/top-2 margin clears ``tie_tau`` times the row's logit standard
deviation (default 0.1), as the reference does.  A row under the guard, or
one holding a non-finite value, ends the step's emission there; a slot
that would emit nothing gets its one token from a RESCUE pass through the
base engine's own decode step, so every emitted token is one the base
engine's decode step would produce on the same cache, and progress is
guaranteed.

Paged mechanics:

* The draft KV cache is itself paged and shares the target's page-id
  space: page p is row p of the target pools AND of the draft pools, so
  one allocator, block table and rollback cover both models.
* A verify step appends up to K+1 rows per slot, so pages are grown for
  the worst case before any compute, and `step_growth_bound` lets the
  scheduler count that growth at admission.
* Rejection rolls back: the slot's block table is truncated to the pages
  covering the accepted rows (`BlockTables.truncate`) and the tail pages
  are released.

Differences from the reference:

* The draft loop, a jitted ``lax.scan`` there (:256-280), is a plain loop
  of ``keff+1`` chained `lm_decode_step` calls; the verify pass follows,
  and the step syncs with the host once, reading back the argmax, top-2
  margin, spread and finiteness of each verify row (not the logits).
* The port's engine has no ``suspend`` (the scheduler recomputes on
  preemption), so the reference's ``_swap_layout`` / ``_gather_pages`` /
  ``_scatter_pages`` overrides, which swap the draft pools with the
  target's, are not here; nor is the fault-injection hook.
* The draft runs on the target's backends (``decode_backend``,
  ``ffn_backend``, ``moe_backend``), whatever ``draft_cfg`` says.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.device import synchronize
from repro_torch.models import model as M
from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig
from repro_torch.obs import ENGINE_TRACK
from repro_torch.quant.qtypes import tree_nbytes
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.paging import pages_needed


def draft_of(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A draft config from a target config: the standard `reduced` shrink
    (few layers, d_model 128, d_ff 256) sharing the target's FULL vocab —
    draft proposals must be target token ids."""
    small = cfg.reduced(**{k: v for k, v in overrides.items()
                           if k != "vocab"})
    return dataclasses.replace(small, vocab=cfg.vocab)


def clears_tie_guard(logits: torch.Tensor, tie_tau: float) -> torch.Tensor:
    """Per row of ``logits`` (..., V): whether the top-1/top-2 margin
    clears ``tie_tau`` times the row's logit spread (the verify/decode
    divergence scales with activation magnitude)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) \
        >= tie_tau * logits.std(dim=-1, correction=0)


def _attention_only(cfg: ModelConfig, what: str) -> None:
    """The reference's attention-only checks (`repro/serve/spec.py:100-117`):
    a rejected row cannot be rewound out of recurrent or SSM state."""
    bad = [k for k in cfg.layer_kinds() if k not in (ATTN_GLOBAL, ATTN_LOCAL)]
    if bad:
        raise NotImplementedError(f"{what} {sorted(set(bad))}")


class SpecPagedEngine(PagedEngine):
    """PagedEngine whose decode step is draft-K / batched-verify.

    Same admit/decode/finish/preempt protocol as the base engine (the
    Scheduler drives both alike); `decode` returns the accepted tokens per
    slot — between 1 (immediate rejection: the target's correction) and
    K+1 (all drafts accepted plus the bonus token) per step.

    ``draft_params=None`` draws a fresh draft from ``generator`` (a seeded
    generator on the engine's device by default), whose proposals are
    mostly rejected; passing the target's own (cfg, params) as the draft
    gives acceptance 1.0 up to ties, the upper bound.
    """

    def __init__(self, cfg: ModelConfig, params, *, spec_k: int,
                 draft_cfg: ModelConfig | None = None, draft_params=None,
                 generator: torch.Generator | None = None,
                 tie_tau: float = 0.1, **kw):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        _attention_only(cfg, "speculative decoding needs an attention-only "
                        "stack (recurrent/SSM state cannot be rewound past "
                        "rejected rows); target has")
        tune = kw.pop("tune", None)
        super().__init__(cfg, params, **kw)
        if tune:
            # warmed here, with the verify family (its spec carries K);
            # self.cfg carries the replacements the base engine applied
            from repro_torch.tune import warm_from_flag
            warm_from_flag(self.cfg, tune, seq=self.max_len,
                           batch=self.slots, page_size=self.page_size,
                           spec_k=spec_k, metrics=self.obs)
        self.spec_k = int(spec_k)
        draft_cfg = draft_cfg if draft_cfg is not None \
            else draft_of(self.cfg)
        if draft_cfg.vocab != self.cfg.vocab:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab} != target vocab "
                f"{self.cfg.vocab}; draft proposals must be target ids")
        _attention_only(draft_cfg, "draft model must be attention-only; has")
        self.draft_cfg = dataclasses.replace(
            draft_cfg, decode_backend=self.cfg.decode_backend,
            ffn_backend=self.cfg.ffn_backend,
            moe_backend=self.cfg.moe_backend)
        if draft_params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            draft_params = M.lm_init(self.draft_cfg, generator,
                                     device=self.device)
        self.draft_params = draft_params
        # the draft cache shares the TARGET's page-id space
        self.draft_cache = M.lm_init_cache_paged(
            self.draft_cfg, self.pool.num_pages, self.page_size,
            device=self.device)
        self.cache_mib += tree_nbytes(self.draft_cache) / 2**20

        self.tie_tau = float(tie_tau)
        o = self.obs
        self._c_drafted = o.counter("spec_drafted_total",
                                    "draft tokens offered to verify")
        self._c_accepted = o.counter("spec_accepted_total",
                                     "draft tokens accepted")
        self._c_spec_steps = o.counter("spec_steps_total")
        self._c_rescues = o.counter(
            "spec_rescue_steps_total",
            "steps that needed a decode-step rescue")
        self._c_nan_rows = o.counter(
            "spec_nan_rows_total", "verify rows voided by the NaN guard")

    @property
    def drafted(self) -> int:
        return self._c_drafted.value

    @property
    def accepted(self) -> int:
        return self._c_accepted.value

    @property
    def spec_steps(self) -> int:
        return self._c_spec_steps.value

    @property
    def rescue_steps(self) -> int:
        return self._c_rescues.value

    @property
    def nan_rows(self) -> int:
        return self._c_nan_rows.value

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(1, self.drafted)

    # -- admission accounting (scheduler hook) ------------------------------

    def _step_rows(self) -> int:
        return self.spec_k + 1          # a verify appends up to K+1 rows

    def step_growth_bound(self, req=None) -> int:
        return self._growth_bound(req)

    # -- draft-side prefill --------------------------------------------------

    def _run_draft_prefill(self, slot: int, tokens) -> None:
        """Ingest the full prompt into the draft cache through the slot's
        (already allocated) block table, the other slots' rows nulled."""
        only = np.zeros((self.slots,), bool)
        only[slot] = True
        bt_dev = self._device_table(only)
        td = time.perf_counter()
        for i in range(0, len(tokens), self.chunk):
            piece = tokens[i:i + self.chunk]
            buf = np.zeros((self.slots, len(piece)), np.int32)
            buf[slot] = piece
            pos0 = self.written.copy()
            pos0[slot] = i
            M.lm_prefill(self.draft_params, self._ints(buf), self.draft_cfg,
                         cache=self.draft_cache, block_table=bt_dev,
                         pos0=self._ints(pos0))
        synchronize(self.device)
        self._c_prefill_dev.inc(time.perf_counter() - td)

    def admit(self, slot: int, req) -> int:
        first = super().admit(slot, req)
        # no draft-side allocation: the target's pages cover the draft, so
        # this cannot raise PoolExhausted after super() succeeded
        self._run_draft_prefill(slot, list(req.prompt))
        return first

    # -- the spec step -------------------------------------------------------

    def _draft_and_verify(self, keff, kpad: int, slots):
        """Draft ``kpad+1`` chained greedy steps (step j writes draft row
        written+j for the slots with j <= keff), then verify [last,
        d_1..d_kpad] in one pass.  Returns, on the host, the drafts (slots,
        kpad+1), and per verify row (slots, kpad+1) the greedy token,
        whether its top-1/top-2 margin clears the tie guard, and whether
        it is finite."""
        bt_dev = self._device_table(self.active)
        pos0 = self._ints(self.written)
        keff_dev = self._ints(keff)
        last = np.zeros((self.slots, 1), np.int32)
        last[slots, 0] = self.last[slots]
        last_dev = self._ints(last)
        tok, pos, drafts = last_dev, pos0, []
        for j in range(kpad + 1):
            logits, _ = M.lm_decode_step(
                self.draft_params, self.draft_cache, tok, pos,
                self.draft_cfg, block_table=bt_dev, write_mask=j <= keff_dev)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        drafts = torch.stack(drafts, dim=1)              # (slots, kpad+1)
        # row t scores position written+t+1 given [.., last, d_1..d_t]
        vtok = torch.cat([last_dev, drafts[:, :kpad]], dim=1)
        logits, _ = M.lm_verify_step(self.params, self.cache, vtok, pos0,
                                     self.cfg, block_table=bt_dev,
                                     valid_len=keff_dev + 1)
        clear = clears_tie_guard(logits, self.tie_tau)
        finite = torch.isfinite(logits).all(dim=-1)
        greedy = torch.argmax(logits, dim=-1)
        return tuple(x.cpu().numpy() for x in (drafts, greedy, clear,
                                               finite))

    def decode(self, slots) -> dict[int, list[int]]:
        """One draft-K / verify / accept / rollback step for the running
        ``slots``; emits 1..K+1 tokens per slot.  Page growth for the worst
        case (all K accepted) happens before any compute; PoolExhausted
        propagates to the scheduler with the slots whose growth succeeded
        keeping their pages — consistent, not leaked."""
        slots = [s for s in slots if self.active[s]]
        if not slots:
            return {}
        ps = self.page_size
        keff = np.zeros((self.slots,), np.int32)
        for s in slots:
            # never draft past the request's budget: a step emits at most
            # keff+1 tokens and remaining >= 1 here
            keff[s] = min(self.spec_k, int(self.remaining[s]) - 1)
        kpad = int(keff[slots].max())
        for s in slots:
            need = pages_needed(int(self.written[s]) + int(keff[s]) + 1, ps) \
                - self.bt.num_pages(s)
            if need > 0:
                self.bt.append(s, self.pool.alloc(need))

        with self.trace.span("verify.pass", "engine", ENGINE_TRACK,
                             {"slots": len(slots), "k": kpad}):
            td = time.perf_counter()
            drafts, greedy, clear, finite = self._draft_and_verify(
                keff, kpad, slots)
            self._c_decode_dev.inc(time.perf_counter() - td)
        # a non-finite verify row is voided: emission stops before it, and
        # the rescue below takes over when nothing else would emit
        voided = int((~finite[slots]).sum())
        if voided:
            self._c_nan_rows.inc(voided)
            self.trace.event("nan.voided", "engine", ENGINE_TRACK,
                             {"rows": voided})
        clear &= finite
        self._c_decode_steps.inc()
        self._c_spec_steps.inc()

        out, rescue = {}, []
        for s in slots:
            k, g, d, ok = int(keff[s]), greedy[s], drafts[s], clear[s]
            n_acc = 0
            while n_acc < k and ok[n_acc] and d[n_acc] == g[n_acc]:
                n_acc += 1
            # accepted drafts d_1..d_n_acc, then the target's own next token
            # (correction or bonus) when its row clears the tie guard
            emitted = [int(g[j]) for j in range(n_acc + int(ok[n_acc]))]
            self._c_drafted.inc(k)
            self._c_accepted.inc(n_acc)
            if not emitted:
                # keep the page holding row `written`: the rescue pass
                # writes there and emits exactly one token
                rescue.append(s)
                self.pool.release(self.bt.truncate(
                    s, pages_needed(int(self.written[s]) + 1, ps)))
                continue
            new_written = int(self.written[s]) + len(emitted)
            # rollback: drop pages past the accepted rows (target AND draft
            # share the ids); stale rows below the page boundary are
            # pos-masked and rewritten before any read
            self.pool.release(
                self.bt.truncate(s, pages_needed(new_written, ps)))
            self.written[s] = new_written
            self.last[s] = emitted[-1]
            self.remaining[s] -= len(emitted)
            self._c_decode_tokens.inc(len(emitted))
            out[s] = emitted

        if rescue:
            # one base-engine decode step for every stepped slot: its argmax
            # (and the row it writes) is the base engine's.  Slots not
            # rescued ride along: their write lands on their next row
            # (rewritten by the next verify) or the null page, and their
            # tokens are discarded.
            self._c_rescues.inc()
            with self.trace.span("decode.rescue", "engine", ENGINE_TRACK,
                                 {"slots": len(rescue)}):
                td = time.perf_counter()
                toks, _ = self._decode_block(1, slots)
                self._c_decode_dev.inc(time.perf_counter() - td)
            for s in rescue:
                tok = int(toks[s, 0])
                out[s] = [tok]
                self.written[s] += 1
                self.last[s] = tok
                self.remaining[s] -= 1
                self._c_decode_tokens.inc()
        return out
