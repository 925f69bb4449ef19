"""FCFS + preemption continuous-batching scheduler, robust under pressure.

A copy of `repro.serve.scheduler` (host-side Python only).  The port's
`PagedEngine` has no ``suspend``, so every eviction here takes the
recompute path.

The scheduler is deliberately engine-agnostic: it talks to anything with the
protocol surface below, which makes every scheduling invariant (each
request reaches a terminal state, FCFS admission order, no starvation under
preemption, page conservation) property-testable against a fake engine with
no model or device in the loop — and the same loop then drives the real
``PagedEngine``.

Engine protocol::

    engine.slots            -> int, number of batch slots
    engine.admit(slot, request) -> first greedy token (from the prefill
                                     # logits) or None; may raise
                                     # PoolExhausted (no partial effects)
    engine.decode(slots)    -> {slot: [new_token, ...]} for the RUNNING
                                     # slots; may raise PoolExhausted when
                                     # page growth fails mid-decode (after
                                     # rolling back to a consistent state)
                                     # or DecodeFault (transient, cursors
                                     # unadvanced — just retry)
    engine.finish(slot)              # frees the slot's pages
    engine.preempt(slot)             # drop cache pages, forget progress
    # optional (resumable preemption — PagedEngine implements these):
    engine.suspend(slot)    -> suspension   # swap pages+state to host
    engine.resume(slot, suspension)         # restore, NO re-prefill;
                                            # may raise PoolExhausted
    engine.suspend_bytes(slot) -> int       # host bytes a swap would take

Eviction policy: on ``PoolExhausted`` the *youngest* running request
(latest arrival) is evicted and requeued at the head of the wait queue in
arrival order — the oldest request is never the victim, so it monotonically
keeps its pages and finishes; once it frees them the next-oldest holds the
same property.  That induction is the no-starvation guarantee, and it holds
as long as a lone worst-case request fits the pool (checked at submit).

HOW a victim is evicted is the swap-vs-recompute policy: when the engine
supports suspension and the suspended bytes fit the host SwapStore budget,
the slot is swapped to host memory and later resumed into fresh pages with
all its prefill + decode work intact; otherwise it is recompute-preempted
(pages dropped, output reset, prefill re-run at re-admission).  Either way
counts against ``max_preemptions`` — overflow is a per-request terminal
FAILED status, never a server crash.

Degradation ladder (each rung sheds load instead of falling off a cliff):
deadline'd requests cancel with pages freed; queue-wait overruns reject
with a retry-after hint; a full wait queue rejects at submit; repeated
eviction fails the one livelocked request; transient decode faults retry
bounded-many times.  ``drain()`` is the graceful-shutdown path: everything
in flight terminates CANCELLED with partial output kept and pages freed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

from repro_torch.obs import NULL_TRACER, QUANTA_BUCKETS, Registry, SCHED_TRACK
from repro_torch.serve.paging import (DecodeFault, PoolExhausted, SwapStore,
                                pages_needed)


class State(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    SUSPENDED = "suspended"   # swapped to host; resumes with work intact
    PREEMPTED = "preempted"   # requeued after a cache drop; restarts clean
    FINISHED = "finished"
    CANCELLED = "cancelled"   # deadline expired / drained; partial output
    REJECTED = "rejected"     # load shed (queue full / wait overrun)
    FAILED = "failed"         # livelock eviction overflow / admit failures


TERMINAL = (State.FINISHED, State.CANCELLED, State.REJECTED, State.FAILED)


@dataclass
class Request:
    """One generation request. ``prefix`` optionally names a registered
    shared prefix whose pages are refcount-shared instead of recomputed.

    ``deadline`` (absolute scheduler-clock quantum) cancels the request
    wherever it is once the clock passes it; ``max_queue_wait`` (quanta
    since the last enqueue) rejects it with a ``retry_after`` hint while it
    waits.  Terminal states carry ``error`` (except FINISHED)."""
    rid: int
    prompt: list[int]
    gen: int
    prefix: str | None = None
    state: State = State.WAITING
    arrival: int = 0              # admission priority (FCFS ties by rid)
    deadline: int | None = None
    max_queue_wait: int | None = None
    preemptions: int = 0          # evictions of either kind
    swaps: int = 0                # evictions that went the suspend path
    output: list[int] = field(default_factory=list)
    error: str | None = None
    retry_after: int | None = None
    submitted_at: int = 0
    enqueued_at: int = 0
    admit_failures: int = 0
    submitted_wall: float = 0.0   # perf_counter at submit (TTFT histogram)
    first_tok_wall: float | None = None

    @property
    def key(self):
        return (self.arrival, self.rid)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL


class Scheduler:
    """Drives an engine: admit waiting requests FCFS into free slots, decode
    the running set, evict the youngest on pool exhaustion (host-swap when
    the budget allows, recompute otherwise).

    ``host_swap_bytes``: SwapStore budget for suspended slots (None =
    unbounded — swap whenever the engine supports it; 0 disables swapping).
    ``max_waiting``: wait-queue bound; submits past it are shed with a
    terminal REJECTED status and a retry-after hint.
    """

    def __init__(self, engine, *, max_preemptions: int = 64,
                 host_swap_bytes: int | None = None,
                 max_waiting: int | None = None,
                 max_admit_retries: int = 8,
                 max_decode_faults: int = 16,
                 metrics: Registry | None = None, trace=None):
        self.engine = engine
        self.waiting: list[Request] = []
        self.running: dict[int, Request] = {}   # slot -> request
        self.finished: list[Request] = []       # every TERMINAL request
        self._clock = 0
        self._rid = 0
        self.max_preemptions = max_preemptions
        self.max_waiting = max_waiting
        self.max_admit_retries = max_admit_retries
        self.max_decode_faults = max_decode_faults
        self.obs = metrics if metrics is not None else Registry()
        self.trace = trace if trace is not None else NULL_TRACER
        self.swap = SwapStore(host_swap_bytes, metrics=self.obs)
        self.steps = 0
        self.time = 0                  # scheduler clock, one tick per step()
        self._consecutive_faults = 0
        o = self.obs
        self._m_submitted = o.counter("sched_submitted_total")
        self._m_preempt = o.counter("sched_preemptions_total",
                                    "evictions of either kind")
        self._m_evict = {
            "swap": o.counter("sched_evictions_total", policy="swap"),
            "recompute": o.counter("sched_evictions_total",
                                   policy="recompute")}
        self._m_faults = o.counter("sched_decode_faults_total",
                                   "transient decode faults retried")
        self._m_quanta = o.counter("sched_quanta_total")
        self._m_terminal = {s: o.counter("sched_requests_total",
                                         state=s.value) for s in TERMINAL}
        self._g_waiting = o.gauge("sched_waiting")
        self._g_running = o.gauge("sched_running")
        self._g_free_pages = o.gauge(
            "engine_free_pages", "free pool pages (lo = high-water usage)") \
            if hasattr(engine, "free_pages") else None
        self._h_queue_wait = o.histogram("sched_queue_wait_quanta",
                                         QUANTA_BUCKETS,
                                         "quanta from enqueue to admission")
        self._h_ttft = o.histogram("sched_ttft_seconds", help="wall seconds "
                                   "from submit to first output token")
        self._h_intertok = o.histogram(
            "sched_intertoken_seconds",
            help="wall seconds per emitted token, per slot, per quantum")
        self._h_swap_rt = o.histogram(
            "sched_swap_roundtrip_seconds",
            help="wall seconds from suspend to successful resume")
        self._suspend_wall: dict[int, float] = {}   # rid -> suspend time

    @property
    def decode_faults(self) -> int:
        return self._m_faults.value

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, gen: int, *, prefix: str | None = None,
               deadline: int | None = None,
               max_queue_wait: int | None = None) -> Request:
        max_len = getattr(self.engine, "max_len", None)
        if max_len is not None and len(prompt) + gen > max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + gen ({gen}) tokens exceed max_len "
                f"{max_len}; rejecting instead of truncating")
        worst = pages_needed(len(prompt) + gen, self.engine.page_size) \
            if hasattr(self.engine, "page_size") else 0
        cap = getattr(self.engine, "pool_capacity", None)
        if cap is not None and worst > cap:
            raise ValueError(
                f"request needs {worst} pages even running alone; pool holds "
                f"{cap} — it could never be scheduled")
        req = Request(rid=self._rid, prompt=list(prompt), gen=int(gen),
                      prefix=prefix, arrival=self._clock, deadline=deadline,
                      max_queue_wait=max_queue_wait, submitted_at=self.time,
                      enqueued_at=self.time, submitted_wall=time.perf_counter())
        self._rid += 1
        self._clock += 1
        self._m_submitted.inc()
        self.trace.lifecycle(req.rid, "QUEUED",
                             {"prompt": len(req.prompt), "gen": req.gen})
        if self.max_waiting is not None \
                and len(self.waiting) >= self.max_waiting:
            # backpressure: shed load LOUDLY instead of queueing unboundedly
            # — the caller gets a terminal status plus a drain estimate to
            # retry against, and the running batch is never stalled
            req.retry_after = self.retry_after()
            self._terminate(req, State.REJECTED,
                            f"wait queue full ({self.max_waiting}); "
                            f"retry after ~{req.retry_after} quanta")
            return req
        self.waiting.append(req)
        return req

    def retry_after(self) -> int:
        """Rough quanta until the wait queue has room: queued decode work
        spread over the engine's slots.  Deterministic, intentionally
        coarse — a backoff hint, not a promise."""
        queued = sum(r.gen - len(r.output) for r in self.waiting)
        return max(1, queued // max(1, self.engine.slots))

    # -- terminal bookkeeping ------------------------------------------------

    def _terminate(self, req: Request, state: State, error=None) -> None:
        if req.rid in self.swap:
            self.swap.drop(req.rid)
            self._suspend_wall.pop(req.rid, None)
        req.state = state
        if error is not None:
            req.error = error
        self.finished.append(req)
        self._m_terminal[state].inc()
        self.trace.lifecycle(req.rid, state.name,
                             {"tokens": len(req.output)})

    @property
    def completed(self) -> list[Request]:
        return [r for r in self.finished if r.state is State.FINISHED]

    # -- scheduling ----------------------------------------------------------

    def _free_slots(self):
        return [s for s in range(self.engine.slots) if s not in self.running]

    def _admission_failed(self, req: Request) -> bool:
        """Admission raised PoolExhausted.  With co-residents the pressure
        resolves through decode progress — just wait.  With an EMPTY
        running set nothing will free pages by itself (submit checked the
        request fits alone), so retry bounded-many times (transient faults
        clear) and then fail the request rather than the server.  Returns
        True when the caller should stop admitting this quantum."""
        if self.running:
            return True
        req.admit_failures += 1
        if req.admit_failures > self.max_admit_retries:
            self.waiting.remove(req)
            self._terminate(
                req, State.FAILED,
                f"admission failed {req.admit_failures} times with no "
                f"co-residents to evict (injected faults or a pool "
                f"inconsistent with submit's worst-case check)")
            return False     # the queue may hold an admissible successor
        return True

    def _admit_waiting(self) -> None:
        """FCFS: oldest waiting request into lowest free slot; stop at the
        first admission failure (admitting younger over older would break
        arrival order).  SUSPENDED requests resume — same pool contract as
        admit, but no prefill and no output reset."""
        self.waiting.sort(key=lambda r: r.key)
        bound = getattr(self.engine, "step_growth_bound", None)
        while self.waiting and (free := self._free_slots()):
            req, slot = self.waiting[0], free[0]
            if bound is not None and self.running \
                    and self.engine.free_pages < bound(req):
                # admitting would leave the next decode step short of its
                # worst-case page growth (speculative verify appends K+1
                # rows at once) — hold the request until decode progress
                # frees pages.  Skipped when nothing is running: a lone
                # request must always make progress.
                break
            if req.state is State.SUSPENDED:
                try:
                    self.engine.resume(slot, self.swap.peek(req.rid))
                except PoolExhausted:
                    if self._admission_failed(req):
                        break
                    continue
                self.swap.pop(req.rid)
                t_susp = self._suspend_wall.pop(req.rid, None)
                if t_susp is not None:
                    self._h_swap_rt.observe(time.perf_counter() - t_susp)
                self.trace.lifecycle(req.rid, "RESUMED", {"slot": slot})
            else:
                try:
                    first = self.engine.admit(slot, req)
                except PoolExhausted:
                    if self._admission_failed(req):
                        break
                    continue
                if first is not None:
                    req.output.append(int(first))
                    self._first_token(req)
                self.trace.lifecycle(req.rid, "ADMITTED", {"slot": slot})
            self._h_queue_wait.observe(self.time - req.enqueued_at)
            req.state = State.RUNNING
            req.admit_failures = 0
            self.running[slot] = req
            self.waiting.pop(0)

    def _first_token(self, req: Request) -> None:
        if req.first_tok_wall is None:
            req.first_tok_wall = time.perf_counter()
            self._h_ttft.observe(req.first_tok_wall - req.submitted_wall)

    def _preempt_youngest(self) -> None:
        """Evict the youngest running request — swap when it fits the host
        budget, recompute otherwise; overflow of ``max_preemptions`` is a
        terminal per-request failure, never a server crash."""
        slot, req = max(self.running.items(), key=lambda kv: kv[1].key)
        req.preemptions += 1
        if req.preemptions > self.max_preemptions:
            self.engine.preempt(slot)
            del self.running[slot]
            req.output = []
            self._terminate(
                req, State.FAILED,
                f"evicted {req.preemptions} times — livelock (pool too "
                f"small for the running set?)")
            return
        self._m_preempt.inc()
        if hasattr(self.engine, "suspend") \
                and self.swap.fits(self.engine.suspend_bytes(slot)):
            susp = self.engine.suspend(slot)
            self.swap.put(req.rid, susp, getattr(susp, "nbytes", 0))
            self._suspend_wall[req.rid] = time.perf_counter()
            req.state = State.SUSPENDED
            req.swaps += 1
            self._m_evict["swap"].inc()
            self.trace.lifecycle(req.rid, "SUSPENDED", {"slot": slot})
        else:
            self.engine.preempt(slot)
            req.state = State.PREEMPTED
            req.output = []
            self._m_evict["recompute"].inc()
            self.trace.lifecycle(req.rid, "PREEMPTED", {"slot": slot})
        del self.running[slot]
        req.enqueued_at = self.time
        self.waiting.append(req)   # key() keeps original arrival order

    def _expire(self) -> None:
        """Deadline + queue-wait enforcement, both queues.  Cancelling a
        running slot frees its pages through finish(); cancelling a
        suspended request drops its host snapshot; partial output stays on
        the request (the pool sees no partial effects either way)."""
        now, keep = self.time, []
        for req in self.waiting:
            if req.deadline is not None and now >= req.deadline:
                self._terminate(req, State.CANCELLED,
                                "deadline expired while queued")
            elif req.max_queue_wait is not None \
                    and now - req.enqueued_at > req.max_queue_wait:
                req.retry_after = self.retry_after()
                self._terminate(
                    req, State.REJECTED,
                    f"queued longer than max_queue_wait="
                    f"{req.max_queue_wait}; retry after ~{req.retry_after}")
            else:
                keep.append(req)
        self.waiting = keep
        for slot in [s for s, r in self.running.items()
                     if r.deadline is not None and now >= r.deadline]:
            req = self.running.pop(slot)
            self.engine.finish(slot)
            self._terminate(req, State.CANCELLED,
                            "deadline expired while running")

    def _retire(self) -> None:
        for slot in [s for s, r in self.running.items()
                     if len(r.output) >= r.gen]:
            req = self.running.pop(slot)
            self.engine.finish(slot)
            req.output = req.output[: req.gen]
            self._terminate(req, State.FINISHED)

    def step(self) -> bool:
        """One scheduling quantum: expire, admit, decode, retire. Returns
        True while any work remains."""
        self.time += 1
        self.trace.quantum = self.time   # everything this step inherits it
        with self.trace.span("sched.quantum", "sched", SCHED_TRACK):
            more = self._step()
        self._m_quanta.inc()
        self._g_waiting.set(len(self.waiting))
        self._g_running.set(len(self.running))
        if self._g_free_pages is not None:
            self._g_free_pages.set(self.engine.free_pages)
        return more

    def _step(self) -> bool:
        self._expire()
        self._admit_waiting()
        self._retire()                      # a gen==1 request ends at admit
        if not self.running:
            return bool(self.waiting)
        self.steps += 1
        while True:
            try:
                t0 = time.perf_counter()
                new = self.engine.decode(sorted(self.running))
                dt = time.perf_counter() - t0
                self._consecutive_faults = 0
                break
            except PoolExhausted:
                self._preempt_youngest()
                if not self.running:
                    return bool(self.waiting)
            except DecodeFault as e:
                # transient, no cursor advanced — retry the quantum, but
                # give up loudly if the "transient" fault never clears
                self._m_faults.inc()
                self._consecutive_faults += 1
                if self._consecutive_faults > self.max_decode_faults:
                    raise RuntimeError(
                        f"{self._consecutive_faults} consecutive decode "
                        f"faults — not transient: {e}") from e
                return True
        for slot, toks in new.items():
            req = self.running[slot]
            req.output.extend(int(t) for t in toks)
            if toks:
                self._first_token(req)
                self._h_intertok.observe(dt / len(toks))
        self._retire()
        return bool(self.waiting or self.running)

    def run_until_done(self, *, max_steps: int = 100_000):
        while self.step():
            if self.steps > max_steps:
                raise RuntimeError("scheduler did not converge")
        assert not self.waiting and not self.running
        return sorted(self.finished, key=lambda r: r.rid)

    def drain(self, *, reason: str = "server drained"):
        """Graceful shutdown: cancel the queue, finish-and-cancel every
        running slot (pages freed through the engine), drop suspensions.
        Partial outputs stay on the requests.  Returns all terminal
        requests, like run_until_done."""
        for req in self.waiting:
            self._terminate(req, State.CANCELLED, reason)
        self.waiting = []
        for slot in sorted(self.running):
            req = self.running[slot]
            self.engine.finish(slot)
            self._terminate(req, State.CANCELLED, reason)
        self.running = {}
        return sorted(self.finished, key=lambda r: r.rid)
