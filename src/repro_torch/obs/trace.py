"""Low-overhead request-lifecycle + engine-span trace recorder.

The paper's whole method is *observing* where kernels spend their time and
choosing coarsening degrees from that evidence; this module is the serving
stack's equivalent for scheduler/engine time.  A ``TraceRecorder`` collects
instant events (request lifecycle transitions: QUEUED -> ADMITTED -> ... ->
exactly one terminal state) and spans (prefill chunks, decode blocks, verify
passes, swap gather/scatter) into a fixed-capacity ring buffer, and exports
them as Chrome trace-event JSON that Perfetto / chrome://tracing load
directly.

Two clocks ride on every event: the wall clock (``ts``, microseconds since
recorder start — what Perfetto renders) and the scheduler's logical-quantum
clock (``args["q"]`` — what the deterministic tests compare, because wall
time is not replayable).  The scheduler stamps ``recorder.quantum`` once per
step; everything recorded inside that step inherits it.

Cost model:

* **disabled** (the default everywhere): ``event``/``begin``/``end`` return
  on the first instruction and allocate nothing; ``span`` returns one
  shared no-op context manager.  Instrumented code needs no ``if
  tracing:`` guards.
* **enabled**: one tuple append into a ``deque(maxlen=capacity)`` per
  event — the ring drops the oldest events once full (``dropped`` counts
  them) so a long-running server holds bounded memory.

Track layout (Chrome ``tid``): engine slots trace as tid 0..slots-1,
batch-level engine work (decode blocks, verify passes) on ``ENGINE_TRACK``,
the scheduler's quantum spans on ``SCHED_TRACK``, and each request's
lifecycle as instant events on ``REQ_TRACK_BASE + rid``.  ``to_chrome``
emits thread-name metadata so Perfetto labels the tracks.
"""
from __future__ import annotations

import json
import time
from collections import deque

ENGINE_TRACK = 998          # batch-level engine spans (decode/verify)
SCHED_TRACK = 999           # scheduler quantum spans
REQ_TRACK_BASE = 1000       # request rid r traces on tid REQ_TRACK_BASE + r

# request lifecycle states an instant event may carry (scheduler states
# plus the admission-side transitions)
LIFECYCLE = ("QUEUED", "ADMITTED", "RESUMED", "SUSPENDED", "PREEMPTED",
             "FINISHED", "CANCELLED", "REJECTED", "FAILED")
TERMINAL_STATES = frozenset({"FINISHED", "CANCELLED", "REJECTED", "FAILED"})


class _NullSpan:
    """Shared no-op context manager the disabled recorder hands out.
    Explicit __exit__ parameters: *args would pack a tuple per call and the
    disabled path is pinned to allocate nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("rec", "tid")

    def __init__(self, rec: "TraceRecorder", tid: int):
        self.rec, self.tid = rec, tid

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.rec.end(self.tid)
        return False


class TraceRecorder:
    """Ring-buffered span/event recorder, zero-cost when disabled."""

    def __init__(self, capacity: int = 1 << 16, enabled: bool = True,
                 clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._clock = clock
        self._t0 = clock()
        self._buf: deque = deque(maxlen=self.capacity)
        self._open: dict[int, list] = {}   # tid -> stack of open spans
        self.quantum = 0      # the scheduler's logical clock (stamped on
        self._seq = 0         # every event next to the wall timestamp)
        self.dropped = 0      # events the ring overwrote

    def __bool__(self) -> bool:
        return self.enabled

    def __len__(self) -> int:
        return len(self._buf)

    # -- recording -----------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _push(self, name, ph, cat, tid, ts, dur, args) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._seq += 1
        self._buf.append((self._seq, name, ph, cat, int(tid), ts, dur,
                          self.quantum, args))

    def event(self, name: str, cat: str = "event", tid: int = 0,
              args: dict | None = None) -> None:
        """Record an instant event.  First instruction returns when the
        recorder is disabled — call sites need no guard."""
        if not self.enabled:
            return
        self._push(name, "i", cat, tid, self._now_us(), 0.0, args)

    def lifecycle(self, rid: int, state: str,
                  args: dict | None = None) -> None:
        """Record one request-lifecycle transition on the request's own
        track.  ``state`` should be a LIFECYCLE name."""
        if not self.enabled:
            return
        a = {"rid": int(rid)}
        if args:
            a.update(args)
        self._push(state, "i", "request", REQ_TRACK_BASE + int(rid),
                   self._now_us(), 0.0, a)

    def begin(self, name: str, cat: str = "engine", tid: int = 0,
              args: dict | None = None) -> None:
        """Open a span on ``tid``.  Spans per tid form a stack, so recorded
        spans always nest and never overlap within a track."""
        if not self.enabled:
            return
        self._open.setdefault(int(tid), []).append(
            (name, cat, self._now_us(), self.quantum, args))

    def end(self, tid: int = 0) -> None:
        """Close the innermost open span on ``tid`` as a complete event."""
        if not self.enabled:
            return
        stack = self._open.get(int(tid))
        if not stack:
            raise RuntimeError(f"end() with no open span on tid {tid}")
        name, cat, ts, q, args = stack.pop()
        # the span keeps its OPENING quantum: that is the step it belongs to
        seq = self._seq = self._seq + 1
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append((seq, name, "X", cat, int(tid), ts,
                          max(0.0, self._now_us() - ts), q, args))

    def span(self, name: str, cat: str = "engine", tid: int = 0,
             args: dict | None = None):
        """Context manager recording one complete span; the disabled path
        returns a shared no-op object."""
        if not self.enabled:
            return _NULL_SPAN
        self.begin(name, cat, tid, args)
        return _Span(self, tid)

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing loadable):
        X/i events with both clocks in args, plus thread-name metadata so
        tracks read as "slot 0", "engine", "scheduler", "req 3"."""
        events, tids = [], set()
        for seq, name, ph, cat, tid, ts, dur, q, args in self._buf:
            tids.add(tid)
            a = dict(args) if args else {}
            a["q"] = q
            e = {"name": name, "ph": ph, "cat": cat, "pid": 1, "tid": tid,
                 "ts": round(ts, 3), "args": a}
            if ph == "X":
                e["dur"] = round(dur, 3)
            if ph == "i":
                e["s"] = "t"        # instant scope: thread
            events.append(e)
        meta = []
        for tid in sorted(tids):
            if tid >= REQ_TRACK_BASE:
                label = f"req {tid - REQ_TRACK_BASE}"
            elif tid == SCHED_TRACK:
                label = "scheduler"
            elif tid == ENGINE_TRACK:
                label = "engine"
            else:
                label = f"slot {tid}"
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": tid, "args": {"name": label}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"recorded": len(self._buf),
                              "dropped": self.dropped}}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


# the shared disabled recorder: instrument against this by default so the
# un-observed hot path costs one attribute load + one branch per site
NULL_TRACER = TraceRecorder(capacity=1, enabled=False)

