"""Straggler / hang detection for the training loop (a copy of
`repro/runtime/watchdog.py`, :16).

Keeps an EMA of step wall-time; a step slower than `threshold` x EMA fires
the mitigation callback (at scale: mark the slow host, trigger checkpoint +
re-slice; here: callback is injectable and unit-tested with synthetic
timings).  A hard `hang_timeout` arms a timer thread that fires even if the
step never returns — the defense against a wedged collective.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class StepWatchdog:
    def __init__(self, threshold: float = 3.0, hang_timeout: float = 600.0,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None,
                 on_hang: Optional[Callable[[int], None]] = None,
                 ema_alpha: float = 0.1):
        self.threshold = threshold
        self.hang_timeout = hang_timeout
        self.on_straggler = on_straggler or (lambda step, dt, ema: None)
        self.on_hang = on_hang or (lambda step: None)
        self.ema_alpha = ema_alpha
        self.ema: Optional[float] = None
        self.stragglers: list[tuple[int, float]] = []
        self._timer: Optional[threading.Timer] = None
        self._step = 0

    # usage:  with watchdog.step(i): run_train_step()
    def step(self, step_idx: int):
        return _StepCtx(self, step_idx)

    def observe(self, step_idx: int, dt: float) -> bool:
        """Record a step duration; returns True if flagged as straggler."""
        flagged = False
        if self.ema is not None and dt > self.threshold * self.ema:
            self.stragglers.append((step_idx, dt))
            self.on_straggler(step_idx, dt, self.ema)
            flagged = True
            # do not poison the EMA with the straggler sample
        else:
            self.ema = dt if self.ema is None else (
                (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt)
        return flagged

    def _arm(self, step_idx: int):
        self._disarm()
        self._step = step_idx
        self._timer = threading.Timer(self.hang_timeout,
                                      lambda: self.on_hang(self._step))
        self._timer.daemon = True
        self._timer.start()

    def _disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


class _StepCtx:
    def __init__(self, wd: StepWatchdog, idx: int):
        self.wd, self.idx = wd, idx

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.wd._arm(self.idx)
        return self

    def __exit__(self, *exc):
        self.wd._disarm()
        if exc[0] is None:
            self.wd.observe(self.idx, time.perf_counter() - self.t0)
        return False
