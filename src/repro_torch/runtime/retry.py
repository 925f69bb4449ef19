"""Bounded retry around a training step — node-failure containment (a copy
of `repro/runtime/retry.py`, :15-33).

On real fleets a dead host raises a collective error on every peer; the
controller restores the last checkpoint and resumes on the surviving mesh.
`retry_step` implements the per-step half: catch, back off, re-run a step
factory (which may rebuild donated buffers from the last known-good state).
`SimulatedFailure` lets tests inject failures deterministically.
"""
from __future__ import annotations

import time
from typing import Callable, Tuple, Type


class SimulatedFailure(RuntimeError):
    """Injected device/host failure for tests and chaos drills."""


def retry_step(fn: Callable[[], any], *, retries: int = 2,
               backoff_s: float = 0.01,
               retry_on: Tuple[Type[BaseException], ...] = (SimulatedFailure,),
               on_retry: Callable[[int, BaseException], None] = None):
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2 ** (attempt - 1)))
