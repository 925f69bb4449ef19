"""Preemption handling: SIGTERM -> checkpoint-then-exit (a copy of
`repro/runtime/preemption.py`, :14).

Cloud TPU/TRN fleets send a grace signal before reclaiming a node; the
handler flips an event the training loop polls at step boundaries, writes a
final checkpoint and exits cleanly so the job controller can reschedule.
"""
from __future__ import annotations

import signal
import threading
from typing import Callable, Optional


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1)):
        self._event = threading.Event()
        self._prev = {}
        self.signals = signals

    def install(self):
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._handle)
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _handle(self, signum, frame):
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def trigger(self):            # test hook
        self._event.set()

    def run_until_preempted(self, loop_body: Callable[[int], None],
                            on_exit: Callable[[int], None],
                            start_step: int = 0, max_steps: int = 10 ** 9):
        step = start_step
        while step < max_steps and not self.preempted:
            loop_body(step)
            step += 1
        on_exit(step)
        return step
