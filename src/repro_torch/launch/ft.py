"""Fault-tolerance runtime: preemption handling, straggler detection,
restart-with-backoff.

A copy of `repro/launch/ft.py`, which imports nothing but the standard
library; the port never imports the reference package.  On one device the
train loop is its own coordinator.

Pieces:
  * PreemptionGuard — SIGTERM/SIGINT -> drain flag; the train loop checkpoints
    and exits cleanly at the next step boundary (cluster eviction contract).
  * StepTimer — EWMA step-time model + straggler flags.  On a real pod a
    straggler shows up as a slow step for EVERYONE (SPMD lockstep), so the
    mitigation is coordinator-side: flag, log, and (if persistent) request a
    re-slice — here that surfaces as `should_reshard()`.
  * run_with_restarts — supervisor that restarts the step loop from the last
    checkpoint on failure with exponential backoff (node-failure recovery;
    exercised in tests with injected faults).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable


class PreemptionGuard:
    """SIGTERM/SIGINT -> drain.  Use as a context manager around the loop."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._old = {}
        self.draining = False

    def _handler(self, signum, frame):
        self.draining = True

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            signal.signal(s, old)
        return False


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    ewma: float
    is_straggler: bool


class StepTimer:
    """EWMA step-time tracker; a step > `threshold` x EWMA is a straggler."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma: float | None = None
        self.count = 0
        self.straggler_steps: list[int] = []
        self._consecutive = 0

    def record(self, step: int, seconds: float) -> StepStats:
        self.count += 1
        if self.ewma is None:
            self.ewma = seconds
        straggler = (
            self.count > self.warmup and seconds > self.threshold * self.ewma
        )
        if straggler:
            self.straggler_steps.append(step)
            self._consecutive += 1
        else:
            self._consecutive = 0
            # stragglers are excluded from the EWMA (they are anomalies)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return StepStats(step, seconds, self.ewma, straggler)

    def should_reshard(self, patience: int = 5) -> bool:
        """Persistent slowness -> the coordinator should drop/replace the slow
        host and resume on a smaller mesh (elastic path, checkpoint/store.py)."""
        return self._consecutive >= patience


def run_with_restarts(
    make_loop: Callable[[], int],
    max_restarts: int = 3,
    backoff_s: float = 0.5,
    on_restart: Callable[[int, Exception], None] | None = None,
) -> int:
    """Supervisor: run `make_loop()` (returns final step); on exception,
    restart (the loop re-resolves its start step from the checkpoint store).
    """
    attempt = 0
    while True:
        try:
            return make_loop()
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any worker failure
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            time.sleep(backoff_s * (2 ** (attempt - 1)))
