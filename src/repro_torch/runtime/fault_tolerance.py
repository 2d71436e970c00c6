"""Fault tolerance: heartbeat, straggler detection, supervised restarts.

The JAX package's ``runtime/fault_tolerance.py``, pure host code.  The
failure model: (a) hard loss of a worker, detected by a missed heartbeat
and recovered by a restore; (b) stragglers, healthy but slow workers,
detected as step-time outliers.

In the serving stack the same primitives are wired by
:mod:`repro_torch.ft`: :class:`~repro_torch.ft.PhaseWatchdog` beats a
:class:`Heartbeat` on every completed stream event and feeds a per-engine
:class:`StragglerDetector` with phase wall times (slow phases become trace
instants), and :class:`~repro_torch.serving.decode.DecodeSession` runs both
over decode-step timings.  Every clock is injectable, for tests.
"""

from __future__ import annotations

import dataclasses
import threading
import time


class Heartbeat:
    """Liveness monitor: the loop beats once per step; a watcher flags a
    stall when no beat arrives within ``deadline_s``."""

    def __init__(self, deadline_s: float = 300.0, clock=time.monotonic):
        self.deadline_s = deadline_s
        self._clock = clock   # injectable for tests
        self._last = clock()
        self._lock = threading.Lock()

    def beat(self):
        with self._lock:
            self._last = self._clock()

    def stalled(self) -> bool:
        with self._lock:
            return (self._clock() - self._last) > self.deadline_s

    def seconds_since_beat(self) -> float:
        with self._lock:
            return self._clock() - self._last


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time tracker; flags steps slower than ``threshold`` x the
    running mean."""

    threshold: float = 2.0
    alpha: float = 0.1
    _mean: float = 0.0
    _n: int = 0
    flagged: int = 0

    def record(self, step_time_s: float) -> bool:
        self._n += 1
        if self._n <= 3:  # warmup: compile steps are expected outliers
            self._mean = step_time_s if self._mean == 0 else \
                0.5 * (self._mean + step_time_s)
            return False
        is_straggler = step_time_s > self.threshold * self._mean
        self._mean = (1 - self.alpha) * self._mean + self.alpha * step_time_s
        if is_straggler:
            self.flagged += 1
        return is_straggler

    @property
    def mean(self) -> float:
        """The current EWMA step time (0.0 until the first record)."""
        return self._mean


class RestartSupervisor:
    """Run a step loop with restore-and-retry on failure.

    ``run(loop_fn, restore_fn)`` calls ``loop_fn(*restore_fn())``; on an
    exception it restores and retries, up to ``max_restarts`` times."""

    def __init__(self, max_restarts: int = 3):
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, loop_fn, restore_fn):
        while True:
            try:
                return loop_fn(*restore_fn())
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
