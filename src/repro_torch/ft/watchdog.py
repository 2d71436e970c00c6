"""Per-phase watchdog over a :class:`~repro_torch.runtime.streams.StreamRuntime`.

A hung phase (a task stuck in an injected hang, a wedged host call) would
otherwise block its engine's stream forever: the worker thread is inside
``task.fn()`` and nothing behind it can make progress.  The watchdog closes
that hole, as the JAX package's ``ft/watchdog.py`` does:

* every stream task carries an optional deadline (``StreamEvent.timeout_s``,
  attached by the server to warm cache hits only: a cold first execution
  includes tracing and would false-trip);
* a monitor thread polls each stream's :meth:`Stream.running_info` and,
  when a running task is past its deadline, calls
  :meth:`Stream.poison_running`: the event completes with
  :class:`PhaseTimeoutError`, the stuck worker is disowned and replaced by
  a fresh one that keeps the engine's ``torch.cuda.Stream`` on the card,
  and the engine keeps serving.  The group's remaining phases fail fast
  through dependency-error propagation, and the server's failure isolation
  takes over.

A watchdog cannot stop a kernel already queued on the card; it never has
to: an injected hang is a host sleep that fires before the task's
launches, and the disowned worker checks its generation before it issues
anything, so a poisoned task launches nothing when it wakes.

Deadlines are scaled from the cycle model: the server calibrates
seconds-per-predicted-cycle from measured phase walls (:meth:`calibrate`)
and :meth:`deadline_for` returns
``max(floor_s, factor * predicted_cycles * s_per_cycle)``.

The liveness primitives of :mod:`repro_torch.runtime.fault_tolerance` are
wired here: the watchdog beats a :class:`Heartbeat` on every completed
event and feeds per-engine :class:`StragglerDetector` instances with
realized phase walls; a flagged slow phase becomes a
``watchdog/slow_phase`` trace instant and a stats counter.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerDetector
from repro_torch.runtime.streams import StreamEvent, StreamRuntime


class PhaseTimeoutError(RuntimeError):
    """A phase exceeded its watchdog deadline and was poisoned."""


class PhaseWatchdog:
    """Deadline enforcement + liveness accounting for one stream runtime.

    ``factor`` is the slowdown multiple over the calibrated predicted wall
    at which a phase counts as hung; ``floor_s`` clamps every deadline from
    below.  ``stats`` (a :class:`~repro_torch.serving.stats.ServerStats`)
    and ``tracer`` are optional sinks.
    """

    def __init__(self, runtime: StreamRuntime, *, floor_s: float = 0.25,
                 factor: float = 20.0, poll_s: float = 0.01,
                 heartbeat_s: float = 30.0, straggler_threshold: float = 3.0,
                 calibration_alpha: float = 0.2,
                 tracer=None, stats=None):
        self.runtime = runtime
        self.floor_s = float(floor_s)
        self.factor = float(factor)
        self.poll_s = float(poll_s)
        self.tracer = tracer
        self.stats = stats
        self.heartbeat = Heartbeat(deadline_s=heartbeat_s)
        self.stragglers: dict[str, StragglerDetector] = {
            engine: StragglerDetector(threshold=straggler_threshold)
            for engine in runtime.streams}
        self.timeouts = 0
        self.slow_phases = 0
        # monotonic time of each poison, for the time to the next phase
        self.poisoned_at: list[float] = []
        self._alpha = float(calibration_alpha)
        self._s_per_cycle: float | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- calibration: cycle model -> wall-clock deadlines ------------------

    def calibrate(self, predicted_cycles: float, measured_s: float) -> None:
        """Fold one (predicted cycles, measured wall) sample into the EWMA
        seconds-per-cycle estimate."""
        if predicted_cycles <= 0 or measured_s <= 0:
            return
        ratio = measured_s / predicted_cycles
        with self._lock:
            if self._s_per_cycle is None:
                self._s_per_cycle = ratio
            else:
                self._s_per_cycle = ((1 - self._alpha) * self._s_per_cycle
                                     + self._alpha * ratio)

    def deadline_for(self, predicted_cycles: float) -> float:
        """The wall-clock budget for a phase the model prices at
        ``predicted_cycles``: the floor until calibrated."""
        with self._lock:
            spc = self._s_per_cycle
        if spc is None or predicted_cycles <= 0:
            return self.floor_s
        return max(self.floor_s, self.factor * predicted_cycles * spc)

    @property
    def s_per_cycle(self) -> float | None:
        with self._lock:
            return self._s_per_cycle

    # -- liveness: completed-event observer --------------------------------

    def _observe(self, event: StreamEvent) -> None:
        self.heartbeat.beat()
        if event.t_start is None or event.t_end is None:
            return  # skipped task: never occupied the engine
        det = self.stragglers.get(event.engine)
        if det is not None and det.record(event.duration_s):
            self.slow_phases += 1
            if self.stats is not None:
                self.stats.record_slow_phase()
            if self.tracer is not None and self.tracer.enabled:
                self.tracer.instant(
                    "watchdog/slow_phase", track="server",
                    label=event.label, engine=event.engine,
                    duration_s=round(event.duration_s, 6),
                    ewma_s=round(det.mean, 6))

    # -- the monitor thread ------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self.runtime.add_observer(self._observe)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._monitor, name="tm-watchdog", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        self.runtime.remove_observer(self._observe)

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            now = time.monotonic()
            for engine, stream in self.runtime.streams.items():
                info = stream.running_info()
                if info is None:
                    continue
                event, t0 = info
                budget = event.timeout_s
                if budget is None or (now - t0) <= budget:
                    continue
                err = PhaseTimeoutError(
                    f"phase {event.label!r} on {engine} exceeded its "
                    f"{budget:.3f}s watchdog deadline "
                    f"(running {now - t0:.3f}s)")
                if stream.poison_running(event, err):
                    self.timeouts += 1
                    self.poisoned_at.append(time.monotonic())
                    if self.stats is not None:
                        self.stats.record_phase_timeout()
                    if self.tracer is not None and self.tracer.enabled:
                        self.tracer.instant(
                            "watchdog/timeout", track="server",
                            label=event.label, engine=engine,
                            budget_s=round(budget, 6))

    def __enter__(self) -> "PhaseWatchdog":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        return {
            "timeouts": self.timeouts,
            "slow_phases": self.slow_phases,
            "s_per_cycle": self.s_per_cycle,
            "seconds_since_beat": round(self.heartbeat.seconds_since_beat(),
                                        6),
            "stalled": self.heartbeat.stalled(),
            "stragglers": {k: {"flagged": d.flagged, "ewma_s": d.mean}
                           for k, d in self.stragglers.items()},
        }
