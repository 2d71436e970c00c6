"""Depth-limited request admission over the stream runtime.

The paper hides TMU manipulation latency behind TPU compute with ping-pong
buffers (Section VI: 34.6% end-to-end reduction).  This module applies the
same discipline at *request* granularity, but the engine scheduling itself
now lives in :mod:`repro_torch.runtime.streams`: each admitted job's steps are
submitted to the per-engine (TMU/TPU) streams with their dependency edges
expressed as events, so request *i+1*'s TMU phases execute while request *i*
occupies the TPU engine — and, when a job carries a phase DAG, independent
phases of ONE request overlap too.  What remains here is pure admission
policy: at most ``depth`` jobs are in flight (default 2, the ping-pong
pair), exactly like two buffers alternating between fill and drain; the
backlog admits FIFO as jobs complete.

Within one job, steps with no explicit ``deps`` run as a sequential chain
(step k+1 waits step k's event); with ``deps`` they form a DAG and only true
data edges synchronize.  Step errors propagate along dependency edges — the
skipped downstream steps never occupy an engine — and ``on_done(error)``
fires exactly once per job with the original failure.  Completed events feed
:class:`~repro_torch.serving.stats.ServerStats`, whose measured overlap ratio
(from realized event timestamps) is compared against the cycle model's
prediction.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Sequence

from repro_torch.runtime.streams import ENGINE_KINDS, StreamRuntime

__all__ = ["ENGINE_KINDS", "PipelineJob", "RequestPipeline"]

_LOG = logging.getLogger("repro_torch.serving.pipeline")


@dataclasses.dataclass
class PipelineJob:
    """One admitted request (or micro-batch): a step chain or DAG.

    ``steps`` is a list of ``(kind, thunk)`` with kind in ``ENGINE_KINDS``;
    a thunk's work is waited for on its engine's stream thread (a CUDA
    event on the engine's stream, on the card) before the step's event
    completes, so event timestamps measure realized work.  ``deps[i]`` lists the step indices
    step *i* must wait for (all < i); ``deps=None`` means the sequential
    chain ``i-1 -> i``.  ``on_done(error)`` fires exactly once, off the
    admission lock, with None on success or the first failing step's
    exception.  ``step_labels`` overrides the per-step event label
    (default ``{label}#{i}:{kind}``) — the server uses it to name stream
    events ``phase/{index}/{kind}`` so the engine-lane trace spans double
    as the phase spans."""

    steps: list[tuple[str, Callable[[], object]]]
    on_done: Callable[[BaseException | None], None]
    label: str = ""
    deps: Sequence[Sequence[int]] | None = None
    step_labels: Sequence[str] | None = None
    # per-step watchdog deadlines (seconds; None = unbounded) — forwarded to
    # StreamEvent.timeout_s so PhaseWatchdog can poison a hung step
    step_timeouts: Sequence[float | None] | None = None
    # per-step StreamEvent.exclusive (a cooperative launch: busy time, never
    # overlapped time); None = no step is
    step_exclusive: Sequence[bool] | None = None

    def __post_init__(self):
        for kind, _ in self.steps:
            if kind not in ENGINE_KINDS:
                raise ValueError(f"unknown engine kind {kind!r}")
        if self.step_labels is not None and \
                len(self.step_labels) != len(self.steps):
            raise ValueError(f"step_labels length {len(self.step_labels)} "
                             f"!= steps length {len(self.steps)}")
        if self.step_timeouts is not None and \
                len(self.step_timeouts) != len(self.steps):
            raise ValueError(f"step_timeouts length "
                             f"{len(self.step_timeouts)} != steps length "
                             f"{len(self.steps)}")
        if self.deps is not None:
            if len(self.deps) != len(self.steps):
                raise ValueError(f"deps length {len(self.deps)} != "
                                 f"steps length {len(self.steps)}")
            for i, dd in enumerate(self.deps):
                if any(d >= i or d < 0 for d in dd):
                    raise ValueError(
                        f"step {i} deps {tuple(dd)} must reference earlier "
                        f"steps only (stream program order)")


class RequestPipeline:
    """Depth-limited admission of :class:`PipelineJob` DAGs onto the
    TMU/TPU streams of one :class:`~repro_torch.runtime.streams.StreamRuntime`.
    ``device`` (None: the card) is where a self-owned runtime runs."""

    def __init__(self, stats=None, depth: int = 2,
                 runtime: StreamRuntime | None = None, tracer=None,
                 device=None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth
        self.stats = stats
        self.tracer = tracer      # handed to a self-owned StreamRuntime
        self.device = device
        self._ext_runtime = runtime       # caller-owned: never closed here
        self.runtime: StreamRuntime | None = None
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._backlog: list[PipelineJob] = []
        self._in_flight = 0
        self._stop = True                 # not started yet
        self.callback_errors = 0          # on_done callbacks that raised

    # --- lifecycle --------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self.runtime is not None:
                return
            if self._ext_runtime is not None:
                # tap the owner's event flow so stats keep measuring even
                # on a caller-provided runtime (untapped on stop)
                self._ext_runtime.add_observer(self._observe)
                self.runtime = self._ext_runtime
            else:
                self.runtime = StreamRuntime(observer=self._observe,
                                             tracer=self.tracer,
                                             device=self.device)
            self._stop = False

    def stop(self) -> None:
        """Drain backlogged and in-flight jobs, then release the streams."""
        with self._drained:
            if self.runtime is None:
                return
            self._stop = True
            while self._in_flight or self._backlog:
                self._drained.wait(timeout=0.05)
            if self.runtime is None:
                return   # a concurrent stop() finished the release already
            runtime, self.runtime = self.runtime, None
        if self._ext_runtime is None:
            runtime.synchronize()
            runtime.close()
        else:
            runtime.remove_observer(self._observe)

    def _observe(self, event) -> None:
        if self.stats is not None:
            self.stats.record_event(event)

    # --- submission -------------------------------------------------------
    def submit(self, job: PipelineJob) -> None:
        if not job.steps:
            job.on_done(None)
            return
        with self._lock:
            if self._stop or self.runtime is None:
                raise RuntimeError("pipeline is stopped")
            self._backlog.append(job)
            to_launch, runtime = self._admit_locked(), self.runtime
            depth_now = self._in_flight + len(self._backlog)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.counter("pipeline/depth", depth_now, track="server")
        for j in to_launch:   # outside the lock: completion callbacks of an
            self._launch(j, runtime)  # instant job re-enter the admission path

    def depth_in_flight(self) -> int:
        with self._lock:
            return self._in_flight + len(self._backlog)

    def _admit_locked(self) -> list[PipelineJob]:
        """Claim admission slots (bumping ``_in_flight`` under the caller's
        lock); the caller launches the returned jobs after releasing it.
        ``stop()`` cannot release the streams meanwhile — it waits for
        ``_in_flight`` to drain, which now includes these claims."""
        launch = []
        while self._backlog and self._in_flight < self.depth:
            launch.append(self._backlog.pop(0))
            self._in_flight += 1
        return launch

    # --- stream dispatch --------------------------------------------------
    def _launch(self, job: PipelineJob, runtime: StreamRuntime) -> None:
        """Submit every step onto its engine's stream (non-blocking).  The
        job finishes when all its events complete; errors propagate along
        dependency edges, so the first failing step's exception is what
        every poisoned event carries."""
        events = []
        for i, (kind, thunk) in enumerate(job.steps):
            dep_idx = job.deps[i] if job.deps is not None else \
                ((i - 1,) if i else ())
            label = (job.step_labels[i] if job.step_labels is not None
                     else f"{job.label}#{i}:{kind}")
            events.append(runtime.submit(
                kind, thunk, deps=[events[d] for d in dep_idx],
                label=label,
                timeout_s=(job.step_timeouts[i]
                           if job.step_timeouts is not None else None),
                exclusive=(job.step_exclusive is not None
                           and job.step_exclusive[i])))

        # completion accounting: every event either completes (its callback
        # decrements) or is error-aborted below before it ever issued (the
        # abort decrements; a cancelled event never completes).  The first
        # error pulls the job's unissued steps back — they could only
        # produce dead work or, if their poisoned dependency was
        # watchdog-cancelled, wedge the job forever.
        state = {"remaining": len(events), "err": None, "finished": False}
        counter_lock = threading.Lock()

        def on_event_done(ev) -> None:
            first_error = False
            with counter_lock:
                state["remaining"] -= 1
                if ev.error is not None and state["err"] is None:
                    state["err"] = ev.error
                    first_error = True
            if first_error:
                aborted = 0
                for other in events:
                    if other.done or other.cancelled:
                        continue
                    if runtime.try_cancel(other):
                        aborted += 1
                if aborted:
                    with counter_lock:
                        state["remaining"] -= aborted
            with counter_lock:
                if state["remaining"] or state["finished"]:
                    return
                state["finished"] = True
                err = state["err"]
            if err is None:
                err = next((e.error for e in events if e.error is not None),
                           None)
            self._finish(job, err)

        for ev in events:
            ev.add_done_callback(on_event_done)

    def _finish(self, job: PipelineJob, err: BaseException | None) -> None:
        try:
            job.on_done(err)
        except BaseException:  # noqa: BLE001 — a raising completion
            # callback must never kill the stream worker that delivered it
            # (it would stall every later job of this engine), but it must
            # not vanish either: the callback owns future resolution, so a
            # failure here likely strands clients
            _LOG.exception("on_done callback failed for job %r", job.label)
            with self._lock:
                self.callback_errors += 1
        with self._drained:
            self._in_flight -= 1
            # keep admitting during stop(): it drains the backlog, it does
            # not abandon it (submissions are what _stop forbids)
            to_launch, runtime = self._admit_locked(), self.runtime
            depth_now = self._in_flight + len(self._backlog)
            self._drained.notify_all()
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.counter("pipeline/depth", depth_now, track="server")
        for j in to_launch:
            self._launch(j, runtime)
