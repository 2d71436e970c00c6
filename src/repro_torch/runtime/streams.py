"""Stream-ordered TMU/TPU dispatch — per-engine submission queues + events.

The paper's 34.6% end-to-end win (Section VI) comes from keeping the TMU and
TPU engines *concurrently* busy; this module is the host-side runtime that
realizes it.  The model is deliberately CUDA-stream-shaped:

* a :class:`Stream` is one engine's submission queue: a dedicated worker
  thread issues the **oldest ready** task — ready-dependency tasks run in
  submission order, and a task whose in-edges are still pending never
  head-blocks the queue (the TMU engine starts request *i+1*'s work while
  request *i* waits on the TPU, the paper's ping-pong discipline);
* a :class:`StreamEvent` is recorded per task.  It completes when the task's
  *work* finishes.  On a CUDA device each engine's worker runs its tasks
  under its own ``torch.cuda.Stream``, records a ``torch.cuda.Event`` there
  after the task and synchronizes it before stamping ``t_end`` — PyTorch's
  launches are asynchronous, so the event, not the return, marks the
  work's end.  Readiness is awaited on the stream's own thread, so it never
  stalls the other engine or the host.  A task is also ordered after
  everything its submitter had queued on its own current stream when it
  submitted (inputs the host stacked, say);
* cross-stream dependencies are expressed as events: a task waits for its
  ``deps`` to complete before it starts.  Independent phases on different
  streams therefore overlap, and the host synchronizes only at true sinks
  (:meth:`StreamRuntime.synchronize`, or waiting a sink event).

A failed task poisons its event; dependents observe the error, skip their
work, and propagate the *original* exception — so a sink wait surfaces the
first failure without deadlocking, and a skipped task never stamps a busy
interval.

Preemption hooks (:mod:`repro_torch.sched`): a **not-yet-issued** task can be
removed from its queue with :meth:`Stream.try_cancel` — its event is marked
``cancelled`` and never completes, so a dependent gated on it can never
issue (and is therefore itself cancellable; the scheduler cancels the whole
dependent suffix and re-submits it later).  A task the worker has already
claimed cannot be cancelled: work is preempted only at task (phase)
boundaries, never mid-kernel.  ``submit(front=True)`` queues a task ahead of
the existing backlog — the deadline-risk path uses it so a preemptor's
phases bypass lower-priority work that was submitted earlier.

:func:`overlap_from_events` turns completed events into the measured
two-engine overlap ratio (both-busy time over any-busy time), directly
comparable to the cycle model's :func:`repro_torch.serving.server.predict_overlap`.
A task submitted ``exclusive`` (a cooperative launch, whose grid holds every
SM it needs at once) counts as busy but never as overlapped: the card cannot
run the other engine's kernels beside it, whatever the host intervals say.

On the CPU (``device="cpu"``) tasks run on the worker threads and nothing
else changes.  ``device=None`` means the card, as everywhere in the port.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, Sequence

import torch

from repro_torch.core.executor import resolve_device

ENGINE_KINDS = ("tmu", "tpu")

_LOG = logging.getLogger("repro_torch.runtime.streams")

# repro_torch.ft.FaultInjector.install() points this at its fire() method; None in
# production — Stream._run pays one attribute load per task
fault_hook: Callable[[str, str], None] | None = None


class StreamError(RuntimeError):
    """Raised when interacting with a closed stream."""


def _report_callback_error(label: str, owner: "Stream | None") -> None:
    _LOG.exception("event done-callback failed for %r", label)
    if owner is not None:
        with owner._cond:
            owner.callback_errors += 1


@dataclasses.dataclass
class StreamEvent:
    """One submitted task's completion marker + timestamps.

    Timestamps are ``time.monotonic()`` seconds.  ``t_start``/``t_end`` stay
    ``None`` for tasks skipped because a dependency failed (they never
    occupied the engine, so they must not count as busy time).
    """

    engine: str
    label: str = ""
    t_submit: float = 0.0
    t_start: float | None = None
    t_end: float | None = None
    error: BaseException | None = None
    result: Any = None
    # set by Stream.try_cancel: the task was dequeued before it ever issued.
    # A cancelled event NEVER completes (wait() would block forever) — its
    # owner drops it and submits a replacement; it stamps no busy interval
    # and reaches no observer, exactly like work that never existed.
    cancelled: bool = False
    # watchdog deadline: once RUNNING for longer than this, PhaseWatchdog
    # poisons the event with PhaseTimeoutError (None = never)
    timeout_s: float | None = None
    # a cooperative launch: busy time, never overlapped time
    exclusive: bool = False

    def __post_init__(self):
        self._done = threading.Event()
        self._callbacks: list[Callable[["StreamEvent"], None]] = []
        self._cb_lock = threading.Lock()
        self._owner: "Stream | None" = None  # set by Stream.submit

    # --- completion -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def duration_s(self) -> float:
        if self.t_start is None or self.t_end is None:
            return 0.0
        return self.t_end - self.t_start

    def wait(self, timeout: float | None = None) -> Any:
        """Block until the task completed; return its result or re-raise its
        (or its failed dependency's) exception."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"event {self.label!r} ({self.engine}) did "
                               f"not complete within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    def add_done_callback(self, cb: Callable[["StreamEvent"], None]) -> None:
        """Run ``cb(self)`` once the event completes (immediately if it
        already has).  Callbacks usually fire on the stream's worker
        thread; exceptions are swallowed (reported to stderr) — a raising
        callback must never kill the worker."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(cb)
                return
        try:
            cb(self)
        except BaseException:  # noqa: BLE001 — see _complete
            _report_callback_error(self.label, self._owner)

    def _complete(self) -> None:
        with self._cb_lock:
            self._done.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except BaseException:  # noqa: BLE001 — a raising callback runs
                # on the stream's worker thread; letting it escape would
                # kill the worker and wedge the whole stream
                _report_callback_error(self.label, self._owner)


@dataclasses.dataclass
class _Task:
    fn: Callable[[], Any]
    deps: tuple[StreamEvent, ...]
    event: StreamEvent
    # CUDA: recorded on the submitter's current stream at submit; the
    # engine's stream waits on it before the task's launches
    ready: Any = None


class Stream:
    """One engine's submission queue, drained by a worker thread.

    Issue order is **oldest-ready**: the worker issues the earliest-submitted
    task whose dependency events have all completed.  A task with pending
    in-edges never head-blocks the queue — exactly the paper's engine
    discipline, where the TMU starts tile *i+1* while the TPU still consumes
    tile *i*.  Tasks with satisfied dependencies therefore run in submission
    order (FIFO), and data ordering is entirely carried by the events, so
    results are deterministic even though issue order is not.

    ``observer(event)`` is called after every completion (including skipped
    tasks) — the serving stats and the event timeline hang off it.

    ``device`` None means the card: the worker then issues its tasks on a
    ``torch.cuda.Stream`` of its own (``cuda_stream``).
    """

    def __init__(self, engine: str,
                 observer: Callable[[StreamEvent], None] | None = None,
                 tracer=None, device=None):
        self.engine = engine
        self.device = resolve_device(device)
        self.cuda_stream = (torch.cuda.Stream(device=self.device)
                            if self.device.type == "cuda" else None)
        self.observer = observer
        # duck-typed repro_torch.obs Tracer (kept import-free: obs.report imports
        # this module's interval helpers); None means tracing off
        self.tracer = tracer
        self._queue: deque[_Task] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._inflight = 0          # popped but not yet completed
        self._running: _Task | None = None   # the task whose fn is executing
        self.callback_errors = 0    # done-callbacks that raised (see _LOG)
        # worker generation: poison_running bumps this and spawns a fresh
        # worker, disowning one stuck in task.fn() — the abandoned thread
        # notices the stale generation when (if) fn returns and exits
        self._gen = 0
        self._thread = threading.Thread(
            target=self._worker, args=(0,),
            name=f"tm-stream-{engine}", daemon=True)
        self._thread.start()

    # --- submission -------------------------------------------------------
    def submit(self, fn: Callable[[], Any],
               deps: Sequence[StreamEvent] = (),
               label: str = "", front: bool = False,
               timeout_s: float | None = None,
               exclusive: bool = False) -> StreamEvent:
        event = StreamEvent(engine=self.engine, label=label,
                            t_submit=time.monotonic(), timeout_s=timeout_s,
                            exclusive=exclusive)
        event._owner = self
        ready = None
        if self.cuda_stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        task = _Task(fn=fn, deps=tuple(deps), event=event, ready=ready)
        with self._cond:
            if self._closed:
                raise StreamError(f"stream {self.engine!r} is closed")
            if front:
                # bypass the backlog: the preemption path queues a
                # deadline-risk job's phases ahead of earlier-submitted
                # lower-priority work (issue order among READY tasks scans
                # from the left)
                self._queue.appendleft(task)
            else:
                self._queue.append(task)
            self._cond.notify_all()
        # a dependency completing (possibly on the OTHER engine's thread)
        # may make this task issuable: poke the worker to re-scan
        for dep in task.deps:
            if not dep.done:
                dep.add_done_callback(self._poke)
        return event

    def _poke(self, _event: StreamEvent) -> None:
        with self._cond:
            self._cond.notify_all()

    def try_cancel(self, event: StreamEvent) -> bool:
        """Remove ``event``'s task from the queue if the worker has not
        claimed it yet.  Returns True on success: the task will never run,
        the event is marked ``cancelled`` and never completes.  Returns
        False when the task already issued (running or done) — preemption
        happens at task boundaries only."""
        with self._cond:
            for i, task in enumerate(self._queue):
                if task.event is event:
                    del self._queue[i]
                    event.cancelled = True
                    self._cond.notify_all()
                    return True
        return False

    def synchronize(self, timeout: float | None = None) -> bool:
        """Block until every submitted task has completed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0 and deadline is not None:
                    return False
                self._cond.wait(timeout=0.05 if left is None
                                else min(left, 0.05))
            return True

    def close(self) -> None:
        """Drain remaining tasks, then stop the worker."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join()

    # --- watchdog / diagnostics -------------------------------------------
    def running_info(self) -> tuple[StreamEvent, float] | None:
        """The currently-executing task's (event, t_start), or None.  The
        watchdog polls this to find tasks past their deadline."""
        with self._cond:
            task = self._running
            if task is None:
                return None
            return task.event, (task.event.t_start or time.monotonic())

    def poison_running(self, event: StreamEvent,
                       error: BaseException) -> bool:
        """Force-complete ``event`` with ``error`` while its fn is still
        executing, and replace the worker thread so the queue keeps
        draining.  Returns False if ``event`` is not the running task (it
        finished, or was never ours) — the caller lost the race and must
        not treat it as hung.

        The abandoned worker is left to finish (Python threads cannot be
        killed); it detects the generation bump when fn returns and exits
        without touching the event or the queue.  Its still-referenced
        result is dropped.
        """
        with self._cond:
            task = self._running
            if task is None or task.event is not event or event.done:
                return False
            event.error = error
            event.t_end = time.monotonic()
            self._running = None
            self._inflight -= 1
            self._gen += 1
            self._thread = threading.Thread(
                target=self._worker, args=(self._gen,),
                name=f"tm-stream-{self.engine}-g{self._gen}", daemon=True)
            self._thread.start()
            self._cond.notify_all()
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.add_span(event.label or "task", self.engine,
                                 event.t_start, event.t_end, ok=False)
        event._complete()
        if self.observer is not None:
            try:
                self.observer(event)
            except BaseException:  # noqa: BLE001 — observers must not kill
                _LOG.exception("stream observer failed for %r", event.label)
        return True

    def pending(self) -> list[dict]:
        """Diagnostic rows for undone work: the running task plus the
        queued backlog (label, engine, state, age in seconds)."""
        now = time.monotonic()
        out: list[dict] = []
        with self._cond:
            run = self._running
            if run is not None:
                out.append({"engine": self.engine, "label": run.event.label,
                            "state": "running",
                            "age_s": now - (run.event.t_start or now)})
            for task in self._queue:
                out.append({"engine": self.engine, "label": task.event.label,
                            "state": "queued",
                            "age_s": now - task.event.t_submit})
        return out

    # --- worker -----------------------------------------------------------
    def _claim_locked(self) -> _Task | None:
        """The oldest task whose in-edges have all signalled (caller holds
        the lock); pending-dep tasks are skipped, never head-block."""
        for i, task in enumerate(self._queue):
            if all(dep.done for dep in task.deps):
                del self._queue[i]
                return task
        return None

    def _worker(self, gen: int) -> None:
        while True:
            with self._cond:
                if gen != self._gen:
                    return  # replaced by poison_running while idle
                task = self._claim_locked()
                while task is None:
                    if self._closed and not self._queue:
                        return
                    self._cond.wait(timeout=0.1)
                    if gen != self._gen:
                        return
                    task = self._claim_locked()
                self._inflight += 1
            if not self._run(task, gen):
                return  # our task was poisoned mid-fn; a fresh worker owns
                #         the queue and poison_running settled the counters
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    def _issue(self, task: _Task) -> Any:
        """Run the task's fn; on the card under this engine's stream, and
        wait for its work there on OUR thread, so t_end is the work's
        completion (a device-event timestamp), not its enqueue; the other
        stream and the host keep running meanwhile."""
        if self.cuda_stream is None:
            return task.fn()
        with torch.cuda.stream(self.cuda_stream):
            if task.ready is not None:
                self.cuda_stream.wait_event(task.ready)
            result = task.fn()
            done = torch.cuda.Event()
            done.record(self.cuda_stream)
        done.synchronize()
        return result

    def _run(self, task: _Task, gen: int) -> bool:
        """Execute one claimed task.  Returns False when the task was
        poisoned (watchdog timeout) while fn was executing — this worker is
        stale and must exit without completing anything."""
        event = task.event
        for dep in task.deps:   # already complete (issue condition); pick
            if dep.error is not None and event.error is None:
                event.error = dep.error   # up the ORIGINAL failure
        if event.error is None:
            with self._cond:
                self._running = task
                event.t_start = time.monotonic()
            result: Any = None
            err: BaseException | None = None
            try:
                hook = fault_hook
                if hook is not None:
                    hook("stream", f"{self.engine}:{event.label}")
                    with self._cond:
                        if gen != self._gen or event.done:
                            # poisoned while the hook hung: a disowned
                            # worker must launch nothing when it wakes
                            return False
                result = self._issue(task)
            except BaseException as e:  # noqa: BLE001 — delivered via event
                err = e
            t_end = time.monotonic()
            with self._cond:
                if gen != self._gen or event.done:
                    # poison_running fired while fn was stuck: the event
                    # already completed with the watchdog's error and a
                    # replacement worker owns the queue — drop the late
                    # result and die quietly
                    return False
                self._running = None
                event.result = result
                event.error = err
                event.t_end = t_end
            if self.tracer is not None and self.tracer.enabled:
                # the realized busy interval, on the ENGINE's track — the
                # exact timestamps the serving stats ingest, so the trace
                # and the overlap accounting share one source of truth
                self.tracer.add_span(
                    event.label or "task", self.engine,
                    event.t_start, event.t_end,
                    ok=event.error is None,
                    **({"exclusive": True} if event.exclusive else {}))
        event._complete()
        if self.observer is not None:
            try:
                self.observer(event)
            except BaseException:  # noqa: BLE001 — observers must not kill
                _LOG.exception("stream observer failed for %r", event.label)
        return True


@dataclasses.dataclass(frozen=True)
class EventRecord:
    """A completed event's timeline entry: timestamps only, never the
    result — the timeline must not pin task outputs (multi-MB activations)
    for the runtime's lifetime."""

    engine: str
    label: str
    t_submit: float
    t_start: float | None
    t_end: float | None
    exclusive: bool = False


class StreamRuntime:
    """The two-engine (TMU/TPU) stream pair + completed-event timeline.

    One runtime is one dispatch domain: the serving pipeline owns one for
    its whole lifetime, a bare ``CompiledTMProgram.run(runtime=...)`` can own
    one per call.  Observers see every completed event (after its record is
    appended to the timeline); ``add_observer`` lets a consumer of a
    caller-provided runtime (the serving pipeline's stats) tap the same
    event flow without replacing the owner's observer.

    ``device`` None means the card: each engine is then one CUDA stream.
    """

    def __init__(self, engines: Iterable[str] = ENGINE_KINDS,
                 observer: Callable[[StreamEvent], None] | None = None,
                 keep_events: int = 4096, tracer=None, device=None):
        self.device = resolve_device(device)
        self._observers: list[Callable[[StreamEvent], None]] = \
            [observer] if observer is not None else []
        self._lock = threading.Lock()
        self.tracer = tracer
        self.events: deque[EventRecord] = deque(maxlen=keep_events)
        self.streams: dict[str, Stream] = {
            kind: Stream(kind, observer=self._on_event, tracer=self.tracer,
                         device=self.device)
            for kind in engines}

    def add_observer(self, cb: Callable[[StreamEvent], None]) -> None:
        with self._lock:
            self._observers.append(cb)

    def remove_observer(self, cb: Callable[[StreamEvent], None]) -> None:
        with self._lock:
            if cb in self._observers:
                self._observers.remove(cb)

    def _on_event(self, event: StreamEvent) -> None:
        with self._lock:
            self.events.append(EventRecord(
                engine=event.engine, label=event.label,
                t_submit=event.t_submit, t_start=event.t_start,
                t_end=event.t_end, exclusive=event.exclusive))
            observers = list(self._observers)
        for cb in observers:
            cb(event)

    def submit(self, engine: str, fn: Callable[[], Any],
               deps: Sequence[StreamEvent] = (),
               label: str = "", front: bool = False,
               timeout_s: float | None = None,
               exclusive: bool = False) -> StreamEvent:
        if engine not in self.streams:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{tuple(self.streams)}")
        return self.streams[engine].submit(fn, deps=deps, label=label,
                                           front=front, timeout_s=timeout_s,
                                           exclusive=exclusive)

    def try_cancel(self, event: StreamEvent) -> bool:
        """Cancel a not-yet-issued task on whichever stream holds it (see
        :meth:`Stream.try_cancel`)."""
        stream = self.streams.get(event.engine)
        return stream.try_cancel(event) if stream is not None else False

    def synchronize(self, timeout: float | None = None) -> bool:
        ok = True
        for stream in self.streams.values():
            ok = stream.synchronize(timeout=timeout) and ok
        return ok

    def close(self) -> None:
        for stream in self.streams.values():
            stream.close()

    def pending(self) -> list[dict]:
        """Undone work across both engines — running + queued task rows
        (engine, label, state, age_s); the drain-timeout diagnostic."""
        rows: list[dict] = []
        for stream in self.streams.values():
            rows.extend(stream.pending())
        return rows

    def callback_errors(self) -> int:
        """Total done-callbacks that raised, across both streams."""
        return sum(s.callback_errors for s in self.streams.values())

    def timeline(self) -> list[EventRecord]:
        with self._lock:
            return list(self.events)

    def overlap(self) -> dict:
        return overlap_from_events(self.timeline())

    def __enter__(self) -> "StreamRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# measured overlap from event timestamps
# ---------------------------------------------------------------------------

def merge_intervals(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def intersect_seconds(a: list[tuple[float, float]],
                   b: list[tuple[float, float]]) -> float:
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_from_events(events: Iterable[StreamEvent | EventRecord]) -> dict:
    """Measured two-engine overlap from realized event timestamps.

    Returns per-engine busy seconds, union busy (``any_busy_s``),
    concurrently-busy (``both_busy_s``) and the overlap ratio
    ``both / any`` — 0 for fully serialized engines, →0.5 as both engines
    stay equally and fully co-busy — the same quantity the cycle model's
    ``predict_overlap`` estimates (``min / (tmu + tpu)``).  An
    ``exclusive`` event's interval counts toward busy and union time but
    never toward ``both_busy_s`` (``exclusive_s`` sums those intervals).
    """
    events = list(events)   # tolerate generators: we iterate twice
    per_engine: dict[str, list[tuple[float, float]]] = {}
    shared: dict[str, list[tuple[float, float]]] = {}
    exclusive_s = 0.0
    for ev in events:
        if ev.t_start is None or ev.t_end is None:
            continue  # skipped (failed-dependency) tasks were never busy
        iv = (ev.t_start, ev.t_end)
        per_engine.setdefault(ev.engine, []).append(iv)
        if getattr(ev, "exclusive", False):
            exclusive_s += ev.t_end - ev.t_start
        else:
            shared.setdefault(ev.engine, []).append(iv)
    merged = {k: merge_intervals(v) for k, v in per_engine.items()}
    busy = {k: sum(t1 - t0 for t0, t1 in v) for k, v in merged.items()}
    lanes = list(merged.values())
    union_both = (intersect_seconds(lanes[0], lanes[1]) if len(lanes) == 2
                  else 0.0)
    any_busy = sum(busy.values()) - union_both
    free = [merge_intervals(shared.get(k, [])) for k in merged]
    both = intersect_seconds(free[0], free[1]) if len(free) == 2 else 0.0
    starts = [iv[0][0] for iv in lanes if iv]
    ends = [iv[-1][1] for iv in lanes if iv]
    return {
        "engine_busy_s": busy,
        "any_busy_s": any_busy,
        "both_busy_s": both,
        "overlap_ratio": both / any_busy if any_busy > 0 else 0.0,
        "span_s": (max(ends) - min(starts)) if starts else 0.0,
        "exclusive_s": exclusive_s,
        "events": sum(1 for ev in events
                      if ev.t_start is not None and ev.t_end is not None),
    }
