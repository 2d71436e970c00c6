"""Lock-cheap, thread-safe tracing — nested spans, counters, Chrome export.

One :class:`Tracer` is the single timeline of a compile/execute/serve run:

* **spans** — ``with tracer.span("compile/trace"): ...`` measures a nested
  region on the calling thread's track; ``add_span`` records an interval
  whose timestamps were stamped elsewhere (a stream event's realized busy
  interval lands on its *engine's* track, so the trace and the serving
  stats share one source of truth).
* **counters** — ``count`` accumulates (kernel launches, HBM bytes, cache
  hits); ``counter`` samples an absolute value (queue depth).  Both emit
  Chrome ``C`` events, so Perfetto draws them as counter tracks over time.
* **instants** — point markers (a request submit).

Everything records ``time.monotonic()`` seconds — the same clock the stream
runtime stamps events with — and is appended under one lock whose critical
section is a single ``list.append``; the recorded payload is built outside
it.  When tracing is off, the module-level :data:`NULL_TRACER` stands in:
every method is a no-op and ``enabled`` is ``False``, so hot paths guard
per-instruction recording with one attribute check.

**Device time.**  A span opened with ``device=`` a CUDA device records a
pair of pooled timing events on the current stream, at open and at close;
``SpanRecord.device_s`` is the time from when the stream reaches the
span's start to when it reaches its end: the span's kernels plus any
idle its own dispatch caused.  It is resolved lazily, by ``spans()`` or
the export, which wait for the end event; nothing on the recording path
waits for the device.  Likewise ``count`` takes a 0-d device tensor and
keeps it, unread, until ``counters()``, ``count_between`` or the export
adds it in.

**The profiler's clock.**  The tracer also reads ``time.time_ns()`` at the
instant of its epoch: :meth:`Tracer.profiler_ns` maps a recorded time to
the nanoseconds ``torch.profiler`` (kineto) stamps its host and device
events with, so a span can be laid against a device trace.

``export_chrome_trace(path)`` writes Chrome-trace JSON (the ``traceEvents``
array format): open it at https://ui.perfetto.dev or ``chrome://tracing``.
Tracks (``tid``) are one per engine/stream/thread, named via ``M``
(metadata) events; spans are complete (``X``) events with microsecond
``ts``/``dur`` relative to the tracer's epoch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

__all__ = ["SpanRecord", "Tracer", "NullTracer", "NULL_TRACER", "as_tracer",
           "current", "process_tracer", "use"]


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span: a named interval on a track."""

    name: str
    track: str                 # engine / stream / thread the span ran on
    t_start: float             # time.monotonic() seconds
    t_end: float
    depth: int = 0             # nesting depth at open (0 = top level)
    args: tuple = ()           # ((key, value), ...) — JSON-safe payload
    overlap_ok: bool = False   # concurrent-lifetime span (request windows):
    # exempt from stack discipline, exported as an async b/e pair
    device_s: float | None = None  # stream time start -> end (None: untimed)

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


class _Span:
    """Context manager returned by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "name", "track", "_args", "t_start", "t_end",
                 "_depth", "_events")

    def __init__(self, tracer: "Tracer", name: str, track: str | None,
                 args: dict, events):
        self._tracer = tracer
        self.name = name
        self.track = track
        self._args = args
        self.t_start = 0.0
        self.t_end = 0.0
        self._depth = 0
        self._events = events      # (start, end) timing events, or None

    def set(self, **args) -> "_Span":
        """Attach args mid-span (stage reports produced inside the region)."""
        self._args.update(args)
        return self

    def __enter__(self) -> "_Span":
        tracer = self._tracer
        stack = tracer._stack()
        if self.track is None:
            # inherit the enclosing span's track so a nested stage stays on
            # its parent's lane; top-level spans land on the thread's track
            self.track = (stack[-1].track if stack
                          else threading.current_thread().name)
        self._depth = len(stack)
        stack.append(self)
        if self._events is not None:
            self._events[0].record()
        self.t_start = tracer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        tracer = self._tracer
        self.t_end = tracer._clock()
        if self._events is not None:
            self._events[1].record()
        stack = tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tracer._record((self.name, self.track, self.t_start, self.t_end,
                        self._depth, tuple(self._args.items()), False,
                        self._events))
        return False


class Tracer:
    """Thread-safe span/counter/instant recorder with Chrome-trace export.

    ``detail`` picks the recording granularity: ``"phase"`` (default) spans
    compile stages, phases, requests and stream intervals; ``"instr"``
    additionally records per-TM-instruction and per-chain spans inside every
    TMU phase — a much denser timeline, for drilling into one program rather
    than watching a serving run."""

    enabled = True
    DETAILS = ("phase", "instr")

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 detail: str = "phase"):
        if detail not in self.DETAILS:
            raise ValueError(f"unknown detail {detail!r}; "
                             f"expected one of {self.DETAILS}")
        self.detail = detail
        self._clock = clock
        self.t0 = clock()
        self.t0_ns = time.time_ns()   # the profiler's clock at ``t0``
        self._lock = threading.Lock()
        # raw span tuples (SpanRecord field order) — building the frozen
        # dataclass on record costs ~5x the append, so the hot path stores
        # tuples and ``spans()`` materializes records lazily; the last
        # field holds a span's timing events until they are resolved
        self._spans: list[tuple] = []
        self._timed: list[int] = []             # spans with events pending
        self._pool: list = []                   # resolved timing events
        self._instants: list[tuple] = []        # (name, track, t, args)
        self._counter_events: list[tuple] = []  # (name, track, t, value)
        self._counters: dict[str, float] = {}   # cumulative totals
        self._device_counts: list[tuple] = []   # (name, track, t, tensor)
        self._tls = threading.local()

    def profiler_ns(self, t: float) -> int:
        """Recorded time ``t`` (``time.monotonic()`` seconds) on the
        profiler's clock: Unix-epoch nanoseconds, as kineto stamps its
        events."""
        return self.t0_ns + round((t - self.t0) * 1e9)

    # --- recording --------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, rec: tuple) -> None:
        with self._lock:
            if rec[-1] is not None:
                self._timed.append(len(self._spans))
            self._spans.append(rec)

    def _event_pair(self, device):
        """Two timing events for a span on ``device``, or None where the
        span is not timed there (not a CUDA device, or a stream capturing
        a graph, which may hold no timing event)."""
        if device is None:
            return None
        if not isinstance(device, torch.device):
            device = torch.device(device)
        if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return None
        pool = self._pool
        return tuple(pool.pop() if pool else
                     torch.cuda.Event(enable_timing=True) for _ in range(2))

    def span(self, name: str, track: str | None = None, device=None,
             **args) -> _Span:
        """Open a nested span on this thread (``track=None`` inherits the
        enclosing span's track, else the thread's name).  With ``device``
        a CUDA device the span is also timed on its current stream."""
        return _Span(self, name, track, args, self._event_pair(device))

    def add_span(self, name: str, track: str, t_start: float, t_end: float,
                 overlap_ok: bool = False, **args) -> None:
        """Record a completed interval stamped elsewhere (stream events,
        request latencies) — it joins ``track`` without nesting.  Pass
        ``overlap_ok=True`` for intervals with concurrent lifetimes on one
        track (in-flight request windows): they skip the stack-discipline
        check and export as Chrome async events."""
        self._record((name, track, t_start, t_end, 0,
                      tuple(args.items()), overlap_ok, None))

    def instant(self, name: str, track: str | None = None, **args) -> None:
        t = self._clock()
        if track is None:
            track = threading.current_thread().name
        with self._lock:
            self._instants.append((name, track, t, tuple(args.items())))

    def count(self, name: str, delta=1.0, track: str = "counters") -> None:
        """Accumulate ``delta`` into counter ``name`` and emit the running
        total as a counter sample (a rising Perfetto counter track).
        ``delta`` may be a 0-d tensor (a DTensor counts this rank's local
        value): it is kept as it is, with no kernel and no wait, and added
        in when the counters are read.  A counter takes host deltas or
        tensors, not both."""
        t = self._clock()
        if isinstance(delta, torch.Tensor):
            delta = (delta.to_local() if isinstance(delta, DTensor)
                     else delta).detach()
            with self._lock:
                self._device_counts.append((name, track, t, delta))
            return
        with self._lock:
            total = self._counters.get(name, 0.0) + delta
            self._counters[name] = total
            self._counter_events.append((name, track, t, total))

    def counter(self, name: str, value: float,
                track: str = "counters") -> None:
        """Sample an absolute value (queue depth, in-flight jobs)."""
        t = self._clock()
        with self._lock:
            self._counters[name] = value
            self._counter_events.append((name, track, t, value))

    def reset(self) -> None:
        """Drop everything recorded.  The timing events of dropped spans go
        back to the pool: each is recorded anew before it is read again."""
        with self._lock:
            self._pool.extend(ev for t in self._spans
                              if isinstance(t[-1], tuple) for ev in t[-1])
            self._spans, self._timed, self._instants = [], [], []
            self._counter_events, self._device_counts = [], []
            self._counters = {}

    # --- introspection ----------------------------------------------------
    def _fold_counts(self) -> None:
        """Add the tensors ``count`` kept into their counters' totals and
        samples (reading each waits for the kernel that made it)."""
        with self._lock:
            pending, self._device_counts = self._device_counts, []
        values = [float(delta) for *_, delta in pending]
        with self._lock:
            for (name, track, t, _), value in zip(pending, values):
                total = self._counters.get(name, 0.0) + value
                self._counters[name] = total
                self._counter_events.append((name, track, t, total))

    def _resolve(self) -> list[tuple]:
        """The raw spans with every span's timing events turned into its
        device seconds (waiting for each end event) and pooled again."""
        with self._lock:
            timed, self._timed = self._timed, []
            pending = [(i, self._spans[i][-1]) for i in timed]
        done = []
        for i, (start, end) in pending:
            end.synchronize()
            done.append((i, start.elapsed_time(end) * 1e-3))
        with self._lock:
            for i, device_s in done:
                self._spans[i] = self._spans[i][:-1] + (device_s,)
            self._pool.extend(ev for _, pair in pending for ev in pair)
            raw = list(self._spans)
        # a span closed since the first lock stays pending until next time
        return [t[:-1] + (None,) if isinstance(t[-1], tuple) else t
                for t in raw]

    def spans(self, prefix: str | None = None,
              track: str | None = None) -> list[SpanRecord]:
        raw = self._resolve()
        if prefix is not None:
            raw = [t for t in raw if t[0].startswith(prefix)]
        if track is not None:
            raw = [t for t in raw if t[1] == track]
        return [SpanRecord(*t) for t in raw]

    def counters(self) -> dict[str, float]:
        """Final cumulative/sampled value per counter name."""
        self._fold_counts()
        with self._lock:
            return dict(self._counters)

    def count_between(self, name: str, t_from: float, t_to: float) -> float:
        """What ``count`` added to counter ``name`` from ``t_from`` to
        ``t_to`` (recorded times): its total at the last sample up to
        ``t_to`` less its total at the last one before ``t_from``."""
        self._fold_counts()
        with self._lock:
            samples = [(t, v) for n, _, t, v in self._counter_events
                       if n == name]
        before = [v for t, v in samples if t < t_from]
        upto = [v for t, v in samples if t <= t_to]
        return (upto[-1] if upto else 0.0) - (before[-1] if before else 0.0)

    def tracks(self) -> list[str]:
        with self._lock:
            seen: dict[str, None] = {}
            for t in self._spans:
                seen.setdefault(t[1])
            for _, track, _, _ in self._instants:
                seen.setdefault(track)
        return list(seen)

    def nesting_errors(self, eps: float = 1e-9) -> list[str]:
        """Integrity check: no negative durations, and spans on one track
        either nest fully or are disjoint (stack discipline).  Explicit
        ``add_span`` intervals (engine busy intervals) are depth-0 siblings
        and may legitimately abut; only *partial* overlap of a span with an
        enclosing open span is an error."""
        errors = []
        spans = self.spans()
        for s in spans:
            if s.t_end < s.t_start - eps:
                errors.append(f"negative duration: {s.name} on {s.track} "
                              f"({s.t_start}..{s.t_end})")
        by_track: dict[str, list[SpanRecord]] = {}
        for s in spans:
            if not s.overlap_ok:
                by_track.setdefault(s.track, []).append(s)
        for track, ss in by_track.items():
            ss.sort(key=lambda s: (s.t_start, -s.t_end))
            stack: list[SpanRecord] = []
            for s in ss:
                while stack and stack[-1].t_end <= s.t_start + eps:
                    stack.pop()
                if stack and s.t_end > stack[-1].t_end + eps:
                    errors.append(
                        f"partial overlap on {track}: {s.name} "
                        f"({s.t_start:.6f}..{s.t_end:.6f}) escapes "
                        f"{stack[-1].name} (..{stack[-1].t_end:.6f})")
                stack.append(s)
        return errors

    # --- Chrome-trace / Perfetto export -----------------------------------
    def _tid_map(self, tracks: list[str]) -> dict[str, int]:
        # engines first so the TMU/TPU lanes sit at the top of the view
        ordered = sorted(tracks, key=lambda t: (t not in ("tmu", "tpu"), t))
        return {track: i for i, track in enumerate(ordered)}

    def chrome_trace(self) -> dict:
        """The trace as a Chrome-trace dict (``{"traceEvents": [...]}``).
        A device-timed span carries ``device_ms`` among its args;
        ``otherData.profiler_ns_at_ts0`` is the profiler's clock at ``ts``
        0, to overlay the spans on a ``torch.profiler`` export."""
        spans = self._resolve()
        self._fold_counts()
        with self._lock:
            instants = list(self._instants)
            counter_events = list(self._counter_events)
        t0 = self.t0
        tracks: dict[str, None] = {}
        for t in spans:
            tracks.setdefault(t[1])
        for _, track, _, _ in instants:
            tracks.setdefault(track)
        for _, track, _, _ in counter_events:
            tracks.setdefault(track)
        tid = self._tid_map(list(tracks))
        events: list[dict] = []
        for track, i in tid.items():
            events.append({"ph": "M", "pid": 1, "tid": i,
                           "name": "thread_name", "args": {"name": track}})
        for i, (name, track, t_start, t_end, _depth, args,
                overlap_ok, device_s) in enumerate(spans):
            if overlap_ok:
                # concurrent lifetimes on one track: an async begin/end pair
                # (grouped by cat+id) renders overlap correctly in Perfetto
                common = {"pid": 1, "tid": tid[track], "name": name,
                          "cat": name.split("/", 1)[0], "id": i + 1}
                events.append({**common, "ph": "b",
                               "ts": (t_start - t0) * 1e6,
                               "args": dict(args)})
                events.append({**common, "ph": "e",
                               "ts": (t_end - t0) * 1e6})
                continue
            if device_s is not None:
                args += (("device_ms", device_s * 1e3),)
            events.append({"ph": "X", "pid": 1, "tid": tid[track],
                           "name": name, "cat": name.split("/", 1)[0],
                           "ts": (t_start - t0) * 1e6,
                           "dur": max(0.0, (t_end - t_start) * 1e6),
                           "args": dict(args)})
        for name, track, t, args in instants:
            events.append({"ph": "i", "pid": 1, "tid": tid[track],
                           "name": name, "s": "t",
                           "ts": (t - t0) * 1e6, "args": dict(args)})
        for name, track, t, value in counter_events:
            events.append({"ph": "C", "pid": 1, "tid": tid[track],
                           "name": name, "ts": (t - t0) * 1e6,
                           "args": {"value": value}})
        events.sort(key=lambda e: e.get("ts", -1.0))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"profiler_ns_at_ts0": self.t0_ns}}

    def export_chrome_trace(self, path: str) -> dict:
        """Write the Chrome-trace JSON to ``path`` and return the dict."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


class NullTracer:
    """The default no-op tracer: every record is skipped, ``enabled`` is
    False so per-instruction hot paths pay one attribute check."""

    enabled = False
    detail = "phase"

    class _NullSpan:
        __slots__ = ()

        def set(self, **args) -> "NullTracer._NullSpan":
            return self

        def __enter__(self) -> "NullTracer._NullSpan":
            return self

        def __exit__(self, *exc) -> bool:
            return False

    _SPAN = _NullSpan()

    def span(self, name: str, track: str | None = None, device=None,
             **args):
        return self._SPAN

    def add_span(self, name: str, track: str, t_start: float, t_end: float,
                 overlap_ok: bool = False, **args) -> None:
        pass

    def instant(self, name: str, track: str | None = None, **args) -> None:
        pass

    def count(self, name: str, delta=1.0, track: str = "counters") -> None:
        pass

    def counter(self, name: str, value: float,
                track: str = "counters") -> None:
        pass

    def spans(self, prefix: str | None = None,
              track: str | None = None) -> list[SpanRecord]:
        return []

    def counters(self) -> dict[str, float]:
        return {}

    def count_between(self, name: str, t_from: float, t_to: float) -> float:
        return 0.0

    def tracks(self) -> list[str]:
        return []

    def nesting_errors(self, eps: float = 1e-9) -> list[str]:
        return []

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> dict:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace


NULL_TRACER = NullTracer()


# --- the process's current tracer ------------------------------------------

_current: Tracer | NullTracer | None = None
_process = Tracer()
_in_session = False     # the process tracer records a running session


@contextlib.contextmanager
def use(tracer: Tracer | NullTracer):
    """Make ``tracer`` the process's current one (:func:`current`) inside
    the block.  It is a module global, not a thread-local: autograd's
    device thread recomputes checkpointed layers, and their spans belong to
    the step that runs the backward.  So one traced caller at a time."""
    global _current
    before, _current = _current, tracer
    try:
        yield tracer
    finally:
        _current = before


def current() -> Tracer | NullTracer:
    """The tracer that :func:`use` set; with none set, the process tracer
    (:func:`process_tracer`) while a ``torch.profiler`` session records,
    else :data:`NULL_TRACER`.  So every profiled run of the port carries
    its own spans, with no knob.  The first call of a session clears what
    the process tracer holds of the last one, so it holds one session at
    most (two sessions with no call between them make one)."""
    global _in_session
    if _current is not None:
        return _current
    if torch.autograd._profiler_enabled():
        if not _in_session:
            _process.reset()
            _in_session = True
        return _process
    _in_session = False
    return NULL_TRACER


def process_tracer() -> Tracer:
    """The tracer :func:`current` gives while a profiler records: it holds
    the latest profiler session's spans and counters until the next
    session begins."""
    return _process


def as_tracer(value: Any) -> Tracer | NullTracer:
    """Normalize a user-facing trace knob: ``None``/``False`` -> the no-op
    tracer, ``True`` -> a fresh :class:`Tracer`, a tracer -> itself."""
    if value is None or value is False:
        return NULL_TRACER
    if value is True:
        return Tracer()
    return value
