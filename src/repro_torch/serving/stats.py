"""Serving counters: batching, latency, and pipeline-overlap accounting.

One :class:`ServerStats` instance is shared by the batcher, the compile
cache, and the stream runtime; everything is guarded by a single lock
(counts are tiny compared to the work they describe).  ``snapshot()`` returns
a plain dict — the benchmark rows and the ``/stats`` surface of
:class:`~repro_torch.serving.server.TMServer`.

Overlap accounting is **measured from stream-event timestamps**: every
completed :class:`~repro_torch.runtime.streams.StreamEvent` contributes its
realized busy interval (``t_start``..``t_end``, stamped when the work — not
its dispatch — finished), and the stats reduce the per-engine interval
unions to time with ≥1 engine busy vs. time with both busy.  Idle gaps
between request arrivals therefore never count against the pipeline.  The
measured overlap ratio is the fraction of total busy time hidden by running
the two engines concurrently (0 = fully serialized, →0.5 = perfectly
overlapped equal stages) — directly comparable to the *predicted* ratio the
cycle model emits at admission time
(:func:`repro_torch.serving.server.predict_overlap`).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

# default intervals kept per engine for cross-engine intersection; incoming
# events arrive in near-time order, so anything older than this window cannot
# overlap a new interval in practice (each engine's stream is serial).
# ``ServerStats(recent_intervals=...)`` overrides it; ``dropped_intervals``
# counts window truncations so long soaks can see the measurement degrade.
_RECENT_INTERVALS = 512


def _percentile(sorted_xs: list[float], q: float) -> float:
    """Linear-interpolated quantile of an ascending-sorted sample.

    (Nearest-rank rounding made p99 equal the max for small samples and
    biased mid quantiles; interpolation matches ``numpy.percentile``'s
    default.)"""
    if not sorted_xs:
        return 0.0
    pos = q * (len(sorted_xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_xs) - 1)
    frac = pos - lo
    return sorted_xs[lo] * (1.0 - frac) + sorted_xs[hi] * frac


def latency_percentiles(latencies_s: list[float], prefix: str) -> dict:
    """p50/p95/p99 of a latency sample, keyed ``{prefix}_p{q}_s`` — the
    shared report shape for request and per-decode-step latencies."""
    xs = sorted(latencies_s)
    return {f"{prefix}_p50_s": _percentile(xs, 0.50),
            f"{prefix}_p95_s": _percentile(xs, 0.95),
            f"{prefix}_p99_s": _percentile(xs, 0.99)}


@dataclasses.dataclass
class ServerStats:
    """Mutable, lock-guarded serving counters."""

    requests: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    batched_requests: int = 0          # real rows across all batches
    pad_rows: int = 0                  # synthetic rows added by bucketing

    cold_latency_s: list = dataclasses.field(default_factory=list)
    warm_latency_s: list = dataclasses.field(default_factory=list)
    # admit -> first phase start, per request: the pure scheduling cost, its
    # own percentile series (folded into total latency it was invisible —
    # the tail-latency benchmark gates on it separately)
    queue_delay_s: list = dataclasses.field(default_factory=list)

    predicted_overlap: list = dataclasses.field(default_factory=list)

    # per-engine interval window for the cross-engine intersection; when it
    # truncates (an interval falls off before a counterpart engine interval
    # could intersect it) ``dropped_intervals`` records the loss
    recent_intervals: int = _RECENT_INTERVALS
    dropped_intervals: int = 0

    # --- fault/recovery ledger (repro_torch.ft, docs/robustness.md) -------------
    group_faults: int = 0          # batched groups whose execution failed
    #                                and entered bisect-retry isolation
    isolation_retries: int = 0     # sub-group re-executions charged by it
    rescued_requests: int = 0      # innocents resolved by isolation
    victim_requests: int = 0       # requests that kept their error
    phase_timeouts: int = 0        # watchdog-poisoned hung phases
    slow_phases: int = 0           # straggler-detector flags (no failure)
    degraded_phases: int = 0       # phase-level backend-ladder fallbacks

    def __post_init__(self):
        self._lock = threading.Lock()
        # overlap accounting is INCREMENTAL — O(1) state and snapshot cost
        # regardless of uptime: cumulative busy seconds per engine, the
        # cumulative concurrently-busy seconds (each incoming interval is
        # intersected against the other engine's recent window on record),
        # and the activity span.  Per-engine intervals are disjoint (each
        # stream is serial), so busy seconds are a plain sum.
        self._busy: dict[str, float] = {}
        self._recent: dict[str, deque] = {}
        self._both_busy = 0.0
        # concurrently-busy seconds an exclusive interval (a cooperative
        # launch) took part in: part of the union, never of the overlap
        self._both_exclusive = 0.0
        self._span_start: float | None = None
        self._span_end: float | None = None

    # --- recording --------------------------------------------------------
    def record_submit(self, n: int = 1) -> None:
        with self._lock:
            self.requests += n

    def record_batch(self, size: int, pad: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += size
            self.pad_rows += pad

    def record_done(self, latency_s: float, *, cold: bool,
                    failed: bool = False) -> None:
        with self._lock:
            if failed:  # errors and cancels: counted, kept out of the
                self.failed += 1  # serve-latency percentiles
                return
            self.completed += 1
            (self.cold_latency_s if cold else
             self.warm_latency_s).append(latency_s)

    def record_queue_delay(self, delay_s: float, n: int = 1) -> None:
        """One request's admit→first-phase-start delay (``n`` requests of a
        coalesced group share the batch's first phase start)."""
        with self._lock:
            self.queue_delay_s.extend([delay_s] * n)

    def reset_series(self) -> None:
        """Clear the per-request sample series (latencies, queue delays) —
        benchmarks call this after warmup so percentiles describe only the
        measured window.  Counters and busy-time accounting are kept."""
        with self._lock:
            self.cold_latency_s.clear()
            self.warm_latency_s.clear()
            self.queue_delay_s.clear()

    def record_event(self, event) -> None:
        """Ingest one completed stream event's realized busy interval.

        Skipped tasks (failed dependency — never occupied the engine) carry
        no timestamps and are ignored."""
        if event.t_start is None or event.t_end is None:
            return
        self.record_interval(event.engine, event.t_start, event.t_end,
                             exclusive=getattr(event, "exclusive", False))

    def record_interval(self, engine: str, t_start: float,
                        t_end: float, exclusive: bool = False) -> None:
        with self._lock:
            self._busy[engine] = self._busy.get(engine, 0.0) + \
                (t_end - t_start)
            for other, recent in self._recent.items():
                if other == engine:
                    continue
                # newest-first: once an interval ends before ours starts,
                # every older one does too (per-engine intervals are
                # disjoint and time-ordered)
                for a0, a1, a_excl in reversed(recent):
                    if a1 <= t_start:
                        break
                    both = max(0.0, min(a1, t_end) - max(a0, t_start))
                    if exclusive or a_excl:
                        self._both_exclusive += both
                    else:
                        self._both_busy += both
            recent = self._recent.get(engine)
            if recent is None:
                recent = self._recent[engine] = deque(
                    maxlen=max(1, int(self.recent_intervals)))
            if len(recent) == recent.maxlen:
                # the window truncates: an interval leaves before a late
                # counterpart could intersect it — overlap may under-report
                self.dropped_intervals += 1
            recent.append((t_start, t_end, exclusive))
            if self._span_start is None or t_start < self._span_start:
                self._span_start = t_start
            if self._span_end is None or t_end > self._span_end:
                self._span_end = t_end

    def record_predicted_overlap(self, ratio: float) -> None:
        with self._lock:
            self.predicted_overlap.append(ratio)

    # --- fault/recovery recording -----------------------------------------
    def record_group_fault(self) -> None:
        with self._lock:
            self.group_faults += 1

    def record_isolation_retry(self, n: int = 1) -> None:
        with self._lock:
            self.isolation_retries += n

    def record_rescued(self, n: int = 1) -> None:
        with self._lock:
            self.rescued_requests += n

    def record_victims(self, n: int = 1) -> None:
        with self._lock:
            self.victim_requests += n

    def record_phase_timeout(self) -> None:
        with self._lock:
            self.phase_timeouts += 1

    def record_slow_phase(self) -> None:
        with self._lock:
            self.slow_phases += 1

    def record_degraded_phase(self) -> None:
        with self._lock:
            self.degraded_phases += 1

    # --- derived ----------------------------------------------------------
    def _measure_locked(self) -> dict:
        any_busy = (sum(self._busy.values()) - self._both_busy
                    - self._both_exclusive)
        span = (self._span_end - self._span_start
                if self._span_start is not None
                and self._span_end is not None else 0.0)
        return {
            "engine_busy_s": dict(self._busy),
            "any_busy_s": any_busy,
            "both_busy_s": self._both_busy,
            "overlap_ratio": (self._both_busy / any_busy
                              if any_busy > 0 else 0.0),
            "pipeline_span_s": span,
            "dropped_intervals": self.dropped_intervals,
        }

    def overlap_ratio(self) -> float:
        """Measured: fraction of engine busy time hidden by concurrency,
        from realized event timestamps (idle gaps between requests are
        excluded — only busy time counts)."""
        with self._lock:
            return self._measure_locked()["overlap_ratio"]

    def mean_batch_size(self) -> float:
        with self._lock:
            if not self.batches:
                return 0.0
            return self.batched_requests / self.batches

    def snapshot(self) -> dict:
        with self._lock:
            cold = sorted(self.cold_latency_s)
            warm = sorted(self.warm_latency_s)
            pred = (sum(self.predicted_overlap) / len(self.predicted_overlap)
                    if self.predicted_overlap else 0.0)
            snap = {
                "requests": self.requests,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "pad_rows": self.pad_rows,
                "mean_batch_size": (self.batched_requests / self.batches
                                    if self.batches else 0.0),
                "cold_latency_p50_s": _percentile(cold, 0.5),
                "cold_latency_p95_s": _percentile(cold, 0.95),
                "cold_latency_p99_s": _percentile(cold, 0.99),
                "warm_latency_p50_s": _percentile(warm, 0.5),
                "warm_latency_p95_s": _percentile(warm, 0.95),
                "warm_latency_p99_s": _percentile(warm, 0.99),
                "queue_delays": len(self.queue_delay_s),
                **latency_percentiles(list(self.queue_delay_s),
                                      "queue_delay"),
                "predicted_overlap": pred,
                "group_faults": self.group_faults,
                "isolation_retries": self.isolation_retries,
                "rescued_requests": self.rescued_requests,
                "victim_requests": self.victim_requests,
                "phase_timeouts": self.phase_timeouts,
                "slow_phases": self.slow_phases,
                "degraded_phases": self.degraded_phases,
            }
            snap.update(self._measure_locked())
        return snap
