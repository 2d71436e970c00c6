"""``TraceReport`` — measured-vs-modeled per-phase accounting from a trace.

The calibration loop (ROADMAP: fit ``CycleParams`` against measured
timings) needs one table: for every phase of a compiled program, the wall
time its ``phase/{index}/{kind}`` spans actually measured next to the
cycles the analytic model predicted.  This module joins the two:

* **measured** — the tracer's phase spans (``phase/3/tmu`` named by
  :meth:`~repro_torch.compiler.api.CompiledTMProgram.run_phase`), summed per
  phase across executions;
* **modeled** — per-phase predicted cycles: a TMU phase's scheduled
  (forwarded, or chained when pinned) cycles, a TPU phase's data-movement
  proxy (inputs+outputs through the port — the same proxy
  :func:`repro_torch.serving.server.predict_cycles` totals program-wide).

``overlap()`` reduces the trace's *engine-track* spans (the stream events'
realized busy intervals) to the same both-busy/any-busy ratio
:class:`~repro_torch.serving.stats.ServerStats` measures — the two must agree,
they are the same intervals through two pipelines.
"""

from __future__ import annotations

import dataclasses

from repro_torch.compiler.ir import itemsize
from repro_torch.runtime.streams import intersect_seconds, merge_intervals

__all__ = ["PhaseRow", "TraceReport", "predicted_phase_cycles"]


def _nbytes(graph, name: str) -> int:
    buf = graph.buffers[name]
    n = itemsize(buf.dtype)
    for d in buf.shape:
        n *= int(d)
    return n


def predicted_phase_cycles(compiled, *, fuse_chains: bool = False,
                           ) -> dict[int, float]:
    """Cycle-model prediction per phase index of ``compiled``.

    TMU phases report their scheduled cycles (chained when ``fuse_chains``
    pins megakernel execution, so the prediction describes the execution
    shape that runs); TPU phases report the data-movement floor — every
    node's inputs+outputs through the port at ``bandwidth_bytes``/cycle."""
    from repro_torch.core.schedule import CycleParams

    params = compiled.params or CycleParams()
    out: dict[int, float] = {}
    for phase in compiled.partition_report.phases:
        if phase.kind == "tmu":
            sched = phase.schedule
            out[phase.index] = (sched.chained_cycles if fuse_chains
                                else sched.forwarded_cycles)
        else:
            cycles = 0.0
            for i in phase.node_indices:
                node = compiled.graph.nodes[i]
                for name in tuple(node.src_names) + tuple(node.dst_names):
                    if name is not None:
                        cycles += (_nbytes(compiled.graph, name)
                                   / params.bandwidth_bytes)
            out[phase.index] = cycles
    return out


@dataclasses.dataclass(frozen=True)
class PhaseRow:
    """One phase's measured-vs-modeled join."""

    phase: int
    kind: str                # "tmu" | "tpu"
    engine: str
    executions: int          # phase spans observed in the trace
    measured_s: float        # summed span wall time
    mean_s: float
    predicted_cycles: float
    measured_share: float    # of total measured phase time
    predicted_share: float   # of total predicted cycles

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TraceReport:
    """Measured-vs-modeled per-phase table + trace-derived overlap."""

    rows: list[PhaseRow]
    tracer: object = None     # the source tracer (kept for overlap())

    @staticmethod
    def from_tracer(tracer, compiled, *, fuse_chains: bool = False,
                    ) -> "TraceReport":
        """Join ``tracer``'s phase spans against ``compiled``'s cycle model.

        Phases never observed in the trace still get a row (0 executions),
        so a gap — a phase the workload never exercised — is visible rather
        than silently absent."""
        predicted = predicted_phase_cycles(compiled, fuse_chains=fuse_chains)
        measured: dict[int, list[float]] = {i: [] for i in predicted}
        for span in tracer.spans(prefix="phase/"):
            parts = span.name.split("/")
            try:
                idx = int(parts[1])
            except (IndexError, ValueError):
                continue
            if idx in measured:
                measured[idx].append(span.duration_s)
        total_meas = sum(sum(v) for v in measured.values()) or 1.0
        total_pred = sum(predicted.values()) or 1.0
        rows = []
        for phase in compiled.partition_report.phases:
            walls = measured[phase.index]
            meas = sum(walls)
            rows.append(PhaseRow(
                phase=phase.index, kind=phase.kind, engine=phase.engine,
                executions=len(walls), measured_s=meas,
                mean_s=meas / len(walls) if walls else 0.0,
                predicted_cycles=predicted[phase.index],
                measured_share=meas / total_meas,
                predicted_share=predicted[phase.index] / total_pred))
        return TraceReport(rows=rows, tracer=tracer)

    # --- views ------------------------------------------------------------
    def table(self) -> list[dict]:
        """JSON-safe rows — what the benchmarks embed in ``BENCH_*.json``."""
        return [r.as_dict() for r in self.rows]

    def covered(self) -> bool:
        """True when every phase was executed at least once in the trace."""
        return all(r.executions > 0 for r in self.rows)

    def summary(self) -> str:
        lines = [f"{'phase':>5s} {'kind':>4s} {'runs':>5s} "
                 f"{'measured':>11s} {'meas%':>7s} "
                 f"{'modeled cyc':>12s} {'model%':>7s}"]
        for r in self.rows:
            lines.append(
                f"{r.phase:>5d} {r.kind:>4s} {r.executions:>5d} "
                f"{r.measured_s * 1e3:>9.2f}ms {r.measured_share:>7.1%} "
                f"{r.predicted_cycles:>12.0f} {r.predicted_share:>7.1%}")
        return "\n".join(lines)

    def overlap(self) -> dict:
        """Both-busy/any-busy ratio from the trace's engine tracks — the
        stream events' realized busy intervals, i.e. the same quantity
        :meth:`ServerStats.overlap_ratio` accumulates."""
        return overlap_from_trace(self.tracer)


def overlap_from_trace(tracer, engines: tuple[str, ...] = ("tmu", "tpu"),
                       ) -> dict:
    """Reduce engine-track spans to measured two-engine overlap.  A span
    marked ``exclusive`` (a cooperative launch) is busy time but never
    overlapped time, as in
    :func:`~repro_torch.runtime.streams.overlap_from_events`."""
    lanes, free = [], []
    busy = {}
    for engine in engines:
        spans = tracer.spans(track=engine)
        merged = merge_intervals([(s.t_start, s.t_end) for s in spans])
        lanes.append(merged)
        free.append(merge_intervals([(s.t_start, s.t_end) for s in spans
                                     if not s.arg("exclusive", False)]))
        busy[engine] = sum(t1 - t0 for t0, t1 in merged)
    union_both = (intersect_seconds(lanes[0], lanes[1]) if len(lanes) == 2
                  else 0.0)
    any_busy = sum(busy.values()) - union_both
    both = intersect_seconds(free[0], free[1]) if len(free) == 2 else 0.0
    return {
        "engine_busy_s": busy,
        "any_busy_s": any_busy,
        "both_busy_s": both,
        "overlap_ratio": both / any_busy if any_busy > 0 else 0.0,
    }
