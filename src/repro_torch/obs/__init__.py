"""Unified observability: span tracing, counters, and Perfetto export.

See :mod:`repro_torch.obs.tracer` for the recorder (and the process's
current tracer, :func:`current` / :func:`use`) and
:mod:`repro_torch.obs.report` for the measured-vs-modeled per-phase join.
``docs/observability.md`` documents the span taxonomy and counter names,
``docs/observability_torch.md`` what the port adds.
"""

from repro_torch.obs.tracer import (NULL_TRACER, NullTracer, SpanRecord, Tracer,
                              as_tracer, current, process_tracer, use)
from repro_torch.obs.report import (PhaseRow, TraceReport, overlap_from_trace,
                              predicted_phase_cycles)

__all__ = [
    "NULL_TRACER", "NullTracer", "SpanRecord", "Tracer", "as_tracer",
    "current", "process_tracer", "use",
    "PhaseRow", "TraceReport", "overlap_from_trace",
    "predicted_phase_cycles",
]
