"""Unified observability: span tracing, counters, and Perfetto export.

See :mod:`repro_torch.obs.tracer` for the recorder and
:mod:`repro_torch.obs.report` for the measured-vs-modeled per-phase join.
``docs/observability.md`` documents the span taxonomy and counter names.
"""

from repro_torch.obs.tracer import (NULL_TRACER, NullTracer, SpanRecord, Tracer,
                              as_tracer)
from repro_torch.obs.report import (PhaseRow, TraceReport, overlap_from_trace,
                              predicted_phase_cycles)

__all__ = [
    "NULL_TRACER", "NullTracer", "SpanRecord", "Tracer", "as_tracer",
    "PhaseRow", "TraceReport", "overlap_from_trace",
    "predicted_phase_cycles",
]
