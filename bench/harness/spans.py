"""The program's own spans and counters over the traced part of a window.

The port records them on its process tracer
(``repro_torch.obs.process_tracer()``) while ``torch.profiler`` records,
so the traced part of a run carries them with no knob: ``train/step``
holding ``train/forward``, ``train/backward`` and ``train/optimizer``,
the MoE block's ``moe/route``, ``moe/dispatch``, ``moe/experts`` and
``moe/combine`` (twice a step under a recomputed layer), and the counters
``moe/slots`` and ``moe/live_slots``.  A span's ``device_s`` is its time
on the stream, start to end; its host times map onto the profiler's clock
(:meth:`Tracer.profiler_ns`), where the device trace's gaps lie.  Each
function returns None where the program records no such thing (a program
without the process tracer, a CPU run).
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

NO_SPAN = "(no span)"


def tracer():
    """The program's process tracer, or None where it has none."""
    try:
        from repro_torch.obs import process_tracer
    except ImportError:
        return None
    return process_tracer()


def _traced(r):
    """(tracer, traced part) of a run whose traced part has steps."""
    part = r.parts["traced"]
    if not part.steps:
        return None, None
    tr = tracer()
    return (tr, part) if tr is not None else (None, None)


def traced_spans(r, names):
    """The spans named ``names`` that lie inside the traced part."""
    tr, part = _traced(r)
    if tr is None:
        return []
    return [s for s in tr.spans() if s.name in names
            and part.t0 <= s.t_start and s.t_end <= part.t1]


def device_ms_per_step(r, *names):
    """Device milliseconds of the spans named ``names`` a traced step, or
    None where there are none or one was not timed on the device."""
    spans = traced_spans(r, names)
    if not spans or any(s.device_s is None for s in spans):
        return None
    return 1e3 * sum(s.device_s for s in spans) / \
        len(r.parts["traced"].steps)


def counted(r, name: str):
    """What the program counted under ``name`` during the traced part."""
    tr, part = _traced(r)
    if tr is None:
        return None
    return tr.count_between(name, part.t0, part.t1)


def idle_by_span(r):
    """``(by_name, per_step)``: the device idle in seconds after the
    traced part's first ``train/step`` span, each gap between device
    operations put down to the innermost span (the latest-started, on any
    thread) open at the gap's middle on the profiler's clock; and the
    idle whose middle falls inside each later ``train/step`` span, one
    entry a step.  The first traced step is left out: it carries the
    profiler's own start.  None where fewer than two steps were traced."""
    tr, part = _traced(r)
    t = r.trace_data
    if tr is None or t is None or not t.intervals:
        return None
    spans = sorted((tr.profiler_ns(s.t_start), tr.profiler_ns(s.t_end),
                    s.name) for s in tr.spans()
                   if part.t0 <= s.t_start and s.t_end <= part.t1)
    steps = [s for s in spans if s[2] == "train/step"]
    if len(steps) < 2:
        return None
    after, steps = steps[0][1], steps[1:]
    starts = [s[0] for s in steps]
    by_name, per_step = defaultdict(float), [0.0] * len(steps)
    for (_, a1), (b0, _) in zip(t.intervals, t.intervals[1:]):
        mid, gap = (a1 + b0) // 2, (b0 - a1) * 1e-9
        if mid <= after:
            continue
        by_name[_innermost(spans, mid)] += gap
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and steps[i][1] >= mid:
            per_step[i] += gap
    return dict(by_name), per_step


def _innermost(spans, t: int) -> str:
    """The name of the latest-started of ``spans`` (``(start, end,
    name)`` sorted by start) open at ``t``."""
    i = bisect.bisect_right(spans, (t, float("inf"), ""))
    while i > 0:
        i -= 1
        if spans[i][1] >= t:
            return spans[i][2]
    return NO_SPAN


def step_idle_ms(r):
    """The median traced step's device idle inside its own span, in ms,
    the first traced step left out."""
    idle = idle_by_span(r)
    if idle is None:
        return None
    return 1e3 * statistics.median(idle[1])


def slot_fill_pct(r):
    """Live expert slots over all slots in the traced part, in percent."""
    slots, live = counted(r, "moe/slots"), counted(r, "moe/live_slots")
    if not slots:
        return None
    return 100.0 * live / slots
