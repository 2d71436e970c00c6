"""The traced part of a window, reduced from ``torch.profiler``'s events:
device operations (kernels, copies, fills) and the host's operations.

``busy_s`` is the union of the device operations' intervals; the idle
gaps between them are named by the innermost host operation that was
running at each gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

TOP = 10            # entries of each breakdown list
GAPS_NAMED = 2000   # longest gaps looked up in the host's events


def _ns(ev, what: str) -> int:
    return int(getattr(ev, f"{what}_ns")())


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class TraceData:
    """Device operations ``(name, start_ns, dur_ns)`` in start order, host
    operations ``(start_ns, end_ns, name)``, and the traced window's
    host-clock length."""

    def __init__(self, device_ops, host_ops, window_s: float):
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.host_ops = sorted(host_ops)
        self.window_s = float(window_s)
        self.intervals = self._union()
        self.busy_s = sum(b - a for a, b in self.intervals) * 1e-9

    @classmethod
    def of(cls, prof, window_s: float) -> "TraceData":
        from torch.autograd import DeviceType
        dev, host = [], []
        for ev in prof.profiler.kineto_results.events():
            dur = _ns(ev, "duration")
            if ev.device_type() == DeviceType.CUDA:
                dev.append((ev.name(), _ns(ev, "start"), dur))
            elif dur > 0:
                start = _ns(ev, "start")
                host.append((start, start + dur, ev.name()))
        return cls(dev, host, window_s)

    def _union(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for _, start, dur in self.device_ops:
            end = start + dur
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return [(a, b) for a, b in out]

    def kernel_seconds(self, *substrings: str) -> tuple[float, int]:
        """Device seconds and count of the operations whose name holds any
        of ``substrings``."""
        total, n = 0, 0
        for name, _, dur in self.device_ops:
            if any(s in name for s in substrings):
                total += dur
                n += 1
        return total * 1e-9, n

    def kernel_count(self) -> int:
        return sum(1 for name, _, _ in self.device_ops if is_kernel(name))

    def _host_at(self, t: int) -> str:
        """The innermost host operation running at ``t``: the latest-started
        one that covers it."""
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), ""))
        while i > 0:
            i -= 1
            start, end, name = self.host_ops[i]
            if end >= t:
                return name
        return "(no host operation)"

    def breakdown(self) -> dict:
        by_op = defaultdict(int)
        for name, _, dur in self.device_ops:
            by_op[name[:120]] += dur
        gaps = [(b0 - a1, a1, b0) for (_, a1), (b0, _) in
                zip(self.intervals, self.intervals[1:])]
        gaps.sort(reverse=True)
        by_host = defaultdict(int)
        for length, a, b in gaps[:GAPS_NAMED]:
            by_host[self._host_at((a + b) // 2)[:120]] += length
        top = lambda d: [[k, v * 1e-9] for k, v in  # noqa: E731
                         sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
