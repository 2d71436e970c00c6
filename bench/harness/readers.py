"""What the per-layer metrics share: the step's share of its roofline over
the untraced part of a traced run, and the traced part's device figures.
Each reader returns None where its cell has nothing for it to read."""

from __future__ import annotations

import statistics

from bench.counts import lm as counts
from bench.harness import lmcfg


def _driver(r, name: str) -> bool:
    return r.cell["driver"] == name


def step_roofline_pct(r, driver: str):
    """The least time the card could take for the untraced part's steps
    (:func:`bench.counts.lm.least_seconds` of each step's FLOPs and
    bytes) over the part's host-clock span, in percent."""
    if not _driver(r, driver):
        return None
    part = r.parts["untraced"]
    if not part.steps:
        return None
    d = lmcfg.dims(r.config)
    p = r.params
    if driver == "train":
        least = len(part.steps) * counts.least_seconds(
            *counts.train_step(d, p["batch"], p["seq"]))
    else:
        least = sum(counts.least_seconds(
            *counts.decode_step(d, p["batch"], s["length"]))
            for s in part.steps)
    return 100.0 * least / part.seconds


def idle_pct(r, driver: str):
    """The traced part's share of time with no device operation running."""
    t = r.trace_data
    if not _driver(r, driver) or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def host_ms_median(r, driver: str):
    steps = r.parts["untraced"].steps
    if not _driver(r, driver) or not steps:
        return None
    return 1e3 * statistics.median(s["host_s"] for s in steps)


def launches_per_step(r, driver: str):
    t, steps = r.trace_data, r.parts["traced"].steps
    if not _driver(r, driver) or t is None or not steps:
        return None
    return t.kernel_count() / len(steps)


def flash_decode_roofline_pct(r):
    """The traced decode calls' bytes at the HBM peak over the device time
    of the decode kernels (the split kernel and its combine)."""
    t, steps = r.trace_data, r.parts["traced"].steps
    if not _driver(r, "decode") or t is None or not steps:
        return None
    secs, n = t.kernel_seconds("decode_mma_kernel", "decode_combine_kernel")
    if n == 0 or secs <= 0:
        return None
    d, B = lmcfg.dims(r.config), r.params["batch"]
    nbytes = sum(d.L * counts.flash_decode_bytes(B, d.H, d.KV, d.hd,
                                                 s["length"])
                 for s in steps)
    return 100.0 * counts.least_seconds(0, nbytes) / secs
