"""Median host time of one decode step call (which returns without
synchronising) over the untraced part of the window."""

from bench.harness import readers


def read(r):
    return readers.host_ms_median(r, "decode")
