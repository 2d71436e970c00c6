"""Share of the traced training window in which no device operation ran."""

from bench.harness import readers


def read(r):
    return readers.idle_pct(r, "train")
