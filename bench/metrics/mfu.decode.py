"""The decode step's share of its roofline: the least time for its FLOPs
(bf16 peak) or its bytes (HBM peak), whichever is longer, over the
measured step time."""

from bench.harness import readers


def read(r):
    return readers.step_roofline_pct(r, "decode")
