"""Device time of the MoE block's tensor manipulation (its `moe/route`,
`moe/dispatch` and `moe/combine` spans, in the forward and the
recompute) a traced step, in ms."""

from bench.harness import spans


def read(r):
    return spans.device_ms_per_step(r, "moe/route", "moe/dispatch",
                                   "moe/combine")
