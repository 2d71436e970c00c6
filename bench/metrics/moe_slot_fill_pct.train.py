"""Share of the MoE block's expert slots that a token filled over the
traced part: 100 x `moe/live_slots` / `moe/slots`."""

from bench.harness import spans


def read(r):
    return spans.slot_fill_pct(r)
