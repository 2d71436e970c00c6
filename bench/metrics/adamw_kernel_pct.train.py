"""Share of the optimizer's elements that the fused AdamW kernels updated
over the traced part: 100 x `adamw/kernel_elems` / `adamw/elems`."""

from bench.harness import spans


def read(r):
    elems = spans.counted(r, "adamw/elems")
    if not elems:
        return None
    return 100.0 * spans.counted(r, "adamw/kernel_elems") / elems
