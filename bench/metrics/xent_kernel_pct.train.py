"""Share of the loss's positions whose row statistics and gradient the
cross-entropy kernels computed over the traced part: 100 x
`xent/kernel_rows` / `xent/rows`."""

from bench.harness import spans


def read(r):
    rows = spans.counted(r, "xent/rows")
    if not rows:
        return None
    return 100.0 * spans.counted(r, "xent/kernel_rows") / rows
