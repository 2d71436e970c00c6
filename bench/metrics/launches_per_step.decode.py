"""CUDA kernel launches in the traced decode window over its steps."""

from bench.harness import readers


def read(r):
    return readers.launches_per_step(r, "decode")
