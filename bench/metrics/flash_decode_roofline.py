"""flash_decode's share of its roofline: the bytes its calls need at the
HBM peak over the device time of its split and combine kernels."""

from bench.harness import readers


def read(r):
    return readers.flash_decode_roofline_pct(r)
