"""Error bounds of floating-point results that are not bit-exact.

Data movement is compared bit for bit; a result that sums products (a
convolution) or rounds twice (a bf16 resize) is compared within a bound
derived from how it is computed, never within a guessed tolerance.  A
float32 sum of ``n`` products lies within ``gamma(n) * sum |x w|`` of the
exact sum, whatever order it takes (Higham, Accuracy and Stability of
Numerical Algorithms, 2002, eq. 3.5).
"""

from __future__ import annotations

import torch

from repro_torch.core import tm_ops

U32 = 2.0 ** -24  # unit roundoff of float32


def gamma(n: int) -> float:
    """Higham's gamma_n = n u / (1 - n u) at float32's unit roundoff."""
    return n * U32 / (1 - n * U32)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significand bits) at each element's magnitude."""
    mag = t.to(torch.float64).abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def conv_tol(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
             pad: int = 0) -> torch.Tensor:
    """Elementwise bound on the distance between two float32 evaluations of
    the conv of ``x`` (H, W, C) by ``w`` (kh, kw, C, OC): each lies within
    gamma_K sum |x w| of the exact sums of K = kh*kw*C products, so the two
    lie within twice that of each other.  Returns float64 (OH, OW, OC)."""
    kh, kw, C, OC = w.shape
    K = kh * kw * C
    patches = tm_ops.img2col(x.to(torch.float64).abs(), kh, kw, stride, pad)
    mag = patches @ w.to(torch.float64).abs().reshape(K, OC)
    OH = (x.shape[0] + 2 * pad - kh) // stride + 1
    OW = (x.shape[1] + 2 * pad - kw) // stride + 1
    return (2 * gamma(K) * mag).reshape(OH, OW, OC)
