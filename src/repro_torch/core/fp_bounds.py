"""Error bounds of floating-point results that are not bit-exact.

Data movement is compared bit for bit; a result that sums products (a
convolution) or rounds twice (a bf16 resize) is compared within a bound
derived from how it is computed, never within a guessed tolerance.  A
float32 sum of ``n`` products lies within ``gamma(n) * sum |x w|`` of the
exact sum, whatever order it takes (Higham, Accuracy and Stability of
Numerical Algorithms, 2002, eq. 3.5).
"""

from __future__ import annotations

import math

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


U_BF16 = 2.0 ** -8  # unit roundoff of bfloat16 (8 significand bits)


def attention_tol(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, length=None,
                  scale: float | None = None) -> torch.Tensor:
    """Elementwise bound on the distance between two evaluations of softmax
    attention (any summation order, online or not) of the same q, k, v, in
    the layout of q: (BH, S, D) against (BH, T, D), or (B, S, H, D) against
    (B, T, KV, D).  Masking as in the flash kernels: causal top-left,
    ``length`` (decode, an int) masks positions >= length.

    With A = sum_j p_j |v_j| (the exact softmax weights applied to |v|):
    each score of D products is off by at most gamma_D sum |q k| * scale in
    either evaluation, the shift s - m and exp add a few roundings relative
    to |s|, so each p_j is off by a relative delta = 2 gamma_D max sum|q k|
    scale + u (4 max|s| + 8); numerator and denominator together move the
    result by 2 delta A, the two sums over T rows by 2 gamma_{T+1} A.  In
    bf16, p rounded to bf16 before the PV product (the Pallas kernels and
    full_attention) and the output's rounding add at most 2^-8 A per
    evaluation each: 2^-6 A for two; in f32 the output rounding 2 u A.
    Returns float64."""
    flat = q.ndim == 3
    if flat:
        q, k, v = q[:, :, None], k[:, :, None], v[:, :, None]
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qd = q.double().reshape(B, S, KV, H // KV, D)
    kd = k.double()
    s = torch.einsum("bskgd,btkd->bkgst", qd, kd) * scale
    qk = torch.einsum("bskgd,btkd->bkgst", qd.abs(), kd.abs()) * scale
    pos = torch.arange(max(S, T), device=q.device)
    masked = torch.zeros((S, T), dtype=torch.bool, device=q.device)
    if causal:
        masked |= pos[:S, None] < pos[None, :T]
    if length is not None:
        masked |= (pos[None, :T] >= length).expand(S, T)
    p = torch.softmax(s.masked_fill(masked, -1e30), dim=-1)
    A = torch.einsum("bkgst,btkd->bkgsd", p, v.double().abs())
    delta = (2 * gamma(D) * qk.masked_fill(masked, 0).amax(dim=-1)
             + U32 * (4 * s.masked_fill(masked, 0).abs().amax(dim=-1) + 8))
    r = 2 * U32 if q.dtype == torch.float32 else 4 * U_BF16
    tol = (2 * delta[..., None] + 2 * gamma(T + 1) + r) * A
    tol = tol.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return tol[:, :, 0] if flat else tol


def decode_lse_tol(q: torch.Tensor, k: torch.Tensor, length,
                   scale: float | None = None) -> torch.Tensor:
    """Bound on the distance between two f32 evaluations of a decode
    block's lse (``flash_decode_partial``'s second output: log sum_j
    exp(s_j) over the rows < ``length``), q (B, 1, H, D) against k (B, T,
    KV, D), in the layout of lse (B, 1, H).  Each exp(s_j) is off by the
    relative delta of :func:`attention_tol`, the sum over T rows by
    gamma_{T+1}: the sum by (delta + gamma_{T+1}) relative, its log by as
    much absolute, for each evaluation, plus the roundings of the log and
    of m + log l (u (|lse| + 1) each).  Returns float64; zero where no row
    is live (both give -inf)."""
    B, _, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qd = q.double().reshape(B, 1, KV, H // KV, D)
    kd = k.double()
    s = torch.einsum("bskgd,btkd->bkgst", qd, kd) * scale
    qk = torch.einsum("bskgd,btkd->bkgst", qd.abs(), kd.abs()) * scale
    live = torch.arange(T, device=q.device) < length
    delta = (2 * gamma(D) * qk.masked_fill(~live, 0).amax(dim=-1)
             + U32 * (4 * s.masked_fill(~live, 0).abs().amax(dim=-1) + 8))
    lse = torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)
    tol = 2 * (delta + gamma(T + 1)) + 4 * U32 * (lse.abs() + 1)
    tol = torch.where(live.any(), tol, torch.zeros_like(tol))
    return tol.permute(0, 3, 1, 2).reshape(B, 1, H)
