"""Plain PyTorch attention: the oracle of the flash kernels.

:func:`attention_ref` and :func:`decode_ref` are the JAX package's
``ref.py`` functions: softmax attention computed in f32 from f32 copies of
the operands, cast to q's dtype.  :func:`decode_partial_ref` is the
partial form of :func:`decode_ref` that a cache split into row blocks
combines (:func:`combine_partials`).  Each takes the Pallas layout, q, k, v of
shape ``(BH, S, D)``, or the model's, q ``(B, S, H, D)`` against k, v
``(B, Sk, KV, D)`` with query head h reading KV head ``h // (H // KV)``
(the GQA repeat as a grouped einsum, never materialized).  These are the
plain versions the kernel wrappers run for CPU tensors.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _model_layout(q, k, v):
    """Views of the operands in the model's layout; whether q was 3-D."""
    if q.ndim == 3:
        return q[:, :, None], k[:, :, None], v[:, :, None], True
    return q, k, v, False


def _softmax_av(s: torch.Tensor, v4: torch.Tensor, shape, dtype):
    """softmax over the last axis of ``s`` (B, KV, G, S, T), times v."""
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", p, v4.float())
    return out.reshape(shape).to(dtype)


def attention_ref(q, k, v, *, causal=True, scale=None):
    """Plain softmax attention in f32.  Causal masking is top-left: query i
    sees key j iff i >= j, also when S != Sk."""
    q4, k4, v4, flat = _model_layout(q, k, v)
    B, S, H, D = q4.shape
    Sk, KV = k4.shape[1], k4.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q4.float().reshape(B, S, KV, H // KV, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k4.float()) * scale
    if causal:
        pos = torch.arange(max(S, Sk), device=q.device)
        s = s.masked_fill(pos[:S, None] < pos[None, :Sk], NEG_INF)
    out = _softmax_av(s, v4, (B, S, H, D), q.dtype)
    return out[:, :, 0] if flat else out


def decode_ref(q, k, v, length, *, scale=None):
    """One query per head against positions < ``length`` of k, v (an int or
    an integer tensor of one element).  With ``length <= 0`` every score is
    masked alike and the result is the mean of all rows of v."""
    q4, k4, v4, flat = _model_layout(q, k, v)
    B, _, H, D = q4.shape
    T, KV = k4.shape[1], k4.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q4.float().reshape(B, 1, KV, H // KV, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k4.float()) * scale
    if isinstance(length, torch.Tensor):
        length = length.reshape(()).to(q.device)
    s = s.masked_fill(torch.arange(T, device=q.device) >= length, NEG_INF)
    out = _softmax_av(s, v4, (B, 1, H, D), q.dtype)
    return out[:, :, 0] if flat else out


def decode_partial_ref(q, k, v, length, *, scale=None):
    """:func:`decode_ref` over one block of cache rows, as ``(o, lse)`` in
    f32: ``o`` (q's shape) the attention over the rows < ``length``,
    normalised; ``lse`` (q's shape without D) the log of the sum of
    exp(score) over those rows.  A block with no such row (``length <=
    0``) gives ``o = 0`` and ``lse = -inf``, which weighs nothing in
    :func:`combine_partials`."""
    q4, k4, v4, flat = _model_layout(q, k, v)
    B, _, H, D = q4.shape
    T, KV = k4.shape[1], k4.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q4.float().reshape(B, 1, KV, H // KV, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k4.float()) * scale
    if isinstance(length, torch.Tensor):
        length = length.reshape(()).to(q.device)
    s = s.masked_fill(torch.arange(T, device=q.device) >= length,
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bskgd", p / torch.clamp(l, min=1e-30),
                     v4.float()).reshape(B, 1, H, D)
    lse = (m + torch.log(l)).permute(0, 3, 1, 2, 4).reshape(B, 1, H)
    return (o[:, :, 0], lse[:, :, 0]) if flat else (o, lse)


def combine_partials(o, lse, dtype=None, *, amax=None, total=None):
    """Partials of one query over disjoint row blocks of a cache, stacked
    on a leading dim (``o`` (n, ..., D), ``lse`` (n, ...)), combined into
    the attention over all of their rows: a max of ``lse``, then the sum
    of each block's ``o`` weighted by exp(lse - max) over the sum of the
    weights (both sums in one reduction of (..., D + 1)).  Blocks with
    ``lse = -inf`` weigh 0; if no block has a row, the result is 0 (never
    NaN).  ``amax`` and ``total`` replace the max and the sum over the
    leading dim (a decode whose blocks lie on other ranks passes one
    rank's partial and all-reduces).  Cast to ``dtype`` (default f32)."""
    m = lse.amax(dim=0) if amax is None else amax(lse)
    w = torch.exp(lse - torch.where(torch.isinf(m), 0.0, m))[..., None]
    both = torch.cat([o * w, w], dim=-1)
    both = both.sum(dim=0) if total is None else total(both)
    out = both[..., :-1] / torch.clamp(both[..., -1:], min=1e-30)
    return out if dtype is None else out.to(dtype)
