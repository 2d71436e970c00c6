"""Plain PyTorch attention: the oracle of the flash kernels.

:func:`attention_ref` and :func:`decode_ref` are the JAX package's
``ref.py`` functions: softmax attention computed in f32 from f32 copies of
the operands, cast to q's dtype.  Each takes the Pallas layout, q, k, v of
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
