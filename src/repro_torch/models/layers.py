"""Shared layers: norms, the SwiGLU MLP, RoPE, embeddings.

The JAX package's ``models/layers.py`` with PyTorch tensors.  Every
``init_*`` draws from an explicit ``torch.Generator`` and returns the
parameter dict alone: the JAX package's second tree (logical sharding
axes) and its ``shard`` calls are no-ops outside a mesh, and sharding
comes with a later slice.  Parameters are drawn in f32 on the generator's
device and cast to ``dtype``, as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _norm_init(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


# -- linear ------------------------------------------------------------------

def init_linear(gen, d_in: int, d_out: int, dtype=torch.float32):
    return {"w": _norm_init(gen, (d_in, d_out), d_in ** -0.5).to(dtype)}


def linear(p, x):
    return x @ p["w"]


# -- rmsnorm -----------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.float32, device=None):
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["g"]).to(x.dtype)


# -- SwiGLU MLP (TM Split: one fused up-projection split into gate/up) --------

def init_mlp(gen, d_model: int, d_ff: int, dtype=torch.float32):
    wi = _norm_init(gen, (d_model, 2 * d_ff), d_model ** -0.5).to(dtype)
    wo = _norm_init(gen, (d_ff, d_model), d_ff ** -0.5).to(dtype)
    return {"wi": wi, "wo": wo}


def mlp(p, x):
    """SwiGLU; the gate/up Split is the paper's Split op on the fused
    projection output (two views of one product, no copy)."""
    h = x @ p["wi"]
    gate, up = torch.chunk(h, 2, dim=-1)
    return (F.silu(gate) * up) @ p["wo"]


# -- embeddings ---------------------------------------------------------------

def init_embedding(gen, vocab: int, d_model: int, dtype=torch.float32):
    return {"e": _norm_init(gen, (vocab, d_model), 1.0).to(dtype)}


def embed(p, tokens):
    return p["e"][tokens]


def unembed(p, x, valid_vocab: int | None = None):
    """Logits; ``valid_vocab`` masks the padding rows (vocab padded to a
    multiple of 128) to -1e9."""
    logits = x @ p["e"].T
    V = p["e"].shape[0]
    if valid_vocab is not None and valid_vocab != V:
        pad = torch.arange(V, device=logits.device) >= valid_vocab
        logits = logits.masked_fill(pad, -1e9)
    return logits


# -- RoPE ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)  # (head_dim // 2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv_freq  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
