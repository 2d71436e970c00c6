"""Shared layers: norms, the SwiGLU MLP, RoPE, embeddings, cross entropy.

The JAX package's ``models/layers.py`` with PyTorch tensors.  Every
``init_*`` draws from an explicit ``torch.Generator`` and returns the
parameter dict alone; the JAX package's second tree (each leaf's logical
sharding axes) is the ``*_SPECS`` constant beside it, which
``transformer.lm_specs`` assembles without allocating anything.  The
``shard`` annotations sit where the JAX package's do and return their
input outside a rules context.  Parameters are drawn in f32 on the
generator's device and cast to ``dtype``, as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.kernels import xent
from repro_torch.runtime.sharding import (local, local_block, ranks_of,
                                          reduce_scatter_over, shard,
                                          spec_of, whole_seq, with_partial)


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


RMSNORM_SPECS = {"g": (None,)}


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


MLP_SPECS = {"wi": ("embed_fsdp", "mlp"), "wo": ("mlp", "embed_fsdp")}


def mlp(p, x):
    """SwiGLU; the gate/up Split is the paper's Split op on the fused
    projection output (two views of one product, no copy)."""
    h = shard(whole_seq(x) @ p["wi"], ("batch", None, "mlp"))
    gate, up = torch.chunk(h, 2, dim=-1)
    return (F.silu(gate) * up) @ p["wo"]


# -- embeddings ---------------------------------------------------------------

def init_embedding(gen, vocab: int, d_model: int, dtype=torch.float32):
    return {"e": _norm_init(gen, (vocab, d_model), 1.0).to(dtype)}


EMBED_SPECS = {"e": ("vocab", "embed")}


def embed(p, tokens):
    """Rows of the table (``jnp.take``'s), through ``F.embedding``.

    Where the rules spread the vocab over mesh axes ("model"), a
    vocab-parallel lookup (:func:`local`): each rank reads only its own
    rows, tokens outside them read row 0 weighted 0 (one
    ``embedding_bag``), and the partial sums meet in an all-reduce, or,
    where the sequence lies over the same axis, in a reduce-scatter into
    the sequence-sharded activations, the tokens taken in the order of
    its blocks so that it scatters along dim 0 with no copy.  Its
    backward runs on each rank's plain shard, a local index-accumulate,
    so it needs no DTensor strategy for an index into a sharded table
    (which PyTorch 2.11's DTensor lacks).  Outside a rules context,
    ``F.embedding(tokens, table)``."""
    e = p["e"]
    vocab, seq = spec_of(("vocab", "seq")) or (None, None)
    if vocab is None:
        return F.embedding(tokens, e)
    offset, _ = local_block(e.shape, EMBED_SPECS["e"], 0)
    n = ranks_of("vocab")
    scatter = isinstance(vocab, str) and seq == vocab and \
        tokens.shape[1] % n == 0

    def lookup(e, tokens):
        B, S = tokens.shape
        if scatter:   # (n, B, S / n): the reduce-scatter's blocks first
            tokens = tokens.view(B, n, S // n).transpose(0, 1).contiguous()
        ids = tokens - offset
        hit = (ids >= 0) & (ids < e.shape[0])
        x = F.embedding_bag(torch.where(hit, ids, 0).view(-1, 1), e,
                            mode="sum", per_sample_weights=hit.view(
                                -1, 1).to(e.dtype)).view(*ids.shape, -1)
        if scatter:
            x = reduce_scatter_over(x, "vocab")[0]
        return x

    out = ("batch", "seq", "embed") if scatter else \
        with_partial(("batch", None, "embed"), "vocab")
    return local(lookup, (EMBED_SPECS["e"], ("batch", None)), out,
                 in_grad=(with_partial(EMBED_SPECS["e"], "batch"), None))(
        e, tokens)


def unembed(p, x, valid_vocab: int | None = None):
    """Logits; ``valid_vocab`` masks the padding rows (vocab padded to a
    multiple of 128) to -1e9."""
    logits = whole_seq(x) @ p["e"].T
    V = p["e"].shape[0]
    if valid_vocab is not None and valid_vocab != V:
        pad = torch.arange(V, device=logits.device) >= valid_vocab
        logits = logits.masked_fill(pad, -1e9)
    return shard(logits, ("batch", None, "vocab"))


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


# -- cross entropy --------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token CE over valid positions.  logits (B, S, V), taken
    in f32; labels (B, S), ``ignore_id`` marks a position left out.

    Each position's nll comes, on the card, from the kernels of
    ``csrc/xent.cu`` (:func:`repro_torch.kernels.xent.nll`, the gradient
    one more kernel; a DTensor's on each rank's shard); anywhere else (the
    CPU, the dry-run's meta tensors) from the plain version, the eager f32
    chain.  The mean over valid positions is PyTorch on either.  While
    tracing it counts ``xent/rows`` (the positions of this rank's logits)
    and ``xent/kernel_rows`` (those the kernels took)."""
    card = xent.on_card(logits)
    nll = (xent.nll if card else xent.nll_plain)(logits, labels)
    tr = obs.current()
    if tr.enabled:
        shape = (logits.to_local() if isinstance(logits, DTensor)
                 else logits).shape
        rows = shape[:-1].numel()
        tr.count("xent/rows", rows)
        if card:
            tr.count("xent/kernel_rows", rows)
    valid = (labels != ignore_id).float()
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)
