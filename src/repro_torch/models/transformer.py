"""Decoder-only LM: the JAX package's ``models/transformer.py``, dense family.

One config dataclass (field for field the JAX package's, with torch dtypes)
and one forward.  The ``dense`` family (GQA attention + SwiGLU: phi4-mini,
granite, mistral-nemo, command-r+) runs here; ``moe``, ``ssm`` and
``hybrid`` and the ``audio_stub``/``vision_stub`` frontends raise
``NotImplementedError`` until their slice (ROADMAP queue 1, item 6).

Parameters keep the JAX tree: ``embed``, ``final_norm`` and ``blocks``,
whose leaves are stacked with a leading layer axis, so a JAX tree carried
across with :func:`repro_torch.models.convert.params_from_numpy` plugs in
unchanged.  The JAX package scans the stack with ``lax.scan``; here a
Python loop walks views of it, layer by layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.executor import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, init_embedding, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm, rope_freqs,
                                       unembed)

PENDING_FAMILIES = {"moe", "ssm", "hybrid"}


def _pending(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the remaining families "
        f"(ROADMAP queue 1, item 6); the port runs the dense family")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    # MoE
    num_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0              # routed-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25  # expert capacity (tokens dropped beyond)
    moe_pad_experts: int = 0
    moe_drop_sp: bool = False

    @property
    def num_experts_padded(self) -> int:
        return max(self.moe_pad_experts, self.num_experts)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0            # hybrid: shared attn block cadence
    # modality stubs
    frontend: str = "none"         # none | audio_stub | vision_stub
    n_codebooks: int = 0
    vit_dim: int = 0
    pixel_unshuffle_s: int = 0
    # execution
    max_seq: int = 131072
    dtype: Any = torch.bfloat16
    remat: str = "full"            # none | full
    attn_chunk: int = 1024
    attn_impl: str = "scan"        # scan | triangular

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 128 multiple; pad logits are masked to -1e9 in
        unembed."""
        return ((self.vocab + 127) // 128) * 128

    def param_count(self) -> int:
        """Parameters of the dense family (embedding counted once)."""
        if self.family != "dense":
            raise _pending(f"param_count of family {self.family!r}")
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        at = D * (self.n_heads + 2 * self.n_kv_heads) * self.hd \
            + self.n_heads * self.hd * D
        return V * D + L * (at + D * 2 * F + F * D + 2 * D)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in PENDING_FAMILIES:
        raise _pending(f"family {cfg.family!r} ({cfg.name})")
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.frontend != "none":
        raise _pending(f"frontend {cfg.frontend!r} ({cfg.name})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_dense_block(cfg: ModelConfig, gen):
    return {"attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd,
                                        dtype=cfg.dtype),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=cfg.dtype),
            "ln1": init_rmsnorm(cfg.d_model, device=gen.device),
            "ln2": init_rmsnorm(cfg.d_model, device=gen.device)}


def _stack_init(cfg: ModelConfig, gen, device) -> dict:
    """Blocks drawn one layer at a time into stacked tensors on
    ``device``, so that at most one layer's f32 draw exists at once."""
    stacked = None
    for i in range(cfg.n_layers):
        layer = _init_dense_block(cfg, gen)
        if stacked is None:
            stacked = _tree_map(lambda t: torch.empty(
                (cfg.n_layers,) + tuple(t.shape), dtype=t.dtype,
                device=device), layer)
        _tree_zip(lambda dst, src: dst[i].copy_(src), stacked, layer)
    return stacked


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def init_lm(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> dict:
    """Random parameters drawn from ``gen`` (on the generator's device, then
    moved to ``device``; None means the card).  Returns the parameter tree
    (the JAX package's ``init_lm`` also returns its sharding specs)."""
    _check_family(cfg)
    dev = resolve_device(device)
    params = {"embed": _tree_map(lambda t: t.to(dev), init_embedding(
        gen, cfg.padded_vocab, cfg.d_model, dtype=cfg.dtype))}
    params["final_norm"] = init_rmsnorm(cfg.d_model, device=dev)
    params["blocks"] = _stack_init(cfg, gen, dev)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _dense_block(cfg: ModelConfig, p, x, inv_freq, cache=None,
                 cache_index=None, attention: str = "flash"):
    h, new_cache = attn.attention_block(
        p["attn"], rmsnorm(p["ln1"], x), inv_freq,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        cache=cache, cache_index=cache_index, chunk=cfg.attn_chunk,
        attention=attention)
    x = x + h                                  # TM Add (residual)
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x))
    return x, new_cache, {}


def input_embed(cfg: ModelConfig, params, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(cfg.dtype)
    return embed(params["embed"], tokens)


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None,
            caches=None, cache_index=None, states=None,
            attention: str = "flash"):
    """Run the backbone.  Returns ``(hidden, new_caches, new_states, aux)``.

    ``caches``: stacked KV caches ``{"k", "v"}`` of shape (L, B, T, KV, Hd);
    each layer writes its band in place into its view, so ``new_caches`` is
    ``caches``.  ``attention`` is ``"flash"`` (the kernels) or ``"plain"``
    (the JAX package's jnp attention, ported), see
    :func:`repro_torch.models.attention.attention_block`.
    """
    _check_family(cfg)
    if states is not None:
        raise _pending("recurrent state (ssm / hybrid)")
    x = input_embed(cfg, params, tokens, embeds)
    inv_freq = rope_freqs(cfg.hd, cfg.rope_theta, device=x.device)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        lp = _tree_map(lambda t: t[i], blocks)
        cache = None if caches is None else {"k": caches["k"][i],
                                             "v": caches["v"][i]}
        x, _, _ = _dense_block(cfg, lp, x, inv_freq, cache=cache,
                               cache_index=cache_index, attention=attention)
    x = rmsnorm(params["final_norm"], x)
    return x, caches, None, {"load_balance": 0.0}


def logits(cfg: ModelConfig, params, hidden):
    return unembed(params["embed"], hidden, valid_vocab=cfg.vocab)


# ---------------------------------------------------------------------------
# serving state builders
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, B: int, max_len: int, dtype=torch.bfloat16,
                device=None):
    """Zeroed stacked KV caches (L, B, max_len, KV, Hd); ``device`` None
    means the card."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_states(cfg: ModelConfig, B: int):
    """Recurrent state: none for the dense family."""
    _check_family(cfg)
    return None
