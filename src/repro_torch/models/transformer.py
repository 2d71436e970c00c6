"""Decoder-only LM covering the JAX package's five families.

The JAX package's ``models/transformer.py`` with PyTorch tensors: one config
dataclass (field for field the JAX package's, with torch dtypes) and one
forward, dispatching per-family blocks:
  dense  — GQA attention + SwiGLU (mistral-nemo, command-r+, phi4, granite,
           the musicgen and internvl2 backbones)
  moe    — GQA attention + RME-dispatched MoE (llama4-scout, qwen2-moe)
  hybrid — Mamba2 stack + one shared attention block every k layers (zamba2)
  ssm    — RWKV6 time-mix + channel-mix (rwkv6)
and the ``vision_stub`` (PixelUnshuffle projector) and ``audio_stub``
(delay-pattern codebook embedding) frontends.

Parameters keep the JAX tree: ``embed``, ``final_norm`` and ``blocks``,
whose leaves are stacked with a leading layer axis (plus ``shared_attn``,
``vision_proj`` and ``codebook_embed`` where the family or frontend has
them), so a JAX tree carried across with
:func:`repro_torch.models.convert.params_from_numpy` plugs in unchanged.
The JAX package scans the stack with ``lax.scan``; here a Python loop walks
views of it, layer by layer.  :func:`lm_loss` is the training objective;
under autograd with ``remat="full"`` each layer (hybrid: each group) is
recomputed in the backward pass, as the JAX package's ``jax.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tm_ops
from repro_torch.core.executor import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (EMBED_SPECS, MLP_SPECS, RMSNORM_SPECS,
                                       _norm_init, embed, init_embedding,
                                       init_mlp, init_rmsnorm, mlp, rmsnorm,
                                       rope_freqs, softmax_xent, unembed)
from repro_torch.runtime.sharding import map_specs, remat_context, shard
from repro_torch.tree import tree_leaves, tree_map

FAMILIES = ("dense", "moe", "hybrid", "ssm")
# the logical axes of the activations between blocks: under a mesh each
# block's output, and each residual branch before it is added (sequence
# parallelism's reduce-scatter, which GSPMD places there on its own and
# DTensor, which propagates forward only, is told), lie on them
ACT = ("batch", "seq", "embed")
FRONTENDS = ("none", "audio_stub", "vision_stub")


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
        """Total parameters (for 6·N·D model-FLOPs accounting), the JAX
        package's formula for every family."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * D
        if self.family in ("dense", "moe"):
            at = D * (self.n_heads + 2 * self.n_kv_heads) * self.hd \
                + self.n_heads * self.hd * D
            if self.family == "dense":
                ff = D * 2 * F + F * D
            else:
                fe = self.moe_d_ff or F
                ff = self.num_experts * (D * 2 * fe + fe * D) \
                    + D * self.num_experts
                if self.n_shared:
                    ff += D * 2 * F + F * D
            return emb + L * (at + ff + 2 * D)
        if self.family == "ssm":
            blk = 4 * D * D + D * D + D * D + D * 2 * F // 1 + F * D
            return emb + L * blk
        if self.family == "hybrid":
            d_inner = self.ssm_expand * D
            nh = d_inner // self.ssm_head_dim
            m = D * (2 * d_inner + 2 * self.ssm_state + nh) + d_inner * D
            # shared attention counted once (reused every attn_every)
            at = (2 * D) * (self.n_heads + 2 * self.n_kv_heads) * self.hd \
                + self.n_heads * self.hd * (2 * D) + (2 * D) * D
            return emb + L * (m + 2 * D) + at
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        fe = self.moe_d_ff or F
        at = D * (self.n_heads + 2 * self.n_kv_heads) * self.hd \
            + self.n_heads * self.hd * D
        ff = self.top_k * (D * 2 * fe + fe * D) + D * self.num_experts
        if self.n_shared:
            ff += D * 2 * F + F * D
        return V * D + L * (at + ff + 2 * D)


def _check_config(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")


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


def _init_moe_block(cfg: ModelConfig, gen):
    return {"attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd,
                                        dtype=cfg.dtype),
            "moe": moe_mod.init_moe(gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                                    cfg.num_experts, cfg.top_k,
                                    n_shared=cfg.n_shared,
                                    shared_d_ff=cfg.d_ff, dtype=cfg.dtype,
                                    pad_experts=cfg.moe_pad_experts),
            "ln1": init_rmsnorm(cfg.d_model, device=gen.device),
            "ln2": init_rmsnorm(cfg.d_model, device=gen.device)}


def _init_ssm_block(cfg: ModelConfig, gen):
    tmix, _ = ssm_mod.init_rwkv6(gen, cfg.d_model, head_dim=cfg.ssm_head_dim,
                                 dtype=cfg.dtype)
    return {"tmix": tmix,
            "ffn": ssm_mod.init_rwkv_ffn(gen, cfg.d_model, cfg.d_ff,
                                         dtype=cfg.dtype),
            "ln1": init_rmsnorm(cfg.d_model, device=gen.device),
            "ln2": init_rmsnorm(cfg.d_model, device=gen.device)}


def _init_mamba_block(cfg: ModelConfig, gen):
    mamba, _ = ssm_mod.init_mamba2(gen, cfg.d_model, d_state=cfg.ssm_state,
                                   expand=cfg.ssm_expand,
                                   head_dim=cfg.ssm_head_dim, dtype=cfg.dtype)
    return {"mamba": mamba, "ln1": init_rmsnorm(cfg.d_model,
                                                device=gen.device)}


_BLOCK_INIT = {"dense": _init_dense_block, "moe": _init_moe_block,
               "ssm": _init_ssm_block, "hybrid": _init_mamba_block}


def _stack_init(cfg: ModelConfig, gen, device) -> dict:
    """The family's blocks drawn one layer at a time into stacked tensors
    on ``device``, so that at most one layer's f32 draw exists at once."""
    init_fn = _BLOCK_INIT[cfg.family]
    stacked = None
    for i in range(cfg.n_layers):
        layer = init_fn(cfg, gen)
        if stacked is None:
            stacked = tree_map(lambda t: torch.empty(
                (cfg.n_layers,) + tuple(t.shape), dtype=t.dtype,
                device=device), layer)
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
    return stacked


def _ssm_meta(cfg: ModelConfig) -> dict:
    if cfg.family == "ssm":
        return dict(n_heads=cfg.d_model // cfg.ssm_head_dim,
                    head_dim=cfg.ssm_head_dim)
    d_inner = cfg.ssm_expand * cfg.d_model
    return dict(d_inner=d_inner, n_heads=d_inner // cfg.ssm_head_dim,
                head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state)


def init_lm(cfg: ModelConfig, gen: torch.Generator, *, device=None) -> dict:
    """Random parameters drawn from ``gen`` (on the generator's device, then
    moved to ``device``; None means the card).  Returns the parameter tree;
    its sharding specs, which the JAX package's ``init_lm`` returns beside
    it, are :func:`lm_specs`."""
    _check_config(cfg)
    dev = resolve_device(device)

    def draw(shape, scale):
        return _norm_init(gen, shape, scale).to(cfg.dtype).to(dev)

    params = {"embed": tree_map(lambda t: t.to(dev), init_embedding(
        gen, cfg.padded_vocab, cfg.d_model, dtype=cfg.dtype))}
    params["final_norm"] = init_rmsnorm(cfg.d_model, device=dev)
    params["blocks"] = _stack_init(cfg, gen, dev)
    if cfg.family == "hybrid":
        # one shared attention block over concat(hidden, embed0) at
        # 2·d_model (its wo maps back to 2·d_model), then its own down-proj
        d2 = 2 * cfg.d_model
        params["shared_attn"] = {
            "attn": tree_map(lambda t: t.to(dev), attn.init_attention(
                gen, d2, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                dtype=cfg.dtype)),
            "proj": {"w": draw((d2, cfg.d_model), d2 ** -0.5)},
            "ln": init_rmsnorm(d2, device=dev)}
    if cfg.frontend == "vision_stub":
        s = cfg.pixel_unshuffle_s or 2
        d_in = cfg.vit_dim * s * s
        params["vision_proj"] = {"w": draw((d_in, cfg.d_model),
                                           d_in ** -0.5)}
    if cfg.frontend == "audio_stub" and cfg.n_codebooks:
        params["codebook_embed"] = {"e": draw(
            (cfg.n_codebooks, cfg.vocab, cfg.d_model), 1.0)}
    return params


def _block_specs(cfg: ModelConfig) -> dict:
    norms = {"ln1": dict(RMSNORM_SPECS), "ln2": dict(RMSNORM_SPECS)}
    if cfg.family == "dense":
        return {"attn": dict(attn.ATTENTION_SPECS), "mlp": dict(MLP_SPECS),
                **norms}
    if cfg.family == "moe":
        return {"attn": dict(attn.ATTENTION_SPECS),
                "moe": moe_mod.moe_specs(cfg.n_shared), **norms}
    if cfg.family == "ssm":
        return {"tmix": dict(ssm_mod.RWKV6_SPECS),
                "ffn": dict(ssm_mod.RWKV_FFN_SPECS), **norms}
    return {"mamba": dict(ssm_mod.MAMBA2_SPECS),
            "ln1": dict(RMSNORM_SPECS)}


def lm_specs(cfg: ModelConfig) -> dict:
    """The logical sharding axes of :func:`init_lm`'s tree, leaf for leaf
    (the JAX package's ``init_lm`` returns them as its second value); the
    stacked blocks' leaves lead with ``"layers"``.  Allocates nothing."""
    _check_config(cfg)
    specs = {"embed": dict(EMBED_SPECS), "final_norm": dict(RMSNORM_SPECS),
             "blocks": map_specs(lambda t: ("layers",) + tuple(t),
                                 _block_specs(cfg))}
    if cfg.family == "hybrid":
        specs["shared_attn"] = {"attn": dict(attn.ATTENTION_SPECS),
                                "proj": {"w": ("embed_fsdp", "embed")},
                                "ln": dict(RMSNORM_SPECS)}
    if cfg.frontend == "vision_stub":
        specs["vision_proj"] = {"w": (None, "embed")}
    if cfg.frontend == "audio_stub" and cfg.n_codebooks:
        specs["codebook_embed"] = {"e": (None, "vocab", "embed")}
    return specs


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _dense_block(cfg: ModelConfig, p, x, inv_freq, cache=None,
                 cache_index=None, attention: str = "flash"):
    h, new_cache = attn.attention_block(
        p["attn"], rmsnorm(p["ln1"], x), inv_freq,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        cache=cache, cache_index=cache_index, chunk=cfg.attn_chunk,
        attention=attention, triangular=cfg.attn_impl == "triangular")
    x = x + shard(h, ACT)                      # TM Add (residual)
    x = x + shard(mlp(p["mlp"], rmsnorm(p["ln2"], x)), ACT)
    return shard(x, ACT), new_cache, {}


def _moe_block(cfg: ModelConfig, p, x, inv_freq, cache=None,
               cache_index=None, attention: str = "flash"):
    h, new_cache = attn.attention_block(
        p["attn"], rmsnorm(p["ln1"], x), inv_freq,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        cache=cache, cache_index=cache_index, chunk=cfg.attn_chunk,
        attention=attention, triangular=cfg.attn_impl == "triangular")
    x = x + shard(h, ACT)
    m, aux = moe_mod.moe_block(p["moe"], rmsnorm(p["ln2"], x),
                               num_experts=cfg.num_experts, top_k=cfg.top_k,
                               n_shared=cfg.n_shared,
                               capacity_factor=cfg.capacity_factor)
    return shard(x + shard(m, ACT), ACT), new_cache, aux


def _ssm_block(cfg: ModelConfig, p, x, state=None):
    if state is None:
        tprev = fprev = wkv = None
    else:
        tprev, fprev, wkv = state["tprev"], state["fprev"], state["wkv"]
    h, tlast, wkv = ssm_mod.rwkv6_block(p["tmix"], rmsnorm(p["ln1"], x),
                                        _ssm_meta(cfg), x_prev=tprev,
                                        state=wkv)
    x = x + shard(h, ACT)
    f, flast = ssm_mod.rwkv_ffn(p["ffn"], rmsnorm(p["ln2"], x), x_prev=fprev)
    return (shard(x + shard(f, ACT), ACT),
            {"tprev": tlast, "fprev": flast, "wkv": wkv})


def _mamba_block(cfg: ModelConfig, p, x, state=None):
    meta = _ssm_meta(cfg)
    u = rmsnorm(p["ln1"], x)
    if state is None:
        y, new_state = ssm_mod.mamba2_block(p["mamba"], u, meta), None
    elif x.shape[1] == 1:  # decode step
        y, new_state = ssm_mod.mamba2_step(p["mamba"], u, state, meta)
    else:  # prefill continuation: run chunked, carry the state out
        y, new_state = ssm_mod.mamba2_block(p["mamba"], u, meta, h0=state,
                                            return_state=True)
    return shard(x + shard(y, ACT), ACT), new_state


def _shared_attn(cfg: ModelConfig, p, x, embed0, inv_freq, cache=None,
                 cache_index=None, attention: str = "flash"):
    """Zamba2 shared block: attention over Route([hidden, embed0]) (TM
    Route, a channel concat) at 2·d_model, projected back to d_model by
    ``proj``."""
    xin = torch.cat([x, embed0], dim=-1)                  # TM Route
    h, new_cache = attn.attention_block(
        p["attn"], rmsnorm(p["ln"], xin), inv_freq,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        cache=cache, cache_index=cache_index, chunk=cfg.attn_chunk,
        attention=attention)
    return x + shard(h @ p["proj"]["w"], ACT), new_cache


def input_embed(cfg: ModelConfig, params, tokens=None, embeds=None):
    x = embeds.to(cfg.dtype) if embeds is not None \
        else embed(params["embed"], tokens)
    return shard(x, ACT)


def vision_prefix(cfg: ModelConfig, params, patch_embeds):
    """InternVL2 projector: PixelUnshuffle (the paper's flagship TM op) on
    the patch grid through the TM engine, then the projection to d_model.
    patch_embeds: (B, Hp, Wp, vit_dim) -> (B, Hp·Wp / s², d_model)."""
    s = cfg.pixel_unshuffle_s or 2
    x = tm_ops.pixel_unshuffle(patch_embeds.to(cfg.dtype), s)
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C) @ params["vision_proj"]["w"]


def audio_embed(cfg: ModelConfig, params, codes):
    """MusicGen frontend stub: per-codebook embeddings summed after the
    EnCodec delay-pattern Rearrange (codebook k shifted right by k steps,
    its first k zeroed).  codes: (B, K, S) int -> (B, S, d_model)."""
    x = 0
    for k in range(codes.shape[1]):
        sk = torch.roll(codes[:, k], k, dims=-1)
        sk[..., :k] = 0
        x = x + params["codebook_embed"]["e"][k][sk]
    return x


def _layer(tree, i):
    return tree_map(lambda t: t[i], tree)


def _layers(tree, n: int, *, train: bool):
    """Layer ``i`` of the stacked ``tree`` as a function of ``i``.  When
    training, every leaf is split once with ``torch.unbind``, whose backward
    stacks the n gradients in one go; ``t[i]``'s backward would build a
    zero tensor the size of the whole stack for each layer."""
    if not train:
        return lambda i: _layer(tree, i)
    parts = {id(t): torch.unbind(t) for t in tree_leaves(tree)}
    return [tree_map(lambda t: parts[id(t)][i], tree)
            for i in range(n)].__getitem__


def _maybe_remat(cfg: ModelConfig, fn, *, train: bool):
    """``fn`` recomputed in the backward pass (activation checkpointing)
    when training with ``cfg.remat == "full"``; serving never remats."""
    if cfg.remat == "full" and train:
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=remat_context)
    return fn


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None,
            caches=None, cache_index=None, states=None,
            attention: str = "flash"):
    """Run the backbone.  Returns ``(hidden, new_caches, new_states, aux)``.

    ``caches``: stacked KV caches ``{"k", "v"}`` of shape (L, B, T, KV, Hd)
    (hybrid: one per shared-attention call); each attention writes its band
    in place into its view, so ``new_caches`` is ``caches``.  ``states``:
    the ssm / hybrid recurrent state stacked as :func:`init_states` makes
    it; each layer writes its new state into its slot, so ``new_states`` is
    ``states``.  ``attention`` is ``"flash"`` (the kernels) or ``"plain"``
    (the JAX package's jnp attention, ported), see
    :func:`repro_torch.models.attention.attention_block`.  ``aux`` holds
    the MoE load balance summed over the layers over ``n_layers`` (dense
    and moe).  Training is grad mode without caches or states: then the
    layer views come from one ``torch.unbind`` per leaf and, with
    ``cfg.remat == "full"``, each layer (hybrid: each group of
    ``attn_every`` Mamba2 layers with the shared attention; the tail
    layers are not) is recomputed in the backward pass.
    """
    _check_config(cfg)
    if attention not in attn.ATTENTION:
        raise ValueError(f"attention must be one of {attn.ATTENTION}, got "
                         f"{attention!r}")
    x = input_embed(cfg, params, tokens, embeds)
    inv_freq = rope_freqs(cfg.hd, cfg.rope_theta, device=x.device)
    train = torch.is_grad_enabled() and caches is None and states is None
    layer = _layers(params["blocks"], cfg.n_layers, train=train)

    if cfg.family in ("dense", "moe"):
        block = _maybe_remat(cfg, _dense_block if cfg.family == "dense"
                             else _moe_block, train=train)
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            cache = None if caches is None else {"k": caches["k"][i],
                                                 "v": caches["v"][i]}
            x, _, aux = block(cfg, layer(i), x, inv_freq, cache,
                              cache_index, attention)
            lb = lb + aux.get("load_balance", 0.0)
        x = rmsnorm(params["final_norm"], x)
        return x, caches, None, {"load_balance": lb / cfg.n_layers}

    if cfg.family == "ssm":
        block = _maybe_remat(cfg, _ssm_block, train=train)
        for i in range(cfg.n_layers):
            st = None if states is None else _layer(states, i)
            x, new_st = block(cfg, layer(i), x, st)
            if states is not None:  # into its slot (JAX donates states)
                tree_map(lambda d, n: d.copy_(n), st, new_st)
        x = rmsnorm(params["final_norm"], x)
        return x, None, states, {}

    # hybrid: groups of attn_every Mamba2 layers, each followed by the
    # shared attention (its own KV cache per call), then the tail layers
    k = cfg.attn_every or cfg.n_layers
    n_groups, rem = divmod(cfg.n_layers, k)
    embed0 = x
    shared = params["shared_attn"]

    def mamba(x, i, st):
        x, new_st = _mamba_block(cfg, layer(i), x, state=st)
        if st is not None:
            st.copy_(new_st)
        return x

    def group(x, g):
        for j in range(k):
            x = mamba(x, g * k + j,
                      None if states is None else states["main"][g, j])
        cache = None if caches is None else {"k": caches["k"][g],
                                             "v": caches["v"][g]}
        x, _ = _shared_attn(cfg, shared, x, embed0, inv_freq, cache=cache,
                            cache_index=cache_index, attention=attention)
        return x

    group = _maybe_remat(cfg, group, train=train)
    for g in range(n_groups):
        x = group(x, g)
    for j in range(rem):
        x = mamba(x, n_groups * k + j,
                  None if states is None else states["tail"][j])
    x = rmsnorm(params["final_norm"], x)
    return x, caches, states, {}


def logits(cfg: ModelConfig, params, hidden):
    return unembed(params["embed"], hidden, valid_vocab=cfg.vocab)


def lm_loss(cfg: ModelConfig, params, tokens, labels, *, embeds=None):
    """Mean next-token cross entropy, plus 0.01 x the MoE load balance
    where the family has one.  Returns ``(loss, aux)``.  Attention takes
    the plain path (``attention="plain"``), through which the JAX package
    trains."""
    hidden, _, _, aux = forward(cfg, params, tokens=tokens, embeds=embeds,
                                attention="plain")
    loss = softmax_xent(logits(cfg, params, hidden), labels)
    if "load_balance" in aux:
        loss = loss + 0.01 * aux["load_balance"]
    return loss, aux


# ---------------------------------------------------------------------------
# serving state builders
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, B: int, max_len: int, dtype=torch.bfloat16,
                device=None):
    """Zeroed stacked KV caches (L, B, max_len, KV, Hd) (hybrid: one per
    shared-attention call; ssm: None); ``device`` None means the card."""
    _check_config(cfg)
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe"):
        n = cfg.n_layers
    elif cfg.family == "hybrid":
        n = cfg.n_layers // (cfg.attn_every or cfg.n_layers)
    else:
        return None
    shape = (n, B, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_states(cfg: ModelConfig, B: int, device=None):
    """Zeroed recurrent state with the JAX package's shapes and dtypes:
    ssm ``{"tprev", "fprev"}`` (L, B, 1, D) in the model's dtype and
    ``"wkv"`` (L, B, H, K, K) f32; hybrid ``{"main"}`` (groups, k, B, H, P,
    N) and ``{"tail"}`` (rem, B, H, P, N) f32; None for the attention
    families.  ``device`` None means the card."""
    _check_config(cfg)
    if cfg.family not in ("ssm", "hybrid"):
        return None
    dev = resolve_device(device)
    meta = _ssm_meta(cfg)
    f32 = torch.float32
    if cfg.family == "ssm":
        L, D = cfg.n_layers, cfg.d_model
        H, K = meta["n_heads"], meta["head_dim"]
        return {"tprev": torch.zeros((L, B, 1, D), dtype=cfg.dtype,
                                     device=dev),
                "fprev": torch.zeros((L, B, 1, D), dtype=cfg.dtype,
                                     device=dev),
                "wkv": torch.zeros((L, B, H, K, K), dtype=f32, device=dev)}
    k = cfg.attn_every or cfg.n_layers
    n_groups, rem = divmod(cfg.n_layers, k)
    H, P, N = meta["n_heads"], meta["head_dim"], meta["d_state"]
    return {"main": torch.zeros((n_groups, k, B, H, P, N), dtype=f32,
                                device=dev),
            "tail": torch.zeros((rem, B, H, P, N), dtype=f32, device=dev)}
