"""Train, prefill and decode step builders (the JAX package's
``runtime/step.py``).

``make_train_step(cfg)`` returns ``(state, batch) -> (state, metrics)``;
the state is a plain dict, so the checkpoint manager can flatten it.  Its
distributed-optimization hooks, as in JAX: optional int8 gradient
compression with error feedback, and the cosine learning rate computed on
the device (no host sync).  The serving builders return plain functions
of ``(params, tokens, caches, states, ...)``.  PyTorch runs eagerly, so
nothing is jitted; the state, caches and recurrent states are written in
place (the JAX package donates them).  ``attention`` is passed to the
model's forward: ``"flash"`` (the kernels) or ``"plain"`` (the JAX
package's jnp attention, ported); training always runs plain.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.models.transformer import (ModelConfig, forward, init_lm,
                                            lm_loss, logits)
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     cosine_schedule)
from repro_torch.optim.compression import (compress_decompress,
                                           compression_init)
from repro_torch.runtime.sharding import shard
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def init_train_state(cfg: ModelConfig, gen: torch.Generator, *,
                     compress: bool = False, device=None) -> dict:
    """``{"params", "opt": {"step", "master", "m", "v"}}`` (and ``"ef"``
    with ``compress``), the parameters drawn from ``gen`` on ``device``
    (None means the card).  The JAX package also returns the parameters'
    sharding specs: here ``lm_specs(cfg)``, and :func:`state_specs` of
    them for the whole state."""
    return train_state_of(init_lm(cfg, gen, device=device),
                          compress=compress)


def train_state_of(params, *, compress: bool = False) -> dict:
    """The train state around ``params``: the optimizer's f32 master, m
    and v (and the compression's error feedback) made from them, so for
    parameters on a mesh, as each rank's shards."""
    opt = adamw_init(params)
    state = {"params": params,
             "opt": {"step": opt.step, "master": opt.master,
                     "m": opt.m, "v": opt.v}}
    if compress:
        state["ef"] = compression_init(params)
    return state


def state_specs(param_specs, *, compress: bool = False):
    """Logical-axis spec tree for the full train state (for tree_sharding)."""
    st = {"params": param_specs,
          "opt": {"step": None, "master": param_specs,
                  "m": param_specs, "v": param_specs}}
    if compress:
        st["ef"] = param_specs
    return st


def _placed_like(grad, param):
    """A DTensor gradient redistributed to its parameter's placements (a
    partial sum is reduced); a plain one as it is."""
    if isinstance(grad, DTensor):
        return grad.redistribute(param.device_mesh, param.placements)
    return grad


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total: int = 10000,
                    compress: bool = False, max_norm: float = 1.0,
                    tracer=None):
    """``train_step(state, batch)`` -> ``(state, metrics)``: ``lm_loss``
    and its gradient with respect to every parameter, then (with
    ``compress``) the int8 round trip, then AdamW at the learning rate of
    the step count *before* the update (so step 0 runs at lr 0 in
    warmup), every parameter cast to ``cfg.dtype``.  ``batch`` holds
    ``labels`` and ``tokens`` or ``embeds``.  Metrics (0-d tensors):
    ``loss``, ``lr``, ``grad_norm`` and, for dense and moe,
    ``load_balance``, plain tensors also when the state lies on a mesh.
    Under a mesh (the state DTensors, the step inside ``use_rules``) each
    gradient is redistributed to its parameter's placements before the
    compression and AdamW.

    Each call is a ``train/step`` span of ``tracer`` (None: the process's
    current one at the call, :func:`repro_torch.obs.current`), run under
    ``obs.use`` of it so the model's spans join it, holding
    ``train/forward`` (``lm_loss``), ``train/backward`` (the gradient,
    each layer's recompute included), ``train/compress`` (with
    ``compress``) and ``train/optimizer`` (the schedule and AdamW), each
    timed on the batch's device."""
    def train_step(state, batch):
        tr = obs.current() if tracer is None else tracer
        dev = batch["labels"].device
        with obs.use(tr), tr.span("train/step", device=dev):
            return _train_step(state, batch, tr, dev)

    def _train_step(state, batch, tr, dev):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        leaves = tree_leaves(params)
        with torch.enable_grad():
            with tr.span("train/forward", device=dev):
                loss, aux = lm_loss(cfg, params, batch.get("tokens"),
                                    batch["labels"],
                                    embeds=batch.get("embeds"))
            # a frontend's weights that the loss does not read get zeros
            with tr.span("train/backward", device=dev):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        by_leaf = dict(zip(map(id, leaves), grads))
        # under a mesh: each gradient onto its parameter's placements, where
        # the data-parallel all-reduce and the FSDP reduce-scatter happen
        grads = tree_map(lambda p: _placed_like(by_leaf[id(p)], p), params)
        new_state = dict(state)
        if compress:
            with tr.span("train/compress", device=dev):
                grads, new_state["ef"] = compress_decompress(grads,
                                                             state["ef"])
        opt = AdamWState(**state["opt"])
        with tr.span("train/optimizer", device=dev):
            lr = cosine_schedule(opt.step, peak_lr=peak_lr, warmup=warmup,
                                 total=total)
            params, opt, om = adamw_update(grads, opt, lr, max_norm=max_norm,
                                           param_dtype=cfg.dtype,
                                           params=state["params"])
        new_state["params"] = params
        new_state["opt"] = {"step": opt.step, "master": opt.master,
                            "m": opt.m, "v": opt.v}
        metrics = {"loss": loss.detach(), "lr": lr, **om,
                   **{k: v.detach() for k, v in aux.items()}}
        return new_state, {k: _whole(v) for k, v in metrics.items()}

    return train_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, *, attention: str = "flash"):
    def prefill_step(params, tokens, caches, states):
        hidden, caches, states, _ = forward(cfg, params, tokens=tokens,
                                            caches=caches, cache_index=0,
                                            states=states,
                                            attention=attention)
        lg = logits(cfg, params, hidden[:, -1:])
        return lg, caches, states

    return prefill_step


def make_prefill_embeds_step(cfg: ModelConfig, *, attention: str = "flash"):
    """Prefill from precomputed embeddings (the audio / vision stub
    frontends): ``prefill_step(params, embeds, caches, states)``."""
    def prefill_step(params, embeds, caches, states):
        hidden, caches, states, _ = forward(cfg, params, embeds=embeds,
                                            caches=caches, cache_index=0,
                                            states=states,
                                            attention=attention)
        lg = logits(cfg, params, hidden[:, -1:])
        return lg, caches, states

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, sample: bool = False,
                     temperature: float = 1.0, attention: str = "flash"):
    """``decode_step(params, token, caches, states, index, gen=None)`` ->
    ``(next_token (B, 1) int32, logits, caches, states)``: greedy, or with
    ``sample=True`` a draw from softmax(logits / temperature) using the
    explicit ``torch.Generator`` ``gen``."""
    def decode_step(params, token, caches, states, index: int, gen=None):
        hidden, caches, states, _ = forward(cfg, params, tokens=token,
                                            caches=caches, cache_index=index,
                                            states=states,
                                            attention=attention)
        lg = logits(cfg, params, hidden)
        if sample:
            if gen is None:
                raise ValueError("decode_step: sample=True needs a "
                                 "torch.Generator (gen=...)")
            probs = torch.softmax(lg[:, -1].float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            # the greedy pick reads every vocab shard (under the rules the
            # vocab lies over "model"): the last logits whole first
            nxt = torch.argmax(shard(lg[:, -1], ("batch", None)), dim=-1)
        return nxt[:, None].to(torch.int32), lg, caches, states

    return decode_step


def serve_state_specs(cfg: ModelConfig, *, long_context: bool = False):
    """Logical axes for KV caches / SSM states.

    The cache sequence axis carries the logical name "kv_seq"; the per-cell
    rules map it to "model" (regular decode: distributed flash-decode) or
    "data" (long_context batch=1), or drop it (train/prefill)."""
    del long_context  # resolution happens in the rules table
    if cfg.family in ("dense", "moe", "hybrid"):
        caches = {"k": (None, "batch", "kv_seq", "kv_heads", None),
                  "v": (None, "batch", "kv_seq", "kv_heads", None)}
    else:
        caches = None
    if cfg.family == "ssm":
        states = {"tprev": (None, "batch", None, None),
                  "fprev": (None, "batch", None, None),
                  "wkv": (None, "batch", None, None, None)}
    elif cfg.family == "hybrid":
        states = {"main": (None, None, "batch", None, None, None),
                  "tail": (None, "batch", None, None, None)}
    else:
        states = None
    return caches, states
