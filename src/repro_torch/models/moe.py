"""Mixture-of-Experts with RME-based token dispatch.

The JAX package's ``models/moe.py`` with PyTorch tensors.  The paper's RME
schemes map one-to-one onto MoE routing:
  * **evaluate** — top-k selection of router scores;
  * **assemble** — packing the tokens routed to each expert into a
    contiguous expert-local batch (:func:`repro_torch.core.rme.dispatch_tokens`,
    on the card one launch of the assemble kernel for the whole batch);
  * un-assemble — the weighted sum back to token order.

Dispatch is per sequence; capacity overflow drops tokens (the residual path
keeps them).  Supports shared experts (Qwen2-MoE: 4 shared + 60 routed
top-4, padded to 64 physical experts) and top-1 routing (Llama4-Scout).

The un-assemble is a gather, not a scatter-add: each token reads back its k
slots and sums them in ascending expert order, the order of the JAX
package's serial scatter over the expert-major (E, C) table, so two runs on
the card give the same bits.

``moe_block`` records ``moe/route``, ``moe/dispatch``, ``moe/experts`` and
``moe/combine`` spans on the process's current tracer
(:func:`repro_torch.obs.current`), each timed on the input's device, and
counts ``moe/slots`` (B·E·C) and ``moe/live_slots`` (the slots a token
filled, counted on the device), only when tracing.  Under a checkpointed layer they fire twice a step: in the
forward and in the backward's recompute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.core import rme
from repro_torch.models.layers import MLP_SPECS, _norm_init, init_mlp, mlp
from repro_torch.runtime.sharding import local, shard, whole_seq


def init_moe(gen, d_model: int, d_ff: int, num_experts: int, top_k: int,
             n_shared: int = 0, shared_d_ff: int | None = None,
             dtype=torch.float32, pad_experts: int = 0) -> dict:
    E = max(pad_experts, num_experts)  # physical expert count
    params = {
        "router": _norm_init(gen, (d_model, num_experts),
                             d_model ** -0.5).to(dtype),
        "wi": _norm_init(gen, (E, d_model, 2 * d_ff),
                         d_model ** -0.5).to(dtype),
        "wo": _norm_init(gen, (E, d_ff, d_model), d_ff ** -0.5).to(dtype)}
    if n_shared:
        params["shared"] = init_mlp(gen, d_model, shared_d_ff or d_ff,
                                    dtype=dtype)
    return params


def moe_specs(n_shared: int = 0) -> dict:
    """Logical sharding axes of :func:`init_moe`'s leaves."""
    specs = {"router": ("embed", None),
             "wi": ("experts", "embed_fsdp", "expert_mlp"),
             "wo": ("experts", "expert_mlp", "embed_fsdp")}
    if n_shared:
        specs["shared"] = dict(MLP_SPECS)
    return specs


def capacity_of(S: int, top_k: int, num_experts: int,
                capacity_factor: float = 1.25) -> int:
    """Slots per expert and sequence: the JAX package's rule, over the
    routed (not the padded) expert count."""
    return min(int(capacity_factor * S * top_k / num_experts) + 1, S)


def route(p, x, *, top_k: int, router_softmax: bool = True):
    """Router scores -> ``(probs (B, S, E) f32, gates (B, S, k) f32,
    expert_of (B, S, k) int64)``.  The product rounds to the weights' dtype
    before the cast to f32, as the JAX einsum does; top-k breaks ties by
    the lower expert index (``lax.top_k``'s order), through a stable
    descending sort."""
    scores = (x @ p["router"]).float()
    probs = torch.softmax(scores, dim=-1) if router_softmax \
        else torch.sigmoid(scores)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_of = order.values[..., :top_k], order.indices[..., :top_k]
    if router_softmax and top_k > 1:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, expert_of


def _dispatch(x, expert_of, num_experts: int, capacity: int):
    """All sequences at once: x (B, S, D); expert_of (B, S, k).  Returns
    the slot table (B, E, C) (sentinel S·k), its validity and the gathered
    tokens (B, E, C, D), zero in dead slots."""
    B, S, D = x.shape
    k = expert_of.shape[-1]
    idx, _ = rme.dispatch_tokens(expert_of.reshape(B, S * k), num_experts,
                                 capacity)
    idx = idx.to(torch.int64)
    valid = idx < S * k
    tok = torch.clamp(idx, max=S * k - 1) // k          # slot -> token
    xe = torch.gather(x, 1, tok.reshape(B, -1, 1).expand(-1, -1, D))
    xe = torch.where(valid.reshape(B, -1, 1), xe, 0).reshape(
        B, num_experts, capacity, D)
    return idx, valid, xe


def _experts(p, xe):
    """SwiGLU per expert: xe (B, E, C, D) -> (E, B, C, D), one batched
    product per weight over the E experts (every expert's B·C rows)."""
    B, E, C, D = xe.shape
    rows = xe.transpose(0, 1).reshape(E, B * C, D)
    h = torch.bmm(rows, p["wi"])
    g, u = torch.chunk(h, 2, dim=-1)          # jnp.split: g the first half
    ye = torch.bmm(F.silu(g) * u, p["wo"])
    return ye.view(E, B, C, D)


def _combine(ye, gates, expert_of, idx, valid, S: int):
    """Un-assemble: token (b, s) sums ``gate · ye`` over its k slots that
    were not dropped, in f32, in ascending expert order (the JAX package's
    scatter order).  ye (E, B, C, D); gates, expert_of (B, S, k); idx,
    valid (B, E, C)."""
    E, B, C, D = ye.shape
    k = expert_of.shape[-1]
    # where each slot was packed: e·C + c, or -1 if it was dropped
    packed = torch.arange(E * C, device=ye.device).expand(B, -1)
    where = torch.full((B, S * k + 1), -1, dtype=torch.int64,
                       device=ye.device)
    where.scatter_(1, torch.where(valid, idx, S * k).reshape(B, -1),
                   torch.where(valid.reshape(B, -1), packed, -1))
    where = where[:, :S * k].reshape(B, S, k)
    # ascending expert order within each token (its k experts differ)
    order = torch.argsort(expert_of, dim=-1)
    where = torch.gather(where, 2, order)
    gate = torch.gather(gates, 2, order)
    e = torch.gather(expert_of, 2, order)
    live = where >= 0
    c = torch.where(live, where - e * C, 0)
    b = torch.arange(B, device=ye.device)[:, None, None]
    rows = ye.reshape(E * B * C, D)[(e * B + b) * C + c]     # (B, S, k, D)
    contrib = torch.where(live[..., None], rows * gate[..., None], 0.0)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out


def moe_block(p, x, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, router_softmax: bool = True,
              n_shared: int = 0):
    """x: (B, S, D) -> ``(out (B, S, D), {"load_balance": f32 scalar})``."""
    B, S, D = x.shape
    tr, dev = obs.current(), x.device
    # the router and the per-sequence dispatch read whole sequences
    x = whole_seq(x)
    E_phys = p["wi"].shape[0]  # >= num_experts when padded
    with tr.span("moe/route", device=dev):
        probs, gates, expert_of = route(p, x, top_k=top_k,
                                        router_softmax=router_softmax)
    capacity = capacity_of(S, top_k, num_experts, capacity_factor)
    with tr.span("moe/dispatch", device=dev):
        idx, valid, xe = _dispatch(x, expert_of, E_phys, capacity)
    if tr.enabled:
        # each rank counts its own batch rows
        mine = valid.to_local() if isinstance(valid, DTensor) else valid
        tr.count("moe/slots", mine.numel())
        tr.count("moe/live_slots", mine.sum())
    with tr.span("moe/experts", device=dev):
        # expert-major layout, experts sharded over "model"
        xe = shard(xe, ("batch", "experts", None, None))
        ye = _experts(p, xe)
    # each token reads back its own sequence's slots: local to each rank's
    # batch rows, with every expert's rows at hand
    rows = ("batch", None, None)
    combine = local(_combine, ((None, "batch", None, None), rows, rows, rows,
                               rows, None), rows)
    with tr.span("moe/combine", device=dev):
        out = combine(ye, gates, expert_of, idx, valid, S).to(x.dtype)
    if n_shared:
        out = out + mlp(p["shared"], x)
    # aux load-balancing loss
    me = F.one_hot(expert_of[..., 0], num_experts).float().mean(dim=(0, 1))
    ce = probs.mean(dim=(0, 1))
    return out, {"load_balance": num_experts * torch.sum(me * ce)}
