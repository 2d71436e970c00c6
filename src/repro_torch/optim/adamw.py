"""AdamW with f32 master weights, global-norm clipping, cosine schedule.

The JAX package's ``optim/adamw.py`` with PyTorch tensors.  Model
parameters live in the model's dtype (what the products read); the
optimizer keeps f32 master weights and moments.  Where JAX builds new
trees (and donates the old ones), the master weights and moments are
updated in place, in slices of at most ``CHUNK`` elements, so a large
leaf's temporaries stay small; the global norm scales each slice instead
of a clipped f32 copy of every gradient.  ``step`` and the learning rate
stay 0-d tensors on the device: nothing here waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.tree import tree_leaves, tree_map

CHUNK = 1 << 26  # elements of a leaf updated at once (256 MB in f32)


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor   # 0-d int32, on the parameters' device
    master: Any          # f32 copies of params
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    dev = tree_leaves(master)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      master=master, m=tree_map(torch.zeros_like, master),
                      v=tree_map(torch.zeros_like, master))


def _local(t):
    """A DTensor's shard on this rank; a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _chunks(t: torch.Tensor):
    """Views of ``t``'s slices: writes to them land in ``t``, and a
    strided ``t`` raises instead of updating a copy.  A DTensor's are
    slices of its shard on this rank: the update is elementwise, and the
    state's leaves lie as their parameter does."""
    return _local(t).view(-1).split(CHUNK)


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    local = sum(torch.sum(torch.square(c.float()))
                for c in _chunks(g.contiguous()))
    if not isinstance(g, DTensor):
        return local
    # each rank summed its shard: a partial sum over the mesh dims the leaf
    # is sharded on, the whole sum on the others
    return DTensor.from_local(local, g.device_mesh, [
        Partial() if p.is_shard() else Replicate() for p in g.placements],
        run_check=False)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32."""
    return torch.sqrt(sum(_sum_squares(g) for g in tree_leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def global_norm_clip(grads, max_norm: float):
    """Returns ``(grads widened to f32 and scaled to a global norm of at
    most max_norm, the norm before)``."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def adamw_update(grads, state: AdamWState, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, max_norm=1.0, param_dtype=torch.bfloat16,
                 params=None):
    """Returns ``(new_params, state, metrics)``; ``state`` is updated in
    place.  Every new parameter is the master weight cast to
    ``param_dtype``: written into the matching leaf of ``params`` where
    that leaf has ``param_dtype``, else a new tensor (the f32 leaves of a
    bf16 tree become bf16, as in JAX)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    state.step += 1
    t = state.step.float()
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    # the scalars on this rank, for the updates of the local shards
    scale, c1, c2, lr = (_local(x) for x in (scale, c1, c2, lr))

    def upd(g, mu, nu, w, p=None):
        for gc, mc, nc, wc in zip(_chunks(g.contiguous()), _chunks(mu),
                                  _chunks(nu), _chunks(w)):
            gc = gc.float() * scale
            mc.mul_(b1).add_(gc, alpha=1 - b1)
            nc.mul_(b2).addcmul_(gc, gc, value=1 - b2)
            denom = (nc / c2).sqrt_().add_(eps)
            step = (mc / c1).div_(denom).add_(wc, alpha=weight_decay)
            wc.sub_(step.mul_(lr))
        if p is not None and p.dtype == param_dtype:
            return p.copy_(w)
        return w.to(param_dtype, copy=True)

    if params is None:
        new = tree_map(upd, grads, state.m, state.v, state.master)
    else:
        new = tree_map(upd, grads, state.m, state.v, state.master, params)
    return new, state, {"grad_norm": gn}


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total``; a 0-d f32 tensor on
    ``step``'s device."""
    t = torch.as_tensor(step).float()
    warm = peak_lr * t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
