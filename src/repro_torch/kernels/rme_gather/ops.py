"""Dispatch-registry rules for the RME compaction kernels.

FINE_EVALUATE instructions with a runtime threshold and a static capacity
lower onto the evaluate kernel, and FINE_ASSEMBLE instructions with a
runtime mask onto the assemble kernel, with any number of leading batch
axes flattened onto their grids of record streams.  Top-k and static lane
masks fall back to the engine.  A chain rule pulls coarse pre-links into
the evaluate kernel's load (detect tails: reshape + Bboxcal as one
launch).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from repro_torch.core.affine import batch_extend_map
from repro_torch.core.dispatch import register_chain_rule, register_rule
from repro_torch.core.instr import TMOpcode
from repro_torch.kernels.rme_gather.rme_gather import (assemble,
                                                       assemble_batched,
                                                       evaluate,
                                                       evaluate_batched,
                                                       evaluate_chained)
from repro_torch.kernels.tm_affine.chain import CHAIN_VMEM_BUDGET, fold_pullback


def _evaluate_matches(ins, srcs, batch_dims, segment_bytes=None):
    if ins.opcode != TMOpcode.FINE_EVALUATE:
        return None
    cfg = ins.rme
    if cfg.top_k is not None or cfg.capacity is None or cfg.threshold is None:
        return None
    if len(srcs) != 1 or srcs[0].ndim != batch_dims + 2:
        return None
    return "cuda.rme.evaluate"


def _evaluate_run(ins, srcs, batch_dims, segment_bytes=None):
    cfg = ins.rme
    x = srcs[0].contiguous()
    if batch_dims == 0:
        rows, _, _ = evaluate(x, cfg.threshold, cfg.capacity, cmp=cfg.cmp,
                              score_index=cfg.score_index)
        return rows
    batch = tuple(x.shape[:batch_dims])
    rows, _, _ = evaluate_batched(
        x.reshape((-1,) + tuple(x.shape[batch_dims:])), cfg.threshold,
        cfg.capacity, cmp=cfg.cmp, score_index=cfg.score_index)
    return rows.reshape(batch + tuple(rows.shape[1:]))


def _assemble_matches(ins, srcs, batch_dims, segment_bytes=None):
    if ins.opcode != TMOpcode.FINE_ASSEMBLE:
        return None
    cfg = ins.rme
    if cfg.lane_mask is not None or cfg.capacity is None:
        return None
    if len(srcs) != 2 or srcs[0].ndim != batch_dims + 2 \
            or srcs[1].ndim != batch_dims + 1:
        return None
    if tuple(srcs[0].shape[:-1]) != tuple(srcs[1].shape):
        return None
    return "cuda.rme.assemble"


def _assemble_run(ins, srcs, batch_dims, segment_bytes=None):
    x, mask = srcs[0].contiguous(), srcs[1].contiguous()
    if batch_dims == 0:
        packed, _ = assemble(x, mask, ins.rme.capacity)
        return packed
    batch = tuple(x.shape[:batch_dims])
    packed, _ = assemble_batched(
        x.reshape((-1,) + tuple(x.shape[batch_dims:])),
        mask.reshape((-1,) + tuple(mask.shape[batch_dims:])),
        ins.rme.capacity)
    return packed.reshape(batch + tuple(packed.shape[1:]))


def _rme_segments(ins, srcs, batch_dims, segment_bytes=None):
    # one compaction pass per record stream
    return max(1, math.prod(srcs[0].shape[:batch_dims]))


# ---------------------------------------------------------------------------
# chain rule: coarse pre-links pulled back into the evaluate kernel's load —
# the record stream is gathered from the chain input slab and compacted in
# one launch (detect tails: layout Rearrange/reshape + Bboxcal as one kernel)
# ---------------------------------------------------------------------------

_lift_cached = lru_cache(maxsize=512)(batch_extend_map)


def _chain_eval_maps(instrs, srcs, batch_dims):
    """Lifted pre-link maps + the FINE link's stream rank, or (None, 0).
    The FINE link's batch axes are the executor's plus its own
    ``meta['batch_dims']``."""
    last = instrs[-1]
    if last.opcode != TMOpcode.FINE_EVALUATE:
        return None, 0
    cfg = last.rme
    if cfg.top_k is not None or cfg.capacity is None or cfg.threshold is None:
        return None, 0
    if len(last.srcs) != 1 or srcs[-1][0] is not None:
        return None, 0
    x = srcs[0][0]
    if x is None:
        return None, 0
    batch = tuple(x.shape[:batch_dims])
    maps = []
    for k, ins in enumerate(instrs[:-1]):
        if ins.opcode != TMOpcode.COARSE or ins.map_ is None \
                or ins.ew is not None or len(ins.srcs) != 1:
            return None, 0
        if k > 0 and srcs[k][0] is not None:
            return None, 0
        m = _lift_cached(ins.map_, batch)
        if k == 0 and tuple(x.shape) != m.in_shape:
            return None, 0
        if maps and m.in_shape != maps[-1].out_shape:
            return None, 0
        maps.append(m)
    fine_bd = batch_dims + (last.meta or {}).get("batch_dims", 0)
    if len(maps[-1].out_shape) != fine_bd + 2:
        return None, 0
    return tuple(maps), fine_bd


@lru_cache(maxsize=256)
def _chain_eval_pullback(maps):
    """(idx, ok, fill) numpy constants on the stream grid, or None on mixed
    fills (a permanent decline — cached, so repeat executor runs stay
    cheap)."""
    try:
        J, OK, fill = fold_pullback(maps)
    except ValueError:
        return None
    stream = maps[-1].out_shape
    N, D = stream[-2], stream[-1]
    return (J.reshape(-1, N, D),
            None if OK is None else OK.reshape(-1, N, D), fill)


@lru_cache(maxsize=64)
def _chain_eval_consts(maps, device: torch.device):
    """The pullback on one device, uploaded once per (maps, device)."""
    pulled = _chain_eval_pullback(maps)
    if pulled is None:
        return None
    idx, ok, fill = pulled
    return (torch.from_numpy(idx).to(device),
            None if ok is None else torch.from_numpy(ok).to(device), fill)


def _chain_eval_lower(instrs, srcs, batch_dims, segment_bytes=None):
    """Single-pass chained-evaluate lowering, or None.  A claimed chain on a
    CUDA tensor launches the kernel or raises."""
    maps, _ = _chain_eval_maps(instrs, srcs, batch_dims)
    if maps is None:
        return None
    x = srcs[0][0]
    stream_elems = math.prod(maps[-1].out_shape)
    # the chain slab plus the pullback index/mask constants: the JAX
    # package's VMEM decline, the same rule as tm_affine.chain
    if x.numel() * x.element_size() + 8 * stream_elems > CHAIN_VMEM_BUDGET:
        return None
    pulled = _chain_eval_consts(maps, x.device)
    if pulled is None:
        return None
    idx, ok, fill = pulled
    cfg = instrs[-1].rme
    stream = maps[-1].out_shape
    rows, _, _ = evaluate_chained(
        x.contiguous(), idx, ok, fill, cfg.threshold, cfg.capacity,
        cmp=cfg.cmp, score_index=cfg.score_index)
    val = rows.reshape(tuple(stream[:-2]) + tuple(rows.shape[1:]))
    return val, "cuda.chain+rme.evaluate", max(1, math.prod(stream[:-2]))


register_rule("rme_gather.evaluate", _evaluate_matches, _evaluate_run,
              priority=10, segments=_rme_segments)
register_rule("rme_gather.assemble", _assemble_matches, _assemble_run,
              priority=10, segments=_rme_segments)
register_chain_rule("rme_gather.chain_evaluate", _chain_eval_lower,
                    priority=10)
