"""Dispatch-registry rules for the generic coarse-grained TM kernels and
the forwarding-chain megakernel."""

from __future__ import annotations

from functools import lru_cache

from repro_torch.core.affine import MixedRadixMap, batch_extend_map
from repro_torch.core.dispatch import register_chain_rule, register_rule
from repro_torch.core.engine import EW_FNS
from repro_torch.core.instr import TMOpcode
from repro_torch.core.schedule import map_segments
from repro_torch.kernels.tm_affine.chain import (CHAIN_VMEM_BUDGET, ChainSig,
                                                 chain_plan_of,
                                                 chain_slab_bytes, tm_chain)
from repro_torch.kernels.tm_affine.tm_affine import plan_cached, tm_affine


# MixedRadixMap is frozen/hashable: memoize the batch lift so match + run
# share one computation per (map, batch)
_lift_cached = lru_cache(maxsize=512)(batch_extend_map)


def _lifted(ins, srcs, batch_dims) -> MixedRadixMap | None:
    if ins.map_ is None:
        return None
    batch = tuple(srcs[0].shape[:batch_dims])
    if tuple(srcs[0].shape[batch_dims:]) != tuple(ins.map_.in_shape):
        return None
    return _lift_cached(ins.map_, batch)


def _coarse_matches(ins, srcs, batch_dims, segment_bytes=None):
    if ins.opcode != TMOpcode.COARSE:
        return None
    m = _lifted(ins, srcs, batch_dims)
    if m is None:
        return None
    mode = ("block" if plan_cached(m, None, segment_bytes) is not None
            else "gather")
    if ins.ew is not None:
        # the kernel epilogue streams y in output layout — broadcastable
        # operands are the engine's job, decline and fall back
        if len(srcs) != 2 or tuple(srcs[1].shape) != tuple(m.out_shape):
            return None
        return f"cuda.{mode}+ew"
    if len(srcs) != 1:
        return None
    return f"cuda.{mode}"


def _coarse_run(ins, srcs, batch_dims, segment_bytes=None):
    m = _lifted(ins, srcs, batch_dims)
    x = srcs[0].contiguous()
    if ins.ew is not None:
        return tm_affine(x, m, y=srcs[1].contiguous(), ew=ins.ew.value,
                         segment_bytes=segment_bytes)
    return tm_affine(x, m, segment_bytes=segment_bytes)


def _coarse_segments(ins, srcs, batch_dims, segment_bytes=None):
    # the map is already batch-lifted: the cycle model's block iterations
    # for exactly this map — the JAX package's kernel grid
    return map_segments(_lifted(ins, srcs, batch_dims),
                        segment_bytes=segment_bytes)


def _route_matches(ins, srcs, batch_dims, segment_bytes=None):
    if ins.opcode != TMOpcode.COARSE or ins.maps is None:
        return None
    if ins.meta and ins.meta.get("overlay"):
        # overlay Routes (dynamic_update_slice) overwrite rather than sum —
        # the band sum below would double-count the overlapped region, so
        # decline and let the reference engine's where-select run it
        return None
    n_band = len(ins.maps)
    expected = n_band + (1 if ins.ew is not None else 0)
    if len(srcs) != expected:
        return None
    for x, m in zip(srcs, ins.maps):
        if tuple(x.shape[batch_dims:]) != tuple(m.in_shape):
            return None
    return "cuda.route+ew" if ins.ew is not None else "cuda.route"


def _route_run(ins, srcs, batch_dims, segment_bytes=None):
    # band loop (Branch stage): one kernel launch per band, disjoint supports
    # summed (the sum is a plain torch add, as the JAX package leaves it to
    # XLA)
    batch = tuple(srcs[0].shape[:batch_dims])
    out = None
    for x, m in zip(srcs, ins.maps):
        band = tm_affine(x.contiguous(), _lift_cached(m, batch),
                         segment_bytes=segment_bytes)
        out = band if out is None else out + band
    if ins.ew is not None:
        out = EW_FNS[ins.ew.value](out, srcs[-1])
    return out


def _route_segments(ins, srcs, batch_dims, segment_bytes=None):
    batch = tuple(srcs[0].shape[:batch_dims])
    return sum(map_segments(_lift_cached(m, batch),
                            segment_bytes=segment_bytes) for m in ins.maps)


# ---------------------------------------------------------------------------
# chain rule: a forwarding chain of coarse instructions as ONE megakernel
# (kernels/tm_affine/chain.py) — intermediates stay in registers
# ---------------------------------------------------------------------------

def _chain_sig_build(instrs, srcs, batch_dims, segment_bytes):
    """Build ``(ChainSig, operand slabs)``, or ``(None, None)`` when this
    rule cannot take the chain.

    Legal chains: every link COARSE; links 1..k-1 single-map with the
    streamed buffer as their data source (``srcs[k][0] is None``); the last
    link may instead be a multi-band Route whose chain band is the streamed
    buffer.  Epilogue operands must already be in the link's (lifted) output
    layout — the same contract as the per-instruction rule.
    """
    x = srcs[0][0]
    if x is None or instrs[0].opcode != TMOpcode.COARSE:
        return None, None
    batch = tuple(x.shape[:batch_dims])
    dtype = x.dtype
    links = []
    route_maps = None
    route_band = 0
    prev_out = None
    slabs = []
    n = len(instrs)
    for k, ins in enumerate(instrs):
        if ins.opcode != TMOpcode.COARSE:
            return None, None
        cur_srcs = srcs[k]
        if ins.maps is not None:
            # multi-band Route — only as the terminal link, without epilogue;
            # overlay Routes (overwrite semantics) never chain: the chain
            # kernel sums bands
            if k != n - 1 or ins.ew is not None \
                    or (ins.meta and ins.meta.get("overlay")):
                return None, None
            if len(cur_srcs) != len(ins.maps):
                return None, None
            band = [i for i, s in enumerate(cur_srcs) if s is None]
            if k == 0 or len(band) != 1:
                return None, None
            route_band = band[0]
            route_maps = []
            for i, (s, m) in enumerate(zip(cur_srcs, ins.maps)):
                lifted = _lift_cached(m, batch)
                if i == route_band:
                    if lifted.in_shape != prev_out:
                        return None, None
                else:
                    if s is None or tuple(s.shape) != lifted.in_shape \
                            or s.dtype != dtype:
                        return None, None
                    slabs.append(s)
                route_maps.append(lifted)
            route_maps = tuple(route_maps)
            break
        if ins.map_ is None:
            return None, None
        m = _lift_cached(ins.map_, batch)
        if k == 0:
            if tuple(x.shape) != m.in_shape:
                return None, None
        else:
            if cur_srcs[0] is not None or m.in_shape != prev_out:
                return None, None
        ew = None
        if ins.ew is not None:
            if len(cur_srcs) != 2:
                return None, None
            y = cur_srcs[1]
            if y is None or tuple(y.shape) != m.out_shape or y.dtype != dtype:
                return None, None
            ew = ins.ew.value
            slabs.append(y)
        elif len(cur_srcs) != 1:
            return None, None
        links.append((m, ew))
        prev_out = m.out_shape
    sig = ChainSig(links=tuple(links), route_maps=route_maps,
                   route_band=route_band,
                   dtype=str(dtype).removeprefix("torch."),
                   segment_bytes=segment_bytes)
    return sig, tuple(slabs)


def _chain_lower(instrs, srcs, batch_dims, segment_bytes=None):
    """Single-pass chain lowering: legality + build + run, or None.  A
    claimed chain on a CUDA tensor launches the kernel or raises."""
    sig, slabs = _chain_sig_build(instrs, srcs, batch_dims, segment_bytes)
    if sig is None:
        return None
    if chain_slab_bytes(sig, srcs[0][0], slabs) > CHAIN_VMEM_BUDGET:
        return None  # the JAX package's VMEM decline, kept for parity
    val = tm_chain(sig, srcs[0][0].contiguous(),
                   tuple(s.contiguous() for s in slabs))
    path = ("cuda.chain+route" if sig.route_maps is not None
            else "cuda.chain")
    return val, path, chain_plan_of(sig).n_segments


register_rule("tm_affine.route", _route_matches, _route_run, priority=10,
              segments=_route_segments,
              launches=lambda ins, srcs, batch_dims: len(ins.maps))
register_rule("tm_affine", _coarse_matches, _coarse_run, priority=0,
              segments=_coarse_segments)
register_chain_rule("tm_affine.chain", _chain_lower, priority=0)
