"""Dispatch-registry rules for the generic coarse-grained TM kernels."""

from __future__ import annotations

from functools import lru_cache

from repro_torch.core.affine import MixedRadixMap, batch_extend_map
from repro_torch.core.dispatch import register_rule
from repro_torch.core.engine import EW_FNS
from repro_torch.core.instr import TMOpcode
from repro_torch.core.schedule import map_segments
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


register_rule("tm_affine.route", _route_matches, _route_run, priority=10,
              segments=_route_segments,
              launches=lambda ins, srcs, batch_dims: len(ins.maps))
register_rule("tm_affine", _coarse_matches, _coarse_run, priority=0,
              segments=_coarse_segments)
