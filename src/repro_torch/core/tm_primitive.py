"""PyTorch custom ops that tag TM operators inside a traced graph.

The compiler (:mod:`repro_torch.compiler`) recovers TM instructions from a
traced program two ways: by pattern-matching raw aten ops (permute, view,
slice, constant_pad_nd, cat, flip, expand, same-shape elementwise), and —
for the operators of :mod:`repro_torch.core.tm_ops`, whose eager form is an
index gather — by *tagging*: inside :func:`tag_tm_ops`, every tm_ops
callable calls one of the custom ops below instead of executing, leaving a
single node in the ``make_fx`` graph whose arguments carry the exact
:class:`~repro_torch.core.affine.MixedRadixMap` (as the JSON string of the
JAX package's primitive params — the TMU's register contents).  Outside
the tagging context the ops execute normally.

Each op has a fake implementation that gives the output's shape and an
implementation that is the engine, so a tagged graph evaluated op by op
still computes the right values — tagging never changes semantics, only
visibility.  The counterpart of the JAX package's ``tm_map`` /
``tm_route`` / ``tm_resize`` / ``tm_evaluate`` primitives.

Each op also has a vmap rule, the counterpart of the JAX batchers, so
``torch.func.vmap`` of a tagged function (what the serving layer compiles)
leaves ONE node per op, not one per sample: the mapped axis moves to the
front and ``batch_dims`` grows by one.
"""

from __future__ import annotations

import contextlib
import json
import threading

import torch

# per thread: the serving layer compiles on its admission threads while
# other threads run the same tm_ops eagerly
_STATE = threading.local()


def tagging() -> bool:
    """True inside a :func:`tag_tm_ops` context (compiler trace in progress)
    on this thread."""
    return getattr(_STATE, "tagging", False)


@contextlib.contextmanager
def tag_tm_ops():
    """Make tm_ops callables call the tagging ops instead of executing, on
    this thread."""
    prev = tagging()
    _STATE.tagging = True
    try:
        yield
    finally:
        _STATE.tagging = prev


def decode_map(map_json: str):
    from repro_torch.core.affine import MixedRadixMap
    return MixedRadixMap.decode(json.loads(map_json))


def encode_map(m) -> str:
    """The JAX package's serialization of a MixedRadixMap (its primitive
    params), byte for byte."""
    return json.dumps(m.encode(), sort_keys=True)


# ---------------------------------------------------------------------------
# tm_map — one coarse-grained instruction (single gather map)
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::tm_map", mutates_args=())
def tm_map(x: torch.Tensor, map_json: str, batch_dims: int) -> torch.Tensor:
    from repro_torch.core.engine import apply_map
    return apply_map(decode_map(map_json), x, batch_dims=batch_dims)


@tm_map.register_fake
def _(x, map_json, batch_dims):
    m = decode_map(map_json)
    return x.new_empty(tuple(x.shape[:batch_dims]) + tuple(m.out_shape))


@tm_map.register_vmap
def _(info, in_dims, x, map_json, batch_dims):
    return tm_map(x.movedim(in_dims[0], 0), map_json, batch_dims + 1), 0


def bind_map(m, x: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    return tm_map(x, encode_map(m), batch_dims)


# ---------------------------------------------------------------------------
# tm_route — multi-band coarse instruction (Route / concat)
# ---------------------------------------------------------------------------

@torch.library.custom_op(
    "repro_torch::tm_route", mutates_args=(),
    schema="(Tensor[] xs, str[] maps_json, int batch_dims) -> Tensor")
def tm_route(xs: list[torch.Tensor], maps_json: list[str],
             batch_dims: int) -> torch.Tensor:
    from repro_torch.core.engine import route_gather
    return route_gather([decode_map(s) for s in maps_json], xs,
                        batch_dims=batch_dims)


@tm_route.register_fake
def _(xs, maps_json, batch_dims):
    m = decode_map(maps_json[0])
    return xs[0].new_empty(tuple(xs[0].shape[:batch_dims])
                           + tuple(m.out_shape))


@tm_route.register_vmap
def _(info, in_dims, xs, maps_json, batch_dims):
    # unmapped bands are broadcast along the new axis, as the JAX batcher
    # broadcasts them
    xs = [x.expand((info.batch_size,) + tuple(x.shape)) if d is None
          else x.movedim(d, 0) for x, d in zip(xs, in_dims[0])]
    return tm_route(xs, maps_json, batch_dims + 1), 0


def bind_route(maps, xs, batch_dims: int = 0) -> torch.Tensor:
    return tm_route(list(xs), [encode_map(m) for m in maps], batch_dims)


# ---------------------------------------------------------------------------
# tm_resize — fine-grained bilinear Resize
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::tm_resize", mutates_args=())
def tm_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    from repro_torch.core.tm_ops import _resize_bilinear_impl
    return _resize_bilinear_impl(x, out_h, out_w)


@tm_resize.register_fake
def _(x, out_h, out_w):
    return x.new_empty(tuple(x.shape[:-3]) + (out_h, out_w, x.shape[-1]))


# resize and evaluate work on trailing core axes natively, so vmap is just
# "mapped axis to the front"
@tm_resize.register_vmap
def _(info, in_dims, x, out_h, out_w):
    return tm_resize(x.movedim(in_dims[0], 0), out_h, out_w), 0


# ---------------------------------------------------------------------------
# tm_evaluate — fine-grained RME evaluate (Bboxcal rows), leading batch axes
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::tm_evaluate", mutates_args=())
def tm_evaluate(x: torch.Tensor, threshold: float, capacity: int, cmp: str,
                score_index: int) -> torch.Tensor:
    from repro_torch.core.tm_ops import _bboxcal_rows_impl
    return _bboxcal_rows_impl(x, threshold, capacity, cmp, score_index)


@tm_evaluate.register_fake
def _(x, threshold, capacity, cmp, score_index):
    return x.new_empty(tuple(x.shape[:-2]) + (capacity, x.shape[-1]))


@tm_evaluate.register_vmap
def _(info, in_dims, x, threshold, capacity, cmp, score_index):
    return tm_evaluate(x.movedim(in_dims[0], 0), threshold, capacity, cmp,
                       score_index), 0
