"""torch.fx -> TM IR front end.

Walks a ``make_fx`` graph (aten ops at concrete shapes) and pattern-matches
tensor-manipulation calls into :class:`~repro_torch.core.instr.TMInstr`
candidates, leaving everything else (mm, the NHWC conv, activations, …) as
opaque :class:`~repro_torch.compiler.ir.TPUNode` calls.  Two match sources,
as in the JAX package's jaxpr front end:

* **raw aten ops** — permute/t/transpose, view/_unsafe_view/reshape,
  squeeze/unsqueeze, slice, constant_pad_nd, cat, flip, expand, clone/copy,
  and same-shape elementwise add/sub/mul/maximum, each rebuilt as the exact
  :class:`~repro_torch.core.affine.MixedRadixMap` the JAX matcher builds
  for the equivalent lax primitive;
* **tagged tm_ops** — inside :func:`repro_torch.core.tm_primitive.tag_tm_ops`
  the operator library calls the ``tm_map`` / ``tm_route`` / ``tm_resize``
  / ``tm_evaluate`` custom ops, whose arguments carry the exact map.

aten is finer than a jaxpr (a multi-axis slice is one ``slice`` per axis,
a reshape of a non-contiguous tensor is ``clone`` + ``view``); the pass
pipeline's composition and copy elimination absorb the difference.
"""

from __future__ import annotations

import itertools
import json
import math
import operator

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import affine as af
from repro_torch.core.affine import MixedRadixMap, batch_extend_map
from repro_torch.core.instr import EwOp, RMEConfig, TMInstr, TMOpcode
from repro_torch.compiler.ir import (Buffer, BufRef, TMGraph, TMNode, TPUNode,
                                     eval_tpu_node)

# all-constant calls fold at trace time up to this output size — this is
# how scalar preprocessing becomes a register constant the matchers can read
_CONST_FOLD_LIMIT = 1 << 20

aten = torch.ops.aten
_EW_OPS = {aten.add.Tensor: EwOp.ADD, aten.sub.Tensor: EwOp.SUB,
           aten.mul.Tensor: EwOp.MUL, aten.maximum.default: EwOp.MAX}
_RESHAPE_OPS = {aten.view.default, aten._unsafe_view.default,
                aten.reshape.default, aten.squeeze.default,
                aten.squeeze.dim, aten.squeeze.dims, aten.unsqueeze.default}


def _shape(n) -> tuple[int, ...]:
    return tuple(int(d) for d in n.meta["val"].shape)


def _axis(d: int, nd: int) -> int:
    return d % nd if nd else 0


# ---------------------------------------------------------------------------
# per-call matchers: node -> TMInstr ingredients (maps / rme / ew) or None
# ---------------------------------------------------------------------------

def _match_tm(node):
    """Return a dict describing the TM instruction, or None to stay opaque."""
    op = node.target
    args = node.args
    kw = node.kwargs
    tensor_args = [a for a in pytree.tree_leaves((args, kw))
                   if isinstance(a, torch.fx.Node)]
    if not tensor_args:
        return None
    x = args[0]
    in_shape = _shape(x) if isinstance(x, torch.fx.Node) else None
    out_shape = _shape(node)
    ns = torch.ops.repro_torch

    if op == ns.tm_map.default:
        m = MixedRadixMap.decode(json.loads(args[1]))
        b = args[2]
        if b:  # lift over the leading batch axes: the graph runs at rank
            m = batch_extend_map(m, in_shape[:b])
        return {"map": m}
    if op == ns.tm_route.default:
        maps = [MixedRadixMap.decode(json.loads(s)) for s in args[1]]
        b = args[2]
        if b:
            maps = [batch_extend_map(m, _shape(v)[:b])
                    for m, v in zip(maps, args[0])]
        return {"maps": tuple(maps)}
    if op == ns.tm_resize.default:
        return {"resize": {"out_h": args[1], "out_w": args[2],
                           "batch_dims": len(in_shape) - 3}}
    if op == ns.tm_evaluate.default:
        # batch_dims is deliberately left unset: the rme-legalize pass pins
        # it from the buffer shapes
        return {"rme": RMEConfig(scheme="evaluate", threshold=args[1],
                                 cmp=args[3], score_index=args[4],
                                 capacity=args[2])}

    nd = len(in_shape) if in_shape is not None else 0
    if op == aten.permute.default:
        return {"map": af.axis_permutation_map(
            in_shape, [_axis(d, nd) for d in args[1]])}
    if op == aten.t.default:
        return {"map": af.axis_permutation_map(in_shape,
                                               tuple(reversed(range(nd))))}
    if op == aten.transpose.int:
        perm = list(range(nd))
        d0, d1 = _axis(args[1], nd), _axis(args[2], nd)
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return {"map": af.axis_permutation_map(in_shape, perm)}
    if op in _RESHAPE_OPS:
        m = af.reshape_map(in_shape, out_shape)
        return {"map": m} if m is not None else None
    if op == aten.slice.Tensor:
        dim = _axis(args[1] if len(args) > 1 else kw.get("dim", 0), nd)
        start = args[2] if len(args) > 2 else kw.get("start")
        step = args[4] if len(args) > 4 else kw.get("step", 1)
        size = in_shape[dim]
        start = 0 if start is None else start
        start = min(max(start + size if start < 0 else start, 0), size)
        starts = [0] * nd
        strides = [1] * nd
        starts[dim], strides[dim] = start, int(step)
        return {"map": af.strided_slice_map(in_shape, starts, strides,
                                            out_shape)}
    if op == aten.constant_pad_nd.default:
        pad = list(args[1])
        fill = args[2] if len(args) > 2 else kw.get("value", 0)
        lo, hi = [0] * nd, [0] * nd
        for i in range(len(pad) // 2):
            lo[nd - 1 - i], hi[nd - 1 - i] = pad[2 * i], pad[2 * i + 1]
        return {"map": af.pad_map(in_shape, lo, hi, fill=float(fill))}
    if op == aten.cat.default:
        xs = list(args[0])
        if not all(isinstance(v, torch.fx.Node) for v in xs):
            return None
        shapes = [_shape(v) for v in xs]
        dim = args[1] if len(args) > 1 else kw.get("dim", 0)
        return {"maps": tuple(af.concat_maps(shapes,
                                             _axis(dim, len(shapes[0]))))}
    if op == aten.flip.default:
        return {"map": af.flip_map(in_shape, [_axis(d, nd) for d in args[1]])}
    if op == aten.expand.default:
        if nd == 0 or math.prod(in_shape) <= 1:
            return None  # scalar/one-element broadcast: left to the op
        n = len(out_shape)
        return {"map": af.broadcast_map(in_shape, out_shape,
                                        tuple(range(n - nd, n)))}
    if op == aten.clone.default:
        return {"copy": True}
    if op == aten.copy.default:
        src = args[1]
        if (not isinstance(src, torch.fx.Node) or _shape(src) != in_shape
                or src.meta["val"].dtype != x.meta["val"].dtype):
            return None
        return {"copy": True, "pick": 1}  # the values are src's
    if op in _EW_OPS:
        if (len(args) == 2 and not kw
                and all(isinstance(v, torch.fx.Node) for v in args)
                and _shape(args[0]) == _shape(args[1]) and nd >= 1
                and args[0].meta["val"].dtype == args[1].meta["val"].dtype):
            return {"ew": _EW_OPS[op]}
        return None
    return None


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

class _Builder:
    def __init__(self):
        self._n = itertools.count()
        self.nodes: list = []
        self.buffers: dict[str, Buffer] = {}
        self.consts: dict = {}
        self.matched: set[str] = set()
        self.notes: list[str] = []

    def fresh(self, prefix: str = "v") -> str:
        return f"{prefix}{next(self._n)}"

    def declare(self, name: str, shape, dtype) -> str:
        self.buffers[name] = Buffer(name, tuple(int(d) for d in shape), dtype)
        return name

    def const_buffer(self, val) -> str:
        name = self.fresh("c")
        val = torch.as_tensor(val)
        self.declare(name, val.shape, val.dtype)
        self.consts[name] = val
        return name


def _is_reshape_copy(node) -> bool:
    """The ``clone`` of a reshape of a non-contiguous tensor, which aten
    splits into ``clone(memory_format=contiguous)`` + ``_unsafe_view``: the
    pair is ONE row-major reshape (one lax.reshape in a jaxpr), and the IR's
    buffers are values, so the clone is an alias of its source."""
    return (node.target == aten.clone.default
            and node.kwargs.get("memory_format") == torch.contiguous_format
            and len(node.users) > 0
            and all(u.target == aten._unsafe_view.default
                    for u in node.users))


def _vals(node) -> list:
    """The traced values of a call: one tensor, or its tuple of outputs."""
    v = node.meta.get("val")
    return list(v) if isinstance(v, (tuple, list)) else [v]


def _walk(builder: _Builder, gm: torch.fx.GraphModule, env: dict) -> None:
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            env[node] = builder.const_buffer(getattr(gm, node.target))
            continue
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:  # one output of a tuple call
            env[node] = env[node.args[0]][node.args[1]]
            continue
        if _is_reshape_copy(node):  # half of one reshape: no instruction
            env[node] = env[node.args[0]]
            continue

        srcs_in = [a for a in pytree.tree_leaves((node.args, node.kwargs))
                   if isinstance(a, torch.fx.Node)]
        vals = _vals(node)
        # trace-time constant folding wins over matching: an all-constant
        # call becomes a register constant downstream matchers can read
        foldable = (all(env[a] in builder.consts for a in srcs_in)
                    and all(isinstance(v, torch.Tensor)
                            and v.numel() <= _CONST_FOLD_LIMIT
                            for v in vals))

        match = None
        if not foldable:
            try:
                match = _match_tm(node)
            except Exception as e:  # noqa: BLE001 — a matcher bug or shape
                # edge must degrade the call to an opaque node, never kill
                # the whole trace; the note makes the residue explainable
                builder.notes.append(
                    f"{node.target}: matcher error left opaque ({e!r})")
        name = str(node.target.name()).split("::")[-1].split(".")[0] \
            if hasattr(node.target, "name") else str(node.target)
        if match is not None:
            srcs = tuple(env[a] for a in srcs_in)
            if "pick" in match:
                srcs = (srcs[match["pick"]],)
            dst = builder.fresh()
            builder.declare(dst, vals[0].shape, vals[0].dtype)
            env[node] = dst
            builder.matched.add(name)
            builder.nodes.append(TMNode(_build_instr(match, srcs, dst),
                                        matched=name))
            continue

        # opaque compute node
        def ref(a):
            return BufRef(env[a]) if isinstance(a, torch.fx.Node) else a

        args = pytree.tree_map(ref, node.args)
        kwargs = pytree.tree_map(ref, node.kwargs)
        dsts = []
        for v in vals:
            d = builder.fresh()
            builder.declare(d, v.shape, v.dtype)
            dsts.append(d)
        env[node] = dsts[0] if not isinstance(node.meta.get("val"),
                                              (tuple, list)) else dsts
        src_names = tuple(env[a] for a in srcs_in)
        tpu = TPUNode(
            op=node.target, args=args, kwargs=kwargs, src_names=src_names,
            dst_names=tuple(dsts),
            in_avals=tuple((builder.buffers[s].shape, builder.buffers[s].dtype)
                           for s in src_names),
            out_avals=tuple((tuple(v.shape), v.dtype) for v in vals))
        if foldable:  # trace-time constant folding
            eval_tpu_node(tpu, builder.consts)
            continue
        builder.nodes.append(tpu)


def _build_instr(match: dict, srcs: tuple[str, ...], dst: str) -> TMInstr:
    if "map" in match:
        return TMInstr(TMOpcode.COARSE, srcs, dst, map_=match["map"])
    if "maps" in match:
        return TMInstr(TMOpcode.COARSE, srcs, dst, maps=match["maps"])
    if "ew" in match:
        return TMInstr(TMOpcode.ELEMENTWISE, srcs, dst, ew=match["ew"])
    if "resize" in match:
        r = match["resize"]
        return TMInstr(TMOpcode.RESIZE, srcs, dst,
                       meta={"out_h": r["out_h"], "out_w": r["out_w"],
                             "batch_dims": r["batch_dims"]})
    if "rme" in match:
        return TMInstr(TMOpcode.FINE_EVALUATE, srcs, dst, rme=match["rme"])
    if "copy" in match:
        return TMInstr(TMOpcode.COPY, srcs, dst)
    raise AssertionError(match)


def graph_from_fx(gm: torch.fx.GraphModule) -> TMGraph:
    """Lower a ``make_fx`` GraphModule into a :class:`TMGraph`."""
    builder = _Builder()
    env: dict = {}
    inputs = []
    out_node = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            v = node.meta["val"]
            n = builder.declare(builder.fresh("in"), v.shape, v.dtype)
            env[node] = n
            inputs.append(n)
        elif node.op == "output":
            out_node = node
    _walk(builder, gm, env)
    outputs = tuple(
        env[v] if isinstance(v, torch.fx.Node) else builder.const_buffer(v)
        for v in pytree.tree_leaves(out_node.args[0]))
    graph = TMGraph(nodes=builder.nodes, buffers=builder.buffers,
                    inputs=tuple(inputs), outputs=outputs,
                    consts=builder.consts, matched_prims=builder.matched,
                    notes=builder.notes)
    graph.validate()
    return graph
