"""torch.fx -> TM IR front end.

Walks a ``make_fx`` graph (aten ops at concrete shapes) and pattern-matches
tensor-manipulation calls into :class:`~repro_torch.core.instr.TMInstr`
candidates, leaving everything else (mm, the NHWC conv, activations, …) as
opaque :class:`~repro_torch.compiler.ir.TPUNode` calls.  Two match sources,
as in the JAX package's jaxpr front end:

* **raw aten ops** — permute/t/transpose, view/_unsafe_view/reshape,
  squeeze/unsqueeze, slice, split, constant_pad_nd, cat, flip, expand,
  clone/copy, the KV append (``slice_scatter`` at constant starts, and the
  constant-band ``scatter`` vmap makes of it) as an overlay Route,
  constant-index gathers (``index_select``/``index``), window-1 pooling
  that only strides, and elementwise add/sub/mul/maximum, each rebuilt as
  the exact :class:`~repro_torch.core.affine.MixedRadixMap` the JAX
  matcher builds for the equivalent lax primitive.  An elementwise op's
  implicitly broadcast operand becomes a broadcast map (a constant one
  folds at trace time) and a promoted operand an opaque cast, as jnp makes
  both explicit (``broadcast_in_dim``, ``convert_element_type``);
* **tagged tm_ops** — inside :func:`repro_torch.core.tm_primitive.tag_tm_ops`
  the operator library calls the ``tm_map`` / ``tm_route`` / ``tm_resize``
  / ``tm_evaluate`` custom ops, whose arguments carry the exact map.

aten is finer than a jaxpr (a multi-axis slice is one ``slice`` per axis,
a reshape of a non-contiguous tensor is ``clone`` + ``view``); the pass
pipeline's composition and copy elimination absorb the difference.

A matcher that declines a matchable-looking op for a reason a user can act
on (a traced index vector, a traced start, a gather past the band budget)
raises :class:`_MatchFallback`: the op stays opaque and the reason lands in
``TMGraph.notes``, which the pass report's ``trace-fallback`` rows surface.
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
_POOL_OPS = {aten.max_pool2d_with_indices.default, aten.avg_pool2d.default}

# irregular (non-arithmetic-progression) gather indices decompose into one
# Route band per index; past this count the band loop costs more than the
# library gather it replaces, so the matcher declines
_GATHER_MAX_BANDS = 64


class _MatchFallback(Exception):
    """A matcher declining with an explanation: the op stays an opaque
    compute node and the reason lands in ``TMGraph.notes`` (pass-report
    surface)."""


def _shape(n) -> tuple[int, ...]:
    return tuple(int(d) for d in n.meta["val"].shape)


def _axis(d: int, nd: int) -> int:
    return d % nd if nd else 0


# ---------------------------------------------------------------------------
# per-call matchers: node -> TMInstr ingredients (maps / rme / ew) or None
# ---------------------------------------------------------------------------

def _gather(name: str, operand: tuple[int, ...], axis: int, idx):
    """A constant-index gather along ``axis`` (``jnp.take``'s form): an
    arithmetic progression becomes ONE strided map, an irregular vector of
    up to ``_GATHER_MAX_BANDS`` indices a band-per-index Route reading the
    operand once per band.  ``idx`` None means a traced index vector."""
    if idx is None:
        raise _MatchFallback(
            f"{name}: traced index vector left opaque (runtime indices "
            f"cannot become TMU register contents)")
    if idx.ndim != 1 or idx.numel() == 0 or idx.is_floating_point():
        return None
    vals = [int(v) for v in idx.tolist()]
    if not all(0 <= v < operand[axis] for v in vals):
        return None  # negative/out-of-range indices: left to the op
    n = len(vals)
    step = vals[1] - vals[0] if n > 1 else 0
    if all(vals[j] == vals[0] + j * step for j in range(n)):
        return {"map": af.index_select_map(operand, axis, vals[0], step, n),
                "pick": (0,)}
    if n > _GATHER_MAX_BANDS:
        raise _MatchFallback(
            f"{name}: {n} irregular indices exceed the "
            f"{_GATHER_MAX_BANDS}-band Route budget")
    return {"maps": tuple(af.index_select_band_maps(operand, axis, vals)),
            "pick": (0,) * n}


def _update(in_shape: tuple[int, ...], upd: tuple[int, ...],
            starts: list[int], picks: tuple[int, int]):
    """The KV append at constant starts: an overlay Route (base, window)
    over (operand, update), the starts folded into the window's map; both
    aten forms are recorded as ``slice_scatter``."""
    return {"maps": af.update_slice_maps(in_shape, upd, starts),
            "overlay": True, "pick": picks, "as": "slice_scatter"}


def _scatter_band(node, get_const):
    """``scatter.src`` whose constant index is one contiguous band along
    ``dim`` repeated over every other axis — what ``torch.func.vmap`` makes
    of ``slice_scatter`` — as the same overlay Route."""
    x, dim, index, src = node.args[:4]
    in_shape, upd = _shape(x), _shape(src)
    idx = get_const(index)
    if idx is None:
        raise _MatchFallback(
            "scatter: non-constant start index left opaque (runtime starts "
            "cannot become TMU register offsets; bucket the position like a "
            "shape instead)")
    nd = len(in_shape)
    dim = _axis(dim, nd)
    if tuple(idx.shape) != upd or any(
            upd[d] != in_shape[d] for d in range(nd) if d != dim):
        return None
    start = int(idx.flatten()[0])
    band = torch.arange(start, start + upd[dim]).reshape(
        [upd[dim] if d == dim else 1 for d in range(nd)])
    if start + upd[dim] > in_shape[dim] or not torch.equal(
            idx.cpu(), band.expand(upd)):
        return None
    starts = [start if d == dim else 0 for d in range(nd)]
    return _update(in_shape, upd, starts, (0, 2))


def _match_tm(node, get_const=lambda a: None):
    """Return a dict describing the TM instruction, or None to stay opaque.

    ``get_const(arg)`` is the concrete value of a constant operand (a
    ``get_attr`` tensor or a call folded at trace time), or None when the
    operand is traced."""
    op = node.target
    args = node.args
    kw = node.kwargs
    tensor_args = [a for a in pytree.tree_leaves((args, kw))
                   if isinstance(a, torch.fx.Node)]
    if not tensor_args:
        return None
    x = args[0]
    in_shape = _shape(x) if isinstance(x, torch.fx.Node) else None
    out_shape = tuple(int(d) for d in _vals(node)[0].shape)
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
    if op in (aten.split.Tensor, aten.split_with_sizes.default):
        dim = _axis(args[2] if len(args) > 2 else kw.get("dim", 0), nd)
        outs, start = [], 0
        for v in _vals(node):
            shape = tuple(int(d) for d in v.shape)
            starts = [start if d == dim else 0 for d in range(nd)]
            outs.append({"map": af.strided_slice_map(in_shape, starts,
                                                     (1,) * nd, shape)})
            start += shape[dim]
        return {"outs": outs}
    if op == aten.slice_scatter.default:
        src = args[1]
        dim = _axis(args[2] if len(args) > 2 else kw.get("dim", 0), nd)
        step = args[5] if len(args) > 5 else kw.get("step", 1)
        if not isinstance(src, torch.fx.Node) or step != 1 \
                or src.meta["val"].dtype != x.meta["val"].dtype:
            return None
        start = args[3] if len(args) > 3 else kw.get("start")
        size = in_shape[dim]
        start = 0 if start is None else start
        start = min(max(start + size if start < 0 else start, 0), size)
        starts = [start if d == dim else 0 for d in range(nd)]
        return _update(in_shape, _shape(src), starts, (0, 1))
    if op == aten.scatter.src:
        if not all(isinstance(a, torch.fx.Node) for a in
                   (args[0], args[2], args[3])) or kw \
                or args[3].meta["val"].dtype != x.meta["val"].dtype:
            return None
        return _scatter_band(node, get_const)
    if op == aten.index_select.default:
        return _gather("index_select", in_shape, _axis(args[1], nd),
                       get_const(args[2]))
    if op == aten.index.Tensor:
        idxs = list(args[1])
        used = [i for i, v in enumerate(idxs) if v is not None]
        if len(used) != 1 or len(idxs) > nd:
            return None
        return _gather("index", in_shape, used[0], get_const(idxs[used[0]]))
    if op in _POOL_OPS:
        window = list(args[1])
        strides = list(args[2]) if len(args) > 2 and args[2] else window
        pad = list(args[3]) if len(args) > 3 else [0]
        rest = args[4:]
        if op == aten.max_pool2d_with_indices.default:
            dil = list(rest[0]) if rest else [1]
            ceil = rest[1] if len(rest) > 1 else False
            if any(u.target != operator.getitem or u.args[1] != 0
                   for u in node.users if len(u.users)):
                return None  # the argmax indices are read: compute
        else:
            dil, ceil = [1], rest[0] if rest else False
            if len(rest) > 2 and rest[2] not in (None, 1):
                return None  # divisor_override rescales: compute
        if (any(w != 1 for w in window) or any(p != 0 for p in pad)
                or any(d != 1 for d in dil) or ceil or len(strides) != 2):
            return None  # genuine pooling: compute, not movement
        strides = [1] * (nd - 2) + [int(v) for v in strides]
        m = af.strided_slice_map(in_shape, (0,) * nd, strides, out_shape)
        return ({"map": m} if op == aten.avg_pool2d.default
                else {"outs": [{"map": m}, None]})
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
        return {"copy": True, "pick": (1,)}  # the values are src's
    if op in _EW_OPS:
        if (len(args) == 2 and not kw
                and all(isinstance(v, torch.fx.Node) for v in args)
                and len(out_shape) >= 1):
            # unequal shapes or dtypes: the walk makes the broadcast and the
            # promotion explicit before the instruction (_ew_operands)
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
        # the traced tensor itself, never a copy: closed-over parameters
        # (a 1.2 GB embedding) are shared by every program compiled from
        # them
        name = self.fresh("c")
        val = torch.as_tensor(val)
        self.declare(name, val.shape, val.dtype)
        self.consts[name] = val
        return name

    def opaque(self, op, args: tuple, src_names: tuple[str, ...],
               val: torch.Tensor, kwargs: dict | None = None) -> str:
        """Append one opaque call the walk itself makes explicit (a cast or
        a one-element broadcast before an elementwise instruction); folded
        at trace time when its source is constant."""
        dst = self.declare(self.fresh(), val.shape, val.dtype)
        node = TPUNode(
            op=op, args=args, kwargs=kwargs or {}, src_names=src_names,
            dst_names=(dst,),
            in_avals=tuple((self.buffers[s].shape, self.buffers[s].dtype)
                           for s in src_names),
            out_avals=((tuple(val.shape), val.dtype),))
        if all(s in self.consts for s in src_names):
            eval_tpu_node(node, self.consts)
        else:
            self.nodes.append(node)
        return dst


def _ew_operands(builder: _Builder, node, srcs: tuple[str, ...]):
    """The operands of a matched elementwise op at its output's shape and
    dtype, as jnp makes them explicit: a promoted operand is cast by an
    opaque ``_to_copy`` (``convert_element_type``), and a broadcast operand
    becomes a broadcast map — folded at trace time when constant, and an
    opaque ``expand`` when it has one element (both as the JAX matcher
    leaves ``broadcast_in_dim``)."""
    out = _vals(node)[0]
    shape, dtype = tuple(int(d) for d in out.shape), out.dtype
    n = len(shape)
    names = []
    for name in srcs:
        buf = builder.buffers[name]
        if buf.dtype != dtype:
            fake = torch.empty(buf.shape, dtype=dtype, device="meta")
            name = builder.opaque(aten._to_copy.default, (BufRef(name),),
                                  (name,), fake, {"dtype": dtype})
            buf = builder.buffers[name]
        if buf.shape != shape:
            fake = torch.empty(shape, dtype=dtype, device="meta")
            const = builder.consts.get(name)
            if const is not None and math.prod(shape) <= _CONST_FOLD_LIMIT:
                name = builder.const_buffer(
                    const.expand(shape).contiguous())
            elif math.prod(buf.shape) <= 1:
                name = builder.opaque(aten.expand.default,
                                      (BufRef(name), list(shape)), (name,),
                                      fake)
            else:
                src = name
                name = builder.declare(builder.fresh(), shape, dtype)
                nd = len(buf.shape)
                builder.nodes.append(TMNode(TMInstr(
                    TMOpcode.COARSE, (src,), name,
                    map_=af.broadcast_map(buf.shape, shape,
                                          tuple(range(n - nd, n)))),
                    matched="expand"))
                builder.matched.add("expand")
        names.append(name)
    return tuple(names)


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

        def get_const(a):
            return (builder.consts.get(env[a])
                    if isinstance(a, torch.fx.Node) else None)

        match = None
        if not foldable:
            try:
                match = _match_tm(node, get_const)
            except _MatchFallback as note:
                builder.notes.append(str(note))
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
                srcs = tuple(srcs[i] for i in match["pick"])
            if "ew" in match:
                srcs = _ew_operands(builder, node, srcs)
            name = match.get("as", name)
            dsts = []
            for out, val in zip(match.get("outs", [match]), vals):
                if out is None:  # an output nothing reads (pool indices)
                    dsts.append(None)
                    continue
                dst = builder.declare(builder.fresh(), val.shape, val.dtype)
                builder.nodes.append(TMNode(_build_instr(out, srcs, dst),
                                            matched=name))
                dsts.append(dst)
            env[node] = dsts if "outs" in match else dsts[0]
            builder.matched.add(name)
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
        meta = {"overlay": True} if match.get("overlay") else None
        return TMInstr(TMOpcode.COARSE, srcs, dst, maps=match["maps"],
                       meta=meta)
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
