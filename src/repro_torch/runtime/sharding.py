"""Logical-axis sharding rules (MaxText-style) for single- and multi-pod
meshes, on ``torch.distributed``'s DeviceMesh and DTensor.

The JAX package's ``runtime/sharding.py``.  Models annotate activations and
parameters with *logical* axis names; the launcher installs a rules table
mapping logical names to mesh axes.  Outside a rules context every
annotation returns its input, so the same model code runs on one device
(the smoke tests, every serving path) and on a 512-rank mesh (the dry-run)
unchanged.

Where the JAX package resolves names to a ``PartitionSpec`` and GSPMD
places the tensor, here :func:`spec_of` resolves them to the spec's entries
as a plain tuple and :func:`placements_of` turns those into DTensor
placements, one per mesh dim: ``Shard(d)`` on every mesh axis that tensor
dim ``d`` is spread over (``batch`` -> ``("pod", "data")`` is ``Shard(0)``
on both), ``Replicate()`` on the others.  :func:`shard` is the counterpart
of ``with_sharding_constraint``: a DTensor is redistributed to those
placements, and a plain tensor, which is single-device execution, is
returned as it is.

Parallelism styles encoded in the default rules:
  * DP   — batch over ("pod", "data")
  * TP   — heads / mlp / vocab / experts over "model" (Megatron-style)
  * SP   — inter-block activation seq over "model" (sequence parallelism)
  * FSDP — weight "embed" rows over "data" (ZeRO-3: all-gathered at use,
           gradients reduce-scattered; optimizer state stays sharded)
  * EP   — experts over "model"
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

_ctx = threading.local()


DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "seq": ("model",),          # sequence parallelism between blocks
    "kv_seq": ("data",),        # long-context decode: KV cache seq over data
    "embed": None,
    "embed_fsdp": ("data",),    # FSDP weight sharding axis
    "heads": ("model",),
    "kv_heads": None,           # kv heads replicated under TP (repeat at use)
    "head_dim": None,
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": None,
    "layers": None,
    "state": None,
    "conv": None,
    "cap": None,
}


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, or of an object with the JAX
    mesh's ``axis_names`` and ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _kept(axes: tuple[str, ...] | None, names) -> tuple[str, ...] | None:
    if axes is None:
        return None
    kept = tuple(a for a in axes if a in names)
    return kept if kept else None


@contextlib.contextmanager
def use_rules(mesh, rules: dict | None = None):
    """Install (mesh, rules) for shard()/spec_of() in this thread."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    # drop mesh axes that don't exist (e.g. "pod" on the single-pod mesh)
    axes = set(mesh_axes(mesh))
    clean = {k: _kept(v, axes) for k, v in rules.items()}
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, clean)
    try:
        with contextlib.ExitStack() as stack:
            if prev is None:
                # a tensor the model makes (positions, masks, a zero state)
                # is plain: replicated where it meets a DTensor, as GSPMD
                # places a constant
                stack.enter_context(implicit_replication())
            yield
    finally:
        _ctx.state = prev


def active():
    """The installed ``(mesh, rules)``, or None outside a rules context."""
    return getattr(_ctx, "state", None)


def _entry(axes: tuple[str, ...] | None):
    """One PartitionSpec entry: None, one axis name, or a tuple of them."""
    if axes is None:
        return None
    return axes[0] if len(axes) == 1 else axes


def _resolve(names: Sequence[str | None], rules: dict) -> tuple:
    return tuple(None if n is None else _entry(rules.get(n)) for n in names)


def spec_of(names: Sequence[str | None]) -> tuple:
    """Logical axis names -> the PartitionSpec's entries under the active
    rules, as a tuple (``()`` outside a rules context)."""
    state = active()
    if state is None:
        return ()
    return _resolve(names, state[1])


def placements_of(spec: Sequence, mesh) -> tuple:
    """A PartitionSpec's entries (:func:`spec_of`'s tuple) -> DTensor
    placements, one per mesh dim: ``Shard(d)`` on each mesh axis that
    tensor dim ``d`` names, ``Replicate()`` on the rest."""
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            dim_of[axis] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def shard(x: torch.Tensor, names: Sequence[str | None]) -> torch.Tensor:
    """``with_sharding_constraint`` under the active rules: a DTensor is
    redistributed to the names' placements on the active mesh.  Outside a
    rules context, and for a plain tensor (single-device execution),
    ``x`` itself."""
    state = active()
    if state is None or not isinstance(x, DTensor):
        return x
    mesh, rules = state
    want = placements_of(_resolve(names, rules), mesh)
    if tuple(x.placements) == want and x.device_mesh == mesh:
        return x
    return x.redistribute(mesh, want)


def local(fn, in_names: Sequence, out_names, in_grad: Sequence = None):
    """``fn`` run on each rank's shards (``local_map``) under the active
    rules: each DTensor argument redistributed to its ``in_names`` entry's
    placements (None for an argument that is not a tensor), the outputs
    made DTensors with ``out_names``' (one names tuple, or a list of them
    for a tuple of outputs).  An entry is logical names or a tuple of
    placements (:func:`with_partial`).  ``in_grad``, one entry an
    argument, gives the placements of the gradients ``fn``'s backward
    returns where they are not the arguments' own (None: its own), as for
    a replicated argument whose gradient is a sum over the ranks' batch
    rows.  For code that is local to each rank's shards but whose ops
    DTensor cannot propagate or would gather for (an in-place scatter
    into a table it makes, a lookup into a vocab-sharded table).  Outside
    a rules context, ``fn`` itself; with plain tensors, ``fn`` runs on
    them as they are."""
    state = active()
    if state is None:
        return fn
    mesh, rules = state

    def placements(names):
        if names is None:
            return None
        if is_placements(names):
            return list(names)
        return list(placements_of(_resolve(names, rules), mesh))

    # local_map reads a tuple as one entry per output, a list as one output
    outs = tuple(placements(n) for n in out_names) \
        if isinstance(out_names, list) else placements(out_names)
    grads = None if in_grad is None else tuple(
        placements(n if g is None else g) for n, g in zip(in_names, in_grad))
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(placements(n) for n in in_names),
                     in_grad_placements=grads, redistribute_inputs=True,
                     device_mesh=mesh)


def with_partial(names: Sequence[str | None], *logical: str) -> tuple:
    """The placements of ``names`` under the active rules, with a
    ``Partial`` sum on the mesh axes each of ``logical`` maps onto: a
    result each rank holds a share of, summed where it is next
    redistributed."""
    mesh, rules = active()
    axes = {a for name in logical for a in rules.get(name) or ()}
    return tuple(Partial() if a in axes else p for a, p in zip(
        mesh.mesh_dim_names, placements_of(_resolve(names, rules), mesh)))


def local_block(shape: Sequence[int], names: Sequence[str | None],
                dim: int) -> tuple[int, int]:
    """This rank's block along ``dim`` of a tensor of global ``shape``
    laid out by ``names`` under the active rules: ``(offset, extent)``,
    DTensor's chunks of a ``Shard`` (the last ones shorter, or empty,
    where the dim does not divide).  ``(0, shape[dim])`` outside a rules
    context.  Host integers from the mesh coordinate: nothing waits on
    the device."""
    state = active()
    offset, extent = 0, shape[dim]
    if state is None:
        return offset, extent
    mesh, rules = state
    for i, p in enumerate(placements_of(_resolve(names, rules), mesh)):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-extent // mesh.size(i))   # torch.chunk's
            start = min(mesh.get_local_rank(i) * chunk, extent)
            offset, extent = offset + start, min(chunk, extent - start)
    return offset, extent


def all_reduce_over(t: torch.Tensor, op: str, logical: str) -> torch.Tensor:
    """A rank's plain tensor ``t`` (inside :func:`local`) reduced with
    ``op`` (``"sum"``, ``"max"``) over the mesh axes that ``logical`` maps
    onto under the active rules, one all-reduce an axis of more than one
    rank; ``t`` itself where there is none."""
    mesh, rules = active()
    for axis in rules.get(logical) or ():
        dim = mesh.mesh_dim_names.index(axis)
        if mesh.size(dim) > 1:
            t = funcol.all_reduce(t, op, (mesh, dim))
    return t


def reduce_scatter_over(t: torch.Tensor, logical: str) -> torch.Tensor:
    """A rank's plain tensor ``t`` (inside :func:`local`) summed over the
    one mesh axis ``logical`` maps onto and scattered along dim 0, with
    a backward (the all-gather of the gradient); ``t`` itself where the
    axis has one rank."""
    mesh, rules = active()
    axis, = rules[logical]
    dim = mesh.mesh_dim_names.index(axis)
    if mesh.size(dim) == 1:
        return t
    # PyTorch 2.13 deprecates the older name for the newer one; take
    # whichever this PyTorch has
    op = getattr(funcol, "reduce_scatter_single_autograd", None) or \
        funcol.reduce_scatter_tensor_autograd
    return op(t, "sum", 0, (mesh, dim))


def whole_seq(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, D) with its sequence whole on every rank: the all-gather
    of sequence parallelism before a product whose output constraint
    leaves the sequence unsharded (or before a pass along the sequence),
    which GSPMD derives from that constraint and DTensor, which propagates
    forward only, must be told (PyTorch's ``SequenceParallel`` ->
    ``ColwiseParallel`` input layouts).  ``x`` itself outside a rules
    context or when the sequence is not sharded."""
    return shard(x, ("batch", None, "embed"))


def remat_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the forward as it runs,
    the recompute under the rules active now, since the recompute runs in
    the backward, on the autograd engine's thread on the card, where this
    thread's rules are not installed."""
    return contextlib.nullcontext(), _installed(active())


@contextlib.contextmanager
def _installed(state):
    """``state`` (an ``active()``) installed in this thread, the flag of
    implicit replication left as it is: it is process-wide, and the thread
    that set it is still inside its ``use_rules``."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = state
    try:
        yield
    finally:
        _ctx.state = prev


BANDS_WHOLE, BANDS_WEIGHT, BANDS_PRODUCT = "whole", "weight", "product"


def band_layout(w: torch.Tensor, x: torch.Tensor, after: int,
                alike: bool) -> str:
    """How a product of ``x`` (B, S, D) with the column bands of ``w``
    (D, N), whose columns the rules spread over "heads", is split, chosen
    once for a block.  Slicing a band off a sharded dim gathers the whole
    dim, so the bands are never sliced off a sharded tensor:

    * :data:`BANDS_WHOLE`: the heads lie on one rank; the bands are views.
    * :data:`BANDS_WEIGHT`: ``w``'s columns are gathered once and each
      band is sharded again before its product, so each rank computes its
      own heads of it.
    * :data:`BANDS_PRODUCT`: the product is gathered once (or each rank
      multiplies its own columns by their bands' activations, and that
      product is gathered once) and split.

    The weight goes first where a rank gathers fewer elements that way:
    its weight rows times N, plus its activation rows times ``after``
    (columns of the products that are gathered after all), against its
    activation rows times N.  Prefill and training, where the rows of x
    outnumber the weight's; a decode step's few rows gather the product.
    ``alike``: the product path needs shards alike (each rank's own
    columns as one ``local`` block), so it takes the weight first where
    the ranks do not divide N."""
    n = ranks_of("heads")
    if n == 1:
        return BANDS_WHOLE
    rows = x.shape[0] * x.shape[1] // ranks_of("batch")
    d, cols = w.shape[0] // ranks_of("embed_fsdp"), w.shape[1]
    if d * cols + rows * after < rows * cols or (alike and cols % n):
        return BANDS_WEIGHT
    return BANDS_PRODUCT


def ranks_of(logical: str) -> int:
    """How many ranks ``logical`` is spread over under the active rules:
    the product of the sizes of the mesh axes it maps onto (1 outside a
    rules context, or where it is not sharded)."""
    state = active()
    if state is None:
        return 1
    mesh, rules = state
    sizes = mesh_axes(mesh)
    n = 1
    for axis in rules.get(logical) or ():
        n *= sizes[axis]
    return n


def is_spec(t) -> bool:
    """A leaf of a spec tree: None or a tuple of logical names / None."""
    return t is None or (isinstance(t, tuple) and
                         all(isinstance(e, (str, type(None))) for e in t))


def map_specs(fn, spec_tree):
    """``fn`` over the leaves of a spec tree (:func:`is_spec`), keeping its
    dicts, lists and non-leaf tuples."""
    if is_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v) for k, v in spec_tree.items()}
    return type(spec_tree)(map_specs(fn, v) for v in spec_tree)


def spec_of_names(names, mesh, rules: dict | None = None) -> tuple:
    """A spec-tree leaf -> its PartitionSpec's entries on ``mesh`` under
    ``rules`` (default :data:`DEFAULT_RULES`), mesh axes the mesh lacks
    dropped; ``()`` for a None leaf."""
    if names is None:
        return ()
    rules = DEFAULT_RULES if rules is None else rules
    axes = set(mesh_axes(mesh))
    return tuple(_entry(_kept(rules.get(n) if n else None, axes))
                 for n in names)


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` onto ``mesh`` with ``placements``, every rank holding the whole
    of ``t`` (drawn from one seed, read from one checkpoint): each takes
    its own shard of it, with no collective and, where the shard is all of
    ``t``, no copy."""
    return distribute_tensor(t, mesh, list(placements), src_data_rank=None)


def is_placements(t) -> bool:
    """A leaf of :func:`tree_sharding`'s tree: a tuple of placements."""
    return isinstance(t, tuple) and all(isinstance(p, Placement) for p in t)


def tree_sharding(spec_tree, mesh, rules: dict | None = None):
    """Map a tree of logical-name tuples to DTensor placements on ``mesh``
    (a None leaf is replicated)."""
    return map_specs(
        lambda names: placements_of(spec_of_names(names, mesh, rules), mesh),
        spec_tree)
