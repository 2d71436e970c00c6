"""Per-device cost of a traced step, counted on its aten ops.

The counterpart of the JAX package's ``launch/hlo_cost.py``, which walks
the post-SPMD HLO module.  Here the step runs once on DTensors whose local
shards are meta tensors (shapes and dtypes, never allocated) under
:class:`CostCounter`, a ``TorchDispatchMode`` below the DTensor layer: it
sees each rank's local aten ops after sharding propagation and the
``c10d_functional`` collectives DTensor issues, which is the per-device
program, as the post-partitioning HLO module is.  A Python loop (over
layers, over chunks) is unrolled by the run, so there are no trip counts to
multiply: n layers cost n times one.

Cost model (per device; ``hlo_cost``'s, so a record's fields mean the same):
  * flops — matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``):
            2·|result|·K; convolution: 2·|result|·(|kernel| / out_features);
            any other op: |result| (elementwise upper bound); views and
            allocations without a fill: 0.
  * bytes — each op reads its tensor operands and writes its result once,
            an operand passed twice charged twice; a view is an operand of
            its own size, so a read through a slice is charged at the slice;
            a gather or index read is charged at what it reads (the result's
            size) plus its indices; an update into a window (``copy_`` into
            a view, ``slice_scatter``, ``index_put``, ``scatter``) at twice
            the window (read-for-write of the region + the update).
  * collectives — wire bytes per device with ring factors:
            all-reduce 2·|result|; all-gather |result|; reduce-scatter
            |operand|; all-to-all |result|.
  * matmul_flops — FlopCounterMode's own formulas over the same local ops,
            the counter a run on the card is checked with.
  * peak memory — the high-water mark of the bytes of the storages the
            step creates and still holds, on top of its arguments'.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# ops that move no data: views, metadata, allocations without a fill, and
# the collectives' bookkeeping
_FREE = {
    aten.view, aten._unsafe_view, aten.alias, aten.as_strided, aten.expand,
    aten.permute, aten.transpose, aten.t, aten.slice, aten.select,
    aten.squeeze, aten.unsqueeze, aten.split, aten.split_with_sizes,
    aten.unbind, aten.chunk, aten.narrow, aten.diagonal, aten.unfold,
    aten.detach, aten.lift_fresh, aten.empty, aten.empty_strided,
    aten.new_empty, aten.new_empty_strided, aten.empty_like,
    aten._reshape_alias, aten.view_as_real, aten.view_as_complex,
    aten.sym_size, aten.sym_stride, aten.sym_numel, aten.is_same_size,
    aten.sym_storage_offset, aten.is_contiguous,
}
_FREE_NAMES = {"wait_tensor", "_wrap_tensor_autograd"}
_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_READS = {aten.index, aten.gather, aten.index_select, aten.embedding,
          aten._embedding_bag, aten._embedding_bag_forward_only,
          aten.take_along_dim}
_WINDOW_WRITES = {aten.copy_, aten.slice_scatter, aten.select_scatter,
                  aten.index_put, aten.index_put_, aten.scatter,
                  aten.scatter_, aten.scatter_add, aten.scatter_add_,
                  aten.diagonal_scatter}
_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """Bytes of the local shards of the tensors in ``tree`` (a DTensor
    counts its shard on this rank)."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    matmul_flops: float = 0.0
    coll: dict = dataclasses.field(default_factory=dict)
    ops: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll.values())


class CostCounter(TorchDispatchMode):
    """Counts :mod:`cost`'s model over the local ops run under it.

    ``baseline`` is a tree of the step's arguments: their storages exist
    before the step and are not its temporaries.  After the ``with``:
    ``totals`` (a :class:`CostTotals`) and ``temp_peak_bytes``."""

    def __init__(self, baseline=()):
        super().__init__()
        self.totals = CostTotals()
        self._known = {self._key(t.to_local() if isinstance(t, DTensor)
                                 else t) for t in _tensors(baseline)}
        self._refs: dict[int, int] = {}
        self._live_bytes = 0
        self.temp_peak_bytes = 0

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _release(self, key: int, nbytes: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self._live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        key = self._key(t)
        if key in self._known:
            return
        if key not in self._refs:
            self._refs[key] = 0
            nbytes = t.untyped_storage().nbytes()
            self._live_bytes += nbytes
            self.temp_peak_bytes = max(self.temp_peak_bytes,
                                       self._live_bytes)
        else:
            nbytes = None
        self._refs[key] += 1
        weakref.finalize(t, self._release, key,
                         nbytes if nbytes is not None
                         else t.untyped_storage().nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it; its local ops come back
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            # DTensor's shape propagation (fake tensors of the global
            # shape, an allocation among them), not work
            return out
        for t in outs:
            self._track(t)
        self._count(func, args, kwargs, ins, outs, out)
        return out

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        tot = self.totals
        packet = func._overloadpacket
        name = packet.__name__
        if packet in _FREE or name in _FREE_NAMES:
            return
        tot.ops += 1
        rbytes = sum(_nbytes(t) for t in outs)
        obytes = sum(_nbytes(t) for t in ins)
        relems = sum(t.numel() for t in outs)
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None:
            tot.matmul_flops += formula(*args, **kwargs, out_val=out)
        kind = _COLLECTIVES.get(name)
        if kind is not None and func.namespace in ("_c10d_functional",
                                                   "c10d_functional"):
            if kind == "all-reduce":
                wire = 2 * rbytes
            elif kind == "reduce-scatter":
                wire = obytes
            else:
                wire = rbytes
            tot.coll[kind] = tot.coll.get(kind, 0.0) + wire
            tot.bytes += rbytes + obytes
            return
        if packet in _DOTS:
            a = args[1] if packet in (aten.addmm, aten.baddbmm) else args[0]
            tot.flops += 2.0 * relems * a.shape[-1]
            tot.bytes += rbytes + obytes
            return
        if packet is aten.convolution:
            w = args[1]
            tot.flops += 2.0 * relems * max(w.numel() // max(w.shape[0], 1),
                                            1)
            tot.bytes += rbytes + obytes
            return
        if packet in _READS:
            src = ins[0]
            index = sum(_nbytes(t) for t in ins[1:])
            tot.flops += relems
            tot.bytes += relems * src.element_size() + index + rbytes
            return
        if packet in _WINDOW_WRITES:
            # the update operand: copy_'s src, the scatters' last tensor
            upd = ins[1] if packet is aten.copy_ else ins[-1]
            tot.flops += upd.numel()
            tot.bytes += 2 * _nbytes(upd) + sum(_nbytes(t) for t in ins[1:-1])
            return
        tot.flops += relems
        tot.bytes += rbytes + obytes
