"""TM IR — the compiler's program graph.

A :class:`TMGraph` is an ordered list of nodes over a buffer file:

* :class:`TMNode` — one TM instruction (:class:`~repro_torch.core.instr.TMInstr`),
  destined for the TM engine (executed by the
  :class:`~repro_torch.core.executor.TMExecutor` backends);
* :class:`TPUNode` — one opaque aten call (mm, the NHWC conv, tanh, …),
  destined for the compute engine (the paper's TPU); the compiler never
  looks inside, it only tracks the def/use edges.

Buffers are named SSA values with shape/dtype (from the trace's fake
tensors).  Node order is the original program order — passes rewrite nodes
in place and the partitioner groups maximal same-kind runs into phases.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.instr import TMInstr


@dataclasses.dataclass(frozen=True)
class Buffer:
    name: str
    shape: tuple[int, ...]
    dtype: Any  # torch dtype (from the traced value)


@dataclasses.dataclass(frozen=True)
class BufRef:
    """A buffer read inside a :class:`TPUNode`'s argument structure."""

    name: str


@dataclasses.dataclass
class TMNode:
    """One TM instruction; ``instr.srcs``/``instr.dst`` name graph buffers."""

    instr: TMInstr
    matched: str = ""  # the aten op this node was matched from

    @property
    def srcs(self) -> tuple[str, ...]:
        return self.instr.srcs

    @property
    def dsts(self) -> tuple[str, ...]:
        return (self.instr.dst,)

    @property
    def kind(self) -> str:
        return "tmu"


@dataclasses.dataclass
class TPUNode:
    """One opaque aten call, evaluated by calling the op eagerly.

    ``args``/``kwargs`` are the call's arguments with every buffer read
    replaced by a :class:`BufRef`; the rest are literals (ints, floats,
    strings, lists of them).  ``src_names`` lists the buffers read, in
    argument order; ``in_avals``/``out_avals`` are their (shape, dtype)
    and those of ``dst_names``."""

    op: Any  # torch OpOverload
    args: tuple
    kwargs: dict
    src_names: tuple[str, ...]
    dst_names: tuple[str, ...]
    in_avals: tuple[tuple[tuple[int, ...], Any], ...] = ()
    out_avals: tuple[tuple[tuple[int, ...], Any], ...] = ()

    @property
    def srcs(self) -> tuple[str, ...]:
        return self.src_names

    @property
    def dsts(self) -> tuple[str, ...]:
        return self.dst_names

    @property
    def kind(self) -> str:
        return "tpu"

    @property
    def op_name(self) -> str:
        """``namespace::name`` of the op, e.g. ``aten::mm``."""
        return self.op.name().split(".")[0]

    @property
    def primitive_name(self) -> str:
        return self.op_name.split("::")[-1]


def eval_tpu_node(node: TPUNode, env: dict) -> None:
    """Execute one opaque aten call eagerly; results land in ``env`` under
    the node's dst names."""
    def resolve(a):
        return env[a.name] if isinstance(a, BufRef) else a

    args = pytree.tree_map(resolve, node.args)
    kwargs = pytree.tree_map(resolve, node.kwargs)
    out = node.op(*args, **kwargs)
    outs = out if len(node.dst_names) != 1 or isinstance(out, (tuple, list)) \
        else [out]
    for name, val in zip(node.dst_names, outs):
        env[name] = val


def eval_tpu_node_exact(node: TPUNode, env: dict) -> None:
    """Execute one opaque aten call bit-exactly vs the eager program.

    The JAX package needs a separate evaluator here: its compute phases
    normally run as one XLA computation each, whose cross-op rewrites (the
    ``rsqrt(x/c + eps)`` class) and runtime literals change the rounding,
    so its exact mode jits each eqn alone with its literals baked.  The
    port's compute phases already dispatch exactly as eager PyTorch does —
    one aten call per node, with the traced Python scalars as its literals
    — so this is :func:`eval_tpu_node`; exact mode differs only where a
    fused cross-engine phase would have run its op inside a TM kernel (see
    ``CompiledTMProgram.run_phase``)."""
    eval_tpu_node(node, env)


@dataclasses.dataclass
class TMGraph:
    """The compiler's unit of work: ordered nodes + buffer declarations."""

    nodes: list  # list[TMNode | TPUNode]
    buffers: dict[str, Buffer]
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    consts: dict[str, Any]  # const buffers -> concrete values
    matched_prims: set[str] = dataclasses.field(default_factory=set)
    # trace-time fallback notes: matchable-looking ops the front end left
    # opaque (matcher errors, …) — surfaced by the pass report so
    # compilations explain their compute residue
    notes: list = dataclasses.field(default_factory=list)

    # --- queries ----------------------------------------------------------
    def producer_index(self, name: str, before: int | None = None) -> int | None:
        """Index of the last node writing ``name`` before position ``before``."""
        hi = len(self.nodes) if before is None else before
        for i in range(hi - 1, -1, -1):
            if name in self.nodes[i].dsts:
                return i
        return None

    def consumer_indices(self, name: str, after: int = -1) -> list[int]:
        return [i for i, n in enumerate(self.nodes)
                if i > after and name in n.srcs]

    def shape(self, name: str) -> tuple[int, ...]:
        return self.buffers[name].shape

    def tm_nodes(self) -> list[TMNode]:
        return [n for n in self.nodes if n.kind == "tmu"]

    def tpu_nodes(self) -> list[TPUNode]:
        return [n for n in self.nodes if n.kind == "tpu"]

    def validate(self) -> None:
        """Every read is defined upstream (input/const or earlier dst)."""
        defined = set(self.inputs) | set(self.consts)
        for i, n in enumerate(self.nodes):
            for s in n.srcs:
                if s not in defined:
                    raise ValueError(
                        f"node {i} ({n.kind}) reads undefined buffer {s!r}")
            defined.update(n.dsts)
        for o in self.outputs:
            if o not in defined:
                raise ValueError(f"graph output {o!r} is never defined")

    def summary(self) -> str:
        tm = len(self.tm_nodes())
        tpu = len(self.tpu_nodes())
        base = (f"TMGraph: {tm} TM instr(s), {tpu} TPU node(s), "
                f"{len(self.buffers)} buffers, "
                f"matched prims: {sorted(self.matched_prims)}")
        if self.notes:
            base += f", {len(self.notes)} trace note(s)"
        return base


def itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()
