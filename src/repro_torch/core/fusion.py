"""Program fusion pass — the GPU form of near-memory execution.

On the TMU, a TM op costs zero extra memory-hierarchy round-trips because the
manipulation happens inside the DMA path.  On a GPU, the equivalent is *copy
elision by composition*: adjacent coarse-grained instructions whose
intermediate buffer has a single consumer are fused by composing their
address maps (A2·A1, A2·B1+B2 — exactly the register-level composition the
paper's abstraction admits), so the intermediate tensor is never
materialized in HBM.

The pass also folds element-wise instructions into the epilogue of a
preceding coarse op (the paper's element-wise stage runs in the same pipeline
pass), and reports the HBM traffic eliminated — the quantity the paper's
bandwidth-normalized benchmark measures.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.affine import MixedRadixMap, compose_maps
from repro_torch.core.instr import TMInstr, TMOpcode, TMProgram


@dataclasses.dataclass
class FusionReport:
    fused_pairs: int
    elided_buffers: list[str]
    bytes_before: int
    bytes_after: int

    @property
    def traffic_reduction(self) -> float:
        if self.bytes_before == 0:
            return 0.0
        return 1.0 - self.bytes_after / self.bytes_before


@dataclasses.dataclass(frozen=True)
class ForwardEdge:
    """Producer instruction ``producer`` streams committed output segments of
    ``buffer`` directly into consumer instruction ``consumer``."""

    producer: int
    consumer: int
    buffer: str


def forwarding_edges(prog: TMProgram) -> list[ForwardEdge]:
    """Cross-instruction output forwarding (paper Fig. 5c).

    Where :func:`fuse` *elides* an intermediate by composing address maps,
    forwarding is the weaker-but-universal form: any single-consumer
    intermediate — composable or not — can be streamed segment-by-segment
    into its consumer, so the consumer starts as soon as the producer commits
    its first block iteration instead of after the full tensor lands.  The
    schedule pass (:mod:`repro_torch.core.schedule`) turns these edges into
    overlapped start times; this function only identifies legality:

      * the buffer is an intermediate (inputs/outputs must materialize), and
      * it has exactly one consumer, downstream of the producer (a second
        consumer would need the full tensor buffered anyway).
    """
    edges: list[ForwardEdge] = []
    ext = set(prog.inputs) | set(prog.outputs)
    for i, producer in enumerate(prog.instrs):
        dst = producer.dst
        if dst in ext:
            continue
        cons = prog.consumer_indices(dst)
        if len(cons) != 1 or cons[0] <= i:
            continue
        if any(prog.instrs[k].dst == dst for k in range(i + 1, cons[0])):
            continue  # rebound before the consumer: this write is stale
        edges.append(ForwardEdge(producer=i, consumer=cons[0], buffer=dst))
    return edges


@dataclasses.dataclass(frozen=True)
class ForwardChain:
    """A maximal run of forwarding edges that can execute as ONE kernel.

    ``instrs`` are consecutive instruction indices (producer -> ... -> final
    consumer); ``buffers`` are the intermediates handed off between the links
    (``len(buffers) == len(instrs) - 1``).  Each intermediate is streamed
    segment-by-segment through on-chip scratch instead of round-tripping HBM
    when the chain is lowered by :func:`repro_torch.core.dispatch.lower_chain`.
    """

    instrs: tuple[int, ...]
    buffers: tuple[str, ...]
    # chains discovered by :func:`cross_engine_chains` span the compute/TM
    # boundary: "compute_to_tm" (the TM run is a compute kernel's commit
    # stage) or "tm_to_compute" (the TM run is its consumer's operand-load
    # prologue).  None — the default, and the only value
    # :func:`forwarding_chains` produces — keeps the chain TM-internal.
    # NOTE: crossing chains index *graph nodes*, not TMProgram positions.
    engine_crossing: str | None = None

    def __len__(self) -> int:
        return len(self.instrs)


def forwarding_chains(prog: TMProgram) -> list[ForwardChain]:
    """Group :func:`forwarding_edges` into maximal producer→consumer chains.

    A chain is a run of edges ``(i, i+1), (i+1, i+2), ...`` — each link's
    consumer is the next link's producer, and links are *adjacent in program
    order* so the executor can evaluate the whole chain at the position of
    its first instruction (every non-chain operand the links read is already
    bound there; an edge with a gap would let an in-between instruction's
    output feed a later link's epilogue, which chain execution would miss).

    Legality beyond grouping (opcode support, map composition geometry, on-chip
    residency of the chain input) is the dispatch layer's job — a chain this
    function reports may still fall back to per-instruction lowering.
    """
    by_producer = {e.producer: e for e in forwarding_edges(prog)
                   if e.consumer == e.producer + 1}
    chains: list[ForwardChain] = []
    taken: set[int] = set()
    for i in sorted(by_producer):
        if i in taken:
            continue
        idxs = [i]
        bufs = []
        j = i
        while j in by_producer:
            e = by_producer[j]
            bufs.append(e.buffer)
            idxs.append(e.consumer)
            taken.add(j)
            j = e.consumer
        chains.append(ForwardChain(instrs=tuple(idxs), buffers=tuple(bufs)))
    return chains


# ---------------------------------------------------------------------------
# cross-engine forwarding (paper Fig. 5c across the compute/TM boundary)
# ---------------------------------------------------------------------------

# compute ops whose kernel can host a TM chain as its commit (epilogue) or
# operand-load prologue stage — see kernels/matmul_tm/chain.py.  The JAX
# package's dot_general and conv_general_dilated: a 2D ``@`` traces to
# aten.mm, and the models' NHWC convolution is one custom op
XENGINE_PRIMS = ("aten::mm", "repro_torch::conv2d_nhwc")


def grids_commensurable(n_a: int, n_b: int) -> bool:
    """Two block grids are commensurable when one step count divides the
    other: the fused kernel can then phase its hand-off so every producer
    block lands on a whole number of consumer segments (or vice versa)."""
    return n_a > 0 and n_b > 0 and (n_a % n_b == 0 or n_b % n_a == 0)


@dataclasses.dataclass(frozen=True)
class CrossEngineChain:
    """One engine-boundary crossing: a compute node plus the adjacent COARSE
    TM run it forwards to (or from), executable as ONE kernel launch.

    ``chain`` holds the TM run as a :class:`ForwardChain` over *graph node
    indices* with ``engine_crossing`` set; ``eqn_index`` is the compute
    node; ``buffer`` is the crossing intermediate that never reaches device
    memory when the lowering realizes."""

    chain: ForwardChain
    eqn_index: int
    buffer: str

    @property
    def direction(self) -> str:
        return self.chain.engine_crossing or ""

    @property
    def tm_indices(self) -> tuple[int, ...]:
        return self.chain.instrs

    @property
    def span(self) -> tuple[int, ...]:
        """All claimed graph-node indices, in program order (the compute
        node and its TM run are adjacent by construction)."""
        return tuple(sorted((self.eqn_index,) + self.chain.instrs))


def _tm_run(graph, start: int, outputs: set) -> tuple[list[int], list[str]]:
    """Maximal graph-level forwarding run of COARSE TM nodes from ``start``:
    each link's dst is an intermediate whose sole consumer is the next node,
    streamed through the next link's primary (srcs[0]) slot — the geometry
    the chain pullback supports (a multi-band Route may consume it in any
    band slot)."""
    nodes = graph.nodes
    idxs, bufs = [start], []
    j = start
    while True:
        dst = nodes[j].instr.dst
        if dst in outputs:
            break
        cons = graph.consumer_indices(dst)
        if len(cons) != 1 or cons[0] != j + 1:
            break
        nxt = nodes[cons[0]]
        if nxt.kind != "tmu" or nxt.instr.opcode != TMOpcode.COARSE:
            break
        if nxt.instr.map_ is not None and nxt.instr.srcs[0] != dst:
            break  # dst would land in the EW-operand slot: not streamable
        bufs.append(dst)
        idxs.append(cons[0])
        j = cons[0]
    return idxs, bufs


def _sole_next_consumer(graph, name: str, i: int) -> int | None:
    cons = graph.consumer_indices(name)
    return cons[0] if len(cons) == 1 and cons[0] == i + 1 else None


def _eqn_grid_steps(graph, node, itemsize: int,
                    segment_bytes: int | None) -> int:
    """Block-grid step count of the compute node inside the fused kernel,
    as the JAX package counts it: the row blocks of a 2D ``(M,K)@(K,N)``
    product (:func:`plan_segments` on the result); a conv binds as ONE
    whole-op step."""
    from repro_torch.core.schedule import plan_segments  # local: avoids cycle

    if node.op_name != "aten::mm":
        return 1
    return plan_segments(graph.shape(node.dst_names[0]), itemsize,
                         segment_bytes).n_segments


def cross_engine_chains(graph, itemsize: int = 4,
                        segment_bytes: int | None = None,
                        ) -> list[CrossEngineChain]:
    """Discover legal engine-boundary crossings in a TMGraph.

    compute→TM: a supported single-output compute node whose result's sole
    consumer is the immediately-following COARSE TM node (primary slot),
    extended through the maximal TM forwarding run.  TM→compute: a COARSE
    TM run whose final dst's sole consumer is the immediately-following
    supported compute node, appearing in exactly one operand slot.  Beyond
    adjacency the two block grids must be commensurable.  Scanning claims
    greedily left-to-right — a compute→TM→compute sandwich resolves as
    compute→TM.  The lowering may still decline a reported crossing
    (pullback or budget limits); execution then takes the split path."""
    from repro_torch.core.schedule import plan_segments  # local: cycle

    out: list[CrossEngineChain] = []
    nodes = graph.nodes
    n = len(nodes)
    outputs = set(graph.outputs)

    def n_segs(name: str) -> int:
        return plan_segments(graph.shape(name), itemsize,
                             segment_bytes).n_segments

    i = 0
    while i < n:
        node = nodes[i]
        if (node.kind == "tpu" and node.op_name in XENGINE_PRIMS
                and len(node.dst_names) == 1):
            y = node.dst_names[0]
            nxt = None if y in outputs else _sole_next_consumer(graph, y, i)
            if (nxt is not None and nodes[nxt].kind == "tmu"
                    and nodes[nxt].instr.opcode == TMOpcode.COARSE
                    and nodes[nxt].instr.srcs
                    and nodes[nxt].instr.srcs[0] == y):
                idxs, bufs = _tm_run(graph, nxt, outputs)
                final = nodes[idxs[-1]].instr.dst
                steps = _eqn_grid_steps(graph, node, itemsize, segment_bytes)
                if grids_commensurable(steps, n_segs(final)):
                    out.append(CrossEngineChain(
                        chain=ForwardChain(
                            instrs=tuple(idxs), buffers=tuple(bufs),
                            engine_crossing="compute_to_tm"),
                        eqn_index=i, buffer=y))
                    i = idxs[-1] + 1
                    continue
        if node.kind == "tmu" and node.instr.opcode == TMOpcode.COARSE:
            idxs, bufs = _tm_run(graph, i, outputs)
            last = idxs[-1]
            dst = nodes[last].instr.dst
            nxt = (None if dst in outputs
                   else _sole_next_consumer(graph, dst, last))
            # the prologue binds the compute op as ONE step, so its grid is
            # commensurable with any chain segment grid by construction
            if (nxt is not None and nodes[nxt].kind == "tpu"
                    and nodes[nxt].op_name in XENGINE_PRIMS
                    and len(nodes[nxt].dst_names) == 1
                    and sum(1 for s in nodes[nxt].src_names if s == dst) == 1
                    and grids_commensurable(n_segs(dst), 1)):
                out.append(CrossEngineChain(
                    chain=ForwardChain(
                        instrs=tuple(idxs), buffers=tuple(bufs),
                        engine_crossing="tm_to_compute"),
                    eqn_index=nxt, buffer=dst))
                i = nxt + 1
                continue
        i += 1
    return out


def _map_bytes(m: MixedRadixMap, itemsize: int = 4) -> int:
    return math.prod(m.out_shape) * itemsize


def fuse(prog: TMProgram, itemsize: int = 4) -> tuple[TMProgram, FusionReport]:
    """Fuse single-consumer coarse->coarse chains by map composition.

    Iterates to fixpoint.  Unfusable pairs (rational/split interactions, see
    :func:`compose_maps`) are left untouched — they fall back to two engine
    passes, exactly like a TMU issuing two instructions.
    """
    instrs = list(prog.instrs)
    elided: list[str] = []
    fused = 0
    bytes_before = _program_traffic(prog, itemsize)

    changed = True
    while changed:
        changed = False
        for i, producer in enumerate(instrs):
            if producer is None or producer.opcode != TMOpcode.COARSE:
                continue
            if producer.map_ is None:  # multi-map Route: not chain-fusable
                continue
            if producer.ew is not None:
                # the epilogue operand is consumed in the producer's output
                # layout; composing the consumer's map over it would need the
                # operand re-mapped too — two instructions stay two
                continue
            dst = producer.dst
            if dst in prog.outputs or dst in prog.inputs:
                continue
            cons = [j for j, ins in enumerate(instrs)
                    if ins is not None and dst in ins.srcs]
            if len(cons) != 1:
                continue
            j = cons[0]
            consumer = instrs[j]
            if consumer.opcode != TMOpcode.COARSE or consumer.map_ is None:
                continue
            if consumer.srcs != (dst,):
                continue
            m = compose_maps(consumer.map_, producer.map_)
            if m is None:
                continue
            instrs[j] = TMInstr(
                opcode=TMOpcode.COARSE, srcs=producer.srcs, dst=consumer.dst,
                map_=m, meta={"fused_from": [producer.dst, consumer.dst]},
            )
            instrs[i] = None
            elided.append(dst)
            fused += 1
            changed = True
            break

    out = TMProgram([x for x in instrs if x is not None], prog.inputs, prog.outputs)
    report = FusionReport(
        fused_pairs=fused, elided_buffers=elided,
        bytes_before=bytes_before, bytes_after=_program_traffic(out, itemsize),
    )
    return out, report


def _program_traffic(prog: TMProgram, itemsize: int) -> int:
    """HBM bytes touched by the program: every instruction reads its sources
    and writes its destination (the memory-to-memory model)."""
    total = 0
    for ins in prog.instrs:
        if ins.map_ is not None:
            total += math.prod(ins.map_.in_shape) * itemsize   # load
            total += math.prod(ins.map_.out_shape) * itemsize  # store
        elif ins.maps is not None:
            for m in ins.maps:
                total += math.prod(m.in_shape) * itemsize
            total += math.prod(ins.maps[0].out_shape) * itemsize
    return total
