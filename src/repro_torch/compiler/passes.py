"""Instruction-level optimization passes over the TM IR.

Each pass rewrites the :class:`~repro_torch.compiler.ir.TMGraph` in place and
records what it did in a :class:`PassReport` — the printed pass pipeline is
part of the compiler's contract (tests assert which rewrites fired).

Passes, in pipeline order:

1. **compose-maps** — adjacent COARSE instructions with a single-consumer
   intermediate fuse into one instruction by exact affine map composition
   (:func:`repro_torch.core.affine.compose_maps`): the TMU's A2·A1 register-level
   composition, eliminating one full HBM round trip per fusion.
2. **copy-elim** — COPY instructions and identity-map COARSE instructions
   are removed by rewiring their consumers to the source buffer.
3. **epilogue-sink** — an ELEMENTWISE instruction whose streamed operand is
   produced by a single-consumer COARSE instruction sinks into that
   instruction's element-wise stage (same pipeline pass, paper Fig. 3).
4. **rme-legalize** — FINE instructions over batched record streams get
   their ``batch_dims`` legalized so the executor dispatches the batched RME
   Pallas kernel instead of falling back.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.affine import compose_maps
from repro_torch.core.instr import TMInstr, TMOpcode
from repro_torch.compiler.ir import TMGraph, TMNode


@dataclasses.dataclass
class PassAction:
    pass_name: str
    detail: str


@dataclasses.dataclass
class PassReport:
    actions: list[PassAction] = dataclasses.field(default_factory=list)

    def record(self, pass_name: str, detail: str) -> None:
        self.actions.append(PassAction(pass_name, detail))

    def count(self, pass_name: str) -> int:
        return sum(1 for a in self.actions if a.pass_name == pass_name)

    @property
    def compositions(self) -> int:
        return self.count("compose-maps")

    @property
    def copies_elided(self) -> int:
        return self.count("copy-elim")

    @property
    def epilogues_sunk(self) -> int:
        return self.count("epilogue-sink")

    @property
    def rme_legalized(self) -> int:
        return self.count("rme-legalize")

    @property
    def trace_fallbacks(self) -> int:
        return self.count("trace-fallback")

    @property
    def phases_defragmented(self) -> int:
        return self.count("phase-defrag")

    def summary(self) -> str:
        lines = ["pass pipeline:"]
        for name in ("trace-fallback", "compose-maps", "copy-elim",
                     "epilogue-sink", "rme-legalize", "phase-defrag"):
            fired = [a.detail for a in self.actions if a.pass_name == name]
            lines.append(f"  {name:14s} {len(fired)} rewrite(s)")
            lines.extend(f"    - {d}" for d in fired)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# pass 1: affine map composition
# ---------------------------------------------------------------------------

def _single_tm_consumer(graph: TMGraph, name: str, after: int):
    """The unique consumer node index of ``name``, when it is a TM node and
    ``name`` is not rebound in between; else None."""
    if name in graph.outputs or name in graph.inputs:
        return None
    cons = graph.consumer_indices(name, after=after)
    if len(cons) != 1:
        return None
    j = cons[0]
    for k in range(after + 1, j):
        if name in graph.nodes[k].dsts:
            return None  # rebound before the consumer
    return j


def compose_coarse_chains(graph: TMGraph, report: PassReport) -> None:
    """Fuse COARSE -> COARSE single-consumer chains by map composition."""
    changed = True
    while changed:
        changed = False
        for i, node in enumerate(graph.nodes):
            if node.kind != "tmu":
                continue
            prod = node.instr
            if (prod.opcode != TMOpcode.COARSE or prod.map_ is None
                    or prod.ew is not None):
                continue
            j = _single_tm_consumer(graph, prod.dst, i)
            if j is None or graph.nodes[j].kind != "tmu":
                continue
            cons = graph.nodes[j].instr
            if (cons.opcode != TMOpcode.COARSE or cons.map_ is None
                    or cons.ew is not None or cons.srcs != (prod.dst,)):
                continue
            m = compose_maps(cons.map_, prod.map_)
            if m is None:
                continue
            # moving the read of prod.srcs from i to j needs those buffers
            # not rebound in between (always true for SSA traces)
            if any(graph.producer_index(s, before=j) !=
                   graph.producer_index(s, before=i) for s in prod.srcs):
                continue
            graph.nodes[j] = TMNode(
                TMInstr(TMOpcode.COARSE, prod.srcs, cons.dst, map_=m,
                        meta={"fused_from": [prod.dst, cons.dst]}),
                matched=graph.nodes[j].matched)
            del graph.nodes[i]
            report.record("compose-maps",
                          f"{prod.dst} ∘ {cons.dst} -> one map "
                          f"(elided {prod.dst})")
            changed = True
            break


# ---------------------------------------------------------------------------
# pass 2: copy elimination
# ---------------------------------------------------------------------------

def _is_identity(ins: TMInstr) -> bool:
    if ins.opcode == TMOpcode.COPY:
        return True
    if ins.opcode != TMOpcode.COARSE or ins.map_ is None or ins.ew is not None:
        return False
    m = ins.map_
    return (m.in_shape == m.out_shape and not m.oob_possible
            and m.is_pure_permutation()
            and m.permutation() == tuple(range(len(m.in_shape))))


def eliminate_copies(graph: TMGraph, report: PassReport) -> None:
    """Remove COPY / identity-map instructions by aliasing dst to src."""
    i = 0
    while i < len(graph.nodes):
        node = graph.nodes[i]
        if (node.kind != "tmu" or not _is_identity(node.instr)
                or node.instr.dst in graph.outputs):
            i += 1
            continue
        src, dst = node.instr.srcs[0], node.instr.dst
        # aliasing is only sound while src is not rebound downstream
        if any(src in graph.nodes[k].dsts or dst in graph.nodes[k].dsts
               for k in range(i + 1, len(graph.nodes))):
            i += 1
            continue
        # rewire every later read of dst to src (dst is SSA: written once)
        for k in range(i + 1, len(graph.nodes)):
            n = graph.nodes[k]
            if dst not in n.srcs:
                continue
            if n.kind == "tmu":
                ins = n.instr
                graph.nodes[k] = TMNode(dataclasses.replace(
                    ins, srcs=tuple(src if s == dst else s for s in ins.srcs)),
                    matched=n.matched)
            else:
                n.src_names = tuple(src if s == dst else s
                                    for s in n.src_names)
        del graph.nodes[i]
        report.record("copy-elim", f"{dst} aliased to {src}")


# ---------------------------------------------------------------------------
# pass 3: elementwise epilogue sinking
# ---------------------------------------------------------------------------

_COMMUTATIVE = {"add", "mul", "max"}


def sink_epilogues(graph: TMGraph, report: PassReport) -> None:
    """Fold ELEMENTWISE instructions into the preceding COARSE instruction's
    element-wise stage when legal: the coarse result is the streamed operand,
    its only consumer is the elementwise op, and the other operand is already
    available before the coarse instruction issues."""
    changed = True
    while changed:
        changed = False
        for j, node in enumerate(graph.nodes):
            if node.kind != "tmu" or node.instr.opcode != TMOpcode.ELEMENTWISE:
                continue
            ew = node.instr
            for pos in (0, 1):
                streamed, other = ew.srcs[pos], ew.srcs[1 - pos]
                if pos == 1 and ew.ew.value not in _COMMUTATIVE:
                    continue  # sub is ordered: only srcs[0] may stream
                i = graph.producer_index(streamed, before=j)
                if i is None or graph.nodes[i].kind != "tmu":
                    continue
                prod = graph.nodes[i].instr
                if (prod.opcode != TMOpcode.COARSE or prod.ew is not None
                        or prod.maps is not None):
                    continue
                if _single_tm_consumer(graph, streamed, i) != j:
                    continue
                if graph.shape(other) != graph.shape(streamed):
                    continue
                op = graph.producer_index(other, before=i + 1)
                avail = (other in graph.inputs or other in graph.consts
                         or op is not None)
                if not avail or streamed == other:
                    continue
                if graph.producer_index(other, before=j) != op:
                    continue  # other is rebound between i and j
                graph.nodes[i] = TMNode(
                    TMInstr(TMOpcode.COARSE, prod.srcs + (other,), ew.dst,
                            map_=prod.map_, ew=ew.ew,
                            meta={"epilogue_from": ew.dst}),
                    matched=graph.nodes[i].matched)
                del graph.nodes[j]
                report.record("epilogue-sink",
                              f"{ew.ew.value}({streamed}, {other}) sunk into "
                              f"coarse instr -> {ew.dst}")
                changed = True
                break
            if changed:
                break


# ---------------------------------------------------------------------------
# pass 4: RME batch legalization
# ---------------------------------------------------------------------------

def legalize_rme_batch(graph: TMGraph, report: PassReport) -> None:
    """Pin ``batch_dims`` metadata on FINE instructions from the buffer
    shapes, so the executor dispatches the batched RME kernel (the record
    stream is the trailing (N, D); everything leading is batch)."""
    for i, node in enumerate(graph.nodes):
        if node.kind != "tmu":
            continue
        ins = node.instr
        if ins.opcode not in (TMOpcode.FINE_EVALUATE, TMOpcode.FINE_ASSEMBLE):
            continue
        rank = len(graph.shape(ins.srcs[0]))
        bd = max(0, rank - 2)
        meta = dict(ins.meta or {})
        if meta.get("batch_dims") == bd:
            continue
        meta["batch_dims"] = bd
        graph.nodes[i] = TMNode(dataclasses.replace(ins, meta=meta),
                                matched=node.matched)
        report.record("rme-legalize",
                      f"{ins.dst}: batch_dims={bd} "
                      f"(batch {graph.shape(ins.srcs[0])[:bd]})")


# ---------------------------------------------------------------------------
# pass 5: phase defragmentation
# ---------------------------------------------------------------------------

def defragment_phases(graph: TMGraph, report: PassReport) -> None:
    """Move *singleton* TM nodes through neighbouring TPU nodes so they join
    the nearest TM run.

    The partitioner groups maximal same-kind runs into phases, so a lone TM
    instruction wedged between TPU equations — the batching/broadcasting
    reshapes vmap mints around a matmul are the canonical case — costs two
    extra phase boundaries (TPU→TM→TPU) for one instruction's worth of work.
    Reordering is sound under SSA when the node's reads still see the same
    producers and nothing jumped over reads the node's destination:

    * forward past TPU nodes: legal iff none of them reads ``node.dst``;
    * backward past TPU nodes: legal iff none of them writes a buffer the
      node reads.

    Runs to fixpoint; two mutually-stranded singletons merge into a run of
    two, which later singletons can then join."""
    changed = True
    while changed:
        changed = False
        n = len(graph.nodes)
        for i, node in enumerate(graph.nodes):
            if node.kind != "tmu":
                continue
            if (i > 0 and graph.nodes[i - 1].kind == "tmu") or \
                    (i + 1 < n and graph.nodes[i + 1].kind == "tmu"):
                continue  # already part of a run
            fwd = next((j for j in range(i + 1, n)
                        if graph.nodes[j].kind == "tmu"), None)
            bwd = next((j for j in range(i - 1, -1, -1)
                        if graph.nodes[j].kind == "tmu"), None)
            candidates = sorted(
                (c for c in (("forward", fwd), ("backward", bwd))
                 if c[1] is not None),
                key=lambda c: abs(c[1] - i))
            for direction, j in candidates:
                if direction == "forward":
                    jumped = graph.nodes[i + 1:j]
                    if any(d in g.srcs for g in jumped for d in node.dsts):
                        continue
                    if any(s in g.dsts for g in jumped for s in node.srcs):
                        continue  # unreachable under SSA; guard anyway
                    graph.nodes.insert(j - 1, graph.nodes.pop(i))
                else:
                    jumped = graph.nodes[j + 1:i]
                    if any(s in g.dsts for g in jumped for s in node.srcs):
                        continue
                    if any(d in g.srcs or d in g.dsts
                           for g in jumped for d in node.dsts):
                        continue  # unreachable under SSA; guard anyway
                    graph.nodes.insert(j + 1, graph.nodes.pop(i))
                report.record(
                    "phase-defrag",
                    f"{node.instr.dst} ({node.matched or node.instr.opcode.value})"
                    f" moved {direction} past {len(jumped)} tpu node(s)")
                changed = True
                break
            if changed:
                break


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def run_pipeline(graph: TMGraph) -> PassReport:
    report = PassReport()
    # surface the front end's fallback notes first: matchable-looking eqns
    # that stayed opaque (e.g. dynamic_slice with traced starts) explain
    # themselves in the same report as the rewrites
    for note in graph.notes:
        report.record("trace-fallback", note)
    compose_coarse_chains(graph, report)
    eliminate_copies(graph, report)
    sink_epilogues(graph, report)
    legalize_rme_batch(graph, report)
    # defrag after the structural rewrites: it permutes node order only (no
    # instruction changes), so running it last moves the final instruction set
    defragment_phases(graph, report)
    graph.validate()
    return report
