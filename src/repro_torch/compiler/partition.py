"""TPU/TMU partitioning + phase DAG + schedule hookup.

Splits the optimized :class:`~repro_torch.compiler.ir.TMGraph` into *phases* —
maximal runs of same-kind nodes in program order — and wires them into a
**data-dependency DAG**: every phase records which buffers it ``reads`` from
outside itself, which buffers it ``writes`` for downstream consumers, and
the indices of the phases those reads depend on (``deps``).  Program order
remains a valid topological order of the DAG, so the blocking executor walks
the list exactly as before, while the stream runtime
(:mod:`repro_torch.runtime.streams`) submits each phase to its engine's queue and
synchronizes only at the dependency edges — independent phases overlap.

Each TMU phase becomes a :class:`~repro_torch.core.instr.TMProgram` and is handed
to the pipeline scheduler (:func:`repro_torch.core.schedule.schedule`) together
with the forwarding edges found by
:func:`repro_torch.core.fusion.forwarding_edges`, so the cycle model reports the
paper's three-way comparison (serialized / double-buffered /
output-forwarded) for the whole compiled program.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.fusion import CrossEngineChain, cross_engine_chains
from repro_torch.core.instr import TMProgram
from repro_torch.core.schedule import (CycleParams, ScheduleReport, schedule,
                                 xengine_phase_report)
from repro_torch.compiler.ir import TMGraph


@dataclasses.dataclass
class Phase:
    kind: str                      # "tpu" | "tmu" | "fused" (engine-crossing)
    node_indices: list[int]        # indices into graph.nodes
    program: TMProgram | None = None       # tmu + fused phases (the TM run)
    schedule: ScheduleReport | None = None  # tmu + fused phases
    # --- DAG wiring (filled by partition()) -------------------------------
    index: int = 0                 # position in PartitionReport.phases
    reads: tuple[str, ...] = ()    # buffers consumed from outside the phase
    writes: tuple[str, ...] = ()   # buffers defined here, visible downstream
    deps: tuple[int, ...] = ()     # phase indices whose writes this reads
    # fused phases only: the crossing this phase realizes (compute node +
    # its adjacent TM run, one kernel launch when the lowering claims it)
    xengine: CrossEngineChain | None = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def engine(self) -> str:
        # a fused phase is anchored on its compute kernel — it runs on the
        # TPU stream (the TM chain rides the launch as commit/prologue)
        return "tpu" if self.kind in ("tpu", "fused") else "tmu"


@dataclasses.dataclass
class PartitionReport:
    phases: list[Phase]
    unpipelined_cycles: float   # all TM work strictly serialized
    pipelined_cycles: float     # double buffering within instructions
    forwarded_cycles: float     # + output forwarding along streamable edges
    forwarding_edges: int
    chained_cycles: float = 0.0  # forwarding REALIZED: chains as megakernels
    forwarding_chains: int = 0
    dag_edges: int = 0           # phase-level data-dependency edges
    # cross-engine fusion (partition(cross_engine=True) only):
    xengine_phases: int = 0          # crossings merged into fused phases
    xengine_saved_bytes: int = 0     # modeled HBM bytes the crossings elide
    xengine_saved_cycles: float = 0.0  # modeled cycle win vs the split path
    xengine_rows: list = dataclasses.field(default_factory=list)

    @property
    def tmu_phases(self) -> list[Phase]:
        return [p for p in self.phases if p.kind == "tmu"]

    @property
    def fused_phases(self) -> list[Phase]:
        return [p for p in self.phases if p.kind == "fused"]

    def launches(self, *, chained: bool = False) -> int:
        """Modeled TM kernel launches (chains collapse to one launch each
        when ``chained``).  A fused phase's TM run launches zero extra
        kernels when chained — it rides the compute kernel's launch — and
        its per-instruction count otherwise (the split path)."""
        n = sum(ph.schedule.launches(chained=chained)
                for ph in self.tmu_phases if ph.schedule is not None)
        if not chained:
            n += sum(ph.schedule.launches(chained=False)
                     for ph in self.fused_phases if ph.schedule is not None)
        return n

    def phase_mix(self) -> dict:
        """Fragmentation stats of the phase list — how much TM work sits in
        singleton phases (one instruction wedged between TPU runs) versus
        proper runs.  The phase-defrag pass drives ``tmu_singletons`` down;
        benchmarks and tests read this to show/assert the consolidation."""
        tmu = self.tmu_phases
        return {
            "phases": len(self.phases),
            "tpu_phases": sum(1 for p in self.phases if p.kind == "tpu"),
            "tmu_phases": len(tmu),
            "tmu_instrs": sum(len(p.node_indices) for p in tmu),
            "tmu_singletons": sum(1 for p in tmu
                                  if len(p.node_indices) == 1),
            "fused_phases": sum(1 for p in self.phases
                                if p.kind == "fused"),
            "kinds": "".join(_KIND_CHARS.get(p.kind, "?")
                             for p in self.phases),
        }

    def sink_phases(self) -> list[Phase]:
        """Phases no other phase depends on — the DAG's sync points."""
        depended = {d for ph in self.phases for d in ph.deps}
        return [ph for ph in self.phases if ph.index not in depended]

    @property
    def latency_reduction(self) -> float:
        if self.unpipelined_cycles == 0:
            return 0.0
        return 1.0 - self.forwarded_cycles / self.unpipelined_cycles

    def summary(self) -> str:
        kinds = "".join(_KIND_CHARS.get(p.kind, "?") for p in self.phases)
        return (f"phases [{kinds}] (T=TPU, M=TMU, F=fused), "
                f"{self.dag_edges} dep "
                f"edge(s), {len(self.sink_phases())} sink(s): "
                f"{self.unpipelined_cycles:.0f} unpipelined -> "
                f"{self.forwarded_cycles:.0f} forwarded TM cycles "
                f"({self.latency_reduction:.1%} reduction, "
                f"{self.forwarding_edges} forwarded edge(s))")


_KIND_CHARS = {"tpu": "T", "tmu": "M", "fused": "F"}


def _phase_program(graph: TMGraph, indices: list[int]) -> TMProgram:
    """Build the TMProgram of one TMU phase.

    Inputs are buffers the phase reads but does not define; outputs are
    buffers defined in the phase and read downstream (or graph outputs)."""
    instrs = [graph.nodes[i].instr for i in indices]
    defined = {ins.dst for ins in instrs}
    reads: list[str] = []
    for ins in instrs:
        for s in ins.srcs:
            if s not in defined and s not in reads:
                reads.append(s)
    last = max(indices)
    outs = []
    for ins in instrs:
        used_later = any(ins.dst in graph.nodes[k].srcs
                         for k in range(last + 1, len(graph.nodes)))
        if (ins.dst in graph.outputs or used_later) and ins.dst not in outs:
            outs.append(ins.dst)
    return TMProgram(instrs, inputs=tuple(reads), outputs=tuple(outs))


def _tpu_reads_writes(graph: TMGraph, indices: list[int],
                      ) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(external reads, downstream-visible writes) of one TPU phase."""
    nodes = [graph.nodes[i] for i in indices]
    defined = {d for n in nodes for d in n.dsts}
    reads: list[str] = []
    for n in nodes:
        for s in n.srcs:
            if s not in defined and s not in reads:
                reads.append(s)
    last = max(indices)
    writes: list[str] = []
    for n in nodes:
        for d in n.dsts:
            used_later = any(d in graph.nodes[k].srcs
                             for k in range(last + 1, len(graph.nodes)))
            if (d in graph.outputs or used_later) and d not in writes:
                writes.append(d)
    return tuple(reads), tuple(writes)


def partition(graph: TMGraph, params: CycleParams | None = None, *,
              cross_engine: bool = False) -> PartitionReport:
    """Split the graph into a phase DAG.

    With ``cross_engine`` (opt-in: the serving admission sweep pins it per
    cache entry, ``tm_compile`` forwards it), every legal engine-boundary
    crossing (:func:`repro_torch.core.fusion.cross_engine_chains`) is emitted as a
    ``"fused"`` phase claiming the compute eqn *and* its adjacent TM run —
    one launch at execution when the lowering realizes, the bit-exact split
    path otherwise.  With ``cross_engine=False`` (the default) the phase
    list is byte-identical to the pre-crossing partition."""
    xstarts: dict[int, CrossEngineChain] = {}
    if cross_engine:
        p = params or CycleParams()
        for c in cross_engine_chains(graph, p.itemsize, p.segment_bytes):
            xstarts[min(c.span)] = c

    phases: list[Phase] = []
    i = 0
    while i < len(graph.nodes):
        xc = xstarts.get(i)
        if xc is not None:
            phases.append(Phase(kind="fused", node_indices=list(xc.span),
                                xengine=xc))
            i = xc.span[-1] + 1
            continue
        node = graph.nodes[i]
        if phases and phases[-1].kind == node.kind:
            phases[-1].node_indices.append(i)
        else:
            phases.append(Phase(kind=node.kind, node_indices=[i]))
        i += 1

    unpiped = piped = fwded = chained = 0.0
    n_edges = n_chains = 0
    x_saved_bytes = 0
    x_saved_cycles = 0.0
    x_rows: list = []
    for ph in phases:
        if ph.kind == "tpu":
            continue
        tm_indices = (list(ph.xengine.tm_indices) if ph.kind == "fused"
                      else ph.node_indices)
        ph.program = _phase_program(graph, tm_indices)
        shapes = {name: graph.shape(name) for name in ph.program.inputs}
        ph.schedule = schedule(ph.program, shapes, params)
        unpiped += ph.schedule.unpipelined_cycles
        piped += ph.schedule.pipelined_cycles
        fwded += ph.schedule.forwarded_cycles
        chained += ph.schedule.chained_cycles
        n_edges += len(ph.schedule.forwards)
        n_chains += len(ph.schedule.chains)
        if ph.kind == "fused":
            row = xengine_phase_report(
                ph.program, shapes, params,
                crossing_shape=graph.shape(ph.xengine.buffer),
                direction=ph.xengine.direction)
            x_saved_bytes += row["saved_bytes"]
            x_saved_cycles += row["saved_cycles"]
            x_rows.append(row)

    # --- DAG wiring: reads/writes per phase, then producer edges ----------
    producer: dict[str, int] = {}   # buffer -> phase index that writes it
    dag_edges = 0
    for idx, ph in enumerate(phases):
        ph.index = idx
        if ph.kind == "tmu":
            ph.reads = tuple(ph.program.inputs)
            ph.writes = tuple(ph.program.outputs)
        else:
            # _tpu_reads_writes is generic over node srcs/dsts, so a fused
            # phase's reads/writes span the eqn AND its TM run — the
            # crossing buffer is internal and never appears (zero HBM)
            ph.reads, ph.writes = _tpu_reads_writes(graph, ph.node_indices)
        deps = []
        for name in ph.reads:
            src = producer.get(name)   # graph inputs/consts have no producer
            if src is not None and src not in deps:
                deps.append(src)
        ph.deps = tuple(sorted(deps))
        dag_edges += len(ph.deps)
        for name in ph.writes:
            producer[name] = idx

    return PartitionReport(phases=phases, unpipelined_cycles=unpiped,
                           pipelined_cycles=piped, forwarded_cycles=fwded,
                           forwarding_edges=n_edges, chained_cycles=chained,
                           forwarding_chains=n_chains, dag_edges=dag_edges,
                           xengine_phases=len(x_rows),
                           xengine_saved_bytes=x_saved_bytes,
                           xengine_saved_cycles=x_saved_cycles,
                           xengine_rows=x_rows)
