"""Program-level pipeline scheduler — double buffering + output forwarding.

The paper's end-to-end win (34.6% latency reduction, Section VI) comes from
*pipeline integration*, not the operator bodies: the TMU segments every
tensor into block iterations that stream through ping-pong buffers (double
buffering: segment k+1's load overlaps segment k's compute and segment k-1's
store), and producers forward committed segments straight into consumers
(output forwarding: the next instruction starts before this one finishes).

This module models both on a :class:`~repro_torch.core.instr.TMProgram` with an
explicit cycle model, producing a :class:`ScheduleReport` that compares

  * ``unpipelined_cycles`` — every stage strictly serialized, every
    intermediate made whole before the consumer starts (the paper's
    CPU-style baseline);
  * ``pipelined_cycles``   — double buffering inside each instruction,
    instructions still serialized on whole tensors;
  * ``forwarded_cycles``   — double buffering plus output forwarding along
    the edges found by :func:`repro_torch.core.fusion.forwarding_edges`.

The same segmentation is the JAX package's kernel grid (a block iteration
is one kernel grid step), and the kernel rules here report it as
``Lowering.segments``, so both packages count the same block iterations;
the constants are calibratable, the *ratios* are the deliverable.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.affine import batch_extend_map
from repro_torch.core.fusion import (ForwardChain, ForwardEdge,
                                     forwarding_chains, forwarding_edges)
from repro_torch.core.instr import TMInstr, TMOpcode, TMProgram


@dataclasses.dataclass(frozen=True)
class CycleParams:
    """Cycle-model constants (defaults loosely follow the paper's 40nm TMU:
    a 128-bit AXI port and a 16-lane manipulation datapath).

    ``segment_bytes`` is the shared ping-pong budget: the kernel rules report
    their grids from the same plan, so model segment counts equal kernel
    grids (``Lowering.segments``).  A *custom* value reconfigures both sides:
    pass the params to :class:`~repro_torch.core.executor.TMExecutor` and the
    budget flows through dispatch into the launched kernels, keeping model
    and grids in lock-step (the serving runtime's per-entry config selection
    relies on this)."""

    bandwidth_bytes: float = 16.0   # bytes moved per cycle per direction
    lanes: float = 16.0             # elements manipulated per cycle
    issue_overhead: float = 32.0    # fetch+decode cycles per instruction
    segment_bytes: int = 16384      # one ping-pong buffer (block iteration)
    itemsize: int = 4


@dataclasses.dataclass(frozen=True)
class InstrTiming:
    """Per-instruction segmentation + per-segment stage cycles."""

    index: int
    dst: str
    opcode: str
    n_segments: int
    load: float      # per-segment Tensor Load cycles
    compute: float   # per-segment fine/ew/coarse datapath cycles
    store: float     # per-segment Tensor Store cycles
    launches: int = 1  # kernel launches (a multi-band Route is one per band)

    @property
    def segment_cycles(self) -> float:
        return self.load + self.compute + self.store

    @property
    def serial_cycles(self) -> float:
        """All segments strictly serialized (no double buffering)."""
        return self.n_segments * self.segment_cycles

    @property
    def pipelined_cycles(self) -> float:
        """Double-buffered: fill + drain + steady state at the bottleneck."""
        steady = max(self.load, self.compute, self.store)
        return self.segment_cycles + (self.n_segments - 1) * steady

    @property
    def first_commit_cycles(self) -> float:
        """Cycles until the first output segment lands (forwarding latency)."""
        return self.segment_cycles


@dataclasses.dataclass
class ScheduleReport:
    timings: list[InstrTiming]
    forwards: list[ForwardEdge]
    unpipelined_cycles: float
    pipelined_cycles: float
    forwarded_cycles: float
    params: CycleParams
    # chain-fused execution (the REALIZED form of forwarding): each
    # forwardable chain collapses into one kernel launch whose grid streams
    # the final output's segments; ``chained_cycles`` is directly comparable
    # to ``pipelined_cycles`` (per-instruction launches, what the unchained
    # kernel backend realizes) and to ``forwarded_cycles`` (the modeled
    # overlap the chain kernel replaces with actual on-chip streaming)
    chains: list[ForwardChain] = dataclasses.field(default_factory=list)
    chained_cycles: float = 0.0
    chain_reports: list[dict] = dataclasses.field(default_factory=list)

    @property
    def pipeline_speedup(self) -> float:
        return self.unpipelined_cycles / max(self.forwarded_cycles, 1e-9)

    @property
    def double_buffer_speedup(self) -> float:
        return self.unpipelined_cycles / max(self.pipelined_cycles, 1e-9)

    @property
    def chain_speedup(self) -> float:
        """Realized chained vs realized per-instruction execution."""
        return self.pipelined_cycles / max(self.chained_cycles, 1e-9)

    def launches(self, *, chained: bool = False) -> int:
        """Kernel launches the model charges: per-instruction, a multi-band
        Route launches once per band; chained, each chain is ONE launch."""
        per_instr = {t.index: t for t in self.timings}
        n = 0
        covered = {i for c in self.chains for i in c.instrs} if chained else set()
        for i, t in per_instr.items():
            if i in covered:
                continue
            n += t.launches
        if chained:
            n += len(self.chains)
        return n

    def rows(self) -> list[dict]:
        """Flat per-instruction rows for benchmark tables/plots."""
        return [{
            "index": t.index, "dst": t.dst, "opcode": t.opcode,
            "segments": t.n_segments, "serial": t.serial_cycles,
            "pipelined": t.pipelined_cycles,
            "forwarded": any(e.producer == t.index for e in self.forwards),
        } for t in self.timings]


# ---------------------------------------------------------------------------
# shape inference over the buffer file
# ---------------------------------------------------------------------------

def infer_shapes(prog: TMProgram,
                 input_shapes: dict[str, tuple[int, ...]]) -> dict[str, tuple[int, ...]]:
    """Propagate buffer shapes through the instruction stream."""
    shapes = dict(input_shapes)
    for ins in prog.instrs:
        for s in ins.srcs:
            if s not in shapes:
                raise KeyError(f"instruction {ins.dst!r} reads undeclared "
                               f"buffer {s!r}")
        shapes[ins.dst] = _out_shape(ins, shapes)
    return shapes


def _out_shape(ins: TMInstr, shapes: dict) -> tuple[int, ...]:
    if ins.opcode == TMOpcode.COARSE:
        return (ins.maps[0].out_shape if ins.maps is not None
                else ins.map_.out_shape)
    if ins.opcode in (TMOpcode.COPY, TMOpcode.ELEMENTWISE):
        return shapes[ins.srcs[0]]
    if ins.opcode == TMOpcode.RESIZE:
        src = shapes[ins.srcs[0]]
        return tuple(src[:-3]) + (ins.meta["out_h"], ins.meta["out_w"], src[-1])
    bd = (ins.meta or {}).get("batch_dims", 0)
    if ins.opcode == TMOpcode.FINE_ASSEMBLE:
        src = shapes[ins.srcs[0]]
        if ins.rme.lane_mask is not None:
            return tuple(src[:-1]) + (sum(1 for v in ins.rme.lane_mask if v),)
        return tuple(src[:bd]) + (ins.rme.capacity,) + tuple(src[bd + 1:])
    if ins.opcode == TMOpcode.FINE_EVALUATE:
        src = shapes[ins.srcs[0]]
        cap = ins.rme.capacity if ins.rme.capacity is not None else ins.rme.top_k
        return tuple(src[:bd]) + (cap,) + tuple(src[bd + 1:])
    raise ValueError(f"unknown opcode {ins.opcode}")


# ---------------------------------------------------------------------------
# segmentation — the single source of truth shared with the kernel rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Row-wise segmentation of an output tensor (the block-iteration plan).

    The tensor is viewed as (rows, minor) with ``minor`` the last axis; one
    segment is ``row_block`` whole rows, sized to fit one ping-pong buffer
    (``segment_bytes``).  ``row_block`` always divides ``rows``."""

    rows: int
    minor: int
    row_block: int

    @property
    def n_segments(self) -> int:
        return self.rows // self.row_block


def plan_segments(out_shape: tuple[int, ...], itemsize: int = 4,
                  segment_bytes: int | None = None) -> SegmentPlan:
    """Segment an output tensor into block iterations.

    This is THE segmentation: the cycle model charges per-segment stage
    cycles from it, and the gather kernel rule reports it as its segment count
    (:mod:`repro_torch.kernels.tm_affine`), so the model's block counts and the
    kernels' grids cannot drift apart."""
    sb = segment_bytes if segment_bytes is not None else CycleParams().segment_bytes
    minor = out_shape[-1] if out_shape else 1
    rows = math.prod(out_shape[:-1]) if len(out_shape) > 1 else 1
    per_row = max(1, minor * itemsize)
    target = max(1, sb // per_row)
    rb = min(target, rows)
    while rows % rb:
        rb -= 1
    return SegmentPlan(rows=rows, minor=minor, row_block=rb)


def instr_segments(ins: TMInstr, out_shape: tuple[int, ...],
                   itemsize: int = 4,
                   segment_bytes: int | None = None,
                   batch_shape: tuple[int, ...] = ()) -> int:
    """Number of block iterations one instruction executes.

    COARSE instructions consult the tm_affine kernel's own decode
    (:func:`map_segments`: block-mode grids, else the row plan); multi-band
    Route sums per-band launches; FINE (RME) instructions run one compaction
    grid step per record stream (their ``meta['batch_dims']`` or
    ``batch_shape``); everything else segments row-wise.

    ``batch_shape`` models an *executor-level* batch lift (the
    ``TMExecutor(..., batch_dims=k)`` call path): coarse maps are lifted
    exactly like the kernel lifts them.  The schedule pass itself models the
    program at its own rank (compiled programs carry batch axes inside their
    maps), so it passes ``batch_shape=()``."""
    sb = segment_bytes if segment_bytes is not None else CycleParams().segment_bytes
    if ins.opcode == TMOpcode.COARSE and ins.maps is not None:
        # multi-band Route: one kernel launch per band, each covering the
        # full output (bands sum over disjoint supports) — segments add up
        return sum(map_segments(m, itemsize, sb, batch_shape)
                   for m in ins.maps)
    if ins.opcode == TMOpcode.COARSE and ins.map_ is not None:
        return map_segments(ins.map_, itemsize, sb, batch_shape)
    if ins.opcode in (TMOpcode.FINE_ASSEMBLE, TMOpcode.FINE_EVALUATE):
        # one compaction pass per record stream, batched or not
        bd = (ins.meta or {}).get("batch_dims", 0)
        return max(1, math.prod(batch_shape) * math.prod(out_shape[:bd]))
    return plan_segments(batch_shape + tuple(out_shape), itemsize, sb).n_segments


def ping_pong_shape(shape: tuple[int, ...], itemsize: int = 4,
                    segment_bytes: int | None = None) -> tuple[int, int, int]:
    """The two-segment ping-pong slot for a streamed buffer: ``(2,
    row_block, minor)`` of the buffer's segment plan — what the compiler's
    scratch allocator (:func:`repro_torch.compiler.allocate.allocate`)
    charges each streamed slot, as the JAX package charges it."""
    seg = plan_segments(shape, itemsize, segment_bytes)
    return (2, seg.row_block, seg.minor)


def map_segments(m, itemsize: int = 4, segment_bytes: int | None = None,
                 batch_shape: tuple[int, ...] = ()) -> int:
    """Grid size the tm_affine kernel launches for one map — THE shared
    count: the kernel rules report it (``Lowering.segments``) and the cycle
    model charges per-segment stage cycles from it.

    A custom ``segment_bytes`` here models exactly the grid the kernels
    launch when the same budget is plumbed through the executor
    (``TMExecutor(params=CycleParams(segment_bytes=...))``)."""
    sb = segment_bytes if segment_bytes is not None else CycleParams().segment_bytes
    return _map_segments_cached(m, itemsize, sb, tuple(batch_shape))


@functools.lru_cache(maxsize=1024)
def _map_segments_cached(m, itemsize: int, segment_bytes: int,
                         batch_shape: tuple[int, ...]) -> int:
    if batch_shape:
        m = batch_extend_map(m, batch_shape)
    # local import: the kernel module imports this one for plan_segments
    from repro_torch.kernels.tm_affine.tm_affine import analyze_block_mode
    plan = analyze_block_mode(m, segment_bytes=segment_bytes)
    if plan is not None:
        return math.prod(plan.grid)
    return plan_segments(m.out_shape, itemsize, segment_bytes).n_segments


# ---------------------------------------------------------------------------
# the cycle model
# ---------------------------------------------------------------------------

def _timing(i: int, ins: TMInstr, shapes: dict, p: CycleParams) -> InstrTiming:
    in_elems = sum(math.prod(shapes[s]) for s in ins.srcs)
    out_elems = math.prod(shapes[ins.dst])
    out_bytes = out_elems * p.itemsize
    n_seg = instr_segments(ins, shapes[ins.dst], p.itemsize, p.segment_bytes)
    # the datapath touches every input and output element once; stage cycles
    # are charged only when the instruction drives that stage (paper Fig. 3)
    active = ins.active_stages()
    load = (in_elems * p.itemsize / p.bandwidth_bytes) / n_seg
    store = (out_bytes / p.bandwidth_bytes) / n_seg
    work = max(in_elems, out_elems)
    compute = 0.0
    if "coarse" in active or "fine" in active:
        compute += (work / p.lanes) / n_seg
    if "elementwise" in active:
        compute += (out_elems / p.lanes) / n_seg
    return InstrTiming(index=i, dst=ins.dst, opcode=ins.opcode.value,
                       n_segments=n_seg, load=load, compute=compute,
                       store=store,
                       launches=len(ins.maps) if ins.maps is not None else 1)


def chain_timing(instrs: list[TMInstr], shapes: dict,
                 p: CycleParams) -> InstrTiming:
    """One forwarding chain executed as a single segment-streaming kernel.

    The kernel's grid iterates the FINAL output's segment plan; per segment
    it loads from the chain's external inputs (the chain source slab plus
    epilogue/band operands — intermediates never touch the port), runs every
    link's datapath work, and stores one output segment."""
    last = instrs[-1]
    out_shape = shapes[last.dst]
    n_seg = plan_segments(out_shape, p.itemsize, p.segment_bytes).n_segments
    internal = {ins.dst for ins in instrs[:-1]}
    in_elems = sum(math.prod(shapes[s]) for ins in instrs
                   for s in ins.srcs if s not in internal)
    out_elems = math.prod(out_shape)
    load = (in_elems * p.itemsize / p.bandwidth_bytes) / n_seg
    store = (out_elems * p.itemsize / p.bandwidth_bytes) / n_seg
    compute = 0.0
    for ins in instrs:
        active = ins.active_stages()
        work = max(sum(math.prod(shapes[s]) for s in ins.srcs),
                   math.prod(shapes[ins.dst]))
        if "coarse" in active or "fine" in active:
            compute += work / p.lanes
        if "elementwise" in active:
            compute += math.prod(shapes[ins.dst]) / p.lanes
    return InstrTiming(index=-1, dst=last.dst, opcode="chain",
                       n_segments=n_seg, load=load, compute=compute / n_seg,
                       store=store, launches=1)


def xengine_phase_report(prog: TMProgram,
                         input_shapes: dict[str, tuple[int, ...]],
                         params: CycleParams | None = None, *,
                         crossing_shape: tuple[int, ...] = (),
                         direction: str = "") -> dict:
    """Price one cross-engine fused phase: its TM run as the adjacent
    compute kernel's commit/prologue stage vs the split path.

    Split: every TM instruction pays issue + its double-buffered cycles,
    plus the crossing buffer's full HBM round-trip (the compute kernel
    stores it, the TM side loads it — or the reverse).  Fused: the chain
    rides the compute kernel's launch (no TM issue at all) and the crossing
    never reaches device memory, so its load (compute→TM) or store
    (TM→compute) leg leaves the chain's memory bill too."""
    p = params or CycleParams()
    shapes = infer_shapes(prog, input_shapes)
    timings = [_timing(i, ins, shapes, p)
               for i, ins in enumerate(prog.instrs)]
    ct = chain_timing(list(prog.instrs), shapes, p)
    crossing_bytes = (math.prod(crossing_shape) * p.itemsize
                      if crossing_shape else 0)
    roundtrip = 2.0 * crossing_bytes / p.bandwidth_bytes
    split = (sum(p.issue_overhead + t.pipelined_cycles for t in timings)
             + roundtrip)
    fused = max(0.0, ct.pipelined_cycles
                - crossing_bytes / p.bandwidth_bytes)
    return {
        "direction": direction,
        "instrs": len(prog.instrs),
        "segments": ct.n_segments,
        "crossing_bytes": crossing_bytes,
        "saved_bytes": crossing_bytes * 2,
        "split_cycles": split,
        "fused_cycles": fused,
        "saved_cycles": split - fused,
        "launches_removed": sum(t.launches for t in timings),
    }


def schedule(prog: TMProgram, input_shapes: dict[str, tuple[int, ...]],
             params: CycleParams | None = None) -> ScheduleReport:
    """Build the three-way cycle comparison for one program."""
    p = params or CycleParams()
    shapes = infer_shapes(prog, input_shapes)
    timings = [_timing(i, ins, shapes, p) for i, ins in enumerate(prog.instrs)]
    forwards = forwarding_edges(prog)
    fwd_of: dict[tuple[int, int], ForwardEdge] = {
        (e.producer, e.consumer): e for e in forwards}

    unpipelined = sum(p.issue_overhead + t.serial_cycles for t in timings)
    pipelined = sum(p.issue_overhead + t.pipelined_cycles for t in timings)

    # forwarding simulation: instruction i becomes ready when each source is
    # available — fully stored by its producer, or (on a forwarded edge) as
    # soon as the producer commits its first segment.  A forwarded consumer
    # still cannot *finish* before the producer's last segment has arrived
    # and flowed through one of its own segment passes.  Issue is in-order
    # on the single TM engine: only a forwarded successor may overlap its
    # predecessor — independent instructions never get free parallelism the
    # double-buffered baseline is denied.
    cur_producer: dict[str, int] = {}  # most recent write *before* instr i
    start: dict[int, float] = {}
    finish: dict[int, float] = {}
    makespan = 0.0
    for i, (ins, t) in enumerate(zip(prog.instrs, timings)):
        ready = 0.0
        tail_bound = 0.0
        for s in ins.srcs:
            pi = cur_producer.get(s)
            if pi is None:
                continue  # external input
            if (pi, i) in fwd_of:
                ready = max(ready, start[pi] + timings[pi].first_commit_cycles)
                tail_bound = max(tail_bound, finish[pi] + t.segment_cycles)
            else:
                ready = max(ready, finish[pi])
        if i > 0:  # in-order issue on one engine
            if (i - 1, i) in fwd_of:
                ready = max(ready,
                            start[i - 1] + timings[i - 1].first_commit_cycles)
            else:
                ready = max(ready, finish[i - 1])
        start[i] = ready + p.issue_overhead
        finish[i] = max(start[i] + t.pipelined_cycles, tail_bound)
        makespan = max(makespan, finish[i])
        cur_producer[ins.dst] = i

    # chain-fused execution: each forwardable chain collapses to ONE launch
    # (one issue charge, intermediates streamed through on-chip scratch); units
    # run serially — that is what the chained kernel backend realizes —
    # reported per chain as modeled (forwarding overlap) vs realized
    # (single-kernel) cycles
    chains = forwarding_chains(prog)
    covered = {i for c in chains for i in c.instrs}
    chained = sum(p.issue_overhead + t.pipelined_cycles
                  for i, t in enumerate(timings) if i not in covered)
    chain_reports: list[dict] = []
    for c in chains:
        ct = chain_timing([prog.instrs[i] for i in c.instrs], shapes, p)
        realized = p.issue_overhead + ct.pipelined_cycles
        chained += realized
        chain_reports.append({
            "instrs": list(c.instrs), "buffers": list(c.buffers),
            "unfused_pipelined": sum(p.issue_overhead
                                     + timings[i].pipelined_cycles
                                     for i in c.instrs),
            "modeled_forwarded": finish[c.instrs[-1]] - start[c.instrs[0]]
            + p.issue_overhead,
            "realized_chained": realized,
            "segments_unfused": sum(timings[i].n_segments for i in c.instrs),
            "segments_chained": ct.n_segments,
            "launches_unfused": sum(timings[i].launches for i in c.instrs),
            "launches_chained": 1,
        })

    return ScheduleReport(timings=timings, forwards=forwards,
                          unpipelined_cycles=unpipelined,
                          pipelined_cycles=pipelined,
                          forwarded_cycles=makespan, params=p,
                          chains=chains, chained_cycles=chained,
                          chain_reports=chain_reports)
