"""``tm_compile`` — trace a PyTorch function into an optimized, scheduled
program.

    compiled = tm_compile(fn, *example_args)
    y = compiled(*args)                      # bit-exact vs fn(*args)
    y = compiled(*args, backend="cuda")      # TM phases on the CUDA kernels
    print(compiled.report())                 # trace/pass/partition/scratch

The front end is ``torch.fx.experimental.proxy_tensor.make_fx`` at the
example arguments (the counterpart of ``jax.make_jaxpr``), run with the
TM operators tagged.  The compiled object executes the partitioned phase
DAG in program order: compute phases call their aten ops eagerly, TM phases
run through the :class:`~repro_torch.core.executor.TMExecutor` on any of
its three backends, and fused phases (``cross_engine=True``) lower a
compute op and its adjacent TM chain as ONE kernel launch.

The program runs on the device of the tensors it was traced with: CUDA
example arguments mean the card, CPU ones the caller asking for the CPU.
Every executor it builds gets that device; nothing moves between devices.

``run(..., runtime=)`` / :meth:`CompiledTMProgram.run_async` dispatch the
phase DAG onto the two engine streams of a
:class:`~repro_torch.runtime.streams.StreamRuntime` (two CUDA streams on
the card); ``tracer=`` records ``compile/*`` and ``phase/*`` spans
(:mod:`repro_torch.obs`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from repro_torch.core.dispatch import Lowering, LoweringReport, lower_xengine
from repro_torch.core.executor import BACKENDS, TMExecutor
from repro_torch.core.instr import TMProgram
from repro_torch.core.schedule import CycleParams
from repro_torch.core.tm_primitive import tag_tm_ops
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.compiler.allocate import ScratchPlan, allocate
from repro_torch.compiler.ir import (TMGraph, eval_tpu_node,
                                     eval_tpu_node_exact, itemsize)
from repro_torch.compiler.partition import (
    _KIND_CHARS, PartitionReport, Phase, partition)
from repro_torch.compiler.passes import PassReport, run_pipeline
from repro_torch.compiler.trace import graph_from_fx

# make_fx keeps its tracer in module state, so two threads may not trace at
# once (the serving layer compiles on its admission threads)
_TRACE_LOCK = threading.Lock()

# repro_torch.ft.FaultInjector.install() points this at its fire() method;
# None in production — run_phase pays one attribute load per phase
fault_hook = None


@dataclasses.dataclass
class TPUPhaseReport:
    """Accounting for one compute phase execution: its aten calls, each
    run eagerly (one or more kernel launches each, the library's)."""

    phase_index: int
    n_ops: int


@dataclasses.dataclass
class CompiledTMProgram:
    """A traced, optimized, partitioned and scheduled program.

    ``params`` pins the cycle params the program was scheduled with; the TM
    phases execute with the same params (their segment budget).  ``device``
    is where the program runs: the device of the traced arguments."""

    graph: TMGraph
    pass_report: PassReport
    partition_report: PartitionReport
    scratch_plan: ScratchPlan
    in_tree: Any
    out_tree: Any
    device: torch.device
    params: CycleParams | None = None
    last_lowering: list[LoweringReport] = dataclasses.field(
        default_factory=list)

    # --- introspection ----------------------------------------------------
    @property
    def tm_programs(self) -> list[TMProgram]:
        return [p.program for p in self.partition_report.tmu_phases]

    @property
    def matched_prims(self) -> set[str]:
        return set(self.graph.matched_prims)

    @property
    def phase_kinds(self) -> str:
        """The phase-kind string, e.g. ``"tf"`` (t: compute, m: TM, f:
        fused)."""
        return "".join(_KIND_CHARS.get(p.kind, "?")
                       for p in self.partition_report.phases).lower()

    def report(self) -> str:
        return "\n".join([
            self.graph.summary(),
            self.pass_report.summary(),
            self.partition_report.summary(),
            self.scratch_plan.summary(),
        ])

    # --- execution --------------------------------------------------------

    def bind_inputs(self, *args) -> dict[str, Any]:
        """Validate ``args`` against the compiled signature; return the
        initial buffer environment (consts + bound inputs)."""
        flat, tree = pytree.tree_flatten(args)
        if tree != self.in_tree:
            raise TypeError(f"argument structure {tree} does not match the "
                            f"compiled structure {self.in_tree}")
        if len(flat) != len(self.graph.inputs):
            raise TypeError(f"expected {len(self.graph.inputs)} input "
                            f"tensor(s), got {len(flat)}")
        env: dict[str, Any] = dict(self.graph.consts)
        for name, val in zip(self.graph.inputs, flat):
            want = self.graph.buffers[name]
            if (not isinstance(val, torch.Tensor)
                    or tuple(val.shape) != want.shape
                    or val.dtype != want.dtype):
                got = (f"{val.dtype}{tuple(val.shape)}"
                       if isinstance(val, torch.Tensor) else type(val))
                raise TypeError(
                    f"input {name!r}: {got} does not match compiled "
                    f"{want.dtype}{want.shape}; recompile with tm_compile "
                    f"for new shapes/dtypes")
            if val.device != self.device:
                raise TypeError(f"input {name!r} is on {val.device}; the "
                                f"program was compiled for {self.device}")
            env[name] = val
        return env

    def _phase_hbm_bytes(self, phase: Phase) -> int:
        """Data-movement estimate of one phase execution: every external
        read plus every downstream-visible write through device memory
        once."""
        total = 0
        for name in tuple(phase.reads) + tuple(phase.writes):
            buf = self.graph.buffers[name]
            n = itemsize(buf.dtype)
            for d in buf.shape:
                n *= int(d)
            total += n
        return total

    def _executor(self, backend: str, fuse_chains: bool,
                  quarantine: set | None, tracer=None) -> TMExecutor:
        return TMExecutor(backend=backend, device=self.device,
                          params=self.params, fuse_chains=fuse_chains,
                          tracer=tracer, quarantine=quarantine)

    def run_phase(self, phase: Phase, env: dict[str, Any], *,
                  backend: str = "fused", fuse_chains: bool = False,
                  exact: bool = False, tracer=None,
                  quarantine: set | None = None,
                  ) -> LoweringReport | TPUPhaseReport:
        """Execute one partition phase against ``env`` (mutated in place).

        A compute phase calls its aten ops eagerly and returns a
        :class:`TPUPhaseReport`; a TM phase runs through the executor and
        returns its :class:`~repro_torch.core.dispatch.LoweringReport`;
        a fused phase lowers as one kernel where it can
        (:meth:`_exec_fused`).  ``fuse_chains`` (cuda backend) executes
        each forwarding chain of a TM phase as ONE kernel.  ``quarantine``
        arms the degradation ladder, on the CPU only.

        ``exact`` asks for bit-exact parity with the eager program: compute
        nodes run one aten call each with their literals as traced
        (:func:`~repro_torch.compiler.ir.eval_tpu_node_exact`, which is how
        they always run in the port), and a fused cross-engine phase takes
        its split path, so its compute op runs the same library call eager
        code makes.  TM phases are data movement and bit-exact in every
        mode.

        ``tracer`` (a :class:`repro_torch.obs.Tracer`) wraps the execution
        in a ``phase/{index}/{kind}`` span; at ``Tracer(detail="instr")``
        the span also carries the phase's launch/segment accounting and the
        ``tmu/launches``, ``tmu/segments``, ``tpu/ops`` and ``hbm/bytes``
        counters accumulate; the default no-op tracer costs one attribute
        check."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        hook = fault_hook
        if hook is not None:
            hook("phase", f"phase/{phase.index}/{phase.kind}")
        tracer = NULL_TRACER if tracer is None else tracer
        if not tracer.enabled:
            return self._exec_phase(phase, env, backend=backend,
                                    fuse_chains=fuse_chains, exact=exact,
                                    quarantine=quarantine)
        with tracer.span(f"phase/{phase.index}/{phase.kind}",
                         backend=backend) as sp:
            rep = self._exec_phase(phase, env, backend=backend,
                                   fuse_chains=fuse_chains, exact=exact,
                                   tracer=tracer, quarantine=quarantine)
            if tracer.detail == "instr":
                if isinstance(rep, TPUPhaseReport):
                    sp.set(n_ops=rep.n_ops)
                    tracer.count("tpu/ops", rep.n_ops)
                else:
                    launches = rep.launch_count()
                    segments = sum(r.segments or 0 for r in rep.records)
                    sp.set(instrs=rep.instr_count(), launches=launches,
                           segments=segments, chains=rep.chain_count())
                    tracer.count("tmu/launches", launches)
                    tracer.count("tmu/segments", segments)
                tracer.count("hbm/bytes", self._phase_hbm_bytes(phase))
        return rep

    def _exec_phase(self, phase: Phase, env: dict[str, Any], *,
                    backend: str, fuse_chains: bool, exact: bool = False,
                    tracer=None, quarantine: set | None = None,
                    ) -> LoweringReport | TPUPhaseReport:
        if phase.kind == "fused":
            return self._exec_fused(phase, env, backend=backend,
                                    fuse_chains=fuse_chains, exact=exact,
                                    tracer=tracer, quarantine=quarantine)
        if phase.kind == "tpu":
            run_node = eval_tpu_node_exact if exact else eval_tpu_node
            for i in phase.node_indices:
                run_node(self.graph.nodes[i], env)
            return TPUPhaseReport(phase_index=phase.index,
                                  n_ops=len(phase.node_indices))
        ex = self._executor(backend, fuse_chains, quarantine, tracer)
        bufs = {n: env[n] for n in phase.program.inputs}
        out, lowering, _ = ex.run(phase.program, bufs)
        env.update(out)
        return lowering

    def _exec_fused(self, phase: Phase, env: dict[str, Any], *,
                    backend: str, fuse_chains: bool, exact: bool = False,
                    tracer=None, quarantine: set | None = None,
                    ) -> LoweringReport:
        """Execute a cross-engine fused phase: the compute op + its TM run
        as ONE kernel launch (cuda backend), the crossing buffer never
        written to device memory.  Any decline — unsupported geometry, the
        budget kept from the JAX package, a quarantined kernel, the
        reference/fused backends, exact mode — takes the split path (op and
        TM run separately), whose op record says why in ``reason``."""
        xe = phase.xengine
        node = self.graph.nodes[xe.eqn_index]
        instrs = [self.graph.nodes[i].instr for i in xe.tm_indices]
        direction = xe.direction
        report = LoweringReport(backend=backend)
        reason = "cross-engine lowering declined: split path"
        if exact:
            reason += " (exact mode)"
        elif backend == "cuda":
            streamed = set(xe.chain.buffers) | {xe.buffer}
            tm_srcs = [[None if s in streamed else env[s] for s in ins.srcs]
                       for ins in instrs]
            eqn_srcs = [None if s == xe.buffer else env[s]
                        for s in node.src_names]
            sb = self.params.segment_bytes if self.params is not None \
                else None
            why: list[str] = []
            lowered = lower_xengine(direction, node, eqn_srcs, instrs,
                                    tm_srcs, segment_bytes=sb,
                                    quarantine=quarantine, reasons=why)
            if lowered is not None:
                val, rec = lowered
                env[rec.dst] = val
                report.records.append(rec)
                return report
            if why:
                reason += " (" + "; ".join(why) + ")"
        else:
            reason += f" ({backend} backend)"

        # split path: the op and the TM run in dataflow order — exactly
        # what the non-crossing partition executes
        def run_eqn():
            (eval_tpu_node_exact if exact else eval_tpu_node)(node, env)
            report.records.append(Lowering(
                dst=node.dst_names[0], opcode="tpu",
                path=f"torch.{node.primitive_name}", reason=reason))

        def run_tm():
            ex = self._executor(backend, fuse_chains, quarantine, tracer)
            bufs = {n: env[n] for n in phase.program.inputs}
            out, lowering, _ = ex.run(phase.program, bufs)
            env.update(out)
            report.records.extend(lowering.records)

        if direction == "compute_to_tm":
            run_eqn()
            run_tm()
        else:
            run_tm()
            run_eqn()
        return report

    def outputs_from(self, env: dict[str, Any]):
        outs = [env[o] for o in self.graph.outputs]
        return pytree.tree_unflatten(outs, self.out_tree)

    def run_async(self, env: dict[str, Any], *, runtime,
                  backend: str = "fused", fuse_chains: bool = False,
                  exact: bool = False, label: str = "", tracer=None,
                  quarantine: set | None = None):
        """Submit every phase of the DAG onto ``runtime``'s engine streams.

        Each phase becomes one stream task whose event dependencies are its
        DAG in-edges (``phase.deps``) — independent phases overlap across
        the TMU/TPU streams, and nothing blocks the calling thread.  Tasks
        communicate through the shared ``env``: a producer binds its writes
        before its event completes, so a consumer's reads are
        happens-before-ordered by the event wait (buffer names are SSA —
        no two phases write the same key).  On the card each task also
        marks the buffers it read as used on its engine's CUDA stream
        (``Tensor.record_stream``), so the caching allocator never hands a
        buffer made on one stream to new work while the other still reads
        it.  A fused phase on the cuda backend is submitted ``exclusive``:
        its cross-engine kernel is a cooperative launch, busy time that the
        overlap accounting never counts as overlapped.

        Returns the phase events in phase order; each completed event's
        ``result`` is ``(written tensors, LoweringReport | TPUPhaseReport)``.
        Wait the sink events (or all of them) to synchronize."""
        on_card = self.device.type == "cuda"
        events = []
        for phase in self.partition_report.phases:
            def task(ph=phase):
                rep = self.run_phase(ph, env, backend=backend,
                                     fuse_chains=fuse_chains, exact=exact,
                                     tracer=tracer, quarantine=quarantine)
                if on_card:
                    _record_reads(ph.reads, env, self.device)
                return [env[n] for n in ph.writes], rep
            events.append(runtime.submit(
                phase.engine, task, deps=[events[d] for d in phase.deps],
                label=f"{label}phase{phase.index}:{phase.kind}",
                exclusive=(on_card and backend == "cuda" and not exact
                           and phase.kind == "fused")))
        return events

    def run(self, *args, backend: str = "fused", fuse_chains: bool = False,
            exact: bool = False, runtime=None, tracer=None,
            quarantine: set | None = None,
            ) -> tuple[Any, list[LoweringReport]]:
        """Execute and return ``(outputs, per-TM-phase lowering reports)``.

        With ``runtime`` (a :class:`~repro_torch.runtime.streams.StreamRuntime`)
        the phase DAG dispatches stream-ordered and this call synchronizes
        only at the sinks; without it the phases run in program order on
        this thread.  Mutates no state on ``self``; :meth:`__call__` wraps
        this and keeps ``last_lowering`` for the last call."""
        env = self.bind_inputs(*args)
        reports: list[LoweringReport | TPUPhaseReport] = []
        if runtime is not None:
            events = self.run_async(env, runtime=runtime, backend=backend,
                                    fuse_chains=fuse_chains, exact=exact,
                                    tracer=tracer, quarantine=quarantine)
            for ev in events:   # sink sync: deps complete transitively
                reports.append(ev.wait()[1])
            if self.device.type == "cuda":
                # the outputs were made on the engine streams; this thread
                # reads them on its own
                _record_reads(self.graph.outputs, env, self.device)
        else:
            for phase in self.partition_report.phases:
                reports.append(self.run_phase(phase, env, backend=backend,
                                              fuse_chains=fuse_chains,
                                              exact=exact, tracer=tracer,
                                              quarantine=quarantine))
        lowerings = [r for r in reports if isinstance(r, LoweringReport)]
        return self.outputs_from(env), lowerings

    def __call__(self, *args, backend: str = "fused",
                 fuse_chains: bool = False, exact: bool = False,
                 runtime=None, tracer=None):
        out, lowerings = self.run(*args, backend=backend,
                                  fuse_chains=fuse_chains, exact=exact,
                                  runtime=runtime, tracer=tracer)
        self.last_lowering = lowerings
        return out


def _record_reads(names, env: dict[str, Any], device: torch.device) -> None:
    """Mark ``env``'s CUDA tensors under ``names`` as used on the current
    stream (``Tensor.record_stream``)."""
    stream = torch.cuda.current_stream(device)
    for n in names:
        t = env.get(n)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)


def tm_compile(fn, *example_args, params: CycleParams | None = None,
               cross_engine: bool = False, tracer=None) -> CompiledTMProgram:
    """Trace ``fn`` at ``example_args`` and lower it through the pipeline:

    make_fx graph -> TM IR (trace) -> passes (map composition, copy
    elimination, epilogue sink, RME legalization) -> compute/TM phase DAG
    + pipeline schedule -> scratch allocation.

    ``cross_engine`` lets the partition merge legal engine-boundary
    crossings (a supported compute op forwarding into — or fed by — an
    adjacent COARSE TM run) into single ``fused`` phases that lower as ONE
    kernel launch; off by default, so the phase DAG of non-crossing
    programs is byte-identical with the flag in either state.

    The example arguments are tensors (in any pytree); the program runs on
    their device (one device for all of them).

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) records each stage as a
    nested span under ``compile`` with the stage's report summary
    attached."""
    tracer = NULL_TRACER if tracer is None else tracer
    flat_in, in_tree = pytree.tree_flatten(example_args)
    if not all(isinstance(a, torch.Tensor) for a in flat_in):
        raise TypeError("tm_compile: every example argument must be a "
                        "tensor")
    devices = {a.device for a in flat_in}
    if len(devices) != 1:
        raise ValueError(f"tm_compile: example arguments on {devices}; the "
                         f"program runs on one device")
    (device,) = devices
    holder: dict = {}

    def flat_fn(*flat):
        out = fn(*pytree.tree_unflatten(list(flat), in_tree))
        leaves, holder["out_tree"] = pytree.tree_flatten(out)
        return leaves

    with tracer.span("compile") as root:
        with tracer.span("compile/trace") as sp:
            with _TRACE_LOCK, tag_tm_ops(), torch.inference_mode(False), \
                    torch.no_grad():
                gm = make_fx(flat_fn)(*flat_in)
            graph = graph_from_fx(gm)
            sp.set(summary=graph.summary())
        with tracer.span("compile/passes") as sp:
            pass_report = run_pipeline(graph)
            sp.set(summary=pass_report.summary())
        with tracer.span("compile/partition") as sp:
            part = partition(graph, params, cross_engine=cross_engine)
            sp.set(summary=part.summary(), phases=len(part.phases),
                   dag_edges=part.dag_edges)
        with tracer.span("compile/allocate") as sp:
            scratch = allocate(graph, part, params)
            sp.set(summary=scratch.summary())
        root.set(phases="".join(_KIND_CHARS.get(p.kind, "?")
                                for p in part.phases))
    return CompiledTMProgram(graph=graph, pass_report=pass_report,
                             partition_report=part, scratch_plan=scratch,
                             in_tree=in_tree, out_tree=holder["out_tree"],
                             device=device, params=params)
