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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from repro_torch.core.dispatch import Lowering, LoweringReport, lower_xengine
from repro_torch.core.executor import BACKENDS, TMExecutor
from repro_torch.core.instr import TMProgram
from repro_torch.core.schedule import CycleParams
from repro_torch.core.tm_primitive import tag_tm_ops
from repro_torch.compiler.allocate import ScratchPlan, allocate
from repro_torch.compiler.ir import TMGraph, eval_tpu_node, itemsize
from repro_torch.compiler.partition import (
    _KIND_CHARS, PartitionReport, Phase, partition)
from repro_torch.compiler.passes import PassReport, run_pipeline
from repro_torch.compiler.trace import graph_from_fx


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
                  quarantine: set | None) -> TMExecutor:
        return TMExecutor(backend=backend, device=self.device,
                          params=self.params, fuse_chains=fuse_chains,
                          quarantine=quarantine)

    def run_phase(self, phase: Phase, env: dict[str, Any], *,
                  backend: str = "fused", fuse_chains: bool = False,
                  quarantine: set | None = None,
                  ) -> LoweringReport | TPUPhaseReport:
        """Execute one partition phase against ``env`` (mutated in place).

        A compute phase calls its aten ops eagerly and returns a
        :class:`TPUPhaseReport`; a TM phase runs through the executor and
        returns its :class:`~repro_torch.core.dispatch.LoweringReport`;
        a fused phase lowers as one kernel where it can
        (:meth:`_exec_fused`).  ``fuse_chains`` (cuda backend) executes
        each forwarding chain of a TM phase as ONE kernel.  ``quarantine``
        arms the degradation ladder, on the CPU only."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if phase.kind == "fused":
            return self._exec_fused(phase, env, backend=backend,
                                    fuse_chains=fuse_chains,
                                    quarantine=quarantine)
        if phase.kind == "tpu":
            for i in phase.node_indices:
                eval_tpu_node(self.graph.nodes[i], env)
            return TPUPhaseReport(phase_index=phase.index,
                                  n_ops=len(phase.node_indices))
        ex = self._executor(backend, fuse_chains, quarantine)
        bufs = {n: env[n] for n in phase.program.inputs}
        out, lowering, _ = ex.run(phase.program, bufs)
        env.update(out)
        return lowering

    def _exec_fused(self, phase: Phase, env: dict[str, Any], *,
                    backend: str, fuse_chains: bool,
                    quarantine: set | None = None) -> LoweringReport:
        """Execute a cross-engine fused phase: the compute op + its TM run
        as ONE kernel launch (cuda backend), the crossing buffer never
        written to device memory.  Any decline — unsupported geometry, the
        budget kept from the JAX package, a quarantined kernel, the
        reference/fused backends — takes the split path (op and TM run
        separately), whose op record says why in ``reason``."""
        xe = phase.xengine
        node = self.graph.nodes[xe.eqn_index]
        instrs = [self.graph.nodes[i].instr for i in xe.tm_indices]
        direction = xe.direction
        report = LoweringReport(backend=backend)
        reason = "cross-engine lowering declined: split path"
        if backend == "cuda":
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
            eval_tpu_node(node, env)
            report.records.append(Lowering(
                dst=node.dst_names[0], opcode="tpu",
                path=f"torch.{node.primitive_name}", reason=reason))

        def run_tm():
            ex = self._executor(backend, fuse_chains, quarantine)
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

    def run(self, *args, backend: str = "fused", fuse_chains: bool = False,
            quarantine: set | None = None,
            ) -> tuple[Any, list[LoweringReport]]:
        """Execute and return ``(outputs, per-TM-phase lowering reports)``:
        the phases in program order on this thread.  Mutates no state on
        ``self``; :meth:`__call__` wraps this and keeps ``last_lowering``
        for the last call."""
        env = self.bind_inputs(*args)
        reports = [self.run_phase(phase, env, backend=backend,
                                  fuse_chains=fuse_chains,
                                  quarantine=quarantine)
                   for phase in self.partition_report.phases]
        lowerings = [r for r in reports if isinstance(r, LoweringReport)]
        return self.outputs_from(env), lowerings

    def __call__(self, *args, backend: str = "fused",
                 fuse_chains: bool = False):
        out, lowerings = self.run(*args, backend=backend,
                                  fuse_chains=fuse_chains)
        self.last_lowering = lowerings
        return out


def tm_compile(fn, *example_args, params: CycleParams | None = None,
               cross_engine: bool = False) -> CompiledTMProgram:
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
    their device (one device for all of them)."""
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

    with tag_tm_ops(), torch.inference_mode(False), torch.no_grad():
        gm = make_fx(flat_fn)(*flat_in)
    graph = graph_from_fx(gm)
    pass_report = run_pipeline(graph)
    part = partition(graph, params, cross_engine=cross_engine)
    scratch = allocate(graph, part, params)
    return CompiledTMProgram(graph=graph, pass_report=pass_report,
                             partition_report=part, scratch_plan=scratch,
                             in_tree=in_tree, out_tree=holder["out_tree"],
                             device=device, params=params)
