"""8-stage TM execution model (paper Fig. 3), as an interpreter.

The :class:`TMExecutor` runs a :class:`~repro_torch.core.instr.TMProgram`
over a buffer file, mirroring the TMU FSM:

  Fetch/Decode  -> iterate the instruction list, dispatch on opcode
  Tensor Load   -> resolve ``srcs`` from the buffer dict (HBM analogue)
  Fine TM       -> RME assemble / evaluate
  Element-wise  -> vector add/sub/mul/max
  Coarse TM     -> the unified address engine (apply_map)
  Tensor Store  -> bind ``dst`` in the buffer dict
  Branch        -> implicit: multi-map ops (Route) loop over bands.

Backends:
  * ``reference`` — execute instructions one by one on the engine (every
    intermediate hits HBM: the paper's unfused baseline).
  * ``fused``     — run the fusion pass first (near-memory execution: elided
    intermediates never materialize), then execute.
  * ``cuda``      — lower each instruction through the kernel-dispatch
    registry (:mod:`repro_torch.core.dispatch`) onto the hand-written CUDA
    kernels; an instruction no rule claims runs on the reference engine.
    With ``fuse_chains=True`` each forwarding chain runs as ONE kernel
    where a chain rule claims it.  ``last_lowering`` records which path
    each instruction (or chain) took.

The executor runs on ``device`` — the card unless the caller asks for the
CPU.  Input buffers are moved there; on the CPU the kernel rules run their
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import rme
from repro_torch.core.dispatch import (Lowering, LoweringReport, lower_chain,
                                       lower_instr)
from repro_torch.core.engine import EW_FNS, apply_map, route_gather
from repro_torch.core.fusion import (ForwardChain, FusionReport,
                                     forwarding_chains, fuse)
from repro_torch.core.instr import EwOp, TMInstr, TMOpcode, TMProgram
from repro_torch.core.schedule import CycleParams

_EW: dict[EwOp, Callable] = {op: EW_FNS[op.value] for op in EwOp}

BACKENDS = ("reference", "fused", "cuda")


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Asking for the card on a machine without
    one raises: nothing carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TMExecutor: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    return dev


@dataclasses.dataclass
class TMExecutor:
    backend: str = "fused"  # "reference" | "fused" | "cuda"
    device: torch.device | str | None = None  # None = "cuda"
    # custom cycle params change the ping-pong budget the kernel rules report
    # their segments from; None keeps the shared default
    params: CycleParams | None = None
    # cuda only: execute each forwarding chain (fusion.forwarding_chains)
    # as ONE kernel where a chain rule claims it (the chain megakernel, or
    # the chained RME evaluate); a chain no rule claims lowers per
    # instruction
    fuse_chains: bool = False
    # duck-typed repro_torch.obs Tracer: per-instruction / per-chain spans
    # on the calling thread's track, recorded only at Tracer(detail="instr")
    # (None or the no-op tracer = tracing off; the hot path pays one
    # attribute check per instruction)
    tracer: object = None
    # cuda backend on the CPU only: the degradation-ladder quarantine (a
    # mutable set).  When set, a rule whose plain version raises is
    # quarantined and the instruction falls through to the next rule / the
    # reference engine instead of failing the run — see
    # dispatch.lower_instr.  None keeps fail-fast; on the card it must be
    # None, so a kernel that fails always fails the run.
    quarantine: set | None = None
    last_report: FusionReport | None = None
    last_lowering: LoweringReport | None = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}")
        if (self.quarantine is not None and torch.device(
                "cuda" if self.device is None else self.device).type == "cuda"):
            raise ValueError("TMExecutor: quarantine runs only on the CPU; on "
                             "the card a failing kernel fails the run")
        self.device = resolve_device(self.device)

    def __call__(self, prog: TMProgram, buffers: dict[str, torch.Tensor],
                 *, batch_dims: int = 0) -> dict[str, torch.Tensor]:
        out, lowering, fusion = self.run(prog, buffers, batch_dims=batch_dims)
        # convenience aliases for the *last* call — racy by construction
        # under concurrent callers; threaded code must use run() instead
        if fusion is not None:
            self.last_report = fusion
        self.last_lowering = lowering
        return out

    def run(self, prog: TMProgram, buffers: dict[str, torch.Tensor],
            *, batch_dims: int = 0,
            ) -> tuple[dict[str, torch.Tensor], LoweringReport,
                       FusionReport | None]:
        """Execute ``prog`` and return ``(outputs, lowering, fusion)``.

        Unlike :meth:`__call__` this mutates no executor state — per-call
        reports are returned, so one executor is safe to share across
        threads."""
        fusion = None
        if self.backend == "fused":
            prog, fusion = fuse(prog)
        lowering = LoweringReport(backend=self.backend)
        bufs = {k: torch.as_tensor(v, device=self.device)
                for k, v in buffers.items()}
        chain_at: dict[int, ForwardChain] = {}
        if self.backend == "cuda" and self.fuse_chains:
            chain_at = {c.instrs[0]: c for c in forwarding_chains(prog)}
        tr = self.tracer
        # instruction/chain spans only at Tracer(detail="instr") — at the
        # default "phase" detail a traced serving run stays lock-cheap
        traced = (tr is not None and tr.enabled
                  and getattr(tr, "detail", "phase") == "instr")
        i = 0
        while i < len(prog.instrs):  # Fetch
            chain = chain_at.get(i)
            if chain is not None:
                if traced:
                    with tr.span(f"chain/{prog.instrs[chain.instrs[-1]].dst}",
                                 instrs=len(chain.instrs)):
                        self._run_chain(chain, prog, bufs, batch_dims,
                                        lowering)
                else:
                    self._run_chain(chain, prog, bufs, batch_dims, lowering)
                i = chain.instrs[-1] + 1
                continue
            ins = prog.instrs[i]
            if traced:
                with tr.span(f"instr/{ins.opcode.value}/{ins.dst}"):
                    bufs[ins.dst] = self._dispatch(ins, bufs, batch_dims,
                                                   lowering)
            else:
                bufs[ins.dst] = self._dispatch(ins, bufs, batch_dims,
                                               lowering)
            i += 1
        missing = [o for o in prog.outputs if o not in bufs]
        if missing:
            raise KeyError(f"program did not produce outputs: {missing}")
        return {o: bufs[o] for o in prog.outputs}, lowering, fusion

    def run_async(self, prog: TMProgram, buffers, *, runtime, deps=(),
                  batch_dims: int = 0, label: str = "tm-program"):
        """Submit ``prog`` onto ``runtime``'s TMU stream instead of running
        it on the calling thread.

        ``buffers`` is the input dict, or a zero-arg callable resolved on
        the stream thread (so inputs produced by the ``deps`` events bind
        after those events complete).  Returns the
        :class:`~repro_torch.runtime.streams.StreamEvent`; its result is
        this executor's ``(outputs, lowering, fusion)`` triple once the
        work — not merely its launch — has finished (on the card: the
        engine's CUDA stream reached it)."""
        def task():
            bufs = buffers() if callable(buffers) else buffers
            return self.run(prog, bufs, batch_dims=batch_dims)
        return runtime.submit("tmu", task, deps=deps, label=label)

    def _run_chain(self, chain: ForwardChain, prog: TMProgram, bufs: dict,
                   batch_dims: int, lowering: LoweringReport) -> None:
        """Execute one chain region, fusing the longest claimable runs.

        Greedy: at each position try the longest remaining sub-chain (>= 2
        links) against the registry, shrinking from the tail; a claimed run
        executes as ONE kernel (its streamed intermediates are passed as
        ``None`` source slots and never enter the buffer file), an
        unclaimable head instruction lowers per-instruction and the scan
        advances one."""
        idxs = chain.instrs
        sb = self.params.segment_bytes if self.params is not None else None
        pos, n = 0, len(idxs)
        while pos < n:
            claimed = None
            for end in range(n, pos + 1, -1):
                if end - pos < 2:
                    break
                instrs = [prog.instrs[k] for k in idxs[pos:end]]
                streamed = set(chain.buffers[pos:end - 1])
                srcs = [[None if s in streamed else bufs[s]
                         for s in ins.srcs] for ins in instrs]
                lowered = lower_chain(instrs, srcs, batch_dims,
                                      segment_bytes=sb,
                                      quarantine=self.quarantine)
                if lowered is not None:
                    claimed = (end, lowered)
                    break
            if claimed is None:
                ins = prog.instrs[idxs[pos]]
                bufs[ins.dst] = self._dispatch(ins, bufs, batch_dims,
                                               lowering)
                pos += 1
                continue
            end, (val, rec) = claimed
            lowering.records.append(rec)
            bufs[prog.instrs[idxs[end - 1]].dst] = val
            pos = end

    def _dispatch(self, ins: TMInstr, bufs: dict, batch_dims: int,
                  lowering: LoweringReport) -> torch.Tensor:
        # compiled programs pin per-instruction batch dims (the RME
        # legalization pass); an executor-level batch lift composes on top
        # (the caller's leading axes come before the instruction's own)
        if ins.meta and "batch_dims" in ins.meta and ins.opcode in (
                TMOpcode.FINE_ASSEMBLE, TMOpcode.FINE_EVALUATE):
            batch_dims = batch_dims + ins.meta["batch_dims"]
        if self.backend == "cuda":
            srcs = [bufs[s] for s in ins.srcs]  # Tensor Load
            sb = self.params.segment_bytes if self.params is not None else None
            faults: list | None = [] if self.quarantine is not None else None
            lowered = lower_instr(ins, srcs, batch_dims, segment_bytes=sb,
                                  quarantine=self.quarantine, faults=faults)
            if lowered is not None:
                val, rec = lowered
                lowering.records.append(rec)
                return val
            # the registry cannot tell us *why* every rule declined; report
            # the observable conditions without guessing at causes
            if faults:
                reason = ("degraded to engine fallback: "
                          + "; ".join(f"{name} {why}" for name, why in faults))
            else:
                reason = (f"no matching kernel rule (batch_dims={batch_dims})"
                          if batch_dims else "no matching kernel rule")
            val = self._exec(ins, bufs, batch_dims)
            lowering.records.append(Lowering(
                dst=ins.dst, opcode=ins.opcode.value,
                path=f"reference.{ins.opcode.value}", reason=reason,
                degraded=bool(faults)))
            return val
        val = self._exec(ins, bufs, batch_dims)
        lowering.records.append(Lowering(
            dst=ins.dst, opcode=ins.opcode.value,
            path=f"reference.{ins.opcode.value}"))
        return val

    # one instruction = Decode + Load + (fine|ew|coarse) + Store
    def _exec(self, ins: TMInstr, bufs: dict, batch_dims: int) -> torch.Tensor:
        srcs = [bufs[s] for s in ins.srcs]  # Tensor Load
        if ins.opcode == TMOpcode.COPY:
            return srcs[0]
        if ins.opcode == TMOpcode.ELEMENTWISE:
            return _EW[ins.ew](srcs[0], srcs[1])
        if ins.opcode == TMOpcode.COARSE:
            if ins.maps is not None:  # Route: band loop (Branch stage)
                overlay = bool(ins.meta and ins.meta.get("overlay"))
                out = route_gather(ins.maps, srcs, batch_dims=batch_dims,
                                   overlay=overlay)
                if ins.ew is not None and len(srcs) > len(ins.maps):
                    out = _EW[ins.ew](out, srcs[-1])
                return out
            out = apply_map(ins.map_, srcs[0], batch_dims=batch_dims)
            if ins.ew is not None:  # fused elementwise epilogue
                out = _EW[ins.ew](out, srcs[1])
            return out
        if ins.opcode == TMOpcode.RESIZE:
            from repro_torch.core.tm_ops import resize_bilinear
            return resize_bilinear(srcs[0], ins.meta["out_h"], ins.meta["out_w"])
        if ins.opcode == TMOpcode.FINE_ASSEMBLE:
            cfg = ins.rme
            if cfg.lane_mask is not None:
                return rme.assemble_static(srcs[0], cfg.lane_mask)
            return _over_leading(
                lambda x, m: rme.assemble(x, m.to(torch.bool),
                                          cfg.capacity)[0],
                batch_dims, srcs[0], srcs[1])
        if ins.opcode == TMOpcode.FINE_EVALUATE:
            cfg = ins.rme
            if cfg.top_k is not None:
                fn = lambda x: rme.evaluate_topk(x, cfg.top_k, cfg.capacity,
                                                 cfg.score_index)[0]
            else:
                fn = lambda x: rme.evaluate(x, cfg.threshold, cfg.capacity,
                                            cmp=cfg.cmp,
                                            score_index=cfg.score_index)[0]
            return _over_leading(fn, batch_dims, srcs[0])
        raise ValueError(f"unknown opcode {ins.opcode}")


def _over_leading(fn: Callable, batch_dims: int, *args: torch.Tensor,
                  ) -> torch.Tensor:
    """Apply ``fn`` to every record stream under ``batch_dims`` leading axes
    of each argument — the reference engine's batch lift for the RME stage
    (an explicit loop over the flattened batch)."""
    if batch_dims == 0:
        return fn(*args)
    batch = tuple(args[0].shape[:batch_dims])
    flat = [a.reshape((-1,) + tuple(a.shape[batch_dims:])) for a in args]
    outs = [fn(*streams) for streams in zip(*flat)]
    if not outs:
        raise ValueError("empty batch: no record stream to run")
    out = torch.stack(outs)
    return out.reshape(batch + tuple(out.shape[1:]))
