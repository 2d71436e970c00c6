"""Kernel-dispatch registry — lowering TM instructions onto the CUDA kernels.

The TMU decodes each instruction's register contents and drives one of its
datapaths; the GPU analogue is *lowering*: each :class:`TMInstr` is matched
against a registry of kernel rules (populated by the kernel packages under
:mod:`repro_torch.kernels` at import time) and executed by the first rule
that claims it.  Instructions no rule claims run on the generic engine
(:func:`repro_torch.core.engine.apply_map` et al.) — exactly like a TMU
raising a configuration it does not support to the host.

The kernel a rule runs is chosen by the device of its operands: on a CUDA
tensor the hand-written kernel launches (or raises), on a CPU tensor its
plain PyTorch version runs.  Either way the lowering path is the rule's
(``cuda.block``, ``cuda.gather``, …), so the report says which datapath
the instruction was lowered to, independently of where it ran.

Every lowering decision is recorded as a :class:`Lowering` in a
:class:`LoweringReport`, so tests can assert *which* datapath ran, not just
that the numbers agree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.instr import TMInstr

# a fault injector points this at its fire() method; None in production.  It
# fires INSIDE the rule-execution try below, so an injected lowering fault
# exercises the quarantine/fallback ladder (on the CPU), not a crash.
fault_hook: Callable[[str, str], None] | None = None


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One lowering decision — an instruction, or a fused forwarding chain.

    ``launches`` makes kernel-launch accounting explicit: a block/gather
    kernel is one launch, a multi-band Route launches once per band, a
    reference fallback is one engine pass, and a fused chain is ONE launch
    covering ``instrs`` instructions.
    """

    dst: str
    opcode: str
    path: str        # e.g. "cuda.block", "cuda.gather", "reference.coarse"
    kernel: str = ""  # registry rule that claimed the instruction ("" = fallback)
    reason: str = ""  # why the fallback was taken ("" when a kernel ran)
    segments: int | None = None  # block iterations of the cycle model
    #                              (schedule.map_segments / instr_segments),
    #                              when the rule reports it
    launches: int = 1  # kernel launches (engine passes for fallbacks)
    instrs: int = 1    # TM instructions this record covers (>1: fused chain)
    degraded: bool = False  # a preferred kernel failed/was quarantined and
    #                         this record is the surviving fallback path

    @property
    def is_kernel(self) -> bool:
        return self.path.startswith("cuda.")

    @property
    def is_chain(self) -> bool:
        return self.instrs > 1


@dataclasses.dataclass
class LoweringReport:
    """Per-instruction lowering decisions for one executor run."""

    backend: str
    records: list[Lowering] = dataclasses.field(default_factory=list)

    def paths(self) -> list[str]:
        return [r.path for r in self.records]

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.records:
            out[r.path] = out.get(r.path, 0) + 1
        return out

    def kernel_fraction(self) -> float:
        if not self.records:
            return 0.0
        return sum(r.is_kernel for r in self.records) / len(self.records)

    def launch_count(self) -> int:
        """Total kernel launches (engine passes for fallbacks) this run."""
        return sum(r.launches for r in self.records)

    def instr_count(self) -> int:
        """TM instructions executed (chain records cover several)."""
        return sum(r.instrs for r in self.records)

    def chain_count(self) -> int:
        """Fused forwarding chains executed as single kernels."""
        return sum(1 for r in self.records if r.is_chain)

    def degraded_count(self) -> int:
        """Records that took a fallback because a kernel failed or was
        quarantined (the degradation ladder's per-run footprint)."""
        return sum(1 for r in self.records if r.degraded)


@dataclasses.dataclass(frozen=True)
class KernelRule:
    """One registry entry.

    ``matches(ins, srcs, batch_dims, segment_bytes=None)`` returns the
    lowering path string when the rule can execute the instruction (None
    otherwise); ``run(ins, srcs, batch_dims, segment_bytes=None)`` executes
    it.  ``segment_bytes`` is the ping-pong buffer budget
    (:class:`~repro_torch.core.schedule.CycleParams.segment_bytes`); None
    means the default.  ``priority`` orders rules (higher first) so
    specialised kernels outrank the generic tm_affine gather.
    """

    name: str
    matches: Callable[..., str | None]
    run: Callable[..., torch.Tensor]
    priority: int = 0
    # optional: report the block iterations of the cycle model, so the
    # lowering report can be checked against the schedule
    segments: Callable[..., int] | None = None
    # optional: kernel launches this rule issues (default 1; Route launches
    # one kernel per band)
    launches: Callable[..., int] | None = None


@dataclasses.dataclass(frozen=True)
class ChainRule:
    """One chain-registry entry — lowers a whole forwarding chain.

    ``lower(instrs, srcs, batch_dims, segment_bytes=None)`` receives the
    chain's instruction run and each instruction's resolved sources
    (``None`` in the slot of a chain-internal intermediate — it never
    materializes).  It returns ``(value, path, segments)`` when the rule can
    execute the chain as ONE kernel, None otherwise.  The kernel packages
    register two: ``rme_gather.chain_evaluate`` (priority 10, coarse links
    into an RME evaluate) and ``tm_affine.chain`` (coarse links, optionally
    ending in a Route).  A rule that claims a chain on a CUDA tensor
    launches its kernel or raises; it never returns None to hide a kernel
    that fails.
    """

    name: str
    lower: Callable[..., tuple[torch.Tensor, str, int | None] | None]
    priority: int = 0


@dataclasses.dataclass(frozen=True)
class XEngineRule:
    """One cross-engine registry entry — lowers a compute op plus its
    adjacent TM chain as ONE launch.

    ``lower(direction, eqn_node, eqn_srcs, instrs, tm_srcs,
    segment_bytes=None, reasons=None)`` receives the compiler's compute node
    (:class:`~repro_torch.compiler.ir.TPUNode`), its tensor operands
    (``None`` in the crossing slot for ``tm_to_compute``), the TM run and
    each instruction's resolved sources (``None`` for a streamed buffer).
    It returns ``(value, path, segments)``, or None to decline (appending
    why to ``reasons`` when given).  The kernel
    packages register one: ``matmul_tm.xchain``
    (:mod:`repro_torch.kernels.matmul_tm.chain`)."""

    name: str
    lower: Callable[..., tuple[torch.Tensor, str, int | None] | None]
    priority: int = 0


_RULES: list[KernelRule] = []
_CHAIN_RULES: list[ChainRule] = []
_XENGINE_RULES: list[XEngineRule] = []
_REGISTERED = False


def register_rule(name: str, matches, run, priority: int = 0,
                  segments=None, launches=None) -> None:
    """Register a kernel rule (called by kernel packages at import time)."""
    global _RULES
    _RULES = [r for r in _RULES if r.name != name]  # idempotent re-import
    _RULES.append(KernelRule(name, matches, run, priority, segments, launches))
    _RULES.sort(key=lambda r: -r.priority)


def register_chain_rule(name: str, lower, priority: int = 0) -> None:
    """Register a chain rule (called by kernel packages at import time)."""
    global _CHAIN_RULES
    _CHAIN_RULES = [r for r in _CHAIN_RULES if r.name != name]
    _CHAIN_RULES.append(ChainRule(name, lower, priority))
    _CHAIN_RULES.sort(key=lambda r: -r.priority)


def register_xengine_rule(name: str, lower, priority: int = 0) -> None:
    """Register a cross-engine rule (called by kernel packages at import)."""
    global _XENGINE_RULES
    _XENGINE_RULES = [r for r in _XENGINE_RULES if r.name != name]
    _XENGINE_RULES.append(XEngineRule(name, lower, priority))
    _XENGINE_RULES.sort(key=lambda r: -r.priority)


def _ensure_registered() -> None:
    """Import the kernel packages so their ops modules self-register."""
    global _REGISTERED
    if _REGISTERED:
        return
    import repro_torch.kernels.img2col.ops  # noqa: F401
    import repro_torch.kernels.matmul_tm.chain  # noqa: F401
    import repro_torch.kernels.resize.ops  # noqa: F401
    import repro_torch.kernels.rme_gather.ops  # noqa: F401
    import repro_torch.kernels.tm_affine.ops  # noqa: F401
    _REGISTERED = True


def rules() -> list[KernelRule]:
    _ensure_registered()
    return list(_RULES)


def quarantine_key(rule_name: str, opcode: str,
                   srcs: Sequence[torch.Tensor | None]) -> tuple:
    """The (rule, shape-class) identity a failing kernel is quarantined
    under: same rule + same opcode + same source shapes means the same
    lowering and is skipped without re-failing."""
    shapes = tuple(tuple(int(d) for d in getattr(s, "shape", ()))
                   for s in srcs if s is not None)
    return (rule_name, opcode, shapes)


def _check_ladder(quarantine: set | None, srcs) -> None:
    """The degradation ladder skips rules only on the CPU, where a rule runs
    its kernel's plain version.  On the card a kernel that fails to build or
    launch fails the run: nothing gives way to the reference engine."""
    if quarantine is not None and any(getattr(s, "is_cuda", False)
                                      for s in srcs):
        raise ValueError("the quarantine ladder runs only on CPU tensors; "
                         "on a CUDA tensor a failing kernel must raise")


def lower_instr(ins: TMInstr, srcs: Sequence[torch.Tensor], batch_dims: int,
                segment_bytes: int | None = None,
                quarantine: set | None = None,
                faults: list | None = None,
                ) -> tuple[torch.Tensor, Lowering] | None:
    """Lower one instruction through the registry.

    Returns ``(value, lowering)`` from the first matching rule, or None when
    no rule claims the instruction (caller falls back to the engine).

    ``quarantine`` (a mutable set owned by the caller) arms the degradation
    ladder: a rule whose :func:`quarantine_key` is in the set is skipped
    outright, and a rule that *raises* is added to the set and skipped —
    lowering falls through to the next rule, or to the caller's engine
    fallback, and the surviving record is marked ``degraded``.  Without a
    quarantine set (the default) a raising rule propagates: a kernel that
    fails to build or launch fails the run.  ``faults`` (optional
    caller-owned list) collects one ``(rule name, why)`` row per skipped
    rule, so a None return can still tell the caller its engine fallback is
    a degradation.  The ladder is for CPU tensors only: a quarantine set
    with a CUDA source raises ``ValueError``.
    """
    _check_ladder(quarantine, srcs)
    _ensure_registered()
    degraded = False
    for rule in _RULES:
        path = rule.matches(ins, srcs, batch_dims, segment_bytes=segment_bytes)
        if path is None:
            continue
        if quarantine is not None:
            qkey = quarantine_key(rule.name, ins.opcode.value, srcs)
            if qkey in quarantine:
                degraded = True
                if faults is not None:
                    faults.append((rule.name, "quarantined"))
                continue
        try:
            hook = fault_hook
            if hook is not None:
                hook("lowering", f"{rule.name}:{ins.opcode.value}:{ins.dst}")
            val = rule.run(ins, srcs, batch_dims, segment_bytes=segment_bytes)
        except Exception as e:
            if quarantine is None:
                raise
            quarantine.add(quarantine_key(rule.name, ins.opcode.value, srcs))
            degraded = True
            if faults is not None:
                faults.append((rule.name, f"failed: {e!r}"))
            continue
        seg = (rule.segments(ins, srcs, batch_dims,
                             segment_bytes=segment_bytes)
               if rule.segments is not None else None)
        n_launch = (rule.launches(ins, srcs, batch_dims)
                    if rule.launches is not None else 1)
        return val, Lowering(dst=ins.dst, opcode=ins.opcode.value,
                             path=path, kernel=rule.name, segments=seg,
                             launches=n_launch, degraded=degraded,
                             reason=("degraded: preferred kernel "
                                     "failed or quarantined"
                                     if degraded else ""))
    return None


def lower_chain(instrs: Sequence[TMInstr],
                srcs: Sequence[Sequence[torch.Tensor | None]],
                batch_dims: int,
                segment_bytes: int | None = None,
                quarantine: set | None = None,
                ) -> tuple[torch.Tensor, Lowering] | None:
    """Lower a whole forwarding chain through the chain registry.

    ``instrs`` is the chain's consecutive instruction run
    (:func:`repro_torch.core.fusion.forwarding_chains`); ``srcs[k]``
    resolves instruction k's sources, with ``None`` in the position of the
    streamed intermediate.  Returns ``(final value, lowering)`` from the
    first rule that claims the chain — one record, ``launches=1``, covering
    ``len(instrs)`` instructions — or None when no rule does (caller
    executes the links one by one).  A quarantined or raising chain rule is
    skipped the same way as in :func:`lower_instr`, on CPU tensors only.
    """
    _check_ladder(quarantine, [s for row in srcs for s in row])
    _ensure_registered()
    for rule in _CHAIN_RULES:
        if quarantine is not None:
            qkey = quarantine_key(rule.name, "chain", srcs[0])
            if qkey in quarantine:
                continue
        try:
            lowered = rule.lower(instrs, srcs, batch_dims,
                                 segment_bytes=segment_bytes)
        except Exception:
            if quarantine is None:
                raise
            quarantine.add(quarantine_key(rule.name, "chain", srcs[0]))
            continue
        if lowered is not None:
            val, path, seg = lowered
            return val, Lowering(dst=instrs[-1].dst, opcode="chain",
                                 path=path, kernel=rule.name, segments=seg,
                                 launches=1, instrs=len(instrs))
    return None


def lower_xengine(direction: str, eqn_node, eqn_srcs: Sequence,
                  instrs: Sequence[TMInstr],
                  tm_srcs: Sequence[Sequence[torch.Tensor | None]],
                  segment_bytes: int | None = None,
                  quarantine: set | None = None,
                  reasons: list | None = None,
                  ) -> tuple[torch.Tensor, Lowering] | None:
    """Lower a cross-engine crossing (compute node + adjacent TM chain)
    through the cross-engine registry.

    The returned record's ``dst`` is what the ONE launch produces: the
    chain's final dst for ``compute_to_tm`` (the product streams into the
    chain and never materializes), the compute node's output for
    ``tm_to_compute`` (the chain output streams into the op's operand
    tiles).  ``launches=1`` and ``instrs=len(instrs)+1`` count the compute
    op, so launch and instruction accounting stays honest against the split
    path.  Returns None when no rule claims the crossing — the caller then
    executes op and chain separately; a rule that declines appends why to
    ``reasons`` (a caller-owned list) when one is given.  ``quarantine``
    works as in :func:`lower_instr` (a raising rule is quarantined under
    its shape-class key and skipped on later runs), on CPU tensors only."""
    _check_ladder(quarantine, list(eqn_srcs)
                  + [s for row in tm_srcs for s in row])
    _ensure_registered()
    dst = (instrs[-1].dst if direction == "compute_to_tm"
           else eqn_node.dst_names[0])
    for rule in _XENGINE_RULES:
        if quarantine is not None:
            qkey = quarantine_key(rule.name, f"xchain.{direction}", eqn_srcs)
            if qkey in quarantine:
                continue
        try:
            hook = fault_hook
            if hook is not None:
                hook("lowering", f"{rule.name}:xchain:{dst}")
            lowered = rule.lower(direction, eqn_node, eqn_srcs, instrs,
                                 tm_srcs, segment_bytes=segment_bytes,
                                 reasons=reasons)
        except Exception:
            if quarantine is None:
                raise
            quarantine.add(quarantine_key(rule.name, f"xchain.{direction}",
                                          eqn_srcs))
            continue
        if lowered is not None:
            val, path, seg = lowered
            return val, Lowering(dst=dst, opcode="xchain", path=path,
                                 kernel=rule.name, segments=seg,
                                 launches=1, instrs=len(instrs) + 1)
    return None
