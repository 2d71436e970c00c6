"""``repro_torch.ft`` — seeded fault injection and recovery for the port's
serving stack (the JAX package's ``repro.ft``).

* :class:`FaultInjector` (inject.py) — a seeded, deterministic fault plan
  (:class:`FaultPlan` of :class:`FaultSpec`) installed into four hook sites:
  stream task execution (:meth:`repro_torch.runtime.streams.Stream._run`),
  kernel lowering (:func:`repro_torch.core.dispatch.lower_instr`), phase
  execution (:meth:`repro_torch.compiler.api.CompiledTMProgram.run_phase`)
  and compilation (:meth:`repro_torch.serving.cache.CompileCache.get_or_compile`).
* :class:`PhaseWatchdog` (watchdog.py) — per-phase deadline enforcement over
  a :class:`~repro_torch.runtime.streams.StreamRuntime`: a hung phase is
  poisoned with :class:`PhaseTimeoutError` and the engine's worker is
  replaced, so a stuck phase loses its result instead of wedging the stream.

Recovery itself (bisect-retry failure isolation; the backend degradation
ladder, on the CPU only) lives in :class:`repro_torch.serving.server.TMServer`.
"""

from repro_torch.ft.inject import (SITES, FaultInjector, FaultPlan, FaultSpec,
                                   InjectedFault, active_injector,
                                   poisson_plan)
from repro_torch.ft.watchdog import PhaseTimeoutError, PhaseWatchdog

__all__ = [
    "SITES", "FaultInjector", "FaultPlan", "FaultSpec", "InjectedFault",
    "active_injector", "poisson_plan",
    "PhaseTimeoutError", "PhaseWatchdog",
]
