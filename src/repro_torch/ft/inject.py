"""Seeded, deterministic fault injection for the port's serving stack.

The JAX package's ``ft/inject.py`` over the port's four injection sites:
module-level ``fault_hook`` variables that are ``None`` in production (one
attribute load on the hot path) and point at :meth:`FaultInjector.fire`
while an injector is installed:

====================  ====================================================
site                  hook location / label format
====================  ====================================================
``"stream"``          ``repro_torch.runtime.streams.Stream._run`` —
                      ``"{engine}:{task label}"`` (e.g. ``"tmu:phase/1/tmu"``)
``"phase"``           ``repro_torch.compiler.api.CompiledTMProgram.run_phase``
                      — ``"phase/{index}/{kind}"`` (e.g. ``"phase/2/tmu"``)
``"lowering"``        ``repro_torch.core.dispatch.lower_instr`` —
                      ``"{rule}:{opcode}:{dst}"`` (fires inside the
                      degradation try: on the CPU an injected failure takes
                      the quarantine ladder; on the card it fails the run)
``"compile"``         ``repro_torch.serving.cache.CompileCache.get_or_compile``
                      — the entry's ``fn_key``
====================  ====================================================

A :class:`FaultPlan` is a tuple of :class:`FaultSpec` rows plus a seed.
Each spec matches one site (plus an optional label substring) and fires a
bounded, optionally probabilistic number of times; each spec draws from its
own ``random.Random`` seeded from ``(plan.seed, spec index)``, never from
global state, so a plan replays identically for a fixed arrival order.
Three modes:

* ``"fail"`` — raise :class:`InjectedFault` at the site;
* ``"hang"`` — block the calling thread for up to ``delay_s`` (or until the
  injector is uninstalled); this is what the watchdog recovers from.  A hang
  at the ``stream`` site fires before the task's launches, so a poisoned
  task launches nothing on the card;
* ``"slow"`` — sleep ``delay_s`` then continue.

One injector may be installed at a time (the hooks are process-global)::

    plan = FaultPlan(specs=(FaultSpec(site="stream", match="x4", count=1),))
    with FaultInjector(plan) as inj:
        ...  # the first matching stream task raises InjectedFault
    assert inj.fired == 1
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
from typing import Any

SITES = ("phase", "lowering", "compile", "stream")
_MODES = ("fail", "hang", "slow")


class InjectedFault(RuntimeError):
    """The error raised at a ``mode="fail"`` injection site."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One row of a fault plan: where, what, and how often.

    ``match`` is a substring filter on the site label (``""`` matches every
    occurrence at the site).  ``after`` skips the first N matching
    occurrences, ``count`` bounds total fires (``math.inf`` for unlimited),
    and ``p`` makes each eligible occurrence fire with that probability
    under the spec's seeded RNG.
    """

    site: str
    match: str = ""
    mode: str = "fail"
    p: float = 1.0
    after: int = 0
    count: float = 1
    delay_s: float = 0.05
    message: str = ""

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; expected "
                             f"one of {SITES}")
        if self.mode not in _MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; expected "
                             f"one of {_MODES}")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"fault probability must be in [0, 1], got "
                             f"{self.p}")
        if self.after < 0:
            raise ValueError(f"after must be >= 0, got {self.after}")
        if self.count < 0:
            raise ValueError(f"count must be >= 0, got {self.count}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded set of fault specs; the unit of replay."""

    specs: tuple[FaultSpec, ...] = ()
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "specs", tuple(self.specs))


class _SpecState:
    __slots__ = ("spec", "seen", "fired", "rng")

    def __init__(self, spec: FaultSpec, plan_seed: int, index: int):
        self.spec = spec
        self.seen = 0
        self.fired = 0
        self.rng = random.Random(
            (plan_seed, index, spec.site, spec.match).__repr__())


# the single active injector (hooks are process-global); guarded by
# _GLOBAL_LOCK
_ACTIVE: "FaultInjector | None" = None
_GLOBAL_LOCK = threading.Lock()


def active_injector() -> "FaultInjector | None":
    """The currently installed injector, or None."""
    return _ACTIVE


def _host_modules() -> dict[str, Any]:
    # imported lazily: repro_torch.ft must stay importable without pulling
    # the whole serving stack in, and the hosts import nothing from it
    import repro_torch.compiler.api as api
    import repro_torch.core.dispatch as dispatch
    import repro_torch.runtime.streams as streams
    import repro_torch.serving.cache as cache

    return {"phase": api, "lowering": dispatch, "compile": cache,
            "stream": streams}


class FaultInjector:
    """Installs a :class:`FaultPlan` into the stack's fault hooks.

    Thread-safe: ``fire`` is called concurrently from stream workers,
    admission threads and the caller's thread.  Occurrence counting is
    global per spec (not per label), so under concurrency the set of labels
    hit can vary run to run while the fired count stays exact.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._states = [_SpecState(s, plan.seed, i)
                        for i, s in enumerate(plan.specs)]
        self._lock = threading.Lock()
        self._release = threading.Event()  # set on uninstall: frees hangs
        self._installed = False
        self.log: list[tuple[str, str, str]] = []  # (site, label, mode)

    # -- installation ------------------------------------------------------

    def install(self) -> None:
        global _ACTIVE
        with _GLOBAL_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("another FaultInjector is already "
                                   "installed")
            self._release.clear()
            for mod in _host_modules().values():
                mod.fault_hook = self.fire
            self._installed = True
            _ACTIVE = self

    def uninstall(self) -> None:
        global _ACTIVE
        with _GLOBAL_LOCK:
            if not self._installed:
                return
            for mod in _host_modules().values():
                mod.fault_hook = None
            self._installed = False
            _ACTIVE = None
        # release any hanging sites after the hooks are gone, so no new
        # hang can start and then block forever
        self._release.set()

    def __enter__(self) -> "FaultInjector":
        self.install()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()

    # -- the hook ----------------------------------------------------------

    def fire(self, site: str, label: str) -> None:
        """Called from the host sites; raises or sleeps per the first
        matching spec."""
        for st in self._states:
            spec = st.spec
            if spec.site != site or (spec.match and spec.match not in label):
                continue
            with self._lock:
                occ = st.seen
                st.seen += 1
                fires = (occ >= spec.after and st.fired < spec.count
                         and (spec.p >= 1.0 or st.rng.random() < spec.p))
                if fires:
                    st.fired += 1
                    self.log.append((site, label, spec.mode))
            if not fires:
                continue
            if spec.mode == "fail":
                raise InjectedFault(
                    spec.message or f"injected fault at {site} site: {label}")
            if spec.mode == "hang":
                self._release.wait(spec.delay_s)
            else:  # slow: interruptible, uninstall releases it too
                self._release.wait(min(spec.delay_s, 60.0))
            return  # at most one spec acts per occurrence

    # -- introspection -----------------------------------------------------

    @property
    def fired(self) -> int:
        with self._lock:
            return sum(st.fired for st in self._states)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            per_site: dict[str, int] = {}
            rows = []
            for st in self._states:
                per_site[st.spec.site] = (per_site.get(st.spec.site, 0)
                                          + st.fired)
                rows.append({
                    "site": st.spec.site, "match": st.spec.match,
                    "mode": st.spec.mode, "seen": st.seen,
                    "fired": st.fired,
                })
            return {
                "fired": sum(st.fired for st in self._states),
                "per_site": per_site,
                "specs": rows,
            }


def poisson_plan(seed: int, rate: float, *, hang_delay_s: float = 1.0,
                 slow_delay_s: float = 0.05) -> FaultPlan:
    """A ready-made chaos plan: probabilistic faults at all four sites.

    ``rate`` is the approximate per-occurrence fire probability at each
    site.  Compile faults are count-limited so a shape class can always
    eventually compile; hangs are bounded by ``hang_delay_s`` so an
    unwatched run still terminates.
    """
    if not (0.0 < rate <= 1.0):
        raise ValueError(f"rate must be in (0, 1], got {rate}")
    return FaultPlan(seed=seed, specs=(
        FaultSpec(site="stream", mode="fail", p=rate, count=math.inf),
        FaultSpec(site="stream", mode="hang", p=rate / 4, count=math.inf,
                  delay_s=hang_delay_s),
        FaultSpec(site="stream", mode="slow", p=rate, count=math.inf,
                  delay_s=slow_delay_s),
        FaultSpec(site="phase", mode="fail", p=rate, count=math.inf),
        FaultSpec(site="lowering", mode="fail", p=rate, count=math.inf),
        FaultSpec(site="compile", mode="fail", p=rate, count=4),
    ))
