"""Compile cache — LRU over ``(fn, shapes, dtypes, backend, CycleParams)``.

``tm_compile`` pays a trace + pass-pipeline + partition + allocation walk per
shape class; under serving traffic the same shape classes recur forever, so
the server compiles once per :class:`CacheKey` and replays the pinned
:class:`~repro_torch.compiler.api.CompiledTMProgram`.

Key semantics:

* **fn identity** — an explicit ``fn_key`` string when the caller provides
  one, else ``(module, qualname, id(fn))``.  The entry keeps a strong
  reference to ``fn`` *while cached*, so a cached ``id`` can never be
  recycled by the allocator while the entry is live (two different lambdas
  can therefore never alias one entry).  Eviction drops the pin — an evicted
  entry must not keep the traced closure alive.
* **shapes/dtypes** — of the *flattened, batched* arguments (the bucketed
  shape class, not the raw request).
* **backend / params** — the *requested* execution config; the entry pins
  the *selected* winner (config selection may sweep candidates at admission
  and store its choice on the entry).

Concurrent misses on one key de-duplicate: the first caller compiles, the
rest wait on an in-flight event and count as hits (they never pay the
compile).  Eviction is LRU by last access.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable

from torch.utils import _pytree as pytree

from repro_torch.core.schedule import CycleParams
from repro_torch.serving.batcher import leaf_dtype

# repro_torch.ft.FaultInjector.install() points this at its fire() method; None in
# production — fired around build() so an injected compile fault surfaces as
# a (retryable) admission failure, exactly like a real trace/staging error
fault_hook: Callable[[str, str], None] | None = None


def fn_identity(fn: Callable, fn_key: Any = None) -> Any:
    """THE fn-identity rule, shared by bucket keys and cache keys: an
    explicit ``fn_key`` wins, else ``(module, qualname, id)`` (the id is
    pinned by the entry's strong reference to ``fn``)."""
    if fn_key is not None:
        return fn_key
    return (getattr(fn, "__module__", "?"),
            getattr(fn, "__qualname__", repr(fn)), id(fn))


@dataclasses.dataclass(frozen=True)
class CacheKey:
    fn_key: Any                     # str | (module, qualname, id)
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[str, ...]
    backend: str
    params: CycleParams | None      # requested (None = auto/default)

    @staticmethod
    def for_call(fn, args, *, backend: str,
                 params: CycleParams | None = None,
                 fn_key: str | None = None) -> "CacheKey":
        flat, _ = pytree.tree_flatten(args)
        shapes = tuple(tuple(int(d) for d in getattr(a, "shape", ()))
                       for a in flat)
        dtypes = tuple(leaf_dtype(a) for a in flat)
        return CacheKey(fn_identity(fn, fn_key), shapes, dtypes, backend,
                        params)


@dataclasses.dataclass
class CacheEntry:
    """One pinned compilation + the admission-time config decision."""

    key: CacheKey
    fn: Callable | None             # pins id(fn) while cached; None once
    #                                 evicted (the pin dies with residency)
    compiled: Any                   # CompiledTMProgram
    backend: str                    # selected (may differ from key.backend)
    params: CycleParams | None      # selected cycle params (pinned winner)
    # cuda backend: execute forwarding chains as single megakernels —
    # pinned at admission by the cycle-model chain sweep, and used by the
    # stats side so predicted overlap reflects realized (chained) execution
    fuse_chains: bool = False
    # cuda backend: the pinned compilation was re-partitioned with
    # cross-engine fusion (compute ops merged with adjacent TM runs into
    # ``fused`` phases that lower as ONE kernel launch) — pinned at
    # admission only after a realized probe, like ``fuse_chains``
    cross_engine: bool = False
    selection: dict = dataclasses.field(default_factory=dict)
    compile_s: float = 0.0
    hits: int = 0
    # born from a speculative pre-compile (repro_torch.sched): demand hits on such
    # entries count as speculative_hits; evicted with zero demand hits they
    # count as speculative_wasted — so the benchmark can tell whether
    # speculation pays for itself
    speculative: bool = False
    demand_hits: int = 0            # non-speculative lookups that landed here
    # degradation-ladder state (docs/robustness.md), both mutated in place
    # so warm traffic sees prior failures without re-failing — on the CPU
    # only: on the card a failing kernel fails the request
    # * quarantine — (rule, opcode, shape-class) keys of kernel lowerings
    #   that raised; dispatch skips them (see dispatch.lower_instr); None
    #   on the card
    # * degraded_phases — phase index -> backend the server's phase-level
    #   ladder settled on after the entry's own backend failed that phase
    quarantine: set | None = None
    degraded_phases: dict = dataclasses.field(default_factory=dict)
    # per-phase cycle-model prices, the watchdog's deadline input (computed
    # once, at the entry's first execution under a watchdog)
    phase_cycle_pred: tuple | None = None


class CompileCache:
    """Thread-safe LRU compile cache with hit/miss/eviction stats."""

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[CacheKey, CacheEntry]" = OrderedDict()
        self._inflight: dict[CacheKey, threading.Event] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # speculative pre-compiles live OUTSIDE the demand hit/miss ledger:
        # a prewarm that compiles counts speculative_compiles (not misses),
        # and hit_rate keeps describing demand traffic only
        self.speculative_compiles = 0
        self.speculative_hits = 0
        self.speculative_wasted = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list[CacheKey]:
        with self._lock:
            return list(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def _record_hit_locked(self, entry: CacheEntry) -> None:
        self.hits += 1
        entry.hits += 1
        entry.demand_hits += 1
        if entry.speculative:
            self.speculative_hits += 1

    def get(self, key: CacheKey) -> CacheEntry | None:
        """Plain lookup (counts a hit/miss; no compile, no de-dup)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self._record_hit_locked(entry)
            return entry

    def contains_or_inflight(self, key: CacheKey) -> bool:
        """True when ``key`` is cached or a compile for it is already in
        flight — the speculative path's de-dup check (no stats recorded)."""
        with self._lock:
            return key in self._entries or key in self._inflight

    def get_or_compile(self, key: CacheKey,
                       build: Callable[[], CacheEntry],
                       speculative: bool = False,
                       ) -> tuple[CacheEntry, bool]:
        """Return ``(entry, was_hit)``; ``build()`` runs at most once per key
        across concurrent callers (losers wait and count as hits).

        ``speculative=True`` marks a pre-compile ahead of demand: it stays
        out of the demand hit/miss ledger (a compile counts
        ``speculative_compiles``, a race into an existing entry counts
        nothing) and stamps the entry so later demand hits and wasted
        evictions are attributed to speculation."""
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    if not speculative:
                        self._record_hit_locked(entry)
                    return entry, True
                event = self._inflight.get(key)
                if event is None:
                    self._inflight[key] = threading.Event()
                    if speculative:
                        self.speculative_compiles += 1
                    else:
                        self.misses += 1
                    break
            # another thread is compiling this key: wait, then re-check (the
            # re-check counts the hit; a failed compile falls through to retry)
            event.wait()
        try:
            hook = fault_hook
            if hook is not None:
                hook("compile", str(key.fn_key))
            entry = build()
        except BaseException:
            with self._lock:
                self._inflight.pop(key).set()
            raise
        entry.speculative = speculative
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                _, evicted = self._entries.popitem(last=False)
                # drop the fn pin: the strong ref exists to keep id(fn)
                # stable while the entry is CACHED; left in place it would
                # keep the traced closure (and everything it captures) alive
                # for as long as anyone holds the evicted entry
                evicted.fn = None
                if evicted.speculative and evicted.demand_hits == 0:
                    self.speculative_wasted += 1
                self.evictions += 1
            self._inflight.pop(key).set()
        return entry, False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / (self.hits + self.misses)
                             if (self.hits + self.misses) else 0.0),
                "speculative_compiles": self.speculative_compiles,
                "speculative_hits": self.speculative_hits,
                "speculative_wasted": self.speculative_wasted,
            }
