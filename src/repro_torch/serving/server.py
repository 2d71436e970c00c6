"""``TMServer`` — compile-cached, shape-bucketed, pipelined TMU serving.

The request path:

1. ``submit(fn, *args)`` queues the call in its shape bucket
   (:mod:`repro_torch.serving.batcher`) and returns a future.
2. The batcher thread coalesces up to ``max_batch`` same-bucket requests
   (waiting at most ``batch_timeout_s`` for stragglers), pads the batch to a
   power-of-two height, and admits it.
3. Admission hits the compile cache (:mod:`repro_torch.serving.cache`); a miss
   compiles ``torch.func.vmap(fn)`` at the bucketed shape once via
   ``tm_compile`` and runs **config selection**: every candidate
   ``segment_bytes`` is swept through the cycle model (re-partitioning is
   pure Python — no re-trace) and the winner is pinned on the entry, so the
   entry's kernels launch at the budget the model chose.  When ``backend_candidates`` is set, each
   candidate backend executes the admission batch once and the fastest is
   pinned (a measured probe — the cycle model is backend-agnostic).
4. The compiled program's phase chain becomes a
   :class:`~repro_torch.serving.pipeline.PipelineJob`: the TMU engine runs request
   *i+1*'s manipulation phases while the TPU engine runs request *i*'s
   opaque compute — the paper's ping-pong double buffering at request
   granularity, with the cycle model's predicted overlap recorded next to
   the measured one.  On the card the two engines are two CUDA streams.
5. Results are split back per request and futures resolve bit-exact with
   direct ``fn(*args)`` calls.

Failure handling (``docs/robustness.md``): a failed group enters
bisect-retry **isolation** on a dedicated retry worker — the stacked batch
is re-executed in halves down to singletons so only the request(s) actually
poisoning it keep the error and innocents resolve bit-exact.  On the CPU a
TMU phase whose kernel path raises falls down the ``degrade_backends``
ladder and the entry remembers the working backend; on the card there is
no ladder and no quarantine: a failing kernel fails the request.  A hung
phase is poisoned by the :class:`~repro_torch.ft.watchdog.PhaseWatchdog`
(enabled by ``phase_timeout_factor > 0``) and its group goes to the same
isolation.

``ServerConfig.device`` (None: the card) is where the server runs: the
engines' streams, the compiled programs and the stacked batches.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import threading
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.compiler.allocate import allocate
from repro_torch.compiler.api import CompiledTMProgram, tm_compile
from repro_torch.compiler.partition import partition
from repro_torch.core.executor import BACKENDS, resolve_device
from repro_torch.core.schedule import CycleParams
from repro_torch.obs.tracer import as_tracer
from repro_torch.serving.batcher import (BucketQueue, Request, bucket_size,
                                   coalesce, split)
from repro_torch.serving.cache import (CacheEntry, CacheKey, CompileCache,
                                 fn_identity)
from repro_torch.serving.pipeline import PipelineJob, RequestPipeline
from repro_torch.serving.stats import ServerStats

_LOG = logging.getLogger("repro_torch.serving.server")

DEFAULT_SEGMENT_CANDIDATES = (4096, 16384, 65536)


class DrainTimeoutError(RuntimeError):
    """:meth:`TMServer.drain` timed out; ``pending`` holds diagnostic rows
    (engine, label, state, age_s) for the stream work still undone."""

    def __init__(self, message: str, pending: list[dict] | None = None):
        super().__init__(message)
        self.pending = pending or []

# request priority classes (repro_torch.sched): lower rank schedules first.  A
# request carrying a deadline is always deadline-class; the continuous
# scheduler orders that class earliest-deadline-first and may preempt
# lower-priority work at phase boundaries for it.
PRIORITIES = {"deadline": 0, "interactive": 1, "batch": 2}


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving knobs (all per-server, immutable once started)."""

    backend: str = "fused"          # requested backend (cache-key component)
    backend_candidates: tuple[str, ...] = ()  # non-empty: probe + pin winner
    # where the server runs (the JAX package's ``interpret`` has no
    # meaning here): None = the card, "cpu" = the kernels' plain versions
    device: Any = None
    # bit-exact compute phases for the decode gate: each compute node one
    # aten call (as always in the port) and fused cross-engine phases on
    # their split path, so every compute op is the library call eager code
    # makes
    exact: bool = False
    max_batch: int = 8              # micro-batch height cap (power of two)
    batch_timeout_s: float = 0.005  # max straggler wait before dispatch
    cache_capacity: int = 32        # compile-cache entries (LRU)
    pipeline_depth: int = 2         # in-flight jobs (2 = ping-pong pair)
    segment_candidates: tuple[int, ...] = DEFAULT_SEGMENT_CANDIDATES
    select_config: bool = True      # sweep segment_candidates at admission
    launch_overhead_cycles: float = 32.0  # per-block-iteration sweep charge
    # admission also sweeps chain fusion (cuda backend): score chained vs
    # per-instruction execution through the cycle model (+ a per-launch
    # charge) and pin the winner on the entry
    select_chaining: bool = True
    # admission also sweeps cross-engine fusion (cuda backend): re-
    # partition with engine-boundary crossings merged into fused phases,
    # score the modeled HBM/launch savings through the cycle model, probe
    # one execution, and pin the crossing partition only when a crossing
    # actually realized (the lowering may decline geometry the discovery
    # pass accepted)
    select_xengine: bool = True
    # observability: None/False = off (the no-op tracer — one attribute
    # check on the hot path), True = the server creates a repro_torch.obs.Tracer
    # (exposed as ``TMServer.tracer``), or pass a Tracer to share one
    # timeline across servers/sessions
    trace: Any = None
    # admission scheduler: "continuous" (repro_torch.sched — rolling group
    # formation at dispatch time, priority/deadline ordering, phase-boundary
    # preemption, speculative pre-compile) or "fifo" (the PR-3
    # power-of-two micro-batcher + depth-limited FIFO pipeline, kept as the
    # measured baseline).  Both honor ``batch_timeout_s`` as the partial-
    # group straggler window and ``pipeline_depth`` as the in-flight cap.
    scheduler: str = "continuous"
    # continuous scheduler knobs (ignored under "fifo"):
    preempt_margin_s: float = 0.002  # deadline slack floor before preempting
    aging_s: float = 0.05            # waiting this long boosts one class
    speculative: bool = False        # pre-compile the next likely bucket
    # --- fault tolerance (repro_torch.ft, docs/robustness.md) -------------------
    # bisect-retry isolation: a failed group is re-executed in halves down
    # to singletons so only the poisoning request(s) keep the error;
    # retry_attempts bounds re-executions of one singleton (0 = groups fail
    # whole, no isolation), retry_backoff_s is the base of the exponential
    # backoff between rounds
    retry_attempts: int = 2
    retry_backoff_s: float = 0.01
    # per-phase watchdog: deadline = max(floor, factor * predicted wall),
    # attached to WARM (cache-hit) executions only — cold runs include
    # tracing and would false-trip.  factor 0.0 disables the watchdog
    phase_timeout_factor: float = 0.0
    phase_timeout_floor_s: float = 0.25
    # backend ladder a failing TMU phase falls down (in order, skipping the
    # entry's own backend); the working rung is memoized per (entry, phase).
    # On the CPU only: on the card a failing phase fails the request
    degrade_backends: tuple[str, ...] = ("fused", "reference")

    def __post_init__(self):
        for b in (self.backend,) + self.backend_candidates \
                + self.degrade_backends:
            if b not in BACKENDS:
                raise ValueError(f"unknown backend {b!r}; expected {BACKENDS}")
        if self.max_batch < 1 or self.max_batch & (self.max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, "
                             f"got {self.max_batch}")
        if self.scheduler not in ("continuous", "fifo"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"expected 'continuous' or 'fifo'")
        if self.retry_attempts < 0:
            raise ValueError(f"retry_attempts must be >= 0, "
                             f"got {self.retry_attempts}")
        if self.phase_timeout_factor < 0:
            raise ValueError(f"phase_timeout_factor must be >= 0, "
                             f"got {self.phase_timeout_factor}")


# ---------------------------------------------------------------------------
# cycle-model scoring: config selection + predicted pipeline overlap
# ---------------------------------------------------------------------------

def select_cycle_params(graph, candidates: tuple[int, ...],
                        launch_overhead_cycles: float = 32.0,
                        ) -> tuple[CycleParams, Any, list[dict]]:
    """Sweep ``segment_bytes`` candidates through the cycle model; return
    ``(winner, its PartitionReport, per-candidate rows)``.

    Partitioning is pure Python over the already-optimized graph, so the
    sweep costs no re-trace; thanks to the executor→kernel budget plumbing
    the winner also re-sizes the launched kernels' segments, keeping the
    model's segment counts equal to the ones it scored.

    Scoring charges ``launch_overhead_cycles`` per block iteration on top of
    the model's forwarded cycles: the per-instruction model amortizes
    fill/drain ever further as segments shrink, so without a per-launch
    charge the sweep degenerates to the smallest candidate — which is not
    how kernel launches behave."""
    sweep = list(dict.fromkeys(candidates or ())) or \
        [CycleParams().segment_bytes]
    best: tuple[CycleParams, Any, float] | None = None
    rows = []
    for sb in sweep:
        params = CycleParams(segment_bytes=int(sb))
        part = partition(graph, params)
        n_segs = sum(t.n_segments for ph in part.tmu_phases
                     for t in ph.schedule.timings)
        score = part.forwarded_cycles + launch_overhead_cycles * n_segs
        rows.append({"segment_bytes": int(sb),
                     "forwarded_cycles": part.forwarded_cycles,
                     "unpipelined_cycles": part.unpipelined_cycles,
                     "segments": n_segs, "score": score})
        if best is None or score < best[2]:
            best = (params, part, score)
    return best[0], best[1], rows


def select_chain_fusion(part, launch_overhead_cycles: float = 32.0,
                        ) -> tuple[bool, dict]:
    """Cycle-model chain sweep: chained (one launch per chain, streamed
    intermediates) vs per-instruction execution, each charged
    ``launch_overhead_cycles`` per kernel launch.  Returns ``(pin chained?,
    score rows)`` — no chains means nothing to pin."""
    if part.forwarding_chains == 0:
        return False, {}
    unfused = part.pipelined_cycles \
        + launch_overhead_cycles * part.launches(chained=False)
    chained = part.chained_cycles \
        + launch_overhead_cycles * part.launches(chained=True)
    return chained < unfused, {
        "chains": part.forwarding_chains,
        "score_unfused": unfused, "score_chained": chained,
        "launches_unfused": part.launches(chained=False),
        "launches_chained": part.launches(chained=True),
    }


def predict_cycles(compiled: CompiledTMProgram,
                   fuse_chains: bool = False) -> tuple[float, float]:
    """(TMU cycles, TPU-proxy cycles) for one execution of ``compiled``.

    TMU cycles are the scheduled (forwarded) cycle model — or the REALIZED
    chained model when ``fuse_chains`` is pinned for the entry, so measured
    and predicted stay comparable; the TPU side has no microarchitectural
    model here, so its proxy is the data-movement floor — every opaque
    node's inputs+outputs through the same port."""
    p = compiled.params or CycleParams()
    tmu = (compiled.partition_report.chained_cycles if fuse_chains
           else compiled.partition_report.forwarded_cycles)
    tpu = 0.0
    for node in compiled.graph.tpu_nodes():
        elems = sum(
            _size(compiled.graph.shape(n))
            for n in tuple(node.src_names) + tuple(node.dst_names)
            if n is not None)
        tpu += elems * p.itemsize / p.bandwidth_bytes
    return tmu, tpu


def _size(shape: tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def predict_phase_cycles(compiled: CompiledTMProgram, phase,
                         fuse_chains: bool = False) -> float:
    """Cycle-model price of ONE phase — the watchdog's deadline input.

    TMU phases use their scheduled (or realized-chained) cycles; TPU phases
    use the same data-movement proxy as :func:`predict_cycles`, restricted
    to the phase's nodes."""
    if phase.kind == "tmu":
        if phase.schedule is None:
            return 0.0
        return (phase.schedule.chained_cycles if fuse_chains
                else phase.schedule.forwarded_cycles)
    p = compiled.params or CycleParams()
    nodes = compiled.graph.nodes
    if phase.kind == "fused":
        # cross-engine fused phase: the TM run's scheduled cycles plus the
        # op's data-movement proxy — pessimistic (the realized megakernel
        # never round-trips the crossing buffer), which is the safe side
        # for a watchdog deadline
        tm = 0.0 if phase.schedule is None else \
            phase.schedule.forwarded_cycles
        node = nodes[phase.xengine.eqn_index]
        elems = sum(_size(compiled.graph.shape(n))
                    for n in tuple(node.src_names) + tuple(node.dst_names)
                    if n is not None)
        return tm + elems * p.itemsize / p.bandwidth_bytes
    elems = sum(
        _size(compiled.graph.shape(n))
        for i in phase.node_indices
        for n in tuple(nodes[i].src_names) + tuple(nodes[i].dst_names)
        if n is not None)
    return elems * p.itemsize / p.bandwidth_bytes


def predict_overlap(compiled: CompiledTMProgram,
                    fuse_chains: bool = False) -> float:
    """Steady-state fraction of busy time the two-engine pipeline hides:
    serial = tmu+tpu per request, pipelined = max(tmu, tpu), hidden =
    min/(tmu+tpu) — directly comparable to the measured overlap ratio.
    With ``fuse_chains`` pinned, the TMU side uses realized (chained)
    cycles, so measured-vs-predicted comparisons see the same execution
    shape the entry actually runs."""
    tmu, tpu = predict_cycles(compiled, fuse_chains=fuse_chains)
    total = tmu + tpu
    return min(tmu, tpu) / total if total > 0 else 0.0


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _AdmittedBatch:
    """One coalesced group admitted through the compile cache, ready to
    launch.  Both schedulers consume it: the FIFO path wraps ``steps`` in a
    :class:`PipelineJob`; the continuous scheduler submits them itself (so
    it can cancel/re-queue unissued phases) — either way the run ends in
    ``TMServer._finalize``.  Step thunks are idempotent (pure writes into
    ``env``), which is what makes a cancelled phase safely re-runnable."""

    batch: list[Request]            # live member requests (cancelled dropped)
    n: int                          # real rows
    size: int                       # padded (power-of-two) batch height
    hit: bool                       # compile-cache hit?
    entry: CacheEntry
    env: dict                       # bound input/intermediate buffers
    phases: list                    # compiled phase DAG (partition order)
    steps: list                     # [(engine_kind, thunk)] per phase
    deps: list                      # per-phase dep indices (earlier phases)
    step_labels: list | None        # stream-event labels at "phase" detail
    label: str
    # per-phase: a cooperative launch (a fused phase on the card), busy
    # time that the overlap accounting never counts as overlapped
    step_exclusive: list | None = None
    # per-phase watchdog deadlines (seconds; None = unbounded): set only
    # for WARM executions when the watchdog is enabled
    step_timeouts: list | None = None


class TMServer:
    """Serve PyTorch functions through the TMU compile/execute stack.

    Usage::

        with TMServer(ServerConfig(max_batch=4)) as srv:
            fut = srv.submit(my_fn, x)        # batched + pipelined
            y = fut.result()                  # == my_fn(x), bit-exact
            y2 = srv(my_fn, x2)               # synchronous convenience
            print(srv.snapshot_stats())
    """

    def __init__(self, config: ServerConfig | None = None):
        self.config = config or ServerConfig()
        self.device = resolve_device(self.config.device)
        self.tracer = as_tracer(self.config.trace)
        self.stats = ServerStats()
        self.cache = CompileCache(capacity=self.config.cache_capacity)
        self._queue = BucketQueue()
        self._batcher: threading.Thread | None = None
        self._admit_pool: concurrent.futures.ThreadPoolExecutor | None = None
        # failure isolation runs on its own worker, off the engine streams
        # and the admission pool — a retry must never deadlock behind the
        # (possibly wedged) work it is recovering from.  Shut down LAST.
        self._retry_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._stopping = False
        self._started = False
        self.watchdog = None            # PhaseWatchdog when enabled
        self._outstanding = 0
        self._idle = threading.Condition()
        if self.config.scheduler == "fifo":
            self.pipeline = RequestPipeline(stats=self.stats,
                                            depth=self.config.pipeline_depth,
                                            tracer=self.tracer,
                                            device=self.device)
            self.sched = None
        else:
            # deferred import: repro_torch.sched builds on the serving primitives,
            # importing it at module scope would cycle
            from repro_torch.sched.scheduler import ContinuousScheduler, SchedConfig
            self.pipeline = None
            self.sched = ContinuousScheduler(
                SchedConfig(slots=self.config.pipeline_depth,
                            hold_s=self.config.batch_timeout_s,
                            max_batch=self.config.max_batch,
                            aging_s=self.config.aging_s,
                            preempt_margin_s=self.config.preempt_margin_s,
                            speculative=self.config.speculative),
                prepare=self._prepare, finalize=self._finalize,
                speculate=self._speculate_next,
                stats=self.stats, tracer=self.tracer, device=self.device)

    # --- lifecycle --------------------------------------------------------
    def start(self) -> "TMServer":
        if self._started:
            return self
        self._started = True
        self._stopping = False
        self._admit_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="tm-serve-admit")
        self._retry_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tm-serve-retry")
        if self.pipeline is not None:
            self.pipeline.start()
            self._batcher = threading.Thread(
                target=self._batch_loop, name="tm-serve-batcher", daemon=True)
            self._batcher.start()
        else:
            self.sched.start()
        if self.config.phase_timeout_factor > 0:
            # deferred import: repro_torch.ft imports the serving layer's
            # hosts
            from repro_torch.ft.watchdog import PhaseWatchdog
            runtime = (self.pipeline.runtime if self.pipeline is not None
                       else self.sched.runtime)
            self.watchdog = PhaseWatchdog(
                runtime, floor_s=self.config.phase_timeout_floor_s,
                factor=self.config.phase_timeout_factor,
                tracer=self.tracer, stats=self.stats)
            self.watchdog.start()
        return self

    def stop(self) -> None:
        """Drain queued work, then stop the scheduler (or batcher +
        pipeline), admission workers and both engines."""
        if not self._started:
            return
        if self.pipeline is not None:
            with self._queue.nonempty:
                self._stopping = True
                self._queue.nonempty.notify_all()
            self._batcher.join()
            self._admit_pool.shutdown(wait=True)
            self.pipeline.stop()
        else:
            self._stopping = True
            self.sched.stop()          # drains queued + in-flight groups
            self._admit_pool.shutdown(wait=True)
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        # last: isolation re-executes blocking (no streams), so failed
        # groups handed off before the drain still resolve their futures
        self._retry_pool.shutdown(wait=True)
        self._retry_pool = None
        self._started = False

    def __enter__(self) -> "TMServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- request surface --------------------------------------------------
    def submit(self, fn: Callable, *args, fn_key: str | None = None,
               priority: str | int = "interactive",
               deadline_s: float | None = None) -> concurrent.futures.Future:
        """Queue ``fn(*args)``; the future resolves to exactly its result.

        ``priority`` is a :data:`PRIORITIES` class name (or a raw rank);
        ``deadline_s`` is a relative latency target in seconds — carrying one
        escalates the request to the deadline class, which the continuous
        scheduler orders earliest-deadline-first and may preempt for.  The
        FIFO scheduler accepts both and ignores them."""
        if isinstance(priority, str):
            if priority not in PRIORITIES:
                raise ValueError(f"unknown priority {priority!r}; expected "
                                 f"one of {tuple(PRIORITIES)}")
            rank = PRIORITIES[priority]
        else:
            rank = int(priority)
        deadline = (None if deadline_s is None
                    else time.monotonic() + deadline_s)
        if deadline is not None:
            rank = PRIORITIES["deadline"]
        req = Request(fn=fn, fn_key=fn_identity(fn, fn_key), args=args,
                      future=concurrent.futures.Future(),
                      priority=rank, deadline=deadline)
        with self._idle:
            self._outstanding += 1
        # the running-state check happens under the queue lock, so a push can
        # never land after the batcher (or scheduler) observed _stopping and
        # drained
        if self.pipeline is not None:
            ok = self._queue.push(
                req, allow=lambda: self._started and not self._stopping)
        else:
            ok = self.sched.submit(req)
        if not ok:
            self._release(1)
            raise RuntimeError("server is not running (use `with TMServer()`)")
        self.stats.record_submit()
        if self.tracer.enabled:
            self.tracer.instant("request/submit", track="server",
                                fn_key=str(req.fn_key))
            # racy unlocked read — a monitoring sample must not contend
            # with the batcher on the admission lock
            self.tracer.counter("server/outstanding", self._outstanding,
                                track="server")
        return req.future

    def __call__(self, fn: Callable, *args, fn_key: str | None = None,
                 priority: str | int = "interactive",
                 deadline_s: float | None = None):
        return self.submit(fn, *args, fn_key=fn_key, priority=priority,
                           deadline_s=deadline_s).result()

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every submitted request has resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._outstanding:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0:
                    return False
                self._idle.wait(timeout=0.05 if left is None
                                else min(left, 0.05))
            return True

    def drain(self, timeout: float | None = None) -> None:
        """Like :meth:`flush`, but a timeout RAISES — with a diagnostic of
        exactly what is stuck — instead of silently returning False and
        leaving the caller to hang (or guess) at :meth:`stop`.

        :class:`DrainTimeoutError` lists the outstanding request count and
        every undone stream task (engine, label, running/queued, age) from
        :meth:`~repro_torch.runtime.streams.StreamRuntime.pending`."""
        if self.flush(timeout=timeout):
            return
        runtime = None
        if self.pipeline is not None:
            runtime = self.pipeline.runtime
        elif self.sched is not None:
            runtime = self.sched.runtime
        rows = runtime.pending() if runtime is not None else []
        with self._idle:
            outstanding = self._outstanding
        detail = "; ".join(
            f"{r['engine']}:{r['label'] or '<unlabelled>'} [{r['state']}] "
            f"age={r['age_s']:.2f}s" for r in rows)
        raise DrainTimeoutError(
            f"drain timed out after {timeout}s: {outstanding} request(s) "
            f"outstanding; stream backlog: "
            f"{detail or 'empty (work queued before dispatch?)'}",
            pending=rows)

    def prewarm(self, fn: Callable, *args, fn_key: str | None = None,
                height: int = 1) -> bool:
        """Speculatively pre-compile ``fn`` at batch height ``height`` (the
        stacked shape class a future micro-batch would hit), off-thread and
        de-duplicated against cached entries and in-flight misses.  Returns
        True when a compile was actually scheduled.  The compile is marked
        speculative on the cache (``speculative_compiles`` /
        ``speculative_hits`` / ``speculative_wasted``), so traffic stats can
        tell whether speculation paid for itself."""
        if not self._started or self._stopping or self._admit_pool is None:
            return False
        cfg = self.config
        size = bucket_size(height, cfg.max_batch)
        stacked = pytree.tree_map(lambda *xs: torch.stack(xs, dim=0),
                                  *([args] * size))
        key = CacheKey.for_call(fn, stacked, backend=cfg.backend, params=None,
                                fn_key=fn_identity(fn, fn_key))
        if self.cache.contains_or_inflight(key):
            return False
        if self.tracer.enabled:
            self.tracer.instant("cache/prewarm", track="server",
                                fn_key=str(key.fn_key), height=size)
        self._admit_pool.submit(
            lambda: self.cache.get_or_compile(
                key, lambda: self._build_entry(key, fn, stacked),
                speculative=True))
        return True

    def _speculate_next(self, batch: list[Request], size: int) -> None:
        """Continuous-scheduler hook, fired after dispatching a group at
        height ``size``: pre-compile the next bucket up for the same shape
        class — under rising load the next group of this class is most
        likely to land one power of two higher."""
        nxt = size * 2
        if nxt > bucket_size(self.config.max_batch, self.config.max_batch):
            return
        r = batch[0]
        try:
            self.prewarm(r.fn, *r.args, fn_key=r.fn_key, height=nxt)
        except BaseException:  # noqa: BLE001 — speculation must never fail
            pass               # the dispatch that triggered it

    def snapshot_stats(self) -> dict:
        snap = self.stats.snapshot()
        snap["cache"] = self.cache.snapshot()
        if self.sched is not None:
            snap["sched"] = self.sched.snapshot()
        return snap

    # --- batcher thread ---------------------------------------------------
    def _batch_loop(self) -> None:
        cfg = self.config
        q = self._queue
        while True:
            with q.nonempty:
                while True:
                    # a full batch anywhere dispatches immediately — never
                    # held hostage by an older partial head's timeout
                    batch = q.pop_full(cfg.max_batch)
                    if batch:
                        break
                    head, _ = q.head_info()
                    if head is None:
                        if self._stopping:
                            return
                        q.nonempty.wait(timeout=0.05)
                        continue
                    deadline = head.t_submit + cfg.batch_timeout_s
                    now = time.monotonic()
                    if now >= deadline or self._stopping:
                        batch = q.pop_bucket(cfg.max_batch)
                        break
                    q.nonempty.wait(timeout=min(deadline - now, 0.05))
            # admission (compile on miss) runs off-thread so cold shape
            # classes never stall dispatch of warm traffic
            self._admit_pool.submit(self._process_batch, batch)

    def _process_batch(self, batch: list[Request]) -> None:
        """FIFO path: admit, then hand the phase DAG to the depth-limited
        pipeline as one job."""
        prep = self._prepare(batch)
        if prep is None:
            return
        try:
            self.pipeline.submit(PipelineJob(
                steps=prep.steps, deps=prep.deps,
                on_done=lambda err: self._finalize(prep, err),
                label=prep.label, step_labels=prep.step_labels,
                step_exclusive=prep.step_exclusive,
                step_timeouts=prep.step_timeouts))
        except BaseException as e:  # noqa: BLE001 — shutdown race
            self._fail_batch(prep.batch, e, cold=not prep.hit)

    def _prepare(self, batch: list[Request]) -> _AdmittedBatch | None:
        """Admission: transition futures to RUNNING, coalesce, hit the
        compile cache, bind inputs, and build the per-phase step thunks.
        Returns None when nothing is left to run (all members cancelled, or
        a failure was already delivered to the futures)."""
        cfg = self.config
        # transition futures to RUNNING so a client cancel() can no longer
        # race set_result(); drop requests cancelled while queued
        live = []
        t_now = time.monotonic()
        for r in batch:
            if r.future.set_running_or_notify_cancel():
                live.append(r)
            else:
                self.stats.record_done(t_now - r.t_submit, cold=False,
                                       failed=True)
                self._release(1)
        batch = live
        if not batch:
            return None
        n = len(batch)
        try:
            size = bucket_size(n, cfg.max_batch)
            # default track: the admitting thread, so concurrent
            # admissions render on their own lanes
            with self.tracer.span(f"admit/{batch[0].fn_key}x{size}") as sp:
                stacked, pad = coalesce(batch, size)
                self.stats.record_batch(n, pad)
                key = CacheKey.for_call(batch[0].fn, stacked,
                                        backend=cfg.backend, params=None,
                                        fn_key=batch[0].fn_key)
                entry, hit = self.cache.get_or_compile(
                    key, lambda: self._build_entry(key, batch[0].fn, stacked))
                sp.set(requests=n, pad_rows=pad, cache_hit=hit)
            if self.tracer.enabled:
                self.tracer.count("cache/hits" if hit else "cache/misses",
                                  track="server")
        except BaseException as e:  # noqa: BLE001 — delivered to futures
            self._fail_batch(batch, e, cold=True)
            return None
        compiled = entry.compiled
        try:
            env = compiled.bind_inputs(*stacked)
        except BaseException as e:  # noqa: BLE001
            self._fail_batch(batch, e, cold=not hit)
            return None
        # the compiled phase DAG maps 1:1 onto pipeline steps: each phase
        # goes to its engine's stream, synchronized only at its data
        # in-edges — independent phases of this batch overlap, and the
        # streams interleave this batch's phases with other admitted batches
        phases = compiled.partition_report.phases
        # at the default "phase" trace detail the stream event's span IS the
        # phase span: the steps are labelled ``phase/{index}/{kind}`` so the
        # engine-lane busy interval (recorded once, after the event's t_end
        # is stamped) doubles as the phase timing, and run_phase itself runs
        # untraced — one record per phase is what keeps tracing inside the
        # overhead gate.  "instr" detail flips both: run_phase traces the
        # rich per-instruction spans on the worker thread, and the stream
        # labels keep the batch identity instead.
        detail = self.tracer.detail if self.tracer.enabled else None
        # queue delay (admit -> first phase START) is stamped exactly once
        # per group, by whichever phase thunk an engine issues first — it is
        # the pure scheduling cost, measured per member request
        first_start = [True]
        start_lock = threading.Lock()

        def mark_started() -> None:
            with start_lock:
                if not first_start[0]:
                    return
                first_start[0] = False
            t = time.monotonic()
            for r in batch:
                self.stats.record_queue_delay(t - r.t_submit)

        # watchdog deadlines: every phase execution calibrates the
        # seconds-per-cycle estimate; deadlines attach to WARM runs only
        # (a cold run includes tracing and would false-trip the monitor)
        wd = self.watchdog
        pred = None
        if wd is not None:
            pred = entry.phase_cycle_pred
            if pred is None:
                pred = tuple(predict_phase_cycles(compiled, p,
                                                  entry.fuse_chains)
                             for p in phases)
                entry.phase_cycle_pred = pred
        step_timeouts = ([wd.deadline_for(c) for c in pred]
                         if wd is not None and hit else None)

        def make_step(ph, pred_cycles):
            def run():
                mark_started()
                t0 = time.monotonic()
                out = self._run_phase(compiled, ph, env, entry,
                                      traced=detail == "instr")
                if wd is not None and pred_cycles:
                    # the wall of the phase's work: on the card the stream
                    # waits for it after run() returns, so this is its
                    # host issue time there, a lower bound of the wall
                    wd.calibrate(pred_cycles, time.monotonic() - t0)
                return out
            return run

        steps = [(phase.engine,
                  make_step(phase, pred[i] if pred is not None else 0.0))
                 for i, phase in enumerate(phases)]
        deps = [phase.deps for phase in phases]
        step_labels = ([f"phase/{p.index}/{p.kind}" for p in phases]
                       if detail == "phase" else None)
        on_card = self.device.type == "cuda" and entry.backend == "cuda"
        step_exclusive = [on_card and p.kind == "fused" for p in phases]
        return _AdmittedBatch(batch=batch, n=n, size=size, hit=hit,
                              entry=entry, env=env, phases=phases,
                              steps=steps, deps=deps, step_labels=step_labels,
                              label=f"{batch[0].fn_key}x{size}",
                              step_exclusive=step_exclusive,
                              step_timeouts=step_timeouts)

    def _finalize(self, prep: _AdmittedBatch,
                  err: BaseException | None) -> None:
        """Completion: split outputs, resolve futures, record latencies —
        fires exactly once per admitted group, from either scheduler."""
        t_end = time.monotonic()
        batch, hit = prep.batch, prep.hit
        parts: list = []
        if err is None:
            try:
                outs = prep.entry.compiled.outputs_from(prep.env)
                if self.device.type == "cuda":
                    # made on the engine streams, read by the clients on
                    # the default stream
                    stream = torch.cuda.default_stream(self.device)
                    for t in pytree.tree_leaves(outs):
                        t.record_stream(stream)
                parts = split(outs, prep.n)
            except BaseException as e:  # noqa: BLE001 — futures must
                err = e                 # resolve no matter what
        if err is not None:
            # failed group: hand off to bisect-retry isolation (or fail
            # whole when isolation is off) — futures resolve there
            self._fail_batch(batch, err, cold=not hit)
            return
        for r, res in zip(batch, parts):
            r.future.set_result(res)
            self.stats.record_done(t_end - r.t_submit, cold=not hit)
        if self.tracer.enabled:
            # one span per request on the requests track: submit ->
            # respond, the client-visible latency
            for r in batch:
                self.tracer.add_span(
                    f"request/{r.fn_key}", "requests",
                    r.t_submit, t_end, overlap_ok=True,
                    cold=not hit, ok=True)
        self._release(prep.n)

    def _run_phase(self, compiled: CompiledTMProgram, phase, env: dict,
                   entry: CacheEntry, traced: bool = False) -> list:
        # ``traced`` only at Tracer(detail="instr"): the default phase-level
        # timing comes from the stream event's span (see _process_batch)
        cfg = self.config
        tracer = self.tracer if traced else None
        backend = entry.degraded_phases.get(phase.index, entry.backend)
        try:
            compiled.run_phase(phase, env, backend=backend,
                               fuse_chains=(entry.fuse_chains
                                            and backend == entry.backend),
                               exact=cfg.exact, tracer=tracer,
                               quarantine=entry.quarantine)
        except Exception as e:  # noqa: BLE001 — degradation ladder below
            if phase.kind != "tmu" or self.device.type == "cuda":
                # TPU phases have no alternative backend to fall to, and on
                # the card a failing kernel fails the request
                raise
            err: Exception = e
            for rung in cfg.degrade_backends:
                if rung == backend:
                    continue
                try:
                    # phase thunks are pure writes into env, so the retry
                    # simply overwrites whatever the failed attempt left
                    compiled.run_phase(phase, env, backend=rung,
                                       fuse_chains=False, exact=cfg.exact,
                                       tracer=tracer,
                                       quarantine=entry.quarantine)
                except Exception as e2:  # noqa: BLE001 — next rung
                    err = e2
                    continue
                # memoize: warm traffic on this entry runs the working
                # rung directly instead of re-failing the preferred one
                entry.degraded_phases[phase.index] = rung
                self.stats.record_degraded_phase()
                _LOG.warning(
                    "phase %d of %r degraded from backend %r to %r: %s",
                    phase.index, str(entry.key.fn_key), backend, rung, e)
                if self.tracer.enabled:
                    self.tracer.instant(
                        "ft/degrade", track="server", phase=phase.index,
                        fn_key=str(entry.key.fn_key), backend=rung)
                break
            else:
                raise err
        # return the written buffers: the stream resolves them before
        # stamping the event, so busy time is realized compute, not async
        # dispatch latency
        return [env[name] for name in phase.writes]

    def _fail_batch(self, batch: list[Request], err: BaseException,
                    *, cold: bool, isolate: bool = True) -> None:
        """Deliver a group failure: to bisect-retry isolation when enabled
        (futures resolve on the retry worker), else to every member."""
        pool = self._retry_pool
        if isolate and self.config.retry_attempts > 0 and pool is not None \
                and not isinstance(err, concurrent.futures.CancelledError):
            try:
                pool.submit(self._isolate, list(batch), err)
                return
            except RuntimeError:
                pass    # pool already shut down: fail directly below
        t_end = time.monotonic()
        for r in batch:
            r.future.set_exception(err)
            self.stats.record_done(t_end - r.t_submit, cold=cold, failed=True)
        self._release(len(batch))

    def _isolate(self, batch: list[Request], err: BaseException) -> None:
        """Failure isolation on the retry worker: re-execute the failed
        group bisected — whole, then halves, down to singletons — so only
        the request(s) actually poisoning it keep an error and innocents
        resolve bit-exact.  Re-execution is blocking (compile cache + direct
        ``CompiledTMProgram.run``, no streams), bounded by
        ``retry_attempts`` singleton retries with exponential backoff."""
        cfg = self.config
        self.stats.record_group_fault()
        if self.tracer.enabled:
            self.tracer.instant("ft/isolate", track="server",
                                requests=len(batch), error=type(err).__name__)
        rescued = 0
        resolved: set[int] = set()   # indices into batch, for crash safety
        index = {id(r): i for i, r in enumerate(batch)}
        try:
            stack: list[tuple[list[Request], int, BaseException]] = \
                [(list(batch), 1, err)]
            while stack:
                members, attempt, last_err = stack.pop()
                time.sleep(cfg.retry_backoff_s * (2 ** (attempt - 1)))
                self.stats.record_isolation_retry()
                try:
                    parts = self._execute_direct(members)
                except Exception as e:  # noqa: BLE001 — bisect or give up
                    if len(members) > 1:
                        mid = len(members) // 2
                        stack.append((members[:mid], attempt + 1, e))
                        stack.append((members[mid:], attempt + 1, e))
                    elif attempt < cfg.retry_attempts:
                        stack.append((members, attempt + 1, e))
                    else:
                        self._deliver(members[0], None, e, resolved, index)
                    continue
                for r, res in zip(members, parts):
                    self._deliver(r, res, None, resolved, index)
                rescued += len(members)
        except BaseException as e:  # noqa: BLE001 — isolation itself broke:
            # futures MUST still resolve or clients hang and drain deadlocks
            _LOG.exception("isolation of %d request(s) failed", len(batch))
            for i, r in enumerate(batch):
                if i not in resolved:
                    self._deliver(r, None, e, resolved, index)
        if rescued:
            self.stats.record_rescued(rescued)
        if self.tracer.enabled:
            self.tracer.instant("ft/isolated", track="server",
                                rescued=rescued,
                                victims=len(batch) - rescued)

    def _deliver(self, r: Request, result, err: BaseException | None,
                 resolved: set, index: dict) -> None:
        t = time.monotonic()
        if err is None:
            r.future.set_result(result)
            self.stats.record_done(t - r.t_submit, cold=False)
        else:
            r.future.set_exception(err)
            self.stats.record_done(t - r.t_submit, cold=False, failed=True)
            self.stats.record_victims(1)
        resolved.add(index[id(r)])
        self._release(1)

    def _execute_direct(self, members: list[Request]):
        """Blocking re-execution of ``members`` as one coalesced group:
        same compile cache, same entry config — so a rescued result is
        bit-exact with the non-faulted serving path — but no streams (this
        runs on the retry worker, possibly after the engines stopped)."""
        cfg = self.config
        size = bucket_size(len(members), cfg.max_batch)
        stacked, _ = coalesce(members, size)
        key = CacheKey.for_call(members[0].fn, stacked, backend=cfg.backend,
                                params=None, fn_key=members[0].fn_key)
        entry, _ = self.cache.get_or_compile(
            key, lambda: self._build_entry(key, members[0].fn, stacked))
        outs, _ = entry.compiled.run(
            *stacked, backend=entry.backend, fuse_chains=entry.fuse_chains,
            exact=cfg.exact, quarantine=entry.quarantine)
        return split(outs, len(members))

    def _sync(self) -> None:
        """Wait for the work this thread queued on the card (a probe's
        clock stops after it)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _release(self, n: int) -> None:
        with self._idle:
            self._outstanding -= n
            self._idle.notify_all()

    # --- admission: compile + per-entry config selection ------------------
    def _build_entry(self, key: CacheKey, fn: Callable,
                     stacked_args: tuple) -> CacheEntry:
        cfg = self.config
        t0 = time.perf_counter()
        compiled = tm_compile(torch.func.vmap(fn), *stacked_args,
                              tracer=self.tracer)
        selection: dict = {}
        if cfg.select_config:
            params, part, rows = select_cycle_params(
                compiled.graph, cfg.segment_candidates,
                cfg.launch_overhead_cycles)
            scratch = allocate(compiled.graph, part, params)
            compiled = dataclasses.replace(
                compiled, partition_report=part, scratch_plan=scratch,
                params=params)
            selection["segment_bytes"] = {
                "winner": params.segment_bytes, "sweep": rows}
        backend = cfg.backend
        if cfg.backend_candidates:
            walls: dict[str, float] = {}
            for cand in dict.fromkeys(cfg.backend_candidates):
                t = time.perf_counter()
                compiled.run(*stacked_args, backend=cand)
                self._sync()
                walls[cand] = time.perf_counter() - t
            backend = min(walls, key=walls.get)
            selection["backend_probe_s"] = walls
        # the degradation ladder's quarantine runs on the CPU only
        quarantine: set | None = set() if self.device.type == "cpu" else None
        fuse_chains = False
        if cfg.select_chaining and backend == "cuda":
            fuse_chains, rows = select_chain_fusion(
                compiled.partition_report, cfg.launch_overhead_cycles)
            if fuse_chains:
                # the chain registry may decline chains the model counted
                # (unsupported link, the budget kept from the JAX package,
                # mixed fills); probe one chained execution and pin only
                # what actually realizes, so the predicted overlap
                # describes the shape that runs
                _, reps = compiled.run(*stacked_args, backend="cuda",
                                       fuse_chains=True)
                rows["realized_chains"] = sum(r.chain_count() for r in reps)
                fuse_chains = rows["realized_chains"] > 0
            selection["fuse_chains"] = {"winner": fuse_chains, **rows}
        cross_engine = False
        # exact mode runs every crossing split: nothing to probe
        if cfg.select_xengine and backend == "cuda" and not cfg.exact:
            part_x = partition(compiled.graph, compiled.params,
                               cross_engine=True)
            if part_x.xengine_phases:
                removed = sum(r.get("launches_removed", 0)
                              for r in part_x.xengine_rows)
                rows = {"xengine_phases": part_x.xengine_phases,
                        "saved_bytes": part_x.xengine_saved_bytes,
                        "saved_cycles": part_x.xengine_saved_cycles,
                        "launches_removed": removed}
                modeled = (part_x.xengine_saved_cycles
                           + cfg.launch_overhead_cycles * removed)
                rows["score_gain"] = modeled
                if modeled > 0:
                    # the lowering may still decline a modeled crossing
                    # (pullback geometry, the budget): probe one execution
                    # and pin the crossing partition only when a megakernel
                    # actually realized, exactly like the chain sweep
                    candidate = dataclasses.replace(
                        compiled, partition_report=part_x,
                        scratch_plan=allocate(compiled.graph, part_x,
                                              compiled.params))
                    _, reps = candidate.run(
                        *stacked_args, backend="cuda",
                        fuse_chains=fuse_chains, quarantine=quarantine)
                    crossings = [r for rep in reps for r in rep.records
                                 if r.opcode == "xchain"
                                 or (r.reason or "").startswith(
                                     "cross-engine")]
                    realized = sum(
                        1 for r in crossings
                        if (r.path or "").startswith("cuda.xchain"))
                    rows["realized_crossings"] = realized
                    rows["crossing_paths"] = [r.path for r in crossings]
                    rows["declined"] = sorted({r.reason for r in crossings
                                               if r.reason})
                    if realized:
                        compiled = candidate
                        cross_engine = True
                selection["cross_engine"] = {"winner": cross_engine, **rows}
        # predicted overlap must describe the execution shape the entry pins
        # (chained segment counts when chaining won the sweep)
        overlap = predict_overlap(compiled, fuse_chains=fuse_chains)
        self.stats.record_predicted_overlap(overlap)
        selection["predicted_overlap"] = overlap
        return CacheEntry(key=key, fn=fn, compiled=compiled, backend=backend,
                          params=compiled.params, fuse_chains=fuse_chains,
                          cross_engine=cross_engine, selection=selection,
                          quarantine=quarantine,
                          compile_s=time.perf_counter() - t0)
