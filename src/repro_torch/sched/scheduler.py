"""Continuous batching with priorities and phase-boundary preemption.

The PR-3 micro-batcher binds a batch *early*: requests are popped into a
power-of-two bucket and from then on the group is opaque — a request that
arrives a microsecond after the pop waits a full service time, and a
deadline-critical request queues behind whatever FIFO admitted first.  This
scheduler re-forms the dispatch decision *continuously*: every time a slot
frees (or the straggler window expires, or a deadline goes at-risk) it
re-scans the live queue and picks the best group **at that instant** —
requests join whichever group is forming when an engine becomes free, not
whichever group existed when they arrived.

Three mechanisms on top of rolling group formation:

* **priority classes** (:class:`Priority`): deadline(0) < interactive(1) <
  batch(2).  Within the deadline class, earliest-deadline-first; queue age
  boosts a request one class per ``aging_s`` waited so the batch class
  cannot starve.
* **phase-boundary preemption**: a compiled group runs as its phase DAG on
  the TMU/TPU streams.  Phases that have not yet *issued* can be pulled back
  from the stream queues (:meth:`~repro_torch.runtime.streams.Stream.try_cancel`);
  issued phases always run to completion — preemption happens at phase
  boundaries, never mid-kernel.  When a deadline-class request's slack drops
  below ``preempt_margin_s`` and every slot is busy, the lowest-priority
  running group is preempted: its unissued phases are cancelled and the
  group is parked; the preemptor's phases jump the stream backlog
  (``front=True``).  A parked group resumes by re-submitting exactly the
  cancelled phases — completed phases are never re-run and their results are
  carried in the bound ``env``, so a preempted-then-resumed request returns
  bit-identical outputs.
* **speculative admission**: after dispatching a partial group the scheduler
  (when enabled) asks the server to pre-compile the next power-of-two bucket
  of the same shape class through the compile cache, de-duplicated against
  cached entries and in-flight misses.

The scheduler owns its :class:`~repro_torch.runtime.streams.StreamRuntime` (events
feed the shared :class:`~repro_torch.serving.stats.ServerStats`) and drives the
server through three callbacks — ``prepare`` (admission: coalesce + compile
cache + bind, returns the per-phase step thunks), ``finalize`` (resolve
futures), ``speculate`` — so it holds no compile or serving logic itself.

Lock order (no inversions): scheduler lock → job lock → stream condvar.
Stream workers call job callbacks with no stream lock held, and job
callbacks release the job lock before touching the scheduler lock.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time
from typing import Callable

from repro_torch.runtime.streams import StreamRuntime
from repro_torch.serving.batcher import Request


class Priority:
    """Request priority classes — lower rank schedules first."""

    DEADLINE = 0
    INTERACTIVE = 1
    BATCH = 2


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Continuous-scheduler knobs (derived from ``ServerConfig``)."""

    slots: int = 2                  # concurrently in-flight groups
    hold_s: float = 0.005           # partial-group straggler window
    max_batch: int = 8              # group height cap (power of two)
    aging_s: float = 0.05           # queue age per one-class priority boost
    preempt_margin_s: float = 0.002  # deadline slack that triggers preemption
    speculative: bool = False       # pre-compile the next likely bucket

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")


@dataclasses.dataclass
class SchedStats:
    """Scheduler-side counters (guarded by the scheduler lock)."""

    submitted: int = 0
    groups: int = 0                 # dispatched groups
    grouped_requests: int = 0       # requests across dispatched groups
    preemptions: int = 0            # victim parkings
    phases_cancelled: int = 0       # unissued phases pulled back
    phases_resubmitted: int = 0     # cancelled phases re-submitted on resume
    phases_aborted: int = 0         # unissued phases cancelled because a
    #                                 sibling phase of their group failed
    resumes: int = 0                # parked groups resumed
    speculations: int = 0           # speculative pre-compiles requested
    max_queue_depth: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class _JobRun:
    """One admitted group in flight: per-phase stream events + completion
    bookkeeping, with preempt/resume at phase granularity.

    ``done[i]`` marks phase *i* complete (its results live in the bound
    ``env``); a cancelled event at slot *i* marks a phase the preemptor
    pulled back before it issued.  ``launch`` (re)submits every phase that
    is neither done nor live, remapping dependency edges onto the newest
    events — completed deps are passed as already-complete events, so the
    stream's own error propagation covers resumed phases too.
    """

    def __init__(self, sched: "ContinuousScheduler", prep):
        self.sched = sched
        self.prep = prep
        self.priority = min(r.priority for r in prep.batch)
        deadlines = [r.deadline for r in prep.batch if r.deadline is not None]
        self.deadline = min(deadlines) if deadlines else None
        self.t_submit = min(r.t_submit for r in prep.batch)
        self.lock = threading.Lock()
        self.events = [None] * len(prep.steps)
        self.done = [False] * len(prep.steps)
        self.state = "running"          # running | preempted
        self.preempt_count = 0
        self._error: BaseException | None = None

    def launch(self, front: bool = False) -> int:
        """(Re)submit every pending phase onto its engine stream; returns
        how many were *re*-submissions of previously cancelled phases."""
        resubmitted = 0
        timeouts = getattr(self.prep, "step_timeouts", None)
        exclusive = getattr(self.prep, "step_exclusive", None)
        with self.lock:
            self.state = "running"
            for i, (kind, thunk) in enumerate(self.prep.steps):
                ev = self.events[i]
                if self.done[i] or (ev is not None and not ev.cancelled):
                    continue            # complete, or still live on a stream
                if ev is not None:
                    resubmitted += 1
                # ascending order means a cancelled dep was already replaced
                # by its new event when we reach the dependent
                deps = [self.events[d] for d in self.prep.deps[i]
                        if self.events[d] is not None
                        and not self.events[d].cancelled]
                label = (self.prep.step_labels[i]
                         if self.prep.step_labels is not None
                         else f"{self.prep.label}#{i}:{kind}")
                new_ev = self.sched.runtime.submit(
                    kind, thunk, deps=deps, label=label, front=front,
                    timeout_s=(timeouts[i] if timeouts is not None
                               else None),
                    exclusive=exclusive is not None and exclusive[i])
                self.events[i] = new_ev
                new_ev.add_done_callback(
                    functools.partial(self._phase_done, i, new_ev))
        return resubmitted

    def preempt(self) -> int:
        """Pull back every not-yet-issued phase from the streams; returns
        how many were cancelled (0 = everything already issued, the group
        cannot be preempted any further)."""
        with self.lock:
            if self.state != "running":
                return 0
            cancelled = 0
            # forward phase order: once a phase is cancelled, its dependents
            # can never issue (their dep event will never complete), so
            # their try_cancel is guaranteed to succeed — the whole
            # dependent suffix comes back in one pass
            for i, ev in enumerate(self.events):
                if ev is None or self.done[i] or ev.cancelled or ev.done:
                    continue
                if self.sched.runtime.try_cancel(ev):
                    cancelled += 1
            if cancelled:
                self.state = "preempted"
                self.preempt_count += 1
            return cancelled

    def _phase_done(self, i: int, ev, _event) -> None:
        aborted = 0
        with self.lock:
            if self.events[i] is not ev:
                return                  # stale callback from a replaced event
            self.done[i] = True
            if ev.error is not None and self._error is None:
                self._error = ev.error
                # error-abort: pull back the group's unissued phases — they
                # could only burn the engines on dead (skip-with-error)
                # work.  Same forward-order guarantee as preempt(): a
                # cancelled phase's dependents can never issue, so the
                # whole dependent suffix comes back in one pass.  Cancelled
                # events never complete, so mark their slots done here —
                # the job finishes once the already-issued phases settle.
                for j, other in enumerate(self.events):
                    if other is None or self.done[j] or other.cancelled \
                            or other.done:
                        continue
                    if self.sched.runtime.try_cancel(other):
                        self.done[j] = True
                        aborted += 1
            finished = all(self.done)
            err = self._error
        if aborted:                     # job lock released first: the lock
            with self.sched._work:      # order is scheduler -> job, never
                self.sched.sstats.phases_aborted += aborted  # the reverse
        if finished:
            self.sched._job_finished(self, err)


class ContinuousScheduler:
    """Rolling admission of :class:`~repro_torch.serving.batcher.Request`s onto
    the TMU/TPU streams — see the module docstring for the policy."""

    def __init__(self, config: SchedConfig, *,
                 prepare: Callable, finalize: Callable,
                 speculate: Callable | None = None,
                 stats=None, tracer=None, device=None):
        self.config = config
        self._prepare = prepare
        self._finalize = finalize
        self._speculate = speculate
        self.stats = stats              # shared ServerStats (event ingest)
        self.tracer = tracer
        self.device = device            # the runtime's; None: the card
        self.sstats = SchedStats()
        self.runtime: StreamRuntime | None = None
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: list[Request] = []
        self._nqueued: dict = {}        # live queue membership per bucket
        self._running: list[_JobRun] = []
        self._paused: list[_JobRun] = []
        self._ready: list[tuple[_JobRun, bool]] = []   # admitted, no slot yet
        self._inflight = 0              # launched jobs occupying a slot
        self._admitting = 0             # selected groups still admitting
        self._stop_flag = True
        self._thread: threading.Thread | None = None
        self._admit_pool = None

    # --- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        import concurrent.futures
        self.runtime = StreamRuntime(observer=self._observe,
                                     tracer=self.tracer, device=self.device)
        self._admit_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="tm-sched-admit")
        with self._work:
            self._stop_flag = False
        self._thread = threading.Thread(target=self._loop,
                                        name="tm-sched-dispatch", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Drain the queue and every in-flight group, then release the
        streams."""
        if self._thread is None:
            return
        with self._work:
            self._stop_flag = True
            self._work.notify_all()
        self._thread.join()             # exits once queue + parked are empty
        self._admit_pool.shutdown(wait=True)
        with self._work:
            while self._inflight or self._admitting or self._ready:
                self._work.wait(timeout=0.05)
        self.runtime.synchronize()
        self.runtime.close()
        self.runtime = None
        self._thread = None

    def _observe(self, event) -> None:
        if self.stats is not None:
            self.stats.record_event(event)

    # --- submission -------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue one request; False when the scheduler is not running
        (the server turns that into its not-running error)."""
        with self._work:
            if self._stop_flag:
                return False
            self._queue.append(req)
            self.sstats.submitted += 1
            depth = len(self._queue)
            self.sstats.max_queue_depth = max(self.sstats.max_queue_depth,
                                              depth)
            b = req.bucket()
            cnt = self._nqueued.get(b, 0) + 1
            self._nqueued[b] = cnt
            # wake the dispatcher only when the wake can matter: the request
            # carries a deadline (preemption check), capacity is free, or
            # this arrival just completed a full group (full groups admit
            # greedily, so the dispatcher can act on it immediately).  With
            # every slot busy a partial arrival can't dispatch until a job
            # finishes — and _job_finished notifies then — so waking per
            # submit would only burn the dispatch thread's CPU against the
            # very compute the queue is waiting on
            staged = self._admitting + len(self._ready) + self._inflight
            if (req.deadline is not None or staged <= self.config.slots
                    or cnt % self.config.max_batch == 0):
                self._work.notify_all()
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.counter("sched/queue_depth", depth, track="server")
        return True

    def snapshot(self) -> dict:
        with self._work:
            snap = self.sstats.snapshot()
            snap["queue_depth"] = len(self._queue)
            snap["in_flight"] = self._inflight
            snap["admitting"] = self._admitting
            snap["ready"] = len(self._ready)
            snap["parked"] = len(self._paused)
        return snap

    # --- dispatch loop ----------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._work:
                while True:
                    now = time.monotonic()
                    actions = self._select_locked(now)
                    if actions:
                        break
                    if self._stop_flag and not self._queue \
                            and not self._paused:
                        return
                    self._work.wait(timeout=self._wait_timeout_locked(now))
            for kind, payload, front in actions:
                if kind == "group":
                    # admission (compile on miss) runs off-thread so cold
                    # shape classes never stall dispatch of warm traffic
                    self._admit_pool.submit(self._admit_and_launch, payload,
                                            front)
                else:
                    n = payload.launch(front=front)
                    with self._work:
                        self.sstats.resumes += 1
                        self.sstats.phases_resubmitted += n
                    if self.tracer is not None and self.tracer.enabled:
                        self.tracer.instant("sched/resume", track="server",
                                            label=payload.prep.label,
                                            phases=n)

    def _eff_priority(self, rank: int, age_s: float) -> int:
        """Queue-age boosted class rank (one class per ``aging_s`` waited,
        floored at the deadline class) — the anti-starvation lever."""
        if self.config.aging_s <= 0:
            return rank
        return max(0, rank - int(age_s / self.config.aging_s))

    def _req_key(self, r: Request, now: float) -> tuple:
        return (self._eff_priority(r.priority, now - r.t_submit),
                r.deadline if r.deadline is not None else math.inf,
                r.t_submit)

    def _job_key(self, job: _JobRun, now: float) -> tuple:
        return (self._eff_priority(job.priority, now - job.t_submit),
                job.deadline if job.deadline is not None else math.inf,
                job.t_submit)

    def _select_locked(self, now: float) -> list:
        """Pick the best dispatchable work at this instant, claim slots
        (preempting if a deadline is at risk), and return a list of
        ``(kind, payload, front)`` actions — empty when nothing should
        launch.  The list is usually length 1; when the best pick is a full
        group, every OTHER already-full group is claimed in the same pass
        (full groups admit greedily, and re-scanning the queue once per
        group is O(queue) each — measurable against the compute on small
        hosts)."""
        cfg = self.config
        candidates = []                 # (key, kind, payload)
        for job in self._paused:
            candidates.append((self._job_key(job, now), "resume", job, False))
        buckets: dict = {}
        for r in self._queue:
            buckets.setdefault(r.bucket(), []).append(r)
        for members in buckets.values():
            head = members[:cfg.max_batch]      # arrival order within bucket
            full = len(head) >= cfg.max_batch
            urgent = any(r.deadline is not None for r in head)
            head_t = min(r.t_submit for r in head)
            # partial groups hold for stragglers; full groups, deadline
            # carriers, expired holds and shutdown dispatch immediately
            if not (full or urgent or cfg.hold_s <= 0 or self._stop_flag
                    or now >= head_t + cfg.hold_s):
                continue
            candidates.append((min(self._req_key(r, now) for r in head),
                               "group", head, full))
        if not candidates:
            return []
        key, kind, payload, *rest = min(candidates, key=lambda c: c[0])
        front = False
        at_risk = (key[1] != math.inf
                   and key[1] - now <= cfg.preempt_margin_s)
        staged = self._admitting + len(self._ready) + self._inflight
        # capacity: a resume launches immediately, so it needs a real slot.
        # A group admits first (coalesce + cache + bind) and may run ahead
        # of a free slot — the admission work overlaps the in-flight groups'
        # compute instead of sitting in the gap between a job finishing and
        # the next one launching.  A PARTIAL group stays late-bound (one
        # admission ahead at most: holding it in the queue lets stragglers
        # still join); a FULL group's membership is fixed — nothing is
        # gained by waiting, so bursts admit greedily and the steady state
        # degenerates to the FIFO pipeline's prepared backlog (capping the
        # stage depth would re-insert a dispatcher wake + pool handoff into
        # every group's critical path once the cap is reached)
        if kind == "resume":
            # count admitting/ready too: right after a preemption the
            # preemptor occupies the freed slot as an _admitting group, and
            # resuming the victim underneath it would undo the preemption
            over = staged >= cfg.slots
        elif rest[0]:                   # full group
            over = False
        else:
            over = staged > cfg.slots
        if over:
            # past capacity: dispatch only by preempting — and only for a
            # deadline at risk (slack below the margin)
            if not at_risk or not self._preempt_victim_locked(key[0]):
                return []
            front = True                # preemptor phases jump the backlog
        elif at_risk and self._inflight >= cfg.slots:
            # admission budget remains but the engines are full: preempt
            # anyway so the deadline group's phases land on a freed slot
            # instead of queueing behind a full engine backlog
            front = self._preempt_victim_locked(key[0])
        if kind != "group":
            self._inflight += 1
            self._paused.remove(payload)
            self._running.append(payload)
            return [(kind, payload, front)]
        self._claim_group_locked(payload)
        actions = [("group", payload, front)]
        claimed = set(map(id, payload))
        for members in buckets.values():
            left = [r for r in members if id(r) not in claimed]
            while len(left) >= cfg.max_batch:
                grp, left = left[:cfg.max_batch], left[cfg.max_batch:]
                self._claim_group_locked(grp)
                actions.append(("group", grp, False))
        return actions

    def _claim_group_locked(self, payload: list[Request]) -> None:
        self._admitting += 1
        chosen = set(map(id, payload))
        self._queue = [r for r in self._queue if id(r) not in chosen]
        b = payload[0].bucket()
        left = self._nqueued.get(b, 0) - len(payload)
        if left > 0:
            self._nqueued[b] = left
        else:
            self._nqueued.pop(b, None)
        self.sstats.groups += 1
        self.sstats.grouped_requests += len(payload)

    def _preempt_victim_locked(self, preemptor_rank: int) -> bool:
        """Preempt the best victim for a deadline-risk preemptor; True when
        a slot was actually freed."""
        victim = self._pick_victim_locked(preemptor_rank)
        if victim is None:
            return False
        n = victim.preempt()            # sched lock → job lock: safe order
        if n == 0:
            return False                # fully issued; it will finish soon
        self._running.remove(victim)
        self._paused.append(victim)
        self._inflight -= 1
        self.sstats.preemptions += 1
        self.sstats.phases_cancelled += n
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant("sched/preempt", track="server",
                                victim=victim.prep.label, cancelled=n)
        return True

    def _pick_victim_locked(self, preemptor_rank: int) -> _JobRun | None:
        """Strictly-lower-priority running group, worst class first, newest
        start breaking ties (the least sunk work)."""
        cands = [j for j in self._running
                 if j.priority > preemptor_rank and j.state == "running"]
        if not cands:
            return None
        return max(cands, key=lambda j: (j.priority, j.t_submit))

    def _wait_timeout_locked(self, now: float) -> float:
        """Sleep until the next scheduling edge: a hold window expiring or
        a pending deadline crossing into the preemption margin.  A hold
        expiry only matters while a slot is free — with every slot busy the
        next edge is a job finishing (which notifies), so polling the hold
        would just time-slice CPU away from the in-flight phases."""
        t = 0.05
        if (self._queue and self.config.hold_s > 0
                and self._admitting + len(self._ready) + self._inflight
                <= self.config.slots):
            head = min(r.t_submit for r in self._queue)
            t = min(t, head + self.config.hold_s - now)
        deadlines = [r.deadline for r in self._queue
                     if r.deadline is not None]
        if deadlines:
            t = min(t, min(deadlines) - self.config.preempt_margin_s - now)
        return max(t, 0.001)

    # --- admission + completion ------------------------------------------
    def _admit_and_launch(self, reqs: list[Request], front: bool) -> None:
        try:
            prep = self._prepare(reqs)
        except BaseException:  # noqa: BLE001 — _prepare resolves futures
            prep = None        # itself; a raise here must still free the slot
        if prep is None:
            with self._work:
                self._admitting -= 1
                self._work.notify_all()
            return
        job = _JobRun(self, prep)
        launch_now = False
        with self._work:
            self._admitting -= 1
            # a front job (the preemptor path) already freed its slot by
            # parking the victim and must not wait behind anything; an
            # admitted-ahead job parks on the ready list — the finishing
            # job's own thread launches it (no cross-thread handoff in the
            # gap between one group draining and the next one issuing)
            if front or self._inflight < self.config.slots:
                self._inflight += 1
                self._running.append(job)
                launch_now = True
            else:
                self._ready.append((job, front))
            if self._queue or self._paused or self._stop_flag:
                self._work.notify_all()  # the dispatcher may select again
        if launch_now:
            job.launch(front=front)
        if (self.config.speculative and self._speculate is not None
                and prep.n < self.config.max_batch):
            with self._work:
                self.sstats.speculations += 1
            try:
                self._speculate(prep.batch, prep.size)
            except BaseException:  # noqa: BLE001 — speculation must never
                pass               # fail the dispatch that triggered it

    def _job_finished(self, job: _JobRun, err: BaseException | None) -> None:
        try:
            self._finalize(job.prep, err)
        finally:
            nxt = None
            with self._work:
                if job in self._running:
                    self._running.remove(job)
                self._inflight -= 1
                if self._ready and self._inflight < self.config.slots:
                    # best ready job by the same age-boosted EDF key the
                    # selector uses — with a deep ready backlog a FIFO pop
                    # would invert priorities for the whole backlog depth
                    now = time.monotonic()
                    idx = min(range(len(self._ready)),
                              key=lambda i: self._job_key(
                                  self._ready[i][0], now))
                    nxt, nxt_front = self._ready.pop(idx)
                    self._inflight += 1
                    self._running.append(nxt)
                # wake the dispatcher only when it has something to act on
                # (queued or parked work, or the stop-path drain wait) — an
                # unconditional notify per completion costs a context switch
                # against the remaining compute on small hosts
                if self._queue or self._paused or self._stop_flag \
                        or not self._inflight:
                    self._work.notify_all()
            if nxt is not None:
                # inline on the finishing stream thread: the freed engine
                # picks up the next admitted group without a thread wake
                nxt.launch(front=nxt_front)
