"""The port's continuous scheduler (``repro_torch.sched``) against the JAX
package's, on the CPU: the twin of ``tests/test_sched.py``.

Stream-level cancellation and front submission, the scheduler's policy
units, continuous admission through ``TMServer``, a deterministic
preempt -> resume on every backend, a mixed-priority soak, the load
generator (seeded replays equal to the JAX package's) and speculative
compile accounting.  Every served result is held against the JAX
package's direct call on the same numpy input, bit-exact (it is data
movement).  Every wait carries a timeout.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.sched import arrival_times as jarrival_times  # noqa: E402
from repro.sched import generate as jgenerate  # noqa: E402
from repro.sched import LoadSpec as JLoadSpec  # noqa: E402
from repro_torch.core.executor import BACKENDS  # noqa: E402
from repro_torch.runtime.streams import StreamRuntime  # noqa: E402
from repro_torch.sched import (ContinuousScheduler, LoadSpec,  # noqa: E402
                               Priority, SchedConfig, arrival_times,
                               generate, run_load)
from repro_torch.serving import (CacheKey, CompileCache,  # noqa: E402
                                 ServerConfig, TMServer)
from repro_torch.serving.batcher import Request  # noqa: E402
from repro_torch.serving.server import PRIORITIES  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

CPU = "cpu"
WAIT = 300


# module-level so every request shares one fn identity (one cache lineage);
# the server serves torch.func.vmap(fn), so fn sees the UNBATCHED (h, w) arg
def _tm_fn(x):
    h = x.permute(1, 0)
    h = torch.flip(h, dims=(0,))
    return torch.nn.functional.pad(h, (0, 0, 1, 1))


def _jax_tm_fn(x):
    h = jnp.transpose(x, (1, 0))
    h = jnp.flip(h, axis=0)
    return jnp.pad(h, ((1, 1), (0, 0)))


def _want(x: torch.Tensor):
    """The JAX package's direct call on the same values."""
    return _jax_tm_fn(jnp.asarray(x.numpy()))


def _mk_x(rng, h=4, w=6):
    return to_torch(rng.rand(h, w).astype(np.float32))


def _call(srv, x, **kw):
    return srv.submit(_tm_fn, x, fn_key="k", **kw).result(timeout=WAIT)


def _wait_until(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.002)


# ---------------------------------------------------------------------------
# stream-level cancellation + front submission
# ---------------------------------------------------------------------------

def test_try_cancel_unissued_task_never_runs():
    ran = []
    seen = []
    with StreamRuntime(observer=seen.append, device=CPU) as rt:
        gate = threading.Event()
        blocker = rt.submit("tmu", lambda: gate.wait(timeout=30))
        queued = rt.submit("tmu", lambda: ran.append(1))
        assert rt.try_cancel(queued)
        gate.set()
        blocker.wait(timeout=30)
        assert rt.synchronize(timeout=30)
    assert not ran                      # the cancelled task never executed
    assert queued.cancelled and not queued.done
    assert queued.t_start is None       # stamped no busy interval
    # cancelled events never reach the observer (no phantom stats samples)
    assert all(ev is not queued for ev in seen)


def test_try_cancel_issued_or_done_task_fails():
    with StreamRuntime(device=CPU) as rt:
        started = threading.Event()
        gate = threading.Event()

        def task():
            started.set()
            gate.wait(timeout=30)

        ev = rt.submit("tpu", task)
        assert started.wait(timeout=30)
        assert not rt.try_cancel(ev)    # already issued: runs to completion
        gate.set()
        ev.wait(timeout=30)
        assert not rt.try_cancel(ev)    # done: nothing to cancel
    assert ev.done and not ev.cancelled


def test_cancelled_dependency_blocks_dependent_forever_until_resubmit():
    """A dependent of a cancelled event must not run — resubmission with a
    fresh dep event is the only way forward (the resume path's contract)."""
    ran = []
    with StreamRuntime(device=CPU) as rt:
        gate = threading.Event()
        rt.submit("tmu", lambda: gate.wait(timeout=30))
        dep = rt.submit("tmu", lambda: ran.append("dep"))
        child = rt.submit("tpu", lambda: ran.append("child"), deps=[dep])
        assert rt.try_cancel(dep)
        assert rt.try_cancel(child)     # dependent is still unissued too
        gate.set()
        assert rt.synchronize(timeout=30)
        assert ran == []
        # resubmit both, remapping the edge onto the new dep event
        dep2 = rt.submit("tmu", lambda: ran.append("dep"))
        child2 = rt.submit("tpu", lambda: ran.append("child"), deps=[dep2])
        child2.wait(timeout=30)
    assert ran == ["dep", "child"]


def test_front_submission_jumps_the_backlog():
    order = []
    with StreamRuntime(device=CPU) as rt:
        gate = threading.Event()
        rt.submit("tmu", lambda: gate.wait(timeout=30))
        rt.submit("tmu", lambda: order.append("queued"))
        ev = rt.submit("tmu", lambda: order.append("front"), front=True)
        gate.set()
        ev.wait(timeout=30)
        assert rt.synchronize(timeout=30)
    assert order == ["front", "queued"]


# ---------------------------------------------------------------------------
# scheduler policy units
# ---------------------------------------------------------------------------

def test_sched_config_validation():
    with pytest.raises(ValueError):
        SchedConfig(slots=0)
    with pytest.raises(ValueError):
        SchedConfig(max_batch=0)


def test_priority_ranks_and_aging():
    assert Priority.DEADLINE < Priority.INTERACTIVE < Priority.BATCH
    sched = ContinuousScheduler(SchedConfig(aging_s=0.05),
                                prepare=lambda b: None,
                                finalize=lambda p, e: None, device=CPU)
    # a batch request gains one class per aging_s waited, floored at 0
    assert sched._eff_priority(Priority.BATCH, 0.0) == Priority.BATCH
    assert sched._eff_priority(Priority.BATCH, 0.06) == Priority.INTERACTIVE
    assert sched._eff_priority(Priority.BATCH, 0.12) == Priority.DEADLINE
    assert sched._eff_priority(Priority.BATCH, 9.99) == Priority.DEADLINE
    assert sched._eff_priority(Priority.DEADLINE, 9.99) == Priority.DEADLINE


def test_submit_when_stopped_returns_false():
    sched = ContinuousScheduler(SchedConfig(),
                                prepare=lambda b: None,
                                finalize=lambda p, e: None, device=CPU)
    req = Request(fn=_tm_fn, fn_key="k", args=(torch.zeros((2, 2)),),
                  future=concurrent.futures.Future())
    assert sched.submit(req) is False   # never started


def test_server_rejects_unknown_priority():
    with TMServer(ServerConfig(max_batch=2, device=CPU)) as srv:
        with pytest.raises(ValueError, match="unknown priority"):
            srv.submit(_tm_fn, torch.zeros((2, 3)), fn_key="k",
                       priority="urgent")
    assert set(PRIORITIES) == {"deadline", "interactive", "batch"}


# ---------------------------------------------------------------------------
# continuous admission through TMServer
# ---------------------------------------------------------------------------

def test_continuous_server_bit_exact_and_queue_delay_series():
    rng = np.random.RandomState(0)
    xs = [_mk_x(rng) for _ in range(12)]
    with TMServer(ServerConfig(scheduler="continuous", max_batch=4,
                               batch_timeout_s=0.004, device=CPU)) as srv:
        futs = [srv.submit(_tm_fn, x, fn_key="k") for x in xs]
        got = [f.result(timeout=WAIT) for f in futs]
        snap = srv.snapshot_stats()
    for g, x in zip(got, xs):
        assert_same(g, _want(x))
    # queue delay (admit -> first phase start) is its own series
    assert snap["queue_delays"] == len(xs)
    assert snap["queue_delay_p50_s"] >= 0.0
    assert snap["queue_delay_p99_s"] >= snap["queue_delay_p50_s"]
    assert snap["sched"]["grouped_requests"] == len(xs)
    assert snap["sched"]["groups"] >= 1


def test_continuous_groups_coalesce_above_one():
    """Rolling admission must actually batch: 8 same-shape requests behind
    a blocked slot dispatch as few multi-request groups, not 8 singletons."""
    rng = np.random.RandomState(1)
    with TMServer(ServerConfig(scheduler="continuous", max_batch=4,
                               batch_timeout_s=0.05, pipeline_depth=1,
                               device=CPU)) as srv:
        # occupy the single slot so the queue builds a full bucket
        gate = threading.Event()
        srv.sched.runtime.submit("tmu", lambda: gate.wait(timeout=30))
        fut = srv.submit(_tm_fn, _mk_x(rng), fn_key="k")  # rides behind
        gate.set()                                        # the blocker
        fut.result(timeout=WAIT)
        futs = [srv.submit(_tm_fn, _mk_x(rng), fn_key="k")
                for _ in range(8)]
        for f in futs:
            f.result(timeout=WAIT)
        snap = srv.snapshot_stats()
    sched = snap["sched"]
    assert sched["grouped_requests"] == 9
    assert snap["mean_batch_size"] > 1.0        # real coalescing happened


def test_fifo_scheduler_still_selectable():
    rng = np.random.RandomState(2)
    x = _mk_x(rng)
    with TMServer(ServerConfig(scheduler="fifo", max_batch=2,
                               device=CPU)) as srv:
        got = _call(srv, x)
        assert srv.sched is None and srv.pipeline is not None
    assert_same(got, _want(x))


def test_server_config_rejects_unknown_scheduler():
    with pytest.raises(ValueError, match="scheduler"):
        ServerConfig(scheduler="round-robin")


# ---------------------------------------------------------------------------
# deterministic preempt -> resume, bit-exact on every backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_preempt_then_resume_is_bit_exact(backend):
    """Force the preemption path deterministically: block both engine
    streams so a batch-class group's phases sit unissued, then submit a
    deadline request with no slack — the scheduler must cancel the victim's
    phases, park it, serve the preemptor first, and resume the victim to a
    bit-identical result."""
    rng = np.random.RandomState(3)
    xa, xb = _mk_x(rng), _mk_x(rng)
    cfg = ServerConfig(scheduler="continuous", max_batch=2,
                       batch_timeout_s=0.0, pipeline_depth=1,
                       backend=backend, preempt_margin_s=0.005, device=CPU)
    with TMServer(cfg) as srv:
        _call(srv, xa)                          # warm the compile cache
        gate = threading.Event()
        for engine in ("tmu", "tpu"):           # hold BOTH streams: nothing
            srv.sched.runtime.submit(           # the victim submits can issue
                engine, lambda: gate.wait(timeout=60))
        fut_victim = srv.submit(_tm_fn, xa, fn_key="k", priority="batch")
        sched = srv.sched
        _wait_until(lambda: sched.snapshot()["in_flight"] >= 1
                    and len(sched._running) == 1
                    and all(ev is not None
                            for ev in sched._running[0].events),
                    msg="victim launched onto the blocked streams")
        fut_pre = srv.submit(_tm_fn, xb, fn_key="k", priority="deadline",
                             deadline_s=0.001)
        _wait_until(lambda: sched.snapshot()["preemptions"] >= 1,
                    msg="deadline preemption")
        snap_mid = sched.snapshot()
        assert snap_mid["phases_cancelled"] >= 1
        assert snap_mid["parked"] == 1
        gate.set()                              # release the engines
        got_pre = fut_pre.result(timeout=WAIT)
        got_victim = fut_victim.result(timeout=WAIT)
        snap = sched.snapshot()
    assert_same(got_pre, _want(xb))
    assert_same(got_victim, _want(xa))          # resumed, bit-identical
    assert snap["preemptions"] >= 1
    assert snap["resumes"] >= 1
    assert snap["phases_resubmitted"] >= snap["phases_cancelled"] >= 1
    assert snap["parked"] == 0 and snap["in_flight"] == 0


def test_preempt_noop_when_victim_fully_issued():
    """A group whose every phase has issued cannot be preempted — preempt()
    returns 0 and the scheduler leaves it alone."""
    rng = np.random.RandomState(4)
    with TMServer(ServerConfig(scheduler="continuous", max_batch=2,
                               pipeline_depth=1, device=CPU)) as srv:
        _call(srv, _mk_x(rng))
        _wait_until(lambda: srv.sched.snapshot()["in_flight"] == 0,
                    msg="drain")
        snap = srv.sched.snapshot()
    assert snap["preemptions"] == 0 and snap["phases_cancelled"] == 0


# ---------------------------------------------------------------------------
# the soak: 4 threads x 8 requests, mixed priorities, no starvation
# ---------------------------------------------------------------------------

def test_mixed_priority_soak_no_starvation():
    n_threads, n_per_thread = 4, 8
    classes = ["deadline", "interactive", "batch"]
    cfg = ServerConfig(scheduler="continuous", max_batch=4,
                       batch_timeout_s=0.002, pipeline_depth=2,
                       preempt_margin_s=0.005, aging_s=0.02, device=CPU)
    failures: list = []
    done_by_class = {c: [] for c in classes}
    lock = threading.Lock()
    with TMServer(cfg) as srv:
        _call(srv, _mk_x(np.random.RandomState(9)))  # warm

        def client(tid):
            trng = np.random.RandomState(200 + tid)
            for i in range(n_per_thread):
                x = _mk_x(trng)
                prio = classes[(tid + i) % len(classes)]
                dl = 0.25 if prio == "deadline" else None
                t0 = time.monotonic()
                try:
                    got = _call(srv, x, priority=prio, deadline_s=dl)
                    if not np.array_equal(got.numpy(), np.asarray(_want(x))):
                        failures.append((tid, i, "output mismatch"))
                    with lock:
                        done_by_class[prio].append(time.monotonic() - t0)
                except Exception as e:  # noqa: BLE001 — collected
                    failures.append((tid, i, repr(e)))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = srv.snapshot_stats()
    assert not failures, failures[:3]
    # no starvation: every class — including every deadline-class request —
    # completed; the aging boost guarantees batch traffic drains too
    counts = {c: len(v) for c, v in done_by_class.items()}
    assert sum(counts.values()) == n_threads * n_per_thread
    assert min(counts.values()) > 0
    assert snap["sched"]["grouped_requests"] == n_threads * n_per_thread + 1
    assert snap["queue_delays"] == n_threads * n_per_thread + 1


# ---------------------------------------------------------------------------
# load generator: the same seeded schedule as the JAX package's
# ---------------------------------------------------------------------------

def test_arrival_times_poisson_and_deterministic():
    spec = LoadSpec(rate_rps=200.0, duration_s=1.0, seed=11)
    a, b = arrival_times(spec), arrival_times(spec)
    assert a == b                               # seeded replay
    assert all(t2 > t1 for t1, t2 in zip(a, a[1:]))
    assert all(0.0 <= t < spec.duration_s for t in a)
    # ~rate * duration arrivals, within loose Poisson bounds
    assert 120 < len(a) < 300
    other = arrival_times(LoadSpec(rate_rps=200.0, duration_s=1.0, seed=12))
    assert other != a                           # the seed matters
    assert a == jarrival_times(JLoadSpec(rate_rps=200.0, duration_s=1.0,
                                         seed=11))


def test_generate_mixes_sizes_priorities_and_deadlines():
    kw = dict(rate_rps=500.0, duration_s=1.0, seed=3,
              sizes=((8, 0.5), (16, 0.5)),
              priorities=(("interactive", 0.8), ("batch", 0.2)),
              deadline_s=0.1, deadline_frac=0.2)
    spec = LoadSpec(**kw)
    reqs = generate(spec)
    assert reqs == generate(spec)               # fully deterministic
    sizes = {r.size for r in reqs}
    assert sizes == {8, 16}
    with_dl = [r for r in reqs if r.deadline_s is not None]
    frac = len(with_dl) / len(reqs)
    assert 0.1 < frac < 0.3                     # ~deadline_frac of arrivals
    assert all(r.priority == "deadline" for r in with_dl)
    assert {r.priority for r in reqs} == {"deadline", "interactive", "batch"}
    jreqs = jgenerate(JLoadSpec(**kw))
    assert [(r.t_arrival, r.size, r.priority, r.deadline_s) for r in reqs] \
        == [(r.t_arrival, r.size, r.priority, r.deadline_s) for r in jreqs]


def test_load_spec_validation():
    with pytest.raises(ValueError):
        LoadSpec(rate_rps=0.0, duration_s=1.0)
    with pytest.raises(ValueError):
        LoadSpec(rate_rps=1.0, duration_s=-1.0)
    with pytest.raises(ValueError):
        LoadSpec(rate_rps=1.0, duration_s=1.0, sizes=())
    with pytest.raises(ValueError):
        LoadSpec(rate_rps=1.0, duration_s=1.0, deadline_frac=0.5)


def test_run_load_replays_schedule_open_loop():
    spec = LoadSpec(rate_rps=50.0, duration_s=0.2, seed=5)
    submitted = []
    fake_now = [0.0]

    def now():
        return fake_now[0]

    def sleep(dt):
        fake_now[0] += dt

    run_load(lambda gr: submitted.append((now(), gr)), spec,
             now=now, sleep=sleep)
    want = generate(spec)
    assert [gr for _, gr in submitted] == want
    for t, gr in submitted:                     # open loop: never early
        assert t >= gr.t_arrival - 1e-9


# ---------------------------------------------------------------------------
# speculative compile accounting
# ---------------------------------------------------------------------------

def _ck(tag):
    return CacheKey(fn_key=tag, shapes=((4, 4),), dtypes=("torch.float32",),
                    backend="fused", params=None)


class _Entry:
    def __init__(self, tag):
        self.tag = tag
        self.hits = 0
        self.demand_hits = 0


def test_cache_speculative_hit_and_waste_counters():
    cache = CompileCache(capacity=2)
    spec_key, other = _ck("spec"), _ck("other")
    cache.get_or_compile(spec_key, lambda: _Entry("s"), speculative=True)
    assert cache.speculative_compiles == 1
    assert cache.contains_or_inflight(spec_key)
    # a demand request lands on the speculative entry: a speculative HIT
    _, hit = cache.get_or_compile(spec_key, lambda: _Entry("s2"))
    assert hit and cache.speculative_hits == 1
    # a speculative entry evicted without ever serving demand is WASTED
    cache.get_or_compile(_ck("wasted"), lambda: _Entry("w"),
                         speculative=True)
    cache.get_or_compile(other, lambda: _Entry("o"))
    cache.get_or_compile(_ck("other2"), lambda: _Entry("o2"))
    assert cache.speculative_wasted >= 1
    snap = cache.snapshot()
    assert snap["speculative_compiles"] == 2
    assert snap["speculative_hits"] == 1
    assert snap["speculative_wasted"] >= 1


def test_server_prewarm_precompiles_without_serving():
    rng = np.random.RandomState(6)
    x = _mk_x(rng)
    with TMServer(ServerConfig(scheduler="continuous", max_batch=4,
                               device=CPU)) as srv:
        # height 1 = the bucket a lone demand request lands on
        assert srv.prewarm(_tm_fn, x, fn_key="k", height=1)
        _wait_until(lambda: len(srv.cache) == 1, msg="speculative compile")
        # the same class again is de-duplicated against the cached entry
        assert not srv.prewarm(_tm_fn, x, fn_key="k", height=1)
        snap = srv.snapshot_stats()
        assert snap["cache"]["speculative_compiles"] == 1
        assert snap["cache"]["speculative_hits"] == 0
        # demand traffic at the prewarmed class hits the speculative entry
        got = _call(srv, x)
        got2 = _call(srv, x)
        snap = srv.snapshot_stats()
    assert_same(got, _want(x))
    assert torch.equal(got2, got)
    assert snap["cache"]["speculative_hits"] >= 1
    assert snap["cache"]["speculative_wasted"] == 0


def test_speculative_server_prewarms_next_bucket():
    """A partial group under ``speculative=True`` triggers a pre-compile of
    the next power-of-two bucket height for the same shape class."""
    rng = np.random.RandomState(7)
    x = _mk_x(rng)
    with TMServer(ServerConfig(scheduler="continuous", max_batch=4,
                               speculative=True, device=CPU)) as srv:
        got = _call(srv, x)                               # height-1 group
        _wait_until(lambda: srv.sched.snapshot()["speculations"] >= 1,
                    msg="speculation hook")
        # the next bucket (height 2) lands in the cache without demand
        _wait_until(lambda: len(srv.cache) >= 2, msg="next-bucket compile")
        snap = srv.snapshot_stats()
    assert_same(got, _want(x))
    assert snap["cache"]["speculative_compiles"] >= 1
