"""The port's fault injection and recovery (``repro_torch.ft``) against the
JAX package's, on the CPU: the twin of ``tests/test_ft.py``.

Seeded fault plans replay identically (the port's plan and the JAX
package's fire on the same occurrences); a transiently faulted group is
bisect-retried so innocents resolve bit-exact on every backend while a
persistently poisoned request keeps its own error; a hung phase is
poisoned by the watchdog without killing its engine, alone and inside a
group that isolation then rescues; on the CPU a failing kernel path
degrades down the backend ladder and the cache entry remembers; ``drain``
surfaces a diagnostic.  Every served result is held bit-exact against the
JAX package's direct call on the same numpy inputs (data movement).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import ft as jft  # noqa: E402
from repro.runtime import fault_tolerance as jfault  # noqa: E402
from repro.runtime.streams import StreamRuntime as JStreamRuntime  # noqa: E402
from repro.ft import PhaseWatchdog as JPhaseWatchdog  # noqa: E402
from repro_torch.core.executor import BACKENDS  # noqa: E402
from repro_torch.ft import (SITES, FaultInjector, FaultPlan,  # noqa: E402
                            FaultSpec, InjectedFault, PhaseTimeoutError,
                            PhaseWatchdog, active_injector, poisson_plan)
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    Heartbeat, RestartSupervisor, StragglerDetector)
from repro_torch.runtime.streams import StreamRuntime  # noqa: E402
from repro_torch.serving import (DrainTimeoutError, PipelineJob,  # noqa: E402
                                 ServerConfig, TMServer)
from tests.test_torch_support import assert_same  # noqa: E402

CPU = "cpu"
WAIT = 120
# the batch window of the isolation tests, which need their requests in one
# group: long enough for a loaded host to submit them all, and no cost, as
# a full group dispatches at once
GROUP_S = 1.0


# module-level so every request shares one fn identity (one bucket lineage)
def _tm_fn(x):
    h = x.permute(1, 0)
    return h + 1.0


def _jax_tm_fn(x):
    return jnp.transpose(x, (1, 0)) + 1.0


def _np_args(i=0):
    return np.arange(12, dtype=np.float32).reshape(3, 4) + float(i)


def _args(i=0):
    return torch.tensor(_np_args(i))


def _want(i=0):
    """The JAX package's direct call on the same values."""
    return np.asarray(_jax_tm_fn(jnp.asarray(_np_args(i))))


def _server(**kw) -> TMServer:
    return TMServer(ServerConfig(device=CPU, **kw))


# ---------------------------------------------------------------------------
# plans + injector mechanics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(site="gpu"), dict(site="phase", mode="explode"),
    dict(site="phase", p=1.5), dict(site="phase", count=-1),
    dict(site="phase", after=-1), dict(site="phase", delay_s=-0.1)])
def test_fault_spec_validation(kw):
    with pytest.raises(ValueError):
        FaultSpec(**kw)
    with pytest.raises(ValueError):   # the JAX package refuses it too
        jft.FaultSpec(**kw)
    assert SITES == jft.SITES == ("phase", "lowering", "compile", "stream")


def _fire_trace(mod, plan_kw, n=64):
    inj = mod.FaultInjector(mod.FaultPlan(
        specs=(mod.FaultSpec(site="stream", p=0.5, count=10**9),),
        **plan_kw))
    fired = []
    for i in range(n):
        try:
            inj.fire("stream", f"tmu:job{i}")
            fired.append(0)
        except mod.InjectedFault:
            fired.append(1)
    return fired


def test_injector_probabilistic_firing_is_seed_deterministic():
    import repro_torch.ft as tft
    a, b = _fire_trace(tft, dict(seed=42)), _fire_trace(tft, dict(seed=42))
    assert a == b
    assert 0 < sum(a) < 64  # p=0.5 actually mixes
    assert _fire_trace(tft, dict(seed=43)) != a  # the seed is load-bearing
    # the same plan fires on the same occurrences as the JAX package's:
    # each spec draws from its own seeded random.Random, never global state
    assert a == _fire_trace(jft, dict(seed=42))
    import random
    random.seed(0)
    c = _fire_trace(tft, dict(seed=42))
    random.seed(1)
    assert c == _fire_trace(tft, dict(seed=42)) == a


def test_injector_installs_and_clears_all_site_hooks():
    import repro_torch.compiler.api as api
    import repro_torch.core.dispatch as dispatch
    import repro_torch.runtime.streams as streams
    import repro_torch.serving.cache as cache

    hosts = [api, dispatch, streams, cache]
    assert all(m.fault_hook is None for m in hosts)
    inj = FaultInjector(FaultPlan(specs=()))
    with inj:
        assert all(m.fault_hook == inj.fire for m in hosts)
        assert active_injector() is inj
        # one active injector at a time: overlapping installs would make
        # occurrence counts meaningless
        with pytest.raises(RuntimeError):
            FaultInjector(FaultPlan(specs=())).install()
    assert all(m.fault_hook is None for m in hosts)
    assert active_injector() is None


def test_injector_match_after_and_count():
    spec = FaultSpec(site="phase", match="tmu", mode="fail", after=1, count=2)
    inj = FaultInjector(FaultPlan(specs=(spec,)))
    inj.fire("phase", "phase/0/tpu")      # wrong label: no match
    inj.fire("phase", "phase/0/tmu")      # occurrence 0: skipped by after=1
    for _ in range(2):                    # occurrences 1..2 fire
        with pytest.raises(InjectedFault):
            inj.fire("phase", "phase/0/tmu")
    inj.fire("phase", "phase/0/tmu")      # count exhausted
    assert inj.fired == 2
    assert [m for (_, _, m) in inj.log] == ["fail", "fail"]
    snap = inj.snapshot()
    assert snap["per_site"] == {"phase": 2}
    assert snap["specs"][0]["seen"] == 4


def test_injector_hang_released_by_uninstall():
    spec = FaultSpec(site="stream", mode="hang", count=1, delay_s=30.0)
    inj = FaultInjector(FaultPlan(specs=(spec,)))
    inj.install()
    t0 = time.monotonic()
    done = threading.Event()

    def hangs():
        inj.fire("stream", "tmu:x")
        done.set()

    t = threading.Thread(target=hangs, daemon=True)
    t.start()
    time.sleep(0.05)
    inj.uninstall()                       # releases every in-flight hang
    assert done.wait(timeout=5.0)
    assert time.monotonic() - t0 < 5.0


def test_poisson_plan_matches_the_jax_package():
    plan, jplan = poisson_plan(5, 0.05), jft.poisson_plan(5, 0.05)
    assert [(s.site, s.mode, s.p, s.count) for s in plan.specs] == \
        [(s.site, s.mode, s.p, s.count) for s in jplan.specs]
    with pytest.raises(ValueError):
        poisson_plan(0, 0.0)


# ---------------------------------------------------------------------------
# liveness primitives (fault_tolerance.py), against the JAX package's
# ---------------------------------------------------------------------------

def test_heartbeat_beat_and_stall_with_fake_clock():
    now = [0.0]
    for cls in (Heartbeat, jfault.Heartbeat):
        now[0] = 0.0
        hb = cls(deadline_s=10.0, clock=lambda: now[0])
        assert not hb.stalled()
        now[0] = 9.0
        assert not hb.stalled() and hb.seconds_since_beat() == 9.0
        now[0] = 11.0
        assert hb.stalled()
        hb.beat()
        assert not hb.stalled() and hb.seconds_since_beat() == 0.0


def test_straggler_detector_warmup_then_flags_outliers():
    det, jdet = StragglerDetector(threshold=2.0), \
        jfault.StragglerDetector(threshold=2.0)
    samples = (5.0, 0.1, 0.1) + (0.1,) * 5
    # warmup: the first three samples (compile steps) never flag
    assert [det.record(s) for s in samples] == \
        [jdet.record(s) for s in samples] == [False] * 8
    mean = det.mean
    assert mean == jdet.mean
    assert det.record(mean * 10)        # a 10x outlier flags
    assert det.flagged == 1
    assert det.mean > mean              # and still folds into the EWMA


def test_restart_supervisor_bounded_restarts():
    calls = []

    def loop(step, state):
        calls.append(step)
        if len(calls) < 3:
            raise RuntimeError("node lost")
        return "done"

    sup = RestartSupervisor(max_restarts=3)
    assert sup.run(loop, lambda: (0, None)) == "done"
    assert sup.restarts == 2
    sup2 = RestartSupervisor(max_restarts=1)
    with pytest.raises(RuntimeError):
        sup2.run(lambda *a: (_ for _ in ()).throw(RuntimeError("x")),
                 lambda: (0, None))
    assert sup2.restarts == 2


# ---------------------------------------------------------------------------
# watchdog over a raw runtime
# ---------------------------------------------------------------------------

def test_watchdog_poisons_hung_task_and_stream_survives():
    with StreamRuntime(device=CPU) as rt:
        wd = PhaseWatchdog(rt, floor_s=0.1, poll_s=0.005)
        with wd:
            ev = rt.submit("tmu", lambda: time.sleep(3.0), label="hung",
                           timeout_s=0.15)
            with pytest.raises(PhaseTimeoutError):
                ev.wait(timeout=5.0)
            assert ev.done and isinstance(ev.error, PhaseTimeoutError)
            # the replaced worker keeps the stream serving
            ev2 = rt.submit("tmu", lambda: 42, label="next")
            assert ev2.wait(timeout=5.0) == 42
        assert wd.timeouts == 1 and len(wd.poisoned_at) == 1
        snap = wd.snapshot()
        assert snap["timeouts"] == 1 and not snap["stalled"]


def test_poisoned_task_hung_in_the_stream_hook_never_runs():
    """A hang at the stream site fires before the task's work: once the
    watchdog poisons it, the disowned worker must not run ``fn`` when the
    hang ends (on the card: it must launch nothing)."""
    ran = threading.Event()
    plan = FaultPlan(specs=(FaultSpec(site="stream", match="hung",
                                      mode="hang", delay_s=0.6),))
    with StreamRuntime(device=CPU) as rt:
        with PhaseWatchdog(rt, floor_s=0.1, poll_s=0.005):
            with FaultInjector(plan):
                ev = rt.submit("tmu", ran.set, label="hung", timeout_s=0.1)
                with pytest.raises(PhaseTimeoutError):
                    ev.wait(timeout=5.0)
                assert rt.submit("tmu", lambda: 7).wait(timeout=5.0) == 7
                time.sleep(0.8)   # the hang has ended by now
    assert not ran.is_set()


def test_watchdog_calibration_scales_deadlines():
    with StreamRuntime(device=CPU) as rt, JStreamRuntime() as jrt:
        wd = PhaseWatchdog(rt, floor_s=0.01, factor=10.0)
        jwd = JPhaseWatchdog(jrt, floor_s=0.01, factor=10.0)
        assert wd.deadline_for(1000.0) == 0.01      # floor until calibrated
        for w in (wd, jwd):
            w.calibrate(1000.0, 0.5)                # 0.5 ms/cycle
            w.calibrate(1000.0, 0.25)               # EWMA
        assert wd.deadline_for(1000.0) == pytest.approx(
            jwd.deadline_for(1000.0))
        assert wd.s_per_cycle == pytest.approx(0.8 * 5e-4 + 0.2 * 2.5e-4)
        assert wd.deadline_for(0.0) == 0.01         # unpriced: floor


def test_stream_callback_errors_are_counted_not_printed(capsys):
    with StreamRuntime(device=CPU) as rt:
        ev = rt.submit("tmu", lambda: 1, label="cb")

        def bad_callback(event):
            raise RuntimeError("callback bug")

        ev.add_done_callback(bad_callback)
        assert ev.wait(timeout=5.0)
        deadline = time.monotonic() + 5.0
        while rt.callback_errors() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert rt.callback_errors() == 1
    out = capsys.readouterr()
    assert "callback bug" not in out.out + out.err  # logging, not stdout


# ---------------------------------------------------------------------------
# pipeline job plumbing + config
# ---------------------------------------------------------------------------

def test_pipeline_job_step_timeouts_length_validated():
    with pytest.raises(ValueError):
        PipelineJob(steps=[("tmu", lambda: 1), ("tpu", lambda: 2)],
                    on_done=lambda e: None, step_timeouts=[0.1])


@pytest.mark.parametrize("kw", [dict(retry_attempts=-1),
                                dict(phase_timeout_factor=-0.5),
                                dict(degrade_backends=("warp",))])
def test_server_config_ft_knob_validation(kw):
    with pytest.raises(ValueError):
        ServerConfig(**kw)


# ---------------------------------------------------------------------------
# failure isolation through TMServer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_bisect_retry_rescues_innocents_bit_exact(backend):
    """A count=3 phase fault fails the group execution, the whole-group
    retry AND one half — forcing a real bisect — yet every request resolves
    bit-exact and nothing is a victim.  The fault targets the compute
    phase: a faulted TM phase would be absorbed by the backend ladder first,
    never reaching isolation."""
    plan = FaultPlan(specs=(FaultSpec(site="phase", match="tpu",
                                      mode="fail", count=3),), seed=3)
    with _server(max_batch=4, batch_timeout_s=GROUP_S, backend=backend,
                 retry_attempts=2) as srv:
        with FaultInjector(plan) as inj:
            futs = [srv.submit(_tm_fn, _args(i)) for i in range(4)]
            res = [f.result(timeout=WAIT) for f in futs]
        snap = srv.snapshot_stats()
    assert inj.fired == 3
    for i, r in enumerate(res):
        assert_same(r, _want(i))
    assert snap["group_faults"] >= 1
    assert snap["isolation_retries"] >= 3   # group + at least half + half
    assert snap["rescued_requests"] == 4
    assert snap["victim_requests"] == 0


def test_poisoned_request_is_the_only_victim():
    def _poison_fn(x):
        raise ValueError("poisoned request")

    with _server(max_batch=4, batch_timeout_s=0.02, retry_attempts=2) as srv:
        victim = srv.submit(_poison_fn, _args(0), fn_key="poison")
        good = [srv.submit(_tm_fn, _args(i)) for i in range(4)]
        for i, f in enumerate(good):
            assert_same(f.result(timeout=WAIT), _want(i))
        with pytest.raises(ValueError, match="poisoned request"):
            victim.result(timeout=WAIT)
        snap = srv.snapshot_stats()
    assert snap["victim_requests"] == 1
    assert snap["failed"] == 1


def test_persistent_fault_bounds_retries_and_server_recovers():
    plan = FaultPlan(
        specs=(FaultSpec(site="phase", mode="fail", count=10**9),), seed=4)
    with _server(max_batch=4, batch_timeout_s=0.05, retry_attempts=1) as srv:
        with FaultInjector(plan):
            futs = [srv.submit(_tm_fn, _args(i)) for i in range(4)]
            for f in futs:
                with pytest.raises(InjectedFault):
                    f.result(timeout=WAIT)
        # injector gone: the same server serves again
        assert_same(srv(_tm_fn, _args()), _want())
        snap = srv.snapshot_stats()
    assert snap["victim_requests"] == 4
    assert snap["group_faults"] >= 1
    # bounded: one group run, then per request at most retry_attempts
    # re-executions of its singleton after the bisect (4 + 2 + 1 here)
    assert snap["isolation_retries"] <= 1 + 2 + 4


@pytest.mark.parametrize("scheduler,retry", [("fifo", 2), ("continuous", 0)])
def test_stream_fault_isolation_on_and_off(scheduler, retry):
    """One stream fault: with isolation on (the FIFO scheduler's path)
    every request is rescued bit-exact; with it off the group fails whole
    and isolation never engages."""
    plan = FaultPlan(specs=(FaultSpec(site="stream", mode="fail", count=1),),
                     seed=9 if retry else 11)
    with _server(max_batch=4, batch_timeout_s=GROUP_S, scheduler=scheduler,
                 retry_attempts=retry) as srv:
        with FaultInjector(plan):
            futs = [srv.submit(_tm_fn, _args(i)) for i in range(4)]
            if retry:
                res = [f.result(timeout=WAIT) for f in futs]
            else:
                for f in futs:
                    with pytest.raises(InjectedFault):
                        f.result(timeout=WAIT)
        snap = srv.snapshot_stats()
    if retry:
        for i, r in enumerate(res):
            assert_same(r, _want(i))
        assert snap["rescued_requests"] == 4 and snap["victim_requests"] == 0
    else:
        assert snap["group_faults"] == 0    # isolation never engaged
        assert snap["failed"] == 4


# ---------------------------------------------------------------------------
# watchdog through TMServer
# ---------------------------------------------------------------------------

def test_server_config_ft_options_are_ported():
    cfg = ServerConfig(device=CPU, phase_timeout_factor=5.0, exact=True)
    assert cfg.phase_timeout_factor == 5.0 and cfg.exact
    with TMServer(ServerConfig(device=CPU)) as srv:
        assert srv.watchdog is None          # factor 0: no watchdog
    srv = TMServer(cfg).start()
    try:
        assert srv.watchdog is not None
    finally:
        srv.stop()
    assert srv.watchdog is None              # stopped with the server


def test_hung_phase_times_out_and_engine_keeps_serving():
    x = _args()
    with _server(max_batch=1, batch_timeout_s=0.0, retry_attempts=0,
                 phase_timeout_factor=5.0, phase_timeout_floor_s=0.15) as srv:
        assert srv.watchdog is not None
        assert_same(srv(_tm_fn, x), _want())           # warm the entry
        plan = FaultPlan(specs=(FaultSpec(site="stream", mode="hang",
                                          count=1, delay_s=10.0),), seed=7)
        with FaultInjector(plan):
            fut = srv.submit(_tm_fn, x)
            with pytest.raises(PhaseTimeoutError):
                fut.result(timeout=WAIT)
        # the poisoned worker was replaced: same server, same entry, served
        assert_same(srv(_tm_fn, x), _want())
        snap = srv.snapshot_stats()
        wd = srv.watchdog.snapshot()
    assert snap["phase_timeouts"] == 1
    assert wd["timeouts"] == 1
    assert wd["s_per_cycle"] is not None   # phase walls calibrated it


def test_hung_group_is_rescued_when_isolation_on():
    with _server(max_batch=2, batch_timeout_s=GROUP_S, retry_attempts=2,
                 phase_timeout_factor=5.0, phase_timeout_floor_s=0.15) as srv:
        # warm the HEIGHT-2 class: deadlines attach to warm hits only
        warm = [srv.submit(_tm_fn, _args(i)) for i in range(2)]
        [f.result(timeout=WAIT) for f in warm]
        plan = FaultPlan(specs=(FaultSpec(site="stream", mode="hang",
                                          count=1, delay_s=10.0),), seed=8)
        with FaultInjector(plan):
            futs = [srv.submit(_tm_fn, _args(i)) for i in range(2)]
            res = [f.result(timeout=WAIT) for f in futs]
        snap = srv.snapshot_stats()
    for i, r in enumerate(res):
        assert_same(r, _want(i))
    assert snap["phase_timeouts"] >= 1
    assert snap["rescued_requests"] >= 2 and snap["victim_requests"] == 0


# ---------------------------------------------------------------------------
# degradation ladder + quarantine (the CPU only)
# ---------------------------------------------------------------------------

def test_phase_ladder_degrades_and_memoizes():
    x = _args()
    plan = FaultPlan(specs=(FaultSpec(site="phase", match="tmu",
                                      mode="fail", count=1),), seed=5)
    with _server(max_batch=1, batch_timeout_s=0.0, backend="cuda",
                 retry_attempts=0) as srv:
        assert_same(srv(_tm_fn, x), _want())   # warm on the cuda backend
        with FaultInjector(plan):
            assert_same(srv(_tm_fn, x), _want())
        snap = srv.snapshot_stats()
        memo = [srv.cache.get(k).degraded_phases for k in srv.cache.keys()]
    assert snap["degraded_phases"] >= 1
    assert snap["failed"] == 0          # the ladder absorbed the fault
    assert any(m for m in memo)         # the working rung is pinned


def test_lowering_quarantine_survives_injected_kernel_failure():
    x = _args()
    plan = FaultPlan(specs=(FaultSpec(site="lowering", mode="fail",
                                      count=1),), seed=6)
    with _server(max_batch=1, batch_timeout_s=0.0, backend="cuda",
                 retry_attempts=0) as srv:
        assert_same(srv(_tm_fn, x), _want())   # warm on the cuda backend
        with FaultInjector(plan) as inj:
            assert_same(srv(_tm_fn, x), _want())
        quarantined = [srv.cache.get(k).quarantine for k in srv.cache.keys()]
        # warm re-run: the quarantined rule is skipped, no new fault needed
        assert_same(srv(_tm_fn, x), _want())
        snap = srv.snapshot_stats()
    assert inj.fired == 1
    assert any(q for q in quarantined)  # the failing (rule, shape) is pinned
    assert snap["failed"] == 0


# ---------------------------------------------------------------------------
# drain diagnostics
# ---------------------------------------------------------------------------

def test_drain_timeout_raises_with_pending_diagnostics():
    x = _args()
    plan = FaultPlan(specs=(FaultSpec(site="stream", mode="hang", count=1,
                                      delay_s=10.0),), seed=10)
    srv = _server(max_batch=1, batch_timeout_s=0.0, retry_attempts=0).start()
    try:
        assert_same(srv(_tm_fn, x), _want())
        with FaultInjector(plan):
            fut = srv.submit(_tm_fn, x)
            with pytest.raises(DrainTimeoutError) as exc:
                srv.drain(timeout=0.3)
            assert exc.value.pending                      # diagnostic rows
            states = {r["state"] for r in exc.value.pending}
            assert "running" in states
            assert "outstanding" in str(exc.value)
        # hang released at uninstall: the request completes and drain passes
        assert_same(fut.result(timeout=WAIT), _want())
        srv.drain(timeout=30.0)
    finally:
        srv.stop()
