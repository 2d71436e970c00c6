"""The port's tracing (``repro_torch.obs``) against the JAX package's, on the
CPU: the twin of ``tests/test_obs.py``.

The tracer core, its integrity checks and Chrome-trace export, the stream
runtime's engine spans, a traced ``TMServer`` (its phase spans and the
overlap the trace and the stats reduce from the same intervals) and the
stats' percentiles.  Where a result is checked, both packages get the same
numpy inputs: the served data movement is bit-exact against the JAX
package's direct call, and the percentile helpers agree with the JAX
package's to the bit.  Every wait carries a timeout.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.obs import Tracer as JTracer  # noqa: E402
from repro.serving.stats import _percentile as j_percentile  # noqa: E402
from repro.serving.stats import \
    latency_percentiles as jlatency_percentiles  # noqa: E402
from repro_torch.compiler import tm_compile  # noqa: E402
from repro_torch.obs import (NULL_TRACER, NullTracer, TraceReport,  # noqa: E402
                             Tracer, as_tracer, overlap_from_trace)
from repro_torch.runtime.streams import (StreamRuntime,  # noqa: E402
                                         overlap_from_events)
from repro_torch.serving import ServerConfig, ServerStats, TMServer  # noqa: E402
from repro_torch.serving.stats import (_percentile,  # noqa: E402
                                       latency_percentiles)
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

CPU = "cpu"


def _tm_fn(x):
    h = x.permute(0, 2, 1)
    h = h * 2.0
    h = torch.flip(h, dims=(1,))
    return torch.nn.functional.pad(h, (0, 0, 1, 1))


def _jax_tm_fn(x):
    h = jnp.transpose(x, (0, 2, 1))
    h = h * 2.0
    h = jnp.flip(h, axis=1)
    return jnp.pad(h, ((0, 0), (1, 1), (0, 0)))


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------

def test_span_records_name_track_args_and_nesting():
    tr = Tracer()
    with tr.span("compile", track="t0"):
        with tr.span("compile/trace") as sp:   # inherits parent's track
            sp.set(summary="ok")
    spans = tr.spans()
    assert [s.name for s in spans] == ["compile/trace", "compile"]
    assert all(s.track == "t0" for s in spans)
    inner, outer = spans
    assert inner.depth == 1 and outer.depth == 0
    assert inner.arg("summary") == "ok"
    assert outer.t_start <= inner.t_start <= inner.t_end <= outer.t_end
    assert tr.spans(prefix="compile/") == [inner]
    assert tr.tracks() == ["t0"]


def test_add_span_and_counters():
    tr = Tracer(clock=time.monotonic)
    tr.add_span("phase/0/tmu", "tmu", 1.0, 2.0, ok=True)
    tr.count("hbm/bytes", 100.0)
    tr.count("hbm/bytes", 50.0)
    tr.counter("server/outstanding", 3.0, track="server")
    (s,) = tr.spans(track="tmu")
    assert s.duration_s == pytest.approx(1.0)
    assert s.arg("ok") is True
    assert tr.counters() == {"hbm/bytes": 150.0, "server/outstanding": 3.0}


def test_tracer_detail_validation():
    assert Tracer().detail == "phase"
    assert Tracer(detail="instr").detail == "instr"
    with pytest.raises(ValueError, match="unknown detail"):
        Tracer(detail="everything")


def test_as_tracer_normalization():
    assert as_tracer(None) is NULL_TRACER
    assert as_tracer(False) is NULL_TRACER
    fresh = as_tracer(True)
    assert isinstance(fresh, Tracer) and fresh is not NULL_TRACER
    tr = Tracer()
    assert as_tracer(tr) is tr


def test_null_tracer_records_nothing(tmp_path):
    tr = NullTracer()
    assert not tr.enabled and tr.detail == "phase"
    with tr.span("compile") as sp:
        sp.set(anything=1)
    tr.add_span("phase/0/tmu", "tmu", 0.0, 1.0)
    tr.instant("x")
    tr.count("c", 5)
    tr.counter("g", 2)
    assert tr.spans() == [] and tr.counters() == {} and tr.tracks() == []
    assert tr.nesting_errors() == []
    trace = tr.export_chrome_trace(str(tmp_path / "null.json"))
    assert trace["traceEvents"] == []


# ---------------------------------------------------------------------------
# integrity: multi-thread soak + overlap_ok
# ---------------------------------------------------------------------------

def test_four_thread_nesting_soak():
    tr = Tracer()
    n_threads, n_iters = 4, 200
    errors: list = []

    def worker(tid: int) -> None:
        try:
            for i in range(n_iters):
                with tr.span(f"outer/{tid}", track=f"w{tid}") as sp:
                    sp.set(i=i)
                    with tr.span("inner/a"):
                        pass
                    with tr.span("inner/b"):
                        tr.count(f"work/{tid}")
                # two threads share each ext track, so the windows have
                # concurrent lifetimes — the request-span shape
                tr.add_span(f"ext/{tid}", f"eng{tid % 2}",
                            tr._clock() - 1e-4, tr._clock(),
                            overlap_ok=True)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    spans = tr.spans()
    assert len(spans) == n_threads * n_iters * 4
    assert tr.nesting_errors() == []          # stack discipline + durations
    assert all(s.duration_s >= 0.0 for s in spans)
    for t in range(n_threads):
        assert len(tr.spans(track=f"w{t}")) == n_iters * 3
        assert tr.counters()[f"work/{t}"] == n_iters


def test_overlap_ok_exempt_from_stack_discipline():
    tr = Tracer()
    # two concurrent request windows on one track: legal only as overlap_ok
    tr.add_span("request/a", "requests", 0.0, 2.0, overlap_ok=True)
    tr.add_span("request/b", "requests", 1.0, 3.0, overlap_ok=True)
    assert tr.nesting_errors() == []
    tr.add_span("request/c", "requests", 2.5, 4.0)
    tr.add_span("request/d", "requests", 3.0, 5.0)
    assert any("partial overlap" in e for e in tr.nesting_errors())


def test_negative_duration_is_an_integrity_error():
    tr = Tracer()
    tr.add_span("bad", "t", 2.0, 1.0)
    assert any("negative duration" in e for e in tr.nesting_errors())


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------

def _fill(tr) -> None:
    with tr.span("compile", track="main"):
        with tr.span("compile/trace"):
            pass
    tr.add_span("phase/0/tmu", "tmu", tr.t0 + 0.001, tr.t0 + 0.002)
    tr.instant("submit", track="main", n=1)
    tr.count("tmu/launches", 3, track="counters")


def _shape(trace: dict) -> list:
    """The export without its clock readings: what two runs share."""
    return [(e["ph"], e.get("name"), e.get("tid"), e.get("args", {}).get(
        "name")) for e in trace["traceEvents"]]


def test_chrome_export_round_trip(tmp_path):
    tr = Tracer()
    _fill(tr)
    path = tmp_path / "trace.json"
    exported = tr.export_chrome_trace(str(path))
    loaded = json.loads(path.read_text())
    assert loaded == exported
    events = loaded["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    names = {e["args"]["name"] for e in meta}
    assert {"main", "tmu", "counters"} <= names
    # engines order first in the tid map
    tmu_meta = next(e for e in meta if e["args"]["name"] == "tmu")
    assert tmu_meta["tid"] == 0
    xs = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"compile", "compile/trace",
                                       "phase/0/tmu"}
    for e in xs:
        assert e["ts"] >= 0.0 and e["dur"] >= 0.0
    assert [e for e in events if e["ph"] == "i"][0]["name"] == "submit"
    c = [e for e in events if e["ph"] == "C"][0]
    assert c["name"] == "tmu/launches" and c["args"]["value"] == 3
    # events are time-sorted (metadata first at ts -1)
    ts = [e.get("ts", -1.0) for e in events]
    assert ts == sorted(ts)
    # the JAX package's tracer exports the same events for the same calls
    jtr = JTracer()
    _fill(jtr)
    assert _shape(exported) == _shape(jtr.chrome_trace())


def test_overlap_ok_spans_export_as_async_pairs():
    tr = Tracer()
    tr.add_span("request/f", "requests", tr.t0, tr.t0 + 0.5,
                overlap_ok=True, cold=True)
    tr.add_span("request/f", "requests", tr.t0 + 0.1, tr.t0 + 0.6,
                overlap_ok=True)
    events = tr.chrome_trace()["traceEvents"]
    begins = [e for e in events if e["ph"] == "b"]
    ends = [e for e in events if e["ph"] == "e"]
    assert len(begins) == 2 and len(ends) == 2
    assert {e["id"] for e in begins} == {e["id"] for e in ends}
    assert all(e["cat"] == "request" for e in begins + ends)
    assert begins[0]["args"]["cold"] is True
    assert not [e for e in events if e["ph"] == "X"]


# ---------------------------------------------------------------------------
# streams + serving integration
# ---------------------------------------------------------------------------

def test_stream_runtime_spans_match_event_overlap():
    tr = Tracer()
    with StreamRuntime(tracer=tr, device=CPU) as rt:
        ev_m = rt.submit("tmu", lambda: time.sleep(0.02), label="m0")
        rt.submit("tpu", lambda: time.sleep(0.02), label="t0")
        rt.submit("tmu", lambda: time.sleep(0.01), deps=[ev_m], label="m1")
        assert rt.synchronize(timeout=10.0)
        timeline = rt.timeline()
    # every realized event interval landed on its engine's track verbatim
    for engine in ("tmu", "tpu"):
        ev_ivs = sorted((e.t_start, e.t_end) for e in timeline
                        if e.engine == engine)
        sp_ivs = sorted((s.t_start, s.t_end) for s in tr.spans(track=engine))
        assert ev_ivs == sp_ivs
    from_trace = overlap_from_trace(tr)
    from_events = overlap_from_events(timeline)
    assert from_trace["overlap_ratio"] == \
        pytest.approx(from_events["overlap_ratio"], abs=1e-9)
    assert tr.nesting_errors() == []


def test_exclusive_spans_agree_between_trace_events_and_stats():
    """A task submitted exclusive (a cooperative launch) is busy time on its
    engine track but never overlapped time: the trace, the event timeline
    and the server stats reduce it the same way."""
    tr = Tracer()
    st = ServerStats()
    with StreamRuntime(tracer=tr, device=CPU, observer=st.record_event) as rt:
        rt.submit("tmu", lambda: time.sleep(0.03), label="coop",
                  exclusive=True)
        rt.submit("tpu", lambda: time.sleep(0.03), label="conv")
        assert rt.synchronize(timeout=10.0)
        timeline = rt.timeline()
    (coop,) = tr.spans(track="tmu")
    assert coop.arg("exclusive") is True
    ev = overlap_from_events(timeline)
    tr_ov = overlap_from_trace(tr)
    snap = st.snapshot()
    assert ev["both_busy_s"] == tr_ov["both_busy_s"] == \
        snap["both_busy_s"] == 0.0
    assert ev["any_busy_s"] == pytest.approx(tr_ov["any_busy_s"], abs=1e-9)
    assert ev["any_busy_s"] == pytest.approx(snap["any_busy_s"], abs=1e-9)
    assert ev["exclusive_s"] >= 0.03


def test_traced_server_phase_spans_and_overlap_agreement(rng):
    tr = Tracer()
    xn = rng.rand(2, 8, 6).astype(np.float32)
    x = to_torch(xn)
    want = _jax_tm_fn(jnp.asarray(xn))
    with TMServer(ServerConfig(max_batch=2, batch_timeout_s=0.001,
                               trace=tr, device=CPU)) as srv:
        for _ in range(3):
            futs = [srv.submit(_tm_fn, x, fn_key="tmfn") for _ in range(4)]
            for f in futs:
                assert_same(f.result(timeout=120), want)
        stats_overlap = srv.stats.overlap_ratio()
        compiled = srv.cache.get(srv.cache.keys()[0]).compiled
    # one span per phase execution, named phase/{index}/{kind}
    for phase in compiled.partition_report.phases:
        spans = tr.spans(prefix=f"phase/{phase.index}/{phase.kind}")
        assert spans, f"phase {phase.index} executed without a span"
        assert all(s.track == phase.engine for s in spans)
    # request windows are concurrent-lifetime spans on the requests track
    reqs = tr.spans(track="requests")
    assert len(reqs) == 12 and all(s.overlap_ok for s in reqs)
    assert all(s.arg("ok") is True for s in reqs)
    # the trace and the stats reduce the SAME intervals: tight agreement
    assert overlap_from_trace(tr)["overlap_ratio"] == \
        pytest.approx(stats_overlap, abs=0.02)
    assert tr.nesting_errors() == []
    report = TraceReport.from_tracer(tr, compiled)
    assert report.covered()
    assert sum(r.measured_share for r in report.rows) == pytest.approx(1.0)
    assert "phase" in report.summary()
    # served compiles are traced too
    assert tr.spans(prefix="compile/")
    counters = tr.counters()
    assert counters["cache/hits"] >= 1 and counters["cache/misses"] == 1


def test_instr_detail_records_per_instruction_spans(rng):
    tr = Tracer(detail="instr")
    xn = rng.rand(2, 6, 4).astype(np.float32)
    x = to_torch(xn)
    compiled = tm_compile(_tm_fn, x, tracer=tr)
    out, _ = compiled.run(x, tracer=tr)
    assert_same(out, _jax_tm_fn(jnp.asarray(xn)))
    assert tr.spans(prefix="phase/")
    assert tr.spans(prefix="instr/") or tr.spans(prefix="chain/")
    counters = tr.counters()
    assert counters.get("tmu/launches", 0) > 0
    assert counters.get("hbm/bytes", 0) > 0
    assert tr.nesting_errors() == []
    assert {s.name for s in tr.spans(prefix="compile")} == {
        "compile", "compile/trace", "compile/passes", "compile/partition",
        "compile/allocate"}


# ---------------------------------------------------------------------------
# stats satellites: percentiles + interval window
# ---------------------------------------------------------------------------

def test_percentile_linear_interpolation():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert _percentile(xs, 0.0) == 1.0
    assert _percentile(xs, 1.0) == 4.0
    assert _percentile(xs, 0.5) == pytest.approx(2.5)   # not nearest-rank
    assert _percentile(xs, 0.25) == pytest.approx(1.75)
    assert _percentile([], 0.5) == 0.0
    assert _percentile([7.0], 0.99) == 7.0
    xs100 = [float(i) for i in range(1, 101)]
    assert _percentile(xs100, 0.99) == pytest.approx(np.percentile(xs100, 99))
    assert _percentile(xs100, 0.99) < 100.0             # p99 != max
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert _percentile(xs100, q) == j_percentile(xs100, q)


def test_latency_percentiles_shape():
    xs = [0.3, 0.1, 0.2]
    out = latency_percentiles(xs, "warm_latency")
    assert set(out) == {"warm_latency_p50_s", "warm_latency_p95_s",
                        "warm_latency_p99_s"}
    assert out["warm_latency_p50_s"] == pytest.approx(0.2)
    assert out == jlatency_percentiles(xs, "warm_latency")


def test_server_stats_snapshot_percentile_keys():
    st = ServerStats()
    for v in (0.1, 0.2, 0.3):
        st.record_done(v, cold=False)
    snap = st.snapshot()
    for q in (50, 95, 99):
        assert f"warm_latency_p{q}_s" in snap
        assert f"cold_latency_p{q}_s" in snap
    assert snap["warm_latency_p50_s"] == pytest.approx(0.2)


def test_recent_intervals_window_and_dropped_counter():
    st = ServerStats(recent_intervals=4)
    for i in range(6):
        st.record_interval("tmu", float(i), float(i) + 0.5)
    assert st.dropped_intervals == 2        # window of 4, 6 inserts
    assert st.snapshot()["dropped_intervals"] == 2
    st2 = ServerStats()                     # default window absorbs all
    for i in range(6):
        st2.record_interval("tmu", float(i), float(i) + 0.5)
    assert st2.dropped_intervals == 0
