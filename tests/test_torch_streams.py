"""The port's stream runtime (``repro_torch.runtime.streams``) against the
JAX package's, on the CPU: the twin of ``tests/test_runtime_streams.py``.

Event ordering, failure propagation, the compiled phase DAG dispatched
stream-ordered, and a 4-thread x 8-request soak through one shared runtime
on every executor backend.  Where a result is checked, both packages get
the same numpy inputs and weights: data movement bit-exact, the conv
network within its derived float32 bound (``tests/test_torch_support.py``)
of the JAX package's direct call, and bit-exact against the port's own
direct call.  Every wait carries a timeout.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import affine as jaf  # noqa: E402
from repro.core.executor import TMExecutor as JTMExecutor  # noqa: E402
from repro.core.instr import TMInstr as JTMInstr  # noqa: E402
from repro.core.instr import TMOpcode as JTMOpcode  # noqa: E402
from repro.core.instr import TMProgram as JTMProgram  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.compiler import tm_compile  # noqa: E402
from repro_torch.compiler.api import TPUPhaseReport  # noqa: E402
from repro_torch.core import affine as af  # noqa: E402
from repro_torch.core.dispatch import LoweringReport  # noqa: E402
from repro_torch.core.executor import BACKENDS, TMExecutor  # noqa: E402
from repro_torch.core.instr import TMInstr, TMOpcode, TMProgram  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.runtime.streams import (EventRecord, Stream,  # noqa: E402
                                         StreamError, StreamEvent,
                                         StreamRuntime, intersect_seconds,
                                         merge_intervals, overlap_from_events)
from tests.test_torch_support import (assert_same, assert_within,  # noqa: E402
                                      bounded_conv, bounded_tanh, to_torch)

CPU = "cpu"
WAIT = 60


# ---------------------------------------------------------------------------
# streams + events
# ---------------------------------------------------------------------------

def test_stream_runs_tasks_fifo():
    order = []
    with StreamRuntime(device=CPU) as rt:
        evs = [rt.submit("tmu", lambda i=i: order.append(i))
               for i in range(8)]
        for ev in evs:
            ev.wait(timeout=WAIT)
    assert order == list(range(8))


def test_event_carries_result_and_timestamps():
    with StreamRuntime(device=CPU) as rt:
        ev = rt.submit("tpu", lambda: torch.arange(4) * 2, label="double")
        res = ev.wait(timeout=WAIT)
    assert torch.equal(res, torch.tensor([0, 2, 4, 6]))
    assert ev.t_submit <= ev.t_start <= ev.t_end
    assert ev.duration_s >= 0.0 and ev.done


def test_cross_stream_dependency_orders_execution():
    log = []
    with StreamRuntime(device=CPU) as rt:
        gate = threading.Event()

        def producer():
            gate.wait(timeout=WAIT)
            log.append("produce")

        def consumer():
            log.append("consume")

        dep = rt.submit("tmu", producer)
        ev = rt.submit("tpu", consumer, deps=[dep])
        gate.set()
        ev.wait(timeout=WAIT)
    assert log == ["produce", "consume"]
    assert ev.t_start >= dep.t_end   # no start before the in-edge signals


def test_failed_dependency_skips_task_and_propagates_original():
    ran = []
    with StreamRuntime(device=CPU) as rt:
        boom = rt.submit("tmu", lambda: (_ for _ in ()).throw(
            ValueError("phase exploded")))
        skipped = rt.submit("tpu", lambda: ran.append(1), deps=[boom])
        transitive = rt.submit("tmu", lambda: ran.append(2), deps=[skipped])
        with pytest.raises(ValueError, match="phase exploded"):
            skipped.wait(timeout=WAIT)
        with pytest.raises(ValueError, match="phase exploded"):
            transitive.wait(timeout=WAIT)
    assert not ran                          # skipped tasks never ran
    assert skipped.t_start is None          # and never occupied the engine
    assert overlap_from_events([skipped])["events"] == 0


def test_submit_to_closed_stream_raises():
    s = Stream("tmu", device=CPU)
    s.close()
    with pytest.raises(StreamError):
        s.submit(lambda: None)


def test_runtime_rejects_unknown_engine():
    with StreamRuntime(device=CPU) as rt:
        with pytest.raises(ValueError, match="unknown engine"):
            rt.submit("gpu", lambda: None)


def test_runtime_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamRuntime()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Stream("tmu")


def test_overlap_interval_math():
    assert merge_intervals([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == \
        [(0.0, 2.0), (3.0, 4.0)]
    assert intersect_seconds([(0.0, 2.0)], [(1.0, 3.0)]) == pytest.approx(1.0)
    assert intersect_seconds([(0.0, 1.0)], [(2.0, 3.0)]) == 0.0


def test_overlap_from_events_two_engines():
    from repro.runtime.streams import StreamEvent as JStreamEvent
    from repro.runtime.streams import overlap_from_events as joverlap
    ivs = (("tmu", 0.0, 2.0), ("tpu", 1.0, 3.0))
    m = overlap_from_events([StreamEvent(engine=e, t_start=a, t_end=b)
                             for e, a, b in ivs])
    assert m["both_busy_s"] == pytest.approx(1.0)
    assert m["any_busy_s"] == pytest.approx(3.0)
    assert m["overlap_ratio"] == pytest.approx(1.0 / 3.0)
    assert m["span_s"] == pytest.approx(3.0)
    ref = joverlap([JStreamEvent(engine=e, t_start=a, t_end=b)
                    for e, a, b in ivs])
    assert {k: m[k] for k in ref} == ref


def test_exclusive_event_is_busy_but_never_overlapped():
    """A cooperative launch (submitted exclusive) counts toward busy and
    union time, never toward the overlap."""
    evs = [EventRecord("tmu", "coop", 0.0, 0.0, 2.0, exclusive=True),
           EventRecord("tpu", "conv", 0.0, 1.0, 3.0),
           EventRecord("tmu", "tm", 0.0, 2.5, 4.0)]
    m = overlap_from_events(evs)
    assert m["engine_busy_s"] == {"tmu": pytest.approx(3.5),
                                  "tpu": pytest.approx(2.0)}
    assert m["any_busy_s"] == pytest.approx(4.0)
    assert m["both_busy_s"] == pytest.approx(0.5)   # only "tm" vs "conv"
    assert m["exclusive_s"] == pytest.approx(2.0)
    with StreamRuntime(device=CPU) as rt:
        ev = rt.submit("tpu", lambda: None, exclusive=True)
        ev.wait(timeout=WAIT)
    assert ev.exclusive and rt.timeline()[-1].exclusive


def test_executor_run_async_on_stream():
    x = np.arange(4 * 6 * 8, dtype=np.int32).reshape(4, 6, 8)
    jprog = JTMProgram([JTMInstr(JTMOpcode.COARSE, ("x",), "y",
                                 map_=jaf.transpose_map((4, 6, 8)))],
                       inputs=("x",), outputs=("y",))
    want = JTMExecutor(backend="reference")(jprog, {"x": jnp.asarray(x)})["y"]
    prog = TMProgram([TMInstr(TMOpcode.COARSE, ("x",), "y",
                              map_=af.transpose_map((4, 6, 8)))],
                     inputs=("x",), outputs=("y",))
    with StreamRuntime(device=CPU) as rt:
        ev = TMExecutor(backend="cuda", device=CPU).run_async(
            prog, {"x": to_torch(x)}, runtime=rt)
        out, lowering, _ = ev.wait(timeout=WAIT)
    assert ev.engine == "tmu"
    assert lowering.paths() == ["cuda.block"]
    assert_same(out["y"], want)


# ---------------------------------------------------------------------------
# the compiled phase DAG on the streams
# ---------------------------------------------------------------------------

def _weights():
    return (np.random.RandomState(7).randn(3, 3, 4, 8) * 0.1).astype(
        np.float32)


def _tail_np(h, s=2):
    B, H, W, C = h.shape
    c = C // (s * s)
    h = h.reshape(B, H, W, s, s, c).transpose(0, 1, 3, 2, 4, 5)
    h = h.reshape(B, H * s, W * s, c)
    return np.pad(h, ((0, 0), (1, 1), (1, 1), (0, 0)))


def _mixed_fn():
    """conv (compute) -> depth-to-space + pad (TM) -> tanh (compute): a
    3-phase T-M-T chain exercising both engines and a mid-graph edge."""
    w = to_torch(_weights())

    def fn(x):
        h = cnn.conv2d(x, w)
        B, H, W, C = h.shape
        h = h.reshape(B, H, W, 2, 2, C // 4).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(B, H * 2, W * 2, C // 4)
        return torch.tanh(torch.nn.functional.pad(h, (0, 0, 1, 1, 1, 1)))
    return fn


def _jax_mixed(x: np.ndarray):
    """The JAX package's direct call of the same network."""
    w = jnp.asarray(_weights())
    h = jcnn.conv2d(jnp.asarray(x), w)
    B, H, W, C = h.shape
    h = jnp.transpose(h.reshape(B, H, W, 2, 2, C // 4), (0, 1, 3, 2, 4, 5))
    h = h.reshape(B, H * 2, W * 2, C // 4)
    return jnp.tanh(jnp.pad(h, ((0, 0), (1, 1), (1, 1), (0, 0))))


def _bound(x: np.ndarray) -> np.ndarray:
    """How far two float32 evaluations of the network may lie apart: twice
    the derived bound (conv, exact data movement, tanh)."""
    v, e = bounded_conv(x.astype(np.float64), np.zeros(x.shape), _weights(),
                        1)
    _, e = bounded_tanh(_tail_np(v), _tail_np(e))
    return 2 * e


def _mixed_args(rng):
    return rng.rand(1, 6, 8, 4).astype(np.float32)


def _check_against_jax(got, x: np.ndarray, what: str = "") -> None:
    assert_within(got, np.asarray(_jax_mixed(x), np.float64), _bound(x),
                  what=what)


def test_phase_dag_edges_are_data_dependencies():
    rng = np.random.RandomState(0)
    compiled = tm_compile(_mixed_fn(), to_torch(_mixed_args(rng)))
    part = compiled.partition_report
    kinds = [ph.kind for ph in part.phases]
    assert "tpu" in kinds and "tmu" in kinds
    produced: set[str] = set()
    for ph in part.phases:
        assert ph.index == part.phases.index(ph)
        for d in ph.deps:
            assert d < ph.index                     # topological order
            # every edge is justified by a read of the dep's writes
            assert set(part.phases[d].writes) & set(ph.reads)
        produced.update(ph.writes)
    assert part.dag_edges == sum(len(ph.deps) for ph in part.phases)
    assert part.sink_phases()                        # at least one sink
    assert set(compiled.graph.outputs) <= produced | \
        set(compiled.graph.inputs) | set(compiled.graph.consts)


def test_tpu_phase_runs_its_ops_in_order_on_the_stream():
    """The port's compute phase calls its aten ops one by one (the JAX
    package's jits them into one XLA computation): the report counts every
    op of the phase, repeated runs give the same bits, and the result is
    within the float32 bound of the JAX package's call."""
    rng = np.random.RandomState(1)
    fn = _mixed_fn()
    x = _mixed_args(rng)
    compiled = tm_compile(fn, to_torch(x))
    want = fn(to_torch(x))
    with StreamRuntime(device=CPU) as rt:
        for _ in range(3):
            env = compiled.bind_inputs(to_torch(x))
            events = compiled.run_async(env, runtime=rt, backend="cuda")
            reports = [ev.wait(timeout=WAIT)[1] for ev in events]
            got = compiled.outputs_from(env)
            assert torch.equal(got, want)
    _check_against_jax(got, x)
    tpu_reports = [r for r in reports if isinstance(r, TPUPhaseReport)]
    assert tpu_reports, "expected at least one compute phase"
    for rep in tpu_reports:
        ph = compiled.partition_report.phases[rep.phase_index]
        assert rep.n_ops == len(ph.node_indices)


def test_tpu_phase_writes_spare_pinned_buffers():
    """No compute phase writes an input, a constant or another phase's
    buffer, so stream-ordered phases never clobber what a sibling reads;
    the bound inputs come back unchanged."""
    rng = np.random.RandomState(2)
    x = to_torch(_mixed_args(rng))
    compiled = tm_compile(_mixed_fn(), x)
    pinned = set(compiled.graph.inputs) | set(compiled.graph.consts)
    writers: dict[str, int] = {}
    for ph in compiled.partition_report.phases:
        assert not set(ph.writes) & pinned
        for n in ph.writes:
            assert writers.setdefault(n, ph.index) == ph.index
    before = x.clone()
    with StreamRuntime(device=CPU) as rt:
        compiled.run(x, backend="cuda", runtime=rt)
    assert torch.equal(x, before)


def test_run_with_runtime_matches_blocking_run():
    rng = np.random.RandomState(3)
    x = _mixed_args(rng)
    compiled = tm_compile(_mixed_fn(), to_torch(x))
    blocking, _ = compiled.run(to_torch(x), backend="cuda")
    with StreamRuntime(device=CPU) as rt:
        streamed, lowerings = compiled.run(to_torch(x), backend="cuda",
                                           runtime=rt)
        assert lowerings and all(isinstance(r, LoweringReport)
                                 for r in lowerings)
    assert torch.equal(blocking, streamed)
    _check_against_jax(streamed, x)


# ---------------------------------------------------------------------------
# the soak: 4 threads x 8 requests through ONE shared stream runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_soak_event_ordering_and_bit_exact(backend):
    n_threads, n_per_thread = 4, 8
    rng = np.random.RandomState(10)
    fn = _mixed_fn()
    compiled = tm_compile(fn, to_torch(_mixed_args(rng)))
    deps_of = {ph.index: ph.deps for ph in compiled.partition_report.phases}
    failures: list = []
    results: list = []
    with StreamRuntime(device=CPU) as rt:
        def client(tid):
            trng = np.random.RandomState(100 + tid)
            for i in range(n_per_thread):
                x = _mixed_args(trng)
                try:
                    env = compiled.bind_inputs(to_torch(x))
                    events = compiled.run_async(
                        env, runtime=rt, backend=backend,
                        label=f"t{tid}r{i}:")
                    for ev in events:
                        ev.wait(timeout=300)
                    # ordering invariant: no phase started before every
                    # one of its in-edge events had signalled
                    for idx, ev in enumerate(events):
                        for d in deps_of[idx]:
                            if ev.t_start < events[d].t_end:
                                failures.append(
                                    (tid, i, f"phase {idx} started at "
                                     f"{ev.t_start} before dep {d} ended "
                                     f"at {events[d].t_end}"))
                    got = compiled.outputs_from(env)
                    if not torch.equal(got, fn(to_torch(x))):
                        failures.append((tid, i, "output mismatch"))
                    results.append((x, got))
                except Exception as e:  # noqa: BLE001 — collected
                    failures.append((tid, i, repr(e)))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        measured = rt.overlap()
    assert not failures, failures[:3]
    assert len(results) == n_threads * n_per_thread
    for x, got in results[:4]:
        _check_against_jax(got, x, what=f"soak {backend}")
    # every request's every phase completed through the two streams
    n_phases = len(compiled.partition_report.phases)
    assert measured["events"] == n_threads * n_per_thread * n_phases
