"""The port's serving runtime (``repro_torch.serving``) against the JAX
package's, on the CPU: the twin of ``tests/test_serving.py``.

Compile cache, shape-bucketed batching, the depth-limited pipeline, the
server's padding, cache accounting and config selection, a concurrent soak
on every backend, executor thread safety and the segment budget.  Every
served result is held against the JAX package's direct call of the same
function on the same numpy inputs (bit-exact: it is data movement), and
the ``serve_cnn`` demo mix is served through the port's ``TMServer`` with
ESPCN weights carried across from the JAX package (ESPCN within
``ESPCN_ATOL``, the rest bit-exact).  Every wait carries a timeout.
"""

from __future__ import annotations

import json
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
from repro.core.schedule import map_segments as jmap_segments  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.serving.batcher import bucket_size as jbucket_size  # noqa: E402
from repro_torch.compiler import tm_compile  # noqa: E402
from repro_torch.core import affine as af  # noqa: E402
from repro_torch.core.executor import BACKENDS, TMExecutor  # noqa: E402
from repro_torch.core.instr import TMInstr, TMOpcode, TMProgram  # noqa: E402
from repro_torch.core.schedule import CycleParams, map_segments  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime.streams import StreamEvent, StreamRuntime  # noqa: E402
from repro_torch.serving import (CacheEntry, CacheKey,  # noqa: E402
                                 CompileCache, PipelineJob, RequestPipeline,
                                 ServerConfig, ServerStats, TMServer,
                                 bucket_size, select_cycle_params)
from repro_torch.serving.batcher import Request, coalesce, split  # noqa: E402
from tests.test_torch_models import ESPCN_ATOL  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

CPU = "cpu"
WAIT = 120


# module-level so every request shares one fn identity (one cache lineage)
def _tm_fn(x, r):
    h = x.permute(0, 2, 1)
    h = h + r
    h = torch.flip(h, dims=(1,))
    return torch.nn.functional.pad(h, (0, 0, 1, 1))


def _jax_tm_fn(x, r):
    h = jnp.transpose(x, (0, 2, 1))
    h = h + r
    h = jnp.flip(h, axis=1)
    return jnp.pad(h, ((0, 0), (1, 1), (0, 0)))


def _mk_np(rng, core):
    b, h, w = core
    return (rng.rand(b, h, w).astype(np.float32),
            rng.rand(b, w, h).astype(np.float32))


def _mk_args(rng, core):
    return tuple(to_torch(a) for a in _mk_np(rng, core))


def _jax_call(args):
    """The JAX package's direct call on the same values."""
    return _jax_tm_fn(*(jnp.asarray(a.numpy()) for a in args))


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

class _FakeEntry:
    def __init__(self, tag):
        self.tag = tag
        self.hits = 0
        self.demand_hits = 0


def _key(tag, shape=(4, 4)):
    return CacheKey(fn_key=tag, shapes=(shape,), dtypes=("torch.float32",),
                    backend="fused", params=None)


def test_cache_lru_eviction_and_stats():
    cache = CompileCache(capacity=2)
    a, b, c = _key("a"), _key("b"), _key("c")
    for k in (a, b):
        entry, hit = cache.get_or_compile(k, lambda k=k: _FakeEntry(k))
        assert not hit
    entry, hit = cache.get_or_compile(a, lambda: _FakeEntry("a2"))
    assert hit and entry.tag is a  # original entry, not rebuilt
    # c evicts b (a was just touched -> b is LRU)
    cache.get_or_compile(c, lambda: _FakeEntry(c))
    assert cache.evictions == 1
    assert set(cache.keys()) == {a, c}
    _, hit = cache.get_or_compile(b, lambda: _FakeEntry("b2"))
    assert not hit  # b was evicted
    assert cache.hits == 1 and cache.misses == 4
    assert cache.hit_rate == pytest.approx(0.2)


def test_cache_concurrent_misses_compile_once():
    cache = CompileCache(capacity=4)
    k = _key("shared")
    built, results, barrier = [], [], threading.Barrier(4)

    def worker():
        barrier.wait(timeout=WAIT)

        def build():
            built.append(1)
            return _FakeEntry("x")
        results.append(cache.get_or_compile(k, build))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1  # in-flight de-dup: one compile
    assert len({id(e) for e, _ in results}) == 1
    assert cache.misses == 1 and cache.hits == 3


def test_cache_failed_build_not_cached():
    cache = CompileCache(capacity=2)
    k = _key("boom")
    with pytest.raises(RuntimeError):
        cache.get_or_compile(k, lambda: (_ for _ in ()).throw(
            RuntimeError("compile failed")))
    entry, hit = cache.get_or_compile(k, lambda: _FakeEntry("ok"))
    assert not hit and entry.tag == "ok"


# ---------------------------------------------------------------------------
# batcher: bucket sizing, pad/coalesce/split on odd shapes
# ---------------------------------------------------------------------------

def test_bucket_size_rounds_to_power_of_two():
    ns = (1, 2, 3, 4, 5, 7, 8, 9)
    assert [bucket_size(n, 8) for n in ns] == [1, 2, 4, 4, 8, 8, 8, 8]
    assert [bucket_size(n, 8) for n in ns] == [jbucket_size(n, 8) for n in ns]


def test_coalesce_split_odd_shapes_roundtrip():
    rng = np.random.RandomState(0)
    reqs = [Request(fn=_tm_fn, fn_key="k", args=_mk_args(rng, (1, 3, 5)),
                    future=None) for _ in range(3)]
    stacked, pad = coalesce(reqs, 4)
    assert pad == 1
    assert stacked[0].shape == (4, 1, 3, 5) and stacked[1].shape == (4, 1, 5, 3)
    # the pad row repeats the last real request
    assert torch.equal(stacked[0][3], reqs[2].args[0])
    parts = split(stacked, 3)
    assert len(parts) == 3           # the pad row reaches no response
    for req, part in zip(reqs, parts):
        assert torch.equal(part[0], req.args[0])
        assert torch.equal(part[1], req.args[1])


# ---------------------------------------------------------------------------
# pipeline: per-job phase order, cross-job overlap admission
# ---------------------------------------------------------------------------

def test_pipeline_preserves_phase_order_and_drains():
    log, lock = [], threading.Lock()
    done = []

    def step(tag):
        def run():
            with lock:
                log.append(tag)
        return run

    pipe = RequestPipeline(stats=ServerStats(), depth=2, device=CPU)
    pipe.start()
    jobs = []
    for j in range(4):
        steps = [("tmu", step((j, 0))), ("tpu", step((j, 1))),
                 ("tmu", step((j, 2)))]
        jobs.append(PipelineJob(steps=steps,
                                on_done=lambda err, j=j: done.append((j, err))))
    for job in jobs:
        pipe.submit(job)
    pipe.stop()
    assert sorted(done) == [(j, None) for j in range(4)]
    for j in range(4):
        mine = [t for t in log if t[0] == j]
        assert mine == [(j, 0), (j, 1), (j, 2)]  # in-order phases per job


def test_pipeline_reports_failure_once():
    done = []
    pipe = RequestPipeline(depth=2, device=CPU)
    pipe.start()
    pipe.submit(PipelineJob(
        steps=[("tmu", lambda: None),
               ("tpu", lambda: (_ for _ in ()).throw(ValueError("phase")))],
        on_done=lambda err: done.append(err)))
    pipe.stop()
    assert len(done) == 1 and isinstance(done[0], ValueError)


# ---------------------------------------------------------------------------
# TMServer: padding, cache accounting, config selection
# ---------------------------------------------------------------------------

def test_server_pads_odd_batch_and_matches_direct_calls():
    rng = np.random.RandomState(1)
    reqs = [_mk_args(rng, (1, 3, 5)) for _ in range(3)]
    cfg = ServerConfig(max_batch=4, batch_timeout_s=0.25, device=CPU)
    with TMServer(cfg) as srv:
        futs = [srv.submit(_tm_fn, *a) for a in reqs]
        for args, fut in zip(reqs, futs):
            assert_same(fut.result(timeout=WAIT), _jax_call(args))
        snap = srv.snapshot_stats()
    assert snap["batches"] == 1          # coalesced within the timeout window
    assert snap["pad_rows"] == 1         # 3 real rows padded to bucket 4
    assert snap["cache"]["misses"] == 1


def test_server_cache_hits_and_eviction():
    rng = np.random.RandomState(2)
    cfg = ServerConfig(max_batch=1, batch_timeout_s=0.0, cache_capacity=2,
                       select_config=False, device=CPU)
    shapes = [(1, 3, 4), (1, 3, 4), (1, 4, 6), (1, 2, 3), (1, 3, 4)]
    with TMServer(cfg) as srv:
        for core in shapes:  # sequential: deterministic LRU traffic
            args = _mk_args(rng, core)
            assert_same(srv.submit(_tm_fn, *args).result(timeout=WAIT),
                        _jax_call(args))
        snap = srv.snapshot_stats()["cache"]
    # miss, hit, miss, miss(evicts (1,3,4)), miss(evicts (1,4,6))
    assert snap["hits"] == 1
    assert snap["misses"] == 4
    assert snap["evictions"] == 2
    assert snap["hit_rate"] == pytest.approx(0.2)


def test_server_config_selection_pins_candidate():
    rng = np.random.RandomState(3)
    cfg = ServerConfig(max_batch=1, batch_timeout_s=0.0,
                       segment_candidates=(2048, 16384), device=CPU)
    with TMServer(cfg) as srv:
        args = _mk_args(rng, (1, 8, 16))
        srv.submit(_tm_fn, *args).result(timeout=WAIT)
        (key,) = srv.cache.keys()
        entry = srv.cache.get(key)
    assert entry.params is not None
    assert entry.params.segment_bytes in (2048, 16384)
    sweep = entry.selection["segment_bytes"]["sweep"]
    assert [r["segment_bytes"] for r in sweep] == [2048, 16384]
    assert all("score" in r and "forwarded_cycles" in r for r in sweep)
    assert entry.compiled.params == entry.params  # pinned into execution


def test_select_cycle_params_prefers_lower_score():
    rng = np.random.RandomState(4)
    args = _mk_args(rng, (1, 8, 16))
    compiled = tm_compile(_tm_fn, *args)
    params, part, rows = select_cycle_params(compiled.graph, (1024, 16384))
    best = min(rows, key=lambda r: r["score"])
    assert params.segment_bytes == best["segment_bytes"]
    assert part.forwarded_cycles == best["forwarded_cycles"]


def test_server_config_validation_and_unported_options():
    with pytest.raises(ValueError, match="unknown backend"):
        ServerConfig(backend="pallas")
    with pytest.raises(ValueError, match="power of two"):
        ServerConfig(max_batch=3)
    # the watchdog and exact mode are ported: both options are accepted
    assert ServerConfig(phase_timeout_factor=1.0).phase_timeout_factor == 1.0
    assert ServerConfig(exact=True).exact
    assert ServerConfig().device is None and ServerConfig().backend == "fused"


def test_server_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TMServer(ServerConfig())


# ---------------------------------------------------------------------------
# concurrent soak: N threads x M mixed-shape requests, every backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_server_concurrent_soak_bit_exact(backend):
    n_threads, n_per_thread = 4, 5
    cfg = ServerConfig(max_batch=2, batch_timeout_s=0.002, backend=backend,
                       device=CPU)
    cores = [(1, 3, 5), (2, 4, 6)]
    failures = []
    with TMServer(cfg) as srv:
        def client(tid):
            rng = np.random.RandomState(100 + tid)
            for i in range(n_per_thread):
                args = _mk_args(rng, cores[(tid + i) % len(cores)])
                try:
                    got = srv.submit(_tm_fn, *args).result(timeout=WAIT)
                    want = np.asarray(_jax_call(args))
                    if not np.array_equal(got.numpy(), want):
                        failures.append((tid, i, "mismatch"))
                except Exception as e:  # noqa: BLE001 — collected for assert
                    failures.append((tid, i, repr(e)))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        snap = srv.snapshot_stats()
    assert not failures, failures[:3]
    assert snap["completed"] == n_threads * n_per_thread
    assert snap["failed"] == 0
    # batching must actually coalesce under concurrency (not all singletons)
    assert snap["batches"] <= snap["completed"]


# ---------------------------------------------------------------------------
# executor thread-safety + segment-budget plumbing
# ---------------------------------------------------------------------------

def _single_map_prog(m):
    return TMProgram([TMInstr(TMOpcode.COARSE, ("x",), "y", map_=m)],
                     inputs=("x",), outputs=("y",))


def _jax_reference(m_json_map, x: np.ndarray):
    prog = JTMProgram([JTMInstr(JTMOpcode.COARSE, ("x",), "y",
                                map_=m_json_map)],
                      inputs=("x",), outputs=("y",))
    return JTMExecutor(backend="reference")(prog, {"x": jnp.asarray(x)})["y"]


def test_executor_run_returns_per_call_reports():
    m = af.transpose_map((4, 6, 8))
    prog = _single_map_prog(m)
    xn = np.arange(4 * 6 * 8, dtype=np.int32).reshape(4, 6, 8)
    ex = TMExecutor(backend="cuda", device=CPU)
    before = ex.last_lowering
    out, lowering, fusion = ex.run(prog, {"x": to_torch(xn)})
    assert ex.last_lowering is before      # run() mutates no executor state
    assert lowering.paths() == ["cuda.block"]
    assert fusion is None                  # cuda backend: no fusion pass
    assert_same(out["y"], _jax_reference(jaf.transpose_map((4, 6, 8)), xn))
    ex(prog, {"x": to_torch(xn)})
    assert ex.last_lowering is not None    # __call__ keeps the alias


def test_executor_shared_across_threads():
    progs = {
        "t": (af.transpose_map((4, 6, 8)), jaf.transpose_map((4, 6, 8)),
              (4, 6, 8)),
        "u": (af.upsample_map((4, 6, 2), 2), jaf.upsample_map((4, 6, 2), 2),
              (4, 6, 2)),
    }
    ex = TMExecutor(backend="cuda", device=CPU)
    errors = []

    def worker(name):
        m, jm, shape = progs[name]
        prog = _single_map_prog(m)
        xn = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
        want = np.asarray(_jax_reference(jm, xn))
        for _ in range(5):
            out, lowering, _ = ex.run(prog, {"x": to_torch(xn)})
            if len(lowering.records) != 1:
                errors.append(f"{name}: report length {len(lowering.records)}")
            if lowering.records[0].dst != "y":
                errors.append(f"{name}: foreign record {lowering.records[0]}")
            if not np.array_equal(out["y"].numpy(), want):
                errors.append(f"{name}: wrong value")

    threads = [threading.Thread(target=worker, args=(n,))
               for n in ("t", "u") * 2]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]


def test_segment_budget_reconfigures_the_kernel_segments():
    m = af.pixel_shuffle_map((8, 16, 16), 2)  # gather-mode map
    jm = jaf.pixel_shuffle_map((8, 16, 16), 2)
    prog = _single_map_prog(m)
    xn = np.random.RandomState(0).randint(-99, 100, m.in_shape).astype(
        "int32")
    ref = _jax_reference(jm, xn)
    seen = {}
    for sb in (None, 1024):
        params = None if sb is None else CycleParams(segment_bytes=sb)
        ex = TMExecutor(backend="cuda", device=CPU, params=params)
        out, lowering, _ = ex.run(prog, {"x": to_torch(xn)})
        rec = lowering.records[0]
        assert rec.path == "cuda.gather"
        want_segments = (map_segments(m) if sb is None
                         else map_segments(m, segment_bytes=sb))
        # the count the kernel rule reports is the JAX package's grid
        assert rec.segments == want_segments == (
            jmap_segments(jm) if sb is None
            else jmap_segments(jm, segment_bytes=sb))
        assert_same(out["y"], ref)
        seen[sb] = rec.segments
    assert seen[1024] > seen[None]  # the budget actually re-sized it


def test_compiled_program_run_is_pure():
    rng = np.random.RandomState(5)
    args = _mk_args(rng, (1, 4, 6))
    compiled = tm_compile(_tm_fn, *args)
    before = list(compiled.last_lowering)
    out, lowerings = compiled.run(*args, backend="cuda")
    assert compiled.last_lowering == before   # run() leaves state alone
    assert lowerings and all(r.backend == "cuda" for r in lowerings)
    assert_same(out, _jax_call(args))
    compiled(*args, backend="cuda")
    assert compiled.last_lowering  # __call__ keeps the alias behaviour


def test_cancelled_request_is_dropped_and_server_keeps_serving():
    rng = np.random.RandomState(6)
    cfg = ServerConfig(max_batch=4, batch_timeout_s=0.2, device=CPU)
    with TMServer(cfg) as srv:
        args = _mk_args(rng, (1, 3, 4))
        fut = srv.submit(_tm_fn, *args)
        assert fut.cancel()  # still queued: cancellable
        # the engine threads must survive the cancelled future; later
        # requests (same and different shape classes) still serve
        args2 = _mk_args(rng, (1, 4, 5))
        got = srv.submit(_tm_fn, *args2).result(timeout=WAIT)
        assert_same(got, _jax_call(args2))
        assert srv.flush(timeout=30)  # cancelled row released its slot


def test_submit_after_stop_raises_instead_of_hanging():
    srv = TMServer(ServerConfig(max_batch=1, device=CPU)).start()
    srv.stop()
    with pytest.raises(RuntimeError):
        srv.submit(_tm_fn, torch.ones((1, 2, 3)), torch.ones((1, 3, 2)))


def test_stats_overlap_from_event_intervals():
    # measured overlap comes from realized event timestamps: two engines
    # busy [0,2] and [1,3] -> 1s both-busy over 3s any-busy
    stats = ServerStats()
    snap = stats.snapshot()          # no events yet: must not divide by zero
    assert snap["overlap_ratio"] == 0.0 and snap["pipeline_span_s"] == 0.0
    stats.record_interval("tmu", 0.0, 2.0)
    stats.record_interval("tpu", 1.0, 3.0)
    snap = stats.snapshot()
    assert snap["both_busy_s"] == pytest.approx(1.0)
    assert snap["any_busy_s"] == pytest.approx(3.0)
    assert snap["overlap_ratio"] == pytest.approx(1.0 / 3.0)
    assert snap["pipeline_span_s"] == pytest.approx(3.0)
    assert snap["engine_busy_s"] == {"tmu": 2.0, "tpu": 2.0}


def test_pipeline_external_runtime_feeds_stats():
    # a caller-provided runtime must still feed the stats (observer tap),
    # and stop() must untap without closing the caller's streams
    stats = ServerStats()
    with StreamRuntime(device=CPU) as rt:
        pipe = RequestPipeline(stats=stats, depth=2, runtime=rt)
        pipe.start()
        done = []
        pipe.submit(PipelineJob(
            steps=[("tmu", lambda: None), ("tpu", lambda: None)],
            on_done=lambda err: done.append(err)))
        pipe.stop()
        # the external runtime survives pipeline stop
        rt.submit("tmu", lambda: None).wait(timeout=30)
    assert done == [None]
    assert set(stats.snapshot()["engine_busy_s"]) == {"tmu", "tpu"}


def test_stats_ignore_skipped_events():
    stats = ServerStats()
    stats.record_event(StreamEvent(engine="tmu"))   # skipped: no timestamps
    assert stats.snapshot()["overlap_ratio"] == 0.0


def test_cache_eviction_drops_fn_pin():
    import gc
    import weakref

    cache = CompileCache(capacity=1)

    def make_entry(tag):
        fn = lambda x: x + tag  # noqa: E731 — a fresh closure per entry
        return fn, CacheEntry(key=_key(str(tag)), fn=fn, compiled=None,
                              backend="fused", params=None)

    fn_a, entry_a = make_entry(1)
    cache.get_or_compile(_key("1"), lambda: entry_a)
    ref_a = weakref.ref(fn_a)
    del fn_a
    gc.collect()
    assert ref_a() is not None       # cached: the entry pins the closure
    _, entry_b = make_entry(2)
    cache.get_or_compile(_key("2"), lambda: entry_b)   # evicts entry 1
    assert cache.evictions == 1
    assert entry_a.fn is None        # the pin died with residency
    del entry_a                      # caller's handle (was the last ref path)
    gc.collect()
    assert ref_a() is None           # eviction released the traced closure


def test_bucket_size_caps_at_largest_pow2_below_max_batch():
    # a non-pow2 max_batch must clamp to the pow2 ladder, not mint a stray
    # bucket size that fragments the compile cache
    assert [bucket_size(n, 6) for n in (1, 2, 3, 4, 5, 6, 9)] == \
        [1, 2, 4, 4, 4, 4, 4]
    assert [bucket_size(n, 1) for n in (1, 5)] == [1, 1]
    assert bucket_size(3, 12) == 4 and bucket_size(9, 12) == 8


# ---------------------------------------------------------------------------
# the serve_cnn demo mix, against the JAX package's direct calls
# ---------------------------------------------------------------------------

def _jax_demo_workload(n_requests, seed, jparams):
    """The JAX package's ``serve_cnn`` mix (``repro/launch/serve.py``), as
    direct calls: the same numpy draws in the same order."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return jnp.asarray(rng.rand(*shape).astype(np.float32))

    out = []
    for i in range(n_requests):
        kind, odd = i % 4, (i // 4) % 2
        if kind == 0:
            x, skip = arr(1, 6 + 2 * odd, 10, 8), arr(1, (6 + 2 * odd) * 2,
                                                      20, 2)
            out.append(jcnn.superres_tail(x, skip))
        elif kind == 1:
            u, skip = arr(1, 4, 6 + 2 * odd, 6), arr(1, 8, (6 + 2 * odd) * 2,
                                                     3)
            out.append(jcnn.yolo_neck(u, skip))
        elif kind == 2:
            out.append(jcnn.detect_tail(arr(2, 33 + odd, 7), 0.5, 16))
        else:
            out.append(jcnn.espcn(jparams, arr(1, 8 + 2 * odd, 10, 3)))
    return out


def test_served_cnn_demo_mix_matches_the_jax_package():
    n, seed = 16, 0
    jparams = jcnn.init_espcn(jax.random.PRNGKey(seed), s=2)
    espcn = cnn.ESPCN(params_from_numpy(jax.tree.map(np.asarray, jparams)))
    workload = tserve.cnn_demo_workload(n_requests=n, seed=seed, device=CPU,
                                        espcn=espcn)
    want = _jax_demo_workload(n, seed, jparams)
    cfg = ServerConfig(backend="cuda", max_batch=4, batch_timeout_s=0.01,
                       device=CPU)
    with TMServer(cfg) as srv:
        futs = [srv.submit(fn, *args, fn_key=key)
                for key, fn, args in workload]
        for (key, _, _), fut, ref in zip(workload, futs, want):
            assert_same(fut.result(timeout=WAIT), ref,
                        atol=ESPCN_ATOL if key == "espcn" else 0.0, what=key)
        snap = srv.snapshot_stats()
        entries = list(srv.cache._entries.values())
    assert snap["completed"] == n and snap["failed"] == 0
    # one entry per (fn, shape class, height): the batched program of
    # every block compiled ONE node per op (vmap rules, no per-sample loop)
    assert {e.key.fn_key for e in entries} == {"superres", "yolo_neck",
                                               "detect_tail", "espcn"}
    for e in entries:
        if e.key.fn_key == "espcn":
            assert e.cross_engine and e.selection["cross_engine"][
                "crossing_paths"] == ["cuda.xchain.commit"]
    assert all(e.quarantine == set() for e in entries)  # the CPU ladder


def test_serve_cli_cnn_on_cpu_exports_a_trace(tmp_path, capsys):
    out = tmp_path / "trace.json"
    tserve.main(["--cnn", "--device", "cpu", "--requests", "8",
                 "--max-batch", "2", "--trace", str(out)])
    printed = capsys.readouterr().out
    assert "served 8 CNN-block requests on cpu" in printed
    names = {e.get("name", "") for e in json.loads(out.read_text())[
        "traceEvents"]}
    assert any(n.startswith("compile/") for n in names)
    assert any(n.startswith("phase/") for n in names)
    assert any(n.startswith("request/") for n in names)
    assert any(n.startswith("admit/") for n in names)
