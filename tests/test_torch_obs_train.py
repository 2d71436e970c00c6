"""The port's spans and counters inside the train step and the MoE block,
on the CPU: the profiler's clock, the spans a step records, the MoE
counters against a dispatch recomputed from the same routing, the
profiler gate of the process tracer, device counters, and the traced
LM entry points (``launch/serve.py``, ``launch/train.py --trace``).

Device time (``SpanRecord.device_s``) needs a CUDA device: on the CPU it
stays None, which is what these tests hold it to.
"""

from __future__ import annotations

import dataclasses
import json
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import rme  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.runtime.step import (init_train_state,  # noqa: E402
                                      make_train_step)
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = "cpu"
MOE_SPANS = ("moe/route", "moe/dispatch", "moe/experts", "moe/combine")
QUIET = dict(log=lambda *a, **k: None)


def _moe_cfg(remat="full"):
    """Qwen2-MoE's smoke config, by default each layer recomputed in the
    backward."""
    return dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), remat=remat)


def _batch(cfg, B=2, S=16, seed=1):
    rows = torch.randint(0, cfg.vocab, (B, S + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _step(cfg, tracer=None, seed=0):
    state = init_train_state(cfg, torch.Generator().manual_seed(seed),
                             device=CPU)
    return make_train_step(cfg, tracer=tracer)(state, _batch(cfg))


def _moe_inputs(B=2, S=24, D=32, E=8, k=2, seed=3):
    gen = torch.Generator().manual_seed(seed)
    p = moe_mod.init_moe(gen, D, 48, E, k, pad_experts=E + 2)
    x = torch.randn(B, S, D, generator=gen)
    return p, x, dict(num_experts=E, top_k=k)


# ---------------------------------------------------------------------------
# the profiler's clock
# ---------------------------------------------------------------------------

def test_span_holds_kineto_op_on_the_profilers_clock():
    tr = obs.Tracer()
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("mm"):
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
    (s,) = tr.spans()
    mms = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.name() == "aten::mm"]
    assert len(mms) == 1
    start, end = mms[0]
    assert tr.profiler_ns(s.t_start) <= start < end <= tr.profiler_ns(
        s.t_end)
    # the recording clock alone is nowhere near kineto's
    assert abs(start - round(s.t_start * 1e9)) > 1e12


def test_export_carries_the_profilers_clock(tmp_path):
    tr = obs.Tracer()
    with tr.span("a", track="main"):
        pass
    trace = tr.export_chrome_trace(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == trace
    at0 = trace["otherData"]["profiler_ns_at_ts0"]
    (x,) = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    (s,) = tr.spans()
    assert at0 == tr.profiler_ns(tr.t0)
    assert abs(at0 + round(x["ts"] * 1e3) - tr.profiler_ns(s.t_start)) <= 1
    assert "device_ms" not in x["args"]     # not timed on a device


# ---------------------------------------------------------------------------
# the train step's spans
# ---------------------------------------------------------------------------

def test_train_step_records_its_phases_and_each_moe_span_twice_a_layer():
    cfg = _moe_cfg()
    tr = obs.Tracer()
    _step(cfg, tracer=tr)
    spans = tr.spans()
    names = [s.name for s in spans]
    (step,) = [s for s in spans if s.name == "train/step"]
    assert step.depth == 0
    for name in ("train/forward", "train/backward", "train/optimizer"):
        (s,) = [x for x in spans if x.name == name]
        assert s.depth == 1 and s.track == step.track
        assert step.t_start <= s.t_start <= s.t_end <= step.t_end
    assert "train/compress" not in names
    for name in MOE_SPANS:
        # once in the forward, once in the backward's recompute
        assert names.count(name) == 2 * cfg.n_layers
    assert tr.nesting_errors() == []
    assert all(s.device_s is None for s in spans)
    c = tr.counters()
    # the CPU's leaves take the plain AdamW and the plain loss: no kernel
    # elements or rows counted
    assert set(c) == {"moe/slots", "moe/live_slots", "adamw/elems",
                      "xent/rows"}
    assert 0 < c["moe/live_slots"] <= c["moe/slots"]
    assert c["xent/rows"] == _batch(cfg)["labels"].numel()
    assert c["adamw/elems"] == sum(t.numel() for t in tree_leaves(
        init_train_state(cfg, torch.Generator().manual_seed(0),
                         device=CPU)["params"]))


def test_train_step_without_remat_counts_each_moe_span_once_a_layer():
    cfg = _moe_cfg(remat="none")
    tr = obs.Tracer()
    _step(cfg, tracer=tr)
    names = [s.name for s in tr.spans()]
    for name in MOE_SPANS:
        assert names.count(name) == cfg.n_layers


def test_compressed_step_records_train_compress():
    cfg = get_smoke("phi4-mini-3.8b")
    tr = obs.Tracer()
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             compress=True, device=CPU)
    make_train_step(cfg, compress=True, tracer=tr)(state, _batch(cfg))
    (c,) = tr.spans(prefix="train/compress")
    (b,) = tr.spans(prefix="train/backward")
    (o,) = tr.spans(prefix="train/optimizer")
    assert b.t_end <= c.t_start and c.t_end <= o.t_start
    assert not tr.spans(prefix="moe/")        # a dense model
    assert tr.nesting_errors() == []


def test_traced_step_is_the_untraced_step():
    cfg = _moe_cfg()
    s0, m0 = _step(cfg)
    s1, m1 = _step(cfg, tracer=obs.Tracer())
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree_leaves(s0["params"]), tree_leaves(s1["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the MoE counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_live_slots_is_the_dispatchs_valid_count(capacity_factor):
    p, x, kw = _moe_inputs()
    B, S, _ = x.shape
    tr = obs.Tracer()
    with obs.use(tr):
        moe_mod.moe_block(p, x, capacity_factor=capacity_factor, **kw)
    _, _, expert_of = moe_mod.route(p, x, top_k=kw["top_k"])
    E = p["wi"].shape[0]
    C = moe_mod.capacity_of(S, kw["top_k"], kw["num_experts"],
                            capacity_factor)
    idx, counts = rme.dispatch_tokens(
        expert_of.reshape(B, S * kw["top_k"]), E, C)
    valid = int((idx.to(torch.int64) < S * kw["top_k"]).sum())
    assert valid == int(counts.sum())
    c = tr.counters()
    assert c["moe/live_slots"] == valid
    assert c["moe/slots"] == B * E * C
    assert c["moe/live_slots"] <= min(c["moe/slots"], B * S * kw["top_k"])
    assert [s.name for s in tr.spans()] == list(MOE_SPANS)


# ---------------------------------------------------------------------------
# the profiler gate and the null path
# ---------------------------------------------------------------------------

def test_current_is_null_outside_a_profiler_and_the_process_tracer_inside():
    assert obs.current() is obs.NULL_TRACER
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.current() is obs.process_tracer()
    assert obs.current() is obs.NULL_TRACER


def test_use_sets_the_current_tracer_for_every_thread_and_restores_it():
    import threading

    outer, inner = obs.Tracer(), obs.Tracer()
    seen = []
    with obs.use(outer):
        with obs.use(inner):
            t = threading.Thread(target=lambda: seen.append(obs.current()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert obs.current() is outer
    assert seen == [inner]
    assert obs.current() is obs.NULL_TRACER


def test_process_tracer_records_only_under_a_profiler():
    cfg = _moe_cfg()
    proc = obs.process_tracer()
    n0 = len(proc.spans())
    _step(cfg)
    assert len(proc.spans()) == n0           # no profiler: nothing
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.monotonic()
        _step(cfg)
        t1 = time.monotonic()
    mine = [s for s in proc.spans() if t0 <= s.t_start and s.t_end <= t1]
    assert [s.name for s in mine].count("train/step") == 1
    assert [s.name for s in mine].count("moe/route") == 2 * cfg.n_layers
    assert proc.count_between("moe/slots", t0, t1) > 0
    n1 = len(proc.spans())
    _step(cfg)
    assert len(proc.spans()) == n1


def test_process_tracer_holds_the_latest_session_until_the_next():
    cfg = _moe_cfg()
    proc = obs.process_tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        _step(cfg)
    first = proc.spans()
    assert [s.name for s in first].count("train/step") == 1
    _step(cfg)                    # after the session: still readable
    assert proc.spans() == first and proc.counters()["moe/slots"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.monotonic()
        _step(cfg)
        _step(cfg)
    # the next session's first call cleared the last one's records
    spans = proc.spans()
    steps = [s for s in spans if s.name == "train/step"]
    assert len(steps) == 2 and all(s.t_start >= t0 for s in spans)
    assert proc.counters()["moe/slots"] == 2 * proc.count_between(
        "moe/slots", t0, steps[0].t_end)


def test_reset_drops_the_records_and_pools_the_events():
    tr = obs.Tracer()
    pair = ("start", "end")     # stand-ins: reset only moves them
    with tr.span("a"):
        tr.count("n", 2)
        tr.count("d", torch.tensor(1))
        tr.instant("i")
    tr._spans.append(("b", "t", 0.0, 1.0, 0, (), False, pair))
    tr.reset()
    assert tr.spans() == [] and tr.counters() == {}
    assert tr._pool == list(pair)
    assert [e for e in tr.chrome_trace()["traceEvents"]
            if e["ph"] != "M"] == []


def test_null_path_records_nothing():
    p, x, kw = _moe_inputs()
    proc = obs.process_tracer()
    n0, c0 = len(proc.spans()), proc.counters()
    moe_mod.moe_block(p, x, **kw)
    with obs.use(obs.NULL_TRACER):
        moe_mod.moe_block(p, x, **kw)
    assert len(proc.spans()) == n0 and proc.counters() == c0
    assert obs.NULL_TRACER.spans() == [] and obs.NULL_TRACER.counters() == {}
    assert obs.NULL_TRACER.count_between("moe/slots", 0.0, 1e12) == 0.0


# ---------------------------------------------------------------------------
# device counters
# ---------------------------------------------------------------------------

def test_count_takes_a_0d_tensor_and_keeps_the_total_a_tensor():
    """A tensor delta is kept as it is (no kernel adds it on the hot
    path) and added in, as a float, when the counters are read."""
    tr = obs.Tracer()
    t0 = time.monotonic()
    three = torch.tensor(3)
    tr.count("c", three)
    assert "c" not in tr._counters
    assert tr._device_counts[0][-1].data_ptr() == three.data_ptr()
    t1 = time.monotonic()
    tr.count("c", torch.tensor(2))
    tr.count("c", torch.tensor(4.5))
    tr.count("host", 2)
    assert tr.counters() == {"c": 9.5, "host": 2.0}
    assert tr._device_counts == []
    assert tr.count_between("c", t1, time.monotonic()) == 6.5
    assert tr.count_between("c", t0, t1) == 3.0
    tr.count("c", torch.tensor(1))
    (ev, *_, last) = [e for e in tr.chrome_trace()["traceEvents"]
                      if e["ph"] == "C" and e["name"] == "c"]
    assert ev["args"]["value"] == 3.0 and last["args"]["value"] == 10.5
    assert isinstance(last["args"]["value"], float)
    json.dumps(tr.chrome_trace())


def test_count_takes_a_dtensors_local_value():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    # a one-rank gloo group in this process, its store in memory
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        valid = distribute_tensor(torch.tensor([True, False, True]), mesh,
                                  [Shard(0)])
        tr = obs.Tracer()
        tr.count("live", valid.sum())
        assert not isinstance(tr._device_counts[0][-1], DTensor)
        assert tr.counters() == {"live": 2.0}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the traced entry points
# ---------------------------------------------------------------------------

def test_traced_serve_returns_the_untraced_tokens_without_waiting():
    cfg = get_smoke("qwen2-moe-a2.7b")
    kw = dict(batch=2, prompt_len=8, gen=5, device=CPU, **QUIET)
    plain, _ = tserve.serve(cfg, **kw)
    tr = obs.Tracer()
    traced, _ = tserve.serve(cfg, tracer=tr, **kw)
    assert torch.equal(plain, traced)
    steps = tr.spans(prefix="decode/step@p")
    assert [s.name for s in steps] == [f"decode/step@p{t}"
                                       for t in range(8, 12)]
    assert all(s.track == "lm" and s.device_s is None for s in steps)
    # the MoE block's spans nest in the prefill and decode spans
    assert len(tr.spans(prefix="moe/route")) == cfg.n_layers * 5
    assert tr.nesting_errors() == []


def test_train_cli_trace_exports_each_steps_spans(tmp_path, capsys):
    out = tmp_path / "train.trace.json"
    ttrain.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--device", CPU,
                 "--trace", str(out)])
    assert "trace:" in capsys.readouterr().out
    trace = json.loads(out.read_text())
    xs = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert xs.count("train/step") == 2
    assert xs.count("train/optimizer") == 2
    assert xs.count("moe/experts") == 2 * get_smoke("qwen2-moe-a2.7b").n_layers
    counters = {e["name"] for e in trace["traceEvents"] if e["ph"] == "C"}
    assert counters == {"moe/slots", "moe/live_slots", "adamw/elems",
                        "xent/rows"}
    assert "profiler_ns_at_ts0" in trace["otherData"]
