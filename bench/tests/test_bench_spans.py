"""The span helper and the seven readers of the program's spans, on a
hand-built run with known spans, counters and device gaps; then on the
smoke train cell, where the program's own process tracer records them."""

import pytest
import torch

from bench.harness import core, spans, trace
from bench.tests import smoke
from repro_torch.obs import SpanRecord

SPEC = core.benchmark_spec()
AT0 = 1_800_000_000_000_000_000      # the profiler's clock at recorded 0
READERS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
           "moe_tm_ms.train", "moe_experts_ms.train",
           "moe_slot_fill_pct.train", "step_idle_ms.train")


class FakeTracer:
    """What the helper reads of the program's process tracer."""

    def __init__(self, records, counts):
        self.records, self.counts = records, counts

    def spans(self):
        return list(self.records)

    def profiler_ns(self, t):
        return AT0 + round(t * 1e9)

    def count_between(self, name, t_from, t_to):
        return sum(v for t, n, v in self.counts
                   if n == name and t_from <= t <= t_to)


def _span(name, a, b, device_s, track="MainThread"):
    return SpanRecord(name, track, a, b, device_s=device_s)


def _step(t, tm_device=0.004):
    """One step from ``t`` (seconds): forward 0.1 s, backward 0.2 s,
    optimizer 0.1 s on the host; on the device 0.09, 0.18 and 0.07 s,
    the step 0.35 s.  Two MoE blocks in the forward, two in the
    backward's recompute (on autograd's thread)."""
    out = [_span("train/step", t, t + 0.4, 0.35),
           _span("train/forward", t, t + 0.1, 0.09),
           _span("train/backward", t + 0.1, t + 0.3, 0.18),
           _span("train/optimizer", t + 0.3, t + 0.4, 0.07)]
    for base, track in ((t, "MainThread"), (t + 0.15, "autograd")):
        for i in range(2):
            a = base + 0.01 + 0.03 * i
            for j, name in enumerate(("moe/route", "moe/dispatch",
                                      "moe/experts", "moe/combine")):
                dev = 0.005 if name == "moe/experts" else tm_device
                out.append(_span(name, a + 0.005 * j, a + 0.005 * (j + 1),
                                 dev, track))
    return out


def _ns(t):
    return AT0 + round(t * 1e9)


def _run(monkeypatch, *, records=None, counts=None, steps=3):
    """A traced part from 10 s to 11.5 s with ``steps`` steps, and device
    operations whose gaps are: 1 ms in step 1's backward (after its MoE
    blocks), 5 ms between steps 1 and 2, 2 ms in a dispatch of step 2's
    recompute, 4 ms in step 3's optimizer."""
    cell = {"name": smoke.TRAIN_CELL, "driver": "train", "params": {},
            "chips": 1}
    r = core.Run(cell, {}, seed=1, seconds=1.0, trace=True,
                 device=torch.device("cpu"), t_start=0.0)
    part = r.parts["traced"]
    part.t0, part.t1 = 10.0, 11.5
    part.steps = [{"tokens": 1}] * steps
    gaps = [(10.28, 0.001), (10.45, 0.005), (10.5 + 0.15 + 0.01 + 0.0075,
                                            0.002), (11.35, 0.004)]
    ops, t = [], _ns(10.0)
    for mid, length in gaps:
        a = _ns(mid) - round(length * 1e9) // 2
        ops.append(("k", t, a - t))
        t = a + round(length * 1e9)
    ops.append(("k", t, _ns(11.45) - t))
    r.trace_data = trace.TraceData(ops, [], window_s=1.5)
    if records is None:
        records = (_step(10.0) + _step(10.5) + _step(11.0) +
                   [_span("train/step", 9.0, 9.4, 0.3)])  # before the part
    if counts is None:
        counts = [(9.5, "moe/slots", 999), (10.1, "moe/slots", 200),
                  (10.1, "moe/live_slots", 120), (10.6, "moe/slots", 200),
                  (10.6, "moe/live_slots", 100)]
    fake = FakeTracer(records, counts)
    monkeypatch.setattr(spans, "tracer", lambda: fake)
    return r


EXPECTED = {"forward_ms.train": 90.0, "backward_ms.train": 180.0,
            "optimizer_ms.train": 70.0,
            # 3 TM spans x 4 blocks x 4 ms a step
            "moe_tm_ms.train": 48.0, "moe_experts_ms.train": 20.0,
            "moe_slot_fill_pct.train": 55.0,
            # the median of steps 2 and 3 (2 ms, 4 ms): the first traced
            # step and the 5 ms between steps 1 and 2 left out
            "step_idle_ms.train": 3.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_known_spans(monkeypatch, name):
    r = _run(monkeypatch)
    got = core.load_module("metrics", name).read(r)
    assert got == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_the_process_tracer(monkeypatch, name):
    r = _run(monkeypatch)
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert core.load_module("metrics", name).read(r) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_traced_steps(monkeypatch, name):
    r = _run(monkeypatch, steps=0)
    assert core.load_module("metrics", name).read(r) is None


def test_spans_without_device_time_read_as_nothing(monkeypatch):
    records = [_span(s.name, s.t_start, s.t_end, None)
               for s in _step(10.0)]
    r = _run(monkeypatch, records=records)
    for name in READERS[:5]:
        assert core.load_module("metrics", name).read(r) is None


def test_idle_by_innermost_span_after_the_first_step(monkeypatch):
    r = _run(monkeypatch)
    by_name, per_step = spans.idle_by_span(r)
    # step 1's 1 ms in its backward is the first step's: left out
    assert by_name == pytest.approx({spans.NO_SPAN: 0.005,
                                     "moe/dispatch": 0.002,
                                     "train/optimizer": 0.004})
    assert per_step == pytest.approx([0.002, 0.004])


def test_step_idle_needs_a_step_after_the_first(monkeypatch):
    r = _run(monkeypatch, records=_step(10.0))
    assert spans.idle_by_span(r) is None
    assert spans.step_idle_ms(r) is None


def test_innermost_is_the_latest_started_open_span():
    s = [(0, 100, "step"), (10, 20, "a"), (30, 90, "b"), (40, 50, "c")]
    assert [spans._innermost(s, t) for t in (5, 15, 25, 45, 60, 95, 150)] \
        == ["step", "a", "step", "c", "b", "step", spans.NO_SPAN]


def test_counters_read_only_the_traced_part(monkeypatch):
    r = _run(monkeypatch)
    assert spans.counted(r, "moe/slots") == 400
    assert spans.counted(r, "moe/live_slots") == 220


def test_the_seven_entries_of_the_benchmark():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["workloads"] == [smoke.TRAIN_CELL]
        assert m["moves"] == "train_tokens_per_s"
        assert m["source"] == ("program_counter" if "fill" in name
                               else "program_span")


def test_smoke_cell_reads_the_programs_own_counters():
    """On the CPU the spans carry no device time, so only the slot fill
    reads; it is the process tracer's count over the traced part."""
    run = smoke.run(smoke.TRAIN_CELL, 7, trace=True)
    e2e, layer = core.cell_metrics(SPEC, smoke.TRAIN_CELL)
    line = core.result_line(run, e2e, layer)
    fill = line["metrics"]["moe_slot_fill_pct.train"]["value"]
    slots = spans.counted(run, "moe/slots")
    live = spans.counted(run, "moe/live_slots")
    assert fill == pytest.approx(100.0 * live / slots)
    # two layers, each in the forward and the recompute, every step
    c = smoke.cell(smoke.TRAIN_CELL)[0]["params"]
    d = smoke.MOE
    C = min(int(1.25 * c["seq"] * d["num_experts_per_tok"] /
                d["num_experts"]) + 1, c["seq"])
    per_step = 2 * d["num_hidden_layers"] * c["batch"] * \
        d["run_as"]["moe_pad_experts"] * C
    assert slots == per_step * len(run.parts["traced"].steps)
    assert 0 < fill <= 100.0 * c["seq"] * d["num_experts_per_tok"] / (
        d["run_as"]["moe_pad_experts"] * C)
    for name in READERS[:5] + ("step_idle_ms.train",):
        assert name not in line["metrics"]
