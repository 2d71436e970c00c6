"""The reader of `adamw_kernel_pct.train`: the share of the optimizer's
elements that the fused AdamW kernels updated over the traced part, on
hand-built counters and on the smoke train cell."""

import pytest
import torch

from bench.harness import core, spans
from bench.tests import smoke

SPEC = core.benchmark_spec()
NAME = "adamw_kernel_pct.train"


class FakeTracer:
    """What the reader needs of the program's process tracer."""

    def __init__(self, counts):
        self.counts = counts

    def count_between(self, name, t_from, t_to):
        return sum(v for t, n, v in self.counts
                   if n == name and t_from <= t <= t_to)


def _run(monkeypatch, counts, steps=3):
    """A traced part from 10 s to 11.5 s with ``steps`` steps, whose
    process tracer holds ``counts`` as (time, name, delta)."""
    cell = {"name": smoke.TRAIN_CELL, "driver": "train", "params": {},
            "chips": 1}
    r = core.Run(cell, {}, seed=1, seconds=1.0, trace=True,
                 device=torch.device("cpu"), t_start=0.0)
    part = r.parts["traced"]
    part.t0, part.t1 = 10.0, 11.5
    part.steps = [{"tokens": 1}] * steps
    fake = FakeTracer(counts)
    monkeypatch.setattr(spans, "tracer", lambda: fake)
    return r


# 77 elements before the part; in it 2000, of which 1500 by the kernels
COUNTS = [(9.9, "adamw/elems", 77), (9.9, "adamw/kernel_elems", 77),
          (10.4, "adamw/elems", 1000), (10.4, "adamw/kernel_elems", 1000),
          (10.9, "adamw/elems", 1000), (10.9, "adamw/kernel_elems", 500)]


def _read(r):
    return core.load_module("metrics", NAME).read(r)


def test_reader_on_known_counters(monkeypatch):
    assert _read(_run(monkeypatch, COUNTS)) == pytest.approx(75.0, rel=1e-9)


@pytest.mark.parametrize("case", ["no_tracer", "no_steps", "no_counter"])
def test_reader_finds_nothing(monkeypatch, case):
    """No process tracer, no traced step, or a program that counts no
    AdamW elements (one older than the fused kernels): no reading."""
    if case == "no_steps":
        r = _run(monkeypatch, COUNTS, steps=0)
    elif case == "no_counter":
        r = _run(monkeypatch, [(10.4, "moe/slots", 200)])
    else:
        r = _run(monkeypatch, COUNTS)
        monkeypatch.setattr(spans, "tracer", lambda: None)
    assert _read(r) is None


def test_the_entry_of_the_benchmark():
    m = {m["name"]: m for m in SPEC["per_layer"]}[NAME]
    assert m["workloads"] == [smoke.TRAIN_CELL]
    assert m["moves"] == "train_tokens_per_s"
    assert m["source"] == "program_counter"
    assert (m["unit"], m["better"], m["layer"]) == ("%", "higher",
                                                    "optimizer")


def test_smoke_cell_counts_the_plain_path():
    """The CPU's leaves take the plain AdamW: every element counted, none
    by the kernels."""
    run = smoke.run(smoke.TRAIN_CELL, 7, trace=True)
    e2e, layer = core.cell_metrics(SPEC, smoke.TRAIN_CELL)
    line = core.result_line(run, e2e, layer)
    assert spans.counted(run, "adamw/elems") > 0
    assert spans.counted(run, "adamw/kernel_elems") == 0
    assert line["metrics"][NAME]["value"] == 0.0
