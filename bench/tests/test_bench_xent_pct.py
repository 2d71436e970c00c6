"""The reader of `xent_kernel_pct.train`: the share of the loss's
positions that the cross-entropy kernels took over the traced part, on
hand-built counters and on the smoke train cell."""

import pytest
import torch

from bench.harness import core, spans
from bench.tests import smoke

SPEC = core.benchmark_spec()
NAME = "xent_kernel_pct.train"


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


# 4096 rows before the part; in it 3 x 4096, of which 2 x 4096 by the
# kernels
COUNTS = [(9.9, "xent/rows", 4096), (9.9, "xent/kernel_rows", 4096),
          (10.2, "xent/rows", 4096), (10.2, "xent/kernel_rows", 4096),
          (10.7, "xent/rows", 4096), (10.7, "xent/kernel_rows", 4096),
          (11.2, "xent/rows", 4096)]


def _read(r):
    return core.load_module("metrics", NAME).read(r)


def test_reader_on_known_counters(monkeypatch):
    assert _read(_run(monkeypatch, COUNTS)) == pytest.approx(200 / 3,
                                                             rel=1e-9)


def test_reader_reads_every_row_by_the_kernels_as_100(monkeypatch):
    counts = [c for c in COUNTS if c[0] < 11.0]
    assert _read(_run(monkeypatch, counts)) == 100.0


@pytest.mark.parametrize("case", ["no_tracer", "no_steps", "no_counter"])
def test_reader_finds_nothing(monkeypatch, case):
    """No process tracer, no traced step, or a program that counts no
    loss rows (one older than the kernels): no reading."""
    if case == "no_steps":
        r = _run(monkeypatch, COUNTS, steps=0)
    elif case == "no_counter":
        r = _run(monkeypatch, [(10.4, "adamw/elems", 200)])
    else:
        r = _run(monkeypatch, COUNTS)
        monkeypatch.setattr(spans, "tracer", lambda: None)
    assert _read(r) is None


def test_the_entry_of_the_benchmark():
    m = {m["name"]: m for m in SPEC["per_layer"]}[NAME]
    assert m["workloads"] == [smoke.TRAIN_CELL]
    assert m["moves"] == "train_tokens_per_s"
    assert m["source"] == "program_counter"
    assert (m["unit"], m["better"], m["layer"]) == ("%", "higher", "models")
    assert SPEC["per_layer"][-1] is m  # appended after the accepted ones


def test_smoke_cell_counts_the_plain_path():
    """The CPU's logits take the plain loss: every row counted, none by
    the kernels."""
    run = smoke.run(smoke.TRAIN_CELL, 7, trace=True)
    e2e, layer = core.cell_metrics(SPEC, smoke.TRAIN_CELL)
    line = core.result_line(run, e2e, layer)
    assert spans.counted(run, "xent/rows") > 0
    assert spans.counted(run, "xent/kernel_rows") == 0
    assert line["metrics"][NAME]["value"] == 0.0
