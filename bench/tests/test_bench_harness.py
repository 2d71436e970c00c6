"""The harness finds each configuration, cell, driver and metric by its
file name, refuses an unknown name, and prints the contract's line."""

import json
import re

import pytest
import torch

from bench.harness import core, trace
from bench.tests import smoke

SPEC = core.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_has_its_file():
    for c in SPEC["configs"]:
        assert core.load_config(c["name"])["name"] == c["name"]
        assert c["file"] == f"bench/configs/{c['name']}.json"
    for w in SPEC["workloads"]:
        cell = core.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        core.load_module("drivers", cell["driver"])
    for m in SPEC["per_layer"]:
        assert callable(core.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("kind,name", [
    ("workloads", "no-such-cell"), ("configs", "no-such-config"),
    ("drivers", "no_such_driver"), ("metrics", "no_such.metric"),
    ("workloads", "../BENCHMARK"), ("configs", "a/b")])
def test_unknown_name_is_refused(kind, name):
    with pytest.raises(core.UnknownName):
        core.load_json(kind, name) if kind in ("workloads", "configs") \
            else core.load_module(kind, name)


def test_main_refuses_an_unknown_cell(capsys):
    assert core.main(["--workload", "no-such-cell", "--seed", "1",
                      "--seconds", "1"], 0.0) == 2
    assert "no-such-cell" in capsys.readouterr().err


def test_main_refuses_without_the_cards_it_needs(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert core.main(["--workload", smoke.DECODE_CELL, "--seed", "1",
                      "--seconds", "1"], 0.0) == 3
    assert capsys.readouterr().out == ""


def test_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        e2e_here, layer_here = core.cell_metrics(SPEC, w["name"])
        assert "setup_s" in {m["name"] for m in e2e_here}
        assert len(e2e_here) >= 2 and layer_here
        assert {m["moves"] for m in layer_here} <= {m["name"]
                                                   for m in e2e_here}
        assert core.load_cell(w["name"])["limits"]


def test_trace_reduction():
    ops = [("k1", 0, 10), ("k2", 5, 10), ("Memcpy HtoD", 30, 5),
           ("k1", 50, 10)]
    host = [(0, 100, "step"), (14, 40, "aten::mm"), (36, 55, "cudaLaunch")]
    t = trace.TraceData(ops, host, window_s=1e-7)
    assert t.intervals == [(0, 15), (30, 35), (50, 60)]
    assert t.busy_s == pytest.approx(30e-9)
    assert t.kernel_count() == 3
    assert t.kernel_seconds("k1") == (pytest.approx(20e-9), 2)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-9)]
    # the gap 15-30 is under aten::mm, the gap 35-50 under cudaLaunch
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "aten::mm": pytest.approx(15e-9), "cudaLaunch": pytest.approx(15e-9)}


@pytest.mark.parametrize("cell", [smoke.TRAIN_CELL, smoke.DECODE_CELL])
def test_result_line(cell):
    run = smoke.run(cell, 3, trace=True)
    e2e, layer = core.cell_metrics(SPEC, cell)
    line = core.result_line(run, e2e, layer)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == set(smoke.LIMITS[cell])
    json.dumps(line)
    run.trace = False
    untraced = core.result_line(run, e2e, layer)
    assert set(untraced["metrics"]) == {m["name"] for m in e2e}
    assert "breakdown" not in untraced


def test_a_seed_draws_the_same_inputs():
    from bench.harness import lmcfg, weights
    d = lmcfg.dims(smoke.MOE)
    a, b, c = (weights.make_params(s, d, "cpu") for s in (2 ** 31 + 5,
                                                           2 ** 31 + 5, 6))
    for leaf in weights.leaves(d):
        x, y, z = (weights.get(t, leaf.path) for t in (a, b, c))
        assert torch.equal(x, y) and not torch.equal(x, z)
        if leaf.layered:   # one layer drawn again alone is the same
            assert torch.equal(weights.draw(2 ** 31 + 5, d, leaf, 1, "cpu"),
                               x[1])
