"""The harness: finds a cell's files by name, runs its driver once, and
prints the result line.

A cell is ``bench/workloads/<cell>.json``; it names its configuration
(``bench/configs/<config>.json``) and its driver
(``bench/drivers/<driver>.py``).  The metrics a run reports are the ones
``BENCHMARK.json`` lists for the cell: its end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``, each of the
latter read by ``bench/metrics/<metric>.py``.  Nothing here names a
cell, a configuration or a metric, so a new one is a new file.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class UnknownName(LookupError):
    """A cell, configuration, driver or metric with no file of its own."""


def _path(kind: str, name: str, suffix: str) -> Path:
    if not isinstance(name, str) or not NAME.match(name):
        raise UnknownName(f"{kind}: {name!r} is not a valid name")
    path = BENCH / kind / f"{name}{suffix}"
    if not path.is_file():
        raise UnknownName(f"{kind}: no file {path.relative_to(ROOT)}")
    return path


def load_json(kind: str, name: str) -> dict:
    data = json.loads(_path(kind, name, ".json").read_text())
    data["name"] = name
    return data


def load_cell(name: str) -> dict:
    return load_json("workloads", name)


def load_config(name: str) -> dict:
    return load_json("configs", name)


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so it is loaded from its file, not imported by name)."""
    path = _path(kind, name, ".py")
    key = f"bench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics ``spec`` gives ``cell``.  A
    per-layer metric without ``workloads`` belongs to every cell that
    reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def derived_seed(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run's seed and a tag path, so each
    input (a weight leaf, one layer's cache, one step's batch) can be drawn
    again alone."""
    text = ":".join(str(t) for t in (seed,) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & ((1 << 63) - 1)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

class Part:
    """The steps (or requests) of one part of the window and its host-clock
    span, synchronised with the device at both ends."""

    def __init__(self):
        self.steps: list[dict] = []
        self.t0 = self.t1 = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) if self.steps else 0.0


class Run:
    """What one run of a cell knows: its inputs, the window's two parts
    (untraced, then traced when ``trace``), the device trace, counters,
    end-to-end values and the comparisons that decide ``correct``."""

    def __init__(self, cell: dict, config: dict, *, seed: int,
                 seconds: float, trace: bool, device, t_start: float,
                 control: bool = False):
        self.cell, self.config = cell, config
        self.params = cell["params"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.control = control     # also read the control (calibration)
        self.parts = {"untraced": Part(), "traced": Part()}
        self.counters: dict = {}
        self.e2e: dict[str, float] = {}
        self.checks: list[tuple[str, float, float]] = []
        self.control_readings: dict[str, float] = {}
        self.attempted = self.failed = 0
        self.trace_data = None
        self.memory_peak_bytes = 0
        self._part = None
        self._prof = None
        self._trace_at = None

    # -- inputs --------------------------------------------------------------
    def generator(self, *tags):
        import torch
        return torch.Generator(device=self.device).manual_seed(
            derived_seed(self.seed, *tags))

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ----------------------------------------------------------
    def begin_window(self):
        """End of set-up: everything is built and warm.  Starts the clock."""
        import torch
        gc.collect()     # set-up's objects out of the collector's way
        gc.freeze()
        if self.trace:   # the profiler's own start-up, outside the window
            self._start_profiler()
            self._prof.__exit__(None, None, None)
            self._prof = None
        self.sync()
        now = time.monotonic()
        self.e2e["setup_s"] = now - self.t_start
        if self.device.type == "cuda":
            self.counters["setup_peak_bytes"] = \
                torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._trace_s = min(float(self.params.get("trace_seconds", 5)),
                            self.seconds / 2)
        self._trace_at = now + self.seconds - self._trace_s \
            if self.trace else None
        self._end = now + self.seconds
        self._part = self.parts["untraced"]
        self._part.t0 = now

    def running(self) -> bool:
        """Whether the window is still open; switches to the traced part
        (synchronised, the profiler started) when its time has come.  The
        traced part lasts its ``trace_seconds`` from the profiler's start,
        whatever the start took."""
        now = time.monotonic()
        if self._trace_at is not None and now >= self._trace_at:
            self._trace_at = None
            self.sync()
            self._part.t1 = time.monotonic()
            self._start_profiler()
            self._part = self.parts["traced"]
            now = self._part.t0 = time.monotonic()
            self._end = max(self._end, now + self._trace_s)
        return now < self._end

    def step_done(self, **info):
        self._part.steps.append(info)

    def end_window(self):
        import torch
        self.sync()
        self._part.t1 = time.monotonic()
        if self._prof is not None:
            self._stop_profiler()
        if self.device.type == "cuda":
            self.counters["window_peak_bytes"] = \
                torch.cuda.max_memory_allocated(self.device)
            self.memory_peak_bytes = max(
                self.counters["window_peak_bytes"],
                self.counters.get("setup_peak_bytes", 0))

    def all_steps(self) -> list[dict]:
        return self.parts["untraced"].steps + self.parts["traced"].steps

    def window_seconds(self) -> float:
        return sum(p.seconds for p in self.parts.values())

    # -- tracing -------------------------------------------------------------
    def _start_profiler(self):
        import torch.profiler as tp
        acts = [tp.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(tp.ProfilerActivity.CUDA)
        self._prof = tp.profile(activities=acts)
        self._prof.__enter__()

    def _stop_profiler(self):
        from bench.harness import trace as trace_mod
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.trace_data = trace_mod.TraceData.of(
            prof, window_s=self.parts["traced"].seconds)

    # -- correctness ---------------------------------------------------------
    def check(self, name: str, value: float, limit: float):
        """One number compared, with its limit: ``correct`` needs
        ``value <= limit`` (a NaN never passes)."""
        self.checks.append((name, float(value), float(limit)))

    def limit(self, name: str) -> float:
        return float(self.cell["limits"][name])

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            v <= lim for _, v, lim in self.checks)


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def _finite(v) -> float:
    v = float(v)
    if not math.isfinite(v):
        raise ValueError(f"metric value {v} is not finite")
    return v


def result_line(run: Run, e2e: list[dict], layer: list[dict]) -> dict:
    """The contract's JSON object for ``run``: the cell's end-to-end
    metrics (untraced) or its per-layer metrics (traced), each per-layer
    reader that finds nothing left out."""
    import torch
    metrics = {}
    if run.trace:
        for m in layer:
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": _finite(value),
                                      "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] not in run.e2e:
                raise KeyError(f"driver {run.cell['driver']} gave no "
                               f"{m['name']} for {run.cell['name']}")
            metrics[m["name"]] = {"value": _finite(run.e2e[m["name"]]),
                                  "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace and run.trace_data is not None:
        device["busy_s"] = run.trace_data.busy_s
        device["window_s"] = run.trace_data.window_s
        out["breakdown"] = run.trace_data.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in run.checks}
    return out


def run_cell(cell: dict, config: dict, *, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             control: bool = False) -> Run:
    """One run of ``cell`` on ``device`` through its driver."""
    run = Run(cell, config, seed=seed, seconds=seconds, trace=trace,
              device=device, t_start=t_start, control=control)
    load_module("drivers", cell["driver"]).run(run)
    return run


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = load_cell(args.workload)
        config = load_config(cell["config"])
        load_module("drivers", cell["driver"])
        e2e, layer = cell_metrics(benchmark_spec(), cell["name"])
        for m in layer if args.trace else ():
            load_module("metrics", m["name"])
    except UnknownName as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)   # the host's work is dispatch: one thread
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"bench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has {cards}", file=sys.stderr)
        return 3
    run = run_cell(cell, config, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=torch.device("cuda", 0),
                   t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"bench: the process holds {', '.join(found)} once the window "
              f"closed", file=sys.stderr)
        return 4
    line = result_line(run, e2e, layer)
    for name, v, lim in run.checks:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
