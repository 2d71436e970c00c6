#!/usr/bin/env python3
"""Where the time of a benchmark train cell's step goes, host and device.

    python3 profile_train.py [--workload qwen2-moe.train-b4x1024] \\
        [--seed N] [--steps 10,...]

The cell's model, weights, batches and schedule as ``bench/run.py`` builds
them (``bench.harness``), on the card: a script beside ``bench/``, since the
port's package imports nothing of the benchmark that measures it.  After three
warm steps it prints, as one dict:

* ``untraced_ms``: the wall ms a step over 20 steps run back to back;
* ``issue_ms``: the host's ms to issue one step after the device drained
  (five, sorted), and ``drained_step_ms`` the same steps to the device's
  end: where issue_ms is well below a step, the device sets the pace;
* under a profiler that records host and device (the benchmark's traced
  run), then under one that records the device alone, for each count of
  ``--steps`` (default 10): the wall ms a step, the first step's and the
  rest's, the device's busy ms a step and its idle share (``bench.harness.trace.TraceData``, as the
  benchmark's traced run reads them), and each span's device and host ms
  a step (the spans ``forward_ms.train`` and ``backward_ms.train`` read);
  a longer count shows whether the profiler's cost a step grows with the
  length of the window it records, the first step what starting it
  cold costs;
* ``peak_gib``: the peak allocated in each phase of one step: the forward
  (``lm_loss``), the backward (up to the optimizer's call) and the
  optimizer.

Prints the card's name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench.harness import core, lmcfg, weights  # noqa: E402
from bench.harness.trace import TraceData  # noqa: E402
from bench.reference import lm as ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.h100 import card_line  # noqa: E402
from repro_torch.runtime import step as step_mod  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="qwen2-moe.train-b4x1024")
    ap.add_argument("--seed", type=int, default=3300000011)
    ap.add_argument("--steps", default="10",
                    help="steps under each profiler, comma-separated")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    torch.set_num_threads(1)
    ref.exact_float32()
    cell = core.load_cell(args.workload)
    conf = core.load_config(cell["config"])
    p = cell["params"]
    dev = torch.device("cuda", 0)
    d = lmcfg.dims(conf)
    state = [step_mod.train_state_of(weights.make_params(args.seed, d, dev))]
    fn = step_mod.make_train_step(lmcfg.port_config(conf),
                                  peak_lr=p["peak_lr"], warmup=p["warmup"],
                                  total=p["total"], max_norm=p["max_norm"])
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def steps(n: int) -> None:
        for _ in range(n):
            rows = torch.randint(0, d.V, (p["batch"], p["seq"] + 1),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
            state[0], _ = fn(state[0], {"tokens": rows[:, :-1],
                                        "labels": rows[:, 1:]})

    steps(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(20)
    torch.cuda.synchronize()
    out = {"untraced_ms": (time.perf_counter() - t0) * 1e3 / 20}
    issue, drained = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(1)
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        drained.append((time.perf_counter() - t0) * 1e3)
    out["issue_ms"], out["drained_step_ms"] = sorted(issue), sorted(drained)
    # host and device first: the benchmark's traced run starts its
    # profiler in a process that has run none
    kinds = (("host_and_device", [ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]),
             ("device_only", [ProfilerActivity.CUDA]))
    for n in map(int, args.steps.split(",")):
        for name, acts in kinds:
            out[f"{name}_{n}"] = profiled(steps, n, acts)

    peaks: dict[str, float] = {}
    real = step_mod.lm_loss, step_mod.adamw_update

    def phase(name: str) -> None:
        peaks[name] = torch.cuda.max_memory_allocated(dev) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)

    def lm_loss(*a, **k):
        r = real[0](*a, **k)
        phase("forward")
        return r

    def adamw_update(*a, **k):
        phase("backward")
        r = real[1](*a, **k)
        phase("optimizer")
        return r

    step_mod.lm_loss, step_mod.adamw_update = lm_loss, adamw_update
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        steps(1)
    finally:
        step_mod.lm_loss, step_mod.adamw_update = real
    out["peak_gib"] = peaks
    print(out, flush=True)


def profiled(steps, n: int, acts) -> dict:
    """``steps(n)`` under a profiler of ``acts``: the wall and busy ms a
    step, the idle share, each span's device and host ms a step; the
    first step's wall ms apart (synchronised after it) and the rest's a
    step."""
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps(1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps(n - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a call outside the session ends it, so the next starts clean
    obs.current()
    td = TraceData.of(prof, wall)
    spans: dict[str, list[float]] = {}
    for sp in obs.process_tracer().spans():
        ms = spans.setdefault(sp.name, [0.0, 0.0])
        ms[0] += (sp.device_s or 0.0) * 1e3 / n
        ms[1] += (sp.t_end - sp.t_start) * 1e3 / n
    return {"step_ms": wall * 1e3 / n, "first_step_ms": (t1 - t0) * 1e3,
            "rest_step_ms": (t0 + wall - t1) * 1e3 / max(n - 1, 1),
            "busy_ms": td.busy_s * 1e3 / n,
            "idle_pct": 100 * (1 - td.busy_s / wall),
            "spans_device_host_ms": {k: (round(a, 3), round(b, 3))
                                     for k, (a, b) in spans.items()}}


if __name__ == "__main__":
    main()
