"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on one
rank of a fake process group and count its per-device cost.

The JAX package's ``launch/dryrun.py``, which lowers and compiles each cell
for 256 or 512 host devices.  Here nothing is compiled and nothing is
allocated: the process joins a ``"fake"`` process group of the mesh's size
as rank 0, builds the production DeviceMesh over it, places the cell's
state, parameters, caches and inputs on it as DTensors whose local shards
are meta tensors (:func:`repro_torch.runtime.elastic.reshard_state` under
the cell's ``specialize_rules(rules_for_cell(...))``), and runs the real
step once under :class:`repro_torch.launch.cost.CostCounter`, which sees
this rank's local aten ops and the collectives DTensor issues.  For each
cell it records:

  * flops / bytes / collective bytes per device, the collectives by kind
    (the cost model of ``launch/cost.py``, the JAX ``hlo_cost``'s);
  * ``matmul_flops``, FlopCounterMode's count over the same local ops;
  * per-device memory: argument, output and temporary bytes and their peak,
    against the card's HBM;
  * the roofline terms against one H100, the dominant one, the model FLOPs
    (6·N·D train, 2·N·D inference) and the step-time bound.

The step is the one the card runs: ``make_train_step`` (plain attention,
remat) for train cells, the ``runtime/step.py`` serving builders with
flash attention (its custom ops, traced through their sharding rules) for
prefill and decode.  A cell that cannot be traced (an unevenly sharded
dim DTensor cannot view, for one) is a ``[FAIL]`` with its reason, and
the exit code is non-zero.  No GPU is needed.

Usage:
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b \\
      --shape train_4k --mesh single --out experiments/dryrun
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, cell_is_live,
                                        input_specs, shape_spec)
from repro_torch.h100 import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from repro_torch.launch.cost import CostCounter, local_bytes
from repro_torch.launch.mesh import (fake_process_group, make_production_mesh,
                                     rules_for_cell, specialize_rules)
from repro_torch.models.transformer import ModelConfig, init_lm, lm_specs
from repro_torch.runtime import sharding as shard_lib
from repro_torch.runtime.elastic import reshard_state
from repro_torch.runtime.step import (init_train_state, make_decode_step,
                                      make_prefill_embeds_step,
                                      make_prefill_step, make_train_step,
                                      serve_state_specs, state_specs)
from repro_torch.tree import tree_map

# -- hardware (one NVIDIA H100 SXM, NVIDIA's data sheet; its peaks are
# repro_torch.h100's) -----------------------------------------------------
HBM_BYTES = 80e9         # bytes of HBM a device (the fits-HBM verdict)
# bytes/s a device for collectives: one 400 Gb/s NDR InfiniBand NIC per GPU
# in a DGX H100; both 16-wide mesh axes cross nodes of 8 GPUs, so the
# slowest hop of every collective is the NIC, not NVLink
LINK_BW = 50e9


def _abstract(fn):
    """``fn()``'s tree of tensors as meta tensors: the draws run under
    FakeTensorMode, so a full-size config allocates nothing."""
    with FakeTensorMode():
        tree = fn()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def abstract_train_state(cfg: ModelConfig, compress: bool = False):
    return _abstract(lambda: init_train_state(
        cfg, torch.Generator().manual_seed(0), compress=compress,
        device="cpu"))


def abstract_params(cfg: ModelConfig):
    return _abstract(lambda: init_lm(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"))


def _placed(t, names, mesh, rules):
    """A meta input onto ``mesh`` with its logical axes' placements."""
    return shard_lib.distribute(t, mesh, shard_lib.placements_of(
        shard_lib.spec_of_names(names, mesh, rules), mesh))


def cell_rules(cfg: ModelConfig, shape: str | ShapeSpec, mesh) -> dict:
    sp = shape_spec(shape)
    long_ctx = sp.name == "long_500k"
    return specialize_rules(rules_for_cell(sp.kind, long_context=long_ctx),
                            cfg, mesh)


def build_cell(cfg: ModelConfig, shape: str | ShapeSpec, mesh, *,
               compress: bool = False):
    """Returns ``(step, args)``: ``step(*args)`` runs the cell's step once
    on ``args``, DTensors on ``mesh`` with meta local shards, under the
    cell's rules.  ``mesh`` is a DeviceMesh over the process group the
    caller set up."""
    sp = shape_spec(shape)
    rules = cell_rules(cfg, sp, mesh)
    specs_in = input_specs(cfg, sp)

    def under_rules(fn):
        def step(*args):
            with shard_lib.use_rules(mesh, rules):
                return fn(*args)
        return step

    if sp.kind == "train":
        state = reshard_state(abstract_train_state(cfg, compress),
                              state_specs(lm_specs(cfg), compress=compress),
                              mesh, rules)
        batch = {k: _placed(v, ("batch", None, "embed") if k == "embeds"
                            else ("batch", None), mesh, rules)
                 for k, v in specs_in["batch"].items()}
        return under_rules(make_train_step(cfg, compress=compress)), \
            (state, batch)

    params = reshard_state(abstract_params(cfg), lm_specs(cfg), mesh, rules)
    c_specs, s_specs = serve_state_specs(cfg,
                                         long_context=sp.name == "long_500k")
    caches = specs_in.get("caches")
    states = specs_in.get("states")
    if caches is not None:
        caches = reshard_state(caches, c_specs, mesh, rules)
    if states is not None:
        states = reshard_state(states, s_specs, mesh, rules)

    if sp.kind == "prefill":
        if "embeds" in specs_in:
            fn = make_prefill_embeds_step(cfg)
            tok = _placed(specs_in["embeds"], ("batch", None, "embed"), mesh,
                          rules)
        else:
            fn = make_prefill_step(cfg)
            tok = _placed(specs_in["tokens"], ("batch", None), mesh, rules)
        return under_rules(fn), (params, tok, caches, states)

    # decode: one new token at the last position of a seq_len-deep cache
    token = _placed(specs_in["token"], ("batch", None), mesh, rules)
    return under_rules(make_decode_step(cfg)), \
        (params, token, caches, states, sp.seq_len - 1)


def model_flops(cfg: ModelConfig, shape: str | ShapeSpec) -> float:
    """6·N_active·D for training, 2·N_active·D for inference (per step)."""
    sp = shape_spec(shape)
    n = cfg.active_param_count()
    if sp.kind == "train":
        return 6.0 * n * sp.global_batch * sp.seq_len
    if sp.kind == "prefill":
        return 2.0 * n * sp.global_batch * sp.seq_len
    return 2.0 * n * sp.global_batch  # decode: one token per sequence


def record(cfg: ModelConfig, shape: str | ShapeSpec, mesh, *,
           compress: bool = False) -> dict:
    """Trace one cell on ``mesh`` and return its cost fields."""
    chips = mesh.size()
    t0 = time.time()
    step, args = build_cell(cfg, shape, mesh, compress=compress)
    counter = CostCounter(args)
    with counter:
        out = step(*args)
    trace_s = time.time() - t0
    tot = counter.totals
    arg_bytes, out_bytes = local_bytes(args), local_bytes(out)
    peak = arg_bytes + counter.temp_peak_bytes
    t_compute = tot.flops / BF16_FLOP_PER_S
    t_memory = tot.bytes / HBM_BYTES_PER_S
    t_coll = tot.collective_bytes / LINK_BW
    mf = model_flops(cfg, shape)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    return {
        "chips": chips,
        "trace_s": round(trace_s, 2),
        "flops_per_device": tot.flops,
        "bytes_per_device": tot.bytes,
        "collective_bytes_per_device": tot.collective_bytes,
        "collectives": {k: int(v) for k, v in tot.coll.items()},
        "matmul_flops": tot.matmul_flops,
        "memory_analysis": {"argument_bytes": arg_bytes,
                            "output_bytes": out_bytes,
                            "temp_bytes": counter.temp_peak_bytes,
                            "peak_bytes": peak},
        "fits_hbm": peak <= HBM_BYTES,
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": mf / max(tot.flops * chips, 1.0),
        "step_time_bound_s": max(terms.values()),
    }


def _device_type() -> str:
    # the card's mesh where there is one; the local shards are meta
    # tensors either way, so the trace needs no GPU
    return "cuda" if torch.cuda.is_available() else "cpu"


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             out_dir: str | None = None, compress: bool = False) -> dict:
    cfg = get_config(arch)
    live, reason = cell_is_live(cfg, shape_name)
    mesh_name = "multi" if multi_pod else "single"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "live": live, "reason": reason}
    if not live:
        return rec
    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=_device_type())
        rec.update(record(cfg, shape_name, mesh, compress=compress))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--compress", action="store_true",
                    help="enable int8 gradient compression in train cells")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    ok = True
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, mp, out_dir=args.out,
                               compress=args.compress)
                if not rec["live"]:
                    print(f"[skip] {arch} {shape} "
                          f"{'multi' if mp else 'single'}: {rec['reason']}")
                    continue
                print(f"[ok]   {arch} {shape} {'multi' if mp else 'single'} "
                      f"chips={rec['chips']} "
                      f"trace={rec['trace_s']}s "
                      f"dom={rec['dominant']} "
                      f"t=({rec['compute_s']:.3e},{rec['memory_s']:.3e},"
                      f"{rec['collective_s']:.3e})s "
                      f"useful={rec['useful_flops_ratio']:.2f}", flush=True)
            except Exception as e:  # a failed cell is a bug in the system
                ok = False
                print(f"[FAIL] {arch} {shape} {'multi' if mp else 'single'}: "
                      f"{type(e).__name__}: {e}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
