"""The port's dry-run on reduced meshes against the JAX package's, on the
CPU (the twin of ``tests/test_dryrun_mini.py``).

In a subprocess (the JAX half needs its own host-device count before JAX
starts; the port's half joins fake process groups): the same four (arch,
shape) cells, smoke configs at the JAX test's reduced shapes, on the
(2, 2) and (2, 2, 2) test meshes.  The port's per-device FLOPs, bytes and
collectives are counted by ``launch/cost.py`` over the local aten ops of
one traced step; the JAX package's by ``hlo_cost.analyze`` on the compiled
module of its ``build_cell``, its mesh built with ``Auto`` axes.  Then the
port alone on a (4, 1) pure data-parallel mesh, whose products split over
the batch exactly.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = os.path.join(os.path.dirname(__file__), "..")

_REDUCED = r"""
SHAPES = {"train_4k": ("train_4k", 64, 8, "train"),
          "prefill_32k": ("prefill_32k", 64, 4, "prefill"),
          "decode_32k": ("decode_32k", 64, 8, "decode"),
          "long_500k": ("long_500k", 256, 1, "decode")}
CELLS = [("granite-8b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
         ("rwkv6-3b", "decode_32k"), ("zamba2-7b", "prefill_32k")]
"""

_SCRIPT = _REDUCED + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import math
import jax
from jax.sharding import AxisType
from repro.configs import shapes as JS
from repro.configs.registry import get_smoke as jax_smoke
from repro.launch import dryrun as JD
from repro.launch import hlo_cost
from repro_torch.configs import shapes as TS
from repro_torch.configs.registry import get_smoke
from repro_torch.launch import dryrun as TD
from repro_torch.launch.mesh import fake_process_group, make_test_mesh

JS.SHAPES = {k: JS.ShapeSpec(*v) for k, v in SHAPES.items()}
JD.SHAPES = JS.SHAPES
TS.SHAPES.update({k: TS.ShapeSpec(*v) for k, v in SHAPES.items()})
results = {}
for arch, shape in CELLS:
    for multi in (False, True):
        key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
        dims = (2, 2, 2) if multi else (2, 2)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        jmesh = jax.make_mesh(dims, axes,
                              axis_types=(AxisType.Auto,) * len(axes))
        jitted, args = JD.build_cell(jax_smoke(arch), shape, jmesh)
        t = hlo_cost.analyze(jitted.lower(*args).compile().as_text())
        with fake_process_group(math.prod(dims)):
            mesh = make_test_mesh(multi_pod=multi, device_type="cpu")
            rec = TD.record(get_smoke(arch), shape, mesh)
        results[key] = {"jax_flops": t.flops, "jax_bytes": t.bytes,
                        "jax_coll": t.collective_bytes,
                        "flops": rec["flops_per_device"],
                        "bytes": rec["bytes_per_device"],
                        "coll": rec["collective_bytes_per_device"],
                        "collectives": rec["collectives"],
                        "peak": rec["memory_analysis"]["peak_bytes"]}
print(json.dumps(results))
"""

_DP_SCRIPT = _REDUCED + r"""
import json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import shapes as TS
from repro_torch.configs.registry import get_smoke
from repro_torch.launch import dryrun as TD
from repro_torch.launch.mesh import fake_process_group

TS.SHAPES.update({k: TS.ShapeSpec(*v) for k, v in SHAPES.items()})
out = {}
for arch in ("granite-8b", "qwen2-moe-a2.7b"):
    for n in (1, 4):
        with fake_process_group(n):
            mesh = init_device_mesh("cpu", (n, 1),
                                    mesh_dim_names=("data", "model"))
            rec = TD.record(get_smoke(arch), "train_4k", mesh)
        out[f"{arch}|{n}"] = [rec["matmul_flops"],
                              rec["collective_bytes_per_device"]]
print(json.dumps(out))
"""


def _run(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + ROOT
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_mini_dryrun_all_families():
    """Every cell traces on both meshes with FLOPs and bytes > 0, a train
    cell with collectives (the data-parallel gradient reduction); the
    port's per-device FLOPs within 35% of the JAX package's on the same
    cell (measured 1.10-1.29 times: the port counts each eager op's
    result where XLA fuses, and the attention's heads run gathered over
    "model", where GSPMD keeps them sharded)."""
    results = _run(_SCRIPT)
    assert len(results) == 8
    for key, rec in results.items():
        assert rec["flops"] > 0 and rec["bytes"] > 0, key
        assert rec["peak"] > 0, key
        if "train" in key:
            assert rec["coll"] > 0 and rec["collectives"].get(
                "all-reduce", 0) + rec["collectives"].get(
                "reduce-scatter", 0) > 0, key
        ratio = rec["flops"] / rec["jax_flops"]
        assert 0.65 <= ratio <= 1.35, (key, ratio)


def test_data_parallel_mesh_splits_products_exactly():
    """On a (4, 1) data-parallel mesh every rank computes a quarter of the
    batch: its matmul FLOPs times 4 equal the one-rank count exactly, and
    only the 4-rank mesh moves bytes."""
    out = _run(_DP_SCRIPT)
    for arch in ("granite-8b", "qwen2-moe-a2.7b"):
        one, four = out[f"{arch}|1"], out[f"{arch}|4"]
        assert four[0] * 4 == one[0], arch
        assert one[1] == 0 and four[1] > 0, arch
