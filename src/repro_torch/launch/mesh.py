"""Production meshes + per-cell sharding rules (the JAX package's
``launch/mesh.py``).

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis is an
outer data-parallel axis whose gradient all-reduce crosses the (slower)
inter-pod links — the axis gradient compression targets.

The meshes are ``torch.distributed`` DeviceMeshes built with
``init_device_mesh`` over the process group the caller set up: NCCL on
the card (:func:`card_process_group`), or the ``"fake"`` backend, which
lets one process stand for every rank of a mesh it traces but never runs
(:func:`fake_process_group`, the dry-run's).
"""

from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.runtime.sharding import mesh_axes


def _mesh(shape, axes, device_type: str):
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Reduced mesh for CI-scale dry-run tests (8 ranks)."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks in this process,
    this one rank 0: collectives are recorded by the DTensor layer and
    never sent.  Destroyed on exit."""
    # a testing module of PyTorch's; imported here, where it is used
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def card_process_group():
    """A one-rank NCCL process group on the card, its store in this
    process (no TCP rendezvous), for the (1, 1) card mesh.  Destroyed on
    exit."""
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rules_for_cell(kind: str, *, long_context: bool = False,
                   batch_is_sharded: bool = True) -> dict:
    """Logical-axis rules per shape kind (see runtime.sharding.DEFAULT_RULES).

    train    — DP batch over (pod, data); TP heads/mlp/vocab/experts over
               model; SP activation seq over model; FSDP weights over data.
    prefill  — same as train minus FSDP-on-master (no optimizer state).
    decode   — seq axis is 1: no SP; batch over (pod, data).
    long     — batch=1: KV-cache/attention sequence over data instead
               (flash-decode-style distributed attention).
    """
    rules = {
        "batch": ("pod", "data") if batch_is_sharded else None,
        "seq": ("model",) if kind in ("train", "prefill") else None,
        # decode: KV-cache sequence sharded over the model axis -> GSPMD
        # emits the distributed flash-decode pattern (partial softmax +
        # tiny psums); long-context (batch=1) shards it over data instead.
        "kv_seq": (("data",) if long_context else ("model",))
        if kind == "decode" else None,
        "embed": None,
        "embed_fsdp": ("data",) if kind == "train" else None,
        "heads": ("model",),
        "kv_heads": None,
        "head_dim": None,
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_mlp": None,
        "layers": None,
        "state": None,
        "conv": None,
        "cap": None,
    }
    if long_context:
        rules["batch"] = None
    return rules


def specialize_rules(rules: dict, cfg, mesh) -> dict:
    """Arch-aware rule fixes for divisibility.

    MoE expert parallelism needs num_experts % model_size == 0 (llama4: 16
    experts over model=16).  When it does not divide (qwen2: 60 experts),
    fall back to tensor parallelism *within* each expert: experts
    replicated, expert hidden dim sharded over model."""
    sizes = mesh_axes(mesh)
    model = sizes.get("model", 1)
    rules = dict(rules)
    if getattr(cfg, "family", None) == "moe":
        if cfg.num_experts_padded % model:
            rules["experts"] = None
            rules["expert_mlp"] = ("model",)
        # §Perf hillclimb B2: sequence parallelism conflicts with token
        # dispatch (the per-sequence gather needs the full local sequence),
        # costing an extra all-gather per MoE layer per direction.  Measured
        # to win for high-expert-count archs (qwen2: E=60, small d_model)
        # and to LOSE for llama4 (E=16, d5120 — the SP savings on its large
        # dense-attention activations outweigh the dispatch gathers), so it
        # is opt-in per arch.
        if rules.get("seq") and getattr(cfg, "moe_drop_sp", False):
            rules["seq"] = None
    return rules
