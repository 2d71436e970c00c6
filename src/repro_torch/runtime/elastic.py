"""Elastic scaling: reshard a checkpointed state onto a different mesh.

The JAX package's ``runtime/elastic.py``.  Node failure at scale rarely
returns the same topology; the framework must restore a checkpoint saved on
mesh A onto mesh B (fewer or more ranks).  Because checkpoints are stored
as logical (unsharded) tensors and placements are derived from *logical
axis rules*, resharding is a ``distribute_tensor`` with the new mesh's
placements — no format conversion.

``global_batch`` stays fixed across re-meshes (the data pipeline re-splits
per-host shards), so training curves are reproducible across topologies.
"""

from __future__ import annotations


from torch.distributed.tensor import DTensor

from repro_torch.runtime.sharding import (distribute, is_placements,
                                           mesh_axes, tree_sharding)


def reshard_state(state, spec_tree, mesh, rules: dict | None = None):
    """``distribute_tensor`` every leaf of ``state`` with the placements
    derived from the logical ``spec_tree`` under ``mesh``/``rules``.  A
    leaf that is already a DTensor (on this mesh or another) is gathered
    whole first."""
    def put(x, placements):
        if is_placements(placements):
            if isinstance(x, DTensor):
                x = x.full_tensor()
            return distribute(x, mesh, placements)
        if isinstance(placements, dict):
            return {k: put(x[k], placements[k]) for k in x}
        return type(placements)(put(a, p) for a, p in zip(x, placements))

    return put(state, tree_sharding(spec_tree, mesh, rules))


def validate_elastic(cfg_batch: int, mesh) -> dict:
    """Check the fixed global batch still divides the new data extent."""
    sizes = mesh_axes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    ok = cfg_batch % dp == 0
    return {"data_parallel": dp, "per_shard_batch": cfg_batch // max(dp, 1),
            "divisible": ok}
