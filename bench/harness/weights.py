"""Weights drawn from the seed on the device, in the port's parameter
layout (``embed``, ``final_norm`` and ``blocks`` with a leading layer
axis), in the type they are served in.

Each leaf, and each layer of a stacked leaf, has a generator of its own
(:func:`bench.harness.core.derived_seed`), so the reference draws any one
of them again, alone, and gets the same values.
"""

from __future__ import annotations

import dataclasses

import torch

from bench.harness.core import derived_seed
from bench.harness.lmcfg import Dims


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: tuple[str, ...]
    shape: tuple[int, ...]     # one layer's shape where ``layered``
    dtype: str                 # "model" or "float32"
    mean: float
    std: float
    layered: bool

    @property
    def name(self) -> str:
        return ".".join(self.path)


def leaves(d: Dims) -> list[Leaf]:
    """Every leaf: the matrices and the table drawn as the published
    initialiser draws them, N(0, ``initializer_range``); the norms' gains
    N(1, 0.1), so that a gain the program dropped would show."""
    std = d.init_std

    def w(path, shape):
        return Leaf(("blocks",) + path, shape, "model", 0.0, std, True)

    out = [Leaf(("embed", "e"), (d.V, d.D), "model", 0.0, std, False),
           Leaf(("final_norm", "g"), (d.D,), "float32", 1.0, 0.1, False),
           w(("attn", "wqkv"), (d.D, (d.H + 2 * d.KV) * d.hd)),
           w(("attn", "wo"), (d.H * d.hd, d.D))]
    if d.moe:
        out += [w(("moe", "router"), (d.D, d.E)),
                w(("moe", "wi"), (d.E_phys, d.D, 2 * d.Fe)),
                w(("moe", "wo"), (d.E_phys, d.Fe, d.D)),
                w(("moe", "shared", "wi"), (d.D, 2 * d.F)),
                w(("moe", "shared", "wo"), (d.F, d.D))]
    else:
        out += [w(("mlp", "wi"), (d.D, 2 * d.F)),
                w(("mlp", "wo"), (d.F, d.D))]
    out += [Leaf(("blocks", n, "g"), (d.D,), "float32", 1.0, 0.1, True)
            for n in ("ln1", "ln2")]
    return out


def _dtype(leaf: Leaf, d: Dims):
    return getattr(torch, d.dtype if leaf.dtype == "model" else leaf.dtype)


def fill(t: torch.Tensor, seed: int, leaf: Leaf, layer: int | None):
    """Draw ``leaf`` (one ``layer`` of it) into the contiguous ``t``."""
    gen = torch.Generator(device=t.device).manual_seed(
        derived_seed(seed, "w", leaf.name, layer))
    return t.normal_(leaf.mean, leaf.std, generator=gen)


def draw(seed: int, d: Dims, leaf: Leaf, layer: int | None, device):
    """One layer of ``leaf`` (or the whole leaf if it is not stacked), as
    the program was given it."""
    return fill(torch.empty(leaf.shape, dtype=_dtype(leaf, d),
                            device=device), seed, leaf, layer)


def make_params(seed: int, d: Dims, device) -> dict:
    """The whole parameter tree, each stacked leaf drawn layer by layer
    into its slot."""
    tree: dict = {}
    for leaf in leaves(d):
        shape = ((d.L,) + leaf.shape) if leaf.layered else leaf.shape
        t = torch.empty(shape, dtype=_dtype(leaf, d), device=device)
        if leaf.layered:
            for i in range(d.L):
                fill(t[i], seed, leaf, i)
        else:
            fill(t, seed, leaf, None)
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = t
    return tree


def get(tree: dict, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def reference_weights(seed: int, d: Dims, device):
    """For the reference: the table, the final norm and a function drawing
    one layer's weights (under the names a layer reads: ``attn.wqkv``...),
    all drawn again from the seed, as float32."""
    by_name = {leaf.name: leaf for leaf in leaves(d)}

    def f32(name, layer=None):
        return draw(seed, d, by_name[name], layer, device).float()

    def layer_weights(i):
        return {leaf.name[len("blocks."):]: f32(leaf.name, i)
                for leaf in leaves(d) if leaf.layered}

    return f32("embed.e"), f32("final_norm.g"), layer_weights
