"""Trees of tensors (parameters, optimizer and recurrent state): nested
dicts, lists and tuples, the port's ``jax.tree``.

:func:`tree_leaves` visits the leaves in ``jax.tree.leaves``' order (dict
keys sorted), so a sum over leaves, such as the global gradient norm,
adds them in the JAX package's order.
"""

from __future__ import annotations


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest``, which have its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
