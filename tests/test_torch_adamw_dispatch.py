"""Where ``adamw_update``'s tensors live decides its pass: CPU (and meta)
leaves take the plain eager version, card leaves the kernels of
``csrc/adamw.cu``.  The kernels run only on the card
(``tests/test_torch_gpu.py`` holds them against the plain version); here
the wiring around them runs with a PyTorch mirror of each kernel in their
place, and the split of a tree into the kernels' tables."""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.kernels import adamw as ak
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     adamw_update_plain, global_norm,
                                     global_norm_plain)
from repro_torch.tree import tree_leaves, tree_map

# keys out of sorted order: the update's tree order is not the leaves' order
SIZES = {"z": (5, 3), "a": (7,), "m": (0,), "b": (2, 2, 2)}


def _tree(seed, dtype=torch.bfloat16, sizes=SIZES, device="cpu"):
    """(grads, params) drawn from ``seed``; gradients small enough that the
    clip scale is 1."""
    rng = np.random.RandomState(seed)
    grads = {k: torch.tensor(rng.randn(*s).astype(np.float32) * 1e-2)
             .to(dtype).to(device) for k, s in sizes.items()}
    params = {k: torch.tensor(rng.randn(*s).astype(np.float32))
              .to(dtype).to(device) for k, s in sizes.items()}
    return grads, params


def _clone(state):
    return AdamWState(step=state.step.clone(),
                      master=tree_map(torch.clone, state.master),
                      m=tree_map(torch.clone, state.m),
                      v=tree_map(torch.clone, state.v))


def test_cpu_tree_takes_the_plain_path_and_counts_its_elements():
    grads, params = _tree(0)
    state = adamw_init(params)
    twin, twin_params = _clone(state), tree_map(torch.clone, params)
    before = ak.adamw_sumsq.launches, ak.adamw_apply.launches
    tr = obs.Tracer()
    with obs.use(tr):
        new, state, met = adamw_update(grads, state, 1e-2, params=params)
    assert (ak.adamw_sumsq.launches, ak.adamw_apply.launches) == before
    assert tr.counters() == {"adamw/elems": 15 + 7 + 0 + 8}
    want, twin, wmet = adamw_update_plain(grads, twin, 1e-2,
                                          params=twin_params)
    assert torch.equal(met["grad_norm"], wmet["grad_norm"])
    for a, b in zip(tree_leaves([new, state.master, state.m, state.v]),
                    tree_leaves([want, twin.master, twin.m, twin.v])):
        assert torch.equal(a, b)
    assert torch.equal(global_norm(grads), global_norm_plain(grads))


def test_meta_tree_takes_the_plain_path():
    """The dry-run's leaves are meta tensors: the plain version traces
    them, no kernel is asked for."""
    grads, params = _tree(1, device="meta")
    state = adamw_init(params)
    before = ak.adamw_sumsq.launches, ak.adamw_apply.launches
    new, state, met = adamw_update(grads, state, torch.zeros((),
                                                             device="meta"),
                                   params=params)
    assert (ak.adamw_sumsq.launches, ak.adamw_apply.launches) == before
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in tree_leaves(new))


@pytest.mark.parametrize("n,lengths", [(0, []), (1, [1]), (64, [64]),
                                       (65, [64, 1]), (150, [64, 64, 22])])
def test_tables_split_a_tree_of_many_leaves(n, lengths):
    """Consecutive runs of at most ``TABLE`` (64, the C table's
    ``kMaxLeaves``) leaves, in order, covering each leaf once."""
    tables = ak.tables(n)
    assert [len(r) for r in tables] == lengths
    assert [i for r in tables for i in r] == list(range(n))


def _mirror(monkeypatch):
    """Card leaves in name: ``_on_card`` says yes and each kernel is a
    PyTorch mirror of its arithmetic; returns the calls made."""
    calls = {"sumsq": [], "apply": []}

    def sumsq(grads):
        calls["sumsq"].append(len(grads))
        return torch.stack([g.float().square().sum() for g in grads])

    def apply(g, w, m, v, out, *, scale, c1, c2, lr, b1, b2, eps,
              weight_decay):
        calls["apply"].append(len(g))
        for gi, wi, mi, vi, oi in zip(g, w, m, v, out):
            x = gi.float() * scale
            mi.mul_(b1).add_(x, alpha=1 - b1)
            vi.mul_(b2).addcmul_(x, x, value=1 - b2)
            u = (mi / c1).div_((vi / c2).sqrt_().add_(eps))
            wi.sub_(u.add_(wi, alpha=weight_decay).mul_(lr))
            oi.copy_(wi)

    monkeypatch.setattr(tadamw, "_on_card", lambda leaves: True)
    monkeypatch.setattr(tadamw, "adamw_sumsq", sumsq)
    monkeypatch.setattr(tadamw, "adamw_apply", apply)
    return calls


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
def test_card_path_pairs_each_leaf_with_its_state(monkeypatch, param_dtype):
    """With the kernels mirrored: one call of each over every leaf, each
    gradient with its own master, m, v and parameter; the parameter
    written in place where it has ``param_dtype``, a new tensor where not;
    the result the plain version's bit for bit (the clip scale is 1), the
    norm within the order of its sum; both counters."""
    grads, params = _tree(2)
    params["a"] = params["a"].float()  # a leaf of another dtype
    state = adamw_init(params)
    twin, twin_params = _clone(state), tree_map(torch.clone, params)
    calls = _mirror(monkeypatch)
    tr = obs.Tracer()
    with obs.use(tr):
        new, state, met = adamw_update(grads, state, 1e-2,
                                       param_dtype=param_dtype,
                                       params=params)
    assert calls == {"sumsq": [4], "apply": [4]}
    assert tr.counters() == {"adamw/elems": 30, "adamw/kernel_elems": 30}
    for k, t in new.items():
        assert t.dtype == param_dtype
        assert (t is params[k]) == (params[k].dtype == param_dtype)
    want, twin, wmet = adamw_update_plain(grads, twin, 1e-2,
                                          param_dtype=param_dtype,
                                          params=twin_params)
    assert float(met["grad_norm"]) == pytest.approx(
        float(wmet["grad_norm"]), rel=1e-6)
    for a, b in zip(tree_leaves([new, state.master, state.m, state.v]),
                    tree_leaves([want, twin.master, twin.m, twin.v])):
        assert torch.equal(a, b)
