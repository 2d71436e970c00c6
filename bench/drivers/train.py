"""Training: the port's train step (``runtime.step.make_train_step``,
AdamW, no compression), as ``launch/train.py`` drives it, on token
batches drawn from the seed.

Set-up builds the one train state from the seed and drives it through the
first ``check_steps`` steps, which also warm every shape; the window then
runs the same state on.  Those first steps are what the reference
follows: each step's loss, each leaf's norm of the first clipped gradient
(from AdamW's first moment after one step: m = (1 - b1) g), and each
leaf's norm of its change over the steps (the f32 master weights against
the weights drawn again from the seed), pad experts left out.
"""

from __future__ import annotations

import statistics

import torch

from bench.harness import compare, lmcfg, weights
from bench.reference import lm as ref

ADAMW = ("b1", "b2", "eps", "weight_decay")


class Feed:
    """Batch ``i`` of B rows of S + 1 tokens, drawn from the seed on the
    device: ``tokens`` the first S, ``labels`` the last S."""

    def __init__(self, run, vocab: int, B: int, S: int):
        self.run, self.vocab, self.B, self.S = run, vocab, B, S

    def batch(self, i: int) -> dict:
        rows = torch.randint(0, self.vocab, (self.B, self.S + 1),
                             generator=self.run.generator("batch", i),
                             device=self.run.device, dtype=torch.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def leaf_slices(d, tree) -> dict:
    """The compared leaves of a parameter-shaped tree: each layer of a
    stacked leaf apart, routed experts cut to the E published ones."""
    out = {}
    for leaf in weights.leaves(d):
        t = weights.get(tree, leaf.path)
        if not leaf.layered:
            out[leaf.name] = t
            continue
        for i in range(d.L):
            ti = t[i]
            if leaf.path[1:] in (("moe", "wi"), ("moe", "wo")):
                ti = ti[:d.E]
            out[f"{leaf.name}.{i}"] = ti
    return out


def _leaf_of(d, name: str):
    """(Leaf, layer) of a compared leaf's name."""
    for leaf in weights.leaves(d):
        if name == leaf.name:
            return leaf, None
        if leaf.layered and name.startswith(leaf.name + "."):
            return leaf, int(name[len(leaf.name) + 1:])
    raise KeyError(name)


def initial(run, d, name: str, device):
    """A compared leaf's starting value, drawn again from the seed, as
    float32."""
    leaf, layer = _leaf_of(d, name)
    t = weights.draw(run.seed, d, leaf, layer, device).float()
    return t[:d.E] if leaf.path[1:] in (("moe", "wi"), ("moe", "wo")) else t


def _norms(tensors: dict, scale: float = 1.0) -> dict:
    return {n: torch.linalg.vector_norm(t.float()) * scale
            for n, t in tensors.items()}


def run(r):
    from repro_torch.runtime import step as step_mod

    ref.exact_float32()
    p = r.params
    d = lmcfg.dims(r.config)
    cfg = lmcfg.port_config(r.config)
    B, S, n_check = p["batch"], p["seq"], p["check_steps"]
    feed = Feed(r, d.V, B, S)

    state = step_mod.train_state_of(weights.make_params(r.seed, d, r.device))
    train_step = step_mod.make_train_step(
        cfg, peak_lr=p["peak_lr"], warmup=p["warmup"], total=p["total"],
        max_norm=p["max_norm"])

    # the first steps: warm-up, and what the reference follows
    losses = []
    for i in range(n_check):
        state, met = train_step(state, feed.batch(i))
        losses.append(met["loss"])
        if i == 0:
            first = _norms(leaf_slices(d, state["opt"]["m"]),
                           1.0 / (1.0 - p["adamw"]["b1"]))
    master = leaf_slices(d, state["opt"]["master"])
    change = {n: torch.linalg.vector_norm(
        t - initial(r, d, n, r.device)) for n, t in master.items()}
    del master

    step = n_check
    r.begin_window()
    while r.running():
        state, met = train_step(state, feed.batch(step))
        step += 1
        r.step_done(tokens=B * S)
    r.end_window()
    steps = r.all_steps()
    r.attempted = len(steps)
    r.e2e["train_tokens_per_s"] = sum(s["tokens"] for s in steps) / \
        r.window_seconds()
    r.counters["final_loss"] = float(met["loss"])

    program = {"loss": [float(x) for x in losses],
               "first_grad": {n: float(v) for n, v in first.items()},
               "change": {n: float(v) for n, v in change.items()}}
    del state, met, first, change, losses
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    judge(r, d, feed, program)


def reference(r, d, feed, mm):
    P = {n: initial(r, d, n, r.device) for n in
         leaf_slices(d, _shapes(d))}
    batches = [(b["tokens"], b["labels"]) for b in
               (feed.batch(i) for i in range(r.params["check_steps"]))]
    hp = {k: r.params[k] for k in ("peak_lr", "warmup", "total",
                                   "max_norm")}
    hp.update({k: r.params["adamw"][k] for k in ADAMW})
    out = ref.train(d, P, batches, hp, mm,
                    lambda n: initial(r, d, n, r.device))
    del P
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _shapes(d) -> dict:
    """A tree of meta tensors shaped as the parameters (for the names)."""
    tree: dict = {}
    for leaf in weights.leaves(d):
        shape = ((d.L,) + leaf.shape) if leaf.layered else leaf.shape
        node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = torch.empty(shape, device="meta")
    return tree


def readings(exact: dict, other: dict) -> dict:
    """The compared numbers of ``other`` (the program, or the control)
    against the exact reference: the widest step's loss gap, the worst
    and the median leaf's gap of the first gradient's norm, the worst
    leaf's gap of the change's norm (over the leaves that move)."""
    grad = compare.leaf_gaps(other["first_grad"], exact["first_grad"],
                             exact["first_grad"])
    change = compare.leaf_gaps(other["change"], exact["change"],
                               compare.moved(exact["first_grad"]))
    return {"loss_gap": compare.loss_gap(other["loss"], exact["loss"]),
            "grad_norm_gap": max(grad.values()),
            "grad_norm_gap_median": statistics.median(grad.values()),
            "change_gap": max(change.values())}


def judge(r, d, feed, program: dict):
    """Each reading that the cell gives a limit is compared (the loss gap
    has none: ``PERF.md`` gives its readings)."""
    exact = reference(r, d, feed, ref.EXACT)
    r.counters["readings"] = readings(exact, program)
    for name, value in r.counters["readings"].items():
        if name in r.cell["limits"]:
            r.check(name, value, r.limit(name))
    if r.control:
        r.control_readings = readings(exact, reference(r, d, feed, ref.FP8))
