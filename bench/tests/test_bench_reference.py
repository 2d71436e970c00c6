"""The reference agrees with the port's plain CPU path at smoke size, in
float32: the forward's logits (dense and MoE, with a decode over a cache),
the loss, and one AdamW step."""

import dataclasses

import pytest
import torch

from bench.harness import lmcfg, weights
from bench.reference import lm as ref
from bench.tests import smoke


def _f32(cfg: dict) -> dict:
    return {**cfg, "run_as": {**cfg["run_as"], "dtype": "float32"}}


def _setup(cfg: dict, seed: int = 3):
    c = _f32(cfg)
    d = lmcfg.dims(c)
    params = weights.make_params(seed, d, "cpu")
    table, final_g, layer_weights = weights.reference_weights(seed, d, "cpu")
    return c, d, params, table, final_g, layer_weights


@pytest.mark.parametrize("cfg", [smoke.DENSE, smoke.MOE],
                         ids=["dense", "moe"])
def test_prefill_logits(cfg):
    from repro_torch.models.transformer import forward, logits
    c, d, params, table, final_g, lw = _setup(cfg)
    tokens = torch.randint(0, d.V, (2, 24), generator=torch.Generator()
                           .manual_seed(1))
    hidden, _, _, _ = forward(lmcfg.port_config(c), params, tokens=tokens,
                              attention="plain")
    port = logits(lmcfg.port_config(c), params, hidden)
    pos = torch.arange(24)
    got = ref.serve_logits(d, lw, table, final_g, [(tokens, pos, None)],
                           [ref.EXACT], last_only=False)[0][0]
    torch.testing.assert_close(got, port, atol=2e-4, rtol=2e-4)


def test_decode_over_a_cache():
    """Eight decode steps of the port over a cache filled with random rows
    against the reference fed the same tokens over the same rows."""
    from repro_torch.models.transformer import init_caches
    from repro_torch.runtime.step import make_decode_step
    c, d, params, table, final_g, lw = _setup(smoke.DENSE)
    cfg = lmcfg.port_config(c)
    B, T0, n = 2, 16, 8
    g = torch.Generator().manual_seed(2)
    caches = init_caches(cfg, B, T0 + n, dtype=torch.float32, device="cpu")
    past = {k: torch.randn((d.L, B, T0, d.KV, d.hd), generator=g)
            for k in ("k", "v")}
    for k in past:
        caches[k][:, :, :T0] = past[k]
    step = make_decode_step(cfg, attention="plain")
    tok = torch.randint(0, d.V, (B, 1), generator=g, dtype=torch.int32)
    fed, port = [tok], []
    for pos in range(T0, T0 + n):
        tok, lg, caches, _ = step(params, tok, caches, None, pos)
        fed.append(tok)
        port.append(lg[:, -1])
    inputs = torch.cat(fed[:-1], dim=1)
    got = ref.serve_logits(
        d, lw, table, final_g,
        [(inputs, torch.arange(T0, T0 + n),
          lambda i: (past["k"][i], past["v"][i]))],
        [ref.EXACT], last_only=False)[0][0]
    torch.testing.assert_close(got, torch.stack(port, dim=1), atol=2e-4,
                               rtol=2e-4)


def test_moe_block_with_capacity_drops():
    """Routing that overloads experts: the same tokens kept and dropped."""
    from repro_torch.models.moe import moe_block
    from repro_torch.tree import tree_map
    c, d, params, _, _, lw = _setup(smoke.MOE)
    d = dataclasses.replace(d, capacity_factor=0.5)
    w = lw(0)
    x = torch.randn((2, 32, d.D), generator=torch.Generator().manual_seed(4))
    layer0 = tree_map(lambda t: t[0], params["blocks"]["moe"])
    port, aux = moe_block(layer0, x, num_experts=d.E, top_k=d.k, n_shared=1,
                          capacity_factor=0.5)
    got, lb = ref.moe(d, w, x, ref.EXACT)
    torch.testing.assert_close(got, port, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lb, aux["load_balance"])


def test_loss_and_one_adamw_step():
    from repro_torch.runtime import step as step_mod
    from bench.harness import core
    train_driver = core.load_module("drivers", "train")
    c, d, params, _, _, _ = _setup(smoke.MOE)
    cfg = lmcfg.port_config(c)
    hp = {"peak_lr": 1e-3, "warmup": 0, "total": 100, "max_norm": 1.0,
          "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, d.V, (2, 17), generator=g, dtype=torch.int32)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    state = step_mod.train_state_of(params)
    step = step_mod.make_train_step(cfg, peak_lr=hp["peak_lr"],
                                    warmup=hp["warmup"], total=hp["total"],
                                    max_norm=hp["max_norm"])
    names = train_driver.leaf_slices(d, params)
    P = {n: t.detach().clone().float() for n, t in names.items()}
    initial = {n: t.clone() for n, t in P.items()}
    state, met = step(state, batch)
    out = ref.train(d, P, [(batch["tokens"], batch["labels"])], hp,
                    ref.EXACT, initial.__getitem__)
    assert out["loss"][0] == pytest.approx(float(met["loss"]), rel=1e-5)
    master = train_driver.leaf_slices(d, state["opt"]["master"])
    # the first step moves an element by lr g / (|g| + eps): one whose
    # gradient is near eps moves by an amount the rounding of g decides
    for n in names:
        torch.testing.assert_close(P[n], master[n], atol=1e-2 * hp["peak_lr"],
                                   rtol=1e-5)
