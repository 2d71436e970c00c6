"""The port's loss, its gradients and the train step against the JAX
package's, on the CPU.

``lm_loss`` and every leaf of its gradient per family and frontend, and
``softmax_xent``, against the JAX package on the same numpy inputs and the
same weights (JAX's, carried across with ``params_from_numpy``); remat,
the layer views of the train path and the first update at lr 0; then the
port twins of the train tests of ``tests/test_models.py`` and
``tests/test_arch_smoke.py``.  ``tests/test_torch_train_loop.py`` holds
the train loop.  Each test states its tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config, get_smoke, list_archs  # noqa: E402
from repro_torch.core import rme  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, to_device  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.runtime.step import (init_train_state,  # noqa: E402
                                      make_train_step)
from tests.test_torch_support import assert_same  # noqa: E402

CPU = "cpu"
QUIET = dict(log=lambda *a, **k: None)
# one arch of each family and frontend
PARITY_ARCHS = ("granite-8b", "qwen2-moe-a2.7b", "rwkv6-3b", "zamba2-7b",
                "internvl2-1b", "musicgen-large")


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _inputs(cfg, B=2, S=16, seed=1):
    """Labels, and tokens or (stub frontends) embeds, from numpy."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend in ("audio_stub", "vision_stub"):
        return {"embeds": (rs.randn(B, S, cfg.d_model) * 0.1).astype(
            np.float32), "labels": labels}
    return {"tokens": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": labels}


def _port_loss_and_grads(cfg, params, batch):
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    b = {k: torch.tensor(v) for k, v in batch.items()}
    loss, aux = tt.lm_loss(cfg, params, b.get("tokens"), b["labels"],
                           embeds=b.get("embeds"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), aux, grads


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_lm_loss_and_every_gradient_match_jax(arch):
    """f32, smoke size: the loss within 1e-5 of itself and every gradient
    leaf within 1e-4 of the leaf's largest |g| (f32 sums in other orders
    through the forward and the backward; measured at most 2.4e-7 and
    6.7e-6).  The port visits the leaves in ``jax.tree.leaves``' order."""
    jc, tc = jreg.get_smoke(arch), get_smoke(arch)
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(0))
    batch = _inputs(jc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.lm_loss(jc, p, jb.get("tokens"), jb["labels"],
                             embeds=jb.get("embeds")), has_aux=True))(jp)
    tl, taux, tg = _port_loss_and_grads(tc, _port(jp), batch)
    assert_same(tl, jl, atol=1e-5 * abs(float(jl)), what=f"{arch} loss")
    assert set(taux) == set(jaux)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (a, b) in enumerate(zip(jleaves, tg)):
        mag = float(np.abs(np.asarray(a, np.float32)).max())
        assert b.shape == a.shape and b.dtype == torch.float32
        assert_same(b, a, atol=1e-4 * mag, what=f"{arch} grad leaf {i}")


def test_softmax_xent_matches_jax_with_ignored_positions():
    """Loss and its gradient in f32, a quarter of the labels ignored (-1):
    within 4 ulps of the loss (the logsumexp's sum in another order) and
    1e-6 of the gradient's largest magnitude."""
    rs = np.random.RandomState(2)
    lg = (rs.randn(3, 8, 50) * 4).astype(np.float32)
    labels = rs.randint(0, 50, (3, 8)).astype(np.int32)
    labels[rs.rand(3, 8) < 0.25] = -1
    jl, jg = jax.value_and_grad(jlayers.softmax_xent)(jnp.asarray(lg),
                                                      jnp.asarray(labels))
    x = torch.tensor(lg, requires_grad=True)
    tl = softmax_xent(x, torch.tensor(labels))
    (tg,) = torch.autograd.grad(tl, x)
    assert_same(tl.detach(), jl, atol=4 * 2 ** -24 * abs(float(jl)))
    assert_same(tg, jg, atol=1e-6 * float(jnp.abs(jg).max()))
    assert float(softmax_xent(x.detach(), torch.full((3, 8), -1))) == 0.0


# -- remat ------------------------------------------------------------------------

TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=64, dtype=torch.float32, max_seq=32, remat="none")
FAMILIES = {
    "dense": {},
    "moe": dict(num_experts=4, top_k=2, moe_d_ff=32, capacity_factor=99.0),
    "ssm": dict(ssm_head_dim=8),
    "hybrid": dict(ssm_state=8, ssm_head_dim=8, attn_every=2),
}


def _cfg(fam, **kw):
    return tt.ModelConfig(name=fam, family=fam,
                          **{**TINY, **FAMILIES[fam], **kw})


def _tiny(cfg, S=16):
    params = tt.init_lm(cfg, torch.Generator().manual_seed(0), device=CPU)
    toks = torch.randint(0, cfg.vocab, (2, S),
                         generator=torch.Generator().manual_seed(1))
    return params, toks


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_train_grads_finite(fam):
    """The twin of ``tests/test_models.py::test_train_grads_finite``."""
    cfg = _cfg(fam)
    params, toks = _tiny(cfg)
    loss, _, grads = _port_loss_and_grads(
        cfg, params, {"tokens": toks.numpy(), "labels": toks.numpy()})
    assert np.isfinite(float(loss))
    assert len(grads) == len(tree_leaves(params))
    for g in grads:
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_remat_matches_no_remat(fam):
    """The twin of ``tests/test_models.py::test_remat_matches_no_remat``
    for every family: the recomputation runs the same ops on the same
    inputs, so the loss and every gradient are equal bit for bit (the
    JAX test allows 1e-6 / 1e-5)."""
    cfg_a, cfg_b = _cfg(fam, remat="none"), _cfg(fam, remat="full")
    params, toks = _tiny(cfg_a)
    batch = {"tokens": toks.numpy(), "labels": toks.numpy()}
    la, _, ga = _port_loss_and_grads(cfg_a, params, batch)
    lb, _, gb = _port_loss_and_grads(cfg_b, params, batch)
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


def test_remat_recomputes_each_unit_in_the_backward(monkeypatch):
    """Under autograd with ``remat="full"`` each moe layer's dispatch runs
    twice (forward and recompute), once without remat and once in a
    forward without grad; hybrid recomputes its groups' Mamba2 layers and
    not its tail."""
    calls = {"dispatch": 0, "mamba": 0}
    dispatch, mamba = rme.dispatch_tokens, ssm_mod.mamba2_block

    def counted_dispatch(*a, **k):
        calls["dispatch"] += 1
        return dispatch(*a, **k)

    def counted_mamba(*a, **k):
        calls["mamba"] += 1
        return mamba(*a, **k)

    monkeypatch.setattr(rme, "dispatch_tokens", counted_dispatch)
    monkeypatch.setattr(ssm_mod, "mamba2_block", counted_mamba)
    for remat, want in (("full", 2), ("none", 1)):
        cfg = _cfg("moe", remat=remat, n_layers=3)
        params, toks = _tiny(cfg)
        calls["dispatch"] = 0
        _port_loss_and_grads(cfg, params, {"tokens": toks.numpy(),
                                           "labels": toks.numpy()})
        assert calls["dispatch"] == want * 3, remat
    cfg = _cfg("moe", remat="full", n_layers=3)
    params, toks = _tiny(cfg)
    calls["dispatch"] = 0
    with torch.no_grad():
        tt.lm_loss(cfg, params, toks, toks)
    assert calls["dispatch"] == 3
    cfg = _cfg("hybrid", remat="full", n_layers=5)   # 2 groups of 2, tail 1
    params, toks = _tiny(cfg)
    _port_loss_and_grads(cfg, params, {"tokens": toks.numpy(),
                                       "labels": toks.numpy()})
    assert calls["mamba"] == 2 * 4 + 1


def test_train_forward_equals_the_serving_forward():
    """The train path (layer views from ``torch.unbind``, checkpointed
    layers) changes no number: its loss equals the grad-free forward's,
    bit for bit."""
    cfg = _cfg("moe", remat="full", n_layers=3)
    params, toks = _tiny(cfg)
    with torch.no_grad():
        want, _ = tt.lm_loss(cfg, params, toks, toks)
    got, _, _ = _port_loss_and_grads(cfg, params, {"tokens": toks.numpy(),
                                                   "labels": toks.numpy()})
    assert torch.equal(got, want)


# -- the train step -----------------------------------------------------------------

def _batch(cfg, step, B=4, S=16, seed=0):
    return to_device(SyntheticLM(cfg.vocab, B, S, seed).batch_at(step),
                     torch.device(CPU))


def test_first_update_runs_at_lr_zero():
    """Step 0's learning rate is the schedule at the step count before the
    update, 0 in warmup: the weights stay as they were, bit for bit,
    while m, v and the step count move."""
    cfg = get_smoke("qwen2-moe-a2.7b")
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device=CPU)
    before = [t.clone() for t in tree_leaves(state["params"])]
    step = make_train_step(cfg, peak_lr=1e-2, warmup=2, total=10)
    state, met = step(state, _batch(cfg, 0))
    assert float(met["lr"]) == 0.0 and int(state["opt"]["step"]) == 1
    assert set(met) == {"loss", "lr", "grad_norm", "load_balance"}
    for a, b in zip(before, tree_leaves(state["params"])):
        assert torch.equal(a, b)
    assert any(bool((m != 0).any()) for m in tree_leaves(state["opt"]["m"]))
    state, met = step(state, _batch(cfg, 1))
    assert float(met["lr"]) == pytest.approx(5e-3)
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, tree_leaves(state["params"])))


# -- twins of tests/test_arch_smoke.py and tests/test_system.py ----------------

@pytest.mark.parametrize("arch", list_archs())
def test_smoke_train_step(arch):
    """The twin of ``tests/test_arch_smoke.py::test_smoke_train_step``:
    the reduced config of the arch's family, loss and every gradient
    finite (embeds for the two stub frontends)."""
    cfg = get_smoke(arch)
    assert cfg.family == get_config(arch).family
    params = tt.init_lm(cfg, torch.Generator().manual_seed(0), device=CPU)
    loss, _, grads = _port_loss_and_grads(cfg, params, _inputs(cfg, seed=2))
    assert np.isfinite(float(loss))
    for g in grads:
        assert torch.isfinite(g).all(), arch


def test_train_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train(get_smoke("granite-8b"), steps=1, **QUIET)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "granite-8b", "--smoke", "--steps", "1"])
