"""The port's train loop against the JAX package's, on the CPU.

A bf16 step (every leaf cast to the model's dtype, the next loss within the
bf16 rule) and a 5-step ``train()`` trajectory (6 steps with int8
compression), each against the JAX
package from the same weights (JAX's, carried across with
``params_from_numpy``, or restored from a checkpoint the JAX package
wrote) on the same ``SyntheticLM`` batches; then the port twins of the
train tests of ``tests/test_system.py``.  Each test states its tolerance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch.train import train as jtrain  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.fp_bounds import bf16_ulp  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, to_device  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.runtime.step import make_train_step  # noqa: E402

CPU = "cpu"
QUIET = dict(log=lambda *a, **k: None)
# one arch of each family
FAMILY_ARCHS = ("granite-8b", "qwen2-moe-a2.7b", "rwkv6-3b", "zamba2-7b")


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_step_casts_every_leaf_and_matches_jax(arch):
    """bf16 smoke variant, the same weights and batches: after the first
    step every parameter leaf is bf16 in both packages (the f32 norm
    gains, RWKV6's mixers and decays, Mamba2's ``A_log``/``D``/``dt_bias``
    too), and the second step's forward, on those leaves, gives a loss
    within 4 bf16 ulps of JAX's (the bf16 rule of the LM's parity
    tests)."""
    jc = dataclasses.replace(jreg.get_smoke(arch), dtype=jnp.bfloat16)
    tc = dataclasses.replace(get_smoke(arch), dtype=torch.bfloat16)
    jstate, _ = jstep.init_train_state(jc, jax.random.PRNGKey(0))
    tstate = _port(jstate)
    jfn = jax.jit(jstep.make_train_step(jc, peak_lr=1e-2, warmup=1,
                                        total=5))
    tfn = make_train_step(tc, peak_lr=1e-2, warmup=1, total=5)
    src = SyntheticLM(jc.vocab, 4, 16, 0)
    losses = []
    for i in range(2):
        b = src.batch_at(i)
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tfn(tstate, to_device(b, torch.device(CPU)))
        losses.append((float(jm["loss"]), float(tm["loss"])))
        if i == 0:
            for a, t in zip(jax.tree.leaves(jstate["params"]),
                            tree_leaves(tstate["params"])):
                assert a.dtype == jnp.bfloat16 and t.dtype == torch.bfloat16
    (j0, t0), (j1, t1) = losses
    assert j0 == t0 or abs(j0 - t0) <= 4 * float(bf16_ulp(torch.tensor(j0)))
    assert abs(j1 - t1) <= 4 * float(bf16_ulp(torch.tensor(j1))), (j1, t1)


@pytest.mark.parametrize("arch,compress", [
    *((a, False) for a in FAMILY_ARCHS), ("qwen2-moe-a2.7b", True)])
def test_train_matches_jax(arch, compress, tmp_path):
    """``train()`` in both packages from one checkpoint the JAX package
    wrote at step 0 (its f32 smoke weights, restored by the port): the
    same ``SyntheticLM`` batches, warmup and schedule, 5 steps (6 with
    int8 compression, the error feedback restored too), each loss within
    1e-4 of JAX's: f32 sums in other orders, amplified by the updates,
    and with compression a rounding that moves an int8 code moves that
    gradient element by a whole quantization step (measured at most
    2.8e-6, with compression 1.04e-5)."""
    jc, tc = jreg.get_smoke(arch), get_smoke(arch)
    steps, seq = (6, 64) if compress else (5, 16)
    state, _ = jstep.init_train_state(jc, jax.random.PRNGKey(0),
                                      compress=compress)
    for d in ("jax", "port"):
        JCheckpointManager(str(tmp_path / d)).save(0, state, blocking=True)
    kw = dict(steps=steps, batch=4, seq=seq, compress=compress)
    _, jl = jtrain(jc, ckpt_dir=str(tmp_path / "jax"), **kw, **QUIET)
    logs = []
    _, tl = ttrain.train(tc, ckpt_dir=str(tmp_path / "port"), device=CPU,
                         log=logs.append, **kw)
    assert logs[0] == "[restore] resumed from step 0"
    assert len(tl) == len(jl) == steps
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)


def test_train_loss_decreases_and_checkpoints(tmp_path):
    cfg = get_smoke("granite-8b")
    state, losses = ttrain.train(cfg, steps=25, batch=8, seq=32,
                                 ckpt_dir=str(tmp_path), ckpt_every=10,
                                 peak_lr=1e-2, device=CPU, **QUIET)
    assert losses[-1] < losses[0] * 0.7
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 25
    saved, _ = mgr.restore(device=CPU)
    for a, b in zip(tree_leaves(saved), tree_leaves(state)):
        assert torch.equal(a, b)


def test_train_restart_resumes(tmp_path):
    cfg = get_smoke("granite-8b")
    ttrain.train(cfg, steps=10, batch=4, seq=16, ckpt_dir=str(tmp_path),
                 ckpt_every=5, device=CPU, **QUIET)
    # resume to 15: loads step 10, runs 5 more
    _, losses = ttrain.train(cfg, steps=15, batch=4, seq=16,
                             ckpt_dir=str(tmp_path), ckpt_every=5,
                             device=CPU, **QUIET)
    assert len(losses) == 5


def test_train_with_compression(tmp_path):
    cfg = get_smoke("phi4-mini-3.8b")
    state, losses = ttrain.train(cfg, steps=20, batch=8, seq=32,
                                 compress=True, peak_lr=1e-2, device=CPU,
                                 **QUIET)
    assert losses[-1] < losses[0] * 0.8  # int8+EF still converges
    assert any(bool((e != 0).any()) for e in tree_leaves(state["ef"]))
