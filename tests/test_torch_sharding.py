"""The port's logical-axis sharding on DeviceMesh / DTensor against the JAX
package's, on the CPU.

The twins of ``tests/test_sharding.py`` (rules, specs, the single-device
loss under rules), of ``TestElastic`` in ``tests/test_substrate.py``, the
spec trees of every arch's smoke and full config (``lm_specs``,
``state_specs``, ``serve_state_specs``, ``make_batch_specs``) against the
JAX package's, taken under ``jax.eval_shape`` so a full config allocates
nothing, and the port's own distribution paths on a one-rank ``"cpu"``
mesh (a ``gloo`` group in this process): ``train(mesh=)`` against
``train()``, a checkpoint restored onto the mesh, and the three custom
ops through their sharding rules.  Any JAX mesh here has ``Auto`` axes
(JAX 0.9's ``make_mesh`` makes ``Explicit`` ones, which
``with_sharding_constraint`` refuses).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AxisType, PartitionSpec as P  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate, Shard,  # noqa: E402
                                      distribute_tensor)

from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro.runtime import sharding as jsh  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_smoke, list_archs  # noqa: E402
from repro_torch.data.pipeline import make_batch_specs  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.rme_gather import rme_gather as rg  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import elastic as telastic  # noqa: E402
from repro_torch.runtime import sharding as tsh  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from tests.test_torch_support import assert_same  # noqa: E402

QUIET = dict(log=lambda *a, **k: None)


def _jmesh(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group in this process, its store in memory."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh1(group):
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


# -- the twins of tests/test_sharding.py ----------------------------------------

def test_spec_resolution_outside_context_is_noop():
    assert tsh.spec_of(("batch", "seq", "embed")) == tuple(P()) == ()
    x = torch.ones((4, 4))
    assert tsh.shard(x, ("batch", None)) is x
    assert tsh.whole_seq(x) is x
    fn = lambda t: t  # noqa: E731
    assert tsh.local(fn, ((None,),), (None,)) is fn


def test_spec_resolution_in_context(mesh1):
    names = [("batch", None, "mlp"), (None, "embed"), ("kv_seq", "heads")]
    with jsh.use_rules(_jmesh((1, 1), ("data", "model"))):
        want = [tuple(jsh.spec_of(n)) for n in names]
    with tsh.use_rules(mesh1):
        got = [tsh.spec_of(n) for n in names]
        assert got[0] == ("data", None, "model")
        assert got[1] == (None, None)
        x = torch.ones((2, 3))
        assert tsh.shard(x, ("batch", None)) is x  # plain: one device
    assert got == want


def test_pod_axis_dropped_on_single_pod_mesh(mesh1):
    with tsh.use_rules(mesh1):  # batch maps to ("pod","data") -> ("data",)
        assert tsh.spec_of(("batch",)) == ("data",)
        assert tsh.placements_of(tsh.spec_of(("batch", "mlp")), mesh1) == \
            (Shard(0), Shard(1))


def test_tree_sharding_handles_none_and_tuples(mesh1):
    specs = {"a": ("batch", "mlp"), "b": None, "c": {"d": (None, "vocab")}}
    jsh_tree = jsh.tree_sharding(specs, _jmesh((1, 1), ("data", "model")))
    sh = tsh.tree_sharding(specs, mesh1)
    assert sh["a"] == (Shard(0), Shard(1))
    assert sh["b"] == (Replicate(), Replicate())
    assert sh["c"]["d"] == (Replicate(), Shard(1))
    for got, want in ((sh["a"], jsh_tree["a"]), (sh["b"], jsh_tree["b"]),
                      (sh["c"]["d"], jsh_tree["c"]["d"])):
        assert got == tsh.placements_of(tuple(want.spec), mesh1)


def test_rules_for_cell_kinds():
    tr = tmesh.rules_for_cell("train")
    assert tr["embed_fsdp"] == ("data",) and tr["seq"] == ("model",)
    de = tmesh.rules_for_cell("decode")
    assert de["seq"] is None and de["embed_fsdp"] is None
    lg = tmesh.rules_for_cell("decode", long_context=True)
    assert lg["kv_seq"] == ("data",) and lg["batch"] is None
    for kind in ("train", "prefill", "decode"):
        for kw in ({}, {"long_context": True}, {"batch_is_sharded": False}):
            assert tmesh.rules_for_cell(kind, **kw) == \
                jmesh.rules_for_cell(kind, **kw)
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES


def test_specialize_rules_moe_divisibility():
    class FakeMesh:
        axis_names = ("data", "model")

        class devices:
            shape = (16, 16)

    qwen = get_config("qwen2-moe-a2.7b")
    assert qwen.num_experts_padded == 64
    r = tmesh.specialize_rules(tmesh.rules_for_cell("train"), qwen, FakeMesh)
    assert r["experts"] == ("model",)
    assert r["seq"] is None  # no SP around MoE dispatch
    qwen_unpadded = dataclasses.replace(qwen, moe_pad_experts=0)
    r0 = tmesh.specialize_rules(tmesh.rules_for_cell("train"), qwen_unpadded,
                                FakeMesh)
    assert r0["experts"] is None and r0["expert_mlp"] == ("model",)
    llama = get_config("llama4-scout-17b-a16e")  # 16 experts: divides
    r2 = tmesh.specialize_rules(tmesh.rules_for_cell("train"), llama,
                                FakeMesh)
    assert r2["experts"] == ("model",)
    for arch in list_archs():
        for kind in ("train", "prefill", "decode"):
            assert tmesh.specialize_rules(
                tmesh.rules_for_cell(kind), get_config(arch), FakeMesh) == \
                jmesh.specialize_rules(jmesh.rules_for_cell(kind),
                                       jreg.get_config(arch), FakeMesh)


def test_sharded_execution_single_device_matches_unsharded(mesh1):
    """The port's lm_loss on DTensor weights under the train rules on a
    (1, 1) "cpu" mesh: bit for bit its plain lm_loss, and within 1e-6 of
    JAX's lm_loss under the rules on an Auto mesh (f32 sums in other
    orders; the JAX test's own rtol)."""
    jcfg = jt.ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                          n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                          dtype=jnp.float32, remat="none")
    tcfg = tt.ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                          n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                          dtype=torch.float32, remat="none")
    jp, jspecs = jt.init_lm(jcfg, jax.random.PRNGKey(0))
    toks = np.random.RandomState(1).randint(0, 64, (2, 8)).astype(np.int32)
    with jsh.use_rules(_jmesh((1, 1), ("data", "model"))):
        want, _ = jax.jit(lambda p: jt.lm_loss(jcfg, p, jnp.asarray(toks),
                                               jnp.asarray(toks)))(jp)
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tt.lm_specs(tcfg) == jspecs
    plain, _ = tt.lm_loss(tcfg, params, torch.tensor(toks),
                          torch.tensor(toks))
    rules = tmesh.rules_for_cell("train")
    placed = telastic.reshard_state(params, tt.lm_specs(tcfg), mesh1, rules)
    t = distribute_tensor(torch.tensor(toks), mesh1, [Shard(0), Replicate()])
    with tsh.use_rules(mesh1, rules):
        inside, _ = tt.lm_loss(tcfg, placed, t, t)
    assert isinstance(inside, DTensor)
    assert_same(inside.full_tensor(), plain, what="DTensor vs plain")
    assert np.allclose(float(plain), float(want), rtol=1e-6)


# -- elastic (the TestElastic twin) ---------------------------------------------

def test_reshard_roundtrip_single_device(group):
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    state = {"w": torch.arange(16.0).reshape(4, 4)}
    specs = {"w": ("batch", None)}
    out = telastic.reshard_state(state, specs, mesh)
    assert isinstance(out["w"], DTensor)
    assert out["w"].placements == (Shard(0),)
    assert_same(out["w"].full_tensor(), state["w"])
    rep = telastic.validate_elastic(256, mesh)
    assert rep["divisible"]
    jm = _jmesh((1,), ("data",))
    assert rep == jelastic.validate_elastic(256, jm)
    assert telastic.validate_elastic(7, mesh) == \
        jelastic.validate_elastic(7, jm)


# -- spec trees against the JAX package's ---------------------------------------

def _jax_specs(cfg):
    """JAX's init_lm specs under eval_shape, as its dry-run takes them."""
    box = {}

    def grab(key):
        p, specs = jt.init_lm(cfg, key)
        box["specs"] = specs
        return p

    jax.eval_shape(grab, jax.random.PRNGKey(0))
    return box["specs"]


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_spec_trees_match_jax(arch, size):
    """lm_specs, state_specs (with and without compression) and
    serve_state_specs equal the JAX package's trees leaf for leaf."""
    tget, jget = (get_smoke, jreg.get_smoke) if size == "smoke" \
        else (get_config, jreg.get_config)
    tcfg, jcfg = tget(arch), jget(arch)
    jspecs = _jax_specs(jcfg)
    specs = tt.lm_specs(tcfg)
    assert specs == jspecs
    for compress in (False, True):
        assert tstep.state_specs(specs, compress=compress) == \
            jstep.state_specs(jspecs, compress=compress)
    for long_context in (False, True):
        assert tstep.serve_state_specs(tcfg, long_context=long_context) == \
            jstep.serve_state_specs(jcfg, long_context=long_context)


def test_make_batch_specs():
    got = make_batch_specs(8, 64)
    want = jpipe.make_batch_specs(8, 64)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)


def test_lm_specs_cover_every_parameter():
    """Every leaf init_lm makes has a spec of its rank, every family."""
    for arch in list_archs():
        cfg = get_smoke(arch)
        params = tt.init_lm(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        ranks = tsh.map_specs(len, tt.lm_specs(cfg))
        assert tree_map(lambda t: t.ndim, params) == ranks, arch


# -- the port's paths on a one-rank mesh ----------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-7b"])
def test_train_on_mesh_equals_train(arch, mesh1, tmp_path):
    """train(mesh=) on a (1, 1) "cpu" mesh: the state placed by the train
    rules, the batch split over the batch axes, every gradient
    redistributed to its parameter's placements, compression on, a
    checkpoint written and resumed onto the mesh: the losses and the
    final state bit for bit train()'s."""
    cfg = get_smoke(arch)
    kw = dict(steps=3, batch=2, seq=16, compress=True, device="cpu", **QUIET)
    want_state, want = train(cfg, **kw)
    ckpt = str(tmp_path / "ckpt")
    st, got = train(cfg, mesh=mesh1, ckpt_dir=ckpt, ckpt_every=2, **kw)
    assert got == want
    leaves = tree_leaves(st["params"])
    assert all(isinstance(t, DTensor) for t in leaves)
    for a, b in zip(leaves, tree_leaves(want_state["params"])):
        assert_same(a.full_tensor(), b)
    st2, rest = train(cfg, mesh=mesh1, ckpt_dir=ckpt, **{**kw, "steps": 4})
    assert len(rest) == 1  # resumed at step 3, from the mesh's checkpoint
    assert isinstance(st2["params"]["embed"]["e"], DTensor)


def test_checkpoint_restores_onto_mesh(mesh1, tmp_path):
    """restore(mesh=, spec_tree=) places each leaf the spec tree names with
    its rules' placements, values bit for bit; the rest stay plain."""
    cfg = get_smoke("granite-8b")
    state = tstep.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, state, blocking=True)
    rules = tmesh.rules_for_cell("train")
    specs = {"params": tt.lm_specs(cfg)}
    back, step = mgr.restore(device="cpu", mesh=mesh1, spec_tree=specs,
                             rules=rules)
    assert step == 5
    e = back["params"]["embed"]["e"]
    assert isinstance(e, DTensor) and e.placements == (Replicate(), Shard(0))
    assert not isinstance(back["opt"]["m"]["embed"]["e"], DTensor)
    for a, b in zip(tree_leaves(back["params"]),
                    tree_leaves(state["params"])):
        assert_same(a.full_tensor(), b)


def test_custom_ops_on_dtensors_equal_plain(mesh1):
    """rme_assemble, flash_attention and flash_decode on DTensors go through
    their sharding rules to the plain version on each shard: equal to the
    plain calls, bit for bit, their outputs DTensors."""
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(6, 20, 3).astype(np.float32))
    mask = torch.tensor(rs.rand(6, 20) > 0.5)
    q = torch.tensor(rs.randn(2, 8, 4, 16).astype(np.float32))
    k = torch.tensor(rs.randn(2, 8, 2, 16).astype(np.float32))
    v = torch.tensor(rs.randn(2, 8, 2, 16).astype(np.float32))
    batch = [Shard(0), Replicate()]
    d = {n: distribute_tensor(t, mesh1, batch)
         for n, t in dict(x=x, mask=mask, q=q, k=k, v=v).items()}
    with tsh.use_rules(mesh1):
        rows, cnt = rg.rme_assemble(d["x"], d["mask"], 7)
        pre = fa.flash_attention(d["q"], d["k"], d["v"], causal=True)
        dec = fa.flash_decode(d["q"][:, :1], d["k"], d["v"], 5)
    want_rows, want_cnt = rg.assemble_plain(x, mask, 7)
    for got, want in ((rows, want_rows), (cnt, want_cnt),
                      (pre, fa.attention_ref(q, k, v, causal=True)),
                      (dec, fa.decode_ref(q[:, :1], k, v, 5))):
        assert isinstance(got, DTensor)
        assert_same(got.full_tensor(), want)
