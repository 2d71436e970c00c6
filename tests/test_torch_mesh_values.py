"""The port's distributed steps on a real multi-rank mesh, on the CPU.

The dry-run's fake process groups move no values.  Here four processes
(``torch.multiprocessing`` spawn) join a ``gloo`` group through a
``FileStore`` in ``tmp_path`` and run the port under the rules on a real
mesh, so every collective carries real data.  Rank 0 writes the whole
results, and the tests hold them against the unsharded port (within 1e-5
relative) and against the JAX package on the same weights (JAX's, carried
across with ``params_from_numpy``):

* granite-8b smoke's decode step (4 query heads over 1 KV head) on a
  (2, 2) ("data", "model") mesh under the decode rules, which lay the
  cache's rows over "model": the distributed flash decode and the band
  write into the rank that owns the row, at the last position and at one
  where the second "model" rank holds no live row;
* rwkv6 smoke with 6 heads, which do not divide 4 ranks, on (1, 4) under
  the train rules: the loss and every gradient, at 2 x 16 tokens (the
  band product gathered, every head on every rank) and at 2 x 128 (the
  weight split first: the heads' uneven chunks, padded, each rank
  running its own);
* rwkv6-3b smoke (4 heads) on (2, 2) under the train rules at 4 x 32
  tokens: the weight split first, each rank running its own heads of an
  even split; the loss and every gradient;
* granite-8b smoke's loss on (2, 2) under the train rules: the loss and
  every gradient, the embedding table's (the vocab-parallel lookup) and
  ``wqkv``'s (the QKV bands) among them;
* rwkv6-3b smoke's decode steps on (2, 2) under the decode rules, from a
  random state: RWKV6's four bands as each rank's own columns times
  their mixes, the product gathered once, the logits and the state;
* zamba2-7b smoke's prefill on (2, 2) under the prefill rules: Mamba2's
  in-projection and the shared attention's QKV product, each gathered
  once and split, the logits and the state.

Each worker records the layouts :func:`band_layout` chose for a case, and
the tests hold them to the path the case is there to cover.

The four workers run once for the whole file, in one subprocess with a
timeout of 300 s.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_arch_smoke import lm_logit_tol  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT_S = 300
B, T, S = 4, 32, 16    # decode batch and cache rows; the loss's sequence
POSITIONS = {"last": T - 1, "early": 5}  # 5: rows 16-31 hold nothing live
SSM_STEPS = 3          # rwkv6's decode steps from a random state
# the layouts band_layout chooses in each case's blocks: rwkv6 6 heads on
# (1, 4) splits the weight first once its rows outnumber 128 (the weight's
# 96 x 384 elements plus the uneven heads' output gather against the
# product's rows x 384); rwkv6-3b smoke on (2, 2) once they outnumber 32
# (a rank's 32 weight rows)
LAYOUTS = {"rwkv6_loss": ["product"], "rwkv6_own_loss": ["weight"],
           "rwkv6_even_loss": ["weight"], "granite_loss": ["product"],
           "rwkv6-3b_ssm_decode": ["product"],
           "zamba2-7b_prefill": ["product"]}

_WORKER = r"""
import os
import pickle
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, world, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(os.path.join(out, "store"),
                                                 world))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import rules_for_cell, specialize_rules
    from repro_torch.models import attention as tattn
    from repro_torch.models import ssm as tssm
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.runtime import sharding as tsh
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.runtime.step import make_decode_step, serve_state_specs
    from repro_torch.tree import tree_leaves

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()

    # the layouts the blocks choose, as the tests read them
    seen = []

    def recorded(layout):
        def chosen(*args, **kw):
            seen.append(layout(*args, **kw))
            return seen[-1]
        return chosen

    tattn.band_layout = recorded(tattn.band_layout)
    tssm.band_layout = recorded(tssm.band_layout)

    with open(os.path.join(out, "inputs.pkl"), "rb") as f:
        cases = pickle.load(f)
    res = {}
    for name, case in cases.items():
        seen.clear()
        cfg = case["cfg"]
        mesh = init_device_mesh("cpu", case["dims"],
                                mesh_dim_names=("data", "model"))
        rules = specialize_rules(rules_for_cell(case["rules"]), cfg, mesh)
        params = case.get("params") and reshard_state(
            params_from_numpy(case["params"]), tt.lm_specs(cfg), mesh, rules)

        def placed(a, names):
            return tsh.distribute(torch.tensor(a), mesh, tsh.placements_of(
                tsh.spec_of_names(names, mesh, rules), mesh))

        if case["kind"] == "embed":
            from repro_torch.models.layers import EMBED_SPECS, embed
            from repro_torch.models.transformer import ACT
            table = tsh.distribute(torch.tensor(case["table"]), mesh,
                                   tsh.placements_of(tsh.spec_of_names(
                                       EMBED_SPECS["e"], mesh, rules), mesh))
            table.requires_grad_()
            tokens = placed(case["tokens"], ("batch", None))
            weights = placed(case["weights"], ACT)
            with tsh.use_rules(mesh, rules):
                x = tsh.shard(embed({"e": table}, tokens), ACT)
                grad, = torch.autograd.grad((x * weights).sum(), [table])
            res[name + "/rows"] = whole(x)
            res[name + "/grad"] = whole(grad)
            res[name + "/grad_placements"] = str(grad.placements)
        elif case["kind"] == "decode":
            caches = reshard_state(params_from_numpy(case["caches"]),
                                   serve_state_specs(cfg)[0], mesh, rules)
            token = placed(case["token"], ("batch", None))
            with tsh.use_rules(mesh, rules):
                _, lg, caches, _ = make_decode_step(cfg)(
                    params, token, caches, None, case["index"])
            res[name + "/logits"] = whole(lg)
            res[name + "/k"] = whole(caches["k"])
            res[name + "/v"] = whole(caches["v"])
            res[name + "/cache_placements"] = str(caches["k"].placements)
        elif case["kind"] in ("ssm_decode", "prefill"):
            from repro_torch.runtime.step import make_prefill_step
            c_specs, s_specs = serve_state_specs(cfg)
            caches = case["caches"] and reshard_state(
                params_from_numpy(case["caches"]), c_specs, mesh, rules)
            states = reshard_state(params_from_numpy(case["states"]),
                                   s_specs, mesh, rules)
            tokens = case["tokens"]
            lgs = []
            with tsh.use_rules(mesh, rules):
                if case["kind"] == "prefill":
                    lg, _, states = make_prefill_step(cfg)(
                        params, placed(tokens, ("batch", None)), caches,
                        states)
                    lgs.append(lg)
                else:
                    step = make_decode_step(cfg)
                    for i in range(tokens.shape[1]):
                        _, lg, _, states = step(
                            params, placed(tokens[:, i:i + 1],
                                           ("batch", None)),
                            None, states, i)
                        lgs.append(lg)
            res[name + "/logits"] = [whole(lg) for lg in lgs]
            res[name + "/states"] = [whole(t) for t in tree_leaves(states)]
        else:
            leaves = [t.requires_grad_() for t in tree_leaves(params)]
            tokens = placed(case["tokens"], ("batch", None))
            with tsh.use_rules(mesh, rules):
                loss, _ = tt.lm_loss(cfg, params, tokens, tokens)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            res[name + "/loss"] = whole(loss)
            res[name + "/grads"] = [whole(g) for g in grads]
        res[name + "/layouts"] = sorted(set(seen))
        dist.barrier()
    if rank == 0:
        with open(os.path.join(out, "results.pkl"), "wb") as f:
            pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(4, sys.argv[1]), nprocs=4, join=True)
"""


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, **kw):
    return (dataclasses.replace(jreg.get_smoke(arch), **kw),
            dataclasses.replace(get_smoke(arch), **kw))


def _cases():
    """The inputs of every case: JAX's weights as numpy, the port's config,
    numpy tokens and caches from seeds."""
    rs = np.random.RandomState(0)
    cases = {}
    jc, tc = _configs("granite-8b")
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(0))
    shape = (tc.n_layers, B, T, tc.n_kv_heads, tc.hd)
    caches = {n: rs.randn(*shape).astype(np.float32) for n in ("k", "v")}
    token = rs.randint(0, tc.vocab, (B, 1)).astype(np.int32)
    for pos, index in POSITIONS.items():
        cases[f"decode_{pos}"] = dict(
            kind="decode", rules="decode", dims=(2, 2), cfg=tc, jcfg=jc, params=_np_tree(jp),
            caches=caches, token=token, index=index)
    cases["granite_loss"] = dict(
        kind="loss", rules="train", dims=(2, 2), cfg=tc, jcfg=jc, params=_np_tree(jp),
        tokens=rs.randint(0, tc.vocab, (B, S)).astype(np.int32))
    cases["embed"] = dict(
        kind="embed", rules="train", dims=(2, 2), cfg=tc,
        table=rs.randn(tc.vocab, tc.d_model).astype(np.float32),
        tokens=rs.randint(0, tc.vocab, (B, S)).astype(np.int32),
        weights=rs.randn(B, S, tc.d_model).astype(np.float32))
    jc, tc = _configs("rwkv6-3b", n_heads=6, n_kv_heads=6, d_model=96)
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(1))
    cases["rwkv6_loss"] = dict(
        kind="loss", rules="train", dims=(1, 4), cfg=tc, jcfg=jc, params=_np_tree(jp),
        tokens=rs.randint(0, tc.vocab, (2, S)).astype(np.int32))
    cases["rwkv6_own_loss"] = dict(
        cases["rwkv6_loss"],
        tokens=rs.randint(0, tc.vocab, (2, 8 * S)).astype(np.int32))
    jc, tc = _configs("rwkv6-3b")
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(3))
    cases["rwkv6_even_loss"] = dict(
        kind="loss", rules="train", dims=(2, 2), cfg=tc, jcfg=jc,
        params=_np_tree(jp),
        tokens=rs.randint(0, tc.vocab, (B, 2 * S)).astype(np.int32))
    for arch, kind, rules, n_tok in (("rwkv6-3b", "ssm_decode", "decode",
                                      SSM_STEPS),
                                     ("zamba2-7b", "prefill", "prefill", S)):
        jc, tc = _configs(arch)
        jp, _ = jt.init_lm(jc, jax.random.PRNGKey(2))
        caches = tt.init_caches(tc, B, n_tok, dtype=torch.float32,
                                device="cpu")
        states = tt.init_states(tc, B, device="cpu")
        cases[f"{arch}_{kind}"] = dict(
            kind=kind, rules=rules, dims=(2, 2), cfg=tc, jcfg=jc,
            params=_np_tree(jp),
            caches=caches and {n: t.numpy() for n, t in caches.items()},
            states={n: 0.5 * rs.randn(*t.shape).astype(np.float32)
                    for n, t in states.items()},
            tokens=rs.randint(0, tc.vocab, (B, n_tok)).astype(np.int32))
    return cases


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """``(cases, results)``: the cases' inputs and what rank 0 of the
    four-process gloo group wrote."""
    out = tmp_path_factory.mktemp("mesh")
    cases = _cases()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump({n: {k: v for k, v in c.items() if k != "jcfg"}
                     for n, c in cases.items()}, f)
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, str(script), str(out)], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "results.pkl", "rb") as f:
        return cases, pickle.load(f)


def _assert_rel(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, f"{what}: max |err| {err}, scale {scale}"


def _plain_decode(case):
    tc = case["cfg"]
    params = params_from_numpy(case["params"])
    caches = params_from_numpy(case["caches"])
    _, lg, caches, _ = tstep.make_decode_step(tc)(
        params, torch.tensor(case["token"]), caches, None, case["index"])
    return params, lg, caches


@pytest.mark.parametrize("pos", list(POSITIONS))
def test_decode_on_a_mesh_equals_unsharded(mesh_run, pos):
    """The decode step on the (2, 2) mesh, the cache's rows over "model":
    the logits and both caches within 1e-5 relative of the unsharded
    port's (the partials summed in another order; the band written where
    it belongs), the caches still sharded along their rows; the logits
    within the LM bound (``lm_logit_tol``) of the JAX package's decode
    step on the same weights."""
    cases, res = mesh_run
    case = cases[f"decode_{pos}"]
    params, lg, caches = _plain_decode(case)
    got = res[f"decode_{pos}/logits"]
    _assert_rel(got, lg, 1e-5, f"{pos}: logits against the unsharded port")
    for n in ("k", "v"):
        _assert_rel(res[f"decode_{pos}/{n}"], caches[n], 1e-5,
                    f"{pos}: cache {n}")
    assert "Shard(dim=2)" in res[f"decode_{pos}/cache_placements"]
    jc = case["jcfg"]
    jl = jax.jit(jstep.make_decode_step(jc), static_argnums=4)(
        jax.tree.map(jnp.asarray, case["params"]), jnp.asarray(case["token"]),
        {n: jnp.asarray(a) for n, a in case["caches"].items()}, None,
        case["index"])[1]
    tol = lm_logit_tol(case["cfg"], params, T).numpy()
    err = np.abs(got.astype(np.float64) - np.asarray(jl, np.float64))
    assert (err <= tol).all(), (pos, float(err.max()), float(tol.min()))


def test_a_rank_without_live_rows_weighs_nothing(mesh_run):
    """At position 5 the second "model" rank holds rows 16-31, none of
    them live: its partial is (0, -inf), so changing what those rows hold
    cannot move the unsharded result, and the mesh's logits are finite and
    equal it."""
    cases, res = mesh_run
    case = cases["decode_early"]
    _, lg, _ = _plain_decode(case)
    moved = dict(case, caches={n: a.copy() for n, a in
                               case["caches"].items()})
    for a in moved["caches"].values():
        a[:, :, 16:] = 1e3
    _, lg_moved, _ = _plain_decode(moved)
    assert torch.equal(lg, lg_moved)
    got = res["decode_early/logits"]
    assert np.isfinite(got).all()
    _assert_rel(got, lg, 1e-5, "early position")


def _plain_loss(case):
    tc = case["cfg"]
    params = params_from_numpy(case["params"])
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    tokens = torch.tensor(case["tokens"])
    loss, _ = tt.lm_loss(tc, params, tokens, tokens)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True)


@pytest.mark.parametrize("name", ["rwkv6_loss", "rwkv6_own_loss",
                                  "rwkv6_even_loss", "granite_loss"])
def test_loss_and_gradients_on_a_mesh_equal_unsharded(mesh_run, name):
    """lm_loss under the train rules: rwkv6 with 6 heads over 4 "model"
    ranks, its band product gathered (32 rows) and its weight split first
    (256 rows: the heads' uneven chunks, padded), rwkv6-3b smoke's 4 heads
    over 2 ranks with its weight split first (each rank's own heads of an
    even split), granite on (2, 2) (the QKV bands, the vocab-parallel
    embedding lookup): each case's blocks choose the layout of
    ``LAYOUTS``; the loss and every gradient leaf within 1e-5 relative of
    the unsharded port's, the loss within 1e-5 of the JAX package's
    ``lm_loss`` on the same weights (the bound of ``test_torch_train``)."""
    cases, res = mesh_run
    case = cases[name]
    assert res[name + "/layouts"] == LAYOUTS[name]
    loss, grads = _plain_loss(case)
    _assert_rel(res[name + "/loss"], loss.detach(), 1e-5, f"{name} loss")
    got = res[name + "/grads"]
    assert len(got) == len(grads)
    for i, (a, b) in enumerate(zip(got, grads)):
        _assert_rel(a, b, 1e-5, f"{name} gradient leaf {i}")
    jc = case["jcfg"]
    toks = jnp.asarray(case["tokens"])
    jl, _ = jt.lm_loss(jc, jax.tree.map(jnp.asarray, case["params"]), toks,
                       toks)
    assert abs(float(res[name + "/loss"]) - float(jl)) <= \
        1e-5 * abs(float(jl))


def test_embedding_gradient_on_a_mesh_equals_unsharded(mesh_run):
    """The vocab-parallel lookup on the (2, 2) mesh under the train rules
    (vocab over "model", batch over "data", the rows reduce-scattered into
    the sequence-sharded activations): the rows equal ``F.embedding``'s
    bit for bit (one nonzero share a row), and the table's gradient
    (each rank's local index-accumulate into its own rows, summed over
    "data") within 1e-5 relative of the unsharded one, nonzero on exactly
    the rows of the tokens used."""
    cases, res = mesh_run
    case = cases["embed"]
    table = torch.tensor(case["table"], requires_grad=True)
    tokens = torch.tensor(case["tokens"])
    x = torch.nn.functional.embedding(tokens, table)
    grad, = torch.autograd.grad((x * torch.tensor(case["weights"])).sum(),
                                [table])
    assert np.array_equal(res["embed/rows"], x.detach().numpy())
    _assert_rel(res["embed/grad"], grad, 1e-5, "embedding table gradient")
    # each rank's own rows, the sum over "data" pending (the train step
    # reduces it onto the table's placements)
    assert res["embed/grad_placements"] == "(Partial(sum), Shard(dim=0))"
    used = np.flatnonzero(np.abs(res["embed/grad"]).sum(axis=1) > 0)
    assert np.array_equal(used, np.unique(case["tokens"]))


def _jax_serve(case):
    """:func:`_plain_serve` through the JAX package's jitted steps on the
    same weights, caches, states and tokens."""
    jc = case["jcfg"]
    params = jax.tree.map(jnp.asarray, case["params"])
    caches = case["caches"] and jax.tree.map(jnp.asarray, case["caches"])
    states = jax.tree.map(jnp.asarray, case["states"])
    tokens = jnp.asarray(case["tokens"])
    if case["kind"] == "prefill":
        lg, _, states = jax.jit(jstep.make_prefill_step(jc))(
            params, tokens, caches, states)
        return [lg], jax.tree.leaves(states)
    step, lgs = jax.jit(jstep.make_decode_step(jc)), []
    for i in range(tokens.shape[1]):
        _, lg, _, states = step(params, tokens[:, i:i + 1], None, states, i)
        lgs.append(lg)
    return lgs, jax.tree.leaves(states)


def _plain_serve(case):
    """The case's prefill, or its decode steps, on the unsharded port:
    ``(logits of each call, the state's leaves after the last)``."""
    tc = case["cfg"]
    params = params_from_numpy(case["params"])
    caches = case["caches"] and params_from_numpy(case["caches"])
    states = params_from_numpy(case["states"])
    tokens = torch.tensor(case["tokens"])
    if case["kind"] == "prefill":
        lg, _, states = tstep.make_prefill_step(tc)(params, tokens, caches,
                                                    states)
        return [lg], tree_leaves(states)
    step, lgs = tstep.make_decode_step(tc), []
    for i in range(tokens.shape[1]):
        _, lg, _, states = step(params, tokens[:, i:i + 1], None, states, i)
        lgs.append(lg)
    return lgs, tree_leaves(states)


@pytest.mark.parametrize("name", ["rwkv6-3b_ssm_decode", "zamba2-7b_prefill"])
def test_recurrent_bands_on_a_mesh_equal_unsharded(mesh_run, name):
    """The recurrent families' column bands on the (2, 2) mesh, where the
    rules spread the fused weights' columns over "model": rwkv6's decode
    steps (each rank multiplies its own columns of ``w_rkvg`` by the mixes
    of their bands, two bands a rank, and the product is gathered once;
    every head then runs on every rank from the whole state) and
    zamba2's prefill (Mamba2's in-projection and the shared attention's
    QKV product, each gathered once and split): every call's logits and
    the final state within 1e-5 relative of the unsharded port's; the
    logits within the LM bound (``lm_logit_tol``) of the JAX package's
    steps on the same weights, states and tokens, the state within 1e-4
    of its largest magnitude (``test_torch_arch_smoke``'s bounds)."""
    cases, res = mesh_run
    case = cases[name]
    assert res[name + "/layouts"] == LAYOUTS[name]
    lgs, states = _plain_serve(case)
    got = res[name + "/logits"]
    assert len(got) == len(lgs)
    for i, (a, b) in enumerate(zip(got, lgs)):
        _assert_rel(a, b.detach(), 1e-5, f"{name} logits of call {i}")
    got_states = res[name + "/states"]
    assert len(got_states) == len(states)
    for i, (a, b) in enumerate(zip(got_states, states)):
        _assert_rel(a, b.detach(), 1e-5, f"{name} state leaf {i}")
    jlgs, jstates = _jax_serve(case)
    tol = lm_logit_tol(case["cfg"], params_from_numpy(case["params"]),
                       case["tokens"].shape[1]).numpy()
    for i, (a, b) in enumerate(zip(got, jlgs)):
        err = np.abs(a.astype(np.float64) - np.asarray(b, np.float64))
        assert (err <= tol).all(), (name, i, float(err.max()),
                                    float(tol.min()))
    assert len(jstates) == len(got_states)
    for i, (a, b) in enumerate(zip(got_states, jstates)):
        b = np.asarray(b, np.float64)
        err = np.abs(a.astype(np.float64) - b).max()
        assert err <= 1e-4 * max(np.abs(b).max(), 1e-30), (name, i, err)
