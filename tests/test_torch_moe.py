"""The port's MoE (``models/moe.py``) and batched RME dispatch against the
JAX package, on the CPU.

Inputs come from numpy with a seed; weights are JAX's, carried across with
``params_from_numpy``.  Dispatch is integer work and is compared bit for
bit; the block's output and aux loss are float sums compared within the
tolerances stated at each test.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import rme as jrme  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import rme as trme  # noqa: E402
from repro_torch.core.fp_bounds import gamma  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _same(j, t):
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


# ---------------------------------------------------------------------------
# batched dispatch: vmap(dispatch_tokens) bit for bit
# ---------------------------------------------------------------------------

DISPATCH = {  # (B, T, routed experts, physical experts, capacity)
    "roomy": (3, 24, 4, 4, 24),
    "drops": (2, 40, 4, 4, 5),            # more tokens than capacity
    "capacity_1": (4, 4, 8, 8, 1),        # the decode shape's capacity
    "pad_experts": (2, 32, 6, 8, 7),      # experts 6, 7 receive nothing
    "streams_512": (8, 16, 60, 64, 2),    # B·E = 512 record streams
}


@pytest.mark.parametrize("form", ["plain", "assembled"])
@pytest.mark.parametrize("case", list(DISPATCH))
def test_batched_dispatch_matches_vmapped_jax(case, form):
    """Both forms of the port's dispatch (the one-hot pass, and the records
    through the assemble kernel's plain version, which the card's path
    runs as one launch) equal ``vmap(dispatch_tokens)`` bit for bit."""
    B, T, E, E_phys, cap = DISPATCH[case]
    eo = np.random.RandomState(T + B).randint(0, E, size=(B, T)).astype(
        np.int32)
    ji, jc = jax.vmap(lambda e: jrme.dispatch_tokens(e, E_phys, cap))(
        jnp.asarray(eo))
    fn = trme.dispatch_tokens_plain if form == "plain" \
        else trme.dispatch_tokens_assembled
    ti, tc = fn(torch.tensor(eo), E_phys, cap)
    assert ti.shape == (B, E_phys, cap) and tc.shape == (B, E_phys)
    _same(ji, ti)
    _same(jc, tc)
    if E_phys > E:
        assert (ti[:, E:] == T).all() and (tc[:, E:] == 0).all()


def test_dispatch_tokens_runs_the_plain_form_on_the_cpu():
    eo = torch.tensor(np.random.RandomState(1).randint(0, 5, (2, 9)))
    got = trme.dispatch_tokens(eo, 5, 3)
    want = trme.dispatch_tokens_plain(eo, 5, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    one = trme.dispatch_tokens(eo[0], 5, 3)
    assert torch.equal(one[0], want[0][0]) and torch.equal(one[1], want[1][0])


# ---------------------------------------------------------------------------
# routing and the block
# ---------------------------------------------------------------------------

BLOCKS = {  # (B, S, D, F, experts, top_k, n_shared, pad, router_softmax,
    #          capacity_factor)
    "qwen_like": (2, 12, 32, 16, 8, 4, 1, 10, True, 1.25),
    "llama_like": (2, 10, 32, 24, 4, 1, 1, 0, True, 1.25),
    "sigmoid_top2": (3, 8, 16, 8, 6, 2, 0, 0, False, 1.25),
    "drops": (1, 40, 16, 8, 4, 2, 0, 0, True, 0.5),  # capacity 11 a expert
}


def _block(case, dtype=jnp.float32):
    B, S, D, F, E, k, n_sh, pad, sm, cf = BLOCKS[case]
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(0), D, F, E, k, n_shared=n_sh,
                          shared_d_ff=2 * F, dtype=dtype, pad_experts=pad)
    x = np.random.RandomState(S).randn(B, S, D).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    kw = dict(num_experts=E, top_k=k, router_softmax=sm, n_shared=n_sh,
              capacity_factor=cf)
    return jp, _port(jp), jx, params_from_numpy(np.asarray(jx)), kw


@pytest.mark.parametrize("case", list(BLOCKS))
def test_routing_matches_lax_top_k(case):
    """The same experts, in the same order, and the same gates: an f32
    softmax of the same rounded scores (E exps of a few ulps each, an
    E-long sum, a division) renormalised over k, so two evaluations lie
    within 2 gamma_{E+k+8} relative of each other."""
    jp, tp, jx, tx, kw = _block(case)
    scores = jnp.einsum("bsd,de->bse", jx, jp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(scores, -1) if kw["router_softmax"] \
        else jax.nn.sigmoid(scores)
    jg, je = jax.lax.top_k(probs, kw["top_k"])
    if kw["router_softmax"] and kw["top_k"] > 1:
        jg = jg / jnp.maximum(jg.sum(-1, keepdims=True), 1e-9)
    _, tg, te = tmoe.route(tp, tx, top_k=kw["top_k"],
                           router_softmax=kw["router_softmax"])
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    E = tp["router"].shape[1]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                               rtol=2 * gamma(E + kw["top_k"] + 8), atol=0)


def test_routing_breaks_ties_by_the_lower_index():
    """``lax.top_k`` keeps the lower index first among equal scores; the
    stable descending sort does too (bf16 router scores over 60 experts
    tie)."""
    x = torch.zeros((1, 2, 4))
    p = {"router": torch.zeros((4, 6))}
    _, gates, experts = tmoe.route(p, x, top_k=4)
    assert experts.tolist() == [[[0, 1, 2, 3]] * 2]
    jp = {"router": jnp.zeros((4, 6))}
    _, je = jax.lax.top_k(jax.nn.softmax(
        jnp.einsum("bsd,de->bse", jnp.zeros((1, 2, 4)), jp["router"])), 4)
    assert np.asarray(je).tolist() == experts.tolist()


def _magnitude(tp, tx, kw):
    """The block's sum of magnitudes under the port's routing: every
    product and sum of the block taken on |x|, |weights| and |gates|, with
    silu(g)·u bounded by |g||u| (f64)."""
    p = {k: (v.double().abs() if torch.is_tensor(v)
             else {kk: vv.double().abs() for kk, vv in v.items()})
         for k, v in tp.items()}
    x = tx.double().abs()
    B, S, D = x.shape
    _, gates, experts = tmoe.route(tp, tx, top_k=kw["top_k"],
                                   router_softmax=kw["router_softmax"])
    cap = tmoe.capacity_of(S, kw["top_k"], kw["num_experts"],
                           kw["capacity_factor"])
    idx, valid, xe = tmoe._dispatch(x, experts, p["wi"].shape[0], cap)
    E, C = xe.shape[1], xe.shape[2]
    h = torch.bmm(xe.transpose(0, 1).reshape(E, B * C, D), p["wi"])
    g, u = torch.chunk(h, 2, dim=-1)
    ye = torch.bmm(g * u, p["wo"]).view(E, B, C, D)
    out = tmoe._combine(ye, gates.double().abs(), experts, idx, valid, S)
    if kw["n_shared"]:
        g, u = torch.chunk(x @ p["shared"]["wi"], 2, dim=-1)
        out = out + (g * u) @ p["shared"]["wo"]
    return out.numpy()


@pytest.mark.parametrize("case", list(BLOCKS))
def test_moe_block_matches_jax(case):
    """Routing agrees (checked above), so the two outputs are two f32
    orders of the same sums: within 2 gamma_n of the block's sum of
    magnitudes, n = 2 D + 3 F + k + 16 (the router and wi sums over D, wo
    over F, the k slots, the shared MLP, the elementwise roundings).  The
    aux load balance within 8 f32 ulps."""
    jp, tp, jx, tx, kw = _block(case)
    jout, jaux = jmoe.moe_block(jp, jx, **kw)
    tout, taux = tmoe.moe_block(tp, tx, **kw)
    D, F = tx.shape[-1], tp["wo"].shape[1]
    n = 2 * D + 3 * F + kw["top_k"] + 16
    tol = 2 * gamma(n) * _magnitude(tp, tx, kw)
    err = np.abs(tout.numpy() - np.asarray(jout))
    assert (err <= tol).all(), (err.max(), (err / tol).max())
    assert taux["load_balance"].dtype == torch.float32
    np.testing.assert_allclose(float(taux["load_balance"]),
                               float(jaux["load_balance"]),
                               rtol=8 * 2 ** -23)


def test_moe_block_drops_overflow_like_jax():
    """The "drops" case above really drops: at capacity factor 0.5 an
    expert takes 11 of the 80 routed slots of 40 tokens, and some experts
    are asked for more (their counts saturate at the capacity)."""
    B, S, D, F, E, k, *_ = BLOCKS["drops"]
    _, tp, _, tx, kw = _block("drops")
    _, _, experts = tmoe.route(tp, tx, top_k=k)
    cap = tmoe.capacity_of(S, k, E, kw["capacity_factor"])
    asked = torch.bincount(experts.flatten(), minlength=E)
    _, counts = trme.dispatch_tokens(experts.reshape(B, S * k), E, cap)
    assert cap == 11 and int(asked.max()) > cap
    assert torch.equal(counts[0], torch.clamp(asked, max=cap).to(torch.int32))


def test_moe_combine_is_the_jax_scatter_order():
    """Each token's k contributions sum in ascending expert order, as the
    JAX package's serial scatter-add over the expert-major table: with
    addends whose f32 sum depends on the order (2^-24 + 2^-24 + 1 is
    1 + 2^-23 in that order and 1 in the routed order of token 0), the
    port gives the ascending order's sum."""
    E, B, C, D, S, k = 3, 1, 2, 1, 2, 3
    vals = [2.0 ** -24, 2.0 ** -24, 1.0]           # expert e's output
    ye = torch.tensor(vals).view(E, 1, 1, 1).expand(E, B, C, D).clone()
    expert_of = torch.tensor([[[2, 0, 1], [0, 1, 2]]])
    gates = torch.ones((B, S, k))
    idx = torch.full((B, E, C), S * k)
    for s in range(S):                 # token s takes slot c = s of each
        for j in range(k):
            idx[0, int(expert_of[0, s, j]), s] = s * k + j
    out = tmoe._combine(ye, gates, expert_of, idx, idx < S * k, S)
    want = np.float32(np.float32(vals[0] + vals[1]) + np.float32(vals[2]))
    assert want == np.float32(1 + 2.0 ** -23)
    assert out[0, 0, 0].item() == want == out[0, 1, 0].item()


def test_qwen2_moe_smoke_block_bf16_within_stated_bound():
    """bf16 weights and input, the qwen2-moe smoke block: the two packages
    round each bf16 op once, at other points; measured within 1 bf16 ulp
    of the largest |out|.  Tolerance: 4 bf16 ulps of max |out| (routing
    agrees; checked first)."""
    cfg = jreg.get_smoke("qwen2-moe-a2.7b")
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(3), cfg.d_model, cfg.moe_d_ff,
                          cfg.num_experts, cfg.top_k, n_shared=cfg.n_shared,
                          shared_d_ff=cfg.d_ff, dtype=jnp.bfloat16)
    tp = _port(jp)
    x = np.random.RandomState(5).randn(2, 16, cfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = params_from_numpy(np.asarray(jx))
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
              n_shared=cfg.n_shared)
    jout, _ = jmoe.moe_block(jp, jx, **kw)
    tout, _ = tmoe.moe_block(tp, tx, **kw)
    assert tout.dtype == torch.bfloat16
    mag = float(jnp.abs(jout.astype(jnp.float32)).max())
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    err = np.abs(tout.float().numpy() - np.asarray(jout, np.float32))
    assert err.max() <= 4 * ulp, (err.max(), ulp)


def test_moe_configs_route_over_num_experts_with_padded_weights():
    tc = treg.get_config("qwen2-moe-a2.7b")
    assert (tc.num_experts, tc.num_experts_padded, tc.top_k) == (60, 64, 4)
    cfg = dataclasses.replace(treg.get_smoke("qwen2-moe-a2.7b"),
                              moe_pad_experts=12)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg.d_model,
                      cfg.moe_d_ff, cfg.num_experts, cfg.top_k,
                      n_shared=cfg.n_shared, shared_d_ff=cfg.d_ff,
                      pad_experts=cfg.moe_pad_experts)
    assert p["wi"].shape[0] == 12 and p["router"].shape[1] == 8
    x = torch.randn((2, 6, cfg.d_model), generator=torch.Generator())
    out, _ = tmoe.moe_block(p, x, num_experts=8, top_k=cfg.top_k,
                            n_shared=cfg.n_shared)
    assert out.shape == x.shape and torch.isfinite(out).all()
