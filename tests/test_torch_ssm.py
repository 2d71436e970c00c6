"""The port's SSM blocks (``models/ssm.py``: Mamba2 and RWKV6) against the
JAX package, on the CPU.

Inputs come from numpy with a seed; weights are JAX's, carried across with
``params_from_numpy``.  Both packages run the same algorithm in f32 (the
chunked recurrences, the decays through exp and log), summing in other
orders, so results are compared within ``SSM_RTOL`` of the largest
magnitude of the JAX result: the worst measured distance is under 1e-6 of
it (about 8 f32 ulps), and the tolerance leaves a factor of 10.  The token
shift is data movement and is compared bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

SSM_RTOL = 1e-5


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _x(shape, seed, scale=1.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x)


def assert_close(got, want, what=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = SSM_RTOL * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max |err| {err} > {tol}"


def _randomize(tree, seed):
    """Replace the constant-initialized f32 leaves (mixers, decays, the
    bonus) by random values of the same scale, so the tests see every
    term."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in tree.items():
        a = np.asarray(v)
        if k == "mu":
            a = rng.uniform(0.1, 0.9, a.shape).astype(np.float32)
        elif k in ("u_bonus", "D"):
            a = rng.randn(*a.shape).astype(np.float32) * 0.5
        elif k in ("decay_base", "A_log"):
            a = (a + rng.randn(*a.shape) * 0.5).astype(np.float32)
        out[k] = jnp.asarray(a) if a.dtype != v.dtype else jnp.asarray(
            a, dtype=v.dtype)
    return out


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

MAMBA = dict(d_model=32, d_state=8, expand=2, head_dim=16)


def _mamba():
    jp, _, meta = jssm.init_mamba2(jax.random.PRNGKey(0), **MAMBA)
    jp = _randomize(jp, 1)
    return jp, _port(jp), meta


@pytest.mark.parametrize("S,chunk", [(16, 256), (24, 8), (21, 8), (7, 3)])
def test_mamba2_block_matches_jax(S, chunk):
    """Chunk lengths follow the JAX rule (``while S % chunk: chunk -= 1``:
    21 with 8 runs chunks of 7)."""
    jp, tp, meta = _mamba()
    ju, tu = _x((2, S, MAMBA["d_model"]), S)
    want = jssm.mamba2_block(jp, ju, meta, chunk=chunk)
    got = tssm.mamba2_block(tp, tu, meta, chunk=chunk)
    assert_close(got, want, f"mamba2 S={S}")


def test_mamba2_block_carries_the_state():
    """``h0`` seeds the recurrence and ``return_state`` returns the last
    state: a prefill split in two equals the whole, in both packages."""
    jp, tp, meta = _mamba()
    ju, tu = _x((2, 12, MAMBA["d_model"]), 3)
    H, P, N = meta["n_heads"], meta["head_dim"], meta["d_state"]
    jh0, th0 = _x((2, H, P, N), 4, 0.3)
    jy, jh = jssm.mamba2_block(jp, ju, meta, chunk=4, h0=jh0,
                               return_state=True)
    ty, th = tssm.mamba2_block(tp, tu, meta, chunk=4, h0=th0,
                               return_state=True)
    assert_close(ty, jy, "mamba2 y with h0")
    assert_close(th, jh, "mamba2 state")
    ya, ha = tssm.mamba2_block(tp, tu[:, :5], meta, chunk=4, h0=th0,
                               return_state=True)
    yb, hb = tssm.mamba2_block(tp, tu[:, 5:], meta, chunk=4, h0=ha,
                               return_state=True)
    assert_close(torch.cat([ya, yb], 1), jy, "mamba2 split prefill")
    assert_close(hb, jh, "mamba2 split state")


def test_mamba2_step_matches_jax_and_the_block():
    jp, tp, meta = _mamba()
    ju, tu = _x((3, 5, MAMBA["d_model"]), 6)
    js = jssm.mamba2_init_state(3, meta)
    ts = tssm.mamba2_init_state(3, meta)
    assert ts.shape == js.shape and ts.dtype == torch.float32
    ys = []
    for t in range(5):
        jy, js = jssm.mamba2_step(jp, ju[:, t:t + 1], js, meta)
        ty, ts = tssm.mamba2_step(tp, tu[:, t:t + 1], ts, meta)
        assert_close(ty, jy, f"mamba2 step {t}")
        assert_close(ts, js, f"mamba2 state {t}")
        ys.append(ty)
    assert_close(torch.cat(ys, 1),
                 jssm.mamba2_block(jp, ju, meta, chunk=2), "steps vs block")


def test_mamba2_bf16_weights_keep_f32_leaves():
    jp, _, meta = jssm.init_mamba2(jax.random.PRNGKey(2), **MAMBA,
                                   dtype=jnp.bfloat16)
    tp = _port(jp)
    for k in ("A_log", "D", "dt_bias"):
        assert tp[k].dtype == torch.float32, k
    assert tp["win"].dtype == torch.bfloat16
    own, _ = tssm.init_mamba2(torch.Generator().manual_seed(0), **MAMBA,
                              dtype=torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    np.testing.assert_allclose(own["dt_bias"].numpy(),
                               np.asarray(jp["dt_bias"]), rtol=1e-5)
    ju = jnp.asarray(np.random.RandomState(0).randn(2, 8, 32)
                     .astype(np.float32)).astype(jnp.bfloat16)
    want = jssm.mamba2_block(jp, ju, meta)
    got = tssm.mamba2_block(tp, params_from_numpy(np.asarray(ju)), meta)
    assert got.dtype == torch.bfloat16
    # bf16 out: both round the f32 y once, then the bf16 product rounds
    # again; within 4 bf16 ulps of the largest |out|
    mag = float(jnp.abs(want.astype(jnp.float32)).max())
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= 4 * 2.0 ** (np.floor(np.log2(mag)) - 7), err


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

D_RWKV, K_RWKV = 32, 8


def _rwkv():
    jp, _, meta = jssm.init_rwkv6(jax.random.PRNGKey(1), D_RWKV,
                                  head_dim=K_RWKV)
    jp = _randomize(jp, 2)
    return jp, _port(jp), meta


def test_token_shift_is_bit_exact():
    jx, tx = _x((2, 5, 4), 0)
    jp, tp = _x((2, 1, 4), 1)
    for a, b in ((None, None), (jp, tp)):
        want = jssm.token_shift(jx, a)
        got = tssm.token_shift(tx, b)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["chunked", "stepwise"])
@pytest.mark.parametrize("S,chunk", [(16, 64), (24, 8), (20, 6), (1, 64)])
def test_rwkv6_block_matches_jax(S, chunk, form):
    """Both forms, with a carried state and token-shift input: 20 with
    chunk 6 runs chunks of 5; S == 1 is always stepwise."""
    jp, tp, meta = _rwkv()
    jx, tx = _x((2, S, D_RWKV), S)
    jprev, tprev = _x((2, 1, D_RWKV), 7)
    H = D_RWKV // K_RWKV
    js0, ts0 = _x((2, H, K_RWKV, K_RWKV), 8, 0.3)
    stepwise = form == "stepwise"
    jo, jl, js = jssm.rwkv6_block(jp, jx, meta, x_prev=jprev, state=js0,
                                  chunk=chunk, stepwise=stepwise)
    to, tl, ts = tssm.rwkv6_block(tp, tx, meta, x_prev=tprev, state=ts0,
                                  chunk=chunk, stepwise=stepwise)
    assert_close(to, jo, f"rwkv6 out {form}")
    assert_close(ts, js, f"rwkv6 state {form}")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_rwkv6_chunked_equals_stepwise_and_step():
    """The chunked form against the exact recurrence (the port against
    itself, as the JAX package holds its two forms), and ``rwkv6_step``
    token by token against the block."""
    _, tp, meta = _rwkv()
    _, tx = _x((2, 12, D_RWKV), 9)
    oc, _, sc = tssm.rwkv6_block(tp, tx, meta, chunk=4)
    os_, _, ss = tssm.rwkv6_block(tp, tx, meta, stepwise=True)
    assert_close(oc, os_.numpy(), "chunked vs stepwise")
    assert_close(sc, ss.numpy(), "chunked vs stepwise state")
    prev, state, outs = None, None, []
    for t in range(12):
        o, prev, state = tssm.rwkv6_step(tp, tx[:, t:t + 1], prev, state,
                                         meta)
        outs.append(o)
    assert_close(torch.cat(outs, 1), os_.numpy(), "steps vs block")


def test_rwkv_ffn_matches_jax():
    jp, _ = jssm.init_rwkv_ffn(jax.random.PRNGKey(4), D_RWKV, 48)
    jp = _randomize(jp, 5)
    tp = _port(jp)
    jx, tx = _x((2, 6, D_RWKV), 10)
    jprev, tprev = _x((2, 1, D_RWKV), 11)
    for a, b in ((None, None), (jprev, tprev)):
        jo, jl = jssm.rwkv_ffn(jp, jx, a)
        to, tl = tssm.rwkv_ffn(tp, tx, b)
        assert_close(to, jo, "rwkv_ffn")
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_rwkv6_bf16_weights_compute_in_f32():
    """bf16 weights and input: the mixes are f32 (bf16 times an f32
    mixer), so the products run in f32 with the weights widened, as JAX
    promotes them; the f32 leaves stay f32 across the conversion.  The
    output is bf16, within 4 bf16 ulps of the largest |out|."""
    jp, _, meta = jssm.init_rwkv6(jax.random.PRNGKey(6), D_RWKV,
                                  head_dim=K_RWKV, dtype=jnp.bfloat16)
    tp = _port(jp)
    for k in ("mu", "u_bonus", "decay_base"):
        assert tp[k].dtype == torch.float32, k
    own, _ = tssm.init_rwkv6(torch.Generator().manual_seed(0), D_RWKV,
                             head_dim=K_RWKV, dtype=torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    jx = jnp.asarray(np.random.RandomState(3).randn(2, 10, D_RWKV)
                     .astype(np.float32)).astype(jnp.bfloat16)
    jo, _, js = jssm.rwkv6_block(jp, jx, meta, chunk=5)
    to, _, ts = tssm.rwkv6_block(tp, params_from_numpy(np.asarray(jx)), meta,
                                 chunk=5)
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    mag = float(jnp.abs(jo.astype(jnp.float32)).max())
    err = np.abs(to.float().numpy() - np.asarray(jo, np.float32)).max()
    assert err <= 4 * 2.0 ** (np.floor(np.log2(mag)) - 7), err
    assert_close(ts, js, "bf16 rwkv6 state")
