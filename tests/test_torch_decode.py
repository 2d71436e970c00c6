"""The port's position-bucketed LM decode (``repro_torch.serving.decode``)
against the JAX package's, on the CPU: the twin of ``tests/test_decode.py``.

One decoder layer of the phi4-mini smoke model (float32), weights carried
across from the JAX package with ``params_from_numpy``: prefill and
incremental decode served through ``TMServer`` with the position in the
compile-cache key.

* Bit for bit: the compiled step against the eager step on every backend,
  and ``DecodeSession.generate`` (tokens, logits and caches) against
  ``reference_generate``.
* Within ``LOGIT_ATOL``: the port's logits against the JAX package's
  ``DecodeSession`` on the same weights and prompts.  Both are float32
  evaluations of one network whose products sum in different orders
  (MKL's sgemm against XLA's dot); the smoke model's logits stay below 10
  in magnitude with d_model 48 and d_ff 96, so a relative float32 error of
  a few 1e-7 per sum, carried through one layer, is far below 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.phi4_mini_3p8b import smoke_config as jsmoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import rope_freqs as jrope_freqs  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro.serving.decode import DecodeSession as JDecodeSession  # noqa: E402
from repro_torch.compiler import tm_compile  # noqa: E402
from repro_torch.configs.phi4_mini_3p8b import smoke_config  # noqa: E402
from repro_torch.core.executor import BACKENDS  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import rope_freqs  # noqa: E402
from repro_torch.serving import DecodeSession, make_layer_step  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

CPU = "cpu"
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def cfg():
    return smoke_config()


@pytest.fixture(scope="module")
def jparams():
    return jinit_lm(jsmoke(), jax.random.PRNGKey(0))[0]


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def _np_cache(seed, cfg, T=32):
    return np.random.RandomState(seed).randn(
        1, T, cfg.n_kv_heads, cfg.hd).astype(np.float32)


def _session(cfg, params, **kw):
    return DecodeSession(cfg, params, device=CPU, **kw)


# ---------------------------------------------------------------------------
# the decoder layer compiles whole: KV append, RoPE, head split/merge all TM
# ---------------------------------------------------------------------------

def test_decode_step_compiles_with_tm_kv_append_and_rope(cfg, params):
    step = make_layer_step(cfg, params, position=8)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    ck = torch.zeros((1, 32, cfg.n_kv_heads, cfg.hd))
    c = tm_compile(step, tok, ck, ck)
    # the decode step's manipulation traffic compiles as TM instructions:
    # aten's names for the JAX test's dynamic_update_slice (KV append),
    # mul/add/sub/concatenate/slice (RoPE; torch.chunk is aten's split)
    # and reshape/transpose (the head split and merge)
    required = {"slice_scatter", "mul", "add", "sub", "cat", "split",
                "slice", "view", "permute"}
    assert required <= c.matched_prims, required - c.matched_prims
    # nothing of it fell back: the only note is the embedding's lookup of
    # traced token ids, which is data-dependent (the JAX package leaves
    # that gather opaque too)
    assert not any("scatter" in n for n in c.graph.notes), c.graph.notes
    assert all("traced index vector" in n for n in c.graph.notes)
    kv = [n for n in c.graph.tm_nodes() if n.matched == "slice_scatter"]
    assert len(kv) == 2 and all(n.instr.meta == {"overlay": True}
                                for n in kv)
    mix = c.partition_report.phase_mix()
    assert mix["tmu_instrs"] >= 20, mix


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_step_exact_mode_bit_exact(cfg, params, backend):
    step = make_layer_step(cfg, params, position=4)
    tok = torch.tensor([[7]], dtype=torch.int32)
    ck = torch.tensor(_np_cache(3, cfg))
    cv = torch.tensor(_np_cache(4, cfg))
    c = tm_compile(step, tok, ck, cv)
    got = c(tok, ck, cv, backend=backend, exact=True)
    want = step(tok, ck, cv)
    for g, w in zip(got, want):
        assert_same(g, w)
    # the caller's caches are not written: the step is functional
    assert_same(ck, _np_cache(3, cfg))


def test_cached_attention_step_static_position(cfg):
    jp, _ = jattn.init_attention(jax.random.PRNGKey(1), cfg.d_model,
                                 cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    p = params_from_numpy(jax.tree.map(np.asarray, jp))
    x_np = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                        (1, 1, cfg.d_model)))
    x = to_torch(x_np)
    ck = torch.zeros((1, 16, cfg.n_kv_heads, cfg.hd))
    inv = rope_freqs(cfg.hd, cfg.rope_theta)

    def fn(x, ck, cv):
        return tattn.cached_attention_step(
            p, x, inv, ck, cv, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, position=5)

    c = tm_compile(fn, x, ck, ck)
    assert "slice_scatter" in c.matched_prims
    got = c(x, ck, ck, exact=True)
    want = fn(x, ck, ck)
    for g, w in zip(got, want):
        assert_same(g, w)
    # against the JAX package's step on the same values: the caches are
    # data movement of equal rounded values only where the K/V products
    # agree, so they are held within the product's float32 rounding
    jwant = jattn.cached_attention_step(
        jp, jnp.asarray(x_np), jrope_freqs(cfg.hd, cfg.rope_theta),
        jnp.zeros((1, 16, cfg.n_kv_heads, cfg.hd)),
        jnp.zeros((1, 16, cfg.n_kv_heads, cfg.hd)), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, head_dim=cfg.hd, position=5)
    for g, w in zip(got, jwant):
        assert_same(g, np.asarray(w), atol=LOGIT_ATOL)


# ---------------------------------------------------------------------------
# the session: prefill + decode through TMServer, caches through the futures
# ---------------------------------------------------------------------------

def test_session_prefill_plus_short_decode_bit_exact(cfg, params, jparams):
    prompts_np = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, 4), 0, cfg.vocab), dtype=np.int32)
    prompts = to_torch(prompts_np)
    with _session(cfg, params, max_len=16) as sess:
        got_caches, ref_caches = [], []
        toks, logits = sess.generate(prompts, 4, caches=got_caches)
        ref_toks, ref_logits = sess.reference_generate(prompts, 4,
                                                       caches=ref_caches)
        assert torch.equal(toks, ref_toks)
        assert len(logits) == len(ref_logits) == 4
        for a, b in zip(logits, ref_logits):
            assert_same(a, b)
        for (ak, av), (bk, bv) in zip(got_caches, ref_caches):
            assert_same(ak, bk)
            assert_same(av, bv)
        # one compile-cache entry per (position, seq_len) class
        snap = sess.server.snapshot_stats()
        assert snap["cache"]["entries"] == 4  # prefill@0 + 3 decode positions
        # every entry closes over the session's own parameter tensors: the
        # compiled graphs hold the weights, never copies of them
        embed = sess.params["embed"]["e"]
        for e in sess.server.cache._entries.values():
            ptrs = {t.data_ptr() for t in e.compiled.graph.consts.values()}
            assert embed.data_ptr() in ptrs
    # the JAX package's session on the same weights and prompts
    with JDecodeSession(jsmoke(), jparams, max_len=16) as jsess:
        jtoks, jlogits = jsess.generate(jnp.asarray(prompts_np), 4)
    assert np.array_equal(np.asarray(jtoks), toks.numpy())
    for a, b in zip(logits, jlogits):
        assert_same(a, np.asarray(b), atol=LOGIT_ATOL)


def test_session_warm_pass_hits_cache(cfg, params):
    with _session(cfg, params, max_len=16) as sess:
        prompts = torch.zeros((1, 4), dtype=torch.int32)
        sess.generate(prompts, 3)
        misses_cold = sess.server.snapshot_stats()["cache"]["misses"]
        sess.generate(prompts, 3)
        snap = sess.server.snapshot_stats()
        assert snap["cache"]["misses"] == misses_cold  # warm pass: all hits
        assert snap["cache"]["hits"] >= 3
        stats = sess.stats.snapshot()
        assert stats["prefill_steps"] == 2 and stats["decode_steps"] == 4
        assert stats["positions_compiled"] == 3


def test_session_bounds_checked(cfg, params):
    with _session(cfg, params, max_len=8) as sess:
        with pytest.raises(ValueError):
            sess.prefill(torch.zeros((1, 9), dtype=torch.int32))
        with pytest.raises(ValueError):
            sess.generate(torch.zeros((1, 4), dtype=torch.int32), 5)
        ck, cv = sess.init_cache(1)
        with pytest.raises(ValueError):
            sess.decode(torch.zeros((1, 1), dtype=torch.int32), (ck, cv), 8)


def test_session_draws_its_weights_from_the_generator(cfg):
    """No ``params``: the session draws them from its generator, on its
    device; the same seed gives the same weights and the same tokens."""
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        with DecodeSession(cfg, generator=gen, device=CPU,
                           max_len=8) as sess:
            toks, _ = sess.generate(torch.ones((1, 2), dtype=torch.int32),
                                    3)
            runs.append((toks, sess.params["embed"]["e"]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_session_32_step_decode_bit_exact(cfg, params):
    """The acceptance run: prefill + 32 decode steps, every step's logits
    and caches bit-exact against the uncompiled model, the KV cache
    carried across steps through the compile cache.  (The JAX package's
    session is held against the port's on the short session above: over
    32 greedy steps two float32 evaluations may pick different tokens.)"""
    prompts_np = np.asarray(jax.random.randint(
        jax.random.PRNGKey(9), (2, 8), 0, cfg.vocab), dtype=np.int32)
    with _session(cfg, params, max_len=48) as sess:
        got, ref = [], []
        toks, logits = sess.generate(to_torch(prompts_np), 32, caches=got)
        ref_toks, ref_logits = sess.reference_generate(to_torch(prompts_np),
                                                       32, caches=ref)
        assert torch.equal(toks, ref_toks)
        assert len(logits) == 32
        for a, b in zip(logits, ref_logits):
            assert_same(a, b)
        for (ak, av), (bk, bv) in zip(got, ref):
            assert_same(ak, bk)
            assert_same(av, bv)
        assert sess.server.snapshot_stats()["cache"]["entries"] == 32
