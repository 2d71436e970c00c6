"""Every arch of the port against the JAX package, at its smoke size, on
the CPU: the port twins of ``tests/test_arch_smoke.py`` (the train step
comes with the training slice), the forward and the serving loop of each
family (dense, moe, ssm, hybrid) and the two stub frontends.

The same weights (JAX's, carried across with ``params_from_numpy``) and the
same numpy inputs go through both packages.  Float results are compared
within the bounds stated at each test, integer ones (tokens) exactly.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.configs import (SHAPES, cell_is_live, get_config,  # noqa: E402
                                 get_smoke, input_specs, list_archs)
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import tm_ops  # noqa: E402
from repro_torch.core.fp_bounds import bf16_ulp, gamma  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.layers import rope_freqs  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _t(a):
    return params_from_numpy(np.asarray(a))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, dtype=np.float32).astype(np.float64)


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jreg.get_smoke(arch), dtype=JDT[dtype]),
            dataclasses.replace(get_smoke(arch), dtype=TDT[dtype]))


def lm_logit_tol(cfg, params, T: int) -> torch.Tensor:
    """Bound on the distance of two f32 evaluations of the LM's logits, per
    vocab row: each lies within gamma_n sqrt(d) max|g| ||e_v|| of the exact
    value, n the longest chain of sums through the network, under the
    stated assumption that the layers do not amplify a relative error (the
    RMSNorm before every block renormalizes, the weights are scaled by
    fan-in^-1/2, the decays are below 1).  Per layer: attention's QKV
    product d, scores hd, softmax and PV 2T, output product H hd; then the
    family's mixer: the MLP d + d_ff; the MoE router d, expert d + moe_d_ff,
    k slots and the shared MLP d + d_ff; RWKV's five products over d, its
    T-step state and its head, the channel mix d + d_ff; Mamba2's in-product
    d, its T-step state over N and P, the out-product over d_inner; the
    hybrid's shared attention over 2d and its projection.  16 more per
    layer for the elementwise roundings, then the unembedding's d."""
    d, L, F, hd, H = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.hd, cfg.n_heads
    attn_n = d + hd + 2 * T + H * hd
    if cfg.family == "dense":
        per = attn_n + d + F
    elif cfg.family == "moe":
        per = attn_n + 2 * d + (cfg.moe_d_ff or F) + cfg.top_k + d + F
    elif cfg.family == "ssm":
        per = 5 * d + T + cfg.ssm_head_dim + d + F
    else:
        d_inner = cfg.ssm_expand * d
        per = d + T + cfg.ssm_state + cfg.ssm_head_dim + d_inner \
            + (2 * d + hd + 2 * T + H * hd + 2 * d) / max(cfg.attn_every, 1)
    n = int(L * (per + 16) + d)
    g = float(params["final_norm"]["g"].abs().max())
    e = params["embed"]["e"].double().norm(dim=-1)
    return 2 * gamma(n) * math.sqrt(d) * g * e


def assert_within(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    tol = _np(tol) if isinstance(tol, torch.Tensor) else tol
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert not (err > tol).any(), (f"{what}: max |err| {err.max()}, worst "
                                   f"err/tol {(err / tol).max()}")


def _run_lm(jc, tc, *, B=2, P=12, G=6, teacher_forced=False):
    """The same prompts through JAX's jitted prefill + decode steps and the
    port's, with KV caches and recurrent states as each family has them;
    returns per-step last-position logits (JAX, port), tokens and the
    port's params."""
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(0))
    tp = _port(jp)
    prompts = np.random.RandomState(0).randint(0, jc.vocab, (B, P))
    jcache = jt.init_caches(jc, B, P + G, dtype=jc.dtype)
    tcache = tt.init_caches(tc, B, P + G, dtype=tc.dtype, device="cpu")
    jstate = jt.init_states(jc, B)
    tstate = tt.init_states(tc, B, device="cpu")
    jpre = jax.jit(jstep.make_prefill_step(jc))
    jdec = jax.jit(jstep.make_decode_step(jc))
    tpre, tdec = tstep.make_prefill_step(tc), tstep.make_decode_step(tc)
    jl, jcache, jstate = jpre(jp, jnp.asarray(prompts, jnp.int32), jcache,
                              jstate)
    tl, tcache, tstate = tpre(tp, torch.tensor(prompts), tcache, tstate)
    jtok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], dim=-1)[:, None].to(torch.int32)
    logits, toks = [(jl[:, -1], tl[:, -1])], [(jtok, ttok)]
    for t in range(P, P + G - 1):
        feed = _t(jtok).to(torch.int32) if teacher_forced else ttok
        jtok, jl, jcache, jstate = jdec(jp, jtok, jcache, jstate, t)
        ttok, tl, tcache, tstate = tdec(tp, feed, tcache, tstate, t)
        logits.append((jl[:, -1], tl[:, -1]))
        toks.append((jtok, ttok))
    if jstate is not None:
        jax.tree.map(lambda a, b: assert_within(
            b, a, 1e-4 * max(float(jnp.abs(a.astype(jnp.float32)).max()),
                             1e-30), "final states"), jstate, tstate)
    return logits, toks, tp


# ---------------------------------------------------------------------------
# each arch: forward, the serving loop, the tree, the counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_forward_matches_jax(arch):
    """Hidden states within 1e-4 of their largest magnitude (the final
    RMSNorm's output, O(1): about 800 f32 ulps, room for the layer stack's
    other sum orders; measured under 1e-5) and logits within the f32 bound
    above."""
    jc, tc = _configs(arch)
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(1))
    tp = _port(jp)
    toks = np.random.RandomState(2).randint(0, jc.vocab, (2, 10))
    jh, _, _, jaux = jt.forward(jc, jp, tokens=jnp.asarray(toks))
    th, _, _, taux = tt.forward(tc, tp, tokens=torch.tensor(toks))
    scale = float(jnp.abs(jh).max())
    assert_within(th, jh, 1e-4 * scale, f"{arch} hidden")
    tol = lm_logit_tol(tc, tp, 10)
    assert_within(tt.logits(tc, tp, th), jt.logits(jc, jp, jh),
                  tol.expand(2, 10, -1), f"{arch} logits")
    if tc.family in ("dense", "moe"):
        np.testing.assert_allclose(float(taux["load_balance"]),
                                   float(jaux["load_balance"]), rtol=1e-5)


@pytest.mark.parametrize("arch", list_archs())
def test_serving_loop_f32_matches_jax(arch):
    """Prefill + greedy decode in f32: the same token at every step, the
    logits within the f32 bound, the final recurrent states within 1e-4 of
    their largest magnitude."""
    jc, tc = _configs(arch)
    logits, toks, tp = _run_lm(jc, tc)
    tol = lm_logit_tol(tc, tp, 18)
    for step, ((jl, tl), (jtok, ttok)) in enumerate(zip(logits, toks)):
        assert torch.equal(ttok, _t(jtok).to(torch.int32)), (arch, step)
        assert tl.dtype == torch.float32
        assert_within(tl, jl, tol.expand(tl.shape), f"{arch} step {step}")


def test_qwen2_moe_bf16_teacher_forced_matches_jax():
    """bf16 weights and caches, the port fed JAX's tokens.  XLA and PyTorch
    round every bf16 op's output once and accumulate products in f32, but
    at other points (a router score rounding to another bf16 value could
    even flip an expert; none does here): measured at most 2 bf16 ulps of
    the step's largest |logit|.  Tolerance: 4 bf16 ulps of it, every row,
    every step."""
    jc, tc = _configs("qwen2-moe-a2.7b", "bfloat16")
    logits, _, _ = _run_lm(jc, tc, teacher_forced=True)
    for step, (jl, tl) in enumerate(logits):
        assert tl.dtype == torch.bfloat16
        mag = torch.tensor(float(jnp.abs(jl.astype(jnp.float32)).max()))
        assert_within(tl, jl, 4 * float(bf16_ulp(mag)), f"bf16 step {step}")


@pytest.mark.parametrize("arch", list_archs())
def test_init_and_counts_match_jax(arch):
    """``init_lm`` keeps the JAX tree leaf for leaf (shape and dtype, in
    bf16 too, the f32 leaves of a bf16 tree staying f32), and the parameter
    counts equal the JAX package's at full size and smoke size."""
    for fn in ("get_config", "get_smoke"):
        j, t = getattr(jreg, fn)(arch), getattr(treg, fn)(arch)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    jc, tc = _configs(arch, "bfloat16")
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(0))
    tp = tt.init_lm(tc, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    mine = jax.tree.map(lambda a: (tuple(a.shape),
                                   str(a.dtype).split(".")[-1]), tp)
    assert mine == shapes
    conv = _port(jp)
    assert jax.tree.map(lambda a: a.dtype, conv) == \
        jax.tree.map(lambda a: a.dtype, tp)


# ---------------------------------------------------------------------------
# recurrence consistency, attention, frontends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_step_by_step_equals_one_prefill(arch):
    """The serve loop's logits, fed the tokens it picked, against one
    prefill of the whole sequence: the chunked recurrence against the
    step form, within the f32 bound."""
    tc = get_smoke(arch)
    params, prompts = tserve.lm_inputs(tc, batch=2, prompt_len=8,
                                       device="cpu")
    toks, _ = tserve.serve(tc, batch=2, prompt_len=8, gen=6, device="cpu",
                           log=lambda m: None)
    seq = torch.cat([prompts, toks[:, :-1]], dim=1)
    h, _, _, _ = tt.forward(tc, params, tokens=seq)
    whole = tt.logits(tc, params, h)[:, 7:]
    caches = tt.init_caches(tc, 2, 14, dtype=torch.float32, device="cpu")
    states = tt.init_states(tc, 2, device="cpu")
    lg, caches, states = tstep.make_prefill_step(tc)(params, prompts,
                                                      caches, states)
    steps, dec = [lg[:, -1]], tstep.make_decode_step(tc)
    for i, t in enumerate(range(8, 13)):
        _, lg, caches, states = dec(params, toks[:, i:i + 1], caches, states,
                                    t)
        steps.append(lg[:, -1])
    tol = lm_logit_tol(tc, params, 14)
    assert_within(torch.stack(steps, 1), whole, tol.expand(2, 6, -1), arch)


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 16), (40, 16), (20, 7)])
def test_chunked_attention_triangular_matches_jax(S, chunk):
    """Within 2 gamma_{2S + D} of the sums of |p v| and |q k| (f32 both)."""
    rng = np.random.RandomState(S)
    q, k, v = (rng.randn(2, S, n, 8).astype(np.float32) for n in (4, 2, 2))
    want = jattn.chunked_attention_triangular(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk)
    got = tattn.chunked_attention_triangular(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), chunk=chunk)
    ref = tattn.chunked_attention(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal=True, chunk=chunk)
    tol = 2 * gamma(2 * S + 8) * 8 * float(np.abs(v).max()) * 4
    assert_within(got, want, tol, "triangular vs JAX")
    assert_within(got, ref, tol, "triangular vs the scanned form")


def test_attention_block_takes_the_triangular_prefill_past_2048(
        monkeypatch):
    """Plain attention past 2048 tokens with ``triangular`` goes through
    the lower-triangle form, as the JAX package's does; without it, the
    scanned form."""
    calls = []
    orig = tattn.chunked_attention_triangular

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(tattn, "chunked_attention_triangular", spy)
    g = torch.Generator().manual_seed(0)
    p = tattn.init_attention(g, 16, 2, 1, 8)
    x = torch.randn((1, 2049, 16), generator=g)
    kw = dict(n_heads=2, n_kv=1, head_dim=8, chunk=1024, attention="plain")
    tattn.attention_block(p, x, rope_freqs(8), triangular=True, **kw)
    assert calls == [(1, 2049, 2, 8)]
    tattn.attention_block(p, x, rope_freqs(8), **kw)
    assert len(calls) == 1


def test_vision_prefix_matches_jax():
    """PixelUnshuffle through the TM engine is data movement (bit for bit
    against JAX's engine); the projection an f32 product within 2
    gamma_K sum |x w|."""
    jc, tc = _configs("internvl2-1b")
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(0))
    tp = _port(jp)
    patches = np.random.RandomState(0).randn(2, 8, 6, jc.vit_dim).astype(
        np.float32)
    want = jt.vision_prefix(jc, jp, jnp.asarray(patches))
    got = tt.vision_prefix(tc, tp, torch.tensor(patches))
    assert got.shape == (2, 12, tc.d_model)
    un = tm_ops.pixel_unshuffle(torch.tensor(patches), 2).reshape(2, 12, -1)
    w = tp["vision_proj"]["w"]
    tol = 2 * gamma(w.shape[0]) * (un.abs() @ w.abs())
    assert_within(got, want, tol, "vision_prefix")
    jl, _, _ = jax.jit(jstep.make_prefill_embeds_step(jc))(
        jp, want, None, None)
    tl, _, _ = tstep.make_prefill_embeds_step(tc)(tp, got, None, None)
    assert_within(tl, jl, lm_logit_tol(tc, tp, 12).expand(tl.shape),
                  "embeds prefill")


def test_audio_embed_matches_jax():
    """The delay-pattern shift and the codebook gathers are data movement
    and an f32 sum of K rows: within 2 gamma_K of the sum of |rows|."""
    jc, tc = _configs("musicgen-large")
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(0))
    tp = _port(jp)
    codes = np.random.RandomState(1).randint(
        1, jc.vocab, (2, jc.n_codebooks, 9)).astype(np.int32)
    want = jt.audio_embed(jc, jp, jnp.asarray(codes))
    got = tt.audio_embed(tc, tp, torch.tensor(codes))
    e = tp["codebook_embed"]["e"]
    mag = sum(e[k][torch.tensor(codes[:, k])].abs() for k in range(4))
    assert_within(got, want, 2 * gamma(4) * mag, "audio_embed")
    # codebook k's first k positions read row 0 (the shift zeroes them)
    for k in range(1, jc.n_codebooks):
        shifted = torch.roll(torch.tensor(codes[:, k]), k, -1)
        assert shifted[:, k:].equal(torch.tensor(codes[:, k, :-k]))


# ---------------------------------------------------------------------------
# port twins of tests/test_arch_smoke.py (the train step excepted)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_smoke_forward_shapes(arch):
    cfg = get_smoke(arch)
    assert cfg.family == get_config(arch).family
    params = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 8
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    h, _, _, _ = tt.forward(cfg, params, tokens=toks)
    assert h.shape == (B, S, cfg.d_model)
    lg = tt.logits(cfg, params, h)
    assert lg.shape == (B, S, cfg.padded_vocab)
    assert torch.isfinite(lg).all()


def test_full_configs_match_assignment():
    """The exact published numbers of the assignment block."""
    expect = {
        "mistral-nemo-12b": (40, 5120, 32, 8, 14336, 131072),
        "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000),
        "phi4-mini-3.8b": (32, 3072, 24, 8, 8192, 200064),
        "granite-8b": (36, 4096, 32, 8, 14336, 49152),
        "musicgen-large": (48, 2048, 32, 32, 8192, 2048),
        "llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048),
        "qwen2-moe-a2.7b": (24, 2048, 16, 16, 1408, 151936),
        "zamba2-7b": (81, 3584, 32, 32, 14336, 32000),
        "rwkv6-3b": (32, 2560, None, None, 8960, 65536),
        "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
    }
    assert set(expect) == set(list_archs())
    for arch, (L, D, H, KV, F, V) in expect.items():
        cfg = get_config(arch)
        assert cfg.n_layers == L and cfg.d_model == D and cfg.vocab == V, arch
        if H is not None:
            assert cfg.n_heads == H and cfg.n_kv_heads == KV, arch
        ff = cfg.moe_d_ff if cfg.family == "moe" else cfg.d_ff
        assert ff == F, (arch, ff, F)


def test_moe_configs():
    q = get_config("qwen2-moe-a2.7b")
    assert (q.num_experts, q.top_k, q.n_shared) == (60, 4, 4)
    sc = get_config("llama4-scout-17b-a16e")
    assert (sc.num_experts, sc.top_k) == (16, 1)


def test_cell_liveness_32_plus_8():
    live = skipped = 0
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, reason = cell_is_live(cfg, shape)
            live += ok
            skipped += not ok
            if not ok:
                assert shape == "long_500k" \
                    and reason == "skipped(full-attention)"
            assert (ok, reason) == jshapes.cell_is_live(
                jreg.get_config(arch), shape)
    assert (live, skipped) == (32, 8)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_are_abstract(shape):
    """Meta tensors (never allocated) with the JAX stand-ins' shapes and
    dtypes, for zamba2 (live for all four shapes) and the other families."""
    for arch in ("zamba2-7b", "rwkv6-3b", "qwen2-moe-a2.7b", "internvl2-1b"):
        specs = input_specs(get_config(arch), shape)
        jspecs = jshapes.input_specs(jreg.get_config(arch), shape)
        leaves = jax.tree.leaves(specs)
        assert leaves and all(isinstance(t, torch.Tensor)
                              and t.device.type == "meta" for t in leaves)
        assert jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[-1]),
                            specs) == \
            jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jspecs)


@pytest.mark.parametrize("arch", list_archs())
def test_serve_cli_smoke_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "6", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated token ids" in out and "decode 2 steps" in out
