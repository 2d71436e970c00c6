"""The port's LM serving slice against the JAX package, on the CPU.

The flash kernels' plain versions against the JAX package's Pallas kernels
in interpret mode; the layers, ``attention_block`` and the prefill + decode
loop of ``phi4-mini-3.8b``'s smoke config against the JAX functions, with
the JAX package's weights carried across (``params_from_numpy``).  Inputs
come from numpy with a seed.  Every tolerance is stated where it is used:
float results are never compared bit for bit across the two frameworks,
which sum in other orders.
"""

import dataclasses
import math
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.kernels.flash_attention import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.flash_attention import (decode_ref as j_decode_ref,  # noqa: E402
                                           flash_attention_call as j_fa,
                                           flash_decode_call as j_fd)
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.runtime import step as jstep  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.fp_bounds import (U32, attention_tol, bf16_ulp,  # noqa: E402
                                        gamma)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, decode_ref, flash_attention_call, flash_decode_call)
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import step as tstep  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(rng, shape, dtype: str):
    """numpy f32 values, rounded to ``dtype`` once, as (jax, torch)."""
    a = rng.randn(*shape).astype(np.float32)
    j = jnp.asarray(a).astype(JDT[dtype])
    return j, _t(j)


def _t(a):
    return params_from_numpy(np.asarray(a))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, dtype=np.float32).astype(np.float64)


def assert_within(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    tol = _np(tol) if isinstance(tol, torch.Tensor) else tol
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    bad = err > tol
    assert not bad.any(), (f"{what}: max |err| {err.max()}, worst err/tol "
                           f"{(err / np.maximum(tol, 1e-300)).max()}")


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# the plain flash versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

SHAPES = {"square": (64, 64), "s_lt_sk": (48, 80), "s_gt_sk": (80, 48),
          "odd": (21, 21)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(dtype, causal, shape):
    """attention_tol: two evaluations in any order differ by at most the
    derived bound (scores' and sums' rounding; in bf16 the Pallas kernel's
    p rounded to bf16 and both outputs' rounding)."""
    S, Sk = SHAPES[shape]
    rng = np.random.RandomState(zlib.crc32(f"{dtype}{causal}{shape}".encode()))
    (jq, q), (jk, k), (jv, v) = (_rand(rng, (3, n, 16), dtype)
                                 for n in (S, Sk, Sk))
    want = j_fa(jq, jk, jv, causal=causal)
    got = flash_attention_call(q, k, v, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (3, S, 16)
    assert_within(got, want, attention_tol(q, k, v, causal=causal),
                  f"flash_attention {dtype} causal={causal} {shape}")


def test_causal_alignment_is_top_left():
    """S != Sk: query i sees keys 0..i (Pallas qi >= ki), not the
    bottom-right alignment of FlashAttention-style libraries."""
    rng = np.random.RandomState(7)
    _, q = _rand(rng, (2, 4, 8), "float32")
    _, k = _rand(rng, (2, 12, 8), "float32")
    _, v = _rand(rng, (2, 12, 8), "float32")
    got = attention_ref(q, k, v, causal=True)
    for i in range(4):  # row i is the attention of query i over keys 0..i
        row = attention_ref(q[:, i:i + 1], k[:, :i + 1], v[:, :i + 1],
                            causal=False)
        assert torch.allclose(got[:, i:i + 1], row, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax_ref(dtype):
    rng = np.random.RandomState(3)
    (jq, q), (jk, k), (jv, v) = (_rand(rng, (2, 24, 16), dtype)
                                 for _ in range(3))
    for causal in (True, False):
        assert_within(attention_ref(q, k, v, causal=causal),
                      j_attention_ref(jq, jk, jv, causal=causal),
                      attention_tol(q, k, v, causal=causal),
                      f"attention_ref causal={causal}")
    for length in (0, 5, 24):
        assert_within(decode_ref(q[:, :1], k, v, length),
                      j_decode_ref(jq[:, :1], jk, jv, length),
                      attention_tol(q[:, :1], k, v, causal=False,
                                    length=length), f"decode_ref {length}")


DECODE_S = 40  # Pallas bk = gcd(40, 512) = 8: five cache blocks


@pytest.mark.parametrize("length", [0, 1, 17, DECODE_S, DECODE_S + 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas(dtype, length):
    rng = np.random.RandomState(length + 11)
    jq, q = _rand(rng, (3, 1, 16), dtype)
    (jk, k), (jv, v) = (_rand(rng, (3, DECODE_S, 16), dtype)
                        for _ in range(2))
    want = j_fd(jq, jk, jv, jnp.int32(length))
    got = flash_decode_call(q, k, v, length)
    tol = attention_tol(q, k, v, causal=False, length=length)
    assert_within(got, want, tol, f"flash_decode {dtype} length={length}")
    # the length also arrives as a tensor (the kernel reads it on the card)
    assert torch.equal(got, flash_decode_call(q, k, v, torch.tensor(length)))
    if length <= 0:  # every score -1e30: p = 1 on every row, the mean of v
        mean = v.double().mean(dim=1, keepdim=True)
        assert_within(got, mean, tol, "length 0 is the mean of v")
        assert_within(want, mean, tol, "Pallas: length 0 is the mean of v")


def _heads_first(x, G=1):
    """(B, S, KV, D) -> (B*KV*G, S, D), each KV head repeated G times."""
    x = jnp.repeat(x, G, axis=2)
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layout_entries_match_repeat_then_pallas(dtype, G):
    """q (B, S, H, D) against k, v (B, Sk, KV, D), H = G KV, with query
    head h reading KV head h // G: equal to repeating the KV heads and
    running the Pallas kernels on (BH, S, D)."""
    B, S, KV, D = 2, 24, 2, 16
    H = G * KV
    rng = np.random.RandomState(G)
    jq, q = _rand(rng, (B, S, H, D), dtype)
    (jk, k), (jv, v) = (_rand(rng, (B, S, KV, D), dtype) for _ in range(2))
    want = j_fa(_heads_first(jq), _heads_first(jk, G), _heads_first(jv, G))
    want = want.reshape(B, H, S, D).transpose(0, 2, 1, 3)
    got = fa.flash_attention(q, k, v, causal=True)
    assert got.shape == (B, S, H, D)
    assert_within(got, want, attention_tol(q, k, v), f"prefill G={G}")
    for length in (0, 9):
        want = j_fd(_heads_first(jq[:, :1]), _heads_first(jk, G),
                    _heads_first(jv, G), jnp.int32(length))
        want = want.reshape(B, H, 1, D).transpose(0, 2, 1, 3)
        got = fa.flash_decode(q[:, :1], k, v, length)
        assert got.shape == (B, 1, H, D)
        assert_within(got, want, attention_tol(q[:, :1], k, v, causal=False,
                                               length=length),
                      f"decode G={G} length={length}")


def _failing_loader(name):
    raise RuntimeError(f"nvcc failed for {name}.cu")


def _flash_calls():
    return {
        "flash_attention": lambda x: fa.flash_attention(x, x, x),
        "flash_decode": lambda x: fa.flash_decode(x[:, :1], x, x, 3),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_decode"])
def test_flash_wrappers_raise_when_kernel_build_fails(monkeypatch, kernel):
    """A non-CPU tensor goes to the kernel: when the library cannot be built
    the wrapper raises, and it never returns the plain version."""
    monkeypatch.setattr(build, "library", _failing_loader)
    call = _flash_calls()[kernel]
    x = torch.rand(2, 8, 16)
    assert call(x) is not None  # CPU tensor: the plain version runs
    before = (fa.flash_attention.launches, fa.flash_decode.launches)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call(x.to("meta"))
    assert (fa.flash_attention.launches, fa.flash_decode.launches) == before
    monkeypatch.setattr(build, "library", lambda name: object())
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(x.to("meta"))


def test_flash_attention_library_is_built_with_the_others():
    assert set(build.SIGNATURES["flash_attention"]) == {
        "flash_attention_fwd", "flash_attention_decode",
        "flash_attention_decode_partial"}
    assert build.library_path("flash_attention").name == \
        "libflash_attention.so"


@pytest.mark.parametrize("T,blocks", [(1088, 64), (32768, 2), (100, 4),
                                      (4096, 24), (1, 1), (10 ** 6, 64)])
def test_decode_split_covers_the_cache_from_shapes_alone(T, blocks):
    """flash_decode's row splits: a multiple of 64 rows each, covering the
    T rows with no split wholly past T, within CUDA's 65535 grid rows,
    from T and the grid alone (never the length, so one captured decode
    serves every position), no more blocks than one wave of
    BLOCKS_PER_SM on each SM unless a split is the whole cache; at the
    LM's decode shape (T = 1088, 64 blocks) 6 splits of 192 rows: 384
    blocks on 132 SMs."""
    rows, splits = fa.decode_split(T, blocks, 132)
    assert rows % fa.SPLIT_ROWS == 0 and rows >= fa.SPLIT_ROWS
    assert rows * (splits - 1) < T <= rows * splits <= T + rows
    assert 1 <= splits <= 65535
    assert blocks * splits <= fa.BLOCKS_PER_SM * 132 or splits == 1
    if (T, blocks) == (1088, 64):
        assert (rows, splits) == (192, 6)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches():
    """Sum of d squares in f32, a rsqrt, a product: (gamma_d + 4u) of |y|
    per evaluation."""
    rng = np.random.RandomState(0)
    jx, x = _rand(rng, (2, 5, 48), "float32")
    jg, g = _rand(rng, (48,), "float32")
    want = jlayers.rmsnorm({"g": jg}, jx)
    got = tlayers.rmsnorm({"g": g}, x)
    assert_within(got, want, 2 * (gamma(48) + 4 * U32) * _np(want).__abs__(),
                  "rmsnorm")


def test_mlp_matches():
    """SwiGLU: products of d and d_ff terms, silu in between (|silu'| <
    1.1): each evaluation within 2 gamma_{d + d_ff + 8} of the magnitude
    (|gate| |up|) @ |wo|, with gate and up from |x| @ |wi|."""
    d, f = 48, 96
    rng = np.random.RandomState(1)
    jx, x = _rand(rng, (2, 5, d), "float32")
    jp = jlayers.init_mlp(jax.random.PRNGKey(0), d, f)[0]
    tlp = _port(jp)
    want = jlayers.mlp(jp, jx)
    got = tlayers.mlp(tlp, x)
    h = x.double().abs() @ tlp["wi"].double().abs()
    mag = (h[..., :f] * h[..., f:]) @ tlp["wo"].double().abs()
    assert_within(got, want, 4 * gamma(d + f + 8) * mag, "mlp")


def test_apply_rope_matches():
    """The angles are the same f32 products; cos and sin differ by a few
    ulps between XLA and PyTorch: (|x1| + |x2|) 8u."""
    rng = np.random.RandomState(2)
    jx, x = _rand(rng, (2, 7, 3, 16), "float32")
    pos = np.arange(100, 107)
    inv = tlayers.rope_freqs(16, 10000.0)
    assert_within(inv, jlayers.rope_freqs(16, 10000.0), 2 * U32, "rope_freqs")
    want = jlayers.apply_rope(jx, jnp.asarray(pos),
                              jlayers.rope_freqs(16, 10000.0))
    got = tlayers.apply_rope(x, torch.tensor(pos), inv)
    xa = x.double().abs()
    mag = (xa[..., :8] + xa[..., 8:]).repeat(1, 1, 1, 2)
    assert_within(got, want, 8 * U32 * (1 + pos.max()) * mag, "apply_rope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_unembed_with_padded_vocab(dtype):
    """Embedding rows are gathered exactly; logits are sums of d products
    (2 gamma_d sum |x e| apart, and one rounding each in bf16), and the
    padding rows of the vocab read -1e9 exactly."""
    jp = jlayers.init_embedding(jax.random.PRNGKey(1), 256, 32,
                                dtype=JDT[dtype])[0]
    tp = _port(jp)
    toks = np.random.RandomState(3).randint(0, 200, (2, 5))
    want = jlayers.embed(jp, jnp.asarray(toks))
    got = tlayers.embed(tp, torch.tensor(toks))
    assert torch.equal(got, _t(want))
    want = jlayers.unembed(jp, want, valid_vocab=200)
    got = tlayers.unembed(tp, got, valid_vocab=200)
    assert got.dtype == TDT[dtype] and got.shape == (2, 5, 256)
    assert (got[..., 200:] == torch.tensor(-1e9, dtype=got.dtype)).all()
    mag = tlayers.embed(tp, torch.tensor(toks)).double().abs() @ \
        tp["e"].double().abs().T
    tol = 2 * gamma(32) * mag
    if dtype == "bfloat16":
        tol = tol + 2 * bf16_ulp(got.float())
    assert_within(got, want, tol, "unembed")


# ---------------------------------------------------------------------------
# attention_block
# ---------------------------------------------------------------------------

def _block_tol(p, x, *, n_heads, n_kv, hd, positions, cache=None):
    """Distance of two f32 evaluations of the block: its longest chain of
    sums (QKV product d, scores hd, softmax and PV over T, output H hd)
    relative to the block's magnitude (A @ |wo|, A the exact softmax weights
    applied to |v|), times the softmax's sensitivity to its scores
    (1 + 2 max|s|).  ``cache``: (k, v, length) of a decode step, attended
    instead of the fresh keys, causally; ``length <= 0`` masks every row
    alike (uniform weights: the mean of v)."""
    xd = x.double()
    pd = {k: w.double() for k, w in p.items()}
    q, k, v = tattn.qkv_split(pd, xd, n_heads, n_kv, hd)
    inv = tlayers.rope_freqs(hd).double()
    q = tlayers.apply_rope(q, positions, inv)
    k = tlayers.apply_rope(k, positions, inv)
    B, S = x.shape[:2]
    if cache is not None:
        k, v, length = cache
        rows = slice(None) if length <= 0 else slice(0, length)
        k, v = k[:, rows].double(), v[:, rows].double()
    T = k.shape[1]
    qg = q.reshape(B, S, n_kv, n_heads // n_kv, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(hd)
    if cache is not None and cache[2] <= 0:
        s = torch.zeros_like(s)
    elif cache is None:
        s = s.masked_fill(positions[:, None] < torch.arange(T)[None, :],
                          -1e30)
    prob = torch.softmax(s, dim=-1)
    A = torch.einsum("bkgst,btkd->bskgd", prob, v.abs())
    mag = A.reshape(B, S, n_heads * hd) @ pd["wo"].abs()
    smax = float(s.masked_fill(s < -1e29, 0).abs().max())
    n = x.shape[-1] + hd + 2 * T + n_heads * hd + 16
    return 2 * gamma(n) * (1 + 2 * smax) * mag


def _band_tol(p, x, *, n_heads, n_kv, hd, position):
    """The K band of one step: the QKV product's d-term sums and RoPE's
    cos/sin (a few ulps of angles up to the position), on |x| @ |wk| with
    the two RoPE halves added."""
    h = (x.double().abs() @ p["wqkv"].double().abs())[
        :, 0, n_heads * hd:(n_heads + n_kv) * hd].reshape(-1, n_kv, hd)
    half = h[..., :hd // 2] + h[..., hd // 2:]
    mag = torch.cat([half, half], dim=-1)
    return 2 * (gamma(x.shape[-1]) + 8 * U32 * (1 + position)) * mag


BLOCKS = {  # (d_model, n_heads, n_kv, head_dim, S)
    "prefill": (48, 6, 2, 8, 24),
    "prefill_long": (16, 2, 1, 8, 2056),  # JAX: chunked_attention (S > 2048)
}


@pytest.mark.parametrize("attention", ["flash", "plain"])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_attention_block_prefill_matches(case, attention):
    d, H, KV, hd, S = BLOCKS[case]
    jp = jattn.init_attention(jax.random.PRNGKey(4), d, H, KV, hd)[0]
    tp = _port(jp)
    jx, x = _rand(np.random.RandomState(5), (1, S, d), "float32")
    inv_j = jlayers.rope_freqs(hd)
    want, _ = jattn.attention_block(jp, jx, inv_j, n_heads=H, n_kv=KV,
                                    head_dim=hd)
    got, cache = tattn.attention_block(tp, x, tlayers.rope_freqs(hd),
                                       n_heads=H, n_kv=KV, head_dim=hd,
                                       attention=attention)
    assert cache is None
    tol = _block_tol(tp, x, n_heads=H, n_kv=KV, hd=hd,
                     positions=torch.arange(S))
    assert_within(got, want, tol, f"attention_block {case} {attention}")


@pytest.mark.parametrize("attention", ["flash", "plain"])
def test_attention_block_with_cache_matches(attention):
    """Prefill into the cache at index 0, then decode steps at several
    positions (S == 1: the flash-decode entry), each against JAX's block
    fed the same cache; the port writes its band in place."""
    d, H, KV, hd, P, T = 48, 6, 2, 8, 10, 16
    jp = jattn.init_attention(jax.random.PRNGKey(6), d, H, KV, hd)[0]
    tp = _port(jp)
    rng = np.random.RandomState(7)
    jx, x = _rand(rng, (2, P, d), "float32")
    jcache = jattn.init_cache(2, T, KV, hd, dtype=jnp.float32)
    cache = tattn.init_cache(2, T, KV, hd, dtype=torch.float32, device="cpu")
    assert cache["k"].data_ptr() != cache["v"].data_ptr()
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd)
    want, jcache = jattn.attention_block(jp, jx, jlayers.rope_freqs(hd),
                                         cache=jcache, cache_index=0, **kw)
    got, out_cache = tattn.attention_block(tp, x, tlayers.rope_freqs(hd),
                                           cache=cache, cache_index=0,
                                           attention=attention, **kw)
    assert out_cache is cache  # written in place
    tol = _block_tol(tp, x, n_heads=H, n_kv=KV, hd=hd,
                     positions=torch.arange(P))
    assert_within(got, want, tol, "prefill with cache")
    for t in (P, P + 1, T - 1):
        jx1, x1 = _rand(rng, (2, 1, d), "float32")
        # the same cache on both sides, so only this step's rounding counts
        cache = {"k": _t(jcache["k"]), "v": _t(jcache["v"])}
        before = cache["v"].clone()
        want, jcache = jattn.attention_block(
            jp, jx1, jlayers.rope_freqs(hd), cache=jcache, cache_index=t,
            **kw)
        got, _ = tattn.attention_block(tp, x1, tlayers.rope_freqs(hd),
                                       cache=cache, cache_index=t,
                                       attention=attention, **kw)
        # the band written at t; every other row untouched
        assert_within(cache["k"][:, t], jcache["k"][:, t],
                      _band_tol(tp, x1, n_heads=H, n_kv=KV, hd=hd,
                                position=t), f"k band at {t}")
        rows = torch.arange(T) != t
        assert torch.equal(cache["v"][:, rows], before[:, rows])
        tol = _block_tol(tp, x1, n_heads=H, n_kv=KV, hd=hd,
                         positions=torch.tensor([t]),
                         cache=(cache["k"], cache["v"], t + 1))
        assert_within(got, want, tol, f"decode at {t}")


BAND_CASES = {  # (cache_index, S) in an 8-row cache
    "past_end": (8, 1),    # lax clamps to row 7
    "negative": (-1, 1),   # lax wraps to row 7; the decode length is 0
    "overhang": (6, 4),    # lax clamps to rows 4-7
}


@pytest.mark.parametrize("attention", ["flash", "plain"])
@pytest.mark.parametrize("case", list(BAND_CASES))
def test_kv_band_write_clamps_as_lax(case, attention):
    """A band asked for past the cache, below 0 or overhanging its end lands
    in the rows lax.dynamic_update_slice writes (band_start); every other
    row of both caches stays bit for bit; the output matches JAX's block,
    whose decode length is cache_index + S, unclamped (-1 + 1 = 0 masks
    every row: the mean of v)."""
    cache_index, S = BAND_CASES[case]
    d, H, KV, hd, T = 48, 6, 2, 8, 8
    jp = jattn.init_attention(jax.random.PRNGKey(9), d, H, KV, hd)[0]
    tp = _port(jp)
    rng = np.random.RandomState(10)
    jx, x = _rand(rng, (2, S, d), "float32")
    (jk, k0), (jv, v0) = (_rand(rng, (2, T, KV, hd), "float32")
                          for _ in range(2))
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd)
    want, jcache = jattn.attention_block(
        jp, jx, jlayers.rope_freqs(hd), cache={"k": jk, "v": jv},
        cache_index=cache_index, **kw)
    cache = {"k": k0.clone(), "v": v0.clone()}
    got, _ = tattn.attention_block(tp, x, tlayers.rope_freqs(hd),
                                   cache=cache, cache_index=cache_index,
                                   attention=attention, **kw)
    start = tattn.band_start(cache_index, T, S)
    outside = (torch.arange(T) < start) | (torch.arange(T) >= start + S)
    for name, before in (("k", k0), ("v", v0)):
        # JAX wrote exactly the band's rows, and the port nothing else
        assert torch.equal(_t(jcache[name])[:, outside], before[:, outside])
        assert torch.equal(cache[name][:, outside], before[:, outside])
    wv = tp["wqkv"][:, (H + KV) * hd:].double().abs()
    for r in range(S):
        row = start + r
        assert_within(cache["k"][:, row], jcache["k"][:, row],
                      _band_tol(tp, x[:, r:r + 1], n_heads=H, n_kv=KV,
                                hd=hd, position=abs(cache_index + r)),
                      f"k band row {row}")
        vtol = 2 * gamma(d) * (x[:, r].double().abs() @ wv)
        assert_within(cache["v"][:, row], jcache["v"][:, row],
                      vtol.reshape(-1, KV, hd), f"v band row {row}")
    if S == 1:  # decode: the cache as written, to cache_index + 1 rows
        tol = _block_tol(tp, x, n_heads=H, n_kv=KV, hd=hd,
                         positions=torch.tensor([cache_index]),
                         cache=(cache["k"], cache["v"], cache_index + 1))
    else:  # prefill: causal within the fresh segment
        tol = _block_tol(tp, x, n_heads=H, n_kv=KV, hd=hd,
                         positions=torch.arange(S))
    assert_within(got, want, tol, f"block at cache_index {cache_index}")


@pytest.mark.parametrize("S", [1, 3, 8])
def test_band_start_is_lax_dynamic_update_slice(S):
    """band_start against where lax.dynamic_update_slice puts a band of S
    ones in an 8-row zero cache, for every start from -2T to 2T."""
    T = 8
    for cache_index in range(-2 * T, 2 * T + 1):
        out = np.asarray(jax.lax.dynamic_update_slice(
            jnp.zeros(T), jnp.ones(S), (cache_index,)))
        want = int(np.flatnonzero(out)[0])
        assert tattn.band_start(cache_index, T, S) == want, cache_index
        assert out.sum() == S


def test_full_and_chunked_attention_match_jax():
    """The ported jnp paths, each against its JAX function."""
    rng = np.random.RandomState(8)
    jq, q = _rand(rng, (2, 12, 6, 8), "float32")
    (jk, k), (jv, v) = (_rand(rng, (2, 12, 2, 8), "float32")
                        for _ in range(2))
    tol = attention_tol(q, k, v, causal=True)
    assert_within(tattn.full_attention(q, k, v, causal=True),
                  jattn.full_attention(jq, jk, jv, causal=True), tol, "full")
    assert_within(tattn.chunked_attention(q, k, v, causal=True, chunk=5),
                  jattn.chunked_attention(jq, jk, jv, causal=True, chunk=5),
                  tol, "chunked")
    tol = attention_tol(q[:, :1], k, v, causal=False, length=7)
    assert_within(tattn.full_attention(q[:, :1], k, v, causal=False,
                                       kv_len=7),
                  jattn.full_attention(jq[:, :1], jk, jv, causal=False,
                                       kv_len=7), tol, "full kv_len")


def test_cached_attention_step_matches_block():
    d, H, KV, hd = 48, 6, 2, 8
    jp = jattn.init_attention(jax.random.PRNGKey(9), d, H, KV, hd)[0]
    tp = _port(jp)
    _, x = _rand(np.random.RandomState(9), (1, 1, d), "float32")
    c = tattn.init_cache(1, 8, KV, hd, dtype=torch.float32, device="cpu")
    ck, cv = c["k"].clone(), c["v"].clone()
    out, ck2, cv2 = tattn.cached_attention_step(
        tp, x, tlayers.rope_freqs(hd), ck, cv, n_heads=H, n_kv=KV,
        head_dim=hd, position=3)
    # the step's default is the plain attention (a compute node of the
    # served step), against the in-place block on the same attention
    want, _ = tattn.attention_block(tp, x, tlayers.rope_freqs(hd),
                                    n_heads=H, n_kv=KV, head_dim=hd,
                                    cache=c, cache_index=3,
                                    attention="plain")
    # functional append: new caches, the caller's left untouched
    assert ck2 is not ck and cv2 is not cv
    assert not ck.any() and not cv.any()
    assert torch.equal(out, want)
    assert torch.equal(ck2, c["k"]) and torch.equal(cv2, c["v"])


# ---------------------------------------------------------------------------
# the slice as a whole: phi4-mini smoke, prefill + decode
# ---------------------------------------------------------------------------

def lm_logit_tol(cfg, params, T: int) -> torch.Tensor:
    """Bound on the distance of two f32 evaluations of the LM's logits,
    per vocab row: each lies within gamma_n sqrt(d) max|g| ||e_v|| of the
    exact value, n the longest chain of sums through the network (per
    layer: the QKV product d, scores hd, softmax and PV 2T, the output
    product H hd, the MLP d + d_ff; then the unembedding's d), under the
    stated assumption that the layers do not amplify a relative error (the
    RMSNorm before every block renormalizes, the weights are scaled by
    fan-in^-1/2); the final RMSNorm bounds sum|h_i||e_vi| by sqrt(d) max|g|
    ||e_v|| (Cauchy-Schwarz)."""
    d = cfg.d_model
    n = cfg.n_layers * (d + cfg.hd + 2 * T + cfg.n_heads * cfg.hd + d
                        + cfg.d_ff + 16) + d
    g = float(params["final_norm"]["g"].abs().max())
    e = params["embed"]["e"].double().norm(dim=-1)
    return 2 * gamma(n) * math.sqrt(d) * g * e


def _smoke(dtype):
    jc = dataclasses.replace(jreg.get_smoke("phi4-mini-3.8b"),
                             dtype=JDT[dtype])
    tc = dataclasses.replace(treg.get_smoke("phi4-mini-3.8b"),
                             dtype=TDT[dtype])
    return jc, tc


def _run_lm(jc, tc, *, B=2, P=12, G=8, teacher_forced=False):
    """The same prompts through JAX's jitted prefill + decode steps and
    the port's; returns per-step logits (JAX, port), tokens and params."""
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(0))
    tp = _port(jp)
    prompts = np.random.RandomState(0).randint(0, jc.vocab, (B, P))
    jcache = jt.init_caches(jc, B, P + G, dtype=jc.dtype)
    tcache = tt.init_caches(tc, B, P + G, dtype=tc.dtype, device="cpu")
    jpre = jax.jit(jstep.make_prefill_step(jc))
    jdec = jax.jit(jstep.make_decode_step(jc))
    tpre, tdec = tstep.make_prefill_step(tc), tstep.make_decode_step(tc)
    jl, jcache, _ = jpre(jp, jnp.asarray(prompts, jnp.int32), jcache, None)
    tl, tcache, _ = tpre(tp, torch.tensor(prompts), tcache, None)
    jtok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1], dim=-1)[:, None].to(torch.int32)
    logits, toks = [(jl[:, -1], tl[:, -1])], [(jtok, ttok)]
    for t in range(P, P + G - 1):
        feed = _t(jtok).to(torch.int32) if teacher_forced else ttok
        jtok, jl, jcache, _ = jdec(jp, jtok, jcache, None, t)
        ttok, tl, tcache, _ = tdec(tp, feed, tcache, None, t)
        logits.append((jl[:, -1], tl[:, -1]))
        toks.append((jtok, ttok))
    return logits, toks, tp


def test_phi4_smoke_f32_loop_matches_jax():
    """Greedy tokens equal at every step, logits within lm_logit_tol."""
    jc, tc = _smoke("float32")
    logits, toks, tp = _run_lm(jc, tc)
    tol = lm_logit_tol(tc, tp, 20)
    for step, ((jl, tl), (jtok, ttok)) in enumerate(zip(logits, toks)):
        assert torch.equal(ttok, _t(jtok).to(torch.int32)), step
        assert tl.dtype == torch.float32
        assert_within(tl, jl, tol.expand(tl.shape), f"logits step {step}")


def test_phi4_smoke_bf16_teacher_forced_matches_jax():
    """bf16 weights and caches, the port fed JAX's tokens.  XLA and PyTorch
    round every bf16 op's output once and accumulate products in f32, but
    at other points (XLA may keep an elementwise chain in f32): measured
    0.2 at logits up to 34, under one bf16 ulp (0.25) there.  Tolerance:
    4 bf16 ulps of the step's largest |logit|."""
    jc, tc = _smoke("bfloat16")
    logits, _, _ = _run_lm(jc, tc, teacher_forced=True)
    for step, (jl, tl) in enumerate(logits):
        assert tl.dtype == torch.bfloat16
        mag = torch.tensor(float(jnp.abs(jl.astype(jnp.float32)).max()))
        assert_within(tl, jl, 4 * float(bf16_ulp(mag)), f"bf16 step {step}")


FAMILY_ARCHS = {"dense": "phi4-mini-3.8b", "moe": "qwen2-moe-a2.7b",
                "ssm": "rwkv6-3b", "hybrid": "zamba2-7b"}


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_serve_structure_matches_jax(family):
    """serve: the JAX package's stats keys, (batch, gen) int32 tokens, and
    the tokens of the step loop on lm_inputs' weights and prompts, with the
    family's KV caches and recurrent states."""
    arch = FAMILY_ARCHS[family]
    cfg = treg.get_smoke(arch)
    assert cfg.family == family
    logs = []
    toks, stats = tserve.serve(cfg, batch=2, prompt_len=8, gen=5, seed=3,
                               device="cpu", log=logs.append)
    _, jstats = jserve.serve(jreg.get_smoke(arch), batch=2,
                             prompt_len=8, gen=5, log=lambda m: None)
    assert set(stats) == set(jstats)
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    assert len(logs) == 1 and "decode 4 steps" in logs[0]
    params, prompts = tserve.lm_inputs(cfg, batch=2, prompt_len=8, seed=3,
                                       device="cpu")
    caches = tt.init_caches(cfg, 2, 13, dtype=torch.float32, device="cpu")
    states = tt.init_states(cfg, 2, device="cpu")
    lg, caches, states = tstep.make_prefill_step(cfg)(params, prompts,
                                                       caches, states)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
    out, dec = [tok], tstep.make_decode_step(cfg)
    for t in range(8, 12):
        tok, _, caches, states = dec(params, tok, caches, states, t)
        out.append(tok)
    assert torch.equal(toks, torch.cat(out, dim=1))
    _, pstats = tserve.serve(cfg, batch=2, prompt_len=8, gen=0,
                             device="cpu", log=logs.append)
    assert pstats["prefill_only"] and pstats["decode_s"] == 0.0


def test_serve_cli_refuses_unported_flags():
    for flag in (["--cnn"], ["--trace", "x.json"]):
        with pytest.raises(SystemExit):
            tserve.main(["--arch", "phi4-mini-3.8b", "--smoke", *flag])


def test_decode_step_samples_with_an_explicit_generator():
    cfg = treg.get_smoke("phi4-mini-3.8b")
    params, prompts = tserve.lm_inputs(cfg, batch=2, prompt_len=4,
                                       device="cpu")
    dec = tstep.make_decode_step(cfg, sample=True, temperature=0.7)
    toks = []
    for _ in range(2):
        caches = tt.init_caches(cfg, 2, 6, dtype=torch.float32, device="cpu")
        tok, _, _, _ = dec(params, prompts[:, :1], caches, None, 0,
                           gen=torch.Generator().manual_seed(5))
        toks.append(tok)
    assert torch.equal(toks[0], toks[1]) and toks[0].shape == (2, 1)
    with pytest.raises(ValueError, match="Generator"):
        dec(params, prompts[:, :1], caches, None, 0)


# ---------------------------------------------------------------------------
# configs, init, devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", treg.list_archs())
def test_config_equals_jax_field_for_field(arch):
    for fn in ("get_config", "get_smoke"):
        j, t = getattr(jreg, fn)(arch), getattr(treg, fn)(arch)
        jf = dataclasses.asdict(j)
        tf = dataclasses.asdict(t)
        assert set(jf) == set(tf), arch
        for name in jf:
            if name == "dtype":
                assert str(tf[name]).split(".")[-1] == \
                    jnp.dtype(jf[name]).name, (arch, name)
            else:
                assert tf[name] == jf[name], (arch, name)
        assert t.hd == j.hd and t.padded_vocab == j.padded_vocab
        assert t.param_count() == j.param_count()


def test_registry_lists_every_jax_arch():
    """The port's registry lists the JAX package's ten archs in its order,
    and every family and frontend runs: nothing raises for want of a
    port."""
    assert treg.list_archs() == jreg.list_archs()
    for arch in treg.list_archs():
        cfg = treg.get_smoke(arch)
        params = tt.init_lm(cfg, torch.Generator(), device="cpu")
        toks = torch.zeros((1, 3), dtype=torch.int64)
        h, _, _, _ = tt.forward(cfg, params, tokens=toks)
        assert h.shape == (1, 3, cfg.d_model)


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_init_lm_keeps_the_jax_tree(family):
    arch = FAMILY_ARCHS[family]
    cfg = dataclasses.replace(treg.get_smoke(arch), dtype=torch.bfloat16)
    jc = dataclasses.replace(jreg.get_smoke(arch), dtype=jnp.bfloat16)
    tp = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp, _ = jt.init_lm(jc, jax.random.PRNGKey(0))
    conv = _port(jp)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    mine = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                   .split(".")[-1]), tp)
    assert mine == shapes
    assert jax.tree.map(lambda a: a.dtype, conv) == \
        jax.tree.map(lambda a: a.dtype, tp)
    # the draw is the generator's: the same seed gives the same weights
    again = tt.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(jax.tree.leaves(jax.tree.map(torch.equal, again, tp)))
    moved = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert jax.tree.map(lambda a: a.dtype, moved) == \
        jax.tree.map(lambda a: a.dtype, tp)
    assert torch.bfloat16 in set(jax.tree.leaves(
        jax.tree.map(lambda a: a.dtype, moved)))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.get_smoke("phi4-mini-3.8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_lm(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_caches(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.init_cache(1, 4, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve(cfg, batch=1, prompt_len=2, gen=2, log=lambda m: None)
    assert tt.init_caches(cfg, 1, 4, device="cpu")["k"].device.type == "cpu"


def test_attention_argument_is_explicit():
    cfg = treg.get_smoke("phi4-mini-3.8b")
    params, prompts = tserve.lm_inputs(cfg, batch=1, prompt_len=4,
                                       device="cpu")
    with pytest.raises(ValueError, match="attention"):
        tt.forward(cfg, params, tokens=prompts, attention="sdpa")
