"""The port's decode matchers and exact mode against the JAX package's, on
the CPU: the twins of ``tests/test_compiler.py``'s dynamic-slice,
update-slice, gather, reduce-window, phase-defrag, phase-mix and exact-mode
tests.

aten's forms of the JAX cases:

* ``lax.dynamic_slice`` at constant starts is aten ``slice`` (one per
  axis, composed into one map); lax's start clamp is the port's
  ``band_start``, held against lax's here;
* ``lax.dynamic_update_slice`` (the KV append) is ``slice_scatter`` — or
  the constant-band ``scatter`` ``torch.func.vmap`` makes of it — matched
  as an overlay Route over (operand, update);
* ``jnp.take`` is ``index_select`` / ``index``;
* ``lax.reduce_window`` with window 1 is ``max_pool2d`` of kernel 1;
* a traced start reaches the front end as a traced index vector: a
  ``narrow`` at a traced start is refused by ``make_fx`` itself (its start
  is read on the host), so the port's traced forms are ``index_select``
  with traced indices and ``scatter`` with a traced index.

Data movement is held bit for bit against the JAX package's result on the
same numpy inputs, on every backend.  The decode step's TM instruction
count and phase kinds are held against the JAX compile of the same step,
each difference named with its cause.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.compiler import tm_compile as jtm_compile  # noqa: E402
from repro.compiler.trace import graph_from_jaxpr  # noqa: E402
from repro.configs.phi4_mini_3p8b import smoke_config as jsmoke  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro.serving.decode import make_layer_step as jmake_step  # noqa: E402
from repro_torch.compiler import tm_compile  # noqa: E402
from repro_torch.compiler.trace import (_GATHER_MAX_BANDS,  # noqa: E402
                                        graph_from_fx)
from repro_torch.configs.phi4_mini_3p8b import smoke_config  # noqa: E402
from repro_torch.core.executor import BACKENDS  # noqa: E402
from repro_torch.core.instr import TMOpcode  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.attention import band_start  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime.streams import StreamRuntime  # noqa: E402
from repro_torch.serving.decode import make_layer_step  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(7)


def _rand(rng, *shape):
    a = rng.rand(*shape).astype(np.float32)
    return a, to_torch(a)


def _all_backends(c, args, want):
    for backend in BACKENDS:
        assert_same(c(*args, backend=backend), want, what=backend)


def _tm_nodes(c):
    return [n for n in c.graph.nodes if n.kind == "tmu"]


def _notes(c):
    return [a.detail for a in c.pass_report.actions
            if a.pass_name == "trace-fallback"]


# ---------------------------------------------------------------------------
# constant-start windows (lax.dynamic_slice's aten form: slice)
# ---------------------------------------------------------------------------

def test_dynamic_slice_constant_starts_matches(rng):
    xn, x = _rand(rng, 5, 7, 3)
    c = tm_compile(lambda a: a[1:3, 2:5], x)
    assert "slice" in c.matched_prims
    (node,) = _tm_nodes(c)                # the two slices compose into one
    assert node.instr.opcode == TMOpcode.COARSE
    assert len(node.instr.srcs) == 1
    _all_backends(c, (x,), np.asarray(jax.lax.dynamic_slice(
        jnp.asarray(xn), (1, 2, 0), (2, 3, 3))))


def test_slice_clamps_out_of_range_bounds(rng):
    # aten's slice clamps start and end into the axis (a negative start
    # wraps once), as numpy-style jnp indexing does; the map must agree
    xn, x = _rand(rng, 5, 7, 3)
    fn = lambda a: a[-9:2, 3:99, -2:]  # noqa: E731
    c = tm_compile(fn, x)
    assert "slice" in c.matched_prims
    assert_same(c(x), fn(x))
    assert_same(c(x), np.asarray(jnp.asarray(xn)[-9:2, 3:99, -2:]))


def test_dynamic_slice_traced_start_stays_opaque(rng):
    xn, x = _rand(rng, 10, 3)
    fn = lambda a, i: torch.index_select(a, 0, i)  # noqa: E731
    idx = torch.tensor([2, 3])
    c = tm_compile(fn, x, idx)
    assert "index_select" not in c.matched_prims  # runtime start: compute
    assert_same(c(x, idx), np.asarray(jax.lax.dynamic_slice(
        jnp.asarray(xn), (2, 0), (2, 3))))


def test_dynamic_slice_traced_start_leaves_pass_report_note(rng):
    # the fallback explains itself: the trace note rides the pass report
    # (and never raises mid-trace), and execution stays bit-exact on the
    # stream-dispatched path too
    xn, x = _rand(rng, 10, 3)
    fn = lambda a, i: torch.index_select(a, 0, i) * 2.0  # noqa: E731
    idx = torch.tensor([4, 5])
    c = tm_compile(fn, x, idx)
    assert c.pass_report.trace_fallbacks == 1
    (note,) = _notes(c)
    assert "index_select" in note and "traced index vector" in note
    assert "trace-fallback" in c.pass_report.summary()
    assert c.graph.notes == [note]
    with StreamRuntime(device="cpu") as rt:
        got, _ = c.run(x, idx, runtime=rt)
    assert_same(got, np.asarray(jax.lax.dynamic_slice(
        jnp.asarray(xn), (4, 0), (2, 3))) * 2.0)


def test_traced_window_start_stays_one_opaque_node(rng):
    """The twin of the JAX package's pjit-inlining test.  aten has no
    pjit: its graph is flat, and a ``narrow`` at a traced start never
    reaches the front end (``make_fx`` refuses its host read of the
    start).  The form that does — a traced index vector after a product —
    stays one opaque node beside the product: no explosion, no match."""
    _, x = _rand(rng, 6, 6)
    with pytest.raises(RuntimeError, match="data-dependent|value out"):
        make_fx(lambda a, i: a.narrow(0, i, 2))(x, torch.tensor(1))
    fn = lambda a, i: torch.index_select(a @ a, 0, i)  # noqa: E731
    idx = torch.tensor([1, 2])
    c = tm_compile(fn, x, idx)
    assert not c.matched_prims
    assert [n.kind for n in c.graph.nodes] == ["tpu", "tpu"]
    assert_same(c(x, idx), fn(x, idx))


@pytest.mark.parametrize("starts", [(-2, -1, 0), (9, 12, 1), (-3, 6, 2)])
def test_dynamic_slice_clamp_differential_vs_lax(rng, starts):
    # the port's clamp (band_start: wrap a negative start once, then clamp
    # into [0, dim - size]) must agree with lax.dynamic_slice's own clamp
    # for negative AND past-the-end constant starts, on all three
    # backends — a divergence here silently corrupts every bucketed decode
    xn, x = _rand(rng, 5, 7, 3)
    sizes = (2, 3, 1)
    lo = [band_start(st, d, sz) for st, d, sz in zip(starts, x.shape, sizes)]
    c = tm_compile(lambda a: a[lo[0]:lo[0] + 2, lo[1]:lo[1] + 3,
                               lo[2]:lo[2] + 1], x)
    assert "slice" in c.matched_prims
    ref = np.asarray(jax.lax.dynamic_slice(jnp.asarray(xn), starts, sizes))
    _all_backends(c, (x,), ref)


# ---------------------------------------------------------------------------
# the KV append (lax.dynamic_update_slice's aten form: slice_scatter)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 5, 13])
@pytest.mark.parametrize("vmapped", [False, True])
def test_update_slice_kv_append_round_trip(rng, pos, vmapped):
    """Constant-position KV append: matched as an overlay Route over
    (operand, update), bit-exact against lax.dynamic_update_slice on all
    three backends.  Under ``torch.func.vmap`` the append reaches the
    trace as a ``scatter`` with a constant band index: matched the same."""
    cn, cache = _rand(rng, 2, 16, 2, 4)
    un, upd = _rand(rng, 2, 3, 2, 4)

    def fn(c_, u):
        return torch.slice_scatter(c_, u, dim=1, start=pos, end=pos + 3)

    args = (cache, upd)
    if vmapped:
        fn, args = torch.func.vmap(fn), (cache[None], upd[None])
    c = tm_compile(fn, *args)
    assert "slice_scatter" in c.matched_prims
    (node,) = _tm_nodes(c)
    assert node.instr.opcode == TMOpcode.COARSE
    assert node.instr.meta == {"overlay": True}
    assert len(node.instr.srcs) == 2  # operand + update; starts in the maps
    ref = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(cn), jnp.asarray(un), (0, pos, 0, 0)))
    _all_backends(c, args, ref[None] if vmapped else ref)


def test_update_slice_clamps_past_the_end_start(rng):
    # lax clamps start 14 -> 13 (=16-3); band_start gives the same window
    cn, cache = _rand(rng, 1, 16, 4)
    un, upd = _rand(rng, 1, 3, 4)
    st = band_start(14, 16, 3)
    c = tm_compile(lambda c_, u: torch.slice_scatter(c_, u, 1, st, st + 3),
                   cache, upd)
    assert "slice_scatter" in c.matched_prims
    assert_same(c(cache, upd), np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(cn), jnp.asarray(un), (0, 14, 0))))


def test_update_slice_traced_start_degrades_with_note(rng):
    """A runtime start degrades to an opaque compute node with a
    trace-fallback note — never an exception."""
    cn, cache = _rand(rng, 1, 16, 4)
    un, upd = _rand(rng, 1, 3, 4)

    def fn(c_, u, idx):
        return torch.scatter(c_, 1, idx, u) * 2.0

    idx = (5 + torch.arange(3)).view(1, 3, 1).expand(1, 3, 4).contiguous()
    c = tm_compile(fn, cache, upd, idx)
    assert "slice_scatter" not in c.matched_prims
    assert c.pass_report.trace_fallbacks == 1
    (note,) = _notes(c)
    assert "scatter" in note and "non-constant start" in note
    assert "bucket the position" in note
    assert_same(c(cache, upd, idx), np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(cn), jnp.asarray(un), (0, 5, 0))) * 2.0)


def test_scatter_that_is_not_one_band_stays_opaque(rng):
    # a constant index that is not one contiguous band along dim (here
    # reversed) is a genuine scatter: compute, and no note
    _, cache = _rand(rng, 1, 16, 4)
    _, upd = _rand(rng, 1, 3, 4)
    idx = torch.tensor([7, 6, 5]).view(1, 3, 1).expand(1, 3, 4)
    fn = lambda c_, u: torch.scatter(c_, 1, idx, u)  # noqa: E731
    c = tm_compile(fn, cache, upd)
    assert not c.matched_prims and not c.graph.notes
    assert_same(c(cache, upd), fn(cache, upd))


# ---------------------------------------------------------------------------
# constant-index gathers (jnp.take's aten forms: index / index_select)
# ---------------------------------------------------------------------------

def test_gather_arithmetic_progression_matches_single_map(rng):
    xn, x = _rand(rng, 10, 6)
    idx = np.asarray([1, 3, 5, 7])
    c = tm_compile(lambda a: a[torch.tensor(idx)], x)
    assert "index" in c.matched_prims
    (node,) = _tm_nodes(c)
    assert node.instr.maps is None  # one strided map, not a band Route
    _all_backends(c, (x,), np.asarray(jnp.take(jnp.asarray(xn),
                                               jnp.asarray(idx), axis=0)))


def test_gather_irregular_indices_match_band_route(rng):
    xn, x = _rand(rng, 10, 6)
    idx = np.asarray([3, 0, 7, 7, 2])  # irregular, with a repeat
    c = tm_compile(lambda a: a[torch.tensor(idx)], x)
    assert "index" in c.matched_prims
    (node,) = _tm_nodes(c)
    assert node.instr.maps is not None and len(node.instr.maps) == 5
    _all_backends(c, (x,), np.asarray(jnp.take(jnp.asarray(xn),
                                               jnp.asarray(idx), axis=0)))


def test_gather_inner_axis_matches(rng):
    xn, x = _rand(rng, 4, 9, 3)
    idx = np.asarray([8, 1, 4])
    c = tm_compile(lambda a: torch.index_select(a, 1, torch.tensor(idx)), x)
    assert "index_select" in c.matched_prims
    _all_backends(c, (x,), np.asarray(jnp.take(jnp.asarray(xn),
                                               jnp.asarray(idx), axis=1)))


def test_gather_traced_indices_degrade_with_note(rng):
    xn, x = _rand(rng, 10, 6)
    idx = np.asarray([3, 0, 7])
    fn = lambda a, i: a[i] * 2.0  # noqa: E731
    c = tm_compile(fn, x, torch.tensor(idx))
    assert "index" not in c.matched_prims
    assert any("traced index vector" in n for n in _notes(c)), _notes(c)
    assert_same(c(x, torch.tensor(idx)), np.asarray(
        jnp.take(jnp.asarray(xn), jnp.asarray(idx), axis=0) * 2.0))


def test_gather_too_many_irregular_indices_degrades(rng):
    """Past the band budget the gather stays opaque with the port's note,
    and the result equals eager.  Not held against the JAX package: its
    twin is red there (ROADMAP queue 3) — under the installed JAX,
    ``jnp.take`` traces as a ``jit`` sub-jaxpr its front end does not
    inline, so the JAX matcher never sees the gather and leaves no note."""
    n = _GATHER_MAX_BANDS + 1
    _, x = _rand(rng, 200, 3)
    vals = rng.randint(0, 200, size=n)
    vals[1] = vals[0] + 7  # break any accidental arithmetic progression
    vals[2] = vals[0]
    idx = torch.tensor(vals)
    fn = lambda a: a[idx]  # noqa: E731
    c = tm_compile(fn, x)
    assert "index" not in c.matched_prims
    assert any("band Route budget" in m for m in _notes(c)), _notes(c)
    assert_same(c(x), fn(x))


# ---------------------------------------------------------------------------
# window-1 pooling: strided layouts match, real pooling stays opaque
# ---------------------------------------------------------------------------

def test_reduce_window_degenerate_stride_matches(rng):
    xn, x = _rand(rng, 4, 8, 6)
    c = tm_compile(lambda a: F.max_pool2d(a, 1, stride=(2, 3)), x)
    assert "max_pool2d_with_indices" in c.matched_prims
    ref = np.asarray(jax.lax.reduce_window(
        jnp.asarray(xn), -jnp.inf, jax.lax.max, (1, 1, 1), (1, 2, 3),
        "VALID"))
    _all_backends(c, (x,), ref)
    c = tm_compile(lambda a: F.avg_pool2d(a, 1, stride=2), x)
    assert "avg_pool2d" in c.matched_prims
    _all_backends(c, (x,), xn[:, ::2, ::2])


def test_reduce_window_real_pooling_stays_opaque(rng):
    xn, x = _rand(rng, 1, 8, 8, 2)          # NHWC, as the JAX test
    fn = lambda a: F.max_pool2d(a.permute(0, 3, 1, 2), 2,  # noqa: E731
                                stride=2).permute(0, 2, 3, 1)
    c = tm_compile(fn, x)
    assert "max_pool2d_with_indices" not in c.matched_prims
    # genuine reductions are compute: no fallback noise either
    assert c.pass_report.trace_fallbacks == 0
    assert_same(c(x), np.asarray(jax.lax.reduce_window(
        jnp.asarray(xn), -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1),
        "VALID")))


# ---------------------------------------------------------------------------
# phase defragmentation and the phase mix
# ---------------------------------------------------------------------------

def test_phase_defrag_moves_singleton_past_independent_tpu(rng):
    """A singleton TM node wedged between compute nodes that neither read
    its output nor feed it migrates to join the nearest TM run."""
    an, a = _rand(rng, 6, 6)
    bn, b = _rand(rng, 4, 4)

    def fn(a, b):
        t = (a @ a).T          # TM singleton wedged after the product
        r = torch.tanh(b).T    # independent chain: compute then TM
        return t, r

    c = tm_compile(fn, a, b)
    jc = jtm_compile(lambda a, b: ((a @ a).T, jnp.tanh(b).T),
                     jnp.asarray(an), jnp.asarray(bn))
    assert c.pass_report.phases_defragmented >= 1, c.pass_report.summary()
    mix = c.partition_report.phase_mix()
    assert mix["tmu_singletons"] == 0, mix
    assert mix["tmu_phases"] == 1, mix
    assert mix["kinds"] == jc.partition_report.phase_mix()["kinds"]
    for g, w in zip(c(a, b), fn(a, b)):
        assert_same(g, w)


def test_phase_defrag_respects_data_dependence(rng):
    # the intervening compute node READS the singleton's output: no move
    _, a = _rand(rng, 6, 6)

    def fn(a):
        h = a @ a
        t = h.T                # singleton
        u = torch.tanh(t)      # reads t: blocks the forward move
        return u[:2]           # TM (slice) after the blocker

    c = tm_compile(fn, a)
    # order must stay valid whether or not any move was found
    assert_same(c(a), fn(a))
    kinds = [n.kind for n in c.graph.nodes]
    assert kinds.index("tmu") > 0  # the transpose still after the product


def test_phase_mix_reports_fragmentation(rng):
    _, x = _rand(rng, 2, 16, 16, 8)
    _, skip = _rand(rng, 2, 32, 32, 2)
    c = tm_compile(lambda a, b: tcnn.superres_tail(a, b, s=2), x, skip)
    mix = c.partition_report.phase_mix()
    assert mix["phases"] == mix["tpu_phases"] + mix["tmu_phases"]
    assert len(mix["kinds"]) == mix["phases"]
    assert mix["tmu_instrs"] >= mix["tmu_phases"]


# ---------------------------------------------------------------------------
# exact mode: compute matches eager bit for bit
# ---------------------------------------------------------------------------

def test_exact_mode_matches_eager_through_mean_rsqrt_chain(rng):
    """The JAX package's decode-path divergence, pinned in the port: the
    ``rsqrt(mean(x*x) + eps)`` chain with its broadcast multiplies.  The
    port's compute phases dispatch op by op, as eager does, so exact mode
    and the default mode both reproduce eager bit for bit; the broadcast
    operands the walk lowers (a folded constant ``g``, a one-element
    ``expand``) change no rounding."""
    gn, g = _rand(rng, 48)
    xn = rng.randn(2, 8, 48).astype(np.float32)
    x = to_torch(xn)

    def fn(x):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + 1e-6) * g

    c = tm_compile(fn, x)
    assert {"mul", "expand"} <= c.matched_prims
    ref = fn(x)
    for backend in BACKENDS:
        assert_same(c(x, backend=backend, exact=True), ref)
        assert_same(c(x, backend=backend), ref)
    jref = (jnp.asarray(xn) * jax.lax.rsqrt(jnp.mean(
        jnp.asarray(xn) ** 2, axis=-1, keepdims=True) + 1e-6)
        * jnp.asarray(gn))
    assert_same(c(x, exact=True), np.asarray(jref), atol=1e-5)


def test_exact_mode_takes_the_split_path_of_a_fused_phase(rng):
    """A fused cross-engine phase runs its op as the library call under
    exact mode (the split path), bit-exact against eager, on the cuda
    backend too."""
    p = tcnn.init_espcn(torch.Generator().manual_seed(0), s=2, device="cpu")
    _, img = _rand(rng, 1, 12, 12, 3)
    c = tm_compile(p, img, cross_engine=True)
    assert "f" in c.phase_kinds
    got, reps = c.run(img, backend="cuda", exact=True)
    paths = [r.path for rep in reps for r in rep.records]
    reasons = [r.reason for rep in reps for r in rep.records if r.reason]
    assert not any(pth.startswith("cuda.xchain") for pth in paths), paths
    assert any("exact mode" in r for r in reasons), reasons
    assert_same(got, c(img, backend="reference"))


# ---------------------------------------------------------------------------
# the decode step against the JAX compile of the same step
# ---------------------------------------------------------------------------

# aten op -> the lax primitive it stands for in the TM instruction counts
_ATEN_TO_LAX = {"cat": "concatenate", "slice_scatter": "dynamic_update_slice",
                "permute": "transpose", "view": "reshape",
                "_unsafe_view": "reshape", "unsqueeze": "reshape",
                "expand": "broadcast_in_dim"}


def _matched_counts(graph, rename=None):
    return Counter((rename or {}).get(n.matched, n.matched)
                   for n in graph.nodes if n.kind == "tmu")


def test_decode_step_tm_count_and_phase_kinds_against_jax():
    """Phi4-mini smoke decode step at position 8, same weights, traced by
    both front ends.  Per category of TM instruction (before the passes)
    the counts agree except where named:

    * reshape: port 30 (view, _unsafe_view, unsqueeze), JAX 6 — aten
      decomposes ``x @ W`` of a 3-D x into view + mm + _unsafe_view (two
      reshapes per product, five products) and the attention's einsums
      into unsqueeze/permute/view around bmm; ``dot_general`` takes the
      batch axes as they are;
    * transpose: port 11, JAX 2 — the same einsum decomposition;
    * split: port 6, JAX 0 — ``torch.chunk`` (RoPE's two halves of q and
      k, the MLP's gate/up) is aten ``split``, matched as one slice map per
      output; the JAX front end leaves lax's ``split`` opaque;
    * mul: port 18, JAX 11 — lax's ``mul`` now broadcasts size-1 axes
      itself and the JAX front end leaves such a mixed-shape mul opaque
      (rmsnorm's ``x * rsqrt(var)`` three times, q's RoPE four times);
      the port lowers the broadcast operand and matches the mul;
    * broadcast_in_dim: port 0, JAX 2 — ``jax.nn.softmax`` broadcasts its
      max and sum (matched); ``torch.softmax`` is one aten call.

    add, sub, slice, concatenate and the KV append agree.  After the
    passes the port has 51 TM instructions in 13 TM phases, the JAX
    package 29 in 14: aten's extra reshapes and transposes compose away
    (25 compositions against 5).  Both alternate compute and TM phases
    from the embedding lookup (compute: traced token ids); the JAX
    program ends on the unembedding's ``dot_general``, the port's on the
    ``_unsafe_view`` back to (B, S, V) after its ``mm``."""
    jcfg, cfg = jsmoke(), smoke_config()
    jp = jinit_lm(jcfg, jax.random.PRNGKey(0))[0]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jstep, tstep = (jmake_step(jcfg, jp, position=8),
                    make_layer_step(cfg, tp, position=8))
    tok = np.full((1, 1), 3, np.int32)
    ck = np.zeros((1, 32, cfg.n_kv_heads, cfg.hd), np.float32)
    jargs = tuple(jnp.asarray(a) for a in (tok, ck, ck))
    targs = tuple(to_torch(a) for a in (tok, ck, ck))

    jg = graph_from_jaxpr(jax.make_jaxpr(jstep)(*jargs))
    with torch.no_grad():
        tg = graph_from_fx(make_fx(tstep)(*targs))
    jcount = _matched_counts(jg)
    tcount = _matched_counts(tg, _ATEN_TO_LAX)
    named = {"reshape": (30, 6), "transpose": (11, 2), "split": (6, 0),
             "mul": (18, 11), "broadcast_in_dim": (0, 2)}
    for cat in set(jcount) | set(tcount):
        want = named.get(cat, (jcount[cat], jcount[cat]))
        assert (tcount[cat], jcount[cat]) == want, (cat, tcount, jcount)
    for cat in ("add", "sub", "slice", "concatenate",
                "dynamic_update_slice"):
        assert tcount[cat] == jcount[cat] > 0, cat

    c, jc = tm_compile(tstep, *targs), jtm_compile(jstep, *jargs)
    mix, jmix = (c.partition_report.phase_mix(),
                 jc.partition_report.phase_mix())
    assert (mix["tmu_instrs"], jmix["tmu_instrs"]) == (51, 29)
    assert (c.pass_report.compositions, jc.pass_report.compositions) == \
        (25, 5)
    assert mix["kinds"] == "TM" * 13 and jmix["kinds"] == "TM" * 14 + "T"
    assert c.phase_kinds == mix["kinds"].lower()
