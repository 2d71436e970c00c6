"""Cross-engine fused phases and the matmul_tm kernels in the port against
the JAX package, on the CPU (the kernels' plain versions).

* Every ``XENGINE_CASES`` case has a torch twin (``TWINS``, beside the
  harness table, which this file imports and does not edit).  On every
  dtype and variant, compiled with ``cross_engine=True``: one fused phase
  with the case's direction and TM links; on the cuda backend ONE
  ``cuda.xchain.*`` record (launches 1, instructions links + 1) equal to
  the JAX package's ``pallas.xchain.*`` record (path, launches,
  instructions, segments); outputs on every backend, and those of the
  non-crossing compilation, against the JAX function: integers bit-exact,
  floats within 2 gamma_K sum |x w| (bf16 one more ulp).
* ``pad_mm`` and ``mm_pad_chain`` are red in the JAX package (ROADMAP
  queue 3): its trace leaves ``jnp.pad`` opaque under the installed JAX,
  so its fused compilation finds no crossing (or a shorter one).  The port
  traces the pad; these cases are held to the harness's expected crossing
  and against the JAX package's split compilation and eager function.
* The partition, discovery, matmul wrappers (against the JAX wrappers in
  interpret mode), the split path, the quarantine, the kernel builds, the
  budget decisions at full size (from shapes alone), and YOLOv3-Tiny and
  ESPCN compiled through both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.compiler import tm_compile as jtm_compile  # noqa: E402
from repro.core import affine as jaf  # noqa: E402
from repro.core import forwarding as jfwd  # noqa: E402
from repro.kernels.matmul_tm import chain as jxc  # noqa: E402
from repro.kernels.matmul_tm import matmul_tm as jmk  # noqa: E402
from repro.kernels.matmul_tm import ops as jmops  # noqa: E402
from repro.kernels.tm_affine import ops as jtops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.compiler import tm_compile  # noqa: E402
from repro_torch.core import affine as taf  # noqa: E402
from repro_torch.core import forwarding as tfwd  # noqa: E402
from repro_torch.core.fp_bounds import bf16_ulp, gamma  # noqa: E402
from repro_torch.kernels.matmul_tm import chain as xc  # noqa: E402
from repro_torch.kernels.matmul_tm import matmul_tm as mk  # noqa: E402
from repro_torch.kernels.matmul_tm import ops as mops  # noqa: E402
from repro_torch.kernels.tm_affine.chain import (CHAIN_VMEM_BUDGET,  # noqa: E402
                                                 ChainSig)
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from tests.harness import XENGINE_CASES  # noqa: E402
from tests.test_torch_support import (assert_same, assert_within,  # noqa: E402
                                      espcn_f64, to_f64, to_torch)


def _pixel_shuffle_twin(H, W, C, s):
    return lambda p, q: ((p @ q).reshape(H, W, C, s, s)
                         .permute(0, 3, 1, 4, 2).reshape(H * s, W * s, C))


# XENGINE_CASES twins (tests/harness.py:526), given the case's variant
TWINS = {
    "mm_transpose": lambda v: (lambda p, q: (p @ q).T),
    "mm_pixelshuffle": lambda v: _pixel_shuffle_twin(*v[:4]),
    "mm_pad_chain": lambda v: (lambda p, q: F.pad((p @ q).T, (2, 2, 1, 1))),
    "transpose_mm": lambda v: (lambda p, q: p.T @ q),
    "pad_mm": lambda v: (lambda p, q: F.pad(p, (1, 1)) @ q),
}
# red in the JAX package (its trace leaves jnp.pad opaque): held against
# the JAX split compilation and the eager function, not its fused output
JAX_PAD_OPAQUE = {"pad_mm", "mm_pad_chain"}

XCASES = [(c, d) for c in XENGINE_CASES for d in c.dtypes]


def _records(reps):
    return [(r.path.replace("pallas.", "cuda.", 1), r.launches, r.instrs,
             r.segments) for rep in reps for r in rep.records]


def _require_close(got, want, twin, targs, dtype, what):
    """Integers bit-exact; floats within 2 gamma_K sum |x w| of the JAX
    result, bf16 one more ulp."""
    if not dtype.startswith("float") and dtype != "bfloat16":
        assert_same(want, got, what=what)
        return
    a, b = (t.to(torch.float64).abs() for t in targs)
    K = targs[1].shape[0]
    mag = twin(a, b)
    w = torch.tensor(to_f64(want))
    tol = 2 * gamma(K) * mag
    if dtype == "bfloat16":
        tol = tol + bf16_ulp(w)
    err = (to_f64(got) - to_f64(want))
    assert np.all(np.abs(err) <= tol.numpy()), (what, float(np.abs(err).max()))


@pytest.mark.parametrize("case,dtype", XCASES,
                         ids=[f"{c.name}-{d}" for c, d in XCASES])
def test_xengine_case_twin(case, dtype):
    for variant in case.variants:
        fn, args = case.build(dtype, variant, np.random.RandomState(977))
        targs = [to_torch(a) for a in args]
        twin = TWINS[case.name](variant)
        want = fn(*args)
        what = (case.name, dtype, variant)
        base = tm_compile(twin, *targs)
        fused = tm_compile(twin, *targs, cross_engine=True)
        part = fused.partition_report
        assert part.xengine_phases == 1, what
        (fp,) = part.fused_phases
        assert fp.xengine.direction == case.direction, what
        assert len(fp.xengine.tm_indices) == case.tm_links, what
        if case.name in JAX_PAD_OPAQUE:
            jbase = jtm_compile(fn, *args)
            jout, _ = jbase.run(*args, backend="reference")
            _require_close(to_torch(jout), want, twin, targs, dtype, what)
        else:
            jfused = jtm_compile(fn, *args, cross_engine=True)
            assert fused.phase_kinds == jfused.partition_report.summary()\
                .split("[")[1].split("]")[0].lower(), what
            (jfp,) = jfused.partition_report.fused_phases
            assert jfp.xengine.direction == fp.xengine.direction
            _, jreps = jfused.run(*args, backend="pallas")
        for backend in ("reference", "fused", "cuda"):
            got, reps = fused.run(*targs, backend=backend)
            _require_close(got, want, twin, targs, dtype, (what, backend))
            recs = _records(reps)
            xrecs = [r for r in recs if r[0].startswith("cuda.xchain")]
            if backend == "cuda":
                assert len(xrecs) == 1, (what, recs)
                assert xrecs[0][1:3] == (1, case.tm_links + 1)
                if case.name not in JAX_PAD_OPAQUE:
                    assert recs == _records(jreps), what
            else:
                assert not xrecs
            got_base, _ = base.run(*targs, backend=backend)
            _require_close(got_base, want, twin, targs, dtype,
                           (what, backend, "base"))


def test_xengine_zero_intermediate_hbm():
    x, w = torch.rand(24, 16), torch.rand(16, 40)
    fused = tm_compile(lambda a, b: (a @ b).T, x, w, cross_engine=True)
    (fp,) = fused.partition_report.fused_phases
    crossing = fp.xengine.buffer
    assert crossing not in fp.reads and crossing not in fp.writes
    for buf in fp.xengine.chain.buffers:
        assert buf not in fp.reads and buf not in fp.writes
    assert fused.partition_report.xengine_saved_bytes > 0


def test_xengine_fewer_launches_than_split():
    """One xchain record replaces the op and the per-instruction TM
    launches (the port's twin of the JAX test that is red there: the
    port's trace sees the pad)."""
    p, q = torch.rand(24, 16), torch.rand(16, 40)
    fn = TWINS["mm_pad_chain"](None)
    _, reps = tm_compile(fn, p, q).run(p, q, backend="cuda")
    split_tm_launches = sum(r.launch_count() for r in reps)
    _, freps = tm_compile(fn, p, q, cross_engine=True).run(p, q,
                                                           backend="cuda")
    fused_launches = sum(r.launch_count() for r in freps)
    assert split_tm_launches >= 2
    assert fused_launches == 1


# ---------------------------------------------------------------------------
# partition and discovery
# ---------------------------------------------------------------------------

def _graph_of(fn, *args):
    return tm_compile(fn, *args).graph


def _phase_fingerprint(part):
    return [(p.kind, tuple(p.node_indices), tuple(p.reads),
             tuple(p.writes), tuple(p.deps)) for p in part.phases]


def test_partition_crossing_is_one_fused_phase():
    from repro_torch.compiler.partition import partition
    g = _graph_of(lambda a, b: (a @ b).T, torch.rand(24, 16),
                  torch.rand(16, 40))
    part = partition(g, cross_engine=True)
    assert [p.kind for p in part.phases] == ["fused"]
    assert part.xengine_phases == 1
    assert part.phase_mix()["fused_phases"] == 1
    assert "F" in part.summary()
    (fp,) = part.fused_phases
    assert len(fp.node_indices) == 2
    assert fp.engine == "tpu"  # fused phases dispatch on the compute stream


def test_partition_non_crossing_byte_identical():
    from repro_torch.compiler.partition import partition
    a, b = torch.rand(8, 6), torch.rand(6, 10)

    def two_consumers(p, q):
        y = p @ q
        return y.T, y + 1.0

    graphs = [_graph_of(lambda t: t.permute(1, 0, 2), torch.rand(5, 7, 3)),
              _graph_of(lambda p, q: p @ q, a, b),
              _graph_of(two_consumers, a, b)]
    for g in graphs:
        off = partition(g)
        on = partition(g, cross_engine=True)
        assert on.xengine_phases == 0
        assert _phase_fingerprint(on) == _phase_fingerprint(off)
        assert on.dag_edges == off.dag_edges
        assert on.summary() == off.summary()


def test_partition_crossing_off_by_default():
    from repro_torch.compiler.partition import partition
    g = _graph_of(lambda a, b: (a @ b).T, torch.rand(24, 16),
                  torch.rand(16, 40))
    part = partition(g)
    assert part.xengine_phases == 0
    assert all(p.kind in ("tpu", "tmu") for p in part.phases)
    c = tm_compile(lambda a, b: (a @ b).T, torch.rand(24, 16),
                   torch.rand(16, 40))
    assert c.phase_kinds == "tm"


def test_cross_engine_chain_discovery():
    from repro_torch.core.fusion import cross_engine_chains
    q = torch.rand(16, 16)
    g = _graph_of(lambda p, q: (p @ q).T @ q, torch.rand(16, 16), q)
    chains = cross_engine_chains(g)
    assert len(chains) == 1
    assert chains[0].direction == "compute_to_tm"


def test_grids_commensurable():
    from repro.core.fusion import grids_commensurable as jgc
    from repro_torch.core.fusion import grids_commensurable
    for a in range(0, 9):
        for b in range(0, 9):
            assert grids_commensurable(a, b) == jgc(a, b)


# ---------------------------------------------------------------------------
# matmul_tm (#13): the wrappers against the JAX wrappers in interpret mode
# ---------------------------------------------------------------------------

def _mm_operands(rng, M, K, N):
    return (rng.randn(M, K).astype(np.float32),
            rng.randn(K, N).astype(np.float32))


@pytest.mark.parametrize("shape", [(192, 64, 64), (200, 128, 96),
                                   (128, 200, 64), (3, 5, 4), (7, 9, 5)])
def test_matmul_call_non_divisible_dims(shape, rng):
    M, K, N = shape
    x, w = _mm_operands(rng, M, K, N)
    got = mops.matmul_call(torch.tensor(x), torch.tensor(w))
    want = jmops.matmul_call(jnp.asarray(x), jnp.asarray(w))
    assert tuple(got.shape) == (M, N)
    tol = 2 * gamma(K) * (np.abs(x).astype(np.float64)
                          @ np.abs(w).astype(np.float64))
    assert np.all(np.abs(to_f64(got) - to_f64(want)) <= tol)


def test_block_div():
    for n in range(1, 300, 7):
        for b in (1, 4, 5, 64, 128):
            assert mk.block_div(n, b) == jmk.block_div(n, b)
    assert mk.block_div(192, 128) == 96


def test_matmul_transpose_and_pixel_shuffle_calls(rng):
    x, w = _mm_operands(rng, 24, 16, 40)
    tol = 2 * gamma(16) * (np.abs(x).astype(np.float64)
                           @ np.abs(w).astype(np.float64))
    got = mops.matmul_transpose_call(torch.tensor(x), torch.tensor(w))
    want = jmops.matmul_transpose_call(jnp.asarray(x), jnp.asarray(w))
    assert np.all(np.abs(to_f64(got) - to_f64(want)) <= tol.T)
    H, W, C, s, K = 4, 6, 5, 2, 16
    x, w = _mm_operands(rng, H * W, K, C * s * s)
    got = mops.matmul_pixel_shuffle_call(torch.tensor(x), torch.tensor(w),
                                         H=H, W=W, C=C, s=s)
    want = jmops.matmul_pixel_shuffle_call(jnp.asarray(x), jnp.asarray(w),
                                           H=H, W=W, C=C, s=s)
    tol = 2 * gamma(K) * (np.abs(x).astype(np.float64)
                          @ np.abs(w).astype(np.float64))
    tol = tol.reshape(H, W, C, s, s).transpose(0, 3, 1, 4, 2).reshape(
        H * s, W * s, C)
    assert np.all(np.abs(to_f64(got) - to_f64(want)) <= tol)


def test_matmul_split_call(rng):
    x, w = _mm_operands(rng, 9, 7, 12)
    got = mops.matmul_split_call(torch.tensor(x), torch.tensor(w),
                                 n_parts=3, part=1)
    full = mops.matmul_call(torch.tensor(x), torch.tensor(w))
    assert torch.equal(got, full[:, 4:8])


@pytest.mark.parametrize("dtype", ["int8", "int32", "bfloat16", "float32"])
def test_matmul_call_integer_wrap_and_bf16(dtype, rng):
    """Integers wrap like the JAX package's eager product (the exact sum
    modulo 2^bits); bf16 within the f32 bound plus one ulp."""
    if dtype.startswith("int"):
        x = rng.randint(-99, 100, size=(7, 9)).astype(dtype)
        w = rng.randint(-99, 100, size=(9, 5)).astype(dtype)
        want = jnp.asarray(x) @ jnp.asarray(w)
        got = mops.matmul_call(torch.tensor(x), torch.tensor(w))
        assert_same(want, got)
        return
    x, w = _mm_operands(rng, 7, 9, 5)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    want = jmops.matmul_call(jx, jw)
    got = mops.matmul_call(to_torch(jx), to_torch(jw))
    tol = 2 * gamma(9) * (np.abs(to_f64(jx)) @ np.abs(to_f64(jw)))
    if dtype == "bfloat16":
        tol = tol + bf16_ulp(torch.tensor(to_f64(want))).numpy()
    assert np.all(np.abs(to_f64(got) - to_f64(want)) <= tol)


def _count_commits(monkeypatch):
    calls = []
    real = xc.xchain_commit_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(xc, "xchain_commit_plain", spy)
    return calls


def test_matmul_tm_call_routes_through_xchain(monkeypatch, rng):
    M, K, N = 24, 16, 20
    x, w = _mm_operands(rng, M, K, N)
    jm = jaf.strided_slice_map((M, N), (0, 0), (2, 1), (12, 20))
    tm = taf.strided_slice_map((M, N), (0, 0), (2, 1), (12, 20))
    calls = _count_commits(monkeypatch)
    got = mops.matmul_tm_call(torch.tensor(x), torch.tensor(w), tm)
    assert calls == [1]
    want = jmops.matmul_tm_call(jnp.asarray(x), jnp.asarray(w), jm)
    two_pass = jtops.tm_affine_call(jmops.matmul_call(jnp.asarray(x),
                                                      jnp.asarray(w)), jm)
    assert got.shape == tm.out_shape
    assert_same(want, two_pass, atol=1e-4)
    tol = 2 * gamma(K) * (np.abs(x).astype(np.float64)
                          @ np.abs(w).astype(np.float64))[::2]
    assert np.all(np.abs(to_f64(got) - to_f64(want)) <= tol)


def test_matmul_tm_call_decline_matches_two_pass(monkeypatch, rng):
    """A dtype-mismatched call declines the registry; the two-pass branch
    computes it (the product in f32, rounded to x's dtype)."""
    M, K, N = 12, 8, 10
    x, w = _mm_operands(rng, M, K, N)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    jm = jaf.strided_slice_map((M, N), (0, 0), (2, 1), (6, 10))
    tm = taf.strided_slice_map((M, N), (0, 0), (2, 1), (6, 10))
    calls = _count_commits(monkeypatch)
    got = mops.matmul_tm_call(torch.tensor(x), to_torch(jw), tm)
    assert calls == []
    want = jmops.matmul_tm_call(jnp.asarray(x), jw, jm)
    tol = 2 * gamma(K) * (np.abs(x).astype(np.float64)
                          @ np.abs(to_f64(jw)))[::2]
    assert np.all(np.abs(to_f64(got) - to_f64(want)) <= tol)


def test_matmul_tm_call_transpose_keeps_bespoke_epilogue(monkeypatch, rng):
    x, w = _mm_operands(rng, 12, 8, 10)

    class _FlatT:
        in_shape = (12, 10)
        out_shape = (10, 12)

        @staticmethod
        def is_pure_permutation():
            return True

        @staticmethod
        def permutation():
            return (1, 0)

    calls = _count_commits(monkeypatch)
    got = mops.matmul_tm_call(torch.tensor(x), torch.tensor(w), _FlatT())
    assert calls == []
    assert torch.equal(got, mops.matmul_transpose_call(torch.tensor(x),
                                                       torch.tensor(w)))
    want = jmops.matmul_tm_call(jnp.asarray(x), jnp.asarray(w), _FlatT())
    assert_same(want, got, atol=1e-4)


def test_forwarding_matmul_tm_both_paths(rng):
    x, w = _mm_operands(rng, 6, 8, 4)
    jm, tm = jaf.transpose_map((2, 3, 4)), taf.transpose_map((2, 3, 4))
    jr = jaf.reshape_map((6, 4), (2, 3, 4))
    tr = taf.reshape_map((6, 4), (2, 3, 4))
    jm2 = jaf.compose_maps(jm, jr)
    tm2 = taf.compose_maps(tm, tr)
    want = jfwd.matmul_tm(jnp.asarray(x), jnp.asarray(w), jm2)
    for use_kernel in (False, True):
        got = tfwd.matmul_tm(torch.tensor(x), torch.tensor(w), tm2,
                             use_kernel=use_kernel)
        assert_same(want, got, atol=1e-5)
    y = tfwd.forward_through(lambda a, b: a @ b, tm2, torch.tensor(x),
                             torch.tensor(w))
    assert_same(want, y, atol=1e-5)


# ---------------------------------------------------------------------------
# execution: the split path, the quarantine, the kernel builds
# ---------------------------------------------------------------------------

def test_fused_phase_split_path_on_reference_and_fused():
    x, w = torch.randn(24, 16), torch.randn(16, 40)
    fn = lambda a, b: (a @ b).T  # noqa: E731
    fused = tm_compile(fn, x, w, cross_engine=True)
    for backend in ("reference", "fused"):
        got, reps = fused.run(x, w, backend=backend)
        assert torch.equal(got, fn(x, w))
        recs = [r for rep in reps for r in rep.records]
        assert recs[0].path == "torch.mm" and backend in recs[0].reason
        assert not any(r.path.startswith("cuda.xchain") for r in recs)


def test_fused_phase_quarantine_falls_back_split():
    from repro_torch.core.dispatch import quarantine_key
    x, w = torch.randn(24, 16), torch.randn(16, 40)
    fn = lambda a, b: (a @ b).T  # noqa: E731
    fused = tm_compile(fn, x, w, cross_engine=True)
    q = {quarantine_key("matmul_tm.xchain", "xchain.compute_to_tm", [x, w])}
    before = set(q)
    got, reps = fused.run(x, w, backend="cuda", quarantine=q)
    assert torch.equal(got, fn(x, w))
    recs = [r for rep in reps for r in rep.records]
    assert not any(r.path.startswith("cuda.xchain") for r in recs)
    assert q == before


def _slice4_calls():
    g = xc.Gemm("mm", (4, 6), (6, 3))
    sig = ChainSig(links=((taf.axis_permutation_map((4, 3), (1, 0)), None),))
    psig = ChainSig(links=((taf.axis_permutation_map((6, 4), (1, 0)),
                            None),))
    return {
        "matmul_tm": lambda x, w: mk.matmul_tm(x, w),
        "xchain_commit": lambda x, w: xc.xchain_commit(sig, g, x, w),
        "xchain_prologue": lambda x, w: xc.xchain_prologue(
            psig, g, 0, x.T.contiguous(), w),
    }


def _slice4_counts():
    return (mk.matmul_tm.launches, xc.xchain_commit.launches,
            xc.xchain_prologue.launches)


@pytest.mark.parametrize("kernel", ["matmul_tm", "xchain_commit",
                                    "xchain_prologue"])
def test_slice4_wrapper_raises_when_kernel_build_fails(monkeypatch, kernel):
    """A non-CPU tensor goes to the kernel: when the library cannot be
    built the wrapper raises — it never returns the plain version."""
    from repro_torch.kernels import build

    def fail(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(build, "library", fail)
    call = _slice4_calls()[kernel]
    x, w = torch.rand(4, 6), torch.rand(6, 3)
    assert call(x, w) is not None  # CPU tensors: the plain version runs
    before = _slice4_counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call(x.to("meta"), w.to("meta"))
    assert _slice4_counts() == before
    # with a library at hand, a tensor that is not on the card is refused
    monkeypatch.setattr(build, "library", lambda name: object())
    with pytest.raises(ValueError, match="CUDA"):
        call(x.to("meta"), w.to("meta"))
    assert _slice4_counts() == before


# ---------------------------------------------------------------------------
# the budget decisions at the main path's full size, from shapes alone
# ---------------------------------------------------------------------------

def _meta(shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _budgets():
    """(port bytes, JAX bytes) of the three crossings of the slice's path:
    ESPCN x3 at 640x360 (conv3 -> PixelShuffle), YOLOv3-Tiny 448x448 batch
    8 (Rearrange -> conv1; Upsample + Route -> head2)."""
    from repro.kernels.tm_affine.chain import ChainSig as JSig

    def both(tlinks, jlinks, eqn_srcs, slabs, staged, route=None):
        tsig = ChainSig(links=tlinks, route_maps=route and route[0],
                        dtype="float32")
        jsig = JSig(links=jlinks, route_maps=route and route[1],
                    dtype="float32")
        tb = xc.budget_bytes(tsig, [_meta(s) for s in eqn_srcs],
                             [_meta(s) for s in slabs], staged, 4)
        jb = jxc._budget_bytes(
            jsig, [jax.ShapeDtypeStruct(s, jnp.float32) for s in eqn_srcs],
            [jax.ShapeDtypeStruct(s, jnp.float32) for s in slabs], staged, 4)
        return tb, jb

    ps = [(m.batch_extend_map(m.pixel_shuffle_map((360, 640, 27), 3), (1,)),
           None) for m in (taf, jaf)]
    espcn = both((ps[0],), (ps[1],), [(1, 360, 640, 32), (3, 3, 32, 27)],
                 [], 360 * 640 * 27)
    rr = [(m.batch_extend_map(m.rearrange_map((448, 448, 3), 1, 16), (8,)),
           None) for m in (taf, jaf)]
    rearrange = both((rr[0],), (rr[1],), [(8, 448, 448, 3), (3, 3, 16, 16)],
                     [], 8 * 448 * 448 * 16)
    up = [(m.batch_extend_map(m.upsample_map((14, 14, 128), 2), (8,)), None)
          for m in (taf, jaf)]
    routes = [tuple(m.batch_extend_map(b, (8,)) for b in
                    m.route_maps([(28, 28, 128), (28, 28, 128)]))
              for m in (taf, jaf)]
    neck = both((up[0],), (up[1],), [(8, 14, 14, 128), (1, 1, 256, 255)],
                [(8, 28, 28, 128)], 8 * 28 * 28 * 256, route=routes)
    return {"espcn": espcn, "rearrange": rearrange, "neck": neck}


def test_budget_decisions_match_the_jax_package_at_full_size():
    budgets = _budgets()
    for name, (tb, jb) in budgets.items():
        assert tb == jb, name
    mb = {k: round(v[0] / 1e6, 1) for k, v in budgets.items()}
    assert mb == {"espcn": 104.2, "rearrange": 327.6, "neck": 23.5}
    assert budgets["espcn"][0] <= CHAIN_VMEM_BUDGET
    assert budgets["rearrange"][0] > CHAIN_VMEM_BUDGET
    assert budgets["neck"][0] <= CHAIN_VMEM_BUDGET
    assert CHAIN_VMEM_BUDGET == jxc.CHAIN_VMEM_BUDGET


def test_declined_crossing_runs_split_with_its_reason(monkeypatch):
    """A crossing over the budget takes the split path, and the op's record
    says why (its bytes against the budget)."""
    x, w = torch.rand(24, 16), torch.rand(16, 40)
    fn = lambda a, b: (a @ b).T  # noqa: E731
    fused = tm_compile(fn, x, w, cross_engine=True)
    monkeypatch.setattr(xc, "CHAIN_VMEM_BUDGET", 1000)
    got, reps = fused.run(x, w, backend="cuda")
    recs = [r for rep in reps for r in rep.records]
    assert [r.path for r in recs] == ["torch.mm", "cuda.block"]
    assert "split path" in recs[0].reason and "MB over the" in recs[0].reason
    assert torch.equal(got, fn(x, w))


# ---------------------------------------------------------------------------
# the models, compiled through both packages
# ---------------------------------------------------------------------------

def _paths(reps, prefix=None):
    out = [r.path for rep in reps for r in rep.records]
    return [p.replace(prefix, "cuda.", 1) for p in out] if prefix else out


def test_yolov3_tiny_compiles_ftf_in_both_packages():
    jp = jcnn.init_yolov3_tiny(jax.random.PRNGKey(0))
    model = tcnn.YOLOv3Tiny(params_from_numpy(jax.tree.map(np.asarray, jp)))
    img = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    jfn = lambda a: jcnn.yolov3_tiny(jp, a)  # noqa: E731
    jc = jtm_compile(jfn, jnp.asarray(img), cross_engine=True)
    tc = tm_compile(model, torch.tensor(img), cross_engine=True)
    assert tc.phase_kinds == "ftf"
    assert [p.xengine.direction for p in tc.partition_report.fused_phases] \
        == ["tm_to_compute", "tm_to_compute"]
    assert len(tc.graph.tm_nodes()) == len(jc.graph.tm_nodes())
    jout, jreps = jc.run(jnp.asarray(img), backend="pallas",
                         fuse_chains=True)
    with torch.no_grad():
        tout, treps = tc.run(torch.tensor(img), backend="cuda",
                             fuse_chains=True)
        eager = model(torch.tensor(img))
    assert _paths(treps) == _paths(jreps, "pallas.") == [
        "cuda.xchain.prologue", "cuda.xchain.prologue"]
    for j, t, e in zip(jout, tout, eager):
        assert_same(j, t, atol=1e-5)
        assert_same(e, t, atol=1e-5)


def test_espcn_compiles_tf_in_both_packages():
    jp = jcnn.init_espcn(jax.random.PRNGKey(2), s=3)
    model = tcnn.ESPCN(params_from_numpy(jax.tree.map(np.asarray, jp)))
    x = np.random.RandomState(6).rand(1, 9, 12, 3).astype(np.float32)
    jc = jtm_compile(lambda a: jcnn.espcn(jp, a), jnp.asarray(x),
                     cross_engine=True)
    tc = tm_compile(model, torch.tensor(x), cross_engine=True)
    assert tc.phase_kinds == "tf"
    jout, jreps = jc.run(jnp.asarray(x), backend="pallas")
    tout, treps = tc.run(torch.tensor(x), backend="cuda")
    assert _paths(treps) == _paths(jreps, "pallas.") == [
        "cuda.xchain.commit"]
    ref, bound = espcn_f64(jax.tree.map(np.asarray, jp), x)
    assert_within(tout, ref, bound, what="port ESPCN compiled")
    assert_within(jout, ref, bound, what="JAX ESPCN compiled")


@pytest.mark.parametrize("dtype", ["int8", "int32"])
@pytest.mark.parametrize("stride,pad", [(1, "SAME"), (2, "SAME"),
                                        (2, "VALID")])
def test_conv_plain_integers_wrap_like_jax(dtype, stride, pad, rng):
    """The xchain kernels' plain conv for integers (the patch matrix's
    exact product, wrapped) equals the JAX package's integer conv."""
    x = rng.randint(-99, 100, size=(2, 7, 6, 3)).astype(dtype)
    w = rng.randint(-99, 100, size=(3, 3, 3, 5)).astype(dtype)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    g = xc.Gemm("conv", x.shape, w.shape, stride, pad)
    got = xc.op_plain(g, torch.tensor(x), torch.tensor(w))
    assert tuple(got.shape) == g.out_shape
    assert_same(want, got)
