"""The chain megakernel's run plan, held on the CPU without a card.

``build_run_plan`` factors the chain plan's full-size pullback over runs of
``R`` consecutive output elements: every index as ``base[o] + off[p]``,
every mask as ``outer[o] & run[p]``.  Here a numpy model of the kernel's
arithmetic (``csrc/tm_chain.cu``: the run of each access by the magic-number
division, the access's first position, ``base[o] + off[p0] + lane`` for
the lanes of a 16-byte access, the masks at ``p0``) rebuilds the full
arrays from the tables, and they are held, wherever the kernel reads them,
against the port's ``build_chain_plan`` and the JAX package's own chain
plan for the same signature (its maps through ``MixedRadixMap.encode()``
JSON).  A torch model of the kernel's walk (the source read only where no
level masks the element, the walk started at the last level that does)
is held bit for bit against ``chain_plain`` in every dtype.

The kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import affine as jaf  # noqa: E402
from repro.kernels.tm_affine import chain as jch  # noqa: E402
from repro.kernels.tm_affine import ops as jtops  # noqa: E402
from repro_torch.core import affine as af  # noqa: E402
from repro_torch.core.engine import EW_FNS  # noqa: E402
from repro_torch.kernels.tm_affine import chain as ch  # noqa: E402
from repro_torch.kernels.tm_affine import ops as ttops  # noqa: E402
from repro_torch.kernels.tm_affine.tm_affine import _magic  # noqa: E402
from tests.harness import CHAIN_CASES  # noqa: E402
from tests.test_torch_chains import _chain_sources  # noqa: E402
from tests.test_torch_gpu import CHAIN_SIGS, neck_chain  # noqa: E402

DTYPES = (torch.int8, torch.int32, torch.bfloat16, torch.float32)


def _jax_sig(sig: ch.ChainSig):
    """The same signature in the JAX package, its maps through JSON."""
    def conv(m):
        return jaf.MixedRadixMap.decode(json.loads(json.dumps(m.encode())))
    return jch.ChainSig(
        links=tuple((conv(m), ew) for m, ew in sig.links),
        route_maps=None if sig.route_maps is None
        else tuple(conv(m) for m in sig.route_maps),
        route_band=sig.route_band, dtype=sig.dtype,
        segment_bytes=sig.segment_bytes)


def _div(u, units):
    """The kernel's run of access u (chain::run_of)."""
    m, sh = _magic(units)
    t = (u * np.uint64(m)) >> np.uint64(32)
    return (t + ((u - t) >> np.uint64(sh & 0xff))) >> np.uint64(sh >> 8)


def _model(rp: ch.RunPlan, vec: int) -> dict:
    """Per output element, what the kernel computes from the tables with
    accesses of ``vec`` elements: each index (int64) and each mask."""
    numel = rp.run * rp.n_runs
    units = rp.run // vec
    u = np.arange(numel // vec, dtype=np.uint64)
    o = _div(u, units)
    assert np.array_equal(o, u // np.uint64(units))
    o = o.astype(np.int64)
    p0 = (u.astype(np.int64) - o * units) * vec
    lane = np.arange(vec)

    def index(f):
        a = (f.base.astype(np.int64)[o] + f.off.astype(np.int64)[p0])
        return (a[:, None] + lane[None, :]).ravel()

    def mask(m):
        ok = np.ones(len(u), bool)
        if m.outer is not None:
            ok &= m.outer[o]
        if m.run is not None:
            ok &= m.run[p0]
        return np.repeat(ok, vec)

    return dict(
        j=index(rp.j),
        levels=[(mask(m), None if p is None else index(p))
                for m, p in rp.levels],
        extras=[(index(i), mask(m)) for i, m in rp.extras])


def _check_plan(rp: ch.RunPlan, plan) -> None:
    """The model of ``rp`` against a full chain plan (the port's or the
    JAX package's), wherever the kernel reads each array."""
    numel = plan.rows * plan.minor
    assert rp.run * rp.n_runs == numel
    for vec in sorted({1, rp.vec}):
        got = _model(rp, vec)
        # where no level from l on masks the element (true masks)
        alive = np.ones(numel, bool)
        for (gm, gp), lv in zip(reversed(got["levels"]),
                                reversed(plan.levels)):
            true = np.ones(numel, bool) if lv.mask is None \
                else lv.mask.ravel()
            assert np.array_equal(gm[alive], true[alive]), vec
            if lv.ew is not None:
                assert np.array_equal(gp[alive], lv.p.ravel()[alive]), vec
            alive &= true
        assert np.array_equal(got["j"][alive], plan.j.ravel()[alive]), vec
        for (gi, gm), ex in zip(got["extras"], plan.extras):
            true = np.ones(numel, bool) if ex.mask is None \
                else ex.mask.ravel()
            assert np.array_equal(gm, true), vec
            assert np.array_equal(gi[true], ex.idx.ravel()[true]), vec


def _walk(rp: ch.RunPlan, x: torch.Tensor, slabs) -> torch.Tensor:
    """The kernel's walk over the model's arrays: the source only where no
    level masks the element, each element's walk from the last level that
    masks it (its fill, then its epilogue), then the extra bands."""
    plan = ch.build_chain_plan(rp.sig)
    got = _model(rp, rp.vec)
    numel = rp.run * rp.n_runs
    masks = [torch.from_numpy(m) for m, _ in got["levels"]]
    dead_after = torch.zeros(numel, dtype=torch.bool)  # a later level masks
    later = []
    for m in reversed(masks):
        later.append(dead_after.clone())
        dead_after |= ~m
    later.reverse()
    v = torch.zeros(numel, dtype=x.dtype)
    src = ~dead_after
    v[src] = x.reshape(-1)[torch.from_numpy(got["j"])[src]]
    it = iter(slabs)
    for (m, p), lv, skip in zip(got["levels"], plan.levels, later):
        on = ~skip
        fill = on & ~torch.from_numpy(m)
        v[fill] = torch.tensor(lv.fill, dtype=x.dtype)
        if lv.ew is not None:
            y = next(it).reshape(-1)[torch.from_numpy(p)[on]]
            v[on] = EW_FNS[lv.ew](v[on], y)
    for (idx, m), ex in zip(got["extras"], plan.extras):
        ok = torch.from_numpy(m)
        u = torch.full((numel,), ex.fill, dtype=x.dtype)
        u[ok] = next(it).reshape(-1)[torch.from_numpy(idx)[ok]]
        v = v + u
    return v.reshape(rp.sig.out_shape)


def _rand(rng, shape, dtype):
    if dtype.is_floating_point:
        a = torch.tensor((rng.rand(*shape) * 200 - 100).astype(np.float32))
    else:
        a = torch.tensor(rng.randint(-99, 100, size=shape).astype(np.int32))
    return a.to(dtype)


def _harness_sigs() -> list:
    """The port's signature of every forwarding chain of the harness that
    lowers to tm_chain (batch ranks 0 and 1)."""
    out = []
    for case in CHAIN_CASES:
        for b in (0, 1):
            for _, (ti, ts) in _chain_sources(case, b):
                sig, _ = ttops._chain_sig_build(ti, ts, b, None)
                if sig is not None:
                    out.append(sig)
    return out


def _named_sigs() -> dict:
    """The card tests' chains but the full-size neck, with an add epilogue
    and, where the chain has an epilogue, a max one."""
    return {f"{name}-{ew}": f(ew) for name, f in CHAIN_SIGS.items()
            if name != "neck"
            for ew in (("add",) if f("add") == f("max") else ("add", "max"))}


# ---------------------------------------------------------------------------
# the plan against both packages' full plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,batch_dims",
                         [pytest.param(c, b, id=f"{c.name}-b{b}")
                          for c in CHAIN_CASES for b in (0, 1)])
def test_run_plan_matches_both_packages_on_harness_chains(case, batch_dims):
    chains = _chain_sources(case, batch_dims)
    assert chains
    for (jinstrs, jsrcs), (tinstrs, tsrcs) in chains:
        jsig, _ = jtops._chain_sig_build(jinstrs, jsrcs, batch_dims, None)
        tsig, _ = ttops._chain_sig_build(tinstrs, tsrcs, batch_dims, None)
        assert (jsig is None) == (tsig is None)
        if tsig is None:  # the RME chain: a pullback, not a tm_chain plan
            continue
        rp = ch.build_run_plan(tsig)
        _check_plan(rp, ch.build_chain_plan(tsig))
        _check_plan(rp, jch.build_chain_plan(jsig))


@pytest.mark.parametrize("name", list(_named_sigs()))
def test_run_plan_matches_both_packages(name):
    sig = _named_sigs()[name]
    rp = ch.build_run_plan(sig)
    _check_plan(rp, ch.build_chain_plan(sig))
    _check_plan(rp, jch.build_chain_plan(_jax_sig(sig)))
    assert rp.table_bytes <= ch.RUN_SMEM and rp.run <= ch.R_CAP


def test_neck_run_plan_is_runs_of_the_channels():
    """chip_smoke.py's neck: runs of the 256 channels, 16-byte accesses in
    f32, under 64 KB of tables in all (the full pullback is 16 MB)."""
    sig = neck_chain()
    rp = ch.build_run_plan(sig)
    assert (rp.run, rp.n_runs, rp.vec) == (256, 8 * 28 * 28, 4)
    assert rp.table_bytes + rp.outer_bytes < 64 * 1024
    # j: base of (n, h / 2, w / 2), off c below 128; band 1: base of
    # (n, h, w) and off c - 128 from 128 on
    assert np.array_equal(rp.j.off[:128], np.arange(128))
    (idx, mask), = rp.extras
    assert np.array_equal(idx.off[128:], np.arange(128))
    assert mask.outer is None and np.array_equal(mask.run,
                                                 np.arange(256) >= 128)
    _check_plan(rp, ch.build_chain_plan(sig))
    _check_plan(rp, jch.build_chain_plan(_jax_sig(sig)))


@pytest.mark.parametrize("name,run", [("img2col_r1", 1),
                                      ("at_cap", ch.R_CAP)])
def test_run_plan_takes_the_longest_suffix_that_factors(name, run):
    """No suffix factors the img2col padding's mask (R = 1, the per-run
    tables are then the full arrays); a transpose's suffix of R_CAP
    elements with an epilogue takes 64 KB of run tables."""
    sig = CHAIN_SIGS[name]("add")
    rp = ch.build_run_plan(sig)
    assert rp.run == run
    if run == ch.R_CAP:
        assert 48 * 1024 < rp.table_bytes <= ch.RUN_SMEM
    else:
        assert rp.n_runs == rp.sig.out_shape[0] * rp.sig.out_shape[1]


def test_magic_division_of_every_run_length():
    u = np.concatenate([np.arange(5000, dtype=np.uint64),
                        np.uint64(2 ** 31 - 1) - np.arange(5000,
                                                           dtype=np.uint64)])
    for units in list(range(1, 300)) + [1120, 4096, 8191, 8192]:
        assert np.array_equal(_div(u, units), u // np.uint64(units)), units


# ---------------------------------------------------------------------------
# the kernel's walk over the tables, bit for bit against chain_plain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("name", list(_named_sigs()) + ["harness"])
def test_run_plan_walk_matches_chain_plain(name, dtype):
    rng = np.random.RandomState(3)
    sigs = _harness_sigs() if name == "harness" else [_named_sigs()[name]]
    for sig in sigs:
        sig = ch.ChainSig(links=sig.links, route_maps=sig.route_maps,
                          route_band=sig.route_band,
                          dtype=str(dtype)[len("torch."):],
                          segment_bytes=sig.segment_bytes)
        x = _rand(rng, sig.links[0][0].in_shape, dtype)
        slabs = tuple(_rand(rng, s, dtype) for s in ch._slab_shapes(sig))
        rp = ch.build_run_plan(sig)
        want = ch.chain_plain(x, ch.build_chain_plan(sig), slabs)
        assert torch.equal(_walk(rp, x, slabs), want), sig


# ---------------------------------------------------------------------------
# the kernel's descriptor, decoded as chain_desc.cuh parse_runs decodes it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["neck", "superres_wide-add",
                                  "two_epilogues-max", "route_band1-add"])
def test_descriptor_points_at_the_run_plan(name):
    """The launch's int64 words, decoded field by field, hold R, the
    access width and its magic, every fill and epilogue code, a hole for
    every operand slab, and pointers and offsets that lead to the plan's
    tables in the two uploaded buffers (on the CPU here)."""
    sig = neck_chain() if name == "neck" else _named_sigs()[name]
    lc = ch._Launch(sig, torch.device("cpu"))
    rp, plan = lc.plan, ch.build_chain_plan(sig)
    table = lc.table.numpy()
    outer, o0 = lc.outer.numpy(), lc.outer.data_ptr()

    def run_table(off, dtype):
        if off == -1:
            return None
        n = rp.run * np.dtype(dtype).itemsize
        return table[off:off + n].view(dtype)

    def per_run(ptr, dtype):
        if ptr == 0:
            return None
        n = rp.n_runs * np.dtype(dtype).itemsize
        return outer[ptr - o0:ptr - o0 + n].view(dtype)

    def same(a, b):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64))

    for vec, words in lc.words.items():
        w = list(lc.table_type.from_buffer_copy(words))
        assert w[:2] == [rp.run, rp.table_bytes] and w[5] == vec
        assert (w[6], w[7]) == _magic(rp.run // vec)
        assert w[2] == lc.table.data_ptr()
        same(per_run(w[3], np.int32), rp.j.base)
        same(run_table(w[4], np.int32), rp.j.off)
        at, holes = 8, []
        for (mask, p), lv in zip(rp.levels, plan.levels):
            same(per_run(w[at], np.uint8), mask.outer)
            same(run_table(w[at + 1], np.uint8), mask.run)
            assert w[at + 2] == ch._fill_bits(lv.fill, lc.dtype)
            assert w[at + 3] == ch.EW_CODES[lv.ew]
            same(per_run(w[at + 4], np.int32), None if p is None else p.base)
            same(run_table(w[at + 5], np.int32), None if p is None else p.off)
            if lv.ew is not None:
                holes.append(at + 6)
            at += 7
        for (idx, mask), ex in zip(rp.extras, plan.extras):
            same(per_run(w[at], np.int32), idx.base)
            same(run_table(w[at + 1], np.int32), idx.off)
            same(per_run(w[at + 2], np.uint8), mask.outer)
            same(run_table(w[at + 3], np.uint8), mask.run)
            assert w[at + 4] == ch._fill_bits(ex.fill, lc.dtype)
            holes.append(at + 5)
            at += 6
        assert at == len(w) and tuple(holes) == lc.slab_at


def test_empty_chain_needs_no_plan():
    """An empty output launches nothing, so its launch builds no plan (a
    plan of zero rows has no segments)."""
    m = af.transpose_map((0, 4, 2))
    sig = ch.ChainSig(links=((m, None), (af.transpose_map((4, 0, 2)), None)))
    lc = ch._Launch(sig, torch.device("cpu"))
    assert lc.numel == 0 and lc.out_shape == (0, 4, 2)
