"""Forwarding chains through the port against the JAX package, on the CPU
(the kernels' plain versions).

* Every ``CHAIN_CASES`` entry runs through ``TMExecutor(backend="cuda",
  fuse_chains=True)``, every dtype at batch rank 0 and float32 at ranks
  1-2: outputs bit-exact against the JAX package's reference engine, and
  the lowering records (paths ``pallas.`` -> ``cuda.``, launches, segments,
  instruction counts) equal to the JAX package's chaining ``pallas``
  executor's.
* The port's chain plans (``build_chain_plan``) and pullbacks
  (``fold_pullback``) equal the JAX package's element for element.
* The chained-evaluate and assemble plain versions against the Pallas
  kernels in interpret mode, and against the JAX package's RME engine at the
  capacities those kernels do not take (0, and more than N).
* The port's versions of tests/test_chains.py's behaviour tests.

Tolerance 0 everywhere except the RESIZE tail (its stated atol)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import affine as jaf  # noqa: E402
from repro.core import rme as jrme  # noqa: E402
from repro.core.executor import TMExecutor as JExecutor  # noqa: E402
from repro.core.fusion import forwarding_chains  # noqa: E402
from repro.core.instr import EwOp, TMInstr, TMOpcode, TMProgram  # noqa: E402
from repro.core.schedule import infer_shapes  # noqa: E402
from repro.core.schedule import schedule as jschedule  # noqa: E402
from repro.kernels.rme_gather import ops as jrops  # noqa: E402
from repro.kernels.rme_gather import rme_gather as jrg  # noqa: E402
from repro.kernels.tm_affine import chain as jch  # noqa: E402
from repro.kernels.tm_affine import ops as jtops  # noqa: E402
from repro_torch.core import affine as taf  # noqa: E402
from repro_torch.core.executor import TMExecutor as TExecutor  # noqa: E402
from repro_torch.core.instr import TMProgram as TProgram  # noqa: E402
from repro_torch.core.schedule import schedule as tschedule  # noqa: E402
from repro_torch.kernels.rme_gather import ops as trops  # noqa: E402
from repro_torch.kernels.rme_gather import rme_gather as trg  # noqa: E402
from repro_torch.kernels.tm_affine import chain as tch  # noqa: E402
from repro_torch.kernels.tm_affine import ops as ttops  # noqa: E402
from tests.harness import (CHAIN_CASES, CHAIN_CASES_BY_NAME,  # noqa: E402
                           OpCase, make_inputs)
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

DTYPES = ("int8", "int32", "bfloat16", "float32")


def _records(rep, prefix: str = "") -> list[tuple]:
    return [(r.path.replace(prefix, "cuda.", 1) if prefix else r.path,
             r.launches, r.segments, r.instrs) for r in rep.records]


def _chaining() -> TExecutor:
    return TExecutor(backend="cuda", device="cpu", fuse_chains=True)


def run_chain_parity(prog: TMProgram, shapes: dict, dtype: str,
                     batch_dims: int, *, scale: float = 100.0):
    """Run ``prog`` through the port's chaining executor against the JAX
    package (reference outputs, chaining-``pallas`` lowering).  Returns the
    port's chained and per-instruction lowering reports."""
    view = OpCase("chain", lambda: (prog, shapes), (), scale=scale)
    bufs = make_inputs(view, shapes, dtype, batch_dims,
                       np.random.RandomState(11))
    ref, _, _ = JExecutor(backend="reference").run(prog, bufs,
                                                   batch_dims=batch_dims)
    _, jrep, _ = JExecutor(backend="pallas", fuse_chains=True).run(
        prog, bufs, batch_dims=batch_dims)
    tprog = TProgram.decode(prog.encode())
    tbufs = {k: to_torch(v) for k, v in bufs.items()}
    got, trep, _ = _chaining().run(tprog, tbufs, batch_dims=batch_dims)
    _, urep, _ = TExecutor(backend="cuda", device="cpu").run(
        tprog, tbufs, batch_dims=batch_dims)
    assert set(got) == set(ref)
    for k in ref:
        assert str(got[k].dtype) == f"torch.{ref[k].dtype}"
        assert_same(ref[k], got[k], what=f"{dtype}/b{batch_dims}/{k}")
    assert _records(jrep, "pallas.") == _records(trep)
    assert trep.instr_count() == urep.instr_count() == len(prog.instrs)
    return trep, urep


# ---------------------------------------------------------------------------
# CHAIN_CASES: outputs and lowering against the JAX package
# ---------------------------------------------------------------------------

def _case_params():
    return [pytest.param(c, d, b, id=f"{c.name}-{d}-b{b}")
            for c in CHAIN_CASES for b in (0, 1, 2)
            if b == 0 or c.supports_batch
            for d in (c.dtypes if b == 0 else ("float32",))]


@pytest.mark.parametrize("case,dtype,batch_dims", _case_params())
def test_chain_case_matches_reference_package(case, dtype, batch_dims):
    prog, shapes = case.build()
    trep, urep = run_chain_parity(prog, shapes, dtype, batch_dims,
                                  scale=case.scale)
    chain_paths = tuple(r.path for r in trep.records if r.is_chain)
    assert chain_paths == tuple(p.replace("pallas.", "cuda.", 1)
                                for p in case.expect_chain_paths)
    assert trep.launch_count() == case.launches_chained
    assert urep.launch_count() == case.launches_unfused


def _two_epilogue_program():
    """pixel shuffle + Add -> crop -> identity + Mul: two epilogues, each
    rounding to the working dtype (bf16 rounds twice, int8 wraps twice)."""
    ps = jaf.pixel_shuffle_map((6, 10, 8), 2)
    crop = jaf.pad_map((12, 20, 2), (-1, -1, 0), (-1, -1, 0))
    ident = jaf.identity_map((10, 18, 2))
    prog = TMProgram(
        [TMInstr(TMOpcode.COARSE, ("x", "skip"), "a", map_=ps, ew=EwOp.ADD),
         TMInstr(TMOpcode.COARSE, ("a",), "b", map_=crop),
         TMInstr(TMOpcode.COARSE, ("b", "w"), "y", map_=ident, ew=EwOp.MUL)],
        inputs=("x", "skip", "w"), outputs=("y",))
    return prog, {"x": (6, 10, 8), "skip": (12, 20, 2), "w": (10, 18, 2)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_epilogue_chain_matches_reference_package(dtype):
    prog, shapes = _two_epilogue_program()
    trep, _ = run_chain_parity(prog, shapes, dtype, 0, scale=30.0)
    assert [r.path for r in trep.records] == ["cuda.chain"]
    sig, _ = ttops._chain_sig_build(
        TProgram.decode(prog.encode()).instrs,
        [[torch.zeros(shapes["x"]), torch.zeros(shapes["skip"])], [None],
         [None, torch.zeros(shapes["w"])]], 0, None)
    plan = tch.chain_plan_of(sig)
    assert [lv.ew for lv in plan.levels] == ["add", "mul"]


# ---------------------------------------------------------------------------
# chain plans and pullbacks, element for element
# ---------------------------------------------------------------------------

def _chain_sources(case, batch_dims):
    """Each package's (instrs, srcs) for every forwarding chain of the case,
    sources as zeros of their executor-lifted shapes (None where a buffer
    is streamed)."""
    prog, shapes = case.build()
    tprog = TProgram.decode(prog.encode())
    batch = tuple(range(2, 2 + batch_dims))
    full = infer_shapes(prog, shapes)
    out = []
    for chain in forwarding_chains(prog):
        streamed = set(chain.buffers)
        rows = []
        for pkg, zeros in ((prog, jnp.zeros), (tprog, torch.zeros)):
            instrs = [pkg.instrs[i] for i in chain.instrs]
            srcs = [[None if s in streamed else zeros(batch + full[s])
                     for s in ins.srcs] for ins in instrs]
            rows.append((instrs, srcs))
        out.append(rows)
    return out


def _assert_same_array(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=what)


def _assert_same_plan(jp, tp):
    assert (jp.rows, jp.minor, jp.row_block, jp.n_composed, jp.n_segments) \
        == (tp.rows, tp.minor, tp.row_block, tp.n_composed, tp.n_segments)
    _assert_same_array(jp.j, tp.j, "j")
    assert len(jp.levels) == len(tp.levels)
    for k, (a, b) in enumerate(zip(jp.levels, tp.levels)):
        assert (a.fill, a.ew) == (b.fill, b.ew), k
        _assert_same_array(a.mask, b.mask, f"level {k} mask")
        _assert_same_array(a.p, b.p, f"level {k} p")
    assert len(jp.extras) == len(tp.extras)
    for k, (a, b) in enumerate(zip(jp.extras, tp.extras)):
        assert a.fill == b.fill, k
        _assert_same_array(a.idx, b.idx, f"extra {k} idx")
        _assert_same_array(a.mask, b.mask, f"extra {k} mask")


@pytest.mark.parametrize(
    "case,batch_dims", [pytest.param(c, b, id=f"{c.name}-b{b}")
                        for c in CHAIN_CASES for b in (0, 1)])
def test_chain_plan_matches_reference_package(case, batch_dims):
    chains = _chain_sources(case, batch_dims)
    assert chains
    for (jinstrs, jsrcs), (tinstrs, tsrcs) in chains:
        jsig, jslabs = jtops._chain_sig_build(jinstrs, jsrcs, batch_dims,
                                              None)
        tsig, tslabs = ttops._chain_sig_build(tinstrs, tsrcs, batch_dims,
                                              None)
        assert (jsig is None) == (tsig is None)
        if jsig is not None:
            _assert_same_plan(jch.build_chain_plan(jsig),
                              tch.build_chain_plan(tsig))
            assert jch.chain_slab_bytes(jsig, jsrcs[0][0], jslabs) == \
                tch.chain_slab_bytes(tsig, tsrcs[0][0], tslabs)
            continue
        # the RME chain: coarse pre-links folded into one pullback
        jmaps, jbd = jrops._chain_eval_maps(jinstrs, jsrcs, batch_dims)
        tmaps, tbd = trops._chain_eval_maps(tinstrs, tsrcs, batch_dims)
        assert jmaps is not None and jbd == tbd
        jidx, jok, jfill = jrops._chain_eval_pullback(jmaps)
        tidx, tok, tfill = trops._chain_eval_pullback(tmaps)
        assert jfill == tfill
        _assert_same_array(jidx, tidx, "pullback idx")
        _assert_same_array(jok, tok, "pullback ok")


def _pullback_maps(af):
    pad = af.pad_map((3, 40, 7), (0, 2, 0), (0, 3, 0), fill=25.0)
    crop = af.pad_map((3, 45, 7), (0, -1, 0), (0, -2, 0))
    repad = af.pad_map((3, 42, 7), (0, 1, 0), (0, 1, 0), fill=25.0)
    other = af.pad_map((3, 42, 7), (0, 1, 0), (0, 1, 0), fill=-1.0)
    return {
        "reshape": ((af.reshape_map((3, 315), (3, 45, 7)),), False),
        "pad": ((pad, af.reshape_map((3, 45, 7), (45, 21))), False),
        "crop_repad": ((pad, crop, repad), False),
        "mixed_fills": ((pad, crop, other), True),
    }


@pytest.mark.parametrize("name", list(_pullback_maps(jaf)))
def test_fold_pullback_matches_reference_package(name):
    jmaps, mixed = _pullback_maps(jaf)[name]
    tmaps, _ = _pullback_maps(taf)[name]
    if mixed:
        for fold, maps in ((jch.fold_pullback, jmaps),
                           (tch.fold_pullback, tmaps)):
            with pytest.raises(ValueError, match="mixed fill"):
                fold(maps)
        # the chain rule then declines (cached), it does not fail
        assert trops._chain_eval_pullback(tmaps) is None
        return
    jj, jok, jfill = jch.fold_pullback(jmaps)
    tj, tok, tfill = tch.fold_pullback(tmaps)
    assert jfill == tfill
    _assert_same_array(jj, tj, "J")
    _assert_same_array(jok, tok, "OK")


def test_mixed_fill_chain_declines_and_runs_per_instruction():
    """A detect-tail chain whose pre-links disagree on their fill is left to
    per-instruction lowering, bit-exact, exactly as the JAX package does."""
    pad = jaf.pad_map((40, 7), (2, 0), (3, 0), fill=25.0)
    crop = jaf.pad_map((45, 7), (-1, 0), (-2, 0))
    other = jaf.pad_map((42, 7), (1, 0), (1, 0), fill=-1.0)
    from repro.core.instr import RMEConfig
    prog = TMProgram(
        [TMInstr(TMOpcode.COARSE, ("p",), "a", map_=pad),
         TMInstr(TMOpcode.COARSE, ("a",), "b", map_=crop),
         TMInstr(TMOpcode.COARSE, ("b",), "c", map_=other),
         TMInstr(TMOpcode.FINE_EVALUATE, ("c",), "y",
                 rme=RMEConfig(scheme="evaluate", threshold=20.0, cmp="ge",
                               score_index=4, capacity=8))],
        inputs=("p",), outputs=("y",))
    trep, _ = run_chain_parity(prog, {"p": (40, 7)}, "float32", 0)
    assert "cuda.chain+rme.evaluate" not in trep.paths()


# ---------------------------------------------------------------------------
# RME plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _arr(rng, shape, dtype):
    if dtype.startswith("int"):
        return jnp.asarray(rng.randint(-99, 100, size=shape).astype(dtype))
    return jnp.asarray((rng.rand(*shape) * 100 - 50)
                       .astype(np.float32)).astype(dtype)


def _pulled_streams(name):
    maps, _ = _pullback_maps(jaf)[name]
    J, OK, fill = jch.fold_pullback(maps)
    shape = maps[-1].out_shape
    return maps[0].in_shape, J.reshape(shape), (
        None if OK is None else OK.reshape(shape)), fill


def _engine_evaluate(recs, thr, cap, cmp, score_index):
    out = [jrme.evaluate(r, thr, cap, cmp=cmp, score_index=score_index)
           for r in recs]
    return tuple(jnp.stack([o[k] for o in out]) for k in range(3))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pullback", ["reshape", "pad"])
def test_evaluate_chained_plain_matches_pallas(dtype, pullback):
    """With ``ok`` (the pad: fill 25 passes the threshold) and without it
    (the reshape), at capacities the Pallas kernel takes, then at 0 and
    more than N against the JAX package's engine."""
    rng = np.random.RandomState(12)
    in_shape, idx, ok, fill = _pulled_streams(pullback)
    if idx.ndim == 2:
        idx = idx[None]
        ok = None if ok is None else ok[None]
    x = _arr(rng, in_shape, dtype)
    thr = 10.5 if dtype != "int8" else 3
    t_args = (to_torch(x), torch.tensor(idx),
              None if ok is None else torch.tensor(ok), fill)
    for cmp in ("ge", "lt"):
        ref = jrg.evaluate_chained(x, jnp.asarray(idx),
                                   None if ok is None else jnp.asarray(ok),
                                   fill, thr, 8, cmp=cmp, score_index=4,
                                   interpret=True)
        got = trg.evaluate_chained(*t_args, thr, 8, cmp=cmp, score_index=4)
        for r, g, what in zip(ref, got, ("rows", "idx", "count")):
            assert_same(r, g, what=f"{dtype}/{pullback}/{cmp}/{what}")
        recs = x.reshape(-1)[jnp.asarray(idx)]
        if ok is not None:
            recs = jnp.where(jnp.asarray(ok), recs,
                             jnp.asarray(fill, dtype=recs.dtype))
        for cap in (0, idx.shape[1] + 9):
            ref = _engine_evaluate(recs, thr, cap, cmp, 4)
            got = trg.evaluate_chained(*t_args, thr, cap, cmp=cmp,
                                       score_index=4)
            for r, g, what in zip(ref, got, ("rows", "idx", "count")):
                assert_same(np.asarray(r).reshape(g.shape), g,
                            what=f"{dtype}/{pullback}/{cmp}/cap{cap}/{what}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_assemble_plain_matches_pallas(dtype):
    rng = np.random.RandomState(13)
    x = _arr(rng, (3, 33, 7), dtype)
    masks = {"random": rng.rand(3, 33) < 0.4,
             "none": np.zeros((3, 33), dtype=bool),
             "int32": (rng.rand(3, 33) < 0.6).astype(np.int32) * 5}
    for name, mask in masks.items():
        ref = jrg.assemble_batched(x, jnp.asarray(mask), 8, interpret=True)
        got = trg.assemble_batched(to_torch(x), torch.tensor(mask), 8)
        for r, g in zip(ref, got):
            assert_same(r, g, what=f"{dtype}/{name}/batched")
        ref = jrg.assemble(x[1], jnp.asarray(mask[1]), 8, interpret=True)
        got = trg.assemble(to_torch(x)[1], torch.tensor(mask[1]), 8)
        for r, g in zip(ref, got):
            assert_same(r, g, what=f"{dtype}/{name}/single")
        for cap in (0, 40):
            got = trg.assemble_batched(to_torch(x), torch.tensor(mask), cap)
            for b in range(3):
                packed, cnt = jrme.assemble(x[b], jnp.asarray(mask[b] != 0),
                                            cap)
                assert_same(packed, got[0][b],
                            what=f"{dtype}/{name}/cap{cap}")
                assert int(cnt) == int(got[1][b, 0])


# ---------------------------------------------------------------------------
# behaviour (the port's versions of tests/test_chains.py's)
# ---------------------------------------------------------------------------

def test_unclaimed_chain_falls_back_per_instruction():
    """A forwardable chain whose link no chain rule executes (RESIZE) falls
    back to per-instruction lowering."""
    m = jaf.transpose_map((6, 9, 3))
    prog = TMProgram(
        [TMInstr(TMOpcode.COARSE, ("x",), "a", map_=m),
         TMInstr(TMOpcode.RESIZE, ("a",), "y",
                 meta={"out_h": 11, "out_w": 5})],
        inputs=("x",), outputs=("y",))
    assert len(forwarding_chains(prog)) == 1
    x = np.random.RandomState(7).rand(6, 9, 3).astype(np.float32)
    ref, _, _ = JExecutor(backend="reference").run(prog,
                                                   {"x": jnp.asarray(x)})
    got, rep, _ = _chaining().run(TProgram.decode(prog.encode()),
                                  {"x": torch.tensor(x)})
    assert_same(ref["y"], got["y"], atol=1e-5)
    assert rep.chain_count() == 0
    assert rep.launch_count() == 2  # one per instruction — nothing fused


def test_partial_chain_fuses_claimable_prefix():
    """transpose -> split fuse to one launch, the RESIZE tail lowers
    alone: 2 launches instead of 3."""
    m1 = jaf.transpose_map((9, 6, 4))
    m2 = jaf.split_map((6, 9, 4), 2, 1)
    prog = TMProgram(
        [TMInstr(TMOpcode.COARSE, ("x",), "a", map_=m1),
         TMInstr(TMOpcode.COARSE, ("a",), "b", map_=m2),
         TMInstr(TMOpcode.RESIZE, ("b",), "y",
                 meta={"out_h": 11, "out_w": 5})],
        inputs=("x",), outputs=("y",))
    x = np.random.RandomState(7).rand(9, 6, 4).astype(np.float32)
    ref, _, _ = JExecutor(backend="reference").run(prog,
                                                   {"x": jnp.asarray(x)})
    got, rep, _ = _chaining().run(TProgram.decode(prog.encode()),
                                  {"x": torch.tensor(x)})
    assert_same(ref["y"], got["y"], atol=1e-5)
    assert rep.chain_count() == 1
    assert rep.launch_count() == 2
    (chain_rec,) = [r for r in rep.records if r.is_chain]
    assert chain_rec.instrs == 2 and chain_rec.dst == "b"
    assert chain_rec.path == "cuda.chain"


def test_fuse_chains_off_is_identical():
    """fuse_chains=False is the per-instruction path (one record per
    instruction), with the same outputs as the chained path."""
    prog, shapes = CHAIN_CASES_BY_NAME["chain3"].build()
    tprog = TProgram.decode(prog.encode())
    x = {"x": torch.tensor(np.random.RandomState(7).rand(*shapes["x"])
                           .astype(np.float32))}
    off, rep, _ = TExecutor(backend="cuda", device="cpu").run(tprog, x)
    on, rep_on, _ = _chaining().run(tprog, x)
    assert [r.instrs for r in rep.records] == [1, 1, 1]
    assert rep.chain_count() == 0 and rep_on.chain_count() == 1
    assert torch.equal(off["y"], on["y"])


@pytest.mark.parametrize("name", ["chain3", "chain_superres", "chain_route"])
def test_chain_record_segments_match_schedule(name):
    """The chain record's segment count is the chained cycle model's, in the
    port and in the JAX package."""
    prog, shapes = CHAIN_CASES_BY_NAME[name].build()
    tprog = TProgram.decode(prog.encode())
    bufs = {k: torch.zeros(v) for k, v in shapes.items()}
    _, rep, _ = _chaining().run(tprog, bufs)
    (chain_rec,) = [r for r in rep.records if r.is_chain]
    (row,) = tschedule(tprog, shapes).chain_reports
    assert chain_rec.segments == row["segments_chained"]
    assert row == jschedule(prog, shapes).chain_reports[0]
