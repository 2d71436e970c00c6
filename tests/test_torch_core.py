"""The port's core against the JAX package's: the instruction encoding as a
parity channel, the reference engine, the RME, the schedule's segment
counts and the fusion pass — same inputs, made from a seed with numpy."""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import affine as jaf  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import fusion as jfusion  # noqa: E402
from repro.core import rme as jrme  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core.instr import TMProgram as JProgram  # noqa: E402
from repro_torch.core import affine as taf  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import fusion as tfusion  # noqa: E402
from repro_torch.core import rme as trme  # noqa: E402
from repro_torch.core import schedule as tschedule  # noqa: E402
from repro_torch.core.instr import TMProgram as TProgram  # noqa: E402
from tests.harness import CASES, CHAIN_CASES  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402


def _maps(af):
    """The same map library built by either package's affine module."""
    return {
        "transpose": af.transpose_map((5, 7, 3)),
        "rot90": af.rot90_map((5, 7, 3)),
        "pixelshuffle": af.pixel_shuffle_map((6, 10, 8), 2),
        "pixelunshuffle": af.pixel_unshuffle_map((6, 10, 2), 2),
        "upsample": af.upsample_map((5, 7, 3), 2),
        "split": af.split_map((5, 7, 6), 3, 1),
        "img2col_pad": af.img2col_map((8, 9, 3), 3, 3, 2, 1, fill=-1.0),
        "rearrange": af.rearrange_map((6, 8, 3), 4, 16),
        "flip": af.flip_map((4, 5, 6), (0, 2)),
        "pad_crop": af.pad_map((6, 7, 2), (2, -1, 0), (-2, 3, 0), fill=3.0),
        "band_gather": af.index_select_band_maps((6, 4), 0, [5, 0, 3])[1],
        "reshape": af.reshape_map((14, 14, 255), (588, 85)),
        "broadcast": af.broadcast_map((1, 5), (3, 4, 5), (1, 2)),
        "strided_neg": af.strided_slice_map((9, 5), (8, 4), (-3, -2), (3, 3)),
        "paper_table2_pixelshuffle": af.MixedRadixMap(
            out_shape=(4, 6), in_shape=(2, 12), splits=(af.DigitSplit(1, 2),),
            affine=af.AffineMap.make([[Fraction(1, 2), 0, 0],
                                      [Fraction(-1, 3), 2, 1]], [0, -3]),
            oob_possible=True, fill=7.0, digit_bounds=((0, 3),)),
    }


MAP_NAMES = list(_maps(jaf))


# ---------------------------------------------------------------------------
# (a) the encoding is the parity channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES + CHAIN_CASES,
                         ids=[c.name for c in CASES + CHAIN_CASES])
def test_program_json_round_trips_between_packages(case):
    prog, _ = case.build()
    s = prog.encode()
    ported = TProgram.decode(s)
    assert ported.encode() == s
    assert JProgram.decode(ported.encode()).encode() == s


@pytest.mark.parametrize("name", MAP_NAMES)
def test_map_encoding_is_byte_compatible(name):
    jm, tm = _maps(jaf)[name], _maps(taf)[name]
    assert jm.encode() == tm.encode()
    assert taf.MixedRadixMap.decode(jm.encode()) == tm


# ---------------------------------------------------------------------------
# reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MAP_NAMES)
def test_gather_indices_match(name):
    jm, tm = _maps(jaf)[name], _maps(taf)[name]
    jflat, jvalid = jengine.gather_indices(jm)
    tflat, tvalid = tengine.gather_indices(tm)
    assert tflat.dtype == torch.int64
    assert_same(jflat, tflat, what=name)
    assert_same(jvalid, tvalid, what=name)


@pytest.mark.parametrize("name", MAP_NAMES)
@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("batch_dims", [0, 2])
def test_apply_map_matches(name, dtype, batch_dims):
    jm, tm = _maps(jaf)[name], _maps(taf)[name]
    rng = np.random.RandomState(7)
    shape = (2, 3)[:batch_dims] + tuple(jm.in_shape)
    x = rng.randint(-99, 100, size=shape).astype(dtype)
    got = tengine.apply_map(tm, torch.tensor(x), batch_dims=batch_dims)
    ref = jengine.apply_map(jm, jnp.asarray(x), batch_dims=batch_dims)
    assert got.dtype == torch.tensor(x).dtype
    assert_same(ref, got, what=name)


@pytest.mark.parametrize("overlay", [False, True])
def test_route_gather_matches(overlay):
    rng = np.random.RandomState(3)
    if overlay:
        jmaps = jaf.update_slice_maps((6, 5, 4), (2, 3, 4), (3, 1, 0))
        tmaps = taf.update_slice_maps((6, 5, 4), (2, 3, 4), (3, 1, 0))
        xs = [rng.rand(2, 6, 5, 4), rng.rand(2, 2, 3, 4)]
    else:
        jmaps = jaf.route_maps([(5, 7, 2), (5, 7, 3)])
        tmaps = taf.route_maps([(5, 7, 2), (5, 7, 3)])
        xs = [rng.rand(2, 5, 7, 2), rng.rand(2, 5, 7, 3)]
    xs = [x.astype(np.float32) for x in xs]
    ref = jengine.route_gather(jmaps, [jnp.asarray(x) for x in xs],
                               batch_dims=1, overlay=overlay)
    got = tengine.route_gather(tmaps, [torch.tensor(x) for x in xs],
                               batch_dims=1, overlay=overlay)
    assert_same(ref, got)


@pytest.mark.parametrize("name", ["transpose", "split", "pad_crop"])
def test_scatter_accumulate_matches(name):
    jm, tm = _maps(jaf)[name], _maps(taf)[name]
    rng = np.random.RandomState(5)
    x = rng.rand(2, *jm.out_shape).astype(np.float32)
    out = rng.rand(2, *jm.in_shape).astype(np.float32)
    ref = jengine.scatter_accumulate(jm, jnp.asarray(x), jnp.asarray(out),
                                     batch_dims=1)
    got = tengine.scatter_accumulate(tm, torch.tensor(x), torch.tensor(out),
                                     batch_dims=1)
    assert_same(ref, got)


def test_ew_fns_wrap_and_round_like_the_reference():
    rng = np.random.RandomState(11)
    for dtype in ("int8", "int32", "bfloat16", "float32"):
        a = jnp.asarray((rng.rand(64) * 200 - 100).astype(np.float32)
                        ).astype(dtype)
        b = jnp.asarray((rng.rand(64) * 200 - 100).astype(np.float32)
                        ).astype(dtype)
        for op in ("add", "sub", "mul", "max"):
            ref = jengine.EW_FNS[op](a, b)
            got = tengine.EW_FNS[op](to_torch(a), to_torch(b))
            assert_same(ref, got, what=f"{op}/{dtype}")


# ---------------------------------------------------------------------------
# RME
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cap", [(33, 8), (10, 16), (40, 0)])
def test_assemble_and_indices_match(n, cap):
    rng = np.random.RandomState(n)
    x = rng.rand(n, 5).astype(np.float32)
    mask = rng.rand(n) > 0.5
    jp, jc = jrme.assemble(jnp.asarray(x), jnp.asarray(mask), cap, fill=-2.0)
    tp, tc = trme.assemble(torch.tensor(x), torch.tensor(mask), cap, fill=-2.0)
    assert_same(jp, tp)
    assert int(jc) == int(tc)
    ji, jc = jrme.assemble_indices(jnp.asarray(mask), cap)
    ti, tc = trme.assemble_indices(torch.tensor(mask), cap)
    assert_same(ji, ti)
    assert int(jc) == int(tc)


@pytest.mark.parametrize("dtype,threshold",
                         [("float32", 50.0), ("bfloat16", 50.3),
                          ("int32", 10.5), ("int8", 3)])
@pytest.mark.parametrize("cmp", ["ge", "gt", "le", "lt"])
def test_evaluate_matches_at_promoted_dtype(dtype, threshold, cmp):
    rng = np.random.RandomState(2)
    x = jnp.asarray((rng.rand(40, 6) * 100).astype(np.float32)).astype(dtype)
    ref = jrme.evaluate(x, threshold, 12, cmp=cmp, score_index=2)
    got = trme.evaluate(to_torch(x), threshold, 12, cmp=cmp, score_index=2)
    for r, g in zip(ref, got):
        assert_same(r, g, what=f"{dtype}/{cmp}")


def test_evaluate_topk_breaks_ties_by_index():
    x = np.array([[3.0, 0], [5.0, 1], [3.0, 2], [5.0, 3], [1.0, 4],
                  [5.0, 5]], dtype=np.float32)
    jr, ji = jrme.evaluate_topk(jnp.asarray(x), 4, score_index=0)
    tr, ti = trme.evaluate_topk(torch.tensor(x), 4, score_index=0)
    assert_same(ji, ti)
    assert_same(jr, tr)
    assert ti.tolist() == [1, 3, 5, 0]


@pytest.mark.parametrize("E,T,cap", [(4, 30, 5), (3, 7, 8)])
def test_dispatch_tokens_matches(E, T, cap):
    expert_of = np.random.RandomState(T).randint(0, E, size=T).astype(np.int32)
    ji, jc = jrme.dispatch_tokens(jnp.asarray(expert_of), E, cap)
    ti, tc = trme.dispatch_tokens(torch.tensor(expert_of), E, cap)
    assert_same(ji, ti)
    assert_same(jc, tc)


# ---------------------------------------------------------------------------
# schedule and fusion: the same counts and the same programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MAP_NAMES)
@pytest.mark.parametrize("segment_bytes", [None, 512])
def test_map_segments_match(name, segment_bytes):
    jm, tm = _maps(jaf)[name], _maps(taf)[name]
    for batch in ((), (3,), (2, 4)):
        assert (jschedule.map_segments(jm, 4, segment_bytes, batch)
                == tschedule.map_segments(tm, 4, segment_bytes, batch))


@pytest.mark.parametrize("case", CASES + CHAIN_CASES,
                         ids=[c.name for c in CASES + CHAIN_CASES])
def test_schedule_and_fusion_match(case):
    jprog, shapes = case.build()
    tprog = TProgram.decode(jprog.encode())
    jrep = jschedule.schedule(jprog, shapes)
    trep = tschedule.schedule(tprog, shapes)
    assert [t.n_segments for t in jrep.timings] == \
        [t.n_segments for t in trep.timings]
    assert (jrep.unpipelined_cycles, jrep.pipelined_cycles,
            jrep.forwarded_cycles, jrep.chained_cycles) == \
        (trep.unpipelined_cycles, trep.pipelined_cycles,
         trep.forwarded_cycles, trep.chained_cycles)
    assert [c.instrs for c in jfusion.forwarding_chains(jprog)] == \
        [c.instrs for c in tfusion.forwarding_chains(tprog)]
    jf, jfr = jfusion.fuse(jprog)
    tf, tfr = tfusion.fuse(tprog)
    assert jf.encode() == tf.encode()
    assert (jfr.fused_pairs, jfr.bytes_before, jfr.bytes_after) == \
        (tfr.fused_pairs, tfr.bytes_before, tfr.bytes_after)


# ---------------------------------------------------------------------------
# dispatch: the degradation ladder and the lowering report
# ---------------------------------------------------------------------------

def _transpose_program():
    m = taf.transpose_map((4, 6, 2))
    from repro_torch.core.instr import TMInstr, TMOpcode
    return TProgram([TMInstr(TMOpcode.COARSE, ("x",), "y", map_=m)],
                    ("x",), ("y",))


def test_quarantine_degrades_a_failing_rule_to_the_engine(monkeypatch):
    from repro_torch.core import dispatch
    from repro_torch.core.executor import TMExecutor
    fired = []

    def hook(site, label):
        fired.append((site, label))
        raise RuntimeError("injected")

    monkeypatch.setattr(dispatch, "fault_hook", hook)
    x = torch.arange(48, dtype=torch.float32).reshape(4, 6, 2)
    quarantine: set = set()
    ex = TMExecutor(backend="cuda", device="cpu", quarantine=quarantine)
    for _ in range(2):  # second run: skipped outright, no new fault
        out, rep, _ = ex.run(_transpose_program(), {"x": x})
        assert torch.equal(out["y"], x.permute(1, 0, 2))
        assert rep.paths() == ["reference.coarse"]
        assert rep.degraded_count() == 1 and not rep.records[0].is_kernel
    assert fired == [("lowering", "tm_affine:coarse:y")]
    assert len(quarantine) == 1


def test_without_quarantine_a_failing_rule_fails_the_run(monkeypatch):
    from repro_torch.core import dispatch
    from repro_torch.core.executor import TMExecutor

    def hook(site, label):
        raise RuntimeError("injected")

    monkeypatch.setattr(dispatch, "fault_hook", hook)
    with pytest.raises(RuntimeError, match="injected"):
        TMExecutor(backend="cuda", device="cpu")(
            _transpose_program(), {"x": torch.zeros(4, 6, 2)})


def test_quarantine_is_refused_on_the_card():
    """The ladder gives way to the engine only on the CPU: an executor for
    the card with a quarantine set, or a CUDA source under one, raises
    before any rule runs."""
    from types import SimpleNamespace

    from repro_torch.core import dispatch
    from repro_torch.core.executor import TMExecutor
    for device in (None, "cuda"):
        with pytest.raises(ValueError, match="quarantine"):
            TMExecutor(backend="cuda", device=device, quarantine=set())
    ins = _transpose_program().instrs[0]
    on_card = SimpleNamespace(is_cuda=True, shape=(4, 6, 2))
    with pytest.raises(ValueError, match="quarantine"):
        dispatch.lower_instr(ins, [on_card], 0, quarantine=set())
    with pytest.raises(ValueError, match="quarantine"):
        dispatch.lower_chain([ins, ins], [[on_card], [None]], 0,
                             quarantine=set())


def test_lowering_report_accounting():
    from repro_torch.core.executor import TMExecutor
    route = TProgram.decode(CASES[[c.name for c in CASES].index("route")]
                            .build()[0].encode())
    ex = TMExecutor(backend="cuda", device="cpu")
    out, rep, _ = ex.run(route, {"a": torch.zeros(5, 7, 2),
                                 "b": torch.ones(5, 7, 3)})
    assert rep.counts() == {"cuda.route": 1}
    assert rep.launch_count() == 2 and rep.instr_count() == 1
    assert rep.chain_count() == 0 and rep.kernel_fraction() == 1.0
    assert out["y"].shape == (5, 7, 5)


# ---------------------------------------------------------------------------
# tm_ops: the functional API on the reference engine
# ---------------------------------------------------------------------------

def _tm_ops_calls():
    return {
        "transpose": lambda t, x: t.transpose(x),
        "rot90": lambda t, x: t.rot90(x),
        "pixel_shuffle": lambda t, x: t.pixel_shuffle(x, 2),
        "pixel_unshuffle": lambda t, x: t.pixel_unshuffle(x, 2),
        "upsample": lambda t, x: t.upsample(x, 2),
        "split": lambda t, x: t.split(x, 2)[1],
        "route": lambda t, x: t.route([x, x[..., :2]]),
        "add": lambda t, x: t.add(x, x),
        "img2col": lambda t, x: t.img2col(x, 3, 3, 2, 1),
        "rearrange": lambda t, x: t.rearrange(x[..., :3], 2, 8),
        "permute": lambda t, x: t.permute(x, (2, 0, 1)),
        "repeat_heads": lambda t, x: t.repeat_heads(x, 3, 1),
    }


@pytest.mark.parametrize("name", list(_tm_ops_calls()))
def test_tm_ops_match(name):
    from repro.core import tm_ops as jops
    from repro_torch.core import tm_ops as tops
    x = np.random.RandomState(8).rand(6, 8, 4).astype(np.float32)
    call = _tm_ops_calls()[name]
    assert_same(call(jops, jnp.asarray(x)), call(tops, torch.tensor(x)),
                what=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_bilinear_matches_within_float_rounding(dtype):
    """Both compute the weights in f32 and lerp at the promoted dtype; the
    order of the two lerps is the same, so they agree to a few ulps."""
    from repro.core import tm_ops as jops
    from repro_torch.core import tm_ops as tops
    x = jnp.asarray(np.random.RandomState(9).rand(2, 6, 9, 3)
                    .astype(np.float32)).astype(dtype)
    ref = jops.resize_bilinear(x, 11, 5)
    got = tops.resize_bilinear(to_torch(x), 11, 5)
    assert str(got.dtype) == f"torch.{ref.dtype}"
    assert_same(ref, got, atol=1e-5 if dtype == "float32" else 1e-2)


def test_bboxcal_and_nms_match():
    from repro.core import tm_ops as jops
    from repro_torch.core import tm_ops as tops
    rng = np.random.RandomState(10)
    pred = rng.rand(40, 7).astype(np.float32)
    for r, g in zip(jops.bboxcal(jnp.asarray(pred), 0.5, 12),
                    tops.bboxcal(torch.tensor(pred), 0.5, 12)):
        assert_same(r, g)
    assert_same(jops.bboxcal_rows(jnp.asarray(pred.reshape(2, 20, 7)), 0.4, 6),
                tops.bboxcal_rows(torch.tensor(pred.reshape(2, 20, 7)), 0.4, 6))
    boxes, scores = pred[:, :4] * 10, pred[:, 4]
    for r, g in zip(jops.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3, 8),
                    tops.nms(torch.tensor(boxes), torch.tensor(scores), 0.3, 8)):
        assert_same(r, g)
