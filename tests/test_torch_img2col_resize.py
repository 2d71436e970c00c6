"""Slice 3 of the port on the CPU (the kernels' plain versions) against the
JAX package: img2col, the implicit-GEMM conv and bilinear resize through
their entry points and dispatch rules, and the EDSR x2 forward whose convs
all go through ``conv2d_call``.

The JAX kernels run in interpret mode, as the JAX package's own tests run
them; both packages get the same numpy inputs from a seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import affine as jaf  # noqa: E402
from repro.core.executor import TMExecutor as JExecutor  # noqa: E402
from repro.core.instr import TMInstr as JInstr  # noqa: E402
from repro.core.instr import TMOpcode as JOpcode  # noqa: E402
from repro.core.instr import TMProgram as JProgram  # noqa: E402
from repro.kernels import img2col as jimg2col  # noqa: E402
from repro.kernels import resize as jresize  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core.executor import TMExecutor  # noqa: E402
from repro_torch.core.fp_bounds import bf16_ulp, conv_tol  # noqa: E402
from repro_torch.core.instr import TMProgram  # noqa: E402
from repro_torch.kernels import img2col as timg2col  # noqa: E402
from repro_torch.kernels.img2col import img2col as tkernels  # noqa: E402
from repro_torch.kernels import resize as tresize  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.partitioned import (  # noqa: E402
    edsr_partitioned_forward)
from tests.test_torch_support import (assert_same, assert_within,  # noqa: E402
                                      edsr_f64, gamma, to_f64, to_torch)

DTYPES = ("int8", "int32", "bfloat16", "float32")
# (H, W, C, k, stride, pad): tests/test_kernels.py's img2col shapes
IMG2COL_SHAPES = [(16, 16, 8, 3, 1, 1), (16, 16, 8, 3, 2, 1),
                  (8, 12, 4, 2, 2, 0), (16, 16, 3, 5, 1, 2)]


def _data(rng, shape, dtype: str, scale: float = 100.0) -> np.ndarray:
    if dtype.startswith("int"):
        return rng.randint(-99, 100, size=shape).astype(dtype)
    return (rng.rand(*shape) * scale).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, to_torch(j)


# ---------------------------------------------------------------------------
# img2col: bit-exact in every dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hwckst", IMG2COL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_img2col_call_matches_jax(hwckst, dtype):
    H, W, C, k, stride, pad = hwckst
    x = _data(np.random.RandomState(0), (H, W, C), dtype)
    jx, tx = _pair(x, dtype)
    ref = jimg2col.img2col_call(jx, kh=k, kw=k, stride=stride, pad=pad)
    got = timg2col.img2col_call(tx, kh=k, kw=k, stride=stride, pad=pad)
    assert got.dtype == tx.dtype
    assert_same(ref, got)
    assert_same(jimg2col.img2col_ref(jx, k, k, stride, pad),
                timg2col.img2col_ref(tx, k, k, stride, pad))


@pytest.mark.parametrize("dtype", DTYPES)
def test_img2col_fill_follows_the_map(dtype):
    """A map whose fill is 7 writes 7 into the padding, as the JAX
    package's reference engine does.  The JAX Pallas img2col kernel pads
    with zeros (``jnp.pad`` at src/repro/kernels/img2col/img2col.py:57)
    while its rule claims the map with any fill, so its ``pallas`` backend
    returns 0 there: the reference backend is the oracle."""
    m = jaf.img2col_map((8, 9, 3), 3, 3, 1, 1, fill=7.0)
    meta = {"img2col": {"kh": 3, "kw": 3, "stride": 1, "pad": 1}}
    prog = JProgram([JInstr(JOpcode.COARSE, ("x",), "y", map_=m, meta=meta)],
                    inputs=("x",), outputs=("y",))
    x = _data(np.random.RandomState(1), (8, 9, 3), dtype)
    jx, tx = _pair(x, dtype)
    ref = JExecutor(backend="reference")(prog, {"x": jx})["y"]
    ex = TMExecutor(backend="cuda", device="cpu")
    got = ex(TMProgram.decode(prog.encode()), {"x": tx})["y"]
    assert ex.last_lowering.paths() == ["cuda.img2col"]
    assert_same(ref, got)
    assert int((to_f64(got) == 7.0).sum()) >= 2 * 9 * 3 * 3  # the border
    assert_same(ref, timg2col.img2col_call(tx, kh=3, kw=3, stride=1, pad=1,
                                           fill=7.0))


def _img2col_variants():
    """(name, map, meta, batch_dims): the rule claims only the first."""
    good = {"kh": 3, "kw": 3, "stride": 1, "pad": 1}
    m = jaf.img2col_map((8, 9, 3), 3, 3, 1, 1)
    return [
        ("exact", m, good, 0),
        ("meta_disagrees", m, {**good, "kh": 2}, 0),
        ("batched", m, good, 1),
        ("no_meta", m, None, 0),
        ("other_map", jaf.transpose_map((8, 9, 3)), good, 0),
    ]


@pytest.mark.parametrize("variant", _img2col_variants(),
                         ids=lambda v: v[0])
def test_img2col_rule_claims_what_jax_claims(variant):
    name, m, meta, bd = variant
    meta = None if meta is None else {"img2col": meta}
    prog = JProgram([JInstr(JOpcode.COARSE, ("x",), "y", map_=m, meta=meta)],
                    inputs=("x",), outputs=("y",))
    x = _data(np.random.RandomState(2), (2,) * bd + m.in_shape, "float32")
    jx, tx = _pair(x, "float32")
    jex = JExecutor(backend="pallas")
    ref = jex(prog, {"x": jx}, batch_dims=bd)["y"]
    tex = TMExecutor(backend="cuda", device="cpu")
    got = tex(TMProgram.decode(prog.encode()), {"x": tx}, batch_dims=bd)["y"]
    assert_same(ref, got)
    want = [p.replace("pallas.", "cuda.", 1)
            for p in jex.last_lowering.paths()]
    assert tex.last_lowering.paths() == want
    assert (want == ["cuda.img2col"]) == (name == "exact")


# ---------------------------------------------------------------------------
# implicit-GEMM conv: float32 sums in another order
# ---------------------------------------------------------------------------

def conv_tolerance(x, w, stride: int, pad: int, ref) -> np.ndarray:
    """Elementwise: two float32 evaluations of the same sums of K = kh*kw*C
    products each lie within gamma_K * sum |x w| of the exact sum, so within
    twice that of each other (fp_bounds.conv_tol); in bf16 each result then
    rounds once, which adds one bf16 ulp of the output."""
    tol = conv_tol(to_torch(x), to_torch(w), stride, pad)
    if x.dtype.name == "bfloat16":
        tol = tol + bf16_ulp(to_torch(ref))
    return tol.numpy()


@pytest.mark.parametrize("stride,pad", [(1, 1), (2, 1), (2, 0), (3, 2)])
def test_conv_tol_is_the_sum_bound_of_each_output(stride, pad):
    """fp_bounds.conv_tol at any stride: every output's 2 gamma_K sum |x w|,
    each sum taken over the K = kh*kw*C products that output reads (the
    padded taps read zero)."""
    rng = np.random.RandomState(7)
    x = rng.rand(9, 8, 5) - 0.5
    w = rng.rand(3, 3, 5, 4) - 0.5
    tol = conv_tol(torch.tensor(x), torch.tensor(w), stride, pad).numpy()
    xp = np.pad(np.abs(x), ((pad, pad), (pad, pad), (0, 0)))
    OH, OW = (9 + 2 * pad - 3) // stride + 1, (8 + 2 * pad - 3) // stride + 1
    assert tol.shape == (OH, OW, 4)
    for oy in range(OH):
        for ox in range(OW):
            win = xp[oy * stride:oy * stride + 3, ox * stride:ox * stride + 3]
            mag = np.einsum("hwc,hwco->o", win, np.abs(w))
            np.testing.assert_allclose(tol[oy, ox], 2 * gamma(45) * mag,
                                       rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,stride,pad", [
    ((16, 16, 8, 16), 1, 1),   # tests/test_kernels.py's conv
    ((13, 11, 3, 7), 2, 1),    # odd sizes, strided, a 3-channel input
    ((9, 10, 5, 4), 1, 0),
])
def test_conv2d_call_matches_jax(shape, stride, pad, dtype):
    H, W, C, OC = shape
    rng = np.random.RandomState(3)
    x = rng.rand(H, W, C).astype(np.float32)
    w = (rng.rand(3, 3, C, OC) - 0.5).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    ref = jimg2col.conv2d_call(jx, jw, stride=stride, pad=pad)
    got = timg2col.conv2d_call(tx, tw, stride=stride, pad=pad)
    assert got.dtype == tx.dtype and got.shape == ref.shape
    tol = conv_tolerance(jx, jw, stride, pad, ref)
    assert_within(got, to_f64(ref), tol, what=f"conv2d {dtype}")
    ref = jimg2col.conv2d_ref(jx, jw, stride, pad)
    assert_within(timg2col.conv2d_ref(tx, tw, stride, pad), to_f64(ref),
                  conv_tolerance(jx, jw, stride, pad, ref),
                  what=f"conv2d_ref {dtype}")


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_hw", [(32, 24), (96, 100), (64, 48), (5, 7)])
def test_resize_call_matches_jax(out_hw, dtype):
    """f32 within 1e-5 absolute (values in [0, 1), taps and weights in f32
    on both sides); bf16 within one bf16 ulp of the output, where one f32
    rounding apart can flip the final rounding."""
    x = np.random.RandomState(4).rand(64, 48, 8).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ref = jresize.resize_call(jx, out_h=out_hw[0], out_w=out_hw[1])
    got = tresize.resize_call(tx, out_h=out_hw[0], out_w=out_hw[1])
    assert got.dtype == tx.dtype
    r = to_f64(ref)
    tol = 1e-5 if dtype == "float32" else bf16_ulp(
        torch.tensor(r)).numpy()
    assert_within(got, r, np.broadcast_to(tol, r.shape), what="resize")
    assert_same(jresize.resize_ref(jx, *out_hw),
                tresize.resize_ref(tx, *out_hw), atol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: EDSR x2 with every conv through conv2d_call
# ---------------------------------------------------------------------------

def test_partitioned_edsr_matches_both_models(monkeypatch):
    """The hand-partitioned EDSR x2 forward (models.partitioned: 6 convs
    per image at 2 blocks, each through ``conv2d_call``, the PixelShuffle
    through the cuda executor), the port's eager model and the JAX
    package's ``edsr``: each within the derived float32 bound of the
    float64 network (test_torch_support)."""
    jp = jcnn.init_edsr(jax.random.PRNGKey(5), n_blocks=2, feats=8)
    npp = jax.tree.map(np.asarray, jp)
    x = np.random.RandomState(6).rand(2, 9, 7, 3).astype(np.float32)
    ref, bound = edsr_f64(npp, x)
    model = tcnn.EDSR(params_from_numpy(npp))
    ex = TMExecutor(backend="cuda", device="cpu")
    plain_calls = []  # a CPU tensor reaches the conv wrapper's plain version
    plain = tkernels.conv2d_plain
    monkeypatch.setattr(tkernels, "conv2d_plain",
                        lambda *a: plain_calls.append(a) or plain(*a))
    before = tkernels.conv2d.launches  # CPU: no kernel launches
    with torch.no_grad():
        got, paths = edsr_partitioned_forward(model, torch.tensor(x), ex)
        eager = model(torch.tensor(x))
    assert len(plain_calls) == 2 * (2 + 2 * 2) and paths == ["cuda.gather"]
    assert tkernels.conv2d.launches == before
    assert float(bound.max()) < 1e-3 * max(1.0, float(np.abs(ref).max()))
    for what, out in (("partitioned", got), ("eager", eager),
                      ("jax", jcnn.edsr(jp, jnp.asarray(x)))):
        assert_within(out, ref, bound, what=f"EDSR {what}")
