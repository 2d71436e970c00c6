"""The paper's networks in the port against the JAX package, at small sizes,
with the JAX package's weights carried across (``params_from_numpy``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core.executor import TMExecutor  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import partitioned  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from tests.test_torch_support import (assert_same, assert_within,  # noqa: E402
                                      espcn_f64, to_torch)

# Conv outputs agree only to float32 rounding: XLA's and PyTorch's CPU
# convolutions sum in different orders.  Activations here stay below 1 in
# magnitude, so a few ulps of float32 (1.2e-7 each) per stacked conv stay
# far below 1e-5 absolute (measured: 2e-7 on the YOLOv3-Tiny heads).
CONV_ATOL = 1e-5


def _port(p):
    return params_from_numpy(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def yolo():
    jp = jcnn.init_yolov3_tiny(jax.random.PRNGKey(0), n_classes=3)
    img = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    j1, j2 = jcnn.yolov3_tiny(jp, jnp.asarray(img))
    model = tcnn.YOLOv3Tiny(_port(jp))
    return jp, model, img, np.asarray(j1), np.asarray(j2)


def test_params_from_numpy_copies_every_leaf_exactly():
    jp = jcnn.init_edsr(jax.random.PRNGKey(1), n_blocks=2, feats=4,
                        dtype=jnp.bfloat16)
    tp = _port(jp)
    assert tp["head"].dtype == torch.bfloat16
    assert len(tp["blocks"]) == 2 and int(tp["s"]) == 2
    assert_same(jp["blocks"][1]["c2"], tp["blocks"][1]["c2"])
    tp["head"].add_(1)  # a private, writable copy
    assert not np.array_equal(np.asarray(jp["head"], np.float32),
                              tp["head"].float().numpy())


def test_yolov3_tiny_heads_match(yolo):
    _, model, img, j1, j2 = yolo
    with torch.no_grad():
        t1, t2 = model(torch.tensor(img))
    assert t1.shape == (2, 2, 2, 24) and t2.shape == (2, 4, 4, 24)
    assert_same(j1, t1, atol=CONV_ATOL)
    assert_same(j2, t2, atol=CONV_ATOL)


@pytest.mark.parametrize("head", [0, 1])
def test_detect_tails_bit_exact_on_the_same_head(yolo, head):
    """Given the same head array, both packages pack the same boxes — the
    eager tail, and the port's executor with its kernels' plain versions."""
    pred = (yolo[3], yolo[4])[head]
    conf = float(np.median(pred.reshape(-1, 8)[:, 4]))
    ref = jcnn.detect_tail_raw(jnp.asarray(pred), conf, 16)
    got = tcnn.detect_tail_raw(torch.tensor(pred), conf, 16)
    assert_same(ref, got)
    prog = partitioned.detect_program(pred.shape[1:], conf, 16)
    ex = TMExecutor(backend="cuda", device="cpu")
    out, low, _ = ex.run(prog, {"p": torch.tensor(pred)}, batch_dims=1)
    assert low.paths() == ["cuda.gather", "cuda.rme.evaluate"]
    assert_same(ref, out["boxes"])
    ref_raw = jcnn.detect_tail(jnp.asarray(pred.reshape(2, -1, 8)), conf, 16)
    got_raw = tcnn.detect_tail(torch.tensor(pred.reshape(2, -1, 8)), conf, 16)
    assert_same(ref_raw, got_raw)


def test_partitioned_forward_equals_eager_model(yolo):
    """The hand-partitioned forward (models.partitioned, which chip_smoke.py
    drives; TM stages through the port's cuda executor, here on the CPU)
    equals the port's eager model."""
    _, model, img, _, _ = yolo
    x = torch.tensor(img)
    ex = TMExecutor(backend="cuda", device="cpu")
    with torch.no_grad():
        e1, e2, _, _ = partitioned.eager_forward(model, x)
        conf = float(e2.reshape(-1, 8)[:, 4].median())
        e1, e2, eb1, eb2 = partitioned.eager_forward(model, x, conf=conf,
                                                    capacity=16)
        p1, p2, b1, b2, paths, launches = partitioned.partitioned_forward(
            model, x, ex, conf=conf, capacity=16)
    for got, ref in ((p1, e1), (p2, e2), (b1, eb1), (b2, eb2)):
        assert torch.equal(got, ref)
    assert int((b2[..., 4] >= conf).sum()) > 0
    assert paths == partitioned.UNFUSED_PATHS == [
        "cuda.gather", "cuda.gather", "cuda.route", "cuda.gather",
        "cuda.rme.evaluate", "cuda.gather", "cuda.rme.evaluate"]
    assert launches == 8


def test_chained_partitioned_forward_equals_unfused(yolo):
    """With fuse_chains=True the neck and both detect tails each run as one
    chain (4 TM launches instead of 8), bit-exact against the unfused
    forward and the eager model."""
    _, model, img, _, _ = yolo
    x = torch.tensor(img)
    unfused = TMExecutor(backend="cuda", device="cpu")
    chained = TMExecutor(backend="cuda", device="cpu", fuse_chains=True)
    with torch.no_grad():
        conf = float(model(x)[1].reshape(-1, 8)[:, 4].median())
        eager = partitioned.eager_forward(model, x, conf=conf, capacity=16)
        ref = partitioned.partitioned_forward(model, x, unfused, conf=conf,
                                             capacity=16)
        got = partitioned.partitioned_forward(model, x, chained, conf=conf,
                                             capacity=16)
    for g, r, e in zip(got[:4], ref[:4], eager):
        assert torch.equal(g, r) and torch.equal(g, e)
    assert got[4] == partitioned.CHAINED_PATHS == [
        "cuda.gather", "cuda.chain+route", "cuda.chain+rme.evaluate",
        "cuda.chain+rme.evaluate"]
    assert (ref[5], got[5]) == (8, 4)


def test_yolo_postprocess_matches_on_the_same_head(yolo):
    pred = yolo[4]
    ref = jcnn.yolo_postprocess(jnp.asarray(pred), conf_threshold=0.0,
                                capacity=16, max_out=6)
    got = tcnn.yolo_postprocess(torch.tensor(pred), conf_threshold=0.0,
                                capacity=16, max_out=6)
    for r, g in zip(ref, got):
        assert_same(r, g)


# ESPCN's precision limit, beside its derived bound.  The derived float32
# bound is a worst case (1.3e-3 to 9.1e-3 per element here) that a network
# run with TF32-rounded conv operands still meets (7.0e-4 from the float64
# network, measured on the CPU by rounding F.conv2d's operands); bf16
# operands give 6.4e-3.  Float32 evaluations measured 6.5e-7 (PyTorch) and
# 8.1e-7 (XLA), and once 3.58e-5 (PyTorch) under the parallel test run: 1e-4
# leaves 2.8x over that worst and fails TF32 by 7x.
ESPCN_ATOL = 1e-4


def test_espcn_matches():
    """Each package's ESPCN against the float64 evaluation of the same
    network: every element within its derived float32 error bound (the sum
    lengths of the three convs, 75, 576 and 288 products, carried through
    the layers: test_torch_support.espcn_f64), and within ESPCN_ATOL, which
    a float32 network meets and one with reduced-precision convs does not;
    then the two packages within ESPCN_ATOL of each other."""
    jp = jcnn.init_espcn(jax.random.PRNGKey(2), s=2)
    x = np.random.RandomState(1).rand(2, 10, 14, 3).astype(np.float32)
    ref, bound = espcn_f64(jax.tree.map(np.asarray, jp), x)
    with torch.no_grad():
        got = tcnn.ESPCN(_port(jp))(torch.tensor(x))
    jax_out = jcnn.espcn(jp, jnp.asarray(x))
    for what, out in (("JAX ESPCN", jax_out), ("port ESPCN", got)):
        assert_within(out, ref, bound, what=what)
        assert_same(out, ref, atol=ESPCN_ATOL, what=what)
    assert_same(jax_out, got, atol=ESPCN_ATOL, what="port vs JAX ESPCN")


def test_edsr_matches():
    jp = jcnn.init_edsr(jax.random.PRNGKey(3), n_blocks=2, feats=16)
    x = np.random.RandomState(2).rand(1, 12, 10, 3).astype(np.float32)
    ref = jcnn.edsr(jp, jnp.asarray(x))
    with torch.no_grad():
        got = tcnn.EDSR(_port(jp))(torch.tensor(x))
    assert_same(ref, got, atol=CONV_ATOL)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_demo_blocks_bit_exact(dtype):
    rng = np.random.RandomState(4)
    x = rng.randint(-50, 50, size=(2, 5, 7, 8)).astype(dtype)
    skip = rng.randint(-50, 50, size=(2, 10, 14, 2)).astype(dtype)
    assert_same(jcnn.superres_tail(jnp.asarray(x), jnp.asarray(skip)),
                tcnn.superres_tail(torch.tensor(x), torch.tensor(skip)))
    u = rng.randint(-50, 50, size=(2, 4, 6, 8)).astype(dtype)
    s2 = rng.randint(-50, 50, size=(2, 8, 12, 4)).astype(dtype)
    assert_same(jcnn.yolo_neck(jnp.asarray(u), jnp.asarray(s2)),
                tcnn.yolo_neck(torch.tensor(u), torch.tensor(s2)))


def test_init_functions_take_a_generator():
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = tcnn.init_espcn(g1, s=2, device="cpu")
    b = tcnn.init_espcn(g2, s=2, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    y = tcnn.init_yolov3_tiny(torch.Generator().manual_seed(0), n_classes=3,
                              device="cpu")
    with torch.no_grad():
        p1, p2 = y(to_torch(np.zeros((1, 64, 64, 3), np.float32)))
    assert p1.shape == (1, 2, 2, 24) and p2.shape == (1, 4, 4, 24)


@pytest.mark.parametrize("stride,pad", [(1, "SAME"), (2, "SAME"),
                                        (2, "VALID")])
def test_conv2d_nhwc_hwio_matches(stride, pad):
    rng = np.random.RandomState(6)
    x = rng.rand(2, 9, 8, 5).astype(np.float32)
    w = rng.rand(3, 3, 5, 7).astype(np.float32) - 0.5
    b = rng.rand(7).astype(np.float32)
    ref = jcnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride=stride, pad=pad)
    got = tcnn.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                      stride=stride, pad=pad)
    assert_same(ref, got, atol=CONV_ATOL)
