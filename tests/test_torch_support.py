"""Shared helpers of the port's tests, plus the port's boundary checks: it
imports neither JAX nor the JAX package, its entry points default to the
card, and a kernel that cannot be built raises instead of falling back."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core.fp_bounds import U32, gamma  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def to_torch(a) -> "torch.Tensor":
    """A JAX or numpy array as a torch tensor with the same values (bf16
    goes through f32, which is exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(np.array(a, dtype=np.float32)).to(torch.bfloat16)
    return torch.tensor(np.array(a))


def to_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def assert_same(a, b, *, atol: float = 0.0, what: str = "") -> None:
    """Bit-exact (atol=0) or atol-bounded agreement, compared in float64."""
    x, y = to_f64(a), to_f64(b)
    assert x.shape == y.shape, (what, x.shape, y.shape)
    if atol == 0.0:
        assert np.array_equal(x, y), what
    else:
        np.testing.assert_allclose(x, y, atol=atol, rtol=0, err_msg=what)


def assert_within(got, ref: np.ndarray, bound: np.ndarray, *,
                  what: str = "") -> None:
    """Every element of ``got`` within its own ``bound`` of ``ref``."""
    g = to_f64(got)
    assert g.shape == ref.shape, (what, g.shape, ref.shape)
    over = np.abs(g - ref) - bound
    assert (over <= 0).all(), (
        f"{what}: {int((over > 0).sum())} element(s) past the bound, worst "
        f"|err| {float(np.abs(g - ref).flat[over.argmax()])} against "
        f"{float(bound.flat[over.argmax()])}")


# ---------------------------------------------------------------------------
# float64 oracles of float32 conv networks, with derived error bounds
#
# Each helper carries (value, bound): the exact result of the network's
# float32 inputs and weights, computed in float64, and an elementwise bound
# on how far ANY float32 evaluation of it can lie from that value, whatever
# order its sums take.  A float32 sum of n products lies within gamma_n *
# sum |w x| of the exact sum (Higham, Accuracy and Stability of Numerical
# Algorithms, 2002, eq. 3.5), so the bound of a conv is its sum length n =
# kh*kw*C times the conv of absolute values, plus its input's bound carried
# through |w|.  Activations are 1-Lipschitz; tanh adds its library rounding.
# ---------------------------------------------------------------------------

TANH_ULPS = 4 * U32   # a library tanh (|tanh| < 1) to within 4 ulps


def conv_f64(x: np.ndarray, w: np.ndarray, pad: int) -> np.ndarray:
    """Stride-1 conv of (B, H, W, C) by (kh, kw, C, OC), ``pad`` on every
    side, in float64."""
    B, H, W, _ = x.shape
    kh, kw, _, oc = w.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    OH, OW = H + 2 * pad - kh + 1, W + 2 * pad - kw + 1
    out = np.zeros((B, OH, OW, oc))
    for ky in range(kh):
        for kx in range(kw):
            out += np.einsum("bhwc,co->bhwo", xp[:, ky:ky + OH, kx:kx + OW],
                             w[ky, kx])
    return out


def bounded_conv(v, e, w, pad):
    w = np.asarray(w, np.float64)
    aw = np.abs(w)
    n = w.shape[0] * w.shape[1] * w.shape[2]
    return (conv_f64(v, w, pad),
            conv_f64(e, aw, pad) + gamma(n) * conv_f64(np.abs(v) + e, aw, pad))


def bounded_tanh(v, e):
    return np.tanh(v), e + TANH_ULPS


def bounded_relu(v, e):
    return np.maximum(v, 0.0), e


def bounded_scale(v, e, s):
    s = float(np.float32(s))  # a Python float meets a float32 array
    out = v * s
    return out, abs(s) * e + U32 * (np.abs(out) + abs(s) * e)


def bounded_add(v1, e1, v2, e2):
    out = v1 + v2
    return out, e1 + e2 + U32 * (np.abs(out) + e1 + e2)


def pixel_shuffle_f64(h: np.ndarray, s: int) -> np.ndarray:
    """out[y, x, c] = in[y // s, x // s, c*s*s + (y % s)*s + x % s]."""
    B, H, W, C = h.shape
    c = C // (s * s)
    return (h.reshape(B, H, W, c, s, s).transpose(0, 1, 4, 2, 5, 3)
            .reshape(B, H * s, W * s, c))


def espcn_f64(p: dict, x: np.ndarray):
    """ESPCN (SAME convs 5x5, 3x3, 3x3; tanh) -> (value, bound)."""
    v, e = x.astype(np.float64), np.zeros(x.shape)
    v, e = bounded_tanh(*bounded_conv(v, e, p["c1"], 2))
    v, e = bounded_tanh(*bounded_conv(v, e, p["c2"], 1))
    v, e = bounded_conv(v, e, p["c3"], 1)
    s = int(p["s"])
    return pixel_shuffle_f64(v, s), pixel_shuffle_f64(e, s)


def edsr_f64(p: dict, x: np.ndarray, res_scale: float = 0.1):
    """EDSR (3x3 SAME convs, ReLU, scaled residuals) -> (value, bound)."""
    h, eh = bounded_conv(x.astype(np.float64), np.zeros(x.shape), p["head"],
                         1)
    skip, eskip = h, eh
    for blk in p["blocks"]:
        r, er = bounded_relu(*bounded_conv(h, eh, blk["c1"], 1))
        r, er = bounded_scale(*bounded_conv(r, er, blk["c2"], 1), res_scale)
        h, eh = bounded_add(h, eh, r, er)
    h, eh = bounded_conv(*bounded_add(h, eh, skip, eskip), p["up"], 1)
    s = int(p["s"])
    return pixel_shuffle_f64(h, s), pixel_shuffle_f64(eh, s)


# ---------------------------------------------------------------------------
# the port's import boundary
# ---------------------------------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "profile_train.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    """No file of the port imports JAX or the JAX package, and no file of
    the package imports the benchmark that measures it (``bench``); the
    scripts at the repository's root that drive the benchmark's cells on
    the card may."""
    banned = {"jax", "jaxlib", "repro"}
    if ROOT / "src" in path.parents:
        banned.add("bench")
    assert not _imported_roots(path) & banned, (path,
                                                _imported_roots(path) & banned)


def test_h100_bound_and_the_dry_run_read_one_set_of_peaks(monkeypatch):
    """``h100.bound_ms`` gives bytes over 3.35e12 B/s, f32 operations over
    67e12 and bf16 operations over 989e12 FLOP/s, the largest with what
    sets it (bytes on a tie); the dry-run's roofline terms are its
    counts over the same constants."""
    from repro_torch import h100
    from repro_torch.launch import dryrun
    assert h100.bound_ms(3.35e12) == (1e3, "bytes")
    assert h100.bound_ms(0, f32_ops=67e12) == (1e3, "operations")
    assert h100.bound_ms(0, bf16_ops=989e12) == (1e3, "operations")
    for args, kw, want in (((3.35e9,), dict(f32_ops=2 * 67e9), (2, "operations")),
                           ((3 * 3.35e9,), dict(f32_ops=67e9, bf16_ops=2 * 989e9),
                            (3, "bytes")),
                           ((3.35e9,), dict(f32_ops=67e9, bf16_ops=2 * 989e9),
                            (2, "operations")),
                           ((3.35e9,), dict(bf16_ops=989e9), (1, "bytes"))):
        ms, by = h100.bound_ms(*args, **kw)
        assert (ms, by) == (pytest.approx(want[0]), want[1]), (args, kw)
    assert (dryrun.BF16_FLOP_PER_S, dryrun.HBM_BYTES_PER_S) == (989e12, 3.35e12)
    assert dryrun.BF16_FLOP_PER_S is h100.BF16_FLOP_PER_S
    assert dryrun.HBM_BYTES_PER_S is h100.HBM_BYTES_PER_S

    # one product of (512, 1024) by (1024, 256) traced as a cell's step
    a, b = (torch.empty(s, device="meta") for s in ((512, 1024), (1024, 256)))
    monkeypatch.setattr(dryrun, "build_cell",
                        lambda *_, **__: (torch.mm, (a, b)))
    monkeypatch.setattr(dryrun, "model_flops", lambda *_: 1.0)
    mesh = type("Mesh", (), {"size": lambda self: 1})()
    rec = dryrun.record(None, "train_4k", mesh)
    flops, nbytes = 2 * 512 * 1024 * 256, (512 * 1024 + 1024 * 256
                                           + 512 * 256) * 4
    assert (rec["flops_per_device"], rec["bytes_per_device"]) == (flops, nbytes)
    assert rec["compute_s"] == flops / 989e12
    assert rec["memory_s"] == nbytes / 3.35e12
    assert rec["collective_s"] == 0.0
    assert rec["step_time_bound_s"] == max(flops / 989e12, nbytes / 3.35e12)


# ---------------------------------------------------------------------------
# the card by default, and no fallback that hides a missing kernel
# ---------------------------------------------------------------------------

def test_executor_defaults_to_cuda_and_raises_without_gpu(monkeypatch):
    from repro_torch.core.executor import TMExecutor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TMExecutor()
    with pytest.raises(RuntimeError, match="CUDA"):
        TMExecutor(backend="reference", device="cuda")
    assert TMExecutor(device="cpu").device == torch.device("cpu")


def test_executor_default_device_is_cuda(monkeypatch):
    from repro_torch.core.executor import TMExecutor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TMExecutor().device.type == "cuda"


def _failing_loader(name):
    raise RuntimeError(f"nvcc failed for {name}.cu")


def _kernel_calls():
    from repro_torch.core import affine as af
    from repro_torch.kernels.img2col.img2col import conv2d, img2col
    from repro_torch.kernels.resize.resize import resize_bilinear
    from repro_torch.kernels.rme_gather.rme_gather import (
        rme_assemble, rme_evaluate, rme_evaluate_chained)
    from repro_torch.kernels.tm_affine.chain import ChainSig, tm_chain
    from repro_torch.kernels.tm_affine.tm_affine import (
        analyze_block_mode, tm_affine_block, tm_affine_gather)
    mt = af.transpose_map((4, 8, 3))
    mu = af.upsample_map((4, 8, 3), 2)
    sig = ChainSig(links=((mt, None), (af.upsample_map((8, 4, 3), 2), None)))

    def pullback(x):  # the records of a chained evaluate: x reversed
        return torch.arange(95, -1, -1, dtype=torch.int32,
                            device=x.device).reshape(1, 32, 3)

    return {
        "block": lambda x: tm_affine_block(x, mt, analyze_block_mode(mt)),
        "gather": lambda x: tm_affine_gather(x, mu),
        "evaluate": lambda x: rme_evaluate(x.reshape(1, 32, 3), 0.5, 4),
        "chain": lambda x: tm_chain(sig, x),
        "evaluate_chained": lambda x: rme_evaluate_chained(
            x, pullback(x), None, 0.0, 0.5, 4),
        "assemble": lambda x: rme_assemble(x.reshape(1, 32, 3),
                                           x[..., 0].reshape(1, 32) > 0.5, 4),
        "img2col": lambda x: img2col(x, 3, 3, 1, 1, fill=2.0),
        "conv2d": lambda x: conv2d(x, torch.ones((3, 3, 3, 5),
                                                 device=x.device), 1, 1),
        "resize": lambda x: resize_bilinear(x, 7, 5),
    }


@pytest.mark.parametrize("kernel", ["block", "gather", "evaluate", "chain",
                                    "evaluate_chained", "assemble", "img2col",
                                    "conv2d", "resize"])
def test_wrapper_raises_when_kernel_build_fails(monkeypatch, kernel):
    """A non-CPU tensor goes to the kernel: when the library cannot be
    built the wrapper raises — it never returns the plain version."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "library", _failing_loader)
    call = _kernel_calls()[kernel]
    x = torch.rand(4, 8, 3)
    assert call(x) is not None  # CPU tensor: the plain version runs
    launches_before = _launch_counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call(x.to("meta"))
    assert _launch_counts() == launches_before


def test_wrapper_rejects_non_cuda_tensor_after_build(monkeypatch):
    """With a library at hand, a tensor that is neither CPU nor CUDA is
    refused by the operand checks before any launch."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "library", lambda name: object())
    for call in _kernel_calls().values():
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(torch.rand(4, 8, 3).to("meta"))


def _launch_counts():
    from repro_torch.kernels.img2col.img2col import conv2d, img2col
    from repro_torch.kernels.resize.resize import resize_bilinear
    from repro_torch.kernels.rme_gather.rme_gather import (
        rme_assemble, rme_evaluate, rme_evaluate_chained)
    from repro_torch.kernels.tm_affine.chain import tm_chain
    from repro_torch.kernels.tm_affine.tm_affine import (tm_affine_block,
                                                         tm_affine_gather)
    return (tm_affine_block.launches, tm_affine_gather.launches,
            rme_evaluate.launches, tm_chain.launches,
            rme_evaluate_chained.launches, rme_assemble.launches,
            img2col.launches, conv2d.launches, resize_bilinear.launches)


def test_build_keys_libraries_by_source_hash():
    from repro_torch.kernels import build
    assert set(build.SIGNATURES) == {p.stem for p in build.CSRC.glob("*.cu")}
    a, b = build.library_path("tm_affine"), build.library_path("rme_gather")
    assert a.parent != b.parent and a.name == "libtm_affine.so"
    # the chain kernel is its own library: editing it rebuilds only it
    assert build.library_path("tm_chain").name == "libtm_chain.so"
    assert build.BUILD_ROOT == ROOT / "build" / "repro_torch"
