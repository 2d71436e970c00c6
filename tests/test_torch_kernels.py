"""The port's kernels against the JAX package's Pallas kernels (interpret
mode) on the CPU, through the kernels' plain versions.  The kernels
themselves are held against the plain versions on the card by
tests/test_torch_gpu.py."""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import affine as jaf  # noqa: E402
from repro.kernels.rme_gather import rme_gather as jrg  # noqa: E402
from repro.kernels.tm_affine.ops import (tm_affine_call,  # noqa: E402
                                         tm_affine_ew_call)
from repro_torch.core import affine as taf  # noqa: E402
from repro_torch.kernels.rme_gather import evaluate_ref  # noqa: E402
from repro_torch.kernels.rme_gather import rme_gather as trg  # noqa: E402
from repro_torch.kernels.tm_affine import tm_affine as tta  # noqa: E402
from repro_torch.kernels.tm_affine import tm_affine_ref  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

DTYPES = ("int8", "int32", "bfloat16", "float32")
EW_OPS = (None, "add", "sub", "mul", "max")


def _arr(rng, shape, dtype, scale=100.0):
    if dtype.startswith("int"):
        return jnp.asarray(rng.randint(-99, 100, size=shape).astype(dtype))
    return jnp.asarray((rng.rand(*shape) * scale - scale / 2)
                       .astype(np.float32)).astype(dtype)


BLOCK_MAPS = {
    "transpose": lambda af: af.transpose_map((16, 24, 8)),
    "rot90": lambda af: af.rot90_map((16, 24, 8)),
    "split": lambda af: af.split_map((16, 24, 8), 2, 1),
    "flip4d": lambda af: af.flip_map((2, 8, 16, 4), (1, 3)),
    "permute4d": lambda af: af.axis_permutation_map((2, 8, 16, 4),
                                                    (2, 0, 3, 1)),
}

GATHER_MAPS = {
    "pixelshuffle": lambda af: af.pixel_shuffle_map((6, 10, 8), 2),
    "upsample": lambda af: af.upsample_map((5, 7, 3), 2),
    "rearrange": lambda af: af.rearrange_map((6, 8, 3), 1, 16),
    "img2col": lambda af: af.img2col_map((8, 9, 3), 3, 3, 2, 1, fill=-1.0),
    "reshape": lambda af: af.reshape_map((7, 7, 30), (147, 10)),
    "transpose": lambda af: af.transpose_map((5, 7, 3)),
    # a map that reads out of bounds without declaring it: the gather
    # kernels apply fill there anyway (the engine would not)
    "undeclared_oob": lambda af: dataclasses.replace(
        af.pad_map((4, 6, 2), (1, 0, 0), (0, 2, 0), fill=5.0),
        oob_possible=False),
}


@pytest.mark.parametrize("name", list(BLOCK_MAPS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ew", EW_OPS, ids=lambda e: e or "none")
def test_block_plain_matches_pallas_block(name, dtype, ew):
    jm, tm = BLOCK_MAPS[name](jaf), BLOCK_MAPS[name](taf)
    plan = tta.analyze_block_mode(tm)
    assert plan is not None
    rng = np.random.RandomState(0)
    x = _arr(rng, jm.in_shape, dtype)
    if ew is None:
        ref = tm_affine_call(x, jm, interpret=True)
        got = tta.tm_affine_block(to_torch(x), tm, plan)
    else:
        y = _arr(rng, jm.out_shape, dtype)
        ref = tm_affine_ew_call(x, y, jm, ew=ew, interpret=True)
        got = tta.tm_affine_block(to_torch(x), tm, plan, y=to_torch(y), ew=ew)
    assert str(got.dtype) == f"torch.{ref.dtype}"
    assert_same(ref, got, what=f"{name}/{dtype}/{ew}")


@pytest.mark.parametrize("name", list(GATHER_MAPS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_plain_matches_pallas_forced_gather(name, dtype):
    jm, tm = GATHER_MAPS[name](jaf), GATHER_MAPS[name](taf)
    rng = np.random.RandomState(1)
    x = _arr(rng, jm.in_shape, dtype)
    ref = tm_affine_call(x, jm, interpret=True, force_mode="gather")
    got = tta.tm_affine_gather(to_torch(x), tm)
    assert_same(ref, got, what=f"{name}/{dtype}")
    if name != "undeclared_oob":  # the engine fills only where declared
        assert_same(tm_affine_ref(to_torch(x), tm), got)
    y = _arr(rng, jm.out_shape, dtype)
    ref = tm_affine_ew_call(x, y, jm, ew="max", interpret=True,
                            force_mode="gather")
    got = tta.tm_affine_gather(to_torch(x), tm, y=to_torch(y), ew="max")
    assert_same(ref, got, what=f"{name}/{dtype}/max")


@pytest.mark.parametrize("dtype,threshold", [("float32", 0.0), ("bfloat16", 7.3),
                                             ("int32", 10.5), ("int8", 0)])
@pytest.mark.parametrize("cap", [4, 40])
def test_evaluate_plain_matches_pallas_evaluate(dtype, threshold, cap):
    rng = np.random.RandomState(2)
    x = _arr(rng, (33, 7), dtype)
    ref = jrg.evaluate(x, threshold, min(cap, 33), cmp="ge", score_index=4,
                       interpret=True)
    got = trg.evaluate(to_torch(x), threshold, min(cap, 33), cmp="ge",
                       score_index=4)
    for r, g in zip(ref, got):
        assert_same(r, g, what=dtype)
    oracle = evaluate_ref(to_torch(x), threshold, min(cap, 33), cmp="ge",
                          score_index=4)
    for o, g in zip(oracle, got):
        assert torch.equal(o, g)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cmp", ["ge", "gt", "le", "lt"])
def test_evaluate_batched_plain_matches_pallas(dtype, cmp):
    rng = np.random.RandomState(3)
    x = _arr(rng, (3, 300, 6), dtype)
    ref = jrg.evaluate_batched(x, 5.0, 16, cmp=cmp, score_index=1,
                               interpret=True)
    got = trg.evaluate_batched(to_torch(x), 5.0, 16, cmp=cmp, score_index=1)
    for r, g in zip(ref, got):
        assert_same(r, g, what=f"{dtype}/{cmp}")


def test_round_rows_is_the_kernels_round():
    """``ROUND_ROWS``, from which the card tests build their round edges and
    chip_smoke.py counts scan rounds, is ``kRound`` of csrc/rme_gather.cu:
    ``kThreads`` x ``kRows``."""
    from repro_torch.kernels import build
    src = (build.CSRC / "rme_gather.cu").read_text()

    def const(name):
        m = re.search(rf"^constexpr int {name} = (.+?);", src, re.M)
        assert m, name
        return m.group(1)

    assert const("kRound") == "kThreads * kRows"
    assert (int(const("kThreads")) * int(const("kRows"))
            == trg.ROUND_ROWS)
