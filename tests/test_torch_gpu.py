"""Each CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one.  They import neither JAX nor the JAX package, so they run on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import affine as af  # noqa: E402
from repro_torch.kernels.rme_gather import rme_gather as rg  # noqa: E402
from repro_torch.kernels.tm_affine import chain as ch  # noqa: E402
from repro_torch.kernels.tm_affine import tm_affine as ta  # noqa: E402

DTYPES = (torch.int8, torch.int32, torch.bfloat16, torch.float32)
EW_OPS = (None, "add", "sub", "mul", "max")

BLOCK_MAPS = {
    "transpose": af.transpose_map((16, 24, 8)),
    "rot90": af.rot90_map((16, 24, 8)),
    "split": af.split_map((16, 24, 8), 2, 1),
    "flip4d": af.flip_map((2, 8, 16, 4), (1, 3)),
    "permute4d": af.axis_permutation_map((2, 8, 16, 4), (2, 0, 3, 1)),
}

GATHER_MAPS = {
    "pixelshuffle": af.pixel_shuffle_map((6, 10, 8), 2),
    "upsample": af.upsample_map((5, 7, 3), 2),
    "rearrange": af.batch_extend_map(af.rearrange_map((6, 8, 3), 1, 16),
                                     (2,)),
    "rearrange_group4": af.rearrange_map((6, 8, 3), 4, 16),
    "img2col": af.img2col_map((8, 9, 3), 3, 3, 2, 1, fill=-1.0),
    "reshape": af.batch_extend_map(af.reshape_map((7, 7, 30), (147, 10)),
                                   (3,)),
    "route_band": af.route_maps([(5, 7, 2), (5, 7, 3)])[1],
    "yolo_route_band": af.batch_extend_map(
        af.route_maps([(28, 28, 128), (28, 28, 128)])[1], (2,)),
    "band_gather": af.index_select_band_maps((6, 4), 0, [5, 0, 3])[1],
    "strided_neg": af.strided_slice_map((9, 5), (8, 4), (-3, -2), (3, 3)),
    # a numerator past 2^31 takes the kernel's 64-bit path
    "wide_rows": af.MixedRadixMap(
        out_shape=(4, 6), in_shape=(4, 6), splits=(),
        affine=af.AffineMap.make([[1, 0], [2 ** 33, 1]]), oob_possible=True,
        fill=-3.0),
    "undeclared_oob": dataclasses.replace(
        af.pad_map((4, 6, 2), (1, 0, 0), (0, 2, 0), fill=5.0),
        oob_possible=False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(rng, shape, dtype, device):
    if dtype.is_floating_point:
        a = torch.tensor((rng.rand(*shape) * 200 - 100).astype(np.float32))
    else:
        a = torch.tensor(rng.randint(-99, 100, size=shape).astype(np.int32))
    return a.to(dtype).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BLOCK_MAPS))
def test_block_kernel_matches_plain_on_card(cuda, name):
    rng = np.random.RandomState(4)
    m = BLOCK_MAPS[name]
    plan = ta.analyze_block_mode(m)
    assert plan is not None
    for dtype in DTYPES:
        for ew in EW_OPS:
            x = _rand(rng, m.in_shape, dtype, cuda)
            y = None if ew is None else _rand(rng, m.out_shape, dtype, cuda)
            before = ta.tm_affine_block.launches
            got = ta.tm_affine_block(x, m, plan, y=y, ew=ew)
            ref = ta.block_plain(x, m, plan, y=y, ew=ew)
            torch.cuda.synchronize()
            assert ta.tm_affine_block.launches == before + 1
            assert torch.equal(got, ref), (name, dtype, ew)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GATHER_MAPS))
def test_gather_kernel_matches_plain_on_card(cuda, name):
    rng = np.random.RandomState(5)
    m = GATHER_MAPS[name]
    for dtype in DTYPES:
        for ew in EW_OPS:
            x = _rand(rng, m.in_shape, dtype, cuda)
            y = None if ew is None else _rand(rng, m.out_shape, dtype, cuda)
            got = ta.tm_affine_gather(x, m, y=y, ew=ew)
            ref = ta.gather_plain(x, m, y=y, ew=ew)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (name, dtype, ew)


@pytest.mark.gpu
def test_empty_output_launches_nothing_on_card(cuda):
    counts = lambda: (ta.tm_affine_block.launches,  # noqa: E731
                      ta.tm_affine_gather.launches, rg.rme_evaluate.launches,
                      ch.tm_chain.launches, rg.rme_evaluate_chained.launches,
                      rg.rme_assemble.launches)
    before = counts()
    m = af.transpose_map((0, 4, 2))
    sig = ch.ChainSig(links=((m, None), (af.transpose_map((4, 0, 2)), None)))
    out = ch.tm_chain(sig, torch.zeros(m.in_shape, device=cuda))
    assert out.shape == (0, 4, 2)
    idx = torch.zeros((0, 9, 5), dtype=torch.int32, device=cuda)
    rows, _, _ = rg.rme_evaluate_chained(torch.zeros(4, device=cuda), idx,
                                         None, 0.0, 0.5, 4)
    assert rows.shape == (0, 4, 5)
    rows, _ = rg.rme_assemble(torch.zeros((0, 9, 5), device=cuda),
                              torch.zeros((0, 9), dtype=torch.bool,
                                          device=cuda), 4)
    assert rows.shape == (0, 4, 5)
    m = af.transpose_map((0, 4, 2))
    out = ta.tm_affine_block(torch.zeros(m.in_shape, device=cuda), m,
                             ta.analyze_block_mode(m))
    assert out.shape == (4, 0, 2)
    m = af.upsample_map((0, 3, 2), 2)
    out = ta.tm_affine_gather(torch.zeros(m.in_shape, device=cuda), m)
    assert out.shape == (0, 6, 2)
    rows, _, _ = rg.rme_evaluate(torch.zeros((0, 9, 5), device=cuda), 0.5, 4)
    assert rows.shape == (0, 4, 5)
    assert counts() == before


@pytest.mark.gpu
def test_quarantine_is_refused_on_card(cuda):
    from repro_torch.core import dispatch
    from repro_torch.core.executor import TMExecutor
    from repro_torch.core.instr import TMInstr, TMOpcode
    with pytest.raises(ValueError, match="quarantine"):
        TMExecutor(backend="cuda", device=cuda, quarantine=set())
    ins = TMInstr(TMOpcode.COARSE, ("x",), "y",
                  map_=af.transpose_map((4, 6, 2)))
    before = ta.tm_affine_block.launches
    with pytest.raises(ValueError, match="quarantine"):
        dispatch.lower_instr(ins, [torch.zeros((4, 6, 2), device=cuda)], 0,
                             quarantine=set())
    assert ta.tm_affine_block.launches == before


@pytest.mark.gpu
def test_max_epilogue_propagates_nan_on_card(cuda):
    m = af.identity_map((4, 64))
    plan = ta.analyze_block_mode(m)
    x = torch.zeros((4, 64), device=cuda)
    y = torch.zeros((4, 64), device=cuda)
    x[0, 3] = float("nan")
    y[1, 5] = float("nan")
    for out in (ta.tm_affine_block(x, m, plan, y=y, ew="max"),
                ta.tm_affine_gather(x, m, y=y, ew="max")):
        assert torch.isnan(out[0, 3]) and torch.isnan(out[1, 5])
        assert int(torch.isnan(out).sum()) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,thr", [(torch.float32, 20.0),
                                       (torch.bfloat16, 7.3),
                                       (torch.int32, 10.5), (torch.int8, 3)])
def test_evaluate_kernel_matches_plain_on_card(cuda, dtype, thr):
    rng = np.random.RandomState(6)
    for cmp in ("ge", "gt", "le", "lt"):
        for B, N, D, cap in ((1, 33, 7, 8), (3, 3136, 85, 256),
                             (2, 700, 5, 1000), (2, 40, 6, 0)):
            x = _rand(rng, (B, N, D), dtype, cuda)
            got = rg.rme_evaluate(x, thr, cap, cmp=cmp, score_index=4)
            ref = rg.evaluate_plain(x, thr, cap, cmp=cmp, score_index=4)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert torch.equal(g, r), (dtype, cmp, B, N, D, cap)


# ---------------------------------------------------------------------------
# slice 2: the chain megakernel, the chained evaluate and assemble
# ---------------------------------------------------------------------------

def _chain3():
    m1 = af.transpose_map((8, 12, 16))
    m2 = af.split_map((12, 8, 16), 2, 1)
    m3 = af.transpose_map((12, 8, 8))
    return ch.ChainSig(links=((m1, None), (m2, None), (m3, None)))


def _superres(ew):
    ps = af.pixel_shuffle_map((6, 10, 8), 2)
    crop = af.pad_map((12, 20, 2), (-1, -1, 0), (-1, -1, 0), fill=-5.0)
    pad = af.pad_map((10, 18, 2), (1, 2, 0), (2, 1, 0), fill=3.0)
    return ch.ChainSig(links=((ps, ew), (crop, None), (pad, None)))


def _route():
    up = af.batch_extend_map(af.upsample_map((5, 7, 3), 2), (2,))
    maps = tuple(af.batch_extend_map(m, (2,))
                 for m in af.route_maps([(10, 14, 3), (10, 14, 5)]))
    return ch.ChainSig(links=((up, None),), route_maps=maps, route_band=0)


def _two_epilogues(ew):
    # pixel shuffle + ew, then crop fused with an identity + ew: two levels
    # that each round to the working dtype
    ps = af.pixel_shuffle_map((6, 10, 8), 2)
    crop = af.pad_map((12, 20, 2), (-1, -1, 0), (-1, -1, 0))
    return ch.ChainSig(links=((ps, ew), (crop, None),
                              (af.identity_map((10, 18, 2)), "mul")))


CHAIN_SIGS = {
    "chain3": lambda ew: _chain3(),
    "superres": _superres,
    "route": lambda ew: _route(),
    "two_epilogues": _two_epilogues,
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CHAIN_SIGS))
def test_chain_kernel_matches_plain_on_card(cuda, name):
    rng = np.random.RandomState(7)
    for dtype in DTYPES:
        for ew in EW_OPS[1:]:
            sig = dataclasses.replace(CHAIN_SIGS[name](ew),
                                      dtype=str(dtype)[len("torch."):])
            plan = ch.chain_plan_of(sig)
            x = _rand(rng, sig.links[0][0].in_shape, dtype, cuda)
            slabs = tuple(_rand(rng, shape, dtype, cuda)
                          for shape in ch._slab_shapes(sig))
            before = ch.tm_chain.launches
            got = ch.tm_chain(sig, x, slabs)
            ref = ch.chain_plain(x, plan, slabs)
            torch.cuda.synchronize()
            assert ch.tm_chain.launches == before + 1
            assert torch.equal(got, ref), (name, dtype, ew)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,thr", [(torch.float32, 20.0),
                                       (torch.bfloat16, 7.3),
                                       (torch.int32, 10.5), (torch.int8, 3)])
def test_chained_evaluate_kernel_matches_plain_on_card(cuda, dtype, thr):
    """Streams pulled back through a pad (fill 25, which passes some
    thresholds: the test must see the filled value) and a reshape, with and
    without the validity mask, over every compare and edge capacities."""
    rng = np.random.RandomState(8)
    pad = af.pad_map((3, 40, 7), (0, 2, 0), (0, 3, 0), fill=25.0)
    for maps in ((af.reshape_map((3, 315), (3, 45, 7)),),
                 (pad, af.reshape_map((3, 45, 7), (3, 45, 7)))):
        j, ok, fill = ch.fold_pullback(maps)
        shape = maps[-1].out_shape
        idx = torch.from_numpy(j.reshape(shape)).to(cuda)
        okt = None if ok is None else torch.from_numpy(
            ok.reshape(shape)).to(cuda)
        x = _rand(rng, maps[0].in_shape, dtype, cuda)
        for cmp in ("ge", "gt", "le", "lt"):
            for cap in (0, 8, 45, 100):
                before = rg.rme_evaluate_chained.launches
                got = rg.rme_evaluate_chained(x, idx, okt, fill, thr, cap,
                                              cmp=cmp, score_index=4)
                ref = rg.evaluate_chained_plain(x, idx, okt, fill, thr, cap,
                                                cmp=cmp, score_index=4)
                torch.cuda.synchronize()
                assert rg.rme_evaluate_chained.launches == before + 1
                for g, r in zip(got, ref):
                    assert torch.equal(g, r), (dtype, cmp, cap, okt is None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_assemble_kernel_matches_plain_on_card(cuda, dtype):
    rng = np.random.RandomState(9)
    for B, N, D in ((1, 33, 7), (3, 2352, 85), (2, 700, 5)):
        x = _rand(rng, (B, N, D), dtype, cuda)
        for kind in ("bool", "int32", "none"):
            if kind == "none":
                mask = torch.zeros((B, N), dtype=torch.bool, device=cuda)
            else:
                mask = torch.tensor(rng.rand(B, N) < 0.3, device=cuda)
                if kind == "int32":
                    mask = mask.to(torch.int32) * 7
            for cap in (0, 16, 256, N + 5):
                before = rg.rme_assemble.launches
                got = rg.rme_assemble(x, mask, cap)
                ref = rg.assemble_plain(x, mask, cap)
                torch.cuda.synchronize()
                assert rg.rme_assemble.launches == before + 1
                for g, r in zip(got, ref):
                    assert torch.equal(g, r), (dtype, B, N, kind, cap)


# ---------------------------------------------------------------------------
# slice 3: img2col, the implicit-GEMM conv and bilinear resize
# ---------------------------------------------------------------------------

# (H, W, C, kh, kw, stride, pad): aligned and odd channel counts (copy units
# of 16 down to 1 byte), non-square windows, padding wider than the window
IMG2COL_CASES = [(16, 16, 8, 3, 3, 1, 1), (13, 11, 3, 3, 3, 2, 1),
                 (8, 12, 4, 2, 2, 2, 0), (9, 7, 5, 5, 3, 1, 2),
                 (6, 10, 64, 3, 3, 1, 0), (5, 6, 1, 2, 2, 1, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", IMG2COL_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_img2col_kernel_matches_plain_on_card(cuda, case):
    from repro_torch.kernels.img2col import img2col as ik
    H, W, C, kh, kw, stride, pad = case
    rng = np.random.RandomState(10)
    for dtype in DTYPES:
        for fill in (0.0, 7.0, -3.5):
            x = _rand(rng, (H, W, C), dtype, cuda)
            # the same values one element off the allocation's alignment
            shifted = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
            shifted[1:] = x.reshape(-1)
            for xin in (x, shifted[1:].view(H, W, C)):
                before = ik.img2col.launches
                got = ik.img2col(xin, kh, kw, stride, pad, fill)
                ref = ik.img2col_plain(xin, kh, kw, stride, pad, fill)
                torch.cuda.synchronize()
                assert ik.img2col.launches == before + 1
                assert torch.equal(got, ref), (case, dtype, fill)


@pytest.mark.gpu
def test_img2col_wide_index_path_on_card(cuda, monkeypatch):
    """The 64-bit index instantiation, forced on small shapes."""
    from repro_torch.kernels.img2col import img2col as ik
    monkeypatch.setattr(ik, "_NARROW", 0)
    rng = np.random.RandomState(11)
    for H, W, C, kh, kw, stride, pad in IMG2COL_CASES[:4]:
        for dtype in DTYPES:
            x = _rand(rng, (H, W, C), dtype, cuda)
            got = ik.img2col(x, kh, kw, stride, pad, 5.0)
            torch.cuda.synchronize()
            assert torch.equal(got, ik.img2col_plain(x, kh, kw, stride, pad,
                                                     5.0))


# (H, W, C, OC, k, stride, pad): several row and column tiles, K not a
# multiple of the tile depth, a 3-channel input, a 1x1 conv
CONV_CASES = [(16, 16, 8, 16, 3, 1, 1), (13, 11, 3, 7, 3, 2, 1),
              (9, 10, 5, 70, 3, 1, 0), (20, 30, 64, 64, 3, 1, 1),
              (7, 5, 130, 12, 1, 1, 0), (17, 9, 6, 5, 5, 2, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_conv2d_kernel_matches_plain_on_card(cuda, case):
    """Within 2 gamma_K sum |x w| of the plain f32 product (each f32 sum of
    K products lies within gamma_K sum |x w| of the exact one), plus one
    bf16 ulp of the output in bf16."""
    from repro_torch.core.fp_bounds import bf16_ulp, conv_tol
    from repro_torch.kernels.img2col import img2col as ik
    H, W, C, OC, k, stride, pad = case
    gen = torch.Generator().manual_seed(12)
    x = torch.rand((H, W, C), generator=gen).to(cuda)
    w = (torch.rand((k, k, C, OC), generator=gen) - 0.5).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dtype), w.to(dtype)
        before = ik.conv2d.launches
        got = ik.conv2d(xd, wd, stride, pad)
        ref = ik.conv2d_plain(xd, wd, stride, pad)
        torch.cuda.synchronize()
        assert ik.conv2d.launches == before + 1
        assert got.shape == ref.shape and got.dtype == dtype
        tol = conv_tol(xd, wd, stride, pad)
        if dtype == torch.bfloat16:
            tol = tol + bf16_ulp(ref)
        err = (got.double() - ref.double()).abs()
        assert bool((err <= tol).all()), (case, dtype, float(err.max()))


@pytest.mark.gpu
def test_resize_kernel_matches_plain_on_card(cuda):
    """Bit-exact: the kernel does the plain version's f32 operations in its
    order, with no contraction into FMAs."""
    from repro_torch.kernels.resize import resize as rk
    rng = np.random.RandomState(13)
    for (H, W, C), outs in (((64, 48, 8), ((32, 24), (96, 100), (5, 7),
                                           (1, 1))),
                            ((7, 9, 3), ((7, 9), (20, 3))),
                            ((1, 5, 2), ((4, 3),))):
        for dtype in DTYPES:
            x = _rand(rng, (H, W, C), dtype, cuda)
            for out_h, out_w in outs:
                before = rk.resize_bilinear.launches
                got = rk.resize_bilinear(x, out_h, out_w)
                ref = rk.resize_plain(x, out_h, out_w)
                torch.cuda.synchronize()
                assert rk.resize_bilinear.launches == before + 1
                assert torch.equal(got, ref), ((H, W, C), dtype, out_h, out_w)


@pytest.mark.gpu
def test_slice3_empty_output_launches_nothing_on_card(cuda):
    from repro_torch.kernels.img2col import img2col as ik
    from repro_torch.kernels.resize import resize as rk
    counts = lambda: (ik.img2col.launches, ik.conv2d.launches,  # noqa: E731
                      rk.resize_bilinear.launches)
    before = counts()
    x = torch.zeros((2, 5, 3), device=cuda)
    assert ik.img2col(x, 3, 3).shape == (0, 27)
    assert ik.conv2d(x, torch.zeros((3, 3, 3, 4), device=cuda)).shape == (
        0, 3, 4)
    assert rk.resize_bilinear(x, 0, 4).shape == (0, 4, 3)
    assert counts() == before


# ---------------------------------------------------------------------------
# slice 4: matmul_tm, the xchain commit and prologue kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def full_f32(monkeypatch):
    """cuDNN's convolutions in full f32: the plain xchain versions call the
    conv custom op, which takes TF32 where cuDNN's default allows it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _operand(rng, shape, dtype, device):
    """Floats in [-1, 1); integers in [-99, 100), whose int8 products
    overflow, so the wrapped sums are exercised."""
    if dtype.is_floating_point:
        a = torch.tensor((rng.rand(*shape) * 2 - 1).astype(np.float32))
    else:
        a = torch.tensor(rng.randint(-99, 100, size=shape).astype(np.int32))
    return a.to(dtype).to(device)


def _require_product(got, ref, x, w, dtype, what):
    """Integers bit-exact; floats within 2 gamma_K sum |x w| (each f32 sum
    of K products within gamma_K sum |x w| of the exact one) of the plain
    version, bf16 one more ulp of the output."""
    from repro_torch.core.fp_bounds import bf16_ulp, gamma
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    if not dtype.is_floating_point:
        assert torch.equal(got, ref), what
        return
    mag = x.double().abs() @ w.double().abs()
    tol = 2 * gamma(x.shape[1]) * float(mag.max())
    if dtype == torch.bfloat16:
        tol = tol + bf16_ulp(ref)
    err = (got.double() - ref.double()).abs()
    assert bool((err <= tol).all()), (what, float(err.max()))


# (M, K, N): ragged tiles in every direction, K below and above the step
MM_CASES = [(7, 9, 5), (64, 16, 64), (130, 33, 70), (33, 200, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MM_CASES, ids=lambda c: "x".join(map(str, c)))
def test_matmul_tm_kernel_matches_plain_on_card(cuda, case):
    from repro_torch.kernels.matmul_tm import matmul_tm as mk
    M, K, N = case
    rng = np.random.RandomState(20)
    eps = [mk.Epilogue(), mk.Epilogue("transpose"),
           mk.Epilogue(col0=N // 2, ncols=N - N // 2)]
    for dtype in DTYPES:
        x, w = _operand(rng, (M, K), dtype, cuda), \
            _operand(rng, (K, N), dtype, cuda)
        for ep in eps:
            before = mk.matmul_tm.launches
            got = mk.matmul_tm(x, w, ep)
            ref = mk.matmul_tm_plain(x, w, ep)
            torch.cuda.synchronize()
            assert mk.matmul_tm.launches == before + 1
            wb = w[:, ep.col0:ep.col0 + (ep.ncols or N)]
            if ep.mode == "transpose":
                got, ref = got.T, ref.T
            _require_product(got, ref, x, wb, dtype, (case, dtype, ep))


@pytest.mark.gpu
def test_matmul_pixel_shuffle_kernel_matches_plain_on_card(cuda):
    from repro_torch.kernels.matmul_tm import matmul_tm as mk
    rng = np.random.RandomState(21)
    for H, W, C, s, K in ((5, 7, 3, 3, 20), (4, 9, 2, 2, 16)):
        ep = mk.Epilogue("pixel_shuffle", H, W, C, s)
        for dtype in DTYPES:
            x = _operand(rng, (H * W, K), dtype, cuda)
            w = _operand(rng, (K, C * s * s), dtype, cuda)
            got = mk.matmul_tm(x, w, ep)
            ref = mk.matmul_tm_plain(x, w, ep)
            torch.cuda.synchronize()
            # undo the shuffle on both: the rows of the product
            flat = lambda t: (t.reshape(H, s, W, s, C)  # noqa: E731
                              .permute(0, 2, 4, 1, 3).reshape(H * W, -1))
            _require_product(flat(got), flat(ref), x, w, dtype,
                             (H, W, C, s, dtype))


def _xchain_cases():
    """(name, Gemm, chain builder) for both directions: the chain's maps
    from the op's output (commit) or onto its operand (prologue)."""
    from repro_torch.kernels.matmul_tm.chain import Gemm
    return {
        # compute -> TM
        "mm_transpose": (Gemm("mm", (24, 16), (16, 40)), "commit",
                         lambda y: [(af.axis_permutation_map(y, (1, 0)),
                                     None)]),
        "mm_pad_fill": (Gemm("mm", (7, 9), (9, 5)), "commit",
                        lambda y: [(af.pad_map(y, (1, 2), (1, 0),
                                               fill=3.0), None)]),
        "conv_pixelshuffle": (Gemm("conv", (1, 6, 7, 8), (3, 3, 8, 18), 1,
                                   "SAME"), "commit",
                              lambda y: [(af.batch_extend_map(
                                  af.pixel_shuffle_map(y[1:], 3), (1,)),
                                  None)]),
        "conv_stride2_valid": (Gemm("conv", (2, 9, 8, 3), (3, 3, 3, 5), 2,
                                    "VALID"), "commit",
                               lambda y: [(af.flip_map(y, (1, 2)), None)]),
        # TM -> compute
        "transpose_mm": (Gemm("mm", (9, 7), (7, 5)), "prologue_a",
                         lambda a: [(af.axis_permutation_map(
                             (a[1], a[0]), (1, 0)), None)]),
        "pad_mm": (Gemm("mm", (6, 11), (11, 9)), "prologue_a",
                   lambda a: [(af.pad_map((a[0], a[1] - 2), (0, 1), (0, 1),
                                          fill=-2.0), None)]),
        "mm_weight_chain": (Gemm("mm", (5, 12), (12, 6)), "prologue_b",
                            lambda b: [(af.axis_permutation_map(
                                (b[1], b[0]), (1, 0)), None)]),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_xchain_cases()))
def test_xchain_kernels_match_plain_on_card(cuda, full_f32, name):
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.tm_affine.chain import ChainSig
    g, kind, links = _xchain_cases()[name]
    rng = np.random.RandomState(22)
    for dtype in DTYPES:
        dt = str(dtype).removeprefix("torch.")
        x = _operand(rng, g.x_shape, dtype, cuda)
        w = _operand(rng, g.w_shape, dtype, cuda)
        if kind == "commit":
            sig = ChainSig(links=tuple(links(g.out_shape)), dtype=dt)
            before = xc.xchain_commit.launches
            got = xc.xchain_commit(sig, g, x, w)
            ref = xc.xchain_commit_plain(sig, g, x, w)
            n_launch = xc.xchain_commit.launches - before
        else:
            pos = 0 if kind == "prologue_a" else 1
            target = (g.x_shape, g.w_shape)[pos]
            sig = ChainSig(links=tuple(links(target)), dtype=dt)
            src = _operand(rng, sig.links[0][0].in_shape, dtype, cuda)
            other = (w, x)[pos]
            before = xc.xchain_prologue.launches
            got = xc.xchain_prologue(sig, g, pos, src, other)
            ref = xc.xchain_prologue_plain(sig, g, pos, src, other)
            n_launch = xc.xchain_prologue.launches - before
        torch.cuda.synchronize()
        assert n_launch == 1
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if not dtype.is_floating_point:
            assert torch.equal(got, ref), (name, dtype)
            continue
        from repro_torch.core.fp_bounds import bf16_ulp, gamma
        K = g.words()[3]
        # |values| < 1 (and fills <= 3), so sum |A B| <= 3 K
        tol = 2 * gamma(K) * 3 * K
        if dtype == torch.bfloat16:
            tol = tol + bf16_ulp(ref)
        err = (got.double() - ref.double()).abs()
        assert bool((err <= tol).all()), (name, dtype, float(err.max()))


@pytest.mark.gpu
def test_xchain_with_route_extra_and_epilogue_on_card(cuda, full_f32):
    """Commit through an upsample into a Route band (one extra band), and a
    prologue whose chain carries an element-wise epilogue operand."""
    from repro_torch.core.fp_bounds import bf16_ulp, gamma
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.tm_affine.chain import ChainSig
    rng = np.random.RandomState(23)
    g = xc.Gemm("conv", (2, 4, 5, 6), (1, 1, 6, 4), 1, "SAME")
    up = af.batch_extend_map(af.upsample_map((4, 5, 4), 2), (2,))
    route = tuple(af.batch_extend_map(m, (2,)) for m in
                  af.route_maps([(8, 10, 4), (8, 10, 3)]))
    g2 = xc.Gemm("mm", (6, 8), (8, 5))
    tr = af.axis_permutation_map((8, 6), (1, 0))
    for dtype in DTYPES:
        dt = str(dtype).removeprefix("torch.")
        sig = ChainSig(links=((up, None),), route_maps=route, route_band=0,
                       dtype=dt)
        skip = _operand(rng, route[1].in_shape, dtype, cuda)
        x = _operand(rng, g.x_shape, dtype, cuda)
        w = _operand(rng, g.w_shape, dtype, cuda)
        got = xc.xchain_commit(sig, g, x, w, (skip,))
        ref = xc.xchain_commit_plain(sig, g, x, w, (skip,))
        torch.cuda.synchronize()
        if not dtype.is_floating_point:
            assert torch.equal(got, ref), dtype
        else:
            # |x|, |w| < 1 over K = 6 products
            tol = 2 * gamma(6) * 6 + (bf16_ulp(ref) if dtype ==
                                      torch.bfloat16 else 0)
            assert bool(((got.double() - ref.double()).abs() <= tol).all())
        sig2 = ChainSig(links=((tr, "add"),), dtype=dt)
        src = _operand(rng, (8, 6), dtype, cuda)
        y = _operand(rng, (6, 8), dtype, cuda)
        w2 = _operand(rng, g2.w_shape, dtype, cuda)
        got = xc.xchain_prologue(sig2, g2, 0, src, w2, (y,))
        ref = xc.xchain_prologue_plain(sig2, g2, 0, src, w2, (y,))
        torch.cuda.synchronize()
        if not dtype.is_floating_point:
            assert torch.equal(got, ref), dtype
        else:
            # chain values below 2 in magnitude, |w| < 1, K = 8
            tol = 2 * gamma(8) * 16 + (bf16_ulp(ref) if dtype ==
                                       torch.bfloat16 else 0)
            assert bool(((got.double() - ref.double()).abs() <= tol).all())


@pytest.mark.gpu
def test_slice4_build_failure_raises_and_counts_nothing_on_card(cuda,
                                                                 monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.matmul_tm import matmul_tm as mk
    from repro_torch.kernels.tm_affine.chain import ChainSig

    def fail(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(build, "library", fail)
    x = torch.rand((4, 6), device=cuda)
    w = torch.rand((6, 3), device=cuda)
    g = xc.Gemm("mm", (4, 6), (6, 3))
    sig = ChainSig(links=((af.axis_permutation_map((4, 3), (1, 0)), None),))
    counts = lambda: (mk.matmul_tm.launches,  # noqa: E731
                      xc.xchain_commit.launches, xc.xchain_prologue.launches)
    before = counts()
    for call in (lambda: mk.matmul_tm(x, w),
                 lambda: xc.xchain_commit(sig, g, x, w),
                 lambda: xc.xchain_prologue(
                     ChainSig(links=((af.axis_permutation_map((6, 4), (1, 0)),
                                      None),)), g, 0, x.T.contiguous(), w)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    assert counts() == before


# ---------------------------------------------------------------------------
# slice 5: flash attention and flash decode
# ---------------------------------------------------------------------------

FLASH_SHAPES = ((100, 100, True), (70, 130, True), (130, 70, True),
                (100, 100, False), (1, 33, True))  # (S, Sk, causal), ragged


def _qkv(rng, B, S, Sk, H, KV, D, dtype, device):
    mk = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32)  # noqa: E731
                                 ).to(dtype).to(device)
    return mk(B, S, H, D), mk(B, Sk, KV, D), mk(B, Sk, KV, D)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(cuda, full_f32, dtype,
                                                      D, G):
    """Within fp_bounds.attention_tol of the plain version: the derived
    bound on two evaluations in other orders (in bf16 with the kernel's p
    rounded to bf16 and both outputs' rounding)."""
    from repro_torch.core.fp_bounds import attention_tol
    from repro_torch.kernels.flash_attention import flash_attention as fa
    rng = np.random.RandomState(D + G)
    for S, Sk, causal in FLASH_SHAPES:
        q, k, v = _qkv(rng, 2, S, Sk, 2 * G, 2, D, dtype, cuda)
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, causal=causal)
        ref = fa.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        tol = attention_tol(q, k, v, causal=causal)
        err = (got.double() - ref.double()).abs()
        assert bool((err <= tol).all()), (S, Sk, causal, float(err.max()))
    # the Pallas layout (BH, S, D) and a strided v (a view of a fused tensor)
    qkv = torch.randn((3, 77, 3, D), device=cuda).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = fa.flash_attention(q, k, v)
    ref = fa.attention_ref(q, k, v)
    assert bool(((got.double() - ref.double()).abs()
                 <= attention_tol(q, k, v)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain_on_card(cuda, full_f32, dtype, D,
                                                   G):
    """Cache rows < length only; length <= 0 gives the mean of all rows of
    v, as the Pallas kernel does.  Tolerance: fp_bounds.attention_tol."""
    from repro_torch.core.fp_bounds import attention_tol
    from repro_torch.kernels.flash_attention import flash_attention as fa
    rng = np.random.RandomState(2 * D + G)
    T = 100
    q, k, v = _qkv(rng, 2, 1, T, 2 * G, 2, D, dtype, cuda)
    for length in (0, -3, 1, 37, T, T + 5):
        before = fa.flash_decode.launches
        got = fa.flash_decode(q, k, v, length)
        dev_len = fa.flash_decode(q, k, v, torch.tensor(
            [length], dtype=torch.int32, device=cuda))
        ref = fa.decode_ref(q, k, v, length)
        torch.cuda.synchronize()
        assert fa.flash_decode.launches == before + 2
        assert torch.equal(got, dev_len)
        tol = attention_tol(q, k, v, causal=False, length=length)
        err = (got.double() - ref.double()).abs()
        assert bool((err <= tol).all()), (length, float(err.max()))
        if length <= 0:
            mean = v.double().mean(dim=1, keepdim=True).repeat_interleave(
                G, dim=2)
            assert bool(((got.double() - mean).abs() <= tol).all())
    got = fa.flash_decode(q[:, :, 0], k[:, :, 0], v[:, :, 0], 9)  # Pallas
    ref = fa.decode_ref(q[:, :, 0], k[:, :, 0], v[:, :, 0], 9)
    assert bool(((got.double() - ref.double()).abs() <= attention_tol(
        q[:, :, 0], k[:, :, 0], v[:, :, 0], causal=False, length=9)).all())


@pytest.mark.gpu
def test_flash_kernels_refuse_what_they_do_not_take_on_card(cuda):
    """An unsupported head dim, mixed dtypes or a misaligned cache raise;
    nothing falls back to the plain version, nothing is counted."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    before = (fa.flash_attention.launches, fa.flash_decode.launches)
    for D in (12, 264):
        x = torch.rand((1, 8, 2, D), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention(x, x, x)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_decode(x[:, :1], x, x, 4)
    x = torch.rand((1, 8, 2, 16), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(x, x.to(torch.bfloat16), x)
    odd = torch.rand((1, 8 * 2 * 16 + 1), device=cuda)[:, 1:].reshape(
        1, 8, 2, 16)  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_decode(x[:, :1], odd, odd, 4)
    assert (fa.flash_attention.launches, fa.flash_decode.launches) == before


@pytest.mark.gpu
def test_slice5_serve_launch_counts_on_card(cuda):
    """phi4-mini's smoke config through serve on the card: one
    flash_attention launch per layer in the prefill, one flash_decode
    launch per layer per decode step, no other kernel."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.serve import serve
    cfg = get_smoke("phi4-mini-3.8b")
    fa.flash_attention.launches = fa.flash_decode.launches = 0
    toks, stats = serve(cfg, batch=2, prompt_len=8, gen=5, device=cuda,
                        log=lambda m: None)
    assert toks.shape == (2, 5) and toks.is_cuda
    assert fa.flash_attention.launches == cfg.n_layers
    assert fa.flash_decode.launches == cfg.n_layers * 4
    assert stats["tokens_per_s"] > 0
