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
from repro_torch.core.rme import predicate  # noqa: E402
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


# maps that take each path of the block kernel: (map, dtypes, path)
BLOCK_PATH_CASES = {
    # a band at an offset of 3 channels: V of 4 bytes in f32 is one element
    "misaligned_band": (af.split_map((6, 10, 6), 2, 1), DTYPES, None),
    # a band of 2 channels at an offset of 2: vectors of two elements
    "narrow_vector": (af.split_map((6, 10, 8), 4, 1), DTYPES, "vector"),
    # int8 rows of 3 bytes: one element per access
    "int8_runs_of_3": (af.transpose_map((12, 20, 3)), (torch.int8,),
                       "scalar"),
    "int8_transpose": (af.transpose_map((12, 20, 64)), (torch.int8,),
                       "vector"),
    "hwc_to_chw": (af.axis_permutation_map((64, 96, 48), (2, 0, 1)), DTYPES,
                   "tile"),
    "chw_to_hwc_ragged": (af.axis_permutation_map((5, 33, 70), (1, 2, 0)),
                          DTYPES, "tile"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BLOCK_PATH_CASES))
def test_block_kernel_paths_on_card(cuda, name):
    rng = np.random.RandomState(6)
    m, dtypes, path = BLOCK_PATH_CASES[name]
    plan = ta.analyze_block_mode(m)
    for dtype in dtypes:
        regs = ta._block_regs(m, plan, dtype, cuda)
        assert path is None or regs.path == path, (name, dtype, regs.path)
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
def test_block_vector_path_on_misaligned_operands_on_card(cuda):
    """An x (or y) off the vector width runs the scalar path, bit-exact."""
    rng = np.random.RandomState(7)
    m = af.transpose_map((8, 12, 16))
    plan = ta.analyze_block_mode(m)
    n = int(np.prod(m.in_shape))
    for dtype in DTYPES:
        assert ta._block_regs(m, plan, dtype, cuda).path == "vector"
        x = _rand(rng, (n + 1,), dtype, cuda)[1:].view(m.in_shape)
        y = _rand(rng, (n + 1,), dtype, cuda)[1:].view(m.out_shape)
        for yy, ew in ((None, None), (y, "add")):
            got = ta.tm_affine_block(x, m, plan, y=yy, ew=ew)
            ref = ta.block_plain(x, m, plan, y=yy, ew=ew)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (dtype, ew)


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


# maps whose run table holds SEP_CAP entries element by element (the
# upsample on an x one element off 16 B): with the kernel's own shared
# memory, more than the 48 KB a block gets without asking
CAP_MAPS = {
    "pixelshuffle_at_cap": af.pixel_shuffle_map((2, 3, 4 * ta.SEP_CAP), 2),
    "upsample_at_cap": af.upsample_map((2, 3, ta.SEP_CAP), 2),
}

# maps of each gather path: (map, path, vbytes at int8 / int32 / bf16 / f32
# for an aligned x); the upsamples, and the pad past int8, read 16-byte
# accesses where aligned
GATHER_PATH_CASES = {
    "upsample_vector": (af.upsample_map((9, 7, 16), 2), "separable",
                        (16, 16, 16, 16)),
    "pad_vector": (af.pad_map((12, 10, 8), (1, 0, 0), (0, 2, 0), fill=5.0),
                   "separable", (1, 16, 16, 16)),
    "pixelshuffle_elements": (af.pixel_shuffle_map((20, 18, 64), 2),
                              "separable", (1, 4, 2, 4)),
    "pixelunshuffle_elements": (af.pixel_unshuffle_map((20, 36, 16), 2),
                                "separable", (1, 4, 2, 4)),
    "rearrange_elements": (af.batch_extend_map(
        af.rearrange_map((30, 40, 3), 1, 16), (2,)), "separable",
        (1, 4, 2, 4)),
    "img2col_general": (af.img2col_map((64, 64, 8), 3, 3, 1, 1, fill=-1.0),
                        "general", (1, 4, 2, 4)),
    "pixelshuffle_at_cap": (CAP_MAPS["pixelshuffle_at_cap"], "separable",
                            (1, 4, 2, 4)),
    "upsample_at_cap": (CAP_MAPS["upsample_at_cap"], "separable",
                        (16, 16, 16, 16)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GATHER_PATH_CASES))
def test_gather_kernel_paths_on_card(cuda, name):
    """Each path of the gather kernel against the plain version, in every
    dtype and epilogue, on an aligned x and on the same values one element
    off 16 bytes (a view into a larger buffer: element by element)."""
    m, path, vbytes = GATHER_PATH_CASES[name]
    rng = np.random.RandomState(8)
    n = int(np.prod(m.in_shape))
    for dtype, vb in zip(DTYPES, vbytes):
        buf = _rand(rng, (n + 1,), dtype, cuda)
        for aligned in (True, False):
            x = (buf[:n] if aligned else buf[1:]).view(m.in_shape)
            launch = ta.gather_launch(m, x)
            assert launch.path == path, (name, dtype)
            assert launch.vbytes == (vb if aligned else x.element_size())
            for ew in EW_OPS:
                y = None if ew is None else _rand(rng, m.out_shape, dtype,
                                                  cuda)
                before = ta.tm_affine_gather.launches
                got = ta.tm_affine_gather(x, m, y=y, ew=ew)
                ref = ta.gather_plain(x, m, y=y, ew=ew)
                torch.cuda.synchronize()
                assert ta.tm_affine_gather.launches == before + 1
                assert torch.equal(got, ref), (name, dtype, aligned, ew)


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


def neck_chain(batch=8):
    """The YOLOv3-Tiny neck: upsample x2 of (14, 14, 128), Route with a
    (28, 28, 128) skip map (runs of the 256 channels)."""
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), (batch,))
    maps = tuple(af.batch_extend_map(m, (batch,))
                 for m in af.route_maps([(28, 28, 128), (28, 28, 128)]))
    return ch.ChainSig(links=((up, None),), route_maps=maps, route_band=0)


def _img2col_r1(ew):
    # the padding's mask differs from patch row to patch row, so no suffix
    # of the output factors: runs of one element
    m = af.img2col_map((40, 40, 8), 3, 3, 1, 1, fill=-2.0)
    return ch.ChainSig(links=((m, None), (af.identity_map(m.out_shape), ew)))


def _at_cap(ew):
    # runs of R_CAP elements with an epilogue: 64 KB of run tables, past the
    # 48 KB a block gets without asking
    return ch.ChainSig(links=((af.transpose_map((64, 2, 128)), None),
                              (af.identity_map((2, 64, 128)), ew)))


def _superres_wide(ew):
    # many runs, masks in both parts, an epilogue and out-of-bounds fills
    ps = af.pixel_shuffle_map((48, 80, 8), 2)
    crop = af.pad_map((96, 160, 2), (-1, -1, 0), (-1, -1, 0), fill=-5.0)
    pad = af.pad_map((94, 158, 2), (1, 2, 0), (2, 1, 0), fill=3.0)
    return ch.ChainSig(links=((ps, ew), (crop, None), (pad, None)))


def _route_band1():
    # the chain feeds the second band; the first is an extra
    up = af.batch_extend_map(af.upsample_map((10, 14, 16), 2), (3,))
    maps = tuple(af.batch_extend_map(m, (3,))
                 for m in af.route_maps([(20, 28, 24), (20, 28, 16)]))
    return ch.ChainSig(links=((up, None),), route_maps=maps, route_band=1)


def _harness_chain(name, batch, ew):
    """The tm_chain chains of tests/harness.py CHAIN_CASES, built here from
    the port's maps (the harness imports JAX), at batch rank 0 or 1."""
    def lift(m):
        return af.batch_extend_map(m, (2,)) if batch else m
    if name == "route":
        maps = tuple(lift(m) for m in
                     af.route_maps([(10, 14, 3), (10, 14, 5)]))
        return ch.ChainSig(links=((lift(af.upsample_map((5, 7, 3), 2)),
                                   None),), route_maps=maps, route_band=0)
    links = {
        "chain3": [(af.transpose_map((4, 6, 8)), None),
                   (af.split_map((6, 4, 8), 2, 1), None),
                   (af.transpose_map((6, 4, 4)), None)],
        "superres": [(af.pixel_shuffle_map((6, 10, 8), 2), ew),
                     (af.pad_map((12, 20, 2), (-1, -1, 0), (-1, -1, 0)),
                      None),
                     (af.pad_map((10, 18, 2), (1, 1, 0), (1, 1, 0)), None)],
        # the suffix that fuses when a trailing Add also reads the first
        # intermediate
        "broken": [(af.split_map((6, 4, 8), 2, 1), None),
                   (af.transpose_map((6, 4, 4)), None)],
    }[name]
    return ch.ChainSig(links=tuple((lift(m), e) for m, e in links))


CHAIN_SIGS = {
    **{f"harness_{n}_b{b}": (lambda ew, n=n, b=b: _harness_chain(n, b, ew))
       for n in ("chain3", "superres", "route", "broken") for b in (0, 1)},
    "chain3": lambda ew: _chain3(),
    "superres": _superres,
    "route": lambda ew: _route(),
    "two_epilogues": _two_epilogues,
    "neck": lambda ew: neck_chain(),
    "img2col_r1": _img2col_r1,
    "at_cap": _at_cap,
    "superres_wide": _superres_wide,
    "route_band1": lambda ew: _route_band1(),
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


# the compaction core's edges, on each of its sources: (B, N, D, capacity,
# which rows pass).  A scan round is rg.ROUND_ROWS rows.
ROUND = rg.ROUND_ROWS
COMPACT_CASES = {
    "capacity_0": (2, 3000, 7, 0, "some"),
    "capacity_past_n": (2, 3000, 7, 3100, "some"),
    "full_inside_a_round": (2, 5000, 5, 1000, "all"),
    "full_at_a_round_end": (2, 5000, 5, ROUND, "all"),
    "full_one_past_a_round": (1, 5000, 5, ROUND + 1, "all"),
    "no_survivor": (2, 5000, 6, 256, "none"),
    "every_row": (2, 3000, 6, 5000, "all"),
    "ragged_rounds": (3, 2 * ROUND + 7, 9, 8000, "some"),
    "detect_tail": (8, 2352, 85, 256, "some"),
    "long_stream": (1, 100_000, 4, 120_000, "some"),
    "long_stream_early": (2, 100_000, 4, 256, "some"),
}
# one threshold a dtype: an integer one compares in the records' dtype
THRESHOLDS = {torch.float32: 20.0, torch.bfloat16: 7.3, torch.int32: 10.5,
              torch.int8: 3}


def _records(rng, B, N, D, dtype, device, rows):
    x = _rand(rng, (B, N, D), dtype, device)
    if rows != "some":
        x[..., 4 % D] = 99 if rows == "all" else -99
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compaction_edges_on_card(cuda, case):
    """rme_evaluate, rme_evaluate_chained (the pullback a permutation, with
    and without ok, its fill passing the threshold) and rme_assemble (bool
    and int32 masks) against their plain versions, every dtype."""
    B, N, D, cap, rows = COMPACT_CASES[case]
    rng = np.random.RandomState(10)
    si = 4 % D
    for dtype, thr in THRESHOLDS.items():
        x = _records(rng, B, N, D, dtype, cuda, rows)
        got = rg.rme_evaluate(x, thr, cap, score_index=si)
        ref = rg.evaluate_plain(x, thr, cap, score_index=si)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (case, dtype, "evaluate")
        perm = torch.tensor(rng.permutation(B * N * D).astype(np.int32),
                            device=cuda).reshape(B, N, D)
        slab = x.reshape(-1)[perm.reshape(-1).long().argsort()]
        for ok in (None, torch.tensor(rng.rand(B, N, D) < 0.9,
                                      device=cuda)):
            got = rg.rme_evaluate_chained(slab, perm, ok, 25.0, thr, cap,
                                          score_index=si)
            ref = rg.evaluate_chained_plain(slab, perm, ok, 25.0, thr, cap,
                                            score_index=si)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert torch.equal(g, r), (case, dtype, ok is None)
        keep = predicate(x[..., si], thr, "ge")
        for m in (keep, keep.to(torch.int32) * 5):
            got = rg.rme_assemble(x, m, cap)
            ref = rg.assemble_plain(x, m, cap)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                assert torch.equal(g, r), (case, dtype, m.dtype)


@pytest.mark.gpu
def test_compaction_replays_in_a_cuda_graph_on_card(cuda):
    """The three compactions captured once and replayed on new records."""
    rng = np.random.RandomState(11)
    B, N, D = 8, 2352, 85
    x = _rand(rng, (B, N, D), torch.float32, cuda)
    perm = torch.tensor(rng.permutation(B * N * D).astype(np.int32),
                        device=cuda).reshape(B, N, D)
    slab = torch.empty(B * N * D, device=cuda)
    mask = torch.empty((B, N), dtype=torch.bool, device=cuda)

    def calls():
        return (rg.rme_evaluate(x, 20.0, 256, score_index=4),
                rg.rme_evaluate_chained(slab, perm, None, 0.0, 20.0, 256,
                                        score_index=4),
                rg.rme_assemble(x, mask, 256))

    calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for _ in range(3):
        x.copy_(_rand(rng, (B, N, D), torch.float32, cuda))
        slab.copy_(torch.rand(B * N * D, device=cuda) * 200 - 100)
        mask.copy_(torch.rand((B, N), device=cuda) < 0.3)
        graph.replay()
        torch.cuda.synchronize()
        refs = (rg.evaluate_plain(x, 20.0, 256, score_index=4),
                rg.evaluate_chained_plain(slab, perm, None, 0.0, 20.0, 256,
                                          score_index=4),
                rg.assemble_plain(x, mask, 256))
        for got, ref in zip(outs, refs):
            for g, r in zip(got, ref):
                assert torch.equal(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("name,run,vec", [("neck", 256, True),
                                          ("img2col_r1", 1, False),
                                          ("at_cap", ch.R_CAP, True)])
def test_chain_run_plans_on_card(cuda, name, run, vec):
    """The run lengths the plan takes (runs of the neck's channels, of one
    element, of R_CAP with 64 KB of tables), each in 16-byte accesses where
    the plan allows them and element by element on operands 4 bytes off
    16-byte alignment, every dtype."""
    rng = np.random.RandomState(12)
    for dtype in DTYPES:
        sig = dataclasses.replace(CHAIN_SIGS[name]("add"),
                                  dtype=str(dtype)[len("torch."):])
        rp = ch.build_run_plan(sig)
        assert rp.run == run and (rp.vec > 1) == vec, (name, dtype)
        shape = sig.links[0][0].in_shape
        for off in (0, 4 // dtype.itemsize):
            buf = _rand(rng, (int(np.prod(shape)) + off,), dtype, cuda)
            x = buf[off:].view(shape)
            slabs = tuple(_rand(rng, s, dtype, cuda)
                          for s in ch._slab_shapes(sig))
            got = ch.tm_chain(sig, x, slabs)
            ref = ch.chain_plain(x, ch.build_chain_plan(sig), slabs)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (name, dtype, off)


@pytest.mark.gpu
def test_chain_replays_in_a_cuda_graph_on_card(cuda):
    rng = np.random.RandomState(13)
    sig = neck_chain()
    u = _rand(rng, sig.links[0][0].in_shape, torch.float32, cuda)
    skip = _rand(rng, ch._slab_shapes(sig)[0], torch.float32, cuda)
    ch.tm_chain(sig, u, (skip,))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ch.tm_chain(sig, u, (skip,))
    for _ in range(3):
        u.copy_(_rand(rng, tuple(u.shape), torch.float32, cuda))
        skip.copy_(_rand(rng, tuple(skip.shape), torch.float32, cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, torch.cat(
            [u.repeat_interleave(2, 1).repeat_interleave(2, 2), skip], -1))


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
# multiple of the tile depth, a 3-channel input, a 1x1 conv; EDSR's head
# (C = 3: the cp.async path) and up conv (N = 12) at full size, and a
# stride-2 conv on the TMA path (C = 16: 64-byte pixels in f32 and 32 in
# bf16)
CONV_CASES = [(16, 16, 8, 16, 3, 1, 1), (13, 11, 3, 7, 3, 2, 1),
              (9, 10, 5, 70, 3, 1, 0), (20, 30, 64, 64, 3, 1, 1),
              (7, 5, 130, 12, 1, 1, 0), (17, 9, 6, 5, 5, 2, 2),
              (224, 224, 3, 64, 3, 1, 1), (224, 224, 64, 12, 3, 1, 1),
              (33, 30, 16, 20, 3, 2, 1)]


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
@pytest.mark.parametrize("path", ["tma", "cp.async"])
def test_conv2d_kernel_paths_on_card(cuda, path):
    """The same conv through each way of filling the A stages: an x the
    plan sends to TMA's im2col mode, and the same pixels one element off
    16 bytes (a view into a larger buffer), which it sends to cp.async."""
    from repro_torch.core.fp_bounds import bf16_ulp, conv_tol
    from repro_torch.kernels.img2col import img2col as ik
    H, W, C, OC = 40, 36, 32, 27
    gen = torch.Generator().manual_seed(14)
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.rand((H * W * C + 1,), generator=gen).to(cuda, dtype)
        x = (buf[:H * W * C] if path == "tma" else buf[1:]).view(H, W, C)
        w = (torch.rand((3, 3, C, OC), generator=gen) - 0.5).to(cuda, dtype)
        assert ik.conv2d_plan(x, w, 1, 1).path == path
        before = ik.conv2d.launches
        got = ik.conv2d(x, w, 1, 1)
        ref = ik.conv2d_plain(x, w, 1, 1)
        torch.cuda.synchronize()
        assert ik.conv2d.launches == before + 1
        tol = conv_tol(x, w, 1, 1)
        if dtype == torch.bfloat16:
            tol = tol + bf16_ulp(ref)
        err = (got.double() - ref.double()).abs()
        assert bool((err <= tol).all()), (path, dtype, float(err.max()))


@pytest.mark.gpu
def test_conv2d_kernel_with_no_input_channels_stores_zeros_on_card(cuda):
    """K = 0 (C = 0): every output is an empty sum; one launch stores the
    zeros."""
    from repro_torch.kernels.img2col import img2col as ik
    x = torch.zeros((9, 7, 0), device=cuda)
    w = torch.zeros((3, 3, 0, 5), device=cuda)
    before = ik.conv2d.launches
    got = ik.conv2d(torch.full_like(x, 1.0), w, 1, 1)
    torch.cuda.synchronize()
    assert ik.conv2d.launches == before + 1
    assert torch.equal(got, torch.zeros((9, 7, 5), device=cuda))


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


# (M, K, N): ragged tiles in every direction, K below and above the step;
# tall and skinny: a TMA row pitch (K 288), a cp.async one (K 33, and K 9
# in bf16: an 18-byte pitch), N = 255 in eight column tiles, K = 1
MM_CASES = [(7, 9, 5), (64, 16, 64), (130, 33, 70), (33, 200, 3),
            (1000, 288, 27), (517, 33, 28), (300, 9, 255), (70, 1, 5)]


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
    # W = 130: the 512-row tiles cross image rows mid-row; W = 1: more runs
    # than a store pass has rows (stored element by element); C s^2 = 80: a
    # shuffle in three column tiles
    for H, W, C, s, K in ((5, 7, 3, 3, 20), (4, 9, 2, 2, 16),
                          (3, 130, 3, 3, 288), (300, 1, 2, 2, 8),
                          (6, 11, 5, 4, 16)):
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


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["tma", "cp.async"])
def test_matmul_tm_paths_on_card(cuda, path):
    """The same product through each way of filling the A stages: an x the
    plan sends to TMA, and the same rows one element off 16 bytes (a view
    into a larger buffer), which it sends to cp.async."""
    from repro_torch.kernels.matmul_tm import matmul_tm as mk
    rng = np.random.RandomState(22)
    M, K, N = 600, 64, 27
    for dtype in DTYPES:
        buf = _operand(rng, (M * K + 1,), dtype, cuda)
        x = (buf[:M * K] if path == "tma" else buf[1:]).view(M, K)
        w = _operand(rng, (K, N), dtype, cuda)
        assert mk.mm_plan(M, K, N, dtype, x.data_ptr() % 16 == 0).path == path
        for ep in (mk.Epilogue(), mk.Epilogue("transpose")):
            before = mk.matmul_tm.launches
            got = mk.matmul_tm(x, w, ep)
            ref = mk.matmul_tm_plain(x, w, ep)
            torch.cuda.synchronize()
            assert mk.matmul_tm.launches == before + 1
            if ep.mode == "transpose":
                got, ref = got.T, ref.T
            _require_product(got, ref, x, w, dtype, (path, dtype, ep))


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
        # ESPCN's conv3 + PixelShuffle x3 at a tenth of the frame: 32
        # channels (the TMA path), N = 27 (BN 28), several tiles
        "espcn_pixelshuffle": (Gemm("conv", (1, 36, 64, 32), (3, 3, 32, 27),
                                    1, "SAME"), "commit",
                               lambda y: [(af.batch_extend_map(
                                   af.pixel_shuffle_map(y[1:], 3), (1,)),
                                   None)]),
        "conv_batch2": (Gemm("conv", (2, 20, 18, 16), (3, 3, 16, 12), 1,
                             "SAME"), "commit",
                        lambda y: [(af.axis_permutation_map(y, (0, 2, 1, 3)),
                                    None)]),
        "mm_tall_k288": (Gemm("mm", (700, 288), (288, 27)), "commit",
                         lambda y: [(af.axis_permutation_map(y, (1, 0)),
                                     None)]),
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
def test_xchain_commit_replays_in_a_cuda_graph_on_card(cuda, full_f32):
    """The cooperative commit captured in a CUDA graph and replayed (as
    chip_smoke.py times it) equals an eager call, bit for bit; its scratch
    comes from the graph's pool."""
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.tm_affine.chain import ChainSig
    rng = np.random.RandomState(24)
    g = xc.Gemm("conv", (1, 36, 64, 32), (3, 3, 32, 27), 1, "SAME")
    m = af.batch_extend_map(af.pixel_shuffle_map(g.out_shape[1:], 3), (1,))
    for dtype in (torch.float32, torch.int32):
        sig = ChainSig(links=((m, None),),
                       dtype=str(dtype).removeprefix("torch."))
        x = _operand(rng, g.x_shape, dtype, cuda)
        w = _operand(rng, g.w_shape, dtype, cuda)
        eager = xc.xchain_commit(sig, g, x, w)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = xc.xchain_commit(sig, g, x, w)
        for _ in range(3):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, eager), dtype


def _neck_prologue(rng, dtype, device, batch=8):
    """The YOLOv3-Tiny neck (upsample x2 of (B, 14, 14, 128), Route with
    the (B, 28, 28, 128) skip) into head 2's 1x1 conv to 255 channels."""
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.tm_affine.chain import ChainSig
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), (batch,))
    route = tuple(af.batch_extend_map(m, (batch,)) for m in
                  af.route_maps([(28, 28, 128), (28, 28, 128)]))
    sig = ChainSig(links=((up, None),), route_maps=route, route_band=0,
                   dtype=str(dtype).removeprefix("torch."))
    u = _operand(rng, up.in_shape, dtype, device)
    skip = _operand(rng, route[1].in_shape, dtype, device)
    w = _operand(rng, (1, 1, 256, 255), dtype, device)
    g = xc.Gemm("conv", (batch, 28, 28, 256), (1, 1, 256, 255), 1, "SAME")
    return sig, g, u, skip, w


@pytest.mark.gpu
def test_xchain_prologue_at_the_yolo_neck_on_card(cuda, full_f32):
    """The prologue at the full YOLO-neck size in every dtype (one launch,
    TMA im2col over the scratch), against the plain version: integers bit
    for bit, floats within 2 gamma_K sum |x w| (bf16 one more ulp)."""
    from repro_torch.kernels.matmul_tm import chain as xc
    rng = np.random.RandomState(25)
    for dtype in DTYPES:
        sig, g, u, skip, w = _neck_prologue(rng, dtype, cuda)
        before = xc.xchain_prologue.launches
        got = xc.xchain_prologue(sig, g, 0, u, w, (skip,))
        ref = xc.xchain_prologue_plain(sig, g, 0, u, w, (skip,))
        torch.cuda.synchronize()
        assert xc.xchain_prologue.launches == before + 1
        cat = torch.cat([u.repeat_interleave(2, 1).repeat_interleave(2, 2),
                         skip], -1)
        assert xc.xchain_prologue_card_plan(g, cat).path == "tma"
        _require_product(got.reshape(-1, 255), ref.reshape(-1, 255),
                         cat.reshape(-1, 256), w.reshape(256, 255), dtype,
                         dtype)


@pytest.mark.gpu
def test_xchain_prologue_keeps_the_route_sum_bits_on_card(cuda):
    """The Route band sums v + (mask ? z : fill) as the JAX package does:
    a -0.0 in either band's source comes out +0.0 (-0.0 + 0.0), bit for
    bit the plain version, through the chain into an identity product."""
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.tm_affine.chain import ChainSig
    up = af.batch_extend_map(af.upsample_map((3, 4, 4), 2), (1,))
    route = tuple(af.batch_extend_map(m, (1,)) for m in
                  af.route_maps([(6, 8, 4), (6, 8, 4)]))
    sig = ChainSig(links=((up, None),), route_maps=route, route_band=0)
    g = xc.Gemm("conv", (1, 6, 8, 8), (1, 1, 8, 8), 1, "SAME")
    u = torch.full(up.in_shape, -0.0, device=cuda)
    skip = torch.full(route[1].in_shape, -0.0, device=cuda)
    eye = torch.eye(8, device=cuda).reshape(1, 1, 8, 8)
    got = xc.xchain_prologue(sig, g, 0, u, eye, (skip,))
    ref = xc.xchain_prologue_plain(sig, g, 0, u, eye, (skip,))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert not torch.signbit(got).any()


@pytest.mark.gpu
def test_xchain_prologue_replays_in_a_cuda_graph_on_card(cuda, full_f32):
    """The cooperative prologue captured in a CUDA graph and replayed
    equals an eager call, bit for bit; its scratch comes from the graph's
    pool."""
    from repro_torch.kernels.matmul_tm import chain as xc
    rng = np.random.RandomState(26)
    for dtype in (torch.float32, torch.int32):
        sig, g, u, skip, w = _neck_prologue(rng, dtype, cuda, batch=2)
        eager = xc.xchain_prologue(sig, g, 0, u, w, (skip,))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = xc.xchain_prologue(sig, g, 0, u, w, (skip,))
        for _ in range(3):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, eager), dtype


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


def _within_attention_tol(got, ref, q, k, v, **kw):
    from repro_torch.core.fp_bounds import attention_tol
    err = (got.double() - ref.double()).abs()
    return bool((err <= attention_tol(q, k, v, **kw)).all()), float(err.max())


# (B, S, Sk, H, KV, D, causal): the LM prefill, the padded and the widest
# head-dim templates, S != Sk both ways, one query row, and head groups
# G = H / KV whose 128-row tiles (128 / G positions x G heads) leave rows
TC_SHAPES = {
    "phi4_prefill": (8, 1024, 1024, 24, 8, 128, True),
    "d24_padded": (2, 150, 150, 6, 2, 24, True),
    "d256": (1, 300, 300, 4, 2, 256, True),
    "d256_noncausal": (1, 200, 130, 2, 1, 256, False),
    "s_lt_sk": (2, 70, 300, 6, 2, 128, True),
    "s_gt_sk": (2, 300, 70, 6, 2, 128, True),
    "s1": (3, 1, 257, 8, 2, 64, True),
    "g5_noncausal": (2, 150, 90, 5, 1, 128, False),  # 125 of 128 tile rows
    "g16": (1, 200, 333, 16, 1, 64, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(TC_SHAPES))
def test_flash_attention_tensor_core_kernel_on_card(cuda, case):
    """The bf16 prefill (TMA + wgmma) within fp_bounds.attention_tol of
    the plain version at the LM's shape and at the head dims and ragged
    edges its tiles pad."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    B, S, Sk, H, KV, D, causal = TC_SHAPES[case]
    rng = np.random.RandomState(S + Sk + D)
    q, k, v = _qkv(rng, B, S, Sk, H, KV, D, torch.bfloat16, cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ok, err = _within_attention_tol(got, ref, q, k, v, causal=causal)
    assert ok, (case, err)


@pytest.mark.gpu
def test_flash_attention_refuses_what_tma_tiles_cannot_take_on_card(cuda):
    """TMA copies need 16-byte aligned bases and strides: a bf16 view that
    breaks either raises "aligned" and launches nothing, as does a group
    of more than 128 query heads per KV head (a tile's 128 rows hold the
    whole group); the f32 kernel takes the same views."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    x = torch.randn((2, 40, 2 * 16 + 2), device=cuda)
    flat = x.to(torch.bfloat16).reshape(-1)
    before = fa.flash_attention.launches
    for t in (flat[1:1 + 2 * 40 * 32].view(2, 40, 2, 16),  # base + 2 bytes
              x.to(torch.bfloat16)[:, :, :32].unflatten(2, (2, 16))):
        with pytest.raises(ValueError, match="aligned"):  # row: 68 bytes
            fa.flash_attention(t, t, t)
    wide = torch.zeros((1, 8, 129, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="at most 128"):
        fa.flash_attention(wide, wide[:, :, :1], wide[:, :, :1])
    assert fa.flash_attention.launches == before
    odd = x[:, :, 1:33].unflatten(2, (2, 16))  # f32: 4 bytes past, 136 B rows
    got = fa.flash_attention(odd, odd, odd)
    ok, err = _within_attention_tol(got, fa.attention_ref(odd, odd, odd),
                                    odd, odd, odd)
    assert ok, err


# (B, T, lengths): a long cache at batch 1, lengths at 1, a split boundary
# and one past it, T - 1, T, and 0 / -3 (the mean of v)
DECODE_CASES = {"t4096": (1, 4096), "t32768": (1, 32768)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_split_kernel_on_card(cuda, full_f32, dtype, case):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    B, T = DECODE_CASES[case]
    H, KV, D = 24, 8, 128
    rng = np.random.RandomState(T)
    q, k, v = _qkv(rng, B, 1, T, H, KV, D, dtype, cuda)
    rows, splits = fa.decode_plan(B, T, H, KV, cuda, dtype)
    assert splits > 1 and rows * (splits - 1) < T <= rows * splits
    for length in (1, rows, rows + 1, T - 1, T, 0, -3):
        got = fa.flash_decode(q, k, v, length)
        ref = fa.decode_ref(q, k, v, length)
        torch.cuda.synchronize()
        ok, err = _within_attention_tol(got, ref, q, k, v, causal=False,
                                        length=length)
        assert ok, (length, err)
        if length <= 0:
            mean = v.double().mean(dim=1, keepdim=True).repeat_interleave(
                H // KV, dim=2).to(dtype)
            ok, err = _within_attention_tol(got, mean, q, k, v,
                                            causal=False, length=length)
            assert ok, (length, err)
    assert torch.equal(fa.flash_decode(q, k, v, 7),
                       fa.flash_decode(q, k, v, 7))


@pytest.mark.gpu
def test_flash_decode_replays_in_a_cuda_graph_at_every_length_on_card(cuda):
    """One flash_decode captured in a CUDA graph, replayed after the device
    length was changed, equals a direct call at that length: the grid
    depends on T only and the kernels read the length on the device."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    rng = np.random.RandomState(3)
    T = 1088
    q, k, v = _qkv(rng, 8, 1, T, 24, 8, 128, torch.bfloat16, cuda)
    n = torch.tensor([5], dtype=torch.int32, device=cuda)
    fa.flash_decode(q, k, v, n)  # builds and allocates outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_decode(q, k, v, n)
    for length in (1, 64, 65, 1024, 1025, T, 0, -3):
        n.fill_(length)
        graph.replay()
        direct = fa.flash_decode(q, k, v, length)
        torch.cuda.synchronize()
        assert torch.equal(out, direct), length


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


@pytest.mark.gpu
def test_vmap_of_the_cnn_blocks_has_no_fallback_on_card(cuda):
    """torch.func.vmap of the demo blocks reaches every custom op through
    its vmap rule on the card too: with the per-sample fallback turned off
    the compile succeeds, with the unbatched call's TM instructions."""
    from repro_torch.compiler import tm_compile
    from repro_torch.models import cnn
    ft = torch._C._functorch
    rng = np.random.RandomState(3)
    u = torch.tensor(rng.rand(4, 1, 4, 6, 6).astype(np.float32)).to(cuda)
    skip = torch.tensor(rng.rand(4, 1, 8, 12, 3).astype(np.float32)).to(cuda)
    prev = ft._is_vmap_fallback_enabled()
    ft._set_vmap_fallback_enabled(False)
    try:
        c = tm_compile(torch.func.vmap(cnn.yolo_neck), u, skip)
    finally:
        ft._set_vmap_fallback_enabled(prev)
    b = tm_compile(cnn.yolo_neck, u[:, 0], skip[:, 0])
    assert c.phase_kinds == b.phase_kinds == "m"
    assert [len(p.instrs) for p in c.tm_programs] == \
        [len(p.instrs) for p in b.tm_programs]
    out = c(u, skip, backend="cuda")
    assert torch.equal(out[:, 0], cnn.yolo_neck(u[:, 0], skip[:, 0]))


@pytest.mark.gpu
def test_served_requests_on_card_and_a_failing_kernel_fails_them(cuda):
    """TMServer on the card: served yolo_neck requests equal the direct
    call; with a kernel lowering that raises, every request of the group
    fails with that error — no degradation ladder, no quarantine."""
    from repro_torch.core import dispatch
    from repro_torch.models import cnn
    from repro_torch.serving import ServerConfig, TMServer
    rng = np.random.RandomState(0)

    def arr(*shape):
        return torch.tensor(rng.rand(*shape).astype(np.float32)).to(cuda)

    reqs = [(arr(1, 4, 6, 6), arr(1, 8, 12, 3)) for _ in range(4)]

    def boom(site, what):
        if site == "lowering":
            raise RuntimeError(f"injected kernel fault at {what}")

    # per instruction, so every TM instruction goes through lower_instr
    cfg = ServerConfig(backend="cuda", max_batch=4, batch_timeout_s=0.01,
                       select_chaining=False, select_xengine=False,
                       retry_attempts=1)
    with TMServer(cfg) as srv:
        futs = [srv.submit(cnn.yolo_neck, *a, fn_key="neck") for a in reqs]
        for a, f in zip(reqs, futs):
            assert torch.equal(f.result(timeout=300), cnn.yolo_neck(*a))
        dispatch.fault_hook = boom
        try:
            futs = [srv.submit(cnn.yolo_neck, *a, fn_key="neck")
                    for a in reqs]
            for f in futs:
                with pytest.raises(RuntimeError, match="injected"):
                    f.result(timeout=300)
        finally:
            dispatch.fault_hook = None
        snap = srv.snapshot_stats()
        entries = list(srv.cache._entries.values())
    assert snap["failed"] == 4 and snap["completed"] == 4
    assert snap["degraded_phases"] == 0
    assert all(e.quarantine is None and not e.degraded_phases
               for e in entries)


# ---------------------------------------------------------------------------
# fault tolerance and decode on the card
# ---------------------------------------------------------------------------

def _neck_requests(cuda, n, seed=0):
    rng = np.random.RandomState(seed)

    def arr(*shape):
        return torch.tensor(rng.rand(*shape).astype(np.float32)).to(cuda)

    return [(arr(1, 4, 6, 6), arr(1, 8, 12, 3)) for _ in range(n)]


@pytest.mark.gpu
def test_watchdog_poisons_a_hung_phase_on_a_cuda_stream(cuda):
    """A hang injected at the stream site of a warm group is poisoned by
    the watchdog; the engine's fresh worker keeps its CUDA stream and the
    next group completes bit-exact against the direct call."""
    from repro_torch.ft import (FaultInjector, FaultPlan, FaultSpec,
                                PhaseTimeoutError)
    from repro_torch.models import cnn
    from repro_torch.serving import ServerConfig, TMServer
    reqs = _neck_requests(cuda, 2)
    cfg = ServerConfig(backend="cuda", max_batch=1, batch_timeout_s=0.0,
                       retry_attempts=0, phase_timeout_factor=20.0,
                       phase_timeout_floor_s=0.5)
    with TMServer(cfg) as srv:
        streams = {k: s.cuda_stream for k, s in srv.sched.runtime
                   .streams.items()}
        assert torch.equal(srv(cnn.yolo_neck, *reqs[0], fn_key="neck"),
                           cnn.yolo_neck(*reqs[0]))          # warm
        plan = FaultPlan(specs=(FaultSpec(site="stream", mode="hang",
                                          count=1, delay_s=10.0),), seed=7)
        with FaultInjector(plan):
            fut = srv.submit(cnn.yolo_neck, *reqs[0], fn_key="neck")
            with pytest.raises(PhaseTimeoutError):
                fut.result(timeout=120)
        got = srv(cnn.yolo_neck, *reqs[1], fn_key="neck")
        assert {k: s.cuda_stream for k, s in srv.sched.runtime
                .streams.items()} == streams
        snap = srv.snapshot_stats()
    torch.cuda.synchronize()
    assert torch.equal(got, cnn.yolo_neck(*reqs[1]))
    assert snap["phase_timeouts"] == 1


@pytest.mark.gpu
def test_bisect_retry_rescues_a_lowering_fault_on_card(cuda):
    """A one-shot kernel-lowering fault fails the group on the card (no
    ladder); bisect-retry re-executes it on the card and every request
    resolves bit-exact against its entry's program."""
    from repro_torch.ft import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.models import cnn
    from repro_torch.serving import ServerConfig, TMServer
    from repro_torch.serving.batcher import split
    reqs = _neck_requests(cuda, 4, seed=1)
    cfg = ServerConfig(backend="cuda", max_batch=4, batch_timeout_s=0.05,
                       select_chaining=False, select_xengine=False,
                       retry_attempts=2)
    with TMServer(cfg) as srv:
        [f.result(timeout=300) for f in
         [srv.submit(cnn.yolo_neck, *a, fn_key="neck") for a in reqs]]
        plan = FaultPlan(specs=(FaultSpec(site="lowering", mode="fail",
                                          count=1),), seed=6)
        with FaultInjector(plan) as inj:
            futs = [srv.submit(cnn.yolo_neck, *a, fn_key="neck")
                    for a in reqs]
            res = [f.result(timeout=300) for f in futs]
        snap = srv.snapshot_stats()
        (entry,) = srv.cache._entries.values()
    assert inj.fired == 1
    assert snap["rescued_requests"] == 4 and snap["victim_requests"] == 0
    assert entry.quarantine is None and not entry.degraded_phases
    stacked = tuple(torch.stack(xs) for xs in zip(*reqs))
    direct, _ = entry.compiled.run(*stacked, backend="cuda")
    for r, want in zip(res, split(direct, 4)):
        assert torch.equal(r, want)


@pytest.mark.gpu
def test_decode_session_on_card_caches_bit_exact(cuda):
    """A smoke-config DecodeSession on the card: every step's caches
    bit-exact against ``reference_generate`` run on the card (the KV
    append is data movement), the tokens equal, one entry per position."""
    from repro_torch.configs.phi4_mini_3p8b import smoke_config
    from repro_torch.serving import DecodeSession
    cfg = smoke_config()
    gen = torch.Generator(device=cuda).manual_seed(0)
    with DecodeSession(cfg, generator=gen, device=cuda, max_len=16) as sess:
        prompts = torch.randint(0, cfg.vocab, (2, 4), device=cuda,
                                generator=torch.Generator(device=cuda)
                                .manual_seed(1)).to(torch.int32)
        got, ref = [], []
        toks, logits = sess.generate(prompts, 5, caches=got)
        rtoks, rlogits = sess.reference_generate(prompts, 5, caches=ref)
        entries = sess.server.snapshot_stats()["cache"]["entries"]
    assert entries == 5
    for (ak, av), (bk, bv) in zip(got, ref):
        assert torch.equal(ak, bk) and torch.equal(av, bv)
    for a, b in zip(logits, rlogits):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_overlay_route_on_card_matches_slice_scatter(cuda):
    """The KV append's overlay Route on the card (the engine's select: the
    block and gather kernels decline overlay Routes, as the JAX package's
    dispatch does) bit-exact against ``torch.slice_scatter``, in four
    dtypes, unbatched and vmapped."""
    from repro_torch.compiler import tm_compile
    rng = np.random.RandomState(3)
    for dtype in DTYPES:
        cache = _rand(rng, (2, 16, 2, 8), dtype, cuda)
        upd = _rand(rng, (2, 3, 2, 8), dtype, cuda)

        def fn(c_, u):
            return torch.slice_scatter(c_, u, dim=1, start=13, end=16)

        for f, args in ((fn, (cache, upd)),
                        (torch.func.vmap(fn), (cache[None], upd[None]))):
            c = tm_compile(f, *args)
            assert "slice_scatter" in c.matched_prims
            got, reps = c.run(*args, backend="cuda")
            assert torch.equal(got, f(*args)), dtype
            assert [r.path for rep in reps for r in rep.records] == \
                ["reference.coarse"]


# ---------------------------------------------------------------------------
# slice 13: MoE dispatch through the assemble kernel, the new model families'
# attention shapes
# ---------------------------------------------------------------------------

# (B, T, routed experts, physical experts, capacity): the decode shape's
# capacity 1, a capacity that drops slots, pad experts that receive
# nothing, Qwen2-MoE's 512 streams at its served prefill and decode shapes
MOE_DISPATCH = {
    "capacity_1": (8, 4, 60, 64, 1),
    "drops": (2, 400, 4, 4, 30),
    "pad_experts": (3, 64, 6, 8, 20),
    "qwen2_prefill": (8, 4096, 60, 64, 86),
    "qwen2_decode": (8, 4, 60, 64, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MOE_DISPATCH))
def test_moe_dispatch_is_one_assemble_launch_on_card(cuda, case):
    """Batched ``dispatch_tokens`` on the card: one ``rme_assemble`` launch
    over the B·E record streams, bit for bit its plain version's."""
    from repro_torch.core import rme
    B, T, E, E_phys, cap = MOE_DISPATCH[case]
    rng = np.random.RandomState(T + B)
    eo = torch.tensor(rng.randint(0, E, size=(B, T))).to(cuda)
    before = rg.rme_assemble.launches
    idx, cnt = rme.dispatch_tokens(eo, E_phys, cap)
    torch.cuda.synchronize()
    assert rg.rme_assemble.launches == before + 1
    want_idx, want_cnt = rme.dispatch_tokens_plain(eo, E_phys, cap)
    assert idx.dtype == cnt.dtype == torch.int32
    assert torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)
    if E_phys > E:
        assert bool((idx[:, E:] == T).all()) and not cnt[:, E:].any()
    if case == "drops":
        asked = torch.stack([torch.bincount(r, minlength=E) for r in eo])
        assert bool((asked > cap).any())
        assert torch.equal(cnt, asked.clamp(max=cap).to(torch.int32))


@pytest.mark.gpu
def test_moe_block_is_deterministic_on_card(cuda):
    """Two runs of the MoE block on the card give the same bits (the
    combine gathers each token's slots and sums them in a fixed order, no
    atomics), and the block stays within bf16 rounding of its f32 run."""
    from repro_torch.models import moe
    g = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init_moe(g, 256, 128, 60, 4, n_shared=1, shared_d_ff=512,
                     dtype=torch.bfloat16, pad_experts=64)
    x = torch.randn((4, 96, 256), generator=g, device=cuda).to(torch.bfloat16)
    kw = dict(num_experts=60, top_k=4, n_shared=1)
    before = rg.rme_assemble.launches
    a, aux_a = moe.moe_block(p, x, **kw)
    b, aux_b = moe.moe_block(p, x, **kw)
    torch.cuda.synchronize()
    assert rg.rme_assemble.launches == before + 2
    assert torch.equal(a, b) and torch.equal(aux_a["load_balance"],
                                             aux_b["load_balance"])
    assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())


# (B, S, H, KV, D): Zamba2's shared attention (D = 112, padded to 128 by
# the TMA box's zero fill), InternVL2 (G = 7, D = 64), Llama4-Scout
# (G = 5), Qwen2-MoE and MusicGen (MHA, G = 1)
FAMILY_ATTN = {
    "zamba2_d112": (2, 200, 32, 32, 112),
    "internvl2_g7": (2, 300, 14, 2, 64),
    "llama4_g5": (2, 160, 40, 8, 128),
    "qwen2_moe_mha": (2, 256, 16, 16, 128),
    "musicgen_mha_d64": (2, 130, 32, 32, 64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FAMILY_ATTN))
def test_flash_kernels_at_the_families_shapes_on_card(cuda, case):
    """The bf16 prefill and decode within fp_bounds.attention_tol of their
    plain versions at each new family's attention shape."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    B, S, H, KV, D = FAMILY_ATTN[case]
    rng = np.random.RandomState(S + D)
    q, k, v = _qkv(rng, B, S, S, H, KV, D, torch.bfloat16, cuda)
    before = (fa.flash_attention.launches, fa.flash_decode.launches)
    got = fa.flash_attention(q, k, v, causal=True)
    ok, err = _within_attention_tol(got, fa.attention_ref(q, k, v), q, k, v,
                                    causal=True)
    assert ok, (case, "prefill", err)
    for length in (1, S // 2 + 1, S):
        got = fa.flash_decode(q[:, :1], k, v, length)
        ref = fa.decode_ref(q[:, :1], k, v, length)
        ok, err = _within_attention_tol(got, ref, q[:, :1], k, v,
                                        causal=False, length=length)
        assert ok, (case, length, err)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_decode.launches) == \
        (before[0] + 1, before[1] + 3)


# ---------------------------------------------------------------------------
# slice 14: training
# ---------------------------------------------------------------------------

def _smoke_train(device, remat="none", steps=2, seed=0):
    """``steps`` train steps of the Qwen2-MoE smoke config (f32) from
    weights drawn on the CPU with ``seed``, on ``device``; returns the
    state and each step's metrics as floats."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.tree import tree_map
    from repro_torch.runtime.step import init_train_state, make_train_step
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), remat=remat)
    state = init_train_state(cfg, torch.Generator().manual_seed(seed),
                             device="cpu")
    state = tree_map(lambda t: t.to(device), state)
    fn = make_train_step(cfg, peak_lr=1e-2, warmup=1, total=steps)
    src = SyntheticLM(cfg.vocab, 4, 32, seed)
    mets = []
    for i in range(steps):
        state, met = fn(state, to_device(src.batch_at(i),
                                         torch.device(device)))
        mets.append({k: float(v) for k, v in met.items()})
    return cfg, state, mets


@pytest.mark.gpu
def test_smoke_train_steps_on_card_match_the_cpu(cuda, full_f32):
    """Two f32 train steps of the MoE smoke config on the card (dispatch on
    the assemble kernel) against the same steps on the CPU (its plain
    version), from the same weights and batches: every metric, and every
    parameter after them, within 1e-4 of its largest magnitude (f32 sums
    in other orders, through one update at lr 1e-2)."""
    from repro_torch.tree import tree_leaves
    _, got, gm = _smoke_train(cuda)
    _, want, wm = _smoke_train("cpu")
    for a, b in zip(gm, wm):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4 * max(abs(b[k]), 1e-6), (k, a, b)
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(want["params"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        tol = 1e-4 * float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("none", 1)])
def test_moe_dispatch_launches_under_remat_on_card(cuda, remat, per_layer):
    """A train step launches ``rme_assemble`` once a layer in the forward
    and, with ``remat="full"``, once more in each layer's recompute."""
    before = rg.rme_assemble.launches
    cfg, _, _ = _smoke_train(cuda, remat=remat, steps=1)
    torch.cuda.synchronize()
    assert rg.rme_assemble.launches - before == per_layer * cfg.n_layers


@pytest.mark.gpu
def test_bf16_checkpoint_round_trip_from_card_tensors(cuda, tmp_path):
    """bf16, f32 and int32 tensors on the card saved and restored onto the
    card, bit for bit (every bf16 pattern, NaNs included)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    tree = {"bf": bits.view(torch.bfloat16).reshape(256, 256).to(cuda),
            "f32": torch.randn(7, 3, device=cuda),
            "step": torch.tensor(9, dtype=torch.int32, device=cuda)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, tree, blocking=True)
    got, step = mgr.restore(device=cuda)
    assert step == 9
    for k, t in tree.items():
        assert got[k].device.type == "cuda" and got[k].dtype == t.dtype
        if t.dtype == torch.bfloat16:
            assert torch.equal(got[k].view(torch.int16), t.view(torch.int16))
        else:
            assert torch.equal(got[k], t)


@pytest.mark.gpu
def test_train_defaults_to_the_card(cuda):
    """``train()`` without a device trains on the card: the state lives
    there and the dispatch launched the assemble kernel."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    before = rg.rme_assemble.launches
    state, losses = train(get_smoke("qwen2-moe-a2.7b"), steps=2, batch=2,
                          seq=16, log=lambda *a: None)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(t.device.type == "cuda" for t in tree_leaves(state))
    assert rg.rme_assemble.launches > before


# -- slice 15: distribution on a (1, 1) card mesh ---------------------------------

@pytest.fixture(scope="module")
def card_mesh():
    """A one-rank NCCL group (in-process store) and its (1, 1) card mesh,
    the group destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import card_process_group
    with card_process_group():
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))


@pytest.mark.gpu
@pytest.mark.parametrize("compress", [False, True])
def test_train_on_card_mesh_equals_train(card_mesh, compress):
    """train(mesh=) on the smoke config (f32): the state placed on the card
    mesh, every gradient redistributed to its parameter's placements, the
    dispatch through the assemble kernel's sharding rule.  Step 0's loss
    is train()'s bit for bit; the later ones within 1e-5, since two runs
    of train() itself on the card differ in the last bits (the gathers'
    backward sums with atomics, in no fixed order: 6.5e-8 measured)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    cfg = get_smoke("qwen2-moe-a2.7b")
    kw = dict(steps=3, batch=2, seq=16, compress=compress,
              log=lambda *a: None)
    _, want = train(cfg, **kw)
    before = rg.rme_assemble.launches
    state, got = train(cfg, mesh=card_mesh, **kw)
    assert rg.rme_assemble.launches > before
    assert got[0] == want[0]
    assert np.allclose(got, want, rtol=1e-5, atol=0)
    for a in tree_leaves(state["params"]):
        assert isinstance(a, DTensor) and a.device.type == "cuda"


@pytest.mark.gpu
def test_reshard_round_trip_on_card_mesh(card_mesh):
    """The smoke weights placed on the card mesh by the train rules and
    gathered back whole, bit for bit, each leaf a DTensor on the card."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.mesh import rules_for_cell
    from repro_torch.models.transformer import init_lm, lm_specs
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import tree_leaves
    cfg = get_smoke("zamba2-7b")
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0))
    placed = reshard_state(params, lm_specs(cfg), card_mesh,
                           rules_for_cell("train"))
    for a, b in zip(tree_leaves(placed), tree_leaves(params)):
        assert isinstance(a, DTensor) and a.to_local().is_cuda
        assert torch.equal(a.full_tensor(), b)


@pytest.mark.gpu
def test_custom_ops_launch_their_kernels_on_card(cuda, full_f32):
    """Each custom op on CUDA tensors launches its kernel (the launch
    counted) and equals its plain version: the assemble bit for bit, the
    attention within fp_bounds.attention_tol."""
    from repro_torch.core.fp_bounds import attention_tol
    from repro_torch.kernels.flash_attention import flash_attention as fa
    rng = np.random.RandomState(15)
    x = _rand(rng, (6, 300, 5), torch.float32, cuda)
    mask = torch.tensor(rng.rand(6, 300) > 0.4, device=cuda)
    q, k, v = (torch.tensor(rng.randn(2, 64, *hd).astype(np.float32),
                            device=cuda)
               for hd in ((8, 64), (2, 64), (2, 64)))
    n = (rg.rme_assemble.launches, fa.flash_attention.launches,
         fa.flash_decode.launches)
    rows, cnt = torch.ops.repro_torch.rme_assemble.default(x, mask, 128)
    pre = torch.ops.repro_torch.flash_attention.default(q, k, v, True, None)
    length = torch.tensor([37], dtype=torch.int32, device=cuda)
    dec = torch.ops.repro_torch.flash_decode.default(q[:, :1], k, v, length,
                                                     None)
    torch.cuda.synchronize()
    assert (rg.rme_assemble.launches, fa.flash_attention.launches,
            fa.flash_decode.launches) == tuple(c + 1 for c in n)
    want_rows, want_cnt = rg.assemble_plain(x.cpu(), mask.cpu(), 128)
    assert torch.equal(rows.cpu(), want_rows)
    assert torch.equal(cnt.cpu(), want_cnt)
    for got, ref, kw, qq in ((pre, fa.attention_ref(q, k, v), {}, q),
                             (dec, fa.decode_ref(q[:, :1], k, v, 37),
                              dict(causal=False, length=37), q[:, :1])):
        err = (got.double() - ref.double()).abs()
        assert bool((err <= attention_tol(qq, k, v, **kw)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_partial_on_card(cuda, full_f32, dtype):
    """flash_decode's partial mode at Phi-4-mini's decode shape, q (8, 1,
    24, 128) against a (8, 1088, 8, 128) cache split into 4 row blocks,
    each block's length on the device: each launch counted once, each
    block's (o, lse) within attention_tol / decode_lse_tol of its plain
    version (o = 0, lse = -inf exactly for a block with no live row), the
    blocks combined within attention_tol of the whole-cache flash_decode,
    at lengths that leave 0-3 blocks empty; a misaligned block raises and
    launches nothing."""
    from repro_torch.core.fp_bounds import decode_lse_tol
    from repro_torch.kernels.flash_attention import flash_attention as fa
    rng = np.random.RandomState(26)
    T, blocks = 1088, 4
    rows = T // blocks
    q, k, v = _qkv(rng, 8, 1, T, 24, 8, 128, dtype, cuda)
    for length in (1025, 5, rows, rows + 1, T):
        n = torch.tensor([length], dtype=torch.int32, device=cuda)
        os, lses = [], []
        for b in range(blocks):
            kb, vb = k[:, b * rows:(b + 1) * rows], v[:, b * rows:(b + 1) *
                                                      rows]
            live = max(0, min(length - b * rows, rows))
            before = fa.flash_decode_partial.launches
            o, lse = fa.flash_decode_partial(q, kb, vb,
                                             (n - b * rows).clamp(0, rows))
            ro, rl = fa.decode_partial_ref(q, kb, vb, live)
            torch.cuda.synchronize()
            assert fa.flash_decode_partial.launches == before + 1
            assert o.dtype == lse.dtype == torch.float32
            assert o.shape == q.shape and lse.shape == q.shape[:-1]
            if live == 0:
                assert torch.equal(o, torch.zeros_like(o))
                assert bool(torch.isneginf(lse).all())
            else:
                ok, err = _within_attention_tol(o, ro, q, kb, vb,
                                                causal=False, length=live)
                assert ok, (length, b, err)
                lerr = (lse.double() - rl.double()).abs()
                assert bool((lerr <= decode_lse_tol(q, kb, live)).all()), \
                    (length, b, float(lerr.max()))
            os.append(o)
            lses.append(lse)
        comb = fa.combine_partials(torch.stack(os), torch.stack(lses),
                                   q.dtype)
        whole = fa.flash_decode(q, k, v, n)
        ok, err = _within_attention_tol(comb, whole, q, k, v, causal=False,
                                        length=length)
        assert ok, (length, err)
    odd = torch.zeros((8 * 16 * 8 * 128 + 1,), dtype=dtype, device=cuda)[
        1:].view(8, 16, 8, 128)
    before = fa.flash_decode_partial.launches
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_decode_partial(q, odd, odd, 3)
    assert fa.flash_decode_partial.launches == before


@pytest.mark.gpu
def test_flash_decode_partial_op_launches_on_card(cuda):
    """The custom op repro_torch::flash_decode_partial on CUDA tensors
    launches the kernel (counted) and gives the wrapper's pair."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    rng = np.random.RandomState(27)
    q, k, v = _qkv(rng, 2, 1, 128, 8, 2, 64, torch.bfloat16, cuda)
    length = torch.tensor([37], dtype=torch.int32, device=cuda)
    before = fa.flash_decode_partial.launches
    o, lse = torch.ops.repro_torch.flash_decode_partial.default(
        q, k, v, length, None)
    want = fa.flash_decode_partial(q, k, v, length)
    torch.cuda.synchronize()
    assert fa.flash_decode_partial.launches == before + 2
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


@pytest.mark.gpu
def test_card_mesh_decode_equals_plain_on_card(card_mesh):
    """phi4-mini smoke's decode step on the (1, 1) card mesh under the
    decode rules (the cache's rows over "model"): one flash_decode_partial
    launch a layer and no flash_decode, the logits and both caches bit for
    bit the plain step's on the same weights."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.mesh import rules_for_cell
    from repro_torch.models.transformer import init_caches, init_lm, lm_specs
    from repro_torch.runtime import sharding as tsh
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.runtime.step import make_decode_step, serve_state_specs
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                              dtype=torch.bfloat16)
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    caches = init_caches(cfg, 2, 64, dtype=cfg.dtype, device="cuda")
    for t in caches.values():
        t.normal_(generator=torch.Generator(device="cuda").manual_seed(1))
    tok = torch.tensor([[3], [7]], dtype=torch.int32, device="cuda")
    rules = rules_for_cell("decode")
    placed = reshard_state(params, lm_specs(cfg), card_mesh, rules)
    on_mesh = reshard_state({n: t.clone() for n, t in caches.items()},
                            serve_state_specs(cfg)[0], card_mesh, rules)
    step = make_decode_step(cfg)
    with torch.no_grad():
        _, want, caches, _ = step(params, tok, caches, None, 40)
        before = (fa.flash_decode.launches, fa.flash_decode_partial.launches)
        with tsh.use_rules(card_mesh, rules):
            _, got, on_mesh, _ = step(placed, tsh.distribute(
                tok, card_mesh, tsh.placements_of(
                    tsh.spec_of(("batch", None)), card_mesh)),
                on_mesh, None, 40)
    torch.cuda.synchronize()
    assert (fa.flash_decode.launches, fa.flash_decode_partial.launches) == \
        (before[0], before[1] + cfg.n_layers)
    assert torch.equal(got.full_tensor(), want)
    for n in ("k", "v"):
        assert torch.equal(on_mesh[n].full_tensor(), caches[n])


# -- tracing on the card: device time and device counters ---------------------

@pytest.mark.gpu
def test_tracer_spans_carry_device_time_on_card(cuda):
    from repro_torch.obs import Tracer
    tr = Tracer()
    a = torch.randn(2048, 2048, device=cuda)
    a @ a
    torch.cuda.synchronize()
    with tr.span("outer", device=cuda):
        with tr.span("inner", device=cuda):
            for _ in range(10):
                a @ a
        a @ a
        tr.count("live", (a > 0).sum())
        tr.count("host", 1)
    inner, outer = tr.spans()
    assert 0 < inner.device_s < outer.device_s
    # ten 17.2 GFLOP products take more than a millisecond on any card
    assert inner.device_s > 1e-3
    assert tr.counters() == {"live": float((a > 0).sum()), "host": 1.0}
    pooled = len(tr._pool)
    assert pooled == 4
    with tr.span("again", device=cuda):
        a @ a
    assert len(tr._pool) == pooled - 2
    assert tr.spans()[-1].device_s > 0 and len(tr._pool) == pooled


@pytest.mark.gpu
def test_tracer_span_inside_graph_capture_is_not_timed(cuda):
    from repro_torch.obs import Tracer
    tr = Tracer()
    x = torch.ones(1024, device=cuda)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        x * 2
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        with tr.span("captured", device=cuda):
            y = x * 2
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2)
    (sp,) = tr.spans()
    assert sp.device_s is None


@pytest.mark.gpu
def test_traced_train_step_times_every_span_on_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.configs.registry import get_smoke
    from repro_torch.runtime.step import init_train_state, make_train_step
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), remat="full")
    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    state = init_train_state(cfg, gen(0), device=cuda)
    rows = torch.randint(0, cfg.vocab, (2, 33), device=cuda, generator=gen(1))
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    tr = obs.Tracer()
    state, _ = make_train_step(cfg, tracer=tr)(state, batch)
    spans = tr.spans()
    assert all(s.device_s is not None and s.device_s > 0 for s in spans)
    by = {}
    for s in spans:
        by[s.name] = by.get(s.name, 0.0) + s.device_s
    parts = by["train/forward"] + by["train/backward"] + by["train/optimizer"]
    assert parts <= by["train/step"] * (1 + 1e-3)
    for name in ("moe/route", "moe/dispatch", "moe/experts", "moe/combine"):
        assert sum(s.name == name for s in spans) == 2 * cfg.n_layers
    c = tr.counters()
    assert 0 < c["moe/live_slots"] <= c["moe/slots"]
    # a profiled step fills the process tracer, with device time: the
    # session's first call cleared what an earlier session left there
    proc = obs.process_tracer()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state, _ = make_train_step(cfg)(state, batch)
    new = proc.spans()
    assert sum(s.name == "train/step" for s in new) == 1
    assert all(s.device_s is not None for s in new)


# -- the fused AdamW (csrc/adamw.cu) against its plain version ----------------

# leaf sizes: a vector tail, one element, several partial sums, a matrix, none
ADAMW_SIZES = {"z_tail": (2048 + 3,), "a_one": (1,), "m_tiles": (3 * 16384 + 5,),
               "k_mat": (37, 129), "e_empty": (0,)}
ADAMW_DTYPES = (torch.bfloat16, torch.float32)


def _adamw_tree(dev, gdt, pdt, seed, sizes=ADAMW_SIZES, odd=("z_tail",),
                gscale=1e-3):
    """``(grads, AdamWState, params)`` on ``dev``, drawn from ``seed``; the
    leaves named in ``odd`` are views one element into their buffers (not
    16-byte aligned) in every tree.  The dict's keys are out of sorted
    order, so the update's tree order and the norm's leaf order differ.
    Gradients of ``gscale`` 1e-3 have a global norm under 1: the clip
    scale is exactly 1 on both paths, whose norms differ in the last bits
    (their sums run in other orders), and a step of lr 1e-2 on master
    weights of 5e-2 cancels enough to turn one ulp of a scale into dozens
    of the master's."""
    from repro_torch.optim.adamw import AdamWState
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, dtype, scale, off):
        n = int(np.prod(shape))
        buf = (torch.randn(n + off, generator=gen) * scale).to(dtype)
        return buf.to(dev)[off:].view(shape)

    trees = {k: {} for k in ("g", "w", "m", "v", "p")}
    for name, shape in sizes.items():
        off = int(name in odd)
        trees["g"][name] = draw(shape, gdt, gscale, off)
        trees["w"][name] = draw(shape, torch.float32, 5e-2, off)
        trees["m"][name] = draw(shape, torch.float32, 1e-3, off)
        trees["v"][name] = draw(shape, torch.float32, 1e-3, off).square_()
        trees["p"][name] = draw(shape, pdt, 1.0, off)
    state = AdamWState(step=torch.tensor(3, dtype=torch.int32, device=dev),
                       master=trees["w"], m=trees["m"], v=trees["v"])
    return trees["g"], state, trees["p"]


def _adamw_clone(grads, state, params):
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.tree import tree_map
    return (grads, AdamWState(step=state.step.clone(),
                              master=tree_map(torch.clone, state.master),
                              m=tree_map(torch.clone, state.m),
                              v=tree_map(torch.clone, state.v)),
            tree_map(torch.clone, params))


def _adamw_steps(update, grads, state, params, pdt, steps=2, **kw):
    lr = torch.full((), 1e-2, device=state.step.device)
    for _ in range(steps):
        params, state, met = update(grads, state, lr, param_dtype=pdt,
                                    params=params, **kw)
    torch.cuda.synchronize()
    return params, state, met["grad_norm"]


def _local_leaves(tree):
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree)]


def _assert_adamw_close(got, want):
    """m, v and the master within 4 ulps, the parameter within 1, the
    gradient norm within 1e-6 relative."""
    from repro_torch.core.fp_bounds import ulps_apart
    (gp, gs, gn), (wp, ws, wn) = got, want
    for name, a, b, ulps in (("master", gs.master, ws.master, 4),
                             ("m", gs.m, ws.m, 4), ("v", gs.v, ws.v, 4),
                             ("param", gp, wp, 1)):
        for x, y in zip(_local_leaves(a), _local_leaves(b)):
            assert x.dtype == y.dtype and x.shape == y.shape
            if x.numel():
                assert int(ulps_apart(x, y).max()) <= ulps, name
    gn, wn = (float(x.full_tensor() if hasattr(x, "full_tensor") else x)
              for x in (gn, wn))
    assert abs(gn - wn) <= 1e-6 * wn, (gn, wn)


@pytest.mark.gpu
@pytest.mark.parametrize("gdt", ADAMW_DTYPES)
@pytest.mark.parametrize("pdt", ADAMW_DTYPES)
def test_adamw_kernels_match_plain_on_card(cuda, gdt, pdt):
    """Two steps of ``adamw_update`` (the kernels: vector tails, a
    misaligned view, an empty leaf, several partial sums) against
    ``adamw_update_plain`` on copies of the same card tensors; one launch
    of each kernel a step; the parameter written in place."""
    from repro_torch.kernels import adamw as ak
    from repro_torch.optim.adamw import adamw_update, adamw_update_plain
    tree = _adamw_tree(cuda, gdt, pdt, seed=1)
    twin = _adamw_clone(*tree)
    before = ak.adamw_sumsq.launches, ak.adamw_apply.launches
    got = _adamw_steps(adamw_update, *tree, pdt)
    assert (ak.adamw_sumsq.launches - before[0],
            ak.adamw_apply.launches - before[1]) == (2, 2)
    assert all(a is b for a, b in zip(got[0].values(), tree[2].values()))
    want = _adamw_steps(adamw_update_plain, *twin, pdt)
    assert (ak.adamw_sumsq.launches - before[0],
            ak.adamw_apply.launches - before[1]) == (2, 2)
    _assert_adamw_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("pdt", ADAMW_DTYPES)
def test_adamw_kernels_clip_as_the_plain_version_on_card(cuda, pdt):
    """Gradients of norm about 240, clipped to 1: the kernels' step equals
    the plain version's on the f32 gradients scaled by the kernels' own
    clip scale (a norm of 1 up to rounding, under its max_norm of 2, so
    scale 1 there): the scale read on
    the card multiplies each f32 gradient once, as there."""
    from repro_torch.optim.adamw import (_clip_scale, adamw_update,
                                         adamw_update_plain)
    from repro_torch.tree import tree_map
    grads, state, params = _adamw_tree(cuda, torch.float32, pdt, seed=10,
                                       gscale=1.0)
    twin = _adamw_clone(grads, state, params)
    got = _adamw_steps(adamw_update, grads, state, params, pdt, steps=1)
    scale = _clip_scale(got[2], 1.0)
    assert float(scale) < 1e-2
    scaled = tree_map(lambda g: g * scale, twin[0])
    want = _adamw_steps(adamw_update_plain, scaled, *twin[1:], pdt, steps=1,
                        max_norm=2.0)
    _assert_adamw_close(got[:2] + (want[2],), want)


@pytest.mark.gpu
def test_adamw_kernels_cast_leaves_of_another_dtype_on_card(cuda):
    """A parameter of another dtype than ``param_dtype`` (or none) gets a
    new tensor, as in the plain version; the old leaf is left as it was."""
    from repro_torch.optim.adamw import adamw_update, adamw_update_plain
    grads, state, params = _adamw_tree(cuda, torch.bfloat16, torch.float32,
                                       seed=2)
    kept = {k: t.clone() for k, t in params.items()}
    twin = _adamw_clone(grads, state, params)
    got = _adamw_steps(adamw_update, grads, state, params, torch.bfloat16)
    want = _adamw_steps(adamw_update_plain, *twin, torch.bfloat16)
    for k, t in got[0].items():
        assert t.dtype == torch.bfloat16 and t is not params[k]
        assert torch.equal(params[k], kept[k])
    _assert_adamw_close(got, want)
    grads, state, _ = _adamw_tree(cuda, torch.float32, torch.float32, seed=3)
    twin = _adamw_clone(grads, state, {})
    got = _adamw_steps(adamw_update, grads, state, None, torch.bfloat16)
    want = _adamw_steps(adamw_update_plain, twin[0], twin[1], None,
                        torch.bfloat16)
    _assert_adamw_close(got, want)


@pytest.mark.gpu
def test_adamw_tree_larger_than_a_table_on_card(cuda):
    """150 leaves (three tables of at most 64, dtypes mixed) take three
    launches of each kernel a step, and match the plain version."""
    from repro_torch.kernels import adamw as ak
    from repro_torch.optim.adamw import adamw_update, adamw_update_plain
    rng = np.random.RandomState(4)
    sizes = {f"l{i:03d}": (int(rng.randint(0, 5000)),) for i in range(150)}
    grads, state, params = _adamw_tree(cuda, torch.bfloat16, torch.bfloat16,
                                       seed=4, sizes=sizes,
                                       odd=("l007", "l100"))
    grads = {k: (g.float() if i % 3 == 0 else g)
             for i, (k, g) in enumerate(grads.items())}
    twin = _adamw_clone(grads, state, params)
    assert [len(r) for r in ak.tables(150)] == [64, 64, 22]
    before = ak.adamw_sumsq.launches, ak.adamw_apply.launches
    got = _adamw_steps(adamw_update, grads, state, params, torch.bfloat16)
    assert (ak.adamw_sumsq.launches - before[0],
            ak.adamw_apply.launches - before[1]) == (6, 6)
    want = _adamw_steps(adamw_update_plain, *twin, torch.bfloat16)
    _assert_adamw_close(got, want)


@pytest.mark.gpu
def test_adamw_kernels_give_the_same_bits_twice_on_card(cuda):
    """Two runs on the same inputs: every state leaf, every parameter and
    the norm bit for bit (no float atomics); the sums of squares of a leaf
    of 2^24 + 3 elements too."""
    from repro_torch.kernels.adamw import adamw_sumsq
    from repro_torch.optim.adamw import adamw_update
    runs = [_adamw_steps(adamw_update, *_adamw_tree(
        cuda, torch.bfloat16, torch.bfloat16, seed=6), torch.bfloat16)
        for _ in range(2)]
    (ap, as_, an), (bp, bs, bn) = runs
    assert torch.equal(an, bn)
    for a, b in zip(_local_leaves([ap, as_.master, as_.m, as_.v]),
                    _local_leaves([bp, bs.master, bs.m, bs.v])):
        assert torch.equal(a, b)
    big = torch.randn(2 ** 24 + 3, device=cuda).to(torch.bfloat16)
    assert torch.equal(adamw_sumsq([big, big[1:]]),
                       adamw_sumsq([big, big[1:]]))
    ref = big.double().square().sum()
    assert abs(float(adamw_sumsq([big])[0]) - float(ref)) <= 1e-6 * float(ref)


@pytest.mark.gpu
def test_adamw_update_does_not_sync_on_card(cuda):
    """With the device lr, ``adamw_update`` on card tensors makes no call
    that waits for the device."""
    from repro_torch.optim.adamw import adamw_update
    tree = _adamw_tree(cuda, torch.bfloat16, torch.bfloat16, seed=7)
    lr = torch.full((), 1e-2, device=cuda)
    adamw_update(*tree[:2], lr, params=tree[2])  # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adamw_update(*tree[:2], lr, params=tree[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_adamw_counts_every_element_as_the_kernels_on_card(cuda):
    """Under a tracer: ``adamw/kernel_elems`` equals ``adamw/elems``, every
    element of the tree, on the card; only ``adamw/elems`` for the plain
    version."""
    from repro_torch import obs
    from repro_torch.optim.adamw import adamw_update, adamw_update_plain
    tree = _adamw_tree(cuda, torch.bfloat16, torch.bfloat16, seed=8)
    n = sum(int(np.prod(s)) for s in ADAMW_SIZES.values())
    lr = torch.full((), 1e-2, device=cuda)
    tr = obs.Tracer()
    with obs.use(tr):
        adamw_update(*tree[:2], lr, params=tree[2])
    assert tr.counters() == {"adamw/elems": n, "adamw/kernel_elems": n}
    tr = obs.Tracer()
    with obs.use(tr):
        adamw_update_plain(*tree[:2], lr, params=tree[2])
    assert tr.counters() == {"adamw/elems": n}


@pytest.mark.gpu
def test_adamw_kernels_refuse_what_they_do_not_take_on_card(cuda):
    from repro_torch.kernels.adamw import adamw_apply, adamw_sumsq
    with pytest.raises(TypeError, match="dtype"):
        adamw_sumsq([torch.ones(8, dtype=torch.float16, device=cuda)])
    with pytest.raises(ValueError, match="CUDA"):
        adamw_sumsq([torch.ones(8, device=cuda), torch.ones(8)])
    g = torch.ones(8, device=cuda)
    w = torch.ones(16, device=cuda)[::2]
    one = torch.ones((), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        adamw_apply([g], [w], [g.clone()], [g.clone()], [g.clone()],
                    scale=one, c1=one, c2=one, lr=one, b1=0.9, b2=0.95,
                    eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError, match="size"):
        adamw_apply([g], [torch.ones(9, device=cuda)], [g.clone()],
                    [g.clone()], [g.clone()], scale=one, c1=one, c2=one,
                    lr=one, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


@pytest.mark.gpu
def test_adamw_kernels_on_card_mesh_shards(card_mesh):
    """DTensor leaves on the (1, 1) card mesh (sharded and replicated):
    the kernels run on each local shard, the norm a partial sum where a
    leaf is sharded, and the result matches the plain version's."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.kernels import adamw as ak
    from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                         adamw_update_plain)
    from repro_torch.tree import tree_map
    sizes = {k: s for k, s in ADAMW_SIZES.items() if k != "e_empty"}

    def placed(seed):
        grads, state, params = _adamw_tree(torch.device("cuda"),
                                           torch.bfloat16, torch.bfloat16,
                                           seed=seed, sizes=sizes, odd=())
        put = lambda t: distribute_tensor(  # noqa: E731
            t, card_mesh, [Shard(0), Replicate()] if t.shape[0] > 40
            else [Replicate(), Replicate()])
        return (tree_map(put, grads),
                AdamWState(step=state.step, master=tree_map(put, state.master),
                           m=tree_map(put, state.m), v=tree_map(put, state.v)),
                tree_map(put, params))

    before = ak.adamw_apply.launches
    got = _adamw_steps(adamw_update, *placed(9), torch.bfloat16)
    assert ak.adamw_apply.launches - before == 2
    assert all(isinstance(t, DTensor) for t in got[0].values())
    want = _adamw_steps(adamw_update_plain, *placed(9), torch.bfloat16)
    _assert_adamw_close(got, want)
