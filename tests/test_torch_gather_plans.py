"""The host plans of the two kernels redesigned for slice 9, held on the
CPU without a card.

* ``tm_affine_gather``: the path :func:`gather_launch` picks per map,
  dtype and alignment (the separable path over the shortest suffix of
  output axes across which the source address separates, in 16-byte
  accesses where aligned; else the general kernel), its run length ``R``, its
  access width ``V`` and its tables.  A numpy model of the separable
  kernel's arithmetic over those tables (each run's outer digits decoded
  with the magic-number divisions, ``base(outer) + off[p]``, validity,
  fill) is held bit for bit against the JAX package's own
  ``gather_indices`` for the same map, passed through its
  ``MixedRadixMap.encode()`` JSON.
* ``xchain_prologue``: the scratch the chain phase fills (the crossing
  operand's shape) and the cooperative grid of the product's plan, on the
  CPU model of the card's limits.

The kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import affine as jaf  # noqa: E402
from repro.core.engine import gather_indices as jax_gather_indices  # noqa: E402
from repro_torch.core import affine as af  # noqa: E402
from repro_torch.core.instr import TMProgram as TProgram  # noqa: E402
from repro_torch.kernels.img2col import img2col as ik  # noqa: E402
from repro_torch.kernels.matmul_tm import chain as xc  # noqa: E402
from repro_torch.kernels.tm_affine import tm_affine as ta  # noqa: E402
from repro_torch.kernels.tm_affine.chain import ChainSig  # noqa: E402
from tests.harness import CASES  # noqa: E402
from tests.test_torch_gpu import CAP_MAPS, GATHER_MAPS  # noqa: E402
from tests.test_torch_kernel_plans import _div  # noqa: E402

DTYPES = (torch.int8, torch.bfloat16, torch.float32)
CPU = torch.device("cpu")
TABLE3 = (448, 448, 64)


def _harness_gather_maps() -> dict:
    """Every gather-mode map of the harness's operator programs."""
    out = {}
    for case in CASES:
        prog, _ = case.build()
        for i, ins in enumerate(TProgram.decode(prog.encode()).instrs):
            maps = (ins.map_,) if ins.map_ is not None else ins.maps or ()
            for j, m in enumerate(maps):
                if ta.analyze_block_mode(m) is None:
                    out[f"{case.name}.{i}.{j}"] = m
    return out


# the four Table III operator maps that reach gather mode, at a small size
# (the full size is checked by name below), and the card tests' maps
MAPS = {
    **_harness_gather_maps(),
    **GATHER_MAPS,
    **CAP_MAPS,
    "upsample_small": af.upsample_map((6, 5, 16), 2),
    "pixelshuffle_small": af.pixel_shuffle_map((6, 5, 64), 2),
    "pixelunshuffle_small": af.pixel_unshuffle_map((6, 10, 16), 2),
    "rearrange_small": af.rearrange_map((6, 5, 3), 1, 16),
    "pad_hw": af.pad_map((12, 10, 8), (1, 0, 0), (0, 2, 0), fill=5.0),
    "pad_c": af.pad_map((12, 10, 8), (0, 0, 2), (0, 0, 6), fill=-1.0),
    "img2col_general": af.img2col_map((64, 64, 8), 3, 3, 1, 1),
}


def _params(aligned=(True, False)):
    return [pytest.param(n, d, a, id=f"{n}-{str(d)[6:]}-"
                         f"{'al' if a else 'off'}")
            for n in MAPS for d in DTYPES for a in aligned]


def _x(m, dtype, aligned):
    """An x of the map's input shape, 16-byte aligned or one element off."""
    n = math.prod(m.in_shape)
    buf = torch.zeros(n + 16, dtype=dtype)
    lead = (-buf.data_ptr() % 16) // buf.element_size()
    start = lead if aligned else lead + 1
    return buf[start:start + n].view(m.in_shape)


def _model(m, launch, itemsize):
    """The separable kernel over the launch's tables, in numpy: per output
    element its source flat index and whether it reads x (else fill)."""
    w = launch.regs.tolist()
    tab = launch.table.numpy().astype(np.int64)
    ve = launch.vbytes // itemsize
    U = w[4]
    assert len(tab) == U
    units = math.prod(m.out_shape) // ve
    n_runs = units // U
    # each run's outer digits, as sep_run decodes them
    n_ax, n_sp, n_rows, n_b = w[0:4]
    rem = np.arange(n_runs, dtype=np.uint64)
    dig = [None] * (n_ax + n_sp)
    for a in range(n_ax - 1, 0, -1):
        q = _div(rem, w[12 + a], w[24 + a], w[36 + a])
        dig[a], rem = rem - q * np.uint64(w[12 + a]), q
    if n_ax > 0:
        dig[0] = rem
    for j in range(n_sp):
        ax, v = w[48 + j], dig[w[48 + j]]
        q = _div(v, w[60 + j], w[72 + j], w[84 + j])
        dig[ax], dig[n_ax + j] = q, v - q * np.uint64(w[60 + j])
    dig = [d.astype(np.int64) for d in dig]
    ok = np.ones(n_runs, dtype=bool)
    for k in range(n_b):
        ok &= dig[w[96 + k]] < w[108 + k]
    base = np.zeros(n_runs, dtype=np.int64)
    for r in range(n_rows):
        offn, den, hi, stride, checked = w[120 + 5 * r:125 + 5 * r]
        acc = np.full(n_runs, offn, dtype=np.int64)
        for d in range(n_ax + n_sp):
            acc = acc + w[180 + 2 * ta.MAX_AXES * r + d] * dig[d]
        c = acc if den == 1 else np.floor_divide(acc, den)
        if checked:
            ok &= (c >= 0) & (c <= hi)
            c = np.clip(c, 0, hi)
        base += c * stride
        # every partial sum stays in the kernel's 32 bits
        assert np.abs(base).max(initial=0) < 2 ** 31
    # each access: run q = i // U (the magic division), entry p = i % U
    i = np.arange(units, dtype=np.uint64)
    q = _div(i, U, w[5], w[6]).astype(np.int64)
    o = tab[i.astype(np.int64) - q * U]
    reads = ok[q] & (o != ta.SEP_INVALID)
    unit = np.where(reads, base[q] + o, 0)
    src = (unit[:, None] * ve + np.arange(ve)).reshape(-1)
    return src, np.repeat(reads, ve)


@pytest.mark.parametrize("name,dtype,aligned", _params())
def test_gather_plan_path_and_table(name, dtype, aligned):
    """The path, run and access width the launch takes: the separable
    path's run is the product of its suffix's extents, within the cap; a
    wide access needs x aligned to it (else element by element); the run
    table is the plan's offsets in units of the access, fill entries
    marked; the general path keeps the map's register file."""
    m = MAPS[name]
    x = _x(m, dtype, aligned)
    itemsize = x.element_size()
    plan = ta.separable_plan(m, itemsize)
    launch = ta.gather_launch(m, x)
    if plan is None:
        assert launch.path == "general" and launch.table is None
        regs, narrow = ta._gather_regs(m, dtype, CPU)
        assert torch.equal(launch.regs, regs) and launch.narrow == narrow
        return
    assert launch.path == "separable" and launch.narrow
    assert plan.R == math.prod(m.out_shape[plan.suffix:]) <= ta.SEP_CAP
    assert plan.vbytes in (itemsize, 16)
    assert plan.vbytes == itemsize or plan.vbytes >= 2 * itemsize
    want = plan.vbytes if aligned else itemsize
    assert launch.vbytes == want
    ve = want // itemsize
    assert plan.R % ve == 0 and launch.table.numel() == plan.R // ve
    tab = launch.table.numpy()
    valid = plan.valid[::ve]
    assert np.array_equal(tab == ta.SEP_INVALID, ~valid)
    assert np.array_equal(tab[valid], plan.off[::ve][valid] // ve)
    words = launch.regs.tolist()
    assert len(words) == ta.SEP_WORDS and words[4] == plan.R // ve
    assert words[7] == ta._fill_bits(m.fill, dtype)
    assert words[0] == plan.suffix == len(plan.oshape)


def _separable_params():
    """The maps with a separable plan in every dtype (the plan depends on
    the map alone, so every worker collects the same list)."""
    return [p for p in _params()
            if ta.separable_plan(MAPS[p.values[0]], 1) is not None]


@pytest.mark.parametrize("name,dtype,aligned", _separable_params())
def test_separable_addresses_match_jax_gather_indices(name, dtype, aligned):
    """The kernel's addresses over the tables, bit for bit the JAX
    package's gather_indices of the same map (through its encode() JSON):
    the same elements read fill, the others the same source element; and
    the values, fill included, those of the plain version."""
    m = MAPS[name]
    x = _x(m, dtype, aligned)
    launch = ta.gather_launch(m, x)
    assert launch.path == "separable"
    jm = jaf.MixedRadixMap.decode(json.loads(json.dumps(m.encode())))
    jflat, jvalid = (np.asarray(a).reshape(-1)
                     for a in jax_gather_indices(jm))
    src, reads = _model(m, launch, x.element_size())
    assert np.array_equal(reads, jvalid)
    assert np.array_equal(src[reads], jflat[reads])
    rng = np.random.RandomState(9)
    x.copy_(torch.tensor(rng.randint(-99, 100, size=m.in_shape)).to(dtype))
    fill = torch.tensor(m.fill, dtype=dtype)
    got = torch.where(torch.from_numpy(reads), x.reshape(-1)[
        torch.from_numpy(src)], fill).reshape(m.out_shape)
    assert torch.equal(got, ta.gather_plain(x, m))


# the four Table III operator maps at full size: (suffix, R, vbytes by
# itemsize 1 / 2 / 4, run table in elements)
def _unshuffle_offsets():
    p = np.arange(256)
    cqq, dy, dx = p // 4, p // 2 % 2, p % 2
    return dy * 896 * 64 + dx * 64 + cqq


TABLE3_PLANS = {
    "upsample": (af.upsample_map(TABLE3, 2), 2, 64, (16, 16, 16),
                 np.arange(64)),
    "pixelshuffle": (af.pixel_shuffle_map(TABLE3, 2), 2, 16, (1, 2, 4),
                     4 * np.arange(16)),
    "pixelunshuffle": (af.pixel_unshuffle_map((896, 896, 64), 2), 2, 256,
                       (1, 2, 4), _unshuffle_offsets()),
    "rearrange": (af.rearrange_map((448, 448, 3), 1, 16), 2, 16, (1, 2, 4),
                  np.where(np.arange(16) < 3, np.arange(16),
                           ta.SEP_INVALID)),
}


@pytest.mark.parametrize("name", list(TABLE3_PLANS))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_table3_gather_plans(name, dtype):
    """The plans the kernel's design is measured on: upsample in 16-byte
    accesses (one run per output pixel's C channels), the other three
    element by element from their run tables."""
    m, suffix, R, vbytes, off = TABLE3_PLANS[name]
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = ta.separable_plan(m, itemsize)
    assert (plan.suffix, plan.R, plan.vbytes) == \
        (suffix, R, vbytes[(1, 2, 4).index(itemsize)])
    assert np.array_equal(np.where(plan.valid, plan.off, ta.SEP_INVALID),
                          off)
    launch = ta.gather_launch(m, _x(m, dtype, True))
    ve = launch.vbytes // itemsize
    assert np.array_equal(launch.table.numpy(),
                          np.where(off[::ve] == ta.SEP_INVALID,
                                   ta.SEP_INVALID, off[::ve] // ve))


def test_gather_plan_takes_a_run_table_at_the_cap():
    """A run of SEP_CAP elements is the longest the separable path takes:
    its element table holds SEP_CAP entries (the pixel shuffle's always,
    the upsample's on an x off 16 B); one more channel keeps the general
    kernel."""
    for name, m in CAP_MAPS.items():
        for dtype in (torch.int8, torch.float32):
            plan = ta.separable_plan(m, torch.empty((), dtype=dtype)
                                     .element_size())
            assert plan.R == ta.SEP_CAP, name
            launch = ta.gather_launch(m, _x(m, dtype, False))
            assert launch.path == "separable"
            assert launch.table.numel() == ta.SEP_CAP, (name, dtype)
    m = af.pixel_shuffle_map((2, 3, 4 * (ta.SEP_CAP + 1)), 2)
    assert ta.separable_plan(m, 4) is None
    assert ta.gather_launch(m, _x(m, torch.float32, True)).path == "general"


def test_gather_plan_declines_what_does_not_separate():
    """A row that mixes a suffix digit with an outer one under a floor
    division or a bounds check keeps the general kernel when no suffix
    within the cap separates; so does a map that needs 64 bits."""
    m = af.img2col_map((64, 64, 8), 3, 3, 1, 1)  # ky + oh, checked
    assert ta.separable_plan(m, 4) is None
    assert ta.gather_launch(m, _x(m, torch.float32, True)).path == "general"
    assert ta.separable_plan(GATHER_MAPS["wide_rows"], 4) is None
    # a small map separates over its whole output (one run)
    m = af.img2col_map((8, 9, 3), 3, 3, 2, 1, fill=-1.0)
    plan = ta.separable_plan(m, 4)
    assert plan.suffix == 0 and plan.R == math.prod(m.out_shape)


# ---------------------------------------------------------------------------
# xchain_prologue: the scratch and the cooperative grid
# ---------------------------------------------------------------------------

def _neck():
    batch = (8,)
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), batch)
    route = tuple(af.batch_extend_map(m, batch) for m in
                  af.route_maps([(28, 28, 128), (28, 28, 128)]))
    return ((up, None),), route


def _prologues():
    links, route = _neck()
    small = af.batch_extend_map(af.upsample_map((5, 6, 16), 2), (2,))
    return {
        # the YOLOv3-Tiny neck into head 2's 1x1 conv
        "yolo_neck": (links, route, xc.Gemm("conv", (8, 28, 28, 256),
                                            (1, 1, 256, 255), 1, "SAME"), 0),
        # a 3x3 conv consumer of an upsample
        "conv3x3": (((small, None),), None,
                    xc.Gemm("conv", (2, 10, 12, 16), (3, 3, 16, 24), 1,
                            "SAME"), 0),
        # the weights through a transpose (cross_pos 1)
        "mm_weights": (((af.axis_permutation_map((40, 96), (1, 0)), None),),
                       None, xc.Gemm("mm", (300, 96), (96, 40)), 1),
        "mm_rows": (((af.axis_permutation_map((96, 300), (1, 0)), None),),
                    None, xc.Gemm("mm", (300, 96), (96, 40)), 0),
    }


PROLOGUES = _prologues()


class _Fake:
    """Stands in for an operand where the plan reads only its address and
    element size."""

    def __init__(self, dtype, ptr):
        self._size = torch.empty((), dtype=dtype).element_size()
        self._ptr = ptr

    def element_size(self):
        return self._size

    def data_ptr(self):
        return self._ptr


@pytest.mark.parametrize("name", list(PROLOGUES))
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.bfloat16,
                                   torch.float32],
                         ids=lambda d: str(d)[6:])
def test_prologue_plan_scratch_and_grid(name, dtype):
    """The chain fills a scratch of the crossing operand's shape (the mm's
    x or w, the conv's NHWC input), which the product reads as that
    operand: TMA where its rows allow (the scratch is a fresh allocation,
    16-byte aligned), and a cooperative grid no larger than the blocks the
    plan puts on the card, covering every tile."""
    links, route, g, pos = PROLOGUES[name]
    dt = str(dtype).removeprefix("torch.")
    sig = ChainSig(links=links, route_maps=route,
                   route_band=0 if route else None, dtype=dt)
    operand = (g.x_shape, g.w_shape)[pos]
    assert tuple(sig.out_shape) == operand
    a = _Fake(dtype, 0 if pos == 0 else 4)  # x off 16 bytes at pos 1
    M, N, K, C, taps = xc._commit_geometry(g)
    product = ik.conv_plan(M, N, K, dtype, tma=xc._commit_tma_ok(g, a),
                           C=C, taps=taps)
    plan = xc.prologue_grid(product)
    itemsize = a.element_size()
    rows = K if C is None else C
    assert plan.path == ("tma" if pos == 0 and rows * itemsize % 16 == 0
                         else "cp.async")
    # every block the card holds at once walks the chain; the product's
    # tiles are product.grid's blocks' (the others have none)
    assert plan.grid == plan.blocks_per_sm * plan.sms >= product.grid
    assert product.grid == min(plan.tiles, plan.blocks_per_sm * plan.sms)
    assert (plan.path, plan.BM, plan.BN, plan.stages, plan.tiles) == \
        (product.path, product.BM, product.BN, product.stages, product.tiles)
    assert ik.model_occupancy(plan.threads, plan.smem) >= plan.blocks_per_sm
    assert plan.tiles == -(-M // plan.BM) * -(-N // plan.BN)
    seen = np.zeros(plan.tiles, dtype=np.int64)
    for b in range(plan.grid):
        seen[b::plan.grid] += 1
    assert (seen == 1).all()


def test_prologue_plan_at_the_yolo_neck():
    """The neck's product: one round of tiles on the card (K 256, TMA
    im2col over the scratch), while every block the card holds walks the
    chain; its scratch is the 6.4 MB (8, 28, 28, 256) f32 input of
    head 2."""
    links, route, g, _ = PROLOGUES["yolo_neck"]
    sig = ChainSig(links=links, route_maps=route, route_band=0)
    assert math.prod(sig.out_shape) * 4 == 6422528
    M, N, K, C, taps = xc._commit_geometry(g)
    plan = xc.prologue_grid(ik.conv_plan(
        M, N, K, torch.float32,
        tma=xc._commit_tma_ok(g, _Fake(torch.float32, 0)), C=C, taps=taps))
    # the 1x1 conv runs as its mm, (6272, 256) x (256, 255): TMA 2-d boxes
    assert g.words()[:6] == [0, 6272, 255, 256, 255, 0] and C is None
    # 8 x 4 tiles a thread: 264 tiles of 96 x 64, two blocks of 6 warps an
    # SM (8 x 8 tiles would make 132 tiles of 192 x 64: 6 warps an SM)
    assert (plan.path, plan.BM, plan.BN, plan.nct, plan.tiles,
            plan.rounds) == ("tma", 96, 64, 16, 264, 1)
    # the chain phase runs on the same 2 x 132 blocks: 12 warps an SM
    assert plan.grid == 264 and plan.threads == 192 and plan.warps == 12
