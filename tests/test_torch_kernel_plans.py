"""The host plans of two CUDA kernels, held on the CPU without a card.

* ``tm_affine_block``: the register table ``_block_regs`` builds per map and
  dtype — the map's words as before, the path (vector, tile or scalar) and
  the bytes each access moves, and the path's own words.  Besides the
  expected path of named maps, every table is run through a numpy model of
  its path's index arithmetic (the magic-number divisions included) and
  held bit for bit against the plain version.
* ``matmul_tm``: ``mm_plan``'s choice of TMA or cp.async and of the tile.

The kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core import affine as af  # noqa: E402
from repro_torch.core.instr import TMProgram as TProgram  # noqa: E402
from repro_torch.kernels.matmul_tm import matmul_tm as mk  # noqa: E402
from repro_torch.kernels.tm_affine import tm_affine as ta  # noqa: E402
from tests.harness import CASES  # noqa: E402

DTYPES = (torch.int8, torch.int32, torch.bfloat16, torch.float32)
CPU = torch.device("cpu")
AX = ta.MAX_AXES


def _harness_block_maps() -> dict:
    """Every block-mode map of the harness's operator programs."""
    out = {}
    for case in CASES:
        prog, _ = case.build()
        for i, ins in enumerate(TProgram.decode(prog.encode()).instrs):
            maps = (ins.map_,) if ins.map_ is not None else ins.maps or ()
            for j, m in enumerate(maps):
                if ta.analyze_block_mode(m) is not None:
                    out[f"{case.name}.{i}.{j}"] = m
    return out


BLOCK_MAPS = {
    **_harness_block_maps(),
    # the card tests' maps (tests/test_torch_gpu.py)
    "transpose": af.transpose_map((16, 24, 8)),
    "rot90": af.rot90_map((16, 24, 8)),
    "split": af.split_map((16, 24, 8), 2, 1),
    "flip4d": af.flip_map((2, 8, 16, 4), (1, 3)),
    "permute4d": af.axis_permutation_map((2, 8, 16, 4), (2, 0, 3, 1)),
    "split_c3": af.split_map((6, 10, 6), 2, 1),
    "hwc_to_chw": af.axis_permutation_map((24, 40, 36), (2, 0, 1)),
    "chw_to_hwc_ragged": af.axis_permutation_map((5, 33, 70), (1, 2, 0)),
}

# the path each named map takes in every dtype
EXPECTED_PATH = {"flip4d": "scalar", "permute4d": "tile",
                 "hwc_to_chw": "tile", "chw_to_hwc_ragged": "tile",
                 "transpose": "vector", "rot90": "vector", "split": "vector"}


def _block_params():
    return [pytest.param(n, d, id=f"{n}-{str(d)[6:]}")
            for n in BLOCK_MAPS for d in DTYPES]


def _table(name, dtype):
    m = BLOCK_MAPS[name]
    plan = ta.analyze_block_mode(m)
    return m, plan, ta._block_regs(m, plan, dtype, CPU)


def _coefs(m, plan):
    """base and per-axis coefficients of the map, from the plan alone."""
    strides = [math.prod(m.in_shape[a + 1:]) for a in range(len(m.in_shape))]
    coef = [s * strides[a] for s, a in zip(plan.sign, plan.src_axis)]
    base = sum(o * strides[a] for o, a in zip(plan.offset, plan.src_axis))
    return base, coef


def _div(n, d, magic, shifts):
    """The kernels' 32-bit multiply-high division (csrc/tm_affine.cu)."""
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(magic)) >> np.uint64(32)
    q = (t + ((n - t) >> np.uint64(shifts & 0xFF))) >> np.uint64(shifts >> 8)
    assert np.array_equal(q, n // np.uint64(d))
    return q


def _sources(words, count):
    """Source index of each of ``count`` units by block_kernel's arithmetic
    over table words 0-49 (or their vector-unit copy)."""
    ndim, base = int(words[0]), int(words[1])
    shape, coef = words[2:2 + AX], words[2 + AX:2 + 2 * AX]
    magic, shifts = words[2 + 2 * AX:2 + 3 * AX], words[2 + 3 * AX:2 + 4 * AX]
    rem = np.arange(count, dtype=np.uint64)
    src = np.full(count, base, dtype=np.int64)
    for d in range(ndim - 1, 0, -1):
        q = _div(rem, shape[d], magic[d], shifts[d])
        src += (rem - q * np.uint64(shape[d])).astype(np.int64) * coef[d]
        rem = q
    return src + rem.astype(np.int64) * coef[0]


def _tile_model(words, units, xf, numel):
    """tile_kernel's tiles: each read along axis p, written along the
    innermost axis, from the table's tile words."""
    ndim, base = int(words[0]), int(words[1])
    shape, coef = words[2:2 + AX], words[2 + AX:2 + 2 * AX]
    magic, shifts = words[2 + 2 * AX:2 + 3 * AX], words[2 + 3 * AX:2 + 4 * AX]
    tw = words[ta.BLOCK_WORDS + 2:]
    p, last = int(tw[0]), ndim - 1
    rem = np.arange(units, dtype=np.uint64)
    q = _div(rem, tw[4], tw[5], tw[6])
    l0 = (rem - q * np.uint64(tw[4])).astype(np.int64) * ta.TILE_L
    rem = q
    q = _div(rem, tw[1], tw[2], tw[3])
    p0 = (rem - q * np.uint64(tw[1])).astype(np.int64) * ta.TILE_P
    rem = q
    src = base + p0 + l0 * coef[last]
    dst, stride, stride_p = l0.copy(), int(shape[last]), 0
    for d in range(last - 1, -1, -1):
        if d == p:
            stride_p = stride
        else:
            q = _div(rem, shape[d], magic[d], shifts[d])
            od = (rem - q * np.uint64(shape[d])).astype(np.int64)
            rem = q
            src = src + od * coef[d]
            dst = dst + od * stride
        stride *= int(shape[d])
    dst = dst + p0 * stride_p
    i, j = np.meshgrid(np.arange(ta.TILE_P), np.arange(ta.TILE_L),
                       indexing="ij")  # (p, l)
    ok = ((p0[:, None, None] + i < shape[p])
          & (l0[:, None, None] + j < shape[last]))
    s = (src[:, None, None] + i + j * coef[last])[ok]
    o = (dst[:, None, None] + i * stride_p + j)[ok]
    out = np.zeros(numel, dtype=xf.dtype)
    hits = np.zeros(numel, dtype=np.int64)
    out[o] = xf[s]
    np.add.at(hits, o, 1)
    assert (hits == 1).all()  # every output written exactly once
    return out


@pytest.mark.parametrize("name,dtype", _block_params())
def test_block_plan_path_and_width(name, dtype):
    m, plan, r = _table(name, dtype)
    base, coef = _coefs(m, plan)
    size = torch.empty((), dtype=dtype).element_size()
    words = r.table.tolist()
    assert words[ta.BLOCK_WORDS:ta.BLOCK_WORDS + 2] == [
        ta.BLOCK_PATHS[r.path], r.vbytes]
    if name in EXPECTED_PATH:
        assert r.path == EXPECTED_PATH[name]
    p = [d for d in range(len(coef) - 1)
         if coef[d] == 1 and m.out_shape[d] > 1]
    if r.path == "vector":
        assert coef[-1] == 1 and r.vbytes in (2, 4, 8, 16)
        assert r.vbytes >= 2 * size
        for v in (m.out_shape[-1], base, *coef[:-1]):
            assert (v * size) % r.vbytes == 0, (v, r.vbytes)
        assert r.units * r.vbytes == math.prod(m.out_shape) * size
    elif r.path == "tile":
        assert abs(coef[-1]) != 1 and p and r.vbytes == size
        assert words[ta.BLOCK_WORDS + 2] == p[0]
    else:
        assert r.vbytes == size and r.units == math.prod(m.out_shape)
        assert coef[-1] != 1 or any(
            (v * size) % (2 * size) for v in (m.out_shape[-1], base,
                                              *coef[:-1]))
        assert abs(coef[-1]) == 1 or not p or m.out_shape[-1] == 1


@pytest.mark.parametrize("name,dtype", _block_params())
def test_block_table_keeps_the_map_words(name, dtype):
    """Words 0-49 are the map's, whatever the dtype, and each magic number
    divides exactly over the extent's whole range."""
    m, plan, r = _table(name, dtype)
    base, coef = _coefs(m, plan)
    w = r.table.tolist()
    n = len(m.out_shape)
    assert w[0] == n and w[1] == base
    assert w[2:2 + n] == list(m.out_shape)
    assert w[2 + AX:2 + AX + n] == coef
    for d, size in enumerate(m.out_shape):
        top = math.prod(m.out_shape)
        _div(np.array([0, 1, size - 1, size, top - 1, top, 2 ** 31 - 1]),
             size, w[2 + 2 * AX + d], w[2 + 3 * AX + d])
    other = _table(name, torch.float32)[2].table.tolist()
    assert w[:ta.BLOCK_WORDS] == other[:ta.BLOCK_WORDS]
    assert r.narrow


@pytest.mark.parametrize("name,dtype", _block_params())
def test_block_table_addresses_match_plain(name, dtype):
    """The path's index arithmetic over the table moves every element where
    the plain version puts it."""
    m, plan, r = _table(name, dtype)
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randint(-99, 100, size=m.in_shape)).to(dtype)
    ref = ta.block_plain(x, m, plan).reshape(-1)
    numel = ref.numel()
    xf = x.reshape(-1).view(torch.int8 if dtype == torch.int8 else
                            torch.int16 if dtype == torch.bfloat16
                            else torch.int32).numpy()
    words = np.array(r.table.tolist(), dtype=np.int64)
    if r.path == "vector":
        ve = r.vbytes // x.element_size()
        pad = np.zeros(-len(xf) % ve, dtype=xf.dtype)
        xv = np.concatenate([xf, pad]).reshape(-1, ve)
        src = _sources(words[ta.BLOCK_WORDS + 2:], r.units)
        out = xv[src].reshape(-1)
    elif r.path == "tile":
        out = _tile_model(words, r.units, xf, numel)
    else:
        out = xf[_sources(words[:ta.BLOCK_WORDS], numel)]
    got = torch.from_numpy(out.copy()).view(dtype)
    assert torch.equal(got, ref)


def test_block_plan_named_cases():
    """The cases the kernel's design is measured on."""
    m = af.transpose_map((448, 448, 64))
    plan = ta.analyze_block_mode(m)
    r = ta._block_regs(m, plan, torch.float32, CPU)
    assert (r.path, r.vbytes, r.units) == ("vector", 16, 448 * 448 * 16)
    assert ta._block_regs(m, plan, torch.int8, CPU).vbytes == 16
    m = af.axis_permutation_map((448, 448, 64), (2, 0, 1))
    r = ta._block_regs(m, ta.analyze_block_mode(m), torch.float32, CPU)
    assert (r.path, r.units) == ("tile", 2 * 7 * 448)
    # a C = 3 band in int8: one byte per access, so the scalar path
    m = af.split_map((448, 448, 6), 2, 1)
    r = ta._block_regs(m, ta.analyze_block_mode(m), torch.int8, CPU)
    assert r.path == "scalar" or (r.path == "vector" and r.vbytes < 16)
    # 64-bit maps keep the scalar path
    m = af.transpose_map((2, 2 ** 15, 2 ** 16))
    r = ta._block_regs(m, ta.analyze_block_mode(m), torch.float32, CPU)
    assert not r.narrow and r.path == "scalar"


@pytest.mark.parametrize("M,K,N,dtype,aligned,path,BN", [
    (230400, 288, 27, torch.float32, True, "tma", 28),  # ESPCN's last layer
    (230400, 288, 27, torch.float32, False, "cp.async", 28),
    (300, 9, 255, torch.bfloat16, True, "cp.async", 32),  # an 18-byte pitch
    (1000, 288, 255, torch.float32, True, "tma", 32),
    (517, 33, 28, torch.float32, True, "cp.async", 28),
    (64, 16, 64, torch.int8, True, "tma", 32),
    (64, 16, 32, torch.int8, True, "tma", 32),
    (33, 200, 3, torch.int8, True, "cp.async", 4),
    (33, 200, 3, torch.int32, True, "tma", 4),
    (70, 1, 5, torch.float32, True, "cp.async", 8),
    (7, 0, 3, torch.float32, True, "cp.async", 4),
    (130, 33, 70, torch.bfloat16, True, "cp.async", 32),
    (90, 24, 33, torch.bfloat16, True, "tma", 32),
    (90, 24, 30, torch.bfloat16, True, "tma", 32),
], ids=lambda v: str(v)[6:] if isinstance(v, torch.dtype) else str(v))
def test_mm_plan(M, K, N, dtype, aligned, path, BN):
    assert mk.mm_plan(M, K, N, dtype, aligned) == mk.MmPlan(path, 512, BN)
