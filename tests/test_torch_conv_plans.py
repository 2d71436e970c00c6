"""The host plan of the implicit-GEMM core (``csrc/igemm.cuh``), held on
the CPU without a card.

* ``conv_plan``: at EDSR's head, body and up convs, ESPCN's conv3 and every
  card test's conv (``tests/test_torch_gpu.py`` ``CONV_CASES``), the path
  (TMA's im2col mode where the pixels are a multiple of 16 bytes and x is
  16-byte aligned, cp.async otherwise), tiles that cover every (m, n)
  exactly once across the persistent grid, and the last round's fill.
* A numpy model of the loader's address arithmetic: the TMA path's
  bounding-box walk from each box's base pixel, one filter tap and a chunk
  of channels a K step, and the cp.async path's dense (pixel, tap,
  channel) walk, assembled into the patch matrix and held against
  ``img2col_plain``.
* The commit's scratch size and cooperative grid against the co-residency
  the plan assumes.

The kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.kernels.img2col import img2col as ik  # noqa: E402
from repro_torch.kernels.matmul_tm import chain as xc  # noqa: E402
from tests.test_torch_gpu import CONV_CASES  # noqa: E402

# (H, W, C, OC, k, stride, pad): the main path's convs
MAIN_CONVS = {
    "edsr_head": (224, 224, 3, 64, 3, 1, 1),
    "edsr_body": (224, 224, 64, 64, 3, 1, 1),
    "edsr_up": (224, 224, 64, 12, 3, 1, 1),
    "espcn_conv3": (360, 640, 32, 27, 3, 1, 1),
}
ALL_CONVS = {**MAIN_CONVS,
             **{"x".join(map(str, c)): c for c in CONV_CASES}}
DTYPES = (torch.float32, torch.bfloat16)


class _Fake:
    """Stands in for x where the plan reads only its address and size."""

    def __init__(self, dtype, ptr):
        self._size = torch.empty((), dtype=dtype).element_size()
        self._ptr = ptr

    def element_size(self):
        return self._size

    def data_ptr(self):
        return self._ptr


def _geometry(case):
    H, W, C, OC, k, stride, pad = case
    OH, OW = ik.out_hw(H, W, k, k, stride, pad)
    return H, W, C, OC, k, stride, pad, OH, OW


def _plan(case, dtype, aligned=True):
    H, W, C, OC, k, stride, pad, OH, OW = _geometry(case)
    tma = ik.conv_tma_ok(_Fake(dtype, 0 if aligned else 4), C, H, W, OH, OW,
                         stride, pad, pad)
    return ik.conv_plan(OH * OW, OC, k * k * C, dtype, tma=tma, C=C,
                        taps=k * k)


def _params():
    return [pytest.param(n, d, a, id=f"{n}-{str(d)[6:]}-{'al' if a else 'off'}")
            for n in ALL_CONVS for d in DTYPES for a in (True, False)]


@pytest.mark.parametrize("name,dtype,aligned", _params())
def test_conv_plan_path_tiles_and_fill(name, dtype, aligned):
    case = ALL_CONVS[name]
    H, W, C, OC, k, stride, pad, OH, OW = _geometry(case)
    plan = _plan(case, dtype, aligned)
    itemsize = torch.empty((), dtype=dtype).element_size()
    want_tma = aligned and C * itemsize % 16 == 0 and C >= 1
    assert plan.path == ("tma" if want_tma else "cp.async")
    # the tile: N rounded up to 4 where N <= 32, else 64; 8 rows a thread
    assert plan.BN == (-(-OC // 4) * 4 if OC <= 32 else 64)
    assert plan.nct in ((8, 16) if plan.BN == 64 else (4,))
    assert plan.threads == plan.BM // 8 * plan.nct
    assert plan.threads % 32 == 0 and 64 <= plan.threads <= ik.MAX_THREADS
    assert plan.smem <= ik.BLOCK_SMEM and plan.stages in ik.STAGES
    # the K steps: filter taps by 128-byte channel chunks (TMA), else K
    # densely in 128-byte steps
    bk = 128 // itemsize
    K = k * k * C
    assert plan.k_steps == (k * k * -(-C // bk) if want_tma else -(-K // bk))
    # the persistent blocks b, b + grid, ... cover every tile once, and the
    # tiles cover every (m, n) once
    M = OH * OW
    n_n = -(-OC // plan.BN)
    assert plan.tiles == -(-M // plan.BM) * n_n
    assert plan.grid == min(plan.tiles, plan.blocks_per_sm * plan.sms)
    seen = np.zeros(plan.tiles, dtype=np.int64)
    for b in range(plan.grid):
        seen[b::plan.grid] += 1
    assert (seen == 1).all()
    cover = np.zeros((M, OC), dtype=np.int64)
    for tile in range(plan.tiles):
        m0, n0 = tile // n_n * plan.BM, tile % n_n * plan.BN
        cover[m0:m0 + plan.BM, n0:n0 + plan.BN] += 1
    assert (cover == 1).all()
    assert 0 < plan.last_fill <= 1 and 1 <= plan.rounds


def test_conv_plan_main_path_choices():
    """EDSR's body conv fills its one round (BM 192: 262 tiles on 2 x 132
    blocks); every main-path conv keeps 8 warps an SM."""
    body = _plan(MAIN_CONVS["edsr_body"], torch.float32)
    assert (body.path, body.BM, body.BN, body.blocks_per_sm) == \
        ("tma", 192, 64, 2)
    assert body.tiles == 262 and body.rounds == 1 and body.last_fill >= 0.9
    assert _plan(MAIN_CONVS["edsr_head"], torch.float32).path == "cp.async"
    up = _plan(MAIN_CONVS["edsr_up"], torch.float32)
    assert up.path == "tma" and up.BN == 12
    conv3 = _plan(MAIN_CONVS["espcn_conv3"], torch.float32)
    assert conv3.path == "tma" and conv3.BN == 28
    for case in MAIN_CONVS.values():
        p = _plan(case, torch.float32)
        assert p.threads * p.blocks_per_sm >= 256


def test_conv_plan_takes_narrow_thread_tiles_only_for_warps():
    """8 x 4 tiles a thread (16 column threads at BN = 64) only where 8 x 8
    ones would leave the SMs with fewer warps on the same rows: the YOLO
    neck's head-2 1x1 conv (M 6272, N 255) takes them, EDSR's convs keep
    8 x 8 (and every tile width below 64 its 4 column threads)."""
    neck = ik.conv_plan(6272, 255, 256, torch.float32, tma=True, C=256)
    assert (neck.BM, neck.nct, neck.tiles, neck.warps) == (96, 16, 264, 12)
    wide = ik.conv_plan(6272, 255, 256, torch.float32, tma=True, C=256,
                        occupancy=lambda nct, threads, smem: (
                            ik.model_occupancy(threads, smem)
                            if nct == 8 else 0))
    assert (wide.BM, wide.nct, wide.tiles, wide.warps) == (192, 8, 132, 6)
    for name in ("edsr_head", "edsr_body"):
        plan = _plan(MAIN_CONVS[name], torch.float32)
        assert (plan.BM, plan.nct, plan.warps) == (192, 8, 12)
    assert _plan(MAIN_CONVS["edsr_up"], torch.float32).nct == 4


def test_model_occupancy_limits():
    # registers: 168 a thread, 192 threads -> 2 blocks; shared memory
    # 99 KB -> 2 blocks; threads and the block cap
    assert ik.model_occupancy(192, 99360) == 2
    assert ik.model_occupancy(256, 100000, regs=255) == 1
    assert ik.model_occupancy(64, 1000, regs=32) == ik.SM_BLOCKS
    assert ik.model_occupancy(128, 233000) == 0


# ---------------------------------------------------------------------------
# the loader's address arithmetic, as a numpy model
# ---------------------------------------------------------------------------

def _tma_rows(case, plan, itemsize, tile, ks):
    """The A stage TMA's im2col mode fills for (tile, K step): per row the
    flat index into x of each of its BK channels, -1 where it reads zero.
    The walk: from each box's base pixel through the bounding box whose
    corners igemm.cuh's a_tensor_map encodes, by the stride, W then H."""
    H, W, C, OC, k, stride, pad, OH, OW = _geometry(case)
    bk = 128 // itemsize
    n_kc = -(-C // bk)
    tap, c0 = ks // n_kc, ks % n_kc * bk
    ky, kx = divmod(tap, k)
    lower = (-pad, -pad)  # (w, h)
    upper = ((OW - 1) * stride - pad - (W - 1), (OH - 1) * stride - pad - (H - 1))
    n_boxes = -(-plan.BM // 256)
    box_rows = plan.BM // n_boxes
    n_n = -(-OC // plan.BN)
    m0 = tile // n_n * plan.BM
    rows = np.full((plan.BM, bk), -1, dtype=np.int64)
    for q in range(n_boxes):
        m = m0 + q * box_rows
        if m >= OH * OW:
            continue
        oh, ow = divmod(m, OW)
        w, h, n = ow * stride - pad, oh * stride - pad, 0
        for p in range(box_rows):
            y, xx = h + ky, w + kx
            for cc in range(bk):
                c = c0 + cc
                if n == 0 and 0 <= y < H and 0 <= xx < W and c < C:
                    rows[q * box_rows + p, cc] = (y * W + xx) * C + c
            w += stride
            if w > W - 1 + upper[0]:
                w = lower[0]
                h += stride
                if h > H - 1 + upper[1]:
                    h, n = lower[1], n + 1
    return rows, tap * C + c0, min(bk, C - c0)


def _async_rows(case, plan, itemsize, tile, ks):
    """The A stage the cp.async path fills: row m, k = kb + kk walked as
    (ky, kx, c) from kb, zero outside x and past K."""
    H, W, C, OC, k, stride, pad, OH, OW = _geometry(case)
    bk = 128 // itemsize
    K = k * k * C
    kb = ks * bk
    n_n = -(-OC // plan.BN)
    m0 = tile // n_n * plan.BM
    rows = np.full((plan.BM, bk), -1, dtype=np.int64)
    for r in range(plan.BM):
        m = m0 + r
        if m >= OH * OW:
            continue
        oh, ow = divmod(m, OW)
        iy0, ix0 = oh * stride - pad, ow * stride - pad
        for kk in range(min(bk, K - kb)):
            tap, c = divmod(kb + kk, C)
            ky, kx = divmod(tap, k)
            y, xx = iy0 + ky, ix0 + kx
            if 0 <= y < H and 0 <= xx < W:
                rows[r, kk] = (y * W + xx) * C + c
    return rows, kb, min(bk, K - kb)


def _model_tiles(plan):
    """The first, a middle and the last tile."""
    return sorted({0, plan.tiles // 2, plan.tiles - 1})


def _patch_rows(case, m0, count):
    """Rows [m0, m0 + count) of img2col_plain's patch matrix of an x that
    holds its own flat indices (-1 in the padding), built from the few
    input rows they read."""
    H, W, C, OC, k, stride, pad, OH, OW = _geometry(case)
    idx = torch.arange(H * W * C, dtype=torch.float64).reshape(H, W, C)
    xp = torch.nn.functional.pad(idx, (0, 0, pad, pad, pad, pad), value=-1.0)
    oh0, oh1 = m0 // OW, (m0 + count - 1) // OW
    rows = ik.img2col_plain(xp[oh0 * stride:oh1 * stride + k], k, k, stride)
    off = m0 - oh0 * OW
    return rows[off:off + count].numpy()


@pytest.mark.parametrize("name,dtype,aligned", _params())
def test_loader_model_builds_the_patch_matrix(name, dtype, aligned):
    """Every K step of the modelled tiles, placed at its k, equals the
    img2col patch matrix (x holds its own flat indices, so each entry names
    the element it read; -1 the zeros of the padding)."""
    case = ALL_CONVS[name]
    H, W, C, OC, k, stride, pad, OH, OW = _geometry(case)
    plan = _plan(case, dtype, aligned)
    itemsize = torch.empty((), dtype=dtype).element_size()
    K = k * k * C
    n_n = -(-OC // plan.BN)
    for tile in _model_tiles(plan):
        m0 = tile // n_n * plan.BM
        got = np.full((plan.BM, K), -2, dtype=np.int64)
        for ks in range(plan.k_steps):
            fill = _tma_rows if plan.path == "tma" else _async_rows
            rows, kb, nv = fill(case, plan, itemsize, tile, ks)
            assert (got[:, kb:kb + nv] == -2).all()  # each k once
            got[:, kb:kb + nv] = rows[:, :nv]
            if plan.path == "tma":
                assert (rows[:, nv:] == -1).all()  # channels past C: zeros
        rows_in = min(plan.BM, OH * OW - m0)
        want = _patch_rows(case, m0, rows_in)
        assert (got[:rows_in] == want).all(), (tile,)


# ---------------------------------------------------------------------------
# the commit
# ---------------------------------------------------------------------------

COMMITS = {
    "espcn_conv3": xc.Gemm("conv", (1, 360, 640, 32), (3, 3, 32, 27), 1,
                           "SAME"),
    "espcn_small": xc.Gemm("conv", (1, 36, 64, 32), (3, 3, 32, 27), 1,
                           "SAME"),
    "batch2_conv": xc.Gemm("conv", (2, 9, 8, 3), (3, 3, 3, 5), 2, "VALID"),
    "mm": xc.Gemm("mm", (24, 16), (16, 40)),
    "mm_tall": xc.Gemm("mm", (230400, 288), (288, 27)),
}


@pytest.mark.parametrize("name", list(COMMITS))
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.bfloat16,
                                   torch.float32],
                         ids=lambda d: str(d)[6:])
def test_commit_plan_scratch_and_grid(name, dtype):
    """The scratch holds the product, M x N; the cooperative grid is no
    larger than the blocks the plan's occupancy puts on the card, so every
    block is resident at the grid-wide barrier, and covers every tile."""
    g = COMMITS[name]
    x = _Fake(dtype, 0)
    M, N, K, C, taps = xc._commit_geometry(g)
    plan = ik.conv_plan(M, N, K, dtype, tma=xc._commit_tma_ok(g, x), C=C,
                        taps=taps)
    words = g.words()
    # the wrapper's scratch is (M, N): the product, the chain's source
    assert (M, N) == (words[1], words[2])
    assert M * N == int(np.prod(g.out_shape))
    assert plan.grid <= plan.blocks_per_sm * plan.sms
    assert plan.grid == min(plan.tiles, plan.blocks_per_sm * plan.sms)
    assert ik.model_occupancy(plan.threads, plan.smem) >= plan.blocks_per_sm
    assert plan.tiles == -(-M // plan.BM) * -(-N // plan.BN)
    itemsize = x.element_size()
    if g.kind == "mm":
        assert plan.path == ("tma" if words[3] * itemsize % 16 == 0
                             else "cp.async")
    else:
        assert plan.path == ("tma" if words[9] * itemsize % 16 == 0
                             else "cp.async")
