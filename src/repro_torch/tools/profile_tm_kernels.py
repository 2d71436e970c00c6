"""Device times of matmul_tm, tm_affine_block, tm_affine_gather, conv2d,
xchain_commit and xchain_prologue across shapes, paths and dtypes, beside
their bounds and one PyTorch call of the same work.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_tm_kernels [SECTION ...]

SECTION is any of matmul, block, gather, conv, commit, prologue, chain,
rme (default: all, in that order), or calls, which is run alone.

Prints the card's name and power limit, then one line per case: the
kernel's device ms (a CUDA graph of back-to-back calls, timed with CUDA
events), its bound (bytes in and out over 3.35 TB/s, or f32 operations
over 67 TFLOP/s where larger) and the PyTorch call's device ms:

* ``matmul_tm`` (f32 unless named): ESPCN's last layer (230400, 288) x
  (288, 27) through the identity, transpose and pixel-shuffle stores; the
  same in bf16; K = 287 (a pitch TMA cannot take: the cp.async path);
  N = 12, 64 and 255 (four column tiles); K = 32; against ``torch.mm``
  (TF32 off), which computes the product without the TM store;
* ``tm_affine_block`` at (448, 448, 64): the transpose (vector path), a
  channel band and HWC -> CHW (tile path) in int8, bf16 and f32, and a
  flip of W and C (scalar path) in f32, against ``permute().contiguous()``
  (the band: a slice's copy; the flip: ``flip().contiguous()``), after one
  ``clone()`` of the f32 map: what a plain copy reaches on the card;
* ``conv2d`` (the implicit-GEMM core of ``csrc/igemm.cuh``): EDSR's body
  (224, 224, 64) -> 64, head (C = 3: cp.async) and up (-> 12) convs, the
  body in bf16, at stride 2, and on an x one element off 16 bytes (the
  cp.async path), each with its plan, its FMA loop alone (the same tiles
  and K steps over operands already in shared memory, no loads: its share
  of 67 TFLOP/s) and ``F.conv2d`` (cuDNN, TF32 off);
* ``xchain_commit``: ESPCN's conv3 (1, 360, 640, 32) x (3, 3, 32, 27) into
  PixelShuffle x3 in f32 and bf16 (a pure gather: the chain walk's fast
  path), the same conv into a pad with fill (a masked level: the general
  walk), and an mm (230400, 288) x (288, 27) into a transpose, each beside
  the kernel run with one of its phases (the product, or the chain over
  the scratch; the grid-wide barrier between) and the plain version
  (cuDNN's conv or the product, then the chain's gather; timed with CUDA
  events around back-to-back calls, as a masked level's plain version
  cannot be captured in a graph);
* ``tm_affine_gather`` at Table III size: upsample x2, pixel shuffle,
  pixel unshuffle (448, 448, 64) and rearrange (448, 448, 3) -> 16 in
  int8, bf16 and f32, each with its plan (separable path with its run
  and bytes per access, or the general kernel), then each map again on an
  x one element off 16 bytes (element by element) and through the general
  kernel, against its byte bound and, for the upsample, ``F.interpolate``
  (nearest, channels-last);
* ``xchain_prologue``: the YOLOv3-Tiny neck (upsample (8, 14, 14, 128) +
  Route (8, 28, 28, 128)) into head 2's 1x1 conv to 255 in f32 and bf16,
  and into a 3x3 conv to 255 (SAME), each beside the kernel run with one
  of its phases (the chain into the scratch, or the product over it) and
  the same work split: ``tm_chain``, then ``torch.mm`` or ``F.conv2d``
  (TF32 off); the 1x1 product also as one ``conv2d`` launch and its FMA
  loop alone, the port's own split (``tm_chain``, then ``conv2d``), and
  the kernel with its plan held to 8 x 8 thread tiles, on every block the
  card holds and on one block a tile;
* ``tm_chain`` at the YOLOv3-Tiny neck in int8, bf16 and f32, with its run
  plan (R, elements an access, table bytes), on aligned operands and on
  an x 4 bytes off 16-byte alignment (accesses of one element), beside
  its byte bound, the time per call with the wrapper's host work and the
  plain version;
* the RME compactions (``rme_evaluate``, ``rme_evaluate_chained``,
  ``rme_assemble``) at the detect tail (8, 2352, 85) f32, capacity 256,
  scores from ``randn``, conf 0.5, and ``rme_evaluate`` on one 100000-row
  stream with room for every survivor, and with capacity 0 (the launch
  alone), in two turns; then the time per call of each with the wrapper's
  host work, and the chained wrapper's host work piece by piece;
* ``calls``: ``tm_chain`` at the neck and the three compactions at the
  detect tail (``chip_smoke.py``'s shapes and data), device ms and ms per
  call with the wrapper's host work, three turns.  It calls only what
  the port's earlier packages have as well, so that an earlier checkout's
  kernels are timed by the same code in the same run: ``cd <checkout> &&
  PYTHONPATH=src python3 <this file> calls``.

Every kernel result is checked against its plain version first.  Needs a
CUDA device.
"""

from __future__ import annotations

import contextlib
import math
import subprocess
import sys

import torch

import torch.nn.functional as F

from repro_torch.core import affine as af
from repro_torch.core.fp_bounds import bf16_ulp, conv_tol, gamma
from repro_torch.kernels import build
from repro_torch.kernels.img2col import img2col as ik
from repro_torch.kernels.matmul_tm import chain as xc
from repro_torch.kernels.matmul_tm import matmul_tm as mk
from repro_torch.kernels.tm_affine import chain as tc
from repro_torch.kernels.tm_affine import tm_affine as ta

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores, the same sheet


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``: ``iters`` calls in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def events_ms(fn, iters: int = 10) -> float:
    """Device ms per call of ``fn`` over back-to-back calls between two CUDA
    events (for a function a CUDA graph cannot capture, such as a plain
    version that builds a host tensor)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def matmul(gen, dev, M, K, N, ep, dtype=torch.float32) -> None:
    x = torch.randn((M, K), generator=gen).to(dev, dtype)
    w = torch.randn((K, N), generator=gen).to(dev, dtype)
    got, ref = mk.matmul_tm(x, w, ep), mk.matmul_tm_plain(x, w, ep)
    # 2 gamma_K sum |x w| (bf16 one more ulp), on the largest magnitude
    tol = 2 * gamma(K) * float((x.double().abs() @ w.double().abs()).max())
    if dtype == torch.bfloat16:
        tol += float(bf16_ulp(ref).max())
    err = float((got.double() - ref.double()).abs().max())
    assert err <= tol, (M, K, N, ep, err, tol)
    size = x.element_size()
    nbytes = (x.numel() + w.numel() + M * N) * size
    bound = max(nbytes / HBM_BYTES_PER_S, 2 * M * N * K / F32_FLOP_PER_S)
    plan = mk.mm_plan(M, K, N, dtype, x.data_ptr() % 16 == 0)
    ms = graph_ms(lambda: mk.matmul_tm(x, w, ep), 10)
    lib = graph_ms(lambda: torch.mm(x, w), 10)
    print(f"matmul_tm {str(dtype)[6:]} ({M}, {K}) x ({K}, {N}) {ep.mode}: "
          f"{plan.path}, BN {plan.BN}; {ms:.4f} ms, bound {bound * 1e3:.4f} "
          f"({ms / bound / 1e3:.2f}x), torch.mm {lib:.4f} "
          f"(kernel / mm {ms / lib:.2f})", flush=True)


def block(gen, dev, name, m, dtype, library) -> None:
    plan = ta.analyze_block_mode(m)
    x = torch.randint(-100, 100, m.in_shape, generator=gen).to(dev, dtype)
    got = ta.tm_affine_block(x, m, plan)
    assert torch.equal(got, ta.block_plain(x, m, plan)), name
    r = ta._block_regs(m, plan, dtype, x.device)
    nbytes = (x.numel() + got.numel()) * x.element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms = graph_ms(lambda: ta.tm_affine_block(x, m, plan))
    lib = graph_ms(lambda: library(x))
    print(f"tm_affine_block {name} {str(dtype)[6:]}: {r.path}, {r.vbytes} B "
          f"per access; {ms:.4f} ms, bound {bound:.4f} ({ms / bound:.2f}x), "
          f"library {lib:.4f} (kernel / library {ms / lib:.2f})", flush=True)


def conv(gen, dev, name, H, W, C, N, stride=1, dtype=torch.float32,
         offset=0) -> None:
    buf = torch.rand((H * W * C + offset,), generator=gen).to(dev, dtype)
    x = buf[offset:].view(H, W, C)
    w = ((torch.rand((3, 3, C, N), generator=gen) - 0.5) * 0.1).to(dev, dtype)
    got, ref = ik.conv2d(x, w, stride, 1), ik.conv2d_plain(x, w, stride, 1)
    tol = conv_tol(x, w, stride, 1)
    if dtype == torch.bfloat16:
        tol = tol + bf16_ulp(ref)
    assert bool(((got.double() - ref.double()).abs() <= tol).all()), name
    flops = 2 * got.shape[0] * got.shape[1] * N * 9 * C
    bound = flops / F32_FLOP_PER_S * 1e3
    plan = ik.conv2d_plan(x, w, stride, 1)
    ms = graph_ms(lambda: ik.conv2d(x, w, stride, 1))
    fma = graph_ms(lambda: ik.conv2d_fma_probe(x, w, stride, 1))
    xn = x.permute(2, 0, 1)[None].float()
    wn = w.permute(3, 2, 0, 1).float()
    lib = graph_ms(lambda: F.conv2d(xn, wn, stride=stride, padding=1))
    print(f"conv2d {name} {str(dtype)[6:]} ({H}, {W}, {C}) -> {N} s{stride}: "
          f"{plan.path} BM {plan.BM} BN {plan.BN} stages {plan.stages} "
          f"threads {plan.threads} x {plan.blocks_per_sm}/SM, {plan.tiles} "
          f"tiles on {plan.grid} blocks (last round {plan.last_fill:.3f}); "
          f"{ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s, bound {bound:.4f} "
          f"({ms / bound:.2f}x); FMA loop alone {fma:.4f} ms = "
          f"{flops / fma / 1e9 / 67:.3f} of 67 TFLOP/s; F.conv2d f32 "
          f"{lib:.4f} (kernel / cuDNN {ms / lib:.2f})", flush=True)


def commit(gen, dev, name, g, links, dtype=torch.float32) -> None:
    x = (torch.rand(g.x_shape, generator=gen) - 0.5).to(dev, dtype)
    w = ((torch.rand(g.w_shape, generator=gen) - 0.5) * 0.1).to(dev, dtype)
    sig = tc.ChainSig(links=links, dtype=str(dtype)[6:])
    got = xc.xchain_commit(sig, g, x, w)
    ref = xc.xchain_commit_plain(sig, g, x, w)
    K = g.words()[3]
    # |x| <= 0.5, |w| <= 0.05: sum |x w| <= 0.025 K
    tol = 2 * gamma(K) * 0.025 * K
    if dtype == torch.bfloat16:
        tol += float(bf16_ulp(ref).max())
    err = float((got.double() - ref.double()).abs().max())
    assert err <= tol, (name, err, tol)
    flops = g.flops()
    bound = flops / F32_FLOP_PER_S * 1e3
    plan = xc.xchain_commit_card_plan(g, x)
    ms = graph_ms(lambda: xc.xchain_commit(sig, g, x, w), 10)
    product, walk = (graph_ms(lambda: xc.xchain_commit_phase(
        sig, g, x, w, phase), 10) for phase in ("product", "chain"))
    plain = events_ms(lambda: xc.xchain_commit_plain(sig, g, x, w))
    print(f"xchain_commit {name} {str(dtype)[6:]}: {plan.path} BM {plan.BM} "
          f"BN {plan.BN} stages {plan.stages} threads {plan.threads} x "
          f"{plan.blocks_per_sm}/SM, {plan.tiles} tiles on {plan.grid} "
          f"blocks; {ms:.4f} ms; the kernel with one phase: product "
          f"{product:.4f}, chain {walk:.4f}; bound {bound:.4f} "
          f"({ms / bound:.2f}x); plain {plain:.4f}", flush=True)


def general_gather(x, m):
    """The general gather kernel on ``x``, whatever path the map's plan
    takes (the design before the separable path): the library's entry
    point on the map's register file.  Counts no launch."""
    out = torch.empty(m.out_shape, dtype=x.dtype, device=x.device)
    regs, narrow, extra = ta._gather_args(ta.GatherLaunch(
        "general", x.element_size(), *ta._gather_regs(m, x.dtype, x.device),
        None), m)
    rc = build.library("tm_affine").tm_affine_gather(
        x.data_ptr(), None, out.data_ptr(), regs.data_ptr(),
        ta.DTYPE_CODES[x.dtype], ta.EW_CODES[None], out.numel(), int(narrow),
        *extra, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "tm_affine_gather")
    return out


def gather(gen, dev, name, m, dtype, library=None) -> None:
    n = math.prod(m.in_shape)
    buf = torch.randint(-100, 100, (n + 16,), generator=gen).to(dev, dtype)
    lead = (-buf.data_ptr() % 16) // buf.element_size()
    nbytes = (n + math.prod(m.out_shape)) * buf.element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    cases = (("aligned", buf[lead:lead + n], False),
             ("x off 16 B", buf[lead + 1:lead + 1 + n], False),
             ("general kernel", buf[lead:lead + n], True))
    for how, flat, general in cases:
        x = flat.view(m.in_shape)
        launch = ta.gather_launch(m, x)
        if general and launch.path == "general":
            continue
        run = general_gather if general else ta.tm_affine_gather
        got = run(x, m)
        assert torch.equal(got, ta.gather_plain(x, m)), (name, how)
        ms = graph_ms(lambda: run(x, m), 10)
        path = "general" if general else launch.path
        vb = x.element_size() if general else launch.vbytes
        extra = ""
        if library is not None and how == "aligned":
            extra = f", library {graph_ms(lambda: library(x), 10):.4f}"
        print(f"tm_affine_gather {name} {str(dtype)[6:]} {how}: {path}, "
              f"{vb} B per access; {ms:.4f} ms, bound {bound:.4f} "
              f"({bound / ms:.2f} of it){extra}", flush=True)


@contextlib.contextmanager
def plan_held(nct: int, grid_of):
    """conv_plan held to ``nct`` column threads at BN = 64, and the
    prologue's grid to ``grid_of(plan)`` (the plans cached before and
    inside dropped)."""
    keep = ik.col_threads, xc.prologue_grid
    ik.col_threads = lambda BN: (nct,) if BN == 64 else keep[0](BN)
    xc.prologue_grid = grid_of
    ik._PLANS.clear()
    try:
        yield
    finally:
        ik.col_threads, xc.prologue_grid = keep
        ik._PLANS.clear()


def prologue(gen, dev, name, k, dtype=torch.float32) -> None:
    batch = (8,)
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), batch)
    route = tuple(af.batch_extend_map(m, batch) for m in
                  af.route_maps([(28, 28, 128), (28, 28, 128)]))
    sig = tc.ChainSig(links=((up, None),), route_maps=route, route_band=0,
                      dtype=str(dtype)[6:])
    u = torch.rand(up.in_shape, generator=gen).to(dev, dtype)
    skip = torch.rand(route[1].in_shape, generator=gen).to(dev, dtype)
    w = ((torch.rand((k, k, 256, 255), generator=gen) - 0.5) / 8).to(
        dev, dtype)
    g = xc.Gemm("conv", (8, 28, 28, 256), tuple(w.shape), 1, "SAME")
    got = xc.xchain_prologue(sig, g, 0, u, w, (skip,))
    ref = xc.xchain_prologue_plain(sig, g, 0, u, w, (skip,))
    K = g.words()[3]
    # |values| <= 1, |w| <= 1/16: sum |x w| <= K / 16
    tol = 2 * gamma(K) * K / 16
    if dtype == torch.bfloat16:
        tol += float(bf16_ulp(ref).max())
    err = float((got.double() - ref.double()).abs().max())
    assert err <= tol, (name, err, tol)
    bound = g.flops() / F32_FLOP_PER_S * 1e3
    cat = torch.empty(g.x_shape, dtype=dtype, device=dev)
    plan = xc.xchain_prologue_card_plan(g, cat)
    ms = graph_ms(lambda: xc.xchain_prologue(sig, g, 0, u, w, (skip,)), 10)
    walk, product = (graph_ms(lambda: xc.xchain_prologue_phase(
        sig, g, 0, u, w, phase, (skip,)), 10)
        for phase in ("chain", "product"))
    if k == 1:
        w2 = w.reshape(256, 255)
        split = graph_ms(lambda: torch.mm(
            tc.tm_chain(sig, u, (skip,)).reshape(-1, 256), w2), 10)
        ported = graph_ms(lambda: ik.conv2d(
            tc.tm_chain(sig, u, (skip,)).reshape(-1, 1, 256), w), 10)
        print(f"xchain_prologue {name} {str(dtype)[6:]}: split tm_chain + "
              f"conv2d {ported:.4f} ms", flush=True)
        # the plan held to 8 x 8 thread tiles (132 tiles at the neck): on
        # every block the card holds (the tiles spread over the SMs by the
        # kernel), and on one block a tile
        for grid_of in (xc.prologue_grid, lambda p: p):
            with plan_held(8, grid_of):
                wide = xc.xchain_prologue_card_plan(g, cat)
                wide_ms = graph_ms(lambda: xc.xchain_prologue(
                    sig, g, 0, u, w, (skip,)), 10)
                walk8, product8 = (graph_ms(lambda: xc.xchain_prologue_phase(
                    sig, g, 0, u, w, phase, (skip,)), 10)
                    for phase in ("chain", "product"))
            print(f"xchain_prologue {name} {str(dtype)[6:]}: held to 8 x 8 "
                  f"tiles (BM {wide.BM}, {wide.tiles} tiles on {wide.grid} "
                  f"blocks) {wide_ms:.4f} ms; chain {walk8:.4f}, product "
                  f"{product8:.4f}", flush=True)
        # the same product as one conv2d launch of the (6272, 1, 256) map,
        # and its FMA loop alone
        xs = torch.rand((8 * 28 * 28, 1, 256), generator=gen).to(dev, dtype)
        alone = graph_ms(lambda: ik.conv2d(xs, w), 10)
        fma = graph_ms(lambda: ik.conv2d_fma_probe(xs, w), 10)
        cplan = ik.conv2d_plan(xs, w)
        print(f"xchain_prologue {name} {str(dtype)[6:]}: the product as "
              f"conv2d (BM {cplan.BM}, nct {cplan.nct}, {cplan.tiles} "
              f"tiles) {alone:.4f} ms, its FMA loop alone {fma:.4f} ms = "
              f"{g.flops() / fma / 1e9 / 67:.3f} of 67 TFLOP/s", flush=True)
    else:
        wn = w.permute(3, 2, 0, 1)
        split = graph_ms(lambda: F.conv2d(
            tc.tm_chain(sig, u, (skip,)).permute(0, 3, 1, 2), wn,
            padding=k // 2), 10)
    print(f"xchain_prologue {name} {str(dtype)[6:]}: {plan.path} BM "
          f"{plan.BM} BN {plan.BN} stages {plan.stages} threads "
          f"{plan.threads} x {plan.blocks_per_sm}/SM, {plan.tiles} tiles on "
          f"{plan.grid} blocks; {ms:.4f} ms; the kernel with one phase: "
          f"chain {walk:.4f}, product {product:.4f}; bound {bound:.4f} "
          f"({ms / bound:.2f}x); split tm_chain + library {split:.4f}",
          flush=True)


def chain(gen, dev, dtype) -> None:
    from repro_torch.kernels.tm_affine.chain import ChainSig
    batch = (8,)
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), batch)
    route = tuple(af.batch_extend_map(m, batch) for m in
                  af.route_maps([(28, 28, 128), (28, 28, 128)]))
    sig = ChainSig(links=((up, None),), route_maps=route, route_band=0,
                   dtype=str(dtype)[len("torch."):])
    rp = tc.build_run_plan(sig)
    skip = (torch.rand(route[1].in_shape, generator=gen) * 100).to(dev, dtype)
    n = math.prod(up.in_shape)
    buf = (torch.rand(n + 16, generator=gen) * 100).to(dev, dtype)
    nbytes = (n + skip.numel() + math.prod(sig.out_shape)) * dtype.itemsize
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    for off in (0, 4 // dtype.itemsize):
        u = buf[off:off + n].view(up.in_shape)
        got = tc.tm_chain(sig, u, (skip,))
        if not torch.equal(got, tc.chain_plain(u, tc.build_chain_plan(sig),
                                                (skip,))):
            raise AssertionError(f"tm_chain neck {dtype} off {off}")
        ms = graph_ms(lambda: tc.tm_chain(sig, u, (skip,)))
        call = events_ms(lambda: tc.tm_chain(sig, u, (skip,)), 50)
        plain = events_ms(lambda: tc.chain_plain(
            u, tc.build_chain_plan(sig), (skip,)))
        print(f"tm_chain YOLO neck {str(dtype)[6:]} x "
              f"{'aligned' if off == 0 else f'{off * dtype.itemsize} B off'}"
              f": R {rp.run}, {rp.vec if off == 0 else 1} element(s) an "
              f"access, run tables {rp.table_bytes} + {rp.outer_bytes} B; "
              f"{ms:.4f} ms, bound {bound:.4f} ({bound / ms:.2f} of it); "
              f"{call:.4f} ms per call; plain {plain:.4f}", flush=True)


def rme(gen, dev) -> None:
    from repro_torch.kernels.rme_gather import rme_gather as rg
    from repro_torch.kernels.tm_affine.chain import fold_pullback
    m = af.batch_extend_map(af.reshape_map((28, 28, 255), (2352, 85)), (8,))
    j, _, fill = fold_pullback((m,))
    idx = torch.from_numpy(j.reshape(m.out_shape)).to(dev)
    pred = torch.randn(m.in_shape, generator=gen).to(dev)
    recs = torch.randn(m.out_shape, generator=gen).to(dev)
    mask = recs[..., 4] >= 0.5
    long = torch.randn((1, 100_000, 85), generator=gen).to(dev)
    calls = {
        "evaluate": (lambda: rg.rme_evaluate(recs, 0.5, 256, score_index=4),
                     lambda: rg.evaluate_plain(recs, 0.5, 256,
                                               score_index=4)),
        "evaluate_chained": (
            lambda: rg.rme_evaluate_chained(pred, idx, None, fill, 0.5, 256,
                                            score_index=4),
            lambda: rg.evaluate_chained_plain(pred, idx, None, fill, 0.5,
                                              256, score_index=4)),
        "assemble": (lambda: rg.rme_assemble(recs, mask, 256),
                     lambda: rg.assemble_plain(recs, mask, 256)),
        "evaluate 100000 rows": (
            lambda: rg.rme_evaluate(long, 0.5, 100_000, score_index=4),
            lambda: rg.evaluate_plain(long, 0.5, 100_000, score_index=4)),
        # no round runs: the launch and the count's store alone
        "evaluate capacity 0": (
            lambda: rg.rme_evaluate(recs, 0.5, 0, score_index=4),
            lambda: rg.evaluate_plain(recs, 0.5, 0, score_index=4)),
    }
    for name, (kernel, plain) in calls.items():
        for g, r in zip(kernel(), plain()):
            if not torch.equal(g, r):
                raise AssertionError(f"rme {name}")
    for turn in range(2):
        times = ", ".join(f"{name} {graph_ms(k):.4f}"
                          for name, (k, _) in calls.items())
        print(f"rme turn {turn}: {times} ms", flush=True)
    print("rme per call with host work: "
          + ", ".join(f"{name} {events_ms(k, 50):.4f}"
                      for name, (k, _) in calls.items()) + " ms", flush=True)
    # the chained wrapper's host work, piece by piece (host clock, no sync
    # inside the loop)
    lib = build.library("rme_gather")
    rows, src, cnt = rg._outputs(pred, 8, 256, 85)
    fill_bits, args = rg._chained_args(pred.numel(), tuple(idx.shape),
                                       pred.dtype, fill, 256, 0.5, "ge", 4)
    pieces = {
        "outputs (3 torch.empty)": lambda: rg._outputs(pred, 8, 256, 85),
        "stream": lambda: build.current_stream(0),
        "C call and launch": lambda: lib.rme_evaluate_chained(
            pred.data_ptr(), idx.data_ptr(), None, fill_bits,
            rows.data_ptr(), src.data_ptr(), cnt.data_ptr(), *args,
            build.current_stream(0)),
        "whole wrapper": calls["evaluate_chained"][0],
    }
    print("rme_evaluate_chained host us per call: " + ", ".join(
        f"{name} {host_us(f):.2f}" for name, f in pieces.items()),
        flush=True)


def host_us(fn, iters: int = 300) -> float:
    """Host microseconds per call of ``fn`` (launches queue on the card,
    which drains after the clock stops)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def calls(gen, dev) -> None:
    from repro_torch.kernels.rme_gather import rme_gather as rg
    from repro_torch.kernels.tm_affine.chain import ChainSig, fold_pullback
    batch = (8,)
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), batch)
    route = tuple(af.batch_extend_map(m, batch) for m in
                  af.route_maps([(28, 28, 128), (28, 28, 128)]))
    sig = ChainSig(links=((up, None),), route_maps=route, route_band=0)
    u = torch.rand(up.in_shape, generator=gen).to(dev)
    skip = torch.rand(route[1].in_shape, generator=gen).to(dev)
    m = af.batch_extend_map(af.reshape_map((28, 28, 255), (2352, 85)), batch)
    j, _, fill = fold_pullback((m,))
    idx = torch.from_numpy(j.reshape(m.out_shape)).to(dev)
    pred = torch.randn(m.in_shape, generator=gen).to(dev)
    recs = torch.randn(m.out_shape, generator=gen).to(dev)
    mask = recs[..., 4] >= 0.5
    fns = {
        "tm_chain": lambda: tc.tm_chain(sig, u, (skip,)),
        "rme_evaluate": lambda: rg.rme_evaluate(recs, 0.5, 256,
                                                score_index=4),
        "rme_evaluate_chained": lambda: rg.rme_evaluate_chained(
            pred, idx, None, fill, 0.5, 256, score_index=4),
        "rme_assemble": lambda: rg.rme_assemble(recs, mask, 256),
    }
    if not torch.equal(fns["tm_chain"](), torch.cat(
            [u.repeat_interleave(2, 1).repeat_interleave(2, 2), skip], -1)):
        raise AssertionError("tm_chain at the neck")
    for turn in range(3):
        print(f"calls turn {turn}: " + ", ".join(
            f"{name} {graph_ms(f):.4f} device, {events_ms(f, 200):.4f} per "
            f"call" for name, f in fns.items()) + " ms", flush=True)


SECTIONS = ("matmul", "block", "gather", "conv", "commit", "prologue",
            "chain", "rme")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_tm_kernels: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    want = set(sys.argv[1:]) or set(SECTIONS)
    if want == {"calls"}:
        with torch.inference_mode():
            calls(gen, dev)
        return
    if want - set(SECTIONS):
        raise SystemExit(f"profile_tm_kernels: sections are {SECTIONS}, "
                         f"or calls alone")
    with torch.inference_mode():
        if "matmul" in want:
            sweep_matmul(gen, dev)
        if "block" in want:
            sweep_block(gen, dev)
        if "gather" in want:
            sweep_gather(gen, dev)
        if "conv" in want:
            sweep_conv(gen, dev)
        if "commit" in want:
            sweep_commit(gen, dev)
        if "prologue" in want:
            for dtype in (torch.float32, torch.bfloat16):
                prologue(gen, dev, "YOLO neck -> 1x1 conv 255", 1, dtype)
            prologue(gen, dev, "YOLO neck -> 3x3 conv 255", 3)
        if "chain" in want:
            for dtype in (torch.int8, torch.bfloat16, torch.float32):
                chain(gen, dev, dtype)
        if "rme" in want:
            rme(gen, dev)


def sweep_matmul(gen, dev) -> None:
    M = 360 * 640
    for ep in (mk.Epilogue(), mk.Epilogue("transpose"),
               mk.Epilogue("pixel_shuffle", 360, 640, 3, 3)):
        matmul(gen, dev, M, 288, 27, ep)
    matmul(gen, dev, M, 288, 27, mk.Epilogue(), torch.bfloat16)
    matmul(gen, dev, M, 287, 27, mk.Epilogue())
    for N in (12, 64, 255):
        matmul(gen, dev, M, 288, N, mk.Epilogue())
    matmul(gen, dev, M, 32, 27, mk.Epilogue())


def sweep_block(gen, dev) -> None:
    shape = (448, 448, 64)
    x = torch.rand(shape, generator=gen).to(dev)
    copy = graph_ms(lambda: x.clone())
    print(f"copy {shape} float32 (x.clone(), the yardstick of a plain "
          f"copy): {copy:.4f} ms, bound "
          f"{2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3:.4f}", flush=True)
    del x
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        block(gen, dev, "transpose", af.transpose_map(shape), dtype,
              lambda x: x.permute(1, 0, 2).contiguous())
        block(gen, dev, "band 32:64", af.split_map(shape, 2, 1), dtype,
              lambda x: x[..., 32:].contiguous())
        block(gen, dev, "HWC->CHW", af.axis_permutation_map(
            shape, (2, 0, 1)), dtype,
            lambda x: x.permute(2, 0, 1).contiguous())
    block(gen, dev, "flip W, C", af.flip_map(shape, (1, 2)),
          torch.float32, lambda x: x.flip(1, 2).contiguous())


def sweep_gather(gen, dev) -> None:
    shape = (448, 448, 64)

    def interp(x):
        return F.interpolate(x.permute(2, 0, 1)[None], scale_factor=2,
                             mode="nearest")

    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        gather(gen, dev, "upsample x2", af.upsample_map(shape, 2), dtype,
               interp if dtype != torch.int8 else None)
        gather(gen, dev, "pixel shuffle x2", af.pixel_shuffle_map(shape, 2),
               dtype)
        gather(gen, dev, "pixel unshuffle x2",
               af.pixel_unshuffle_map(shape, 2), dtype)
        gather(gen, dev, "rearrange 3 -> 16",
               af.rearrange_map((448, 448, 3), 1, 16), dtype)


def sweep_conv(gen, dev) -> None:
    conv(gen, dev, "EDSR body", 224, 224, 64, 64)
    conv(gen, dev, "EDSR head", 224, 224, 3, 64)
    conv(gen, dev, "EDSR up", 224, 224, 64, 12)
    conv(gen, dev, "EDSR body", 224, 224, 64, 64, dtype=torch.bfloat16)
    conv(gen, dev, "EDSR body stride 2", 224, 224, 64, 64, stride=2)
    conv(gen, dev, "EDSR body off 16 B (cp.async)", 224, 224, 64, 64,
         offset=1)


def sweep_commit(gen, dev) -> None:
    g = xc.Gemm("conv", (1, 360, 640, 32), (3, 3, 32, 27), 1, "SAME")
    shuffle = ((af.batch_extend_map(
        af.pixel_shuffle_map(g.out_shape[1:], 3), (1,)), None),)
    commit(gen, dev, "ESPCN conv3 -> PixelShuffle x3", g, shuffle)
    commit(gen, dev, "ESPCN conv3 -> PixelShuffle x3", g, shuffle,
           torch.bfloat16)
    pad = ((af.batch_extend_map(af.pad_map(
        g.out_shape[1:], (1, 1, 0), (1, 1, 0), fill=3.0), (1,)), None),)
    commit(gen, dev, "ESPCN conv3 -> pad with fill", g, pad)
    g = xc.Gemm("mm", (230400, 288), (288, 27))
    commit(gen, dev, "mm (230400, 288) x (288, 27) -> transpose", g,
           ((af.axis_permutation_map(g.out_shape, (1, 0)), None),))


if __name__ == "__main__":
    main()
