#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (at first
use, into ``build/``, one ``nvcc`` per source, all at once), then runs its
phases and fails on any mismatch:

1. kernels  — each kernel at the main path's shapes against its plain
   PyTorch version on the card (bit-exact; the conv and resize within a
   stated tolerance), with its device time (from a CUDA graph of
   back-to-back launches) and its time per call with the wrapper's host
   work, the plain version's time, its bound (the larger of bytes over
   3.35 TB/s and f32 operations over 67 TFLOP/s; bf16 operations over 989
   TFLOP/s for the flash kernels) and, where one PyTorch
   call computes the same function, that call's device time;
   tm_affine_block's path (vector, tile or scalar) and bytes per access are
   logged on the timed transpose and on HWC -> CHW f32 and the int8
   transpose at the same size, each bit-exact and timed beside its bound
   and ``permute().contiguous()``; matmul_tm's plan (A stages by TMA or
   cp.async, the tile BM x BN) beside its row; the conv's plan and its
   FMA loop alone, with EDSR's head (C = 3) and up (N = 12) convs checked
   and timed beside ``F.conv2d``; the commit's plan and each of its two
   phases timed alone; tm_affine_gather's plan (separable or general, the
   run, bytes per access) on the Table III upsample, pixel shuffle, pixel
   unshuffle and rearrange, each bit-exact and timed beside its bound, the
   upsample also beside ``F.interpolate`` (nearest, channels-last: its
   library call) and ``x.flatten()[index]``; the prologue's plan, each of
   its two phases alone, and the same work split (``tm_chain``, then
   ``conv2d``, which the one launch has to beat; ``tm_chain``, then
   ``torch.mm``); ``tm_chain``'s run plan at the neck (R, elements an
   access, the bytes of its run tables beside the full pullback's, which
   must stay under 64 KB); each RME compaction's scan rounds per stream;
2. slice 1, per-instruction lowering: the paper's Table III operators as
   single-instruction ``TMProgram``s through ``TMExecutor(backend="cuda")``
   against ``backend="reference"``, bit-exact, with the expected ``cuda.*``
   path; then YOLOv3-Tiny at 448x448x3, 80 classes, batch 8, f32: the eager
   model and its detect tails against a hand-partitioned forward whose TM
   stages (Rearrange, Upsample + Route, reshape + Bboxcal for both heads)
   run as ``TMProgram``s through the cuda executor, packed boxes bit-exact;
3. slice 2, forwarding chains and assemble: chain programs (transpose ->
   split -> transpose, the EDSR x2 superres tail, upsample -> Route, the
   detect tail) and runtime-mask assemble through
   ``TMExecutor(backend="cuda", fuse_chains=True)`` against the reference
   engine, then the same YOLOv3-Tiny forward through the chaining executor
   (4 TM launches instead of 8), bit-exact against the eager model and the
   unfused forward;
4. slice 3, img2col, the implicit-GEMM conv and resize: the paper's Table
   III Img2col and Resize as single-instruction ``TMProgram``s through the
   cuda executor against the reference engine (Img2col bit-exact in every
   dtype, its padding filled from the map), then EDSR x2 at full width
   (feats 64, 8 residual blocks, batch 8, 224x224 -> 448x448, f32): the
   eager model (cuDNN convs) against a hand-partitioned forward whose 18
   convs per image all run through ``conv2d_call``;
5. slice 4, the compiler and the cross-engine kernels: ESPCN x3 on one
   640x360 frame (-> 1920x1080, f32) eager against ``tm_compile`` without
   and with ``cross_engine`` on the cuda backend (one
   ``cuda.xchain.commit``: the last conv and its PixelShuffle in one
   launch); its last layer in im2col form through ``matmul_tm``'s
   pixel-shuffle store; then YOLOv3-Tiny 448x448 batch 8 compiled with
   ``cross_engine=True`` and ``fuse_chains=True`` (phases ``ftf``: the
   Rearrange crossing declined over the 128 MiB budget kept from the JAX
   package, the neck realized as ``cuda.xchain.prologue``), both heads
   against the eager model and the hand-partitioned chained forward;
6. slice 5, the LM serving loop: the two flash kernels join the kernel
   phase at Phi-4-mini's shapes (prefill q (8, 1024, 24, 128) against
   k/v (8, 1024, 8, 128), causal; decode against a (8, 1088, 8, 128)
   cache at length 1025; bf16), each with its achieved TFLOP/s or TB/s
   and its ratio to SDPA's time in the same run, and the f32 prefill (the
   FMA kernel, off the LM's bf16 path: a row of the log's table, not of
   the ``kernels`` line); then ``repro_torch.launch.serve.serve``
   runs Phi-4-mini 3.8B at its full published width (32 layers, random
   bf16 weights from seed 0) on batch 8, 1024-token prompts, 64 generated
   tokens: exactly 32 flash_attention and 32 x 63 flash_decode launches and
   no other kernel; then the same weights and the served tokens, teacher
   forced, through the plain attention in bf16 and in f32: the kernel
   path's logits within 2x the bf16 plain path's distance from the f32
   run, plus a floor, at every step;
7. slice 11, serving: YOLOv3-Tiny 448x448 batch 8 compiled with and
   without ``cross_engine``, four runs at once through ``run_async`` on a
   ``StreamRuntime`` whose engines are two CUDA streams, bit-exact against
   ``run()``, the measured overlap beside ``predict_overlap``; the two
   cooperative launches (ESPCN's commit, the YOLO neck's prologue) queued
   on the tmu stream while the tpu stream runs the eager YOLO's convs,
   finished and bit-exact (no deadlock); then 64 requests (32 YOLOv3-Tiny
   images, 32 ESPCN x3 640x360 frames) from 4 threads through
   ``TMServer(ServerConfig(backend="cuda", max_batch=8,
   batch_timeout_s=0.01))``, cold then warm, with the per-sample vmap
   fallback turned off: every response bit-exact against its cache entry's
   program run directly on the same stacked batch and within slice 4's
   tolerances against the eager models; requests/s, p50/p99 latency, the
   cache hit rate, mean batch, measured against predicted overlap and each
   entry's selection rows are logged;
8. the launch counts of each slice's path, read just after it ran with the
   counts set to 0 just before it: every kernel of the slice > 0; the
   ``kernels`` line gives each kernel its launches from the path of the
   slice that ported it.

The last three lines of standard output are the card's name and power
limit as nvidia-smi gives them, the ``{"kernels": [...]}`` line and
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or without the repository's ``src`` beside it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.fp_bounds import bf16_ulp, conv_tol  # noqa: E402
from repro_torch.models.partitioned import (  # noqa: E402
    CAPACITY, CHAINED_PATHS, CONF, UNFUSED_PATHS, detect_program,
    edsr_partitioned_forward, eager_forward, partitioned_forward)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores, the same sheet
BF16_FLOP_PER_S = 989e12   # bf16 on the tensor cores, dense, the same sheet
SECTOR = 32                # bytes: the least a strided load moves from HBM
SEED = 0
IMG = (8, 448, 448, 3)     # batch 8, paper Table III input
N_CLASSES = 80
TABLE3 = (448, 448, 64)    # paper Table III feature map
EDSR_IMG = (8, 224, 224, 3)  # EDSR x2: batch 8 -> (8, 448, 448, 3)
# ESPCN x3 on one 640x360 frame -> 1920x1080 (the ESPCN paper's 1080p
# video setting, Shi et al. CVPR 2016)
ESPCN_IMG = (1, 360, 640, 3)
# partitioned EDSR vs the eager model: 18 stacked f32 convs (K <= 576)
# summed in other orders, and cuDNN may pick a transform algorithm; the
# residual branches are scaled by 0.1, so the errors stay near the f32
# rounding of one conv (about 1e-6 relative): 1e-4 of the output's largest
# magnitude leaves a factor of 100
EDSR_RTOL = 1e-4
# slice 5: Phi-4-mini 3.8B at full width (its published config), batch 8,
# 1024-token prompts, 64 generated tokens: a 1088-row KV cache
LM_ARCH = "phi4-mini-3.8b"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 64
# the kernel path's logits may be at most 2x as far from the f32 plain run
# as the bf16 plain run is, plus LM_FLOOR_ULPS bf16 ulps of the step's
# largest |f32 logit| (two roundings of each logit, and one of its inputs
# either way)
LM_FLOOR_ULPS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn()`` per call: ``iters`` calls captured in one CUDA
    graph and replayed, so no host work sits between the launches."""
    fn()  # builds, caches and first allocations happen outside the capture
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
    del graph
    return start.elapsed_time(end) / iters


def wall_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean host wall time of ``fn()`` ending in a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def require_within(a: torch.Tensor, b: torch.Tensor, tol, what: str) -> None:
    """Every element of ``a`` within ``tol`` (a number or an elementwise
    tensor) of ``b``."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: shapes {tuple(a.shape)} / "
                             f"{tuple(b.shape)}, dtypes {a.dtype} / {b.dtype}")
    err = (a.to(torch.float64) - b.to(torch.float64)).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max |err| {float(err.max())} past the "
                             f"tolerance")


def require_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise AssertionError(f"{what}: mismatch (shapes {tuple(a.shape)} / "
                             f"{tuple(b.shape)}, max |err| "
                             f"{max_abs_err(a, b) if a.shape == b.shape else 'n/a'})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _rounds(src: torch.Tensor, cnt: torch.Tensor, n: int) -> str:
    """The scan rounds each stream took: the walk stops after the round in
    which the count reaches the capacity (or at the stream's end)."""
    from repro_torch.kernels.rme_gather import rme_gather as rg
    rounds = []
    for b in range(src.shape[0]):
        c = int(cnt[b])
        scanned = int(src[b, c - 1]) + 1 if c == src.shape[1] > 0 else n
        rounds.append(-(-scanned // rg.ROUND_ROWS))
    return (f"scan rounds of {rg.ROUND_ROWS} rows per stream {rounds} "
            f"(a {n}-row stream is {-(-n // rg.ROUND_ROWS)})")


def chain_row(dev, gen) -> dict:
    """tm_chain at the YOLOv3-Tiny neck: u0 (8, 14, 14, 128) upsample x2,
    then Route with the skip map (8, 28, 28, 128) -> (8, 28, 28, 256)."""
    from repro_torch.core import affine as af
    from repro_torch.kernels.tm_affine import chain as ch

    batch = (IMG[0],)
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), batch)
    route = tuple(af.batch_extend_map(m, batch) for m in
                  af.route_maps([(28, 28, 128), (28, 28, 128)]))
    sig = ch.ChainSig(links=((up, None),), route_maps=route, route_band=0,
                      dtype="float32")
    plan = ch.chain_plan_of(sig)
    u0 = torch.rand(up.in_shape, generator=gen).to(dev)
    skip = torch.rand(route[1].in_shape, generator=gen).to(dev)
    got = ch.tm_chain(sig, u0, (skip,))
    ref = ch.chain_plain(u0, plan, (skip,))
    require_equal(got, ref, "tm_chain")
    require_equal(got, torch.cat([u0.repeat_interleave(2, 1)
                                  .repeat_interleave(2, 2), skip], -1),
                  "tm_chain vs upsample + concatenate")
    f32 = 4
    nbytes = (u0.numel() + skip.numel() + got.numel()) * f32
    consts = sum(a.nbytes for a in [plan.j]
                 + [a for lv in plan.levels for a in (lv.mask, lv.p)
                    if a is not None]
                 + [a for ex in plan.extras for a in (ex.idx, ex.mask)
                    if a is not None])
    rp = ch.build_run_plan(sig)
    table, outer = rp.table_bytes, rp.outer_bytes
    log(f"kernel tm_chain: {nbytes} bytes of data; run tables {table} bytes "
        f"(staged per block) + {outer} bytes per-run tables = "
        f"{table + outer} bytes read in place of {consts} bytes of full "
        f"pullback constants (neither in the bound); runs of R = "
        f"{rp.run}, {rp.vec} element(s) an access; {len(plan.levels)} "
        f"level(s), {len(plan.extras)} extra band(s)")
    if table + outer >= 64 * 1024:
        raise AssertionError(f"tm_chain: {table + outer} bytes of run tables "
                             f"at the neck, expected under 64 KB")
    return dict(
        name="tm_chain", route="cuda",
        source="src/repro_torch/csrc/tm_chain.cu",
        replaces="src/repro/kernels/tm_affine/chain.py:340",
        max_abs_err=max_abs_err(got, ref),
        ms=graph_ms(lambda: ch.tm_chain(sig, u0, (skip,))),
        call_ms=cuda_ms(lambda: ch.tm_chain(sig, u0, (skip,))),
        plain_ms=cuda_ms(lambda: ch.chain_plain(u0, plan, (skip,))),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
        shape="neck upsample x2 (8, 14, 14, 128) + Route (8, 28, 28, 128) "
              "f32")


def chained_evaluate_row(dev, gen) -> dict:
    """rme_evaluate_chained at head 2's detect tail: the raw grid
    (8, 28, 28, 255) pulled back as (8, 2352, 85) record streams."""
    from repro_torch.core import affine as af
    from repro_torch.kernels.rme_gather import rme_gather as rg
    from repro_torch.kernels.tm_affine.chain import fold_pullback

    f32 = 4
    m = af.batch_extend_map(af.reshape_map((28, 28, 255), (2352, 85)),
                            (IMG[0],))
    j, ok, fill = fold_pullback((m,))
    idx = torch.from_numpy(j.reshape(m.out_shape)).to(dev)
    ok = None if ok is None else torch.from_numpy(
        ok.reshape(m.out_shape)).to(dev)
    pred = torch.randn(m.in_shape, generator=gen).to(dev)

    def call():
        return rg.rme_evaluate_chained(pred, idx, ok, fill, CONF, CAPACITY,
                                       score_index=4)

    got = call()
    ref = rg.evaluate_chained_plain(pred, idx, ok, fill, CONF, CAPACITY,
                                    score_index=4)
    unchained = rg.evaluate_plain(pred.reshape(m.out_shape), CONF, CAPACITY,
                                  score_index=4)
    for g, r, u, what in zip(got, ref, unchained, ("rows", "idx", "count")):
        require_equal(g, r, f"rme_evaluate_chained {what}")
        require_equal(g, u, f"rme_evaluate_chained {what} vs unchained")
    B, N, D = m.out_shape
    src, cnt = ref[1], ref[2]
    nbytes = consts = 0
    for b in range(B):  # what this run's data needs (the walk stops early)
        c = int(cnt[b])
        scanned = int(src[b, c - 1]) + 1 if c == CAPACITY else N
        # a scanned, unkept row costs one sector of scores (and one of its
        # pullback index); a kept row is read whole (and its D indices)
        nbytes += (scanned - c) * SECTOR + c * D * f32
        consts += (scanned - c) * SECTOR + c * D * 4
    nbytes += B * (CAPACITY * D * f32 + CAPACITY * 4 + 4)  # packed output
    log(f"kernel rme_evaluate_chained: {nbytes} bytes of data, {consts} "
        f"bytes of pullback index read (not in the bound), ok mask "
        f"{'none' if ok is None else 'present'}; {_rounds(src, cnt, N)}")
    return dict(
        name="rme_evaluate_chained", route="cuda",
        source="src/repro_torch/csrc/rme_gather.cu",
        replaces="src/repro/kernels/rme_gather/rme_gather.py:176",
        max_abs_err=max(max_abs_err(g, r) for g, r in zip(got, ref)),
        ms=graph_ms(call), call_ms=cuda_ms(call),
        plain_ms=cuda_ms(lambda: rg.evaluate_chained_plain(
            pred, idx, ok, fill, CONF, CAPACITY, score_index=4)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
        shape=f"(8, 28, 28, 255) -> (8, 2352, 85) f32 cap {CAPACITY}, "
              f"{int(cnt.sum())} kept")


def img2col_row(dev, gen) -> dict:
    """img2col at Table III: (448, 448, 64) f32, 3x3 stride 1, no padding
    (site #11, overlapping slabs); the other dtypes are checked beside it,
    the 2x2 stride-2 case (site #10) checked and timed."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.img2col import img2col as ik

    x = torch.rand(TABLE3, generator=gen).to(dev)
    got = ik.img2col(x, 3, 3, 1, 0)
    ref = ik.img2col_plain(x, 3, 3, 1, 0)
    require_equal(got, ref, "img2col")
    err = max_abs_err(got, ref)
    nbytes = (x.numel() + got.numel()) * 4
    del got, ref
    for dtype in (torch.int8, torch.int32, torch.bfloat16):
        xd = (x * 200 - 100).to(dtype)
        require_equal(ik.img2col(xd, 3, 3, 1, 0),
                      ik.img2col_plain(xd, 3, 3, 1, 0), f"img2col[{dtype}]")
    # the library call: one strided copy of the (OH, OW, ky, kx, C) window
    # view, which is this layout; F.unfold's (channel-major columns, rows
    # last) is timed beside it as the nearest conv-library call
    def unfold_copy(k, s):
        return lambda: (x.unfold(0, k, s).unfold(1, k, s)
                        .permute(0, 1, 3, 4, 2)
                        .reshape(-1, k * k * x.shape[2]))

    lib3, lib2 = unfold_copy(3, 1), unfold_copy(2, 2)
    require_equal(lib3(), ik.img2col(x, 3, 3, 1, 0),
                  "img2col vs the unfold copy")
    xn = x.permute(2, 0, 1)[None]  # NCHW view of the same memory
    unfold_ms = graph_ms(lambda: F.unfold(xn, 3), iters=10)
    s2 = ik.img2col(x, 2, 2, 2, 0)
    require_equal(s2, ik.img2col_plain(x, 2, 2, 2, 0), "img2col 2x2 s2")
    require_equal(s2, lib2(), "img2col 2x2 s2 vs the unfold copy")
    s2_bytes = (x.numel() + s2.numel()) * 4
    del s2
    s2_ms = graph_ms(lambda: ik.img2col(x, 2, 2, 2, 0), iters=10)
    s2_call_ms = cuda_ms(lambda: ik.img2col(x, 2, 2, 2, 0), iters=10)
    s2_plain_ms = cuda_ms(lambda: ik.img2col_plain(x, 2, 2, 2, 0), iters=3,
                          warmup=1)
    log(f"kernel img2col 2x2 stride 2 (448, 448, 64) f32 (site #10): "
        f"{s2_ms:.4f} ms device ({s2_call_ms:.4f} per call with host work; "
        f"plain {s2_plain_ms:.4f}, bound "
        f"{s2_bytes / HBM_BYTES_PER_S * 1e3:.4f}, library (unfold copy) "
        f"{graph_ms(lib2, iters=10):.4f}); int8, int32, bf16 at 3x3 s1 "
        f"bit-exact; F.unfold 3x3 (columns channel-major, another layout) "
        f"{unfold_ms:.4f} ms")
    return dict(
        name="img2col", route="cuda",
        source="src/repro_torch/csrc/img2col.cu",
        replaces="src/repro/kernels/img2col/img2col.py:94",
        max_abs_err=err,
        ms=graph_ms(lambda: ik.img2col(x, 3, 3, 1, 0), iters=10),
        call_ms=cuda_ms(lambda: ik.img2col(x, 3, 3, 1, 0), iters=10),
        plain_ms=cuda_ms(lambda: ik.img2col_plain(x, 3, 3, 1, 0), iters=3,
                         warmup=1),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=graph_ms(lib3, iters=10),
        shape="3x3 stride 1 (448, 448, 64) -> (198916, 576) f32")


def _conv_check(x, w, what: str) -> float:
    """conv2d of x by w (pad 1) against its plain version: f32 within
    2 gamma_K sum |x w|, bf16 one bf16 ulp more; returns the f32 max
    |err|."""
    from repro_torch.kernels.img2col import img2col as ik
    got, ref = ik.conv2d(x, w, 1, 1), ik.conv2d_plain(x, w, 1, 1)
    require_within(got, ref, conv_tol(x, w, 1, 1), f"{what} f32")
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    gb, rb = ik.conv2d(xb, wb, 1, 1), ik.conv2d_plain(xb, wb, 1, 1)
    require_within(gb, rb, conv_tol(xb, wb, 1, 1) + bf16_ulp(rb),
                   f"{what} bf16")
    return max_abs_err(got, ref)


def _conv_bound(x, w, out_numel: int) -> tuple[float, str, float]:
    """(bound ms, what bounds it, GFLOP) of a conv of x by w, f32."""
    H, W, C = x.shape
    flops = 2 * H * W * w.shape[3] * w.shape[0] * w.shape[1] * C
    nbytes = (x.numel() + w.numel() + out_numel) * 4
    t_ops, t_bytes = flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", flops / 1e9)


def conv2d_row(dev, gen) -> dict:
    """The implicit-GEMM conv at the EDSR body conv: (224, 224, 64) by
    (3, 3, 64, 64), pad 1, f32 (timed) and bf16 (checked); its plan and
    its FMA loop alone are logged, and EDSR's head (C = 3 -> 64, the
    cp.async path) and up conv (64 -> 12) are checked and timed beside it,
    each with its bound and F.conv2d."""
    import torch.nn.functional as F
    from repro_torch.kernels.img2col import img2col as ik

    H, W, C = EDSR_IMG[1], EDSR_IMG[2], 64
    for name, cin, cout in (("head", 3, 64), ("up", 64, 12)):
        xs = torch.rand((H, W, cin), generator=gen).to(dev)
        ws = ((torch.rand((3, 3, cin, cout), generator=gen) - 0.5)
              * 0.1).to(dev)
        err = _conv_check(xs, ws, f"conv2d EDSR {name}")
        plan = ik.conv2d_plan(xs, ws, 1, 1)
        bound, by, gflop = _conv_bound(xs, ws, H * W * cout)
        xn, wn = xs.permute(2, 0, 1)[None], ws.permute(3, 2, 0, 1)
        log(f"kernel conv2d EDSR {name} ({H}, {W}, {cin}) x (3, 3, {cin}, "
            f"{cout}) f32, {gflop:.3f} GFLOP: {plan}; max |err| {err}; "
            f"{graph_ms(lambda: ik.conv2d(xs, ws, 1, 1)):.4f} ms device, "
            f"bound {bound:.4f} ({by}), F.conv2d "
            f"{graph_ms(lambda: F.conv2d(xn, wn, padding=1)):.4f}")
    x = torch.rand((H, W, C), generator=gen).to(dev)
    w = ((torch.rand((3, 3, C, C), generator=gen) - 0.5) * 0.1).to(dev)
    err = _conv_check(x, w, "conv2d")
    got = ik.conv2d(x, w, 1, 1)
    bound, by, gflop = _conv_bound(x, w, got.numel())
    plan = ik.conv2d_plan(x, w, 1, 1)
    fma = graph_ms(lambda: ik.conv2d_fma_probe(x, w, 1, 1))
    log(f"kernel conv2d plan: {plan} (rounds {plan.rounds}, last round "
        f"{plan.last_fill:.3f} full); the FMA loop alone (no loads) "
        f"{fma:.4f} ms = {gflop / fma:.1f} TFLOP/s, "
        f"{gflop / fma / (F32_FLOP_PER_S / 1e12):.3f} of 67; f32 max |err| "
        f"{err} (tolerance 2 gamma_576 sum|xw|)")
    xn, wn = x.permute(2, 0, 1)[None], w.permute(3, 2, 0, 1)
    return dict(
        name="conv2d", route="cuda",
        source="src/repro_torch/csrc/img2col.cu",
        replaces="src/repro/kernels/img2col/img2col.py:130",
        max_abs_err=err,
        ms=graph_ms(lambda: ik.conv2d(x, w, 1, 1)),
        call_ms=cuda_ms(lambda: ik.conv2d(x, w, 1, 1)),
        plain_ms=cuda_ms(lambda: ik.conv2d_plain(x, w, 1, 1)),
        bound_ms=bound, bound_by=by,
        library_ms=graph_ms(lambda: F.conv2d(xn, wn, padding=1)),
        shape="EDSR body conv (224, 224, 64) x (3, 3, 64, 64) pad 1 f32, "
              f"{gflop:.3f} GFLOP")


def resize_row(dev, gen) -> dict:
    """Bilinear resize of the Table III map, (448, 448, 64) ->
    (224, 224, 64), f32 (timed) and bf16 (checked)."""
    import torch.nn.functional as F
    from repro_torch.kernels.resize import resize as rk

    x = torch.rand(TABLE3, generator=gen).to(dev)
    got = rk.resize_bilinear(x, 224, 224)
    ref = rk.resize_plain(x, 224, 224)
    require_within(got, ref, 1e-5, "resize f32")
    xb = x.to(torch.bfloat16)
    gb, rb = rk.resize_bilinear(xb, 224, 224), rk.resize_plain(xb, 224, 224)
    require_within(gb, rb, bf16_ulp(rb), "resize bf16")
    xn = x.permute(2, 0, 1)[None]
    lib = F.interpolate(xn, size=(224, 224), mode="bilinear",
                        align_corners=False)
    log(f"kernel resize: f32 max |err| {max_abs_err(got, ref)} (tolerance "
        f"1e-5), bf16 {max_abs_err(gb, rb)} (one bf16 ulp); F.interpolate "
        f"vs the kernel {max_abs_err(lib[0].permute(1, 2, 0), got)}")
    nbytes = (x.numel() + got.numel()) * 4
    return dict(
        name="resize", route="cuda",
        source="src/repro_torch/csrc/resize.cu",
        replaces="src/repro/kernels/resize/resize.py:52",
        max_abs_err=max_abs_err(got, ref),
        ms=graph_ms(lambda: rk.resize_bilinear(x, 224, 224)),
        call_ms=cuda_ms(lambda: rk.resize_bilinear(x, 224, 224)),
        plain_ms=cuda_ms(lambda: rk.resize_plain(x, 224, 224)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=graph_ms(lambda: F.interpolate(
            xn, size=(224, 224), mode="bilinear", align_corners=False)),
        shape="(448, 448, 64) -> (224, 224, 64) f32")


def _conv_mag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum |x w| of an NHWC SAME conv (stride 1) in float64: the scale of
    its rounding bound 2 gamma_K sum |x w| (K = kh kw C)."""
    from repro_torch.models.cnn import conv2d_nhwc
    return conv2d_nhwc(x.double().abs(), w.double().abs(), 1, "SAME")


def _shuffle(y: torch.Tensor, s: int) -> torch.Tensor:
    """PixelShuffle of an NHWC map, the paper's c-major channel order."""
    B, H, W, Cs = y.shape
    C = Cs // (s * s)
    return (y.reshape(B, H, W, C, s, s).permute(0, 1, 4, 2, 5, 3)
            .reshape(B, H * s, W * s, C))


def espcn_setup(dev, gen) -> dict:
    """ESPCN x3 at init_espcn's widths (5x5 to 64, 3x3 to 32, 3x3 to 27)
    with random weights, one 640x360 frame, the eager output and the
    feature map its last conv reads."""
    from repro_torch.models import cnn
    model = cnn.init_espcn(gen, s=3, device=dev)
    img = torch.rand(ESPCN_IMG, generator=gen).to(dev)
    h = torch.tanh(cnn.conv2d(torch.tanh(cnn.conv2d(img, model.c1)),
                              model.c2))
    return dict(model=model, img=img, eager=model(img), h=h)


def matmul_tm_row(e: dict) -> dict:
    """matmul_tm (#13) at ESPCN's last layer in im2col form: the
    (360, 640, 32) map's 3x3 patches (230400, 288) by the (288, 27)
    weights, stored through the pixel-shuffle epilogue as (1080, 1920, 3)."""
    from repro_torch.kernels.img2col.ops import img2col_call
    from repro_torch.kernels.matmul_tm import matmul_tm as mk
    from repro_torch.core.fp_bounds import gamma

    (_, H, W, _), C, s = e["h"].shape, 3, 3
    patches = img2col_call(e["h"][0], kh=3, kw=3, stride=1, pad=1)
    w = e["model"].c3.reshape(-1, C * s * s).contiguous()
    ep = mk.Epilogue("pixel_shuffle", H, W, C, s)
    got = mk.matmul_tm(patches, w, ep)
    ref = mk.matmul_tm_plain(patches, w, ep)
    K = patches.shape[1]
    mag = _shuffle((patches.double().abs() @ w.double().abs())
                   .reshape(1, H, W, -1), s)[0]
    require_within(got, ref, 2 * gamma(K) * mag, "matmul_tm pixel shuffle")
    M, N = patches.shape[0], w.shape[1]
    flops = 2 * M * N * K
    nbytes = (patches.numel() + w.numel() + got.numel()) * 4
    plan = mk.mm_plan(M, K, N, patches.dtype, patches.data_ptr() % 16 == 0)
    log(f"kernel matmul_tm plan: A stages by {plan.path}, tiles BM {plan.BM} "
        f"x BN {plan.BN} for ({M}, {K}) x ({K}, {N}) f32")
    # the identity and transposed epilogues at the same product
    for mode in ("identity", "transpose"):
        g = mk.matmul_tm(patches, w, mk.Epilogue(mode))
        r = mk.matmul_tm_plain(patches, w, mk.Epilogue(mode))
        bound = 2 * gamma(K) * (patches.double().abs() @ w.double().abs())
        require_within(g, r, bound.T if mode == "transpose" else bound,
                       f"matmul_tm {mode}")
        ms = graph_ms(lambda: mk.matmul_tm(patches, w, mk.Epilogue(mode)),
                      iters=10)
        log(f"kernel matmul_tm {mode} epilogue: {ms:.4f} ms device, bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} (bytes)")
    return dict(
        name="matmul_tm", route="cuda",
        source="src/repro_torch/csrc/matmul_tm.cu",
        replaces="src/repro/kernels/matmul_tm/matmul_tm.py:85",
        max_abs_err=max_abs_err(got, ref),
        ms=graph_ms(lambda: mk.matmul_tm(patches, w, ep), iters=10),
        call_ms=cuda_ms(lambda: mk.matmul_tm(patches, w, ep), iters=10),
        plain_ms=cuda_ms(lambda: mk.matmul_tm_plain(patches, w, ep),
                         iters=5),
        bound_ms=max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by=("operations" if flops / F32_FLOP_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=graph_ms(lambda: torch.mm(patches, w), iters=10),
        shape="ESPCN last layer im2col (230400, 288) x (288, 27) -> "
              "pixel shuffle (1080, 1920, 3) f32")


def xchain_commit_row(e: dict) -> dict:
    """xchain_commit (#14) at ESPCN's crossing: the 3x3 conv of the
    (1, 360, 640, 32) map to 27 channels, through the PixelShuffle x3 chain
    into (1, 1080, 1920, 3)."""
    from repro_torch.core import affine as af
    from repro_torch.core.fp_bounds import gamma
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.tm_affine.chain import ChainSig

    h, w = e["h"], e["model"].c3
    g = xc.Gemm("conv", tuple(h.shape), tuple(w.shape), 1, "SAME")
    m = af.batch_extend_map(af.pixel_shuffle_map(g.out_shape[1:], 3), (1,))
    sig = ChainSig(links=((m, None),), dtype="float32")
    got = xc.xchain_commit(sig, g, h, w)
    ref = xc.xchain_commit_plain(sig, g, h, w)
    tol = 2 * gamma(g.words()[3]) * _shuffle(_conv_mag(h, w), 3)
    require_within(got, ref, tol, "xchain_commit")
    flops = g.flops()
    nbytes = (h.numel() + w.numel() + got.numel()) * 4
    ms = graph_ms(lambda: xc.xchain_commit(sig, g, h, w), iters=10)
    product, walk = (graph_ms(lambda: xc.xchain_commit_phase(
        sig, g, h, w, phase), iters=10) for phase in ("product", "chain"))
    plan = xc.xchain_commit_card_plan(g, h)
    log(f"kernel xchain_commit plan: {plan} (rounds {plan.rounds}, last "
        f"round {plan.last_fill:.3f} full), scratch {g.out_shape} f32; "
        f"{ms:.4f} ms; the kernel with one phase: product {product:.4f}, "
        f"chain {walk:.4f}")
    return dict(
        name="xchain_commit", route="cuda",
        source="src/repro_torch/csrc/xchain_commit.cu",
        replaces="src/repro/kernels/matmul_tm/chain.py:222",
        max_abs_err=max_abs_err(got, ref),
        ms=ms,
        call_ms=cuda_ms(lambda: xc.xchain_commit(sig, g, h, w), iters=10),
        plain_ms=cuda_ms(lambda: xc.xchain_commit_plain(sig, g, h, w),
                         iters=10),
        bound_ms=max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by=("operations" if flops / F32_FLOP_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=None,
        shape="ESPCN conv3 (1, 360, 640, 32) x (3, 3, 32, 27) -> "
              "PixelShuffle x3 (1, 1080, 1920, 3) f32")


def xchain_prologue_row(dev, gen) -> dict:
    """xchain_prologue (#15) at the YOLOv3-Tiny neck: upsample x2 of u
    (8, 14, 14, 128), Route with the skip map (8, 28, 28, 128), into
    head 2's 1x1 conv (1, 1, 256, 255); logged with its plan, each of its
    two phases alone, and the same work split: the port's own two kernels
    (tm_chain, then conv2d), which the one launch has to beat, and
    tm_chain, then torch.mm."""
    from repro_torch.core import affine as af
    from repro_torch.core.fp_bounds import gamma
    from repro_torch.kernels.img2col import img2col as ik
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.tm_affine import chain as ch

    batch = (IMG[0],)
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), batch)
    route = tuple(af.batch_extend_map(m, batch) for m in
                  af.route_maps([(28, 28, 128), (28, 28, 128)]))
    sig = ch.ChainSig(links=((up, None),), route_maps=route, route_band=0,
                      dtype="float32")
    u = torch.rand(up.in_shape, generator=gen).to(dev)
    skip = torch.rand(route[1].in_shape, generator=gen).to(dev)
    w = ((torch.rand((1, 1, 256, 255), generator=gen) - 0.5) / 8).to(dev)
    g = xc.Gemm("conv", (8, 28, 28, 256), tuple(w.shape), 1, "SAME")
    got = xc.xchain_prologue(sig, g, 0, u, w, (skip,))
    ref = xc.xchain_prologue_plain(sig, g, 0, u, w, (skip,))
    cat = torch.cat([u.repeat_interleave(2, 1).repeat_interleave(2, 2),
                     skip], -1)
    require_within(got, ref, 2 * gamma(256) * _conv_mag(cat, w),
                   "xchain_prologue")
    flops = g.flops()
    nbytes = (u.numel() + skip.numel() + w.numel() + got.numel()) * 4
    ms = graph_ms(lambda: xc.xchain_prologue(sig, g, 0, u, w, (skip,)))
    walk, product = (graph_ms(lambda: xc.xchain_prologue_phase(
        sig, g, 0, u, w, phase, (skip,))) for phase in ("chain", "product"))
    w2 = w.reshape(256, 255)
    split = graph_ms(lambda: torch.mm(ch.tm_chain(sig, u, (skip,))
                                      .reshape(-1, 256), w2))
    mm = graph_ms(lambda: torch.mm(cat.reshape(-1, 256), w2))
    ported = graph_ms(lambda: ik.conv2d(ch.tm_chain(sig, u, (skip,))
                                        .reshape(-1, 1, 256), w))
    plan = xc.xchain_prologue_card_plan(g, cat)
    log(f"kernel xchain_prologue plan: {plan} (rounds {plan.rounds}, last "
        f"round {plan.last_fill:.3f} full), scratch {tuple(cat.shape)} f32; "
        f"{ms:.4f} ms; the kernel with one phase: chain {walk:.4f}, product "
        f"{product:.4f}; split tm_chain + conv2d {ported:.4f} (the one "
        f"launch {'beats' if ms < ported else 'does not beat'} it); split "
        f"tm_chain + torch.mm {split:.4f} (torch.mm alone {mm:.4f}, TF32 "
        f"off)")
    return dict(
        name="xchain_prologue", route="cuda",
        source="src/repro_torch/csrc/xchain_prologue.cu",
        replaces="src/repro/kernels/matmul_tm/chain.py:312",
        max_abs_err=max_abs_err(got, ref),
        ms=ms,
        call_ms=cuda_ms(lambda: xc.xchain_prologue(sig, g, 0, u, w,
                                                   (skip,))),
        plain_ms=cuda_ms(lambda: xc.xchain_prologue_plain(sig, g, 0, u, w,
                                                          (skip,))),
        bound_ms=max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by=("operations" if flops / F32_FLOP_PER_S
                  > nbytes / HBM_BYTES_PER_S else "bytes"),
        library_ms=None,
        shape="YOLO neck upsample (8, 14, 14, 128) + Route (8, 28, 28, 128) "
              "-> head2 1x1 conv (1, 1, 256, 255) f32")


def gather_maps_log(x: torch.Tensor) -> None:
    """tm_affine_gather's plan (path, run R, bytes per access) on the four
    Table III operator maps that reach gather mode, each bit-exact against
    its plain version and timed beside its byte bound (input read once,
    output written once)."""
    from repro_torch.core import affine as af
    from repro_torch.kernels.tm_affine import tm_affine as ta

    gen = torch.Generator().manual_seed(SEED + 1)
    xr = torch.rand((448, 448, 3), generator=gen).to(x.device)
    cases = (("upsample", x, af.upsample_map(TABLE3, 2)),
             ("pixelshuffle", x, af.pixel_shuffle_map(TABLE3, 2)),
             ("pixelunshuffle", x, af.pixel_unshuffle_map(TABLE3, 2)),
             ("rearrange", xr, af.rearrange_map((448, 448, 3), 1, 16)))
    for name, xx, m in cases:
        launch = ta.gather_launch(m, xx)
        plan = ta.separable_plan(m, xx.element_size())
        got = ta.tm_affine_gather(xx, m)
        require_equal(got, ta.gather_plain(xx, m), f"tm_affine_gather {name}")
        ms = graph_ms(lambda: ta.tm_affine_gather(xx, m), iters=10)
        bound = ((xx.numel() + got.numel()) * xx.element_size()
                 / HBM_BYTES_PER_S * 1e3)
        run = (f"run R {plan.R} from axis {plan.suffix}"
               if plan is not None else "no separable run")
        log(f"kernel tm_affine_gather {name} {tuple(xx.shape)} -> "
            f"{tuple(got.shape)} f32: path {launch.path}, {run}, "
            f"{launch.vbytes} B per access; {ms:.4f} ms device, bound "
            f"{bound:.4f} ({bound / ms:.2f} of it)")


def block_maps_log(x: torch.Tensor, m, plan, gen) -> None:
    """tm_affine_block's path and bytes per access on the timed transpose,
    and two more maps of the Table III size, each bit-exact against its
    plain version and timed beside its byte bound and one
    ``permute(...).contiguous()``: HWC -> CHW in f32 (the tile path) and
    the transpose in int8 (16-byte vectors of 16 elements)."""
    from repro_torch.core import affine as af
    from repro_torch.kernels.tm_affine import tm_affine as ta

    xi = torch.randint(-128, 128, TABLE3, generator=gen,
                       dtype=torch.int8).to(x.device)
    chw = af.axis_permutation_map(TABLE3, (2, 0, 1))
    cases = (("transpose f32", x, m, plan),
             ("HWC->CHW f32", x, chw, ta.analyze_block_mode(chw)),
             ("transpose int8", xi, m, plan))
    for name, xx, mm, pl in cases:
        regs = ta._block_regs(mm, pl, xx.dtype, xx.device)
        got = ta.tm_affine_block(xx, mm, pl)
        require_equal(got, ta.block_plain(xx, mm, pl),
                      f"tm_affine_block {name}")
        ms = graph_ms(lambda: ta.tm_affine_block(xx, mm, pl))
        lib = graph_ms(lambda: xx.permute(*pl.src_axis).contiguous())
        bound = 2 * xx.numel() * xx.element_size() / HBM_BYTES_PER_S * 1e3
        log(f"kernel tm_affine_block {name} {TABLE3}: path {regs.path}, "
            f"{regs.vbytes} B per access; {ms:.4f} ms device, bound "
            f"{bound:.4f} ({ms / bound:.2f}x), permute().contiguous() "
            f"{lib:.4f}")


def kernel_phase(dev, gen, espcn: dict) -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.core import affine as af
    from repro_torch.core.engine import gather_indices
    from repro_torch.kernels.rme_gather import rme_gather as rg
    from repro_torch.kernels.tm_affine import tm_affine as ta

    rows = []
    f32 = 4

    # block mode: Transpose at Table III size (448x448x64 f32)
    m = af.transpose_map(TABLE3)
    plan = ta.analyze_block_mode(m)
    x = torch.rand(TABLE3, generator=gen).to(dev)
    got = ta.tm_affine_block(x, m, plan)
    ref = ta.block_plain(x, m, plan)
    require_equal(got, ref, "tm_affine_block")
    nbytes = 2 * x.numel() * f32
    block_maps_log(x, m, plan, gen)
    rows.append(dict(
        name="tm_affine_block", route="cuda",
        source="src/repro_torch/csrc/tm_affine.cu",
        replaces="src/repro/kernels/tm_affine/tm_affine.py:203",
        max_abs_err=max_abs_err(got, ref),
        ms=graph_ms(lambda: ta.tm_affine_block(x, m, plan)),
        call_ms=cuda_ms(lambda: ta.tm_affine_block(x, m, plan)),
        plain_ms=cuda_ms(lambda: ta.block_plain(x, m, plan)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=graph_ms(lambda: x.permute(1, 0, 2).contiguous()),
        shape="transpose 448x448x64 f32"))

    # gather mode: Upsample x2 at Table III size (448x448x64 -> 896x896x64)
    m = af.upsample_map(TABLE3, 2)
    got = ta.tm_affine_gather(x, m)
    ref = ta.gather_plain(x, m)
    require_equal(got, ref, "tm_affine_gather")
    flat, _ = gather_indices(m, dev)
    flat = flat.reshape(-1)
    xf = x.reshape(-1)
    require_equal(xf[flat].reshape(m.out_shape), got, "upsample index")
    # the same upsample in one PyTorch call: x as a channels-last NCHW view
    xcl = x.permute(2, 0, 1).unsqueeze(0)
    interp = lambda: F.interpolate(xcl, scale_factor=2,  # noqa: E731
                                   mode="nearest")
    require_equal(interp()[0].permute(1, 2, 0), got, "upsample interpolate")
    index_ms = graph_ms(lambda: xf[flat], iters=10)
    gather_maps_log(x)
    nbytes = (x.numel() + got.numel()) * f32
    rows.append(dict(
        name="tm_affine_gather", route="cuda",
        source="src/repro_torch/csrc/tm_affine.cu",
        replaces="src/repro/kernels/tm_affine/tm_affine.py:256",
        max_abs_err=max_abs_err(got, ref),
        ms=graph_ms(lambda: ta.tm_affine_gather(x, m), iters=10),
        call_ms=cuda_ms(lambda: ta.tm_affine_gather(x, m)),
        plain_ms=cuda_ms(lambda: ta.gather_plain(x, m), iters=5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=graph_ms(interp, iters=10),
        shape="upsample x2 448x448x64 f32"))
    log(f"kernel tm_affine_gather upsample: library F.interpolate nearest "
        f"(channels-last) {rows[-1]['library_ms']:.4f} ms, x.flatten()[index] "
        f"{index_ms:.4f} ms")
    del flat, xf

    # RME evaluate: YOLO head-2 record streams (batch 8, 28*28*3 rows of 85)
    recs = torch.randn((IMG[0], 28 * 28 * 3, 5 + N_CLASSES),
                       generator=gen).to(dev)
    got = rg.rme_evaluate(recs, CONF, CAPACITY, score_index=4)
    ref = rg.evaluate_plain(recs, CONF, CAPACITY, score_index=4)
    for g, r, what in zip(got, ref, ("rows", "idx", "count")):
        require_equal(g, r, f"rme_evaluate {what}")
    B, N, D = recs.shape
    idx, cnt = ref[1], ref[2]
    nbytes = 0
    for b in range(B):  # what this run's data needs (the walk stops early)
        c = int(cnt[b])
        scanned = int(idx[b, c - 1]) + 1 if c == CAPACITY else N
        # a score sits a record (D * 4 bytes) from the next, so each scanned
        # row that is not kept costs one sector; a kept row is read whole
        nbytes += (scanned - c) * SECTOR + c * D * f32
    nbytes += B * (CAPACITY * D * f32 + CAPACITY * 4 + 4)  # packed output
    log(f"kernel rme_evaluate: {_rounds(idx, cnt, N)}")
    rows.append(dict(
        name="rme_evaluate", route="cuda",
        source="src/repro_torch/csrc/rme_gather.cu",
        replaces="src/repro/kernels/rme_gather/rme_gather.py:105",
        max_abs_err=max(max_abs_err(g, r) for g, r in zip(got, ref)),
        ms=graph_ms(lambda: rg.rme_evaluate(recs, CONF, CAPACITY,
                                            score_index=4)),
        call_ms=cuda_ms(lambda: rg.rme_evaluate(recs, CONF, CAPACITY,
                                                score_index=4)),
        plain_ms=cuda_ms(lambda: rg.evaluate_plain(recs, CONF, CAPACITY,
                                                   score_index=4)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
        shape=f"(8, 2352, 85) f32 cap {CAPACITY}, "
              f"{int(cnt.sum())} kept"))
    evaluated = ref

    rows.append(chain_row(dev, gen))
    rows.append(chained_evaluate_row(dev, gen))

    # RME assemble: the same records under mask = score >= CONF, which is
    # rme_evaluate's test, so the packed rows must equal its rows as well
    mask = recs[..., 4] >= CONF
    got = rg.rme_assemble(recs, mask, CAPACITY)
    ref = rg.assemble_plain(recs, mask, CAPACITY)
    for g, r, what in zip(got, ref, ("rows", "count")):
        require_equal(g, r, f"rme_assemble {what}")
    require_equal(got[0], evaluated[0], "rme_assemble rows vs rme_evaluate")
    require_equal(got[1], evaluated[2], "rme_assemble count vs rme_evaluate")
    nbytes = 0
    for b in range(B):  # the walk stops once the buffer is full
        c = int(cnt[b])
        scanned = int(idx[b, c - 1]) + 1 if c == CAPACITY else N
        nbytes += scanned + c * D * f32  # one mask byte per scanned row
    nbytes += B * (CAPACITY * D * f32 + 4)  # packed rows and count
    log(f"kernel rme_assemble: {_rounds(idx, cnt, N)}")
    rows.append(dict(
        name="rme_assemble", route="cuda",
        source="src/repro_torch/csrc/rme_gather.cu",
        replaces="src/repro/kernels/rme_gather/rme_gather.py:222",
        max_abs_err=max(max_abs_err(g, r) for g, r in zip(got, ref)),
        ms=graph_ms(lambda: rg.rme_assemble(recs, mask, CAPACITY)),
        call_ms=cuda_ms(lambda: rg.rme_assemble(recs, mask, CAPACITY)),
        plain_ms=cuda_ms(lambda: rg.assemble_plain(recs, mask, CAPACITY)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
        shape=f"(8, 2352, 85) f32 mask score >= {CONF} cap {CAPACITY}"))
    rows += [img2col_row(dev, gen), conv2d_row(dev, gen),
             resize_row(dev, gen), matmul_tm_row(espcn),
             xchain_commit_row(espcn), xchain_prologue_row(dev, gen)]
    rows += flash_rows(dev, gen)
    for r in rows:
        log(f"kernel {r['name']:17s} {r['shape']}: {r['ms']:.4f} ms device "
            f"({r['call_ms']:.4f} per call with host work; plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, library "
            f"{r['library_ms']}) max|err| {r['max_abs_err']}")
    return rows


def _sdpa(q, k, v, **kw):
    """One PyTorch call of the same attention (the yardstick only): SDPA
    on (B, H, S, D) views, the GQA grouping by ``enable_gqa``."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True, **kw)


def flash_rows(dev, gen) -> list[dict]:
    """flash_attention (#16) at the slice-5 prefill shape and flash_decode
    (#17) at its decode shape, bf16 with f32 accumulation, each within
    fp_bounds.attention_tol of its plain version, with its achieved rate
    and its ratio to SDPA's time in the same run; then the f32 prefill
    (the FMA kernel, off the LM's bf16 path) as the row
    flash_attention_f32."""
    from repro_torch.core.fp_bounds import attention_tol
    from repro_torch.kernels.flash_attention import flash_attention as fa

    B, S, H, KV, D = LM_BATCH, LM_PROMPT, 24, 8, 128
    T, length = LM_PROMPT + LM_GEN, LM_PROMPT + 1
    bf16 = torch.bfloat16
    flops = 4 * B * H * D * (S * S + S) // 2
    rows = []
    for dtype, name, peak in ((bf16, "flash_attention", BF16_FLOP_PER_S),
                              (torch.float32, "flash_attention_f32",
                               F32_FLOP_PER_S)):
        q, k, v = (torch.randn((B, S, n, D), generator=gen).to(dev, dtype)
                   for n in (H, KV, KV))
        got = fa.flash_attention(q, k, v, causal=True)
        ref = fa.attention_ref(q, k, v, causal=True)
        require_within(got, ref, attention_tol(q, k, v, causal=True), name)
        sdpa = _sdpa(q, k, v, is_causal=True)
        log(f"kernel {name}: SDPA vs the kernel "
            f"{max_abs_err(sdpa().transpose(1, 2), got)}")
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        iters = 10 if dtype == bf16 else 3
        ms = graph_ms(lambda: fa.flash_attention(q, k, v), iters=iters)
        library_ms = graph_ms(sdpa, iters=iters)
        log(f"kernel {name}: {flops / 1e9:.2f} GFLOP in {ms:.4f} ms = "
            f"{flops / ms / 1e9:.1f} TFLOP/s (peak {peak / 1e12:.0f}, bound "
            f"{flops / peak * 1e3:.4f} ms); SDPA {library_ms:.4f} ms, "
            f"kernel / SDPA {ms / library_ms:.2f}")
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:79",
            max_abs_err=max_abs_err(got, ref), ms=ms,
            call_ms=cuda_ms(lambda: fa.flash_attention(q, k, v),
                            iters=iters),
            plain_ms=cuda_ms(lambda: fa.attention_ref(q, k, v), iters=3,
                             warmup=1),
            bound_ms=max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by=("operations" if flops / peak > nbytes / HBM_BYTES_PER_S
                      else "bytes"),
            library_ms=library_ms,
            shape=f"causal q ({B}, {S}, {H}, {D}) k/v ({B}, {S}, {KV}, {D}) "
                  f"{str(dtype).removeprefix('torch.')}"))
        del q, k, v, got, ref

    q = torch.randn((B, 1, H, D), generator=gen).to(dev, bf16)
    k, v = (torch.randn((B, T, KV, D), generator=gen).to(dev, bf16)
            for _ in range(2))
    n = torch.tensor([length], dtype=torch.int32, device=dev)
    got = fa.flash_decode(q, k, v, n)
    ref = fa.decode_ref(q, k, v, length)
    require_within(got, ref, attention_tol(q, k, v, causal=False,
                                           length=length), "flash_decode")
    sdpa = _sdpa(q, k[:, :length], v[:, :length])
    log(f"kernel flash_decode: SDPA vs the kernel "
        f"{max_abs_err(sdpa().transpose(1, 2), got)}")
    nbytes = (2 * B * length * KV * D + 2 * q.numel()) * 2
    flops = 4 * B * H * D * length
    ms = graph_ms(lambda: fa.flash_decode(q, k, v, n))
    library_ms = graph_ms(sdpa)
    split_rows, splits = fa.decode_plan(B, T, H, KV, dev, bf16)
    log(f"kernel flash_decode: {nbytes / 1e6:.2f} MB in {ms:.4f} ms = "
        f"{nbytes / ms / 1e9:.3f} TB/s (peak 3.35, bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; {splits} splits of "
        f"{split_rows} rows); SDPA {library_ms:.4f} ms, kernel / SDPA "
        f"{ms / library_ms:.2f}")
    rows.append(dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:144",
        max_abs_err=max_abs_err(got, ref), ms=ms,
        call_ms=cuda_ms(lambda: fa.flash_decode(q, k, v, n)),
        plain_ms=cuda_ms(lambda: fa.decode_ref(q, k, v, n)),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
        * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= flops / BF16_FLOP_PER_S else "operations"),
        library_ms=library_ms,
        shape=f"q ({B}, 1, {H}, {D}) vs cache ({B}, {T}, {KV}, {D}) bf16 "
              f"at length {length}"))
    return rows


def _teacher_forced(cfg, params, prompts, toks, attention: str):
    """Prefill, then the decode steps fed ``toks`` (the kernel path's
    choices): the last-position logits of every step, (gen, B, V) f32."""
    from repro_torch.models.transformer import init_caches
    from repro_torch.runtime.step import make_decode_step, make_prefill_step
    B, P = prompts.shape
    caches = init_caches(cfg, B, P + toks.shape[1], dtype=cfg.dtype,
                         device=prompts.device)
    lg, caches, _ = make_prefill_step(cfg, attention=attention)(
        params, prompts, caches, None)
    out = [lg[:, -1].float()]
    decode = make_decode_step(cfg, attention=attention)
    for i, t in enumerate(range(P, P + toks.shape[1] - 1)):
        _, lg, caches, _ = decode(params, toks[:, i:i + 1], caches, None, t)
        out.append(lg[:, -1].float())
    return torch.stack(out)


def lm_check(cfg, toks, stats, dev) -> None:
    """The served tokens against the plain attention on the same weights
    and the same teacher-forced tokens: the kernel path's logits no further
    from the f32 plain run than 2x the bf16 plain run's distance plus
    LM_FLOOR_ULPS bf16 ulps, at the prefill's last position and at every
    decode step."""
    import dataclasses
    from repro_torch.launch.serve import lm_inputs

    B, G = LM_BATCH, LM_GEN
    if toks.shape != (B, G) or toks.dtype != torch.int32:
        raise AssertionError(f"served tokens {tuple(toks.shape)} {toks.dtype}")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError("served tokens outside the vocabulary")
    params, prompts = lm_inputs(cfg, batch=B, prompt_len=LM_PROMPT,
                                seed=SEED, device=dev)
    kern = _teacher_forced(cfg, params, prompts, toks, "flash")
    plain = _teacher_forced(cfg, params, prompts, toks, "plain")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float()

    params = f32(params)  # the bf16 weights, exactly, in f32
    ref = _teacher_forced(cfg32, params, prompts, toks, "plain")
    del params
    for what, lg in (("kernel", kern), ("plain bf16", plain),
                     ("plain f32", ref)):
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"LM {what}: non-finite logits")
    d_kern = (kern - ref).abs().flatten(1).amax(dim=1)
    d_plain = (plain - ref).abs().flatten(1).amax(dim=1)
    floor = LM_FLOOR_ULPS * bf16_ulp(ref.abs().flatten(1).amax(dim=1)).float()
    worst = float((d_kern / (2 * d_plain + floor)).max())
    # logits of step i choose token i: the prefill's token 0, step i's i
    replay = float((kern.argmax(-1).T == toks).float().mean())
    agree = float((plain.argmax(-1).T == toks).float().mean())
    log(f"model {cfg.name} {B}x{LM_PROMPT}+{G}: logits vs the f32 plain run,"
        f" max over steps: kernel {float(d_kern.max()):.4g}, plain bf16 "
        f"{float(d_plain.max()):.4g}, floor {float(floor.max()):.4g}; worst "
        f"step kernel / (2 plain + floor) = {worst:.3f} (must be <= 1); "
        f"greedy tokens: the kernel replay picks the served token on "
        f"{replay:.4f}, the plain bf16 path on {agree:.4f} (not gated)")
    if worst > 1:
        raise AssertionError(f"LM kernel path too far from the f32 plain "
                             f"run: {worst:.3f} of its bound")
    P = LM_PROMPT
    log(f"model {cfg.name}: prefill {stats['prefill_s'] * 1e3:.3f} ms, "
        f"decode {stats['decode_s'] * 1e3 / (G - 1):.4f} ms/step, "
        f"{stats['tokens_per_s']:.1f} tokens/s (batch {B}, prompt {P})")


def operator_phase(dev, gen) -> None:
    from repro_torch.core import affine as af
    from repro_torch.core.executor import TMExecutor
    from repro_torch.core.instr import (EwOp, RMEConfig, TMInstr, TMOpcode,
                                        TMProgram)

    def single(m, **kw):
        n_src = 2 if kw.get("ew") is not None else 1
        srcs = ("x", "r")[:n_src]
        return TMProgram([TMInstr(TMOpcode.COARSE, srcs, "y", map_=m, **kw)],
                         srcs, ("y",))

    route = TMProgram([TMInstr(TMOpcode.COARSE, ("x", "r"), "y",
                               maps=tuple(af.route_maps([TABLE3, TABLE3])))],
                      ("x", "r"), ("y",))
    bbox = TMProgram([TMInstr(TMOpcode.FINE_EVALUATE, ("x",), "y",
                              rme=RMEConfig(scheme="evaluate", threshold=CONF,
                                            cmp="ge", score_index=4,
                                            capacity=CAPACITY))],
                     ("x",), ("y",))
    ops = [
        ("transpose", single(af.transpose_map(TABLE3)), TABLE3, "cuda.block"),
        ("rot90", single(af.rot90_map(TABLE3)), TABLE3, "cuda.block"),
        ("pixelshuffle", single(af.pixel_shuffle_map(TABLE3, 2)), TABLE3,
         "cuda.gather"),
        ("pixelunshuffle", single(af.pixel_unshuffle_map(TABLE3, 2)), TABLE3,
         "cuda.gather"),
        ("upsample", single(af.upsample_map(TABLE3, 2)), TABLE3,
         "cuda.gather"),
        ("split", single(af.split_map(TABLE3, 2, 1)), TABLE3, "cuda.block"),
        ("route", route, TABLE3, "cuda.route"),
        ("add", single(af.identity_map(TABLE3), ew=EwOp.ADD), TABLE3,
         "cuda.block+ew"),
        ("rearrange", single(af.rearrange_map((448, 448, 3), 1, 16)),
         (448, 448, 3), "cuda.gather"),
        ("bboxcal", bbox, (448 * 448 // 64, 85), "cuda.rme.evaluate"),
    ]
    # one int8 and one bf16 case each for block, gather and evaluate
    for dtype in (torch.int8, torch.bfloat16):
        ops += [(f"{n}[{dtype}]", p, s, path, dtype)
                for n, p, s, path in (ops[0], ops[4], ops[9])]
    cuda = TMExecutor(backend="cuda", device=dev)
    reference = TMExecutor(backend="reference", device=dev)
    for op in ops:
        name, prog, shape, path = op[:4]
        dtype = op[4] if len(op) > 4 else torch.float32
        if name.startswith("bboxcal"):
            base = torch.randn(shape, generator=gen)
        else:
            base = torch.rand(shape, generator=gen) * 200 - 100
        bufs = {s: base.to(dtype).to(dev) for s in prog.inputs}
        got, low, _ = cuda.run(prog, bufs)
        ref, _, _ = reference.run(prog, bufs)
        require_equal(got["y"], ref["y"], f"operator {name}")
        if low.paths() != [path]:
            raise AssertionError(f"operator {name}: lowered to "
                                 f"{low.paths()}, expected [{path!r}]")
        t_cuda = wall_ms(lambda: cuda.run(prog, bufs), iters=5)
        t_ref = wall_ms(lambda: reference.run(prog, bufs), iters=2)
        log(f"operator {name:22s} {path:18s} bit-exact; cuda executor "
            f"{t_cuda:.3f} ms, reference engine {t_ref:.3f} ms (wall)")


def chain_operator_phase(dev, gen) -> None:
    """Slice 2's operators: forwarding chains and runtime-mask assemble
    through the chaining cuda executor against the reference engine,
    bit-exact, each with its expected lowering."""
    from repro_torch.core import affine as af
    from repro_torch.core.executor import TMExecutor
    from repro_torch.core.instr import (EwOp, RMEConfig, TMInstr, TMOpcode,
                                        TMProgram)

    def coarse(srcs, dst, **kw):
        return TMInstr(TMOpcode.COARSE, srcs, dst, **kw)

    def chain3(shape):
        h, w, c = shape
        return TMProgram(
            [coarse(("x",), "a", map_=af.transpose_map(shape)),
             coarse(("a",), "b", map_=af.split_map((w, h, c), 2, 1)),
             coarse(("b",), "y", map_=af.transpose_map((w, h, c // 2)))],
            ("x",), ("y",)), {"x": shape}

    def superres(shape, s=2):
        # the EDSR x2 tail as tests/harness.py builds it: pixel shuffle +
        # Add skip, crop 1, pad 1
        h, w, c = shape
        hs, ws, cs = h * s, w * s, c // (s * s)
        return TMProgram(
            [coarse(("x", "skip"), "a", map_=af.pixel_shuffle_map(shape, s),
                    ew=EwOp.ADD),
             coarse(("a",), "b", map_=af.pad_map((hs, ws, cs), (-1, -1, 0),
                                                 (-1, -1, 0))),
             coarse(("b",), "y", map_=af.pad_map((hs - 2, ws - 2, cs),
                                                 (1, 1, 0), (1, 1, 0)))],
            ("x", "skip"), ("y",)), {"x": shape, "skip": (hs, ws, cs)}

    def chain_route(shape):
        h, w, c = shape
        up = af.upsample_map(shape, 2)
        maps = tuple(af.route_maps([up.out_shape, up.out_shape]))
        return TMProgram(
            [coarse(("u",), "v", map_=up),
             coarse(("v", "skip"), "y", maps=maps)],
            ("u", "skip"), ("y",)), {"u": shape, "skip": up.out_shape}

    def detect(shape):
        return (detect_program(shape, CONF, CAPACITY), {"p": shape})

    def assemble(shape):
        return TMProgram(
            [TMInstr(TMOpcode.FINE_ASSEMBLE, ("x", "mask"), "y",
                     rme=RMEConfig(scheme="assemble", capacity=CAPACITY))],
            ("x", "mask"), ("y",)), {"x": shape, "mask": shape[:-1]}

    head2 = (28, 28, 3 * (5 + N_CLASSES))
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    # (name, (program, core input shapes), batch, dtype, expected paths).
    # The JAX package declines a chain whose inputs and pullback constants
    # exceed CHAIN_VMEM_BUDGET (128 MiB), and so does the port: in f32 the
    # Table III transpose -> split -> transpose fuses its first two links
    # only, and upsample -> Route at 448x448x128 does not fuse at all; the
    # Route chain is also run at 224x224x128, where it does.
    ops = [
        ("chain3", chain3(TABLE3), (), f32, ["cuda.chain", "cuda.block"]),
        ("chain3", chain3(TABLE3), (), bf16, ["cuda.chain"]),
        ("chain_superres", superres((224, 224, 12)), (IMG[0],), f32,
         ["cuda.chain"]),
        ("chain_route", chain_route((112, 112, 64)), (), f32,
         ["cuda.chain+route"]),
        ("chain_route", chain_route((224, 224, 64)), (), f32,
         ["cuda.gather", "cuda.route"]),
        ("detect_tail", detect(head2), (IMG[0],), f32,
         ["cuda.chain+rme.evaluate"]),
        ("assemble", assemble((2352, 85)), (IMG[0],), f32,
         ["cuda.rme.assemble"]),
    ]
    for dtype in (i8, bf16):
        ops += [(n, p, b, dtype, path) for n, p, b, d, path in ops
                if d == f32 and n in ("chain_superres", "detect_tail",
                                      "assemble")]
    chained = TMExecutor(backend="cuda", device=dev, fuse_chains=True)
    unfused = TMExecutor(backend="cuda", device=dev)
    reference = TMExecutor(backend="reference", device=dev)
    for name, (prog, shapes), batch, dtype, path in ops:
        bufs = {}
        for k, core in shapes.items():
            shape = batch + tuple(core)
            if k == "mask":
                bufs[k] = (torch.rand(shape, generator=gen) < 0.3).to(dev)
            elif k == "p":
                bufs[k] = torch.randn(shape, generator=gen).to(dtype).to(dev)
            else:
                bufs[k] = (torch.rand(shape, generator=gen) * 200 - 100
                           ).to(dtype).to(dev)
        bd = len(batch)
        got, low, _ = chained.run(prog, bufs, batch_dims=bd)
        ref, _, _ = reference.run(prog, bufs, batch_dims=bd)
        require_equal(got["y"] if "y" in got else got["boxes"],
                      ref["y"] if "y" in ref else ref["boxes"],
                      f"operator {name}[{dtype}]")
        if low.paths() != path:
            raise AssertionError(f"operator {name}[{dtype}]: lowered to "
                                 f"{low.paths()}, expected {path}")
        t_chn = wall_ms(lambda: chained.run(prog, bufs, batch_dims=bd))
        t_unf = wall_ms(lambda: unfused.run(prog, bufs, batch_dims=bd))
        label = f"{name}{tuple(batch + tuple(next(iter(shapes.values()))))}"
        log(f"operator {label}[{str(dtype)[6:]}] {'+'.join(path)} bit-exact, "
            f"{low.launch_count()} launch(es); chaining executor "
            f"{t_chn:.3f} ms, per-instruction {t_unf:.3f} ms (wall)")


def img2col_resize_phase(dev, gen, fmap=TABLE3, small=(448, 448, 3),
                         out_hw=(224, 224)) -> None:
    """Slice 3's operators: the paper's Table III Img2col and Resize as
    single-instruction programs through the cuda executor against the
    reference engine, each with its expected lowering.  Img2col bit-exact
    (3x3 stride 1 in every dtype, 2x2 stride 2, and 3x3 pad 1 under a map
    whose fill is 7); Resize f32 within 1e-5 of inputs in [0, 1), bf16
    within one bf16 ulp of the output."""
    from repro_torch.core import affine as af
    from repro_torch.core.executor import TMExecutor
    from repro_torch.core.instr import TMInstr, TMOpcode, TMProgram

    def img2col(shape, k, stride, pad, fill=0.0):
        m = af.img2col_map(shape, k, k, stride, pad, fill=fill)
        meta = {"img2col": {"kh": k, "kw": k, "stride": stride, "pad": pad}}
        return TMProgram([TMInstr(TMOpcode.COARSE, ("x",), "y", map_=m,
                                  meta=meta)], ("x",), ("y",))

    def resize(h, w):
        return TMProgram([TMInstr(TMOpcode.RESIZE, ("x",), "y",
                                  meta={"out_h": h, "out_w": w})],
                         ("x",), ("y",))

    f32, bf16 = torch.float32, torch.bfloat16
    ops = [(f"img2col 3x3 s1 {fmap}", img2col(fmap, 3, 1, 0), fmap, d,
            "cuda.img2col") for d in (torch.int8, torch.int32, bf16, f32)]
    ops += [(f"img2col 2x2 s2 {fmap}", img2col(fmap, 2, 2, 0), fmap, f32,
             "cuda.img2col"),
            (f"img2col 3x3 s1 pad 1 fill 7 {fmap}", img2col(fmap, 3, 1, 1, 7.0),
             fmap, f32, "cuda.img2col")]
    ops += [(f"resize {shape} -> {out_hw}", resize(*out_hw), shape, d,
             "cuda.resize") for shape in (small, fmap) for d in (f32, bf16)]
    cuda = TMExecutor(backend="cuda", device=dev)
    reference = TMExecutor(backend="reference", device=dev)
    for name, prog, shape, dtype, path in ops:
        base = torch.rand(shape, generator=gen)
        if name.startswith("img2col"):
            base = base * 200 - 100
        bufs = {"x": base.to(dtype).to(dev)}
        got, low, _ = cuda.run(prog, bufs)
        ref, _, _ = reference.run(prog, bufs)
        if name.startswith("img2col"):
            require_equal(got["y"], ref["y"], f"operator {name}[{dtype}]")
            if "fill 7" in name and int((got["y"] == 7).sum()) == 0:
                raise AssertionError("img2col fill 7: no padded tap")
        else:
            tol = 1e-5 if dtype == f32 else bf16_ulp(ref["y"])
            require_within(got["y"], ref["y"], tol, f"operator {name}[{dtype}]")
        if low.paths() != [path]:
            raise AssertionError(f"operator {name}: lowered to {low.paths()}, "
                                 f"expected [{path!r}]")
        err = max_abs_err(got["y"], ref["y"])
        del got, ref
        t_cuda = wall_ms(lambda: cuda.run(prog, bufs), iters=3)
        t_ref = wall_ms(lambda: reference.run(prog, bufs), iters=2)
        log(f"operator {name}[{str(dtype)[6:]}] {path} max |err| {err}; "
            f"cuda executor {t_cuda:.3f} ms, reference engine {t_ref:.3f} ms "
            f"(wall)")


def edsr_setup(dev, gen, img_shape=EDSR_IMG) -> dict:
    """EDSR x2 at the JAX package's init_edsr defaults (feats 64, 8
    blocks) with random weights, its input and the eager output (cuDNN
    convs, TF32 off)."""
    from repro_torch.models import cnn
    model = cnn.init_edsr(gen, device=dev)
    img = torch.rand(img_shape, generator=gen).to(dev)
    return dict(model=model, img=img, eager=model(img))


def edsr_check(e: dict, ex) -> int:
    """The partitioned EDSR forward against the eager model within
    EDSR_RTOL of the output's largest magnitude; returns the conv kernel
    launches of that one forward (the wrapper's own count)."""
    from repro_torch.kernels.img2col.img2col import conv2d
    before = conv2d.launches
    got, paths = edsr_partitioned_forward(e["model"], e["img"], ex)
    n_convs = conv2d.launches - before
    eager = e["eager"]
    scale = float(eager.abs().max())
    require_within(got, eager, EDSR_RTOL * scale, "EDSR partitioned vs eager")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("EDSR: non-finite values")
    if paths != ["cuda.gather"]:
        raise AssertionError(f"EDSR tail lowered to {paths}")
    log(f"model EDSR x2 {tuple(e['img'].shape)} -> {tuple(got.shape)} f32: "
        f"partitioned vs eager max |err| {max_abs_err(got, eager)} (max "
        f"|out| {scale:.4g}, tolerance {EDSR_RTOL} of it); {n_convs} "
        f"conv2d kernel launches per forward, tail {paths}")
    return n_convs


def edsr_timings(e: dict, ex) -> None:
    """Wall ms per forward, eager (cuDNN) and partitioned (conv2d_call),
    in turns (a, b, b, a), and the partitioned forward's device ms."""
    model, img = e["model"], e["img"]
    runs = {"eager": lambda: model(img),
            "partitioned": lambda: edsr_partitioned_forward(model, img, ex)}
    walls: dict[str, list[float]] = {k: [] for k in runs}
    for k in ("eager", "partitioned", "partitioned", "eager"):
        walls[k].append(wall_ms(runs[k], iters=3))
    dev_ms = {k: cuda_ms(fn, iters=3, warmup=1) for k, fn in runs.items()}
    log("model EDSR x2 wall ms/forward: " + "; ".join(
        f"{k} {min(v):.3f} (runs {', '.join(f'{t:.3f}' for t in v)}), "
        f"device {dev_ms[k]:.3f}" for k, v in walls.items()))


def yolo_setup(dev, gen) -> dict:
    """YOLOv3-Tiny with random weights, its input and the eager outputs
    (heads and packed boxes, TM stages on the reference engine), plus a
    detect-tail threshold the data crosses (head 2's 90th-percentile
    confidence): random weights may leave every confidence below CONF."""
    from repro_torch.models import cnn

    model = cnn.init_yolov3_tiny(gen, n_classes=N_CLASSES, device=dev)
    img = torch.rand(IMG, generator=gen).to(dev)
    eager = eager_forward(model, img)
    d = 5 + N_CLASSES
    conf2 = float(eager[1].reshape(-1, d)[:, 4].quantile(0.9))
    return dict(model=model, img=img, eager=eager, conf2=conf2)


def yolo_check(y: dict, ex, expect: list[str], name: str,
               against: tuple | None = None) -> tuple:
    """The partitioned forward through ``ex``: heads and packed boxes
    bit-exact against the eager model (and ``against``, another
    partitioned forward's outputs), the TM stages lowered to ``expect``,
    and the detect tails also at ``y['conf2']``.  Returns the outputs."""
    from repro_torch.models import cnn

    p1, p2, b1, b2, paths, launches = partitioned_forward(y["model"],
                                                          y["img"], ex)
    outs = (p1, p2, b1, b2)
    whats = ("head 1", "head 2", "boxes head 1", "boxes head 2")
    for i, (got, what) in enumerate(zip(outs, whats)):
        require_equal(got, y["eager"][i], f"YOLOv3-Tiny {name} {what}")
        if against is not None:
            require_equal(got, against[i], f"YOLOv3-Tiny {name} {what} vs "
                                           f"the unfused forward")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"YOLOv3-Tiny {what}: non-finite values")
    if paths != expect:
        raise AssertionError(f"YOLOv3-Tiny {name} TM stages lowered to "
                             f"{paths}")
    kept = [int((b[..., 4] >= CONF).sum()) for b in (b1, b2)]
    log(f"model YOLOv3-Tiny {IMG} {N_CLASSES} classes f32, {name}: heads "
        f"{tuple(p1.shape)} {tuple(p2.shape)}, boxes {tuple(b1.shape)} "
        f"{tuple(b2.shape)} bit-exact ({kept[0]} + {kept[1]} packed); "
        f"TM stages {paths}, {launches} TM launches per forward")
    conf2 = y["conf2"]
    for i, pred in enumerate((p1, p2)):
        prog = detect_program(tuple(pred.shape[1:]), conf2, CAPACITY)
        got, low, _ = ex.run(prog, {"p": pred}, batch_dims=1)
        ref = cnn.detect_tail_raw(pred, conf2, CAPACITY)
        require_equal(got["boxes"], ref, f"YOLOv3-Tiny {name} boxes head "
                                         f"{i + 1} at conf {conf2}")
        log(f"model {name} detect tail {i + 1} at conf {conf2:.6g} "
            f"({'+'.join(low.paths())}): bit-exact, "
            f"{int((got['boxes'][..., 4] >= conf2).sum())} packed")
    return outs, launches


def yolo_timings(y: dict, executors: dict) -> None:
    """Wall ms per forward of the eager model and of the partitioned
    forward through each executor, in turns (a, b, b, a), and the TM share
    of one partitioned forward's device time."""
    model, img = y["model"], y["img"]
    t_eager = wall_ms(lambda: eager_forward(model, img))
    order = list(executors) + list(executors)[::-1]
    walls: dict[str, list[float]] = {k: [] for k in executors}
    for k in order:
        walls[k].append(wall_ms(
            lambda: partitioned_forward(model, img, executors[k])))
    parts = []
    for k, ex in executors.items():
        events: list = []
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        partitioned_forward(model, img, ex, tm_events=events)
        end.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(end)
        tm = sum(a.elapsed_time(b) for a, b in events)
        parts.append(f"{k} {min(walls[k]):.3f} (runs "
                     f"{', '.join(f'{t:.3f}' for t in walls[k])}), TM "
                     f"{tm:.3f} of {total:.3f} ms device = share "
                     f"{tm / total:.3f}")
    log(f"model wall ms/forward: eager (engine TM) {t_eager:.3f}; "
        + "; ".join(parts))


def espcn_compiled_check(e: dict) -> None:
    """ESPCN x3 compiled without and with cross_engine, cuda backend: the
    split program bit-exact against the eager model (the same cuDNN convs,
    the PixelShuffle gather), the fused one with ONE cuda.xchain.commit
    within the last conv's rounding bound; wall ms of the three and the
    device ms of the fused phase against the split conv + PixelShuffle."""
    from repro_torch.compiler import tm_compile
    from repro_torch.compiler.ir import eval_tpu_node
    from repro_torch.core.fp_bounds import gamma

    model, img, eager = e["model"], e["img"], e["eager"]
    split = tm_compile(model, img)
    fused = tm_compile(model, img, cross_engine=True)
    if (split.phase_kinds, fused.phase_kinds) != ("tm", "tf"):
        raise AssertionError(f"ESPCN phases {split.phase_kinds} / "
                             f"{fused.phase_kinds}, expected tm / tf")
    out_s, reps_s = split.run(img, backend="cuda")
    out_f, reps_f = fused.run(img, backend="cuda")
    recs = [r for rep in reps_f for r in rep.records]
    if [(r.path, r.launches, r.instrs) for r in recs] != [
            ("cuda.xchain.commit", 1, 2)]:
        raise AssertionError(f"ESPCN fused phase lowered to "
                             f"{[(r.path, r.reason) for r in recs]}")
    require_equal(out_s, eager, "ESPCN split vs eager")
    tol = 2 * gamma(3 * 3 * 32) * _shuffle(_conv_mag(e["h"], model.c3), 3)
    require_within(out_f, eager, tol, "ESPCN fused vs eager")
    if not bool(torch.isfinite(out_f).all()):
        raise AssertionError("ESPCN: non-finite values")
    e["compiled"] = out_f
    walls = {k: wall_ms(fn, iters=5) for k, fn in (
        ("eager", lambda: model(img)),
        ("split", lambda: split.run(img, backend="cuda")),
        ("fused", lambda: fused.run(img, backend="cuda")))}
    # the crossing alone: the fused phase against the split path's last
    # conv and PixelShuffle phase, from the same environment
    env_f = fused.bind_inputs(img)
    t_ph, f_ph = fused.partition_report.phases
    fused.run_phase(t_ph, env_f)
    env_s = split.bind_inputs(img)
    s_t, s_m = split.partition_report.phases
    for i in s_t.node_indices[:-1]:
        eval_tpu_node(split.graph.nodes[i], env_s)
    conv3 = split.graph.nodes[s_t.node_indices[-1]]

    def split_tail():
        eval_tpu_node(conv3, env_s)
        split.run_phase(s_m, env_s, backend="cuda")

    dev_f = cuda_ms(lambda: fused.run_phase(f_ph, env_f, backend="cuda"),
                    iters=10)
    dev_s = cuda_ms(split_tail, iters=10)
    log(f"model ESPCN x3 {tuple(img.shape)} -> {tuple(out_f.shape)} f32: "
        f"split bit-exact vs eager; fused ({recs[0].path}, launches "
        f"{recs[0].launches}) max |err| {max_abs_err(out_f, eager)} "
        f"(bound max {float(tol.max()):.3g}); wall ms/frame "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
        + f"; device ms of the crossing: fused phase {dev_f:.4f}, split "
        f"conv + PixelShuffle {dev_s:.4f}")


def espcn_im2col_check(e: dict) -> None:
    """ESPCN's last layer in im2col form through matmul_tm (#13): the
    (360, 640, 32) map's 3x3 patches by the (288, 27) weights, stored
    through the pixel-shuffle epilogue — the same function as the
    compiled program's last layer, within its rounding bound."""
    from repro_torch.core.fp_bounds import gamma
    from repro_torch.kernels.img2col.ops import img2col_call
    from repro_torch.kernels.matmul_tm.ops import matmul_pixel_shuffle_call

    h, c3 = e["h"], e["model"].c3
    patches = img2col_call(h[0], kh=3, kw=3, stride=1, pad=1)
    out = matmul_pixel_shuffle_call(patches, c3.reshape(-1, 27).contiguous(),
                                    H=h.shape[1], W=h.shape[2], C=3, s=3)
    tol = 2 * gamma(288) * _shuffle(_conv_mag(h, c3), 3)[0]
    require_within(out, e["compiled"][0], tol,
                   "matmul_tm im2col vs the compiled ESPCN")
    log(f"model ESPCN last layer as img2col {tuple(patches.shape)} + "
        f"matmul_pixel_shuffle_call: max |err| "
        f"{max_abs_err(out, e['compiled'][0])} against the compiled output")


def yolo_compiled_check(y: dict, chained) -> None:
    """YOLOv3-Tiny compiled with cross_engine=True, run with fuse_chains:
    phases ftf, the Rearrange crossing declined (split path, its reason),
    the neck realized as cuda.xchain.prologue; head 1 bit-exact against
    the eager model and the hand-partitioned chained forward, head 2
    within head 2's rounding bound (its 1x1 conv summed by the kernel)."""
    from repro_torch.compiler import tm_compile
    from repro_torch.core import tm_ops
    from repro_torch.core.fp_bounds import gamma

    model, img = y["model"], y["img"]
    yc = tm_compile(model, img, cross_engine=True)
    if yc.phase_kinds != "ftf":
        raise AssertionError(f"YOLOv3-Tiny phases {yc.phase_kinds}")
    (p1, p2), reps = yc.run(img, backend="cuda", fuse_chains=True)
    recs = [r for rep in reps for r in rep.records]
    paths = [r.path for r in recs]
    # the declined crossing runs its TM run, then its op (tm_to_compute)
    if paths != ["cuda.gather", "torch.conv2d_nhwc", "cuda.xchain.prologue"]:
        raise AssertionError(f"YOLOv3-Tiny compiled lowered to {paths}")
    decline = recs[1].reason
    if "327.6 MB over the 128 MiB budget" not in decline:
        raise AssertionError(f"rearrange decline: {decline!r}")
    part = partitioned_forward(model, img, chained)
    require_equal(p1, y["eager"][0], "YOLOv3-Tiny compiled head 1 vs eager")
    require_equal(p1, part[0], "YOLOv3-Tiny compiled head 1 vs partitioned")
    r, skip = model.trunk(tm_ops.rearrange(img, 1, 16))
    cat = tm_ops.route([tm_ops.upsample(model.neck_in(r), 2), skip])
    tol = 2 * gamma(256) * _conv_mag(cat, model.head2_w)
    for ref, what in ((y["eager"][1], "eager"), (part[1], "partitioned")):
        require_within(p2, ref, tol, f"YOLOv3-Tiny compiled head 2 vs {what}")
    if not (torch.isfinite(p1).all() and torch.isfinite(p2).all()):
        raise AssertionError("YOLOv3-Tiny compiled: non-finite values")
    tm_launches = sum(r.launches for r in recs if r.path.startswith("cuda."))
    walls = {k: wall_ms(fn) for k, fn in (
        ("eager", lambda: model(img)),
        ("partitioned chained (with detect tails)",
         lambda: partitioned_forward(model, img, chained)),
        ("compiled", lambda: yc.run(img, backend="cuda", fuse_chains=True)))}
    log(f"model YOLOv3-Tiny {IMG} compiled cross_engine: phases "
        f"{yc.phase_kinds}, records {paths}; decline: {decline}; "
        f"head 2 max |err| {max_abs_err(p2, y['eager'][1])} vs eager (bound "
        f"max {float(tol.max()):.3g}); {tm_launches} TM-engine launches per "
        f"forward (the prologue carries head 2's conv); wall ms/forward "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))


# ---------------------------------------------------------------------------
# slice 11: the stream runtime and TMServer
# ---------------------------------------------------------------------------

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def no_vmap_fallback():
    """A context in which ``torch.func.vmap`` raises where an op has no
    vmap rule, in place of looping over the samples (PyTorch's
    BatchedFallback): the served programs must reach every op batched."""
    ft = torch._C._functorch
    prev = ft._is_vmap_fallback_enabled()
    ft._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        ft._set_vmap_fallback_enabled(prev)


def two_stream_check(dev, img_shape=IMG, n_classes=N_CLASSES,
                     espcn_img=ESPCN_IMG, inflight=4) -> dict:
    """YOLOv3-Tiny compiled with ``cross_engine`` (as slice 4) and without,
    each run ``inflight`` times at once through ``run(runtime=...)`` /
    ``run_async`` on a StreamRuntime whose engines are two CUDA streams:
    every output bit-exact against ``run()`` of the same program on this
    thread; the measured overlap beside ``predict_overlap``.  Then the two
    cooperative launches (the ESPCN commit, the YOLO neck prologue) queued
    on the tmu stream while the tpu stream runs the eager YOLO's convs:
    both must finish, bit-exact, within a timeout (no deadlock)."""
    from repro_torch.compiler import tm_compile
    from repro_torch.models import cnn
    from repro_torch.runtime.streams import (StreamRuntime,
                                             overlap_from_events)
    from repro_torch.serving.server import predict_overlap

    gen = torch.Generator().manual_seed(SEED)
    model = cnn.init_yolov3_tiny(gen, n_classes=n_classes, device=dev)
    imgs = [torch.rand(img_shape, generator=gen).to(dev)
            for _ in range(inflight)]
    out = {}
    for xe in (True, False):
        prog = tm_compile(model, imgs[0], cross_engine=xe)
        want = [prog.run(im, backend="cuda", fuse_chains=True)[0]
                for im in imgs]
        got, reps = prog.run(imgs[0], backend="cuda", fuse_chains=True,
                             runtime=StreamRuntime(device=dev))
        for a, b in zip(got, want[0]):
            require_equal(a, b, f"YOLOv3-Tiny run(runtime=) xe={xe}")
        _sync(dev)
        with StreamRuntime(device=dev) as rt:
            envs = [prog.bind_inputs(im) for im in imgs]
            t0 = time.perf_counter()
            evs = [ev for i, env in enumerate(envs)
                   for ev in prog.run_async(env, runtime=rt, backend="cuda",
                                            fuse_chains=True, label=f"{i}:")]
            for ev in evs:
                ev.wait(timeout=300)
            wall = time.perf_counter() - t0
            meas = overlap_from_events(rt.timeline())
        for i, (env, w) in enumerate(zip(envs, want)):
            for a, b in zip(prog.outputs_from(env), w):
                require_equal(a, b, f"YOLOv3-Tiny run_async #{i} xe={xe}")
        pred = predict_overlap(prog, fuse_chains=True)
        paths = [r.path for rep in reps for r in rep.records]
        log(f"two streams, YOLOv3-Tiny {tuple(img_shape)} cross_engine={xe}:"
            f" phases {prog.phase_kinds} on engines "
            f"{[p.engine for p in prog.partition_report.phases]}, records "
            f"{paths}; {inflight} in flight {wall * 1e3:.3f} ms wall, "
            f"measured overlap {meas['overlap_ratio']:.4f} (both busy "
            f"{meas['both_busy_s'] * 1e3:.3f} ms of "
            f"{meas['any_busy_s'] * 1e3:.3f}; exclusive "
            f"{meas['exclusive_s'] * 1e3:.3f} ms; busy "
            + ", ".join(f"{k} {v * 1e3:.3f} ms"
                        for k, v in meas["engine_busy_s"].items())
            + f") vs predicted {pred:.4f}; bit-exact against run()")
        out[xe] = dict(measured=meas["overlap_ratio"], predicted=pred)

    # cooperative launches on the tmu stream beside convs on the tpu stream
    yc = tm_compile(model, imgs[0], cross_engine=True)
    es = cnn.init_espcn(torch.Generator().manual_seed(SEED), s=3,
                        device=dev)
    frame = torch.rand(espcn_img, generator=gen).to(dev)
    ec = tm_compile(es, frame, cross_engine=True)

    def last_phase(prog, x):
        """The env before the program's last (fused) phase, and that
        phase's output run on this thread."""
        *head, ph = prog.partition_report.phases
        env = prog.bind_inputs(x)
        for p in head:
            prog.run_phase(p, env, backend="cuda", fuse_chains=True)
        ref = dict(env)
        prog.run_phase(ph, ref, backend="cuda", fuse_chains=True)
        return env, ph, [ref[n] for n in ph.writes]

    runs = [last_phase(ec, frame), last_phase(yc, imgs[0])]
    for prog, (_, ph, _) in zip((ec, yc), runs):
        if ph.kind != "fused":
            raise AssertionError(f"last phase of {prog.phase_kinds} is "
                                 f"{ph.kind}, not fused")
    _sync(dev)
    with StreamRuntime(device=dev) as rt:
        convs = rt.submit("tpu", lambda: [model(im) for im in imgs * 2],
                          label="eager convs")
        coops = [rt.submit("tmu", (lambda p=p, ph=ph, env=env:
                                   p.run_phase(ph, env, backend="cuda")),
                           label=f"coop {ph.index}", exclusive=True)
                 for p, (env, ph, _) in zip((ec, yc), runs)]
        reps = [ev.wait(timeout=300) for ev in coops]
        convs.wait(timeout=300)
        meas = overlap_from_events(rt.timeline())
    for (env, ph, ref), rep, what in zip(runs, reps, ("commit", "prologue")):
        if [r.path for r in rep.records] != [f"cuda.xchain.{what}"]:
            raise AssertionError(f"cooperative {what}: lowered to "
                                 f"{[(r.path, r.reason) for r in rep.records]}")
        for n, b in zip(ph.writes, ref):
            require_equal(env[n], b, f"cooperative {what} on the tmu stream")
    log(f"cooperative launches on the tmu stream beside eager convs on the "
        f"tpu stream: xchain_commit and xchain_prologue finished, bit-exact;"
        f" busy " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                              meas["engine_busy_s"].items())
        + f", exclusive {meas['exclusive_s'] * 1e3:.3f} ms, counted "
        f"overlap {meas['both_busy_s'] * 1e3:.3f} ms")
    return out


def _percentiles_ms(snap: dict) -> str:
    return ", ".join(
        f"{k} p50 {snap[f'{k}_latency_p50_s'] * 1e3:.3f} p99 "
        f"{snap[f'{k}_latency_p99_s'] * 1e3:.3f} ms" for k in ("cold", "warm"))


def served_traffic(dev, img_shape=IMG, n_classes=N_CLASSES,
                   espcn_img=ESPCN_IMG, n_requests=64, threads=4,
                   max_batch=8) -> dict:
    """``n_requests`` requests, half YOLOv3-Tiny (one image each) and half
    ESPCN x3 (one frame each), submitted from ``threads`` host threads to
    ``TMServer(ServerConfig(backend="cuda", max_batch=8,
    batch_timeout_s=0.01))`` (the continuous scheduler, pipeline depth 2),
    twice: cold (compiles) then warm.  Every response bit-exact against its
    cache entry's compiled program run directly on the same stacked batch,
    and within slice 4's tolerances against the eager model on that batch
    (YOLO head 1 bit-exact, head 2 within its last conv's bound; ESPCN
    within its last conv's bound)."""
    import threading

    from repro_torch.core import tm_ops
    from repro_torch.core.fp_bounds import gamma
    from repro_torch.models import cnn
    from repro_torch.serving import ServerConfig, TMServer
    from repro_torch.serving.batcher import coalesce, split

    yolo = cnn.init_yolov3_tiny(torch.Generator().manual_seed(SEED),
                                n_classes=n_classes, device=dev)
    espcn = cnn.init_espcn(torch.Generator().manual_seed(SEED), s=3,
                           device=dev)
    gen = torch.Generator().manual_seed(SEED + 11)
    groups = []

    class RecordingServer(TMServer):
        """Keeps each served group (its requests, height and entry) for
        the checks below."""

        def _finalize(self, prep, err):
            groups.append((list(prep.batch), prep.size, prep.entry, err))
            super()._finalize(prep, err)

    def round_of(srv, name):
        reqs = []
        for i in range(n_requests):
            if i % 2 == 0:
                x = torch.rand((1,) + tuple(img_shape[1:]), generator=gen)
                reqs.append(("yolo", yolo, x.to(dev)))
            else:
                x = torch.rand(espcn_img, generator=gen)
                reqs.append(("espcn", espcn, x.to(dev)))
        futs = [None] * n_requests

        def client(k):
            for i in range(k, n_requests, threads):
                key, fn, x = reqs[i]
                futs[i] = srv.submit(fn, x, fn_key=key)

        _sync(dev)
        srv.stats.reset_series()
        t0 = time.perf_counter()
        pool = [threading.Thread(target=client, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=600)
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        snap = srv.snapshot_stats()
        log(f"served {name}: {n_requests} requests ({n_requests // 2} "
            f"YOLOv3-Tiny {tuple(img_shape[1:])}, {n_requests // 2} ESPCN x3 "
            f"{tuple(espcn_img[1:])}) from {threads} threads in "
            f"{wall * 1e3:.3f} ms: {n_requests / wall:.3f} requests/s; "
            f"{_percentiles_ms(snap)}; queue delay p50 "
            f"{snap['queue_delay_p50_s'] * 1e3:.3f} ms; cache "
            f"{snap['cache']['hits']} hits / {snap['cache']['misses']} "
            f"misses (hit rate {snap['cache']['hit_rate']:.3f}); mean batch "
            f"{snap['mean_batch_size']:.3f}; overlap measured "
            f"{snap['overlap_ratio']:.4f} vs predicted "
            f"{snap['predicted_overlap']:.4f}; engine busy "
            + ", ".join(f"{k} {v * 1e3:.3f} ms"
                        for k, v in snap["engine_busy_s"].items()))
        return reqs, outs, wall, snap

    cfg = ServerConfig(backend="cuda", max_batch=max_batch,
                       batch_timeout_s=0.01, device=dev)
    with no_vmap_fallback(), RecordingServer(cfg) as srv:
        cold = round_of(srv, "cold")
        warm = round_of(srv, "warm")
        entries = list(srv.cache._entries.values())
    for e in entries:
        sel = {k: v for k, v in e.selection.items() if k != "segment_bytes"}
        log(f"cache entry {e.key.fn_key} {e.key.shapes[0]}: phases "
            f"{e.compiled.phase_kinds}, backend {e.backend}, segment_bytes "
            f"{e.params.segment_bytes if e.params else None}, fuse_chains "
            f"{e.fuse_chains}, cross_engine {e.cross_engine}, compile "
            f"{e.compile_s:.3f} s; selection {json.dumps(sel, default=str)}")

    # the checks, group by group, after the server stopped
    tm_paths = {"yolo": set(), "espcn": set()}
    n_checked = 0
    for batch, size, entry, err in groups:
        if err is not None:
            raise AssertionError(f"served group {entry.key.fn_key} failed: "
                                 f"{err!r}")
        stacked, _ = coalesce(batch, size)
        direct, reps = entry.compiled.run(*stacked, backend=entry.backend,
                                          fuse_chains=entry.fuse_chains)
        key = entry.key.fn_key
        tm_paths[key] |= {r.path for rep in reps for r in rep.records
                          if r.path.startswith("cuda.")}
        x = stacked[0].reshape((size,) + tuple(stacked[0].shape[2:]))
        if key == "yolo":
            p1, p2 = yolo(x)
            r, skip = yolo.trunk(tm_ops.rearrange(x, 1, 16))
            cat = tm_ops.route([tm_ops.upsample(yolo.neck_in(r), 2), skip])
            tol2 = 2 * gamma(256) * _conv_mag(cat, yolo.head2_w)
        else:
            eager = espcn(x)
            h = torch.tanh(cnn.conv2d(torch.tanh(cnn.conv2d(x, espcn.c1)),
                                      espcn.c2))
            tol = 2 * gamma(3 * 3 * 32) * _shuffle(_conv_mag(h, espcn.c3), 3)
        for i, (req, part) in enumerate(zip(batch, split(direct, len(batch)))):
            got = req.future.result(timeout=0)
            what = f"served {key} x{size} row {i}"
            if key == "yolo":
                for a, b in zip(got, part):
                    require_equal(a, b, f"{what} vs the compiled program")
                require_equal(got[0], p1[i:i + 1], f"{what} head 1 vs eager")
                require_within(got[1], p2[i:i + 1], tol2[i:i + 1],
                               f"{what} head 2 vs eager")
                fin = all(bool(torch.isfinite(t).all()) for t in got)
            else:
                require_equal(got, part, f"{what} vs the compiled program")
                require_within(got, eager[i:i + 1], tol[i:i + 1],
                               f"{what} vs eager")
                fin = bool(torch.isfinite(got).all())
            if not fin:
                raise AssertionError(f"{what}: non-finite values")
            n_checked += 1
    if n_checked != 2 * n_requests:
        raise AssertionError(f"checked {n_checked} responses of "
                             f"{2 * n_requests}")
    for key, paths in tm_paths.items():
        if not paths:
            raise AssertionError(f"served {key}: no TM kernel ran")
    log(f"served responses: {n_checked} bit-exact against their entries' "
        f"compiled programs on the same stacked batches and within slice "
        f"4's tolerances against the eager models; TM paths {tm_paths}")
    return dict(cold=cold[3], warm=warm[3], entries=entries)


# ---------------------------------------------------------------------------
# slice 12: fault tolerance and position-bucketed decode through TMServer
# ---------------------------------------------------------------------------

class _Recorder:
    """A TMServer mixin that keeps every group it executed — served
    (``_finalize``) or re-executed by isolation (``_execute_direct``) —
    with its height and entry, for the checks after the server stopped."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.groups = []

    def _finalize(self, prep, err):
        self.groups.append((list(prep.batch), prep.size, prep.entry))
        super()._finalize(prep, err)

    def _execute_direct(self, members):
        from repro_torch.serving.batcher import bucket_size, coalesce
        from repro_torch.serving.cache import CacheKey
        out = super()._execute_direct(members)  # raises on a failed retry
        size = bucket_size(len(members), self.config.max_batch)
        key = CacheKey.for_call(members[0].fn, coalesce(members, size)[0],
                                backend=self.config.backend, params=None,
                                fn_key=members[0].fn_key)
        self.groups.append((list(members), size, self.cache._entries[key]))
        return out


def faults_on_card(dev, img_shape=IMG, n_classes=N_CLASSES,
                   max_batch=8) -> dict:
    """YOLOv3-Tiny 448x448 served in batch-8 groups by
    ``TMServer(backend="cuda", max_batch=8, phase_timeout_factor=20)``
    (isolation on, two retries) under one seeded ``FaultPlan`` of three
    faults, each installed for its own round so it hits its own group:
    (1) a hang at the stream site of one warm group's first phase — the
    watchdog poisons it with ``PhaseTimeoutError``, the engine serves the
    next group, isolation re-executes the hung one; (2) a one-shot
    kernel-lowering fault — bisect-retry rescues every request; (3) a
    persistent compile fault matched to one request's ``fn_key`` — that
    request alone fails.  Every response that resolved is bit-exact against
    its entry's program run directly on the same stacked batch."""
    import math

    from repro_torch.ft import (FaultInjector, FaultPlan, FaultSpec,
                                InjectedFault, PhaseTimeoutError)
    from repro_torch.models import cnn
    from repro_torch.serving import ServerConfig, TMServer
    from repro_torch.serving.batcher import coalesce, split

    yolo = cnn.init_yolov3_tiny(torch.Generator().manual_seed(SEED),
                                n_classes=n_classes, device=dev)
    gen = torch.Generator().manual_seed(SEED + 12)
    plan = FaultPlan(seed=SEED, specs=(
        FaultSpec(site="stream", match=f"yolox{max_batch}#0:", mode="hang",
                  count=1, delay_s=120.0),
        FaultSpec(site="lowering", mode="fail", count=1),
        FaultSpec(site="compile", match="yolo-poison", mode="fail",
                  count=math.inf)))

    def images(n):
        return [torch.rand((1,) + tuple(img_shape[1:]), generator=gen)
                .to(dev) for _ in range(n)]

    class Server(_Recorder, TMServer):
        pass

    cfg = ServerConfig(backend="cuda", max_batch=max_batch,
                       batch_timeout_s=0.05, retry_attempts=2,
                       phase_timeout_factor=20.0, phase_timeout_floor_s=2.0,
                       device=dev)
    futs: list = []
    rows = []
    keys = ("phase_timeouts", "isolation_retries", "rescued_requests",
            "victim_requests", "failed", "completed")
    with no_vmap_fallback(), Server(cfg) as srv:
        runtime = srv.sched.runtime

        def round_of(name, spec, reqs, expect):
            before = srv.snapshot_stats()
            t0 = time.perf_counter()
            with FaultInjector(FaultPlan(specs=(spec,) if spec else (),
                                         seed=plan.seed)) as inj:
                fs = [srv.submit(yolo, x, fn_key=k) for k, x in reqs]
                outcome = []
                for f in fs:
                    try:
                        f.result(timeout=600)
                        outcome.append("ok")
                    except (PhaseTimeoutError, InjectedFault) as e:
                        outcome.append(type(e).__name__)
            wall = time.perf_counter() - t0
            after = srv.snapshot_stats()
            delta = {k: after[k] - before[k] for k in keys}
            futs.extend(zip(reqs, fs))
            log(f"faults {name}: {len(reqs)} requests in {wall * 1e3:.3f} ms,"
                f" fired {inj.fired}; " + ", ".join(
                    f"{k} {v}" for k, v in delta.items()))
            if outcome != expect or inj.fired < (1 if spec else 0):
                raise AssertionError(f"faults {name}: outcomes {outcome}, "
                                     f"expected {expect}; fired {inj.fired}")
            rows.append({"round": name, "wall_s": wall, **delta})
            return delta

        ok = ["ok"] * max_batch
        round_of("warm-up", None, [("yolo", x) for x in images(max_batch)],
                 ok)
        d = round_of("hang", plan.specs[0],
                     [("yolo", x) for x in images(2 * max_batch)], ok + ok)
        wd = srv.watchdog
        if d["phase_timeouts"] != 1 or len(wd.poisoned_at) != 1:
            raise AssertionError(f"hang round: {d['phase_timeouts']} phase "
                                 f"timeouts, expected 1")
        t_poison = wd.poisoned_at[0]
        after = [ev.t_end for ev in runtime.timeline()
                 if ev.t_start is not None and ev.t_end is not None
                 and ev.t_end > t_poison]
        if not after:
            raise AssertionError("no phase completed after the poison")
        to_next = min(after) - t_poison
        log(f"faults hang: watchdog timeouts {wd.timeouts}, poison to the "
            f"next completed phase {to_next * 1e3:.3f} ms; the hung group "
            f"rescued by isolation ({d['rescued_requests']} requests)")
        d = round_of("lowering", plan.specs[1],
                     [("yolo", x) for x in images(max_batch)], ok)
        if d["rescued_requests"] != max_batch or d["victim_requests"]:
            raise AssertionError(f"lowering round: {d}")
        reqs = [("yolo", x) for x in images(max_batch - 1)]
        reqs.insert(3, ("yolo-poison", images(1)[0]))
        expect = ok[:]
        expect[3] = "InjectedFault"
        d = round_of("persistent", plan.specs[2], reqs, expect)
        if d["victim_requests"] != 1:
            raise AssertionError(f"persistent round: {d}")
        groups = list(srv.groups)
        snap = srv.snapshot_stats()
    # every response that resolved, against its entry's program on the
    # same stacked batch
    n_checked = 0
    for batch, size, entry in groups:
        live = [r for r in batch if r.future.exception() is None]
        if not live:
            continue
        stacked, _ = coalesce(batch, size)
        direct, _ = entry.compiled.run(*stacked, backend=entry.backend,
                                       fuse_chains=entry.fuse_chains)
        for r, part in zip(batch, split(direct, len(batch))):
            if r.future.exception() is not None:
                continue
            for a, b in zip(r.future.result(timeout=0), part):
                require_equal(a, b, f"faults: {r.fn_key} response vs its "
                                    f"entry's program")
            n_checked += 1
    n_ok = sum(1 for _, f in futs if f.exception() is None)
    if n_checked < n_ok:
        raise AssertionError(f"checked {n_checked} of {n_ok} responses")
    log(f"faults: {n_ok} responses bit-exact against their entries' "
        f"programs on the same stacked batches; totals: phase timeouts "
        f"{snap['phase_timeouts']}, isolation retries "
        f"{snap['isolation_retries']}, rescued {snap['rescued_requests']}, "
        f"victims {snap['victim_requests']}")
    return {"rounds": rows, "poison_to_next_s": to_next}


DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS, DECODE_MAX_LEN = 4, 64, 32, 128


def _forced(step_fn, prompts, toks, caches):
    """The eager step functions fed ``toks`` (the served choices) from
    ``caches``: the last-position logits and the caches of every step."""
    P = prompts.shape[1]
    lg, ck, cv = step_fn(0)(prompts, *caches)
    logits, out = [lg[:, -1]], [(ck, cv)]
    for i in range(toks.shape[1] - 1):
        lg, ck, cv = step_fn(P + i)(toks[:, i:i + 1], ck, cv)
        logits.append(lg[:, -1])
        out.append((ck, cv))
    return logits, out


def decode_full_width(dev) -> dict:
    """``DecodeSession`` on Phi-4-mini 3.8B's full published config (bf16,
    random weights from seed 0, nothing cut): batch 4, 64-token prompts,
    prefill + 32 decode steps (33 pinned programs, one per position),
    ``max_len`` 128, on the cuda backend; a cold pass, then a warm one.
    Every step's caches bit-exact against the same step functions run
    eagerly on the card with the served tokens, every step's logits
    within slice 5's bound (2x the bf16 eager run's distance from an f32
    run of the same weights, plus LM_FLOOR_ULPS bf16 ulps); the 33
    programs close over one copy of the weights."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.serving import DecodeSession, make_layer_step
    from repro_torch.serving.stats import latency_percentiles

    cfg = get_config(LM_ARCH)
    B, P, N = DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS + 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sess = DecodeSession(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev, max_len=DECODE_MAX_LEN)
    prompts = torch.randint(
        0, cfg.vocab, (B, P), device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1)
    ).to(torch.int32)
    weights = torch.cuda.memory_allocated(dev)
    with sess:
        served: list = []
        t0 = time.perf_counter()
        toks, logits = sess.generate(prompts, N, caches=served)
        _sync(dev)
        cold = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        n_cold = len(sess.stats.step_latency_s)
        before = sess.server.snapshot_stats()
        cold_snap = before["cache"]
        t0 = time.perf_counter()
        toks2, logits2 = sess.generate(prompts, N)
        _sync(dev)
        warm = time.perf_counter() - t0
        after = sess.server.snapshot_stats()
        snap = after["cache"]
        # the engines' busy time in the warm pass: the phase intervals of
        # both streams (a phase ends when an event after its work synced)
        busy = {k: v - before["engine_busy_s"].get(k, 0.0)
                for k, v in after["engine_busy_s"].items()}
        entries = list(sess.server.cache._entries.values())
        stats = sess.stats
        if snap["entries"] != N or snap["misses"] - cold_snap["misses"]:
            raise AssertionError(f"decode: {snap['entries']} cache entries "
                                 f"(expected {N}), "
                                 f"{snap['misses'] - cold_snap['misses']} "
                                 f"warm misses (expected 0)")
        if not torch.equal(toks, toks2):
            raise AssertionError("decode: the warm pass chose other tokens")
        # the weights exist once: every program's constants are the
        # session's parameter tensors or small folded values
        params = sess.params
        ptrs = {t.data_ptr() for t in (params["embed"]["e"],
                                       params["final_norm"]["g"])}
        stack = [params["blocks"]]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack.extend(t.values())
            else:
                ptrs.add(t.data_ptr())
        folded = []
        for e in entries:
            consts = e.compiled.graph.consts.values()
            if params["embed"]["e"].data_ptr() not in {
                    c.data_ptr() for c in consts}:
                raise AssertionError(f"{e.key.fn_key}: the embedding is "
                                     f"not the session's own tensor")
            folded.append(sum(c.numel() * c.element_size() for c in consts
                              if c.data_ptr() not in ptrs))
        if max(folded) > 64 << 20:
            raise AssertionError(f"decode: a program holds "
                                 f"{max(folded)} bytes of folded constants")
        # one decode step's program: its TM share, kinds and paths
        e = next(x for x in entries if x.key.fn_key.endswith(f"p{P}s1"))
        mix = e.compiled.partition_report.phase_mix()
        n_tpu = len(e.compiled.graph.tpu_nodes())
        ck, cv = served[0]
        _, reps = e.compiled.run(toks[None, :, :1], ck[None], cv[None],
                                 backend="cuda", fuse_chains=e.fuse_chains,
                                 exact=True)
        tm_phases = [p for p in e.compiled.partition_report.phases
                     if p.kind == "tmu"]
        log(f"decode step p{P}: {len(e.compiled.partition_report.phases)} "
            f"phases {e.compiled.phase_kinds}, "
            f"{mix['tmu_instrs']} TM instructions of "
            f"{mix['tmu_instrs'] + n_tpu} (share "
            f"{mix['tmu_instrs'] / (mix['tmu_instrs'] + n_tpu):.3f}), "
            f"fuse_chains {e.fuse_chains}; TM phase paths: " + "; ".join(
                f"{ph.index}: " + ",".join(r.path for r in rep.records)
                for ph, rep in zip(tm_phases, reps)))
        compile_s = sorted(x.compile_s for x in entries
                           if x.key.fn_key.endswith("s1"))
        pre = [x.compile_s for x in entries
               if x.key.fn_key.endswith(f"p0s{P}")]
        pct = latency_percentiles(stats.step_latency_s[n_cold:], "w")
        log(f"decode {cfg.name} full width, batch {B}, prompt {P}, "
            f"{DECODE_STEPS} decode steps, max_len {DECODE_MAX_LEN}: cold "
            f"{B * N / cold:.3f} tokens/s ({cold:.3f} s), warm "
            f"{B * N / warm:.3f} tokens/s ({warm:.3f} s); warm step p50 "
            f"{pct['w_p50_s'] * 1e3:.3f} / p99 {pct['w_p99_s'] * 1e3:.3f} "
            f"ms; prefill {stats.prefill_latency_s[0] * 1e3:.3f} ms cold, "
            f"{stats.prefill_latency_s[1] * 1e3:.3f} ms warm; compile "
            f"{pre[0]:.3f} s prefill, per decode position min "
            f"{compile_s[0]:.3f} / median {compile_s[len(compile_s) // 2]:.3f}"
            f" / max {compile_s[-1]:.3f} s; cache {snap['entries']} entries, "
            f"warm misses 0; warm pass engine busy " + ", ".join(
                f"{k} {v * 1e3:.3f} ms" for k, v in busy.items())
            + f" of {warm * 1e3:.3f} ms wall; memory: weights "
            f"{weights / 2**30:.3f} GiB, "
            f"peak after the cold pass {peak / 2**30:.3f} GiB, folded "
            f"constants {sum(folded) / 2**20:.3f} MiB over {len(entries)} "
            f"programs")
        # the eager step functions on the card, fed the served tokens
        ref_logits, ref_caches = _forced(sess.step_fn, prompts, toks,
                                         sess.init_cache(B))
        for i, ((a, b), (c, d)) in enumerate(zip(served, ref_caches)):
            require_equal(a, c, f"decode step {i} K cache")
            require_equal(b, d, f"decode step {i} V cache")
        exact = sum(bool(torch.equal(a, b))
                    for a, b in zip(logits, ref_logits))
        # the same weights in f32 (exact), the same step functions
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        p32 = {"embed": {"e": params["embed"]["e"].float()},
               "final_norm": {"g": params["final_norm"]["g"].float()},
               "blocks": _tree(lambda t: t[:1].float(), params["blocks"])}
        steps32: dict = {}

        def step32(pos):
            if pos not in steps32:
                steps32[pos] = make_layer_step(cfg32, p32, position=pos)
            return steps32[pos]

        z = torch.zeros((B, DECODE_MAX_LEN, cfg.n_kv_heads, cfg.hd),
                        device=dev)
        f32_logits, _ = _forced(step32, prompts, toks, (z, z))
        del p32, steps32
        served_lg = torch.stack([x.float() for x in logits])
        plain = torch.stack([x.float() for x in ref_logits])
        ref = torch.stack(f32_logits)
        for what, lg in (("served", served_lg), ("eager bf16", plain),
                         ("f32", ref)):
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"decode {what}: non-finite logits")
        d_srv = (served_lg - ref).abs().flatten(1).amax(dim=1)
        d_plain = (plain - ref).abs().flatten(1).amax(dim=1)
        floor = LM_FLOOR_ULPS * bf16_ulp(
            ref.abs().flatten(1).amax(dim=1)).float()
        worst = float((d_srv / (2 * d_plain + floor)).max())
        log(f"decode checks: caches bit-exact on all {N} steps against the "
            f"eager steps on the card; logits bit-exact on {exact} of {N} "
            f"steps (reported, not required: cuBLAS may pick another "
            f"algorithm for the compiled shapes); vs the f32 run, max over "
            f"steps: served {float(d_srv.max()):.4g}, eager bf16 "
            f"{float(d_plain.max()):.4g}, floor {float(floor.max()):.4g}; "
            f"worst step served / (2 eager + floor) = {worst:.3f} (must be "
            f"<= 1)")
        if worst > 1:
            raise AssertionError(f"decode logits past slice 5's bound: "
                                 f"{worst:.3f}")
    return {"cold_s": cold, "warm_s": warm, "entries": snap["entries"],
            "peak": peak, "exact_steps": exact}


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


KERNELS = {  # slice -> the kernels its path must launch
    1: ("tm_affine_block", "tm_affine_gather", "rme_evaluate"),
    2: ("tm_chain", "rme_evaluate_chained", "rme_assemble"),
    3: ("img2col", "conv2d", "resize"),
    4: ("matmul_tm", "xchain_commit", "xchain_prologue"),
    5: ("flash_attention", "flash_decode"),
    11: ("tm_affine_gather", "tm_chain", "xchain_commit", "xchain_prologue"),
    # slice 12 ports no kernel: its two paths reach earlier slices' kernels
    "12a": ("tm_chain", "xchain_prologue"),
    "12b": ("tm_affine_block", "tm_affine_gather"),
}


def _wrappers() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.img2col import img2col as ik
    from repro_torch.kernels.matmul_tm import chain as xc
    from repro_torch.kernels.matmul_tm import matmul_tm as mk
    from repro_torch.kernels.resize import resize as rk
    from repro_torch.kernels.rme_gather import rme_gather as rg
    from repro_torch.kernels.tm_affine import chain, tm_affine
    return {"tm_affine_block": tm_affine.tm_affine_block,
            "tm_affine_gather": tm_affine.tm_affine_gather,
            "rme_evaluate": rg.rme_evaluate,
            "tm_chain": chain.tm_chain,
            "rme_evaluate_chained": rg.rme_evaluate_chained,
            "rme_assemble": rg.rme_assemble,
            "img2col": ik.img2col,
            "conv2d": ik.conv2d,
            "resize": rk.resize_bilinear,
            "matmul_tm": mk.matmul_tm,
            "xchain_commit": xc.xchain_commit,
            "xchain_prologue": xc.xchain_prologue,
            "flash_attention": fa.flash_attention,
            "flash_decode": fa.flash_decode}


def launch_counts() -> dict[str, int]:
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def run_path(slice_no: int, fn) -> tuple[object, dict[str, int]]:
    """Run one slice's path with every count set to 0 just before it;
    fail unless each of the slice's kernels launched in it."""
    reset_launch_counts()
    out = fn()
    counts = launch_counts()
    log(f"slice {slice_no} path launches: {counts}")
    missing = [k for k in KERNELS[slice_no] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on slice {slice_no}'s "
                             f"path: {missing}")
    return out, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a GPU", file=sys.stderr)
        return 1
    from repro_torch.core.executor import TMExecutor
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    seconds = build.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
        f"({time.perf_counter() - t0:.2f} s wall, nvcc in parallel)")

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    # full f32 for every reference product and conv (no TF32), and cuDNN's
    # algorithm chosen by its heuristics, not by timing
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    with torch.inference_mode():
        es = espcn_setup(dev, gen)  # the eager model launches no kernel
        rows = kernel_phase(dev, gen, es)
        y = yolo_setup(dev, gen)  # the eager model launches no kernel
        unfused = TMExecutor(backend="cuda", device=dev)
        chained = TMExecutor(backend="cuda", device=dev, fuse_chains=True)

        def slice1():
            operator_phase(dev, gen)
            return yolo_check(y, unfused, UNFUSED_PATHS, "unfused")

        def slice2():
            chain_operator_phase(dev, gen)
            out = yolo_check(y, chained, CHAINED_PATHS, "chained",
                             against=unfused_outs)
            yolo_timings(y, {"unfused": unfused, "chained": chained})
            return out

        def slice3():
            img2col_resize_phase(dev, gen)
            n_convs = edsr_check(e, unfused)
            edsr_timings(e, unfused)
            return n_convs

        (unfused_outs, n_unf), counts1 = run_path(1, slice1)
        (_, n_chn), counts2 = run_path(2, slice2)
        e = edsr_setup(dev, gen)  # the eager model launches no kernel
        n_convs, counts3 = run_path(3, slice3)
        del e

        def slice4():
            espcn_compiled_check(es)
            espcn_im2col_check(es)
            yolo_compiled_check(y, chained)

        _, counts4 = run_path(4, slice4)
        del es, y, unfused, chained
        torch.cuda.empty_cache()

        from repro_torch.configs.registry import get_config
        from repro_torch.launch.serve import serve
        lm = get_config(LM_ARCH)

        def slice5():
            return serve(lm, batch=LM_BATCH, prompt_len=LM_PROMPT,
                         gen=LM_GEN, seed=SEED, device=dev, log=log)

        (toks, stats), counts5 = run_path(5, slice5)
        want = {k: 0 for k in counts5}
        want.update(flash_attention=lm.n_layers,
                    flash_decode=lm.n_layers * (LM_GEN - 1))
        if counts5 != want:
            raise AssertionError(f"slice 5 launches {counts5}, expected "
                                 f"{want}")
        lm_check(lm, toks, stats, dev)
        del toks
    torch.cuda.empty_cache()

    # the server's threads run outside inference mode, so the served
    # models and requests are made outside it too
    with torch.no_grad():
        def slice11():
            two_stream_check(dev)
            return served_traffic(dev)

        _, counts11 = run_path(11, slice11)
        _, counts12a = run_path("12a", lambda: faults_on_card(dev))
        torch.cuda.empty_cache()
        _, counts12b = run_path("12b", lambda: decode_full_width(dev))
    if (n_unf, n_chn, n_convs) != (8, 4, 144):
        raise AssertionError(f"TM launches per forward {n_unf} unfused, "
                             f"{n_chn} chained, EDSR conv launches "
                             f"{n_convs}; expected 8, 4 and 144")
    by_slice = {1: counts1, 2: counts2, 3: counts3, 4: counts4, 5: counts5,
                11: counts11, "12a": counts12a, "12b": counts12b}
    # each kernel's launches from the path of the slice that ported it
    counts: dict[str, int] = {}
    for s_no, names in KERNELS.items():
        for k in names:
            counts.setdefault(k, by_slice[s_no][k])
    log(f"main-path launches (each kernel from its slice's path): {counts}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the kernels of the main path; flash_attention_f32 (the FMA route) is
    # off it, since the LM serves bf16, and stays a row of the table above
    kernels = [{k: ({**r, "launches": counts[r["name"]]})[k] for k in keys}
               for r in rows if r["name"] in counts]
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s with the build")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
