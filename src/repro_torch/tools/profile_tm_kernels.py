"""Device times of the TM kernels across shapes, paths and dtypes, around
the kernel table's rows.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_tm_kernels [SECTION ...]

SECTION is any of matmul, block, gather, conv, commit, prologue, chain,
rme (default: all, in that order), or calls, which is run alone.

Prints the card's name and power limit, then each section's kernel-table
row (:mod:`repro_torch.tools.kernel_table`) and its cases around it, each
through the table's function for that kernel: checked against its plain
version, then its device ms (a CUDA graph of back-to-back calls), ms per
call, plain ms, bound and the PyTorch call of the same work:

* ``matmul_tm`` (f32 unless named): ESPCN's last layer (230400, 288) x
  (288, 27) in bf16; K = 287 (a pitch TMA cannot take: the cp.async
  path); N = 12, 64 and 255 (four column tiles); K = 32;
* ``tm_affine_block`` at (448, 448, 64): the transpose and HWC -> CHW
  (tile path) in int8 and bf16, a channel band in all three dtypes and a
  flip of W and C (scalar path) in f32, after one ``clone()`` of the f32
  map: what a plain copy reaches on the card;
* ``tm_affine_gather``: the Table III upsample, pixel shuffle, pixel
  unshuffle and rearrange in int8 and bf16, then on an x one element off
  16 bytes (element by element) in all three dtypes, and through the
  general kernel (the design before the separable path);
* ``conv2d``: EDSR's body at stride 2 and on an x one element off 16 bytes
  (the cp.async path);
* ``xchain_commit``: ESPCN's conv3 into PixelShuffle x3 in bf16, the same
  conv into a pad with fill (a masked level: the general walk), and an mm
  (230400, 288) x (288, 27) into a transpose;
* ``xchain_prologue``: the neck into head 2's 1x1 conv in bf16 and into a
  3x3 conv to 255, each beside ``tm_chain`` then ``torch.mm`` or
  ``F.conv2d`` (TF32 off) and the 1x1 beside ``tm_chain`` then
  ``conv2d``; the 1x1 product in f32 and bf16 held to 8 x 8
  thread tiles (on every block the card holds, and on one block a tile),
  and as one ``conv2d`` launch with its FMA loop alone;
* ``tm_chain`` at the neck in int8 and bf16, and on a u 4 bytes off
  16-byte alignment (accesses of one element) in all three dtypes;
* the RME compactions: the table's three rows and ``rme_evaluate`` on one
  100000-row stream with room for every survivor and with capacity 0 (the
  launch alone), in two turns, then the chained wrapper's host work piece
  by piece;
* ``calls``: the rows of ``tm_chain`` and the three compactions, three
  turns.  An earlier checkout (this module's and the table's) times its
  own kernels by the same code: ``cd <checkout> && PYTHONPATH=src python3
  -m repro_torch.tools.profile_tm_kernels calls``.

Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import torch
import torch.nn.functional as F

from repro_torch.core import affine as af
from repro_torch.core.fp_bounds import gamma
from repro_torch.h100 import bound_ms, card_line, graph_ms
from repro_torch.kernels import build
from repro_torch.kernels.img2col import img2col as ik
from repro_torch.kernels.matmul_tm import chain as xc
from repro_torch.kernels.matmul_tm import matmul_tm as mk
from repro_torch.kernels.rme_gather import rme_gather as rg
from repro_torch.kernels.tm_affine import chain as tc
from repro_torch.kernels.tm_affine import tm_affine as ta
from repro_torch.tools import kernel_table as kt
from repro_torch.tools.kernel_table import TABLE3, dt, log, summary


def sweep_matmul(gen, dev) -> None:
    kt.matmul_tm_row(dev)
    M = 360 * 640
    for K, N, dtype in ((288, 27, torch.bfloat16), (287, 27, torch.float32),
                        (288, 12, torch.float32), (288, 64, torch.float32),
                        (288, 255, torch.float32), (32, 27, torch.float32)):
        x = torch.randn((M, K), generator=gen).to(dev, dtype)
        w = torch.randn((K, N), generator=gen).to(dev, dtype)
        log(summary(kt.matmul_case("randn", x, w, mk.Epilogue())))


def sweep_block(gen, dev) -> None:
    x = torch.rand(TABLE3, generator=gen).to(dev)
    copy = graph_ms(lambda: x.clone())
    log(f"copy {TABLE3} float32 (x.clone(), the yardstick of a plain copy): "
        f"{copy:.4f} ms, bound {bound_ms(2 * x.numel() * 4)[0]:.4f}")
    kt.block_row(dev)
    t, band = af.transpose_map(TABLE3), af.split_map(TABLE3, 2, 1)
    chw, flip = (af.axis_permutation_map(TABLE3, (2, 0, 1)),
                 af.flip_map(TABLE3, (1, 2)))
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        xd = torch.randint(-100, 100, TABLE3, generator=gen).to(dev, dtype)
        cases = [("band 32:64", band, lambda a: a[..., 32:].contiguous())]
        if dtype == torch.bfloat16:
            cases.append(("transpose", t,
                          lambda a: a.permute(1, 0, 2).contiguous()))
        if dtype != torch.float32:
            cases.append(("HWC->CHW", chw,
                          lambda a: a.permute(2, 0, 1).contiguous()))
        else:
            cases.append(("flip W, C", flip,
                          lambda a: a.flip(1, 2).contiguous()))
        for name, m, library in cases:
            log(summary(kt.block_case(name, xd, m, library)))


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


def sweep_gather(gen, dev) -> None:
    kt.gather_row(dev)  # the four maps in f32 on aligned operands
    maps = (("upsample x2", af.upsample_map(TABLE3, 2)),
            ("pixel shuffle x2", af.pixel_shuffle_map(TABLE3, 2)),
            ("pixel unshuffle x2", af.pixel_unshuffle_map(TABLE3, 2)),
            ("rearrange 3 -> 16", af.rearrange_map((448, 448, 3), 1, 16)))
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        for name, m in maps:
            n = math.prod(m.in_shape)
            buf = torch.randint(-100, 100, (n + 16,), generator=gen).to(
                dev, dtype)
            lead = (-buf.data_ptr() % 16) // buf.element_size()
            for start in ((lead + 1,) if dtype == torch.float32
                          else (lead, lead + 1)):
                x = buf[start:start + n].view(m.in_shape)
                library = None
                if (name, dtype, start) == ("upsample x2", torch.bfloat16,
                                            lead):
                    library = lambda: F.interpolate(  # noqa: E731
                        x.permute(2, 0, 1)[None], scale_factor=2,
                        mode="nearest")
                log(summary(kt.gather_case(name, x, m, library)))
            x = buf[lead:lead + n].view(m.in_shape)
            if ta.gather_launch(m, x).path == "general":
                continue
            if not torch.equal(general_gather(x, m), ta.gather_plain(x, m)):
                raise AssertionError(f"general gather {name} {dtype}")
            ms = graph_ms(lambda: general_gather(x, m), 10)
            bound = bound_ms((n + math.prod(m.out_shape)) * x.element_size())[0]
            log(f"tm_affine_gather {name} {dt(dtype)} general kernel: "
                f"{x.element_size()} B per access; {ms:.4f} ms, bound "
                f"{bound:.4f} ({bound / ms:.2f} of it)")


def sweep_conv(gen, dev) -> None:
    kt.conv2d_row(dev)  # EDSR's head, up and body in f32 and bf16
    w = ((torch.rand((3, 3, 64, 64), generator=gen) - 0.5) * 0.1).to(dev)
    buf = torch.rand((224 * 224 * 64 + 1,), generator=gen).to(dev)
    log(summary(kt.conv_case("EDSR body conv", buf[:-1].view(224, 224, 64),
                             w, stride=2)))
    log(summary(kt.conv_case("EDSR body conv off 16 B (cp.async)",
                             buf[1:].view(224, 224, 64), w)))


def sweep_commit(gen, dev) -> None:
    kt.xchain_commit_row(dev)
    g = xc.Gemm("conv", (1, 360, 640, 32), (3, 3, 32, 27), 1, "SAME")
    shuffle = ((af.batch_extend_map(
        af.pixel_shuffle_map(g.out_shape[1:], 3), (1,)), None),)
    pad = ((af.batch_extend_map(af.pad_map(
        g.out_shape[1:], (1, 1, 0), (1, 1, 0), fill=3.0), (1,)), None),)
    mm = xc.Gemm("mm", (230400, 288), (288, 27))
    for name, gg, links, dtype in (
            ("ESPCN conv3 -> PixelShuffle x3", g, shuffle, torch.bfloat16),
            ("ESPCN conv3 -> pad with fill", g, pad, torch.float32),
            ("mm (230400, 288) x (288, 27) -> transpose", mm,
             ((af.axis_permutation_map(mm.out_shape, (1, 0)), None),),
             torch.float32)):
        x = (torch.rand(gg.x_shape, generator=gen) - 0.5).to(dev, dtype)
        w = ((torch.rand(gg.w_shape, generator=gen) - 0.5) * 0.1).to(
            dev, dtype)
        K = gg.words()[3]
        sig = tc.ChainSig(links=links, dtype=str(dtype)[6:])
        # |x| <= 0.5, |w| <= 0.05: sum |x w| <= 0.025 K
        log(summary(kt.commit_case(name, sig, gg, x, w,
                                   2 * gamma(K) * 0.025 * K)))


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


def sweep_prologue(gen, dev) -> None:
    kt.xchain_prologue_row(dev)
    for name, dtype, k in (("YOLO neck -> 1x1 conv 255", torch.bfloat16, 1),
                           ("YOLO neck -> 3x3 conv 255", torch.float32, 3)):
        sig, g, u, skip, w = kt.prologue_inputs(dev, dtype, k)
        log(summary(kt.prologue_case(name, sig, g, u, skip, w)))
    for dtype in (torch.float32, torch.bfloat16):
        sig, g, u, skip, w = kt.prologue_inputs(dev, dtype)
        cat = torch.empty(g.x_shape, dtype=dtype, device=dev)
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
            log(f"xchain_prologue 1x1 {dt(dtype)}: held to 8 x 8 tiles (BM "
                f"{wide.BM}, {wide.tiles} tiles on {wide.grid} blocks) "
                f"{wide_ms:.4f} ms; chain {walk8:.4f}, product "
                f"{product8:.4f}")
        # the same product as one conv2d launch of the (6272, 1, 256) map,
        # and its FMA loop alone
        xs = torch.rand((8 * 28 * 28, 1, 256), generator=gen).to(dev, dtype)
        alone = graph_ms(lambda: ik.conv2d(xs, w), 10)
        fma = graph_ms(lambda: ik.conv2d_fma_probe(xs, w), 10)
        cplan = ik.conv2d_plan(xs, w)
        log(f"xchain_prologue 1x1 {dt(dtype)}: the product as conv2d (BM "
            f"{cplan.BM}, nct {cplan.nct}, {cplan.tiles} tiles) {alone:.4f} "
            f"ms, its FMA loop alone {fma:.4f} ms = "
            f"{g.flops() / fma / 1e9 / 67:.3f} of 67 TFLOP/s")


def sweep_chain(gen, dev) -> None:
    kt.chain_row(dev)
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        for off in ((4 // dtype.itemsize,) if dtype == torch.float32
                    else (0, 4 // dtype.itemsize)):
            log(summary(kt.chain_row(dev, dtype, off)))


def host_us(fn, iters: int = 300) -> float:
    """Host microseconds per call of ``fn`` (launches queue on the card,
    which drains after the clock stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def sweep_rme(gen, dev) -> None:
    long = torch.randn((1, 100_000, 85), generator=gen).to(dev)
    recs = kt.detect_records(dev)
    for turn in range(2):
        for r in (kt.evaluate_row(dev), kt.chained_evaluate_row(dev),
                  kt.assemble_row(dev),
                  # room for every survivor
                  kt.evaluate_case(long, 100_000),
                  # no round runs: the launch and the count's store alone
                  kt.evaluate_case(recs, 0)):
            log(f"rme turn {turn}: {summary(r)}")
    # the chained wrapper's host work, piece by piece (host clock, no sync
    # inside the loop)
    m = af.batch_extend_map(af.reshape_map((28, 28, 255), (2352, 85)), (8,))
    j, _, fill = tc.fold_pullback((m,))
    idx = torch.from_numpy(j.reshape(m.out_shape)).to(dev)
    pred = torch.randn(m.in_shape, generator=gen).to(dev)
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
        "whole wrapper": lambda: rg.rme_evaluate_chained(
            pred, idx, None, fill, 0.5, 256, score_index=4),
    }
    log("rme_evaluate_chained host us per call: " + ", ".join(
        f"{name} {host_us(f):.2f}" for name, f in pieces.items()))


def calls(dev) -> None:
    for turn in range(3):
        rows = [r(dev) for r in (kt.chain_row, kt.evaluate_row,
                                 kt.chained_evaluate_row, kt.assemble_row)]
        log(f"calls turn {turn}: " + ", ".join(
            f"{r['name']} {r['ms']:.4f} device, {r['call_ms']:.4f} per call"
            for r in rows) + " ms")


SECTIONS = {"matmul": sweep_matmul, "block": sweep_block,
            "gather": sweep_gather, "conv": sweep_conv,
            "commit": sweep_commit, "prologue": sweep_prologue,
            "chain": sweep_chain, "rme": sweep_rme}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_tm_kernels: needs a CUDA device")
    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    want = sys.argv[1:] or list(SECTIONS)
    if want == ["calls"]:
        with torch.inference_mode():
            calls(dev)
        return
    if set(want) - set(SECTIONS):
        raise SystemExit(f"profile_tm_kernels: sections are "
                         f"{tuple(SECTIONS)}, or calls alone")
    with torch.inference_mode():
        for name in SECTIONS:
            if name in want:
                SECTIONS[name](gen, dev)


if __name__ == "__main__":
    main()
