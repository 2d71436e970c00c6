"""Device times of matmul_tm, tm_affine_block, conv2d and xchain_commit
across shapes, paths and dtypes, beside their bounds and one PyTorch call
of the same work.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_tm_kernels

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
  cannot be captured in a graph).

Every kernel result is checked against its plain version first.  Needs a
CUDA device.
"""

from __future__ import annotations

import subprocess

import torch

import torch.nn.functional as F

from repro_torch.core import affine as af
from repro_torch.core.fp_bounds import bf16_ulp, conv_tol, gamma
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
    with torch.inference_mode():
        M = 360 * 640
        for ep in (mk.Epilogue(), mk.Epilogue("transpose"),
                   mk.Epilogue("pixel_shuffle", 360, 640, 3, 3)):
            matmul(gen, dev, M, 288, 27, ep)
        matmul(gen, dev, M, 288, 27, mk.Epilogue(), torch.bfloat16)
        matmul(gen, dev, M, 287, 27, mk.Epilogue())
        for N in (12, 64, 255):
            matmul(gen, dev, M, 288, N, mk.Epilogue())
        matmul(gen, dev, M, 32, 27, mk.Epilogue())
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
        conv(gen, dev, "EDSR body", 224, 224, 64, 64)
        conv(gen, dev, "EDSR head", 224, 224, 3, 64)
        conv(gen, dev, "EDSR up", 224, 224, 64, 12)
        conv(gen, dev, "EDSR body", 224, 224, 64, 64, dtype=torch.bfloat16)
        conv(gen, dev, "EDSR body stride 2", 224, 224, 64, 64, stride=2)
        conv(gen, dev, "EDSR body off 16 B (cp.async)", 224, 224, 64, 64,
             offset=1)
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
