"""The port's kernel table on the card: one function a row of ``PERF.md``
§6, each building the row's inputs from the seed at the row's shape.

    from repro_torch.tools import kernel_table as kt
    rows = [row(dev) for row in kt.ROWS]

Each row checks its kernel against the plain PyTorch version on the card
(bit-exact for data movement; the conv, the products, resize, attention
and the loss within a stated tolerance), then times it: its device ms
(:func:`~repro_torch.h100.graph_ms`, a CUDA graph of back-to-back
launches), its ms per call with the wrapper's host work
(:func:`~repro_torch.h100.events_ms`), the plain version's ms, its bound
(:func:`~repro_torch.h100.bound_ms`: bytes in and out over 3.35 TB/s, or
f32 operations over 67 TFLOP/s, bf16 over 989 TFLOP/s, where larger) and,
where one PyTorch call computes the same function, that call's device ms.
It returns the row as a dict (``chip_smoke.py`` prints the main path's
rows in its ``kernels`` line) and logs what the numbers do not show:
plans, paths, phases alone, the other dtypes and maps at the same size.

The ``*_case`` functions check and time one kernel at any shape; the rows
call them at the table's shapes and the profilers of this package at
others.  Needs a CUDA device; every kernel builds at its first call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import affine as af
from repro_torch.core.fp_bounds import (U32, attention_tol, bf16_ulp,
                                        conv_tol, decode_lse_tol, gamma,
                                        ulps_apart)
from repro_torch.h100 import F32_FLOP_PER_S, bound_ms, events_ms, graph_ms
from repro_torch.kernels import xent
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.img2col import img2col as ik
from repro_torch.kernels.matmul_tm import chain as xc
from repro_torch.kernels.matmul_tm import matmul_tm as mk
from repro_torch.kernels.resize import resize as rk
from repro_torch.kernels.rme_gather import rme_gather as rg
from repro_torch.kernels.tm_affine import chain as ch
from repro_torch.kernels.tm_affine import tm_affine as ta
from repro_torch.models.partitioned import CAPACITY, CONF

SEED = 0
SECTOR = 32                # bytes: the least a strided load moves from HBM
IMG = (8, 448, 448, 3)     # batch 8, paper Table III input
TABLE3 = (448, 448, 64)    # paper Table III feature map
EDSR_IMG = (8, 224, 224, 3)  # EDSR x2: batch 8 -> (8, 448, 448, 3)
# ESPCN x3 on one 640x360 frame -> 1920x1080 (the ESPCN paper's 1080p
# video setting, Shi et al. CVPR 2016)
ESPCN_IMG = (1, 360, 640, 3)
# Phi-4-mini 3.8B served at batch 8, 1024-token prompts, 64 generated
# tokens: a 1088-row KV cache; the flash rows' shapes
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 64
PARTIAL_BLOCKS = 4   # row blocks of the cache for flash_decode_partial
# the loss at the train cell's shape: 4 x 1024 positions over Qwen1.5-MoE's
# 151936-token vocabulary, bf16 logits drawn N(0, 1)
XENT_ROWS, XENT_VOCAB = 4096, 151936


def log(msg: str) -> None:
    print(msg, flush=True)


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


def row(name: str, source: str, replaces: str, shape: str, err: float,
        nbytes: float, call, plain, library=None, *, f32_ops: float = 0,
        bf16_ops: float = 0, iters: int = 20, plain_iters: int = 20,
        plain_warmup: int = 3) -> dict:
    """A row of the table, its kernel already checked: ``call`` timed in a
    CUDA graph of ``iters`` launches and per call, ``plain`` per call,
    ``library`` (one PyTorch call of the same function, if any) in a CUDA
    graph, beside the bound of ``nbytes`` and the operation counts."""
    bound, by = bound_ms(nbytes, f32_ops, bf16_ops)
    return dict(
        name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
        replaces=replaces, max_abs_err=err, ms=graph_ms(call, iters),
        call_ms=events_ms(call, iters),
        plain_ms=events_ms(plain, plain_iters, plain_warmup),
        bound_ms=bound, bound_by=by,
        library_ms=None if library is None else graph_ms(library, iters),
        shape=shape)


def summary(r: dict) -> str:
    """One log line of a row's numbers."""
    return (f"kernel {r['name']:17s} {r['shape']}: {r['ms']:.4f} ms device "
            f"({r['call_ms']:.4f} per call with host work; plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, library "
            f"{r['library_ms']}) max|err| {r['max_abs_err']}")


def dt(dtype: torch.dtype) -> str:
    """``f32``, ``bf16`` or the dtype's own name."""
    return {torch.float32: "f32", torch.bfloat16: "bf16"}.get(
        dtype, str(dtype).removeprefix("torch."))


def _gen() -> torch.Generator:
    return torch.Generator().manual_seed(SEED)


def _rand(shape, dev, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=gen).to(dev)


def _neck_sig(dtype: torch.dtype = torch.float32) -> ch.ChainSig:
    """The YOLOv3-Tiny neck as one chain: u (8, 14, 14, 128) upsample x2,
    then Route with the skip map (8, 28, 28, 128) -> (8, 28, 28, 256)."""
    batch = (IMG[0],)
    up = af.batch_extend_map(af.upsample_map((14, 14, 128), 2), batch)
    route = tuple(af.batch_extend_map(m, batch) for m in
                  af.route_maps([(28, 28, 128), (28, 28, 128)]))
    return ch.ChainSig(links=((up, None),), route_maps=route, route_band=0,
                       dtype=str(dtype).removeprefix("torch."))


def detect_records(dev) -> torch.Tensor:
    """YOLO head 2's record streams: batch 8, 28 * 28 * 3 rows of 85."""
    return torch.randn((IMG[0], 2352, 85), generator=_gen()).to(dev)


def _scanned(keep: torch.Tensor, capacity: int) -> torch.Tensor:
    """Rows of each stream a compaction's walk reads, ``keep`` (B, N) its
    rows that pass: up to the one that fills the buffer, or all N."""
    full = keep.sum(-1) >= capacity
    stop = (keep.cumsum(-1) < capacity).sum(-1) + (1 if capacity else 0)
    return torch.where(full, stop, keep.shape[-1])


def _rounds(scanned: torch.Tensor, n: int) -> str:
    """The scan rounds each stream took: the walk stops after the round in
    which the count reaches the capacity (or at the stream's end)."""
    taken = [-(-s // rg.ROUND_ROWS) for s in scanned.tolist()]
    return (f"scan rounds of {rg.ROUND_ROWS} rows per stream {taken} "
            f"(a {n}-row stream is {-(-n // rg.ROUND_ROWS)})")


def conv_mag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum |x w| of an NHWC SAME conv (stride 1) in float64: the scale of
    its rounding bound 2 gamma_K sum |x w| (K = kh kw C)."""
    from repro_torch.models.cnn import conv2d_nhwc
    return conv2d_nhwc(x.double().abs(), w.double().abs(), 1, "SAME")


def shuffle(y: torch.Tensor, s: int) -> torch.Tensor:
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


def sdpa_call(q, k, v, **kw):
    """One PyTorch call of the same attention (the yardstick only): SDPA
    on (B, H, S, D) views, the GQA grouping by ``enable_gqa``."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  enable_gqa=True, **kw)


# ---------------------------------------------------------------------------
# one kernel at any shape
# ---------------------------------------------------------------------------

def block_case(name: str, x, m, library) -> dict:
    """tm_affine_block of ``x`` by the block-mode map ``m``, bit-exact
    against its plain version, beside ``library(x)`` (one PyTorch copy of
    the same map); its path and bytes per access logged."""
    plan = ta.analyze_block_mode(m)
    got, ref = ta.tm_affine_block(x, m, plan), ta.block_plain(x, m, plan)
    require_equal(got, ref, f"tm_affine_block {name} {dt(x.dtype)}")
    regs = ta._block_regs(m, plan, x.dtype, x.device)
    r = row("tm_affine_block", "tm_affine.cu",
            "src/repro/kernels/tm_affine/tm_affine.py:203",
            f"{name} {'x'.join(map(str, x.shape))} {dt(x.dtype)}",
            max_abs_err(got, ref), (x.numel() + got.numel()) * x.element_size(),
            lambda: ta.tm_affine_block(x, m, plan),
            lambda: ta.block_plain(x, m, plan), lambda: library(x))
    log(f"kernel tm_affine_block {r['shape']}: path {regs.path}, "
        f"{regs.vbytes} B per access; {r['ms'] / r['bound_ms']:.2f}x its "
        f"bound")
    return r


def gather_case(name: str, x, m, library=None) -> dict:
    """tm_affine_gather of ``x`` by ``m``, bit-exact against its plain
    version; its plan logged (separable with its run, or general, and the
    bytes an access, which an ``x`` off 16-byte alignment cuts)."""
    launch = ta.gather_launch(m, x)
    plan = ta.separable_plan(m, x.element_size())
    got, ref = ta.tm_affine_gather(x, m), ta.gather_plain(x, m)
    require_equal(got, ref, f"tm_affine_gather {name} {dt(x.dtype)}")
    aligned = x.data_ptr() % 16 == 0
    r = row("tm_affine_gather", "tm_affine.cu",
            "src/repro/kernels/tm_affine/tm_affine.py:256",
            f"{name} {'x'.join(map(str, x.shape))} {dt(x.dtype)}"
            f"{'' if aligned else ' x off 16 B'}", max_abs_err(got, ref),
            (x.numel() + got.numel()) * x.element_size(),
            lambda: ta.tm_affine_gather(x, m), lambda: ta.gather_plain(x, m),
            library, iters=10, plain_iters=5)
    run = (f"run R {plan.R} from axis {plan.suffix}"
           if plan is not None else "no separable run")
    log(f"kernel tm_affine_gather {r['shape']} -> {tuple(got.shape)}: path "
        f"{launch.path}, {run}, {launch.vbytes} B per access; "
        f"{r['bound_ms'] / r['ms']:.2f} of its bound")
    return r


def conv_case(name: str, x, w, stride: int = 1) -> dict:
    """The implicit-GEMM conv of ``x`` (H, W, C) by ``w`` (3, 3, C, N), pad
    1, within 2 gamma_K sum |x w| of its plain version (bf16 one bf16 ulp
    more), beside ``F.conv2d`` (cuDNN, f32); its plan and its FMA loop alone
    (the same tiles and K steps over operands already in shared memory)
    logged."""
    got, ref = ik.conv2d(x, w, stride, 1), ik.conv2d_plain(x, w, stride, 1)
    tol = conv_tol(x, w, stride, 1)
    if x.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(ref)
    require_within(got, ref, tol, f"conv2d {name} {dt(x.dtype)}")
    ops = 2 * got[..., 0].numel() * w.numel()
    xn, wn = x.permute(2, 0, 1)[None].float(), w.permute(3, 2, 0, 1).float()
    r = row("conv2d", "img2col.cu", "src/repro/kernels/img2col/img2col.py:130",
            f"{name} {tuple(x.shape)} x {tuple(w.shape)} pad 1"
            f"{f' stride {stride}' if stride > 1 else ''} {dt(x.dtype)}, "
            f"{ops / 1e9:.3f} GFLOP", max_abs_err(got, ref),
            (x.numel() + w.numel() + got.numel()) * x.element_size(),
            lambda: ik.conv2d(x, w, stride, 1),
            lambda: ik.conv2d_plain(x, w, stride, 1),
            lambda: F.conv2d(xn, wn, stride=stride, padding=1), f32_ops=ops)
    plan = ik.conv2d_plan(x, w, stride, 1)
    fma = graph_ms(lambda: ik.conv2d_fma_probe(x, w, stride, 1))
    log(f"kernel conv2d {r['shape']}: {plan} (rounds {plan.rounds}, last "
        f"round {plan.last_fill:.3f} full); {r['ms'] / r['bound_ms']:.2f}x "
        f"its bound; the FMA loop alone (no loads) {fma:.4f} ms = "
        f"{ops / 1e9 / fma:.1f} TFLOP/s, "
        f"{ops / 1e9 / fma / (F32_FLOP_PER_S / 1e12):.3f} of 67")
    return r


def matmul_case(name: str, x, w, ep) -> dict:
    """matmul_tm of ``x`` (M, K) by ``w`` (K, N) through the store ``ep``,
    within 2 gamma_K sum |x w| of its plain version (bf16 one bf16 ulp
    more), beside ``torch.mm`` (the product without the TM store); its plan
    logged."""
    got, ref = mk.matmul_tm(x, w, ep), mk.matmul_tm_plain(x, w, ep)
    (M, K), N = x.shape, w.shape[1]
    mag = x.double().abs() @ w.double().abs()
    if ep.mode == "transpose":
        mag = mag.T
    elif ep.mode == "pixel_shuffle":
        mag = shuffle(mag.reshape(1, ep.H, ep.W, -1), ep.s)[0]
    tol = 2 * gamma(K) * mag
    if x.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(ref)
    require_within(got, ref, tol, f"matmul_tm {ep.mode} {dt(x.dtype)}")
    plan = mk.mm_plan(M, K, N, x.dtype, x.data_ptr() % 16 == 0)
    r = row("matmul_tm", "matmul_tm.cu",
            "src/repro/kernels/matmul_tm/matmul_tm.py:85",
            f"{name} ({M}, {K}) x ({K}, {N}) -> "
            f"{ep.mode.replace('_', ' ')} {tuple(got.shape)} {dt(x.dtype)}",
            max_abs_err(got, ref),
            (x.numel() + w.numel() + got.numel()) * x.element_size(),
            lambda: mk.matmul_tm(x, w, ep), lambda: mk.matmul_tm_plain(x, w, ep),
            lambda: torch.mm(x, w), f32_ops=2 * M * N * K, iters=10,
            plain_iters=5)
    log(f"kernel matmul_tm {r['shape']}: A stages by {plan.path}, tiles BM "
        f"{plan.BM} x BN {plan.BN}; {r['ms'] / r['bound_ms']:.2f}x its bound")
    return r


def commit_case(name: str, sig, g, x, w, tol) -> dict:
    """xchain_commit of the product ``g`` of ``x`` and ``w`` through the
    chain ``sig``, within ``tol`` of its plain version (bf16 one bf16 ulp
    more); its plan and each of its two phases alone (the product, or the
    chain over the scratch; the grid-wide barrier between) logged."""
    got = xc.xchain_commit(sig, g, x, w)
    ref = xc.xchain_commit_plain(sig, g, x, w)
    if x.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(ref)
    require_within(got, ref, tol, f"xchain_commit {name} {dt(x.dtype)}")
    r = row("xchain_commit", "xchain_commit.cu",
            "src/repro/kernels/matmul_tm/chain.py:222", f"{name} {dt(x.dtype)}",
            max_abs_err(got, ref),
            (x.numel() + w.numel() + got.numel()) * x.element_size(),
            lambda: xc.xchain_commit(sig, g, x, w),
            lambda: xc.xchain_commit_plain(sig, g, x, w), f32_ops=g.flops(),
            iters=10, plain_iters=10)
    product, walk = (graph_ms(lambda: xc.xchain_commit_phase(
        sig, g, x, w, phase), iters=10) for phase in ("product", "chain"))
    plan = xc.xchain_commit_card_plan(g, x)
    log(f"kernel xchain_commit {r['shape']}: {plan} (rounds {plan.rounds}, "
        f"last round {plan.last_fill:.3f} full), scratch {g.out_shape}; "
        f"{r['ms']:.4f} ms, {r['ms'] / r['bound_ms']:.2f}x its bound; the "
        f"kernel with one phase: product {product:.4f}, chain {walk:.4f}")
    return r


def prologue_inputs(dev, dtype: torch.dtype = torch.float32, k: int = 1):
    """The YOLOv3-Tiny neck (:func:`_neck_sig`) into a k x k conv to 255
    (SAME): ``(sig, g, u, skip, w)``, values in [0, 1), w in +-1/16."""
    gen = _gen()
    sig = _neck_sig(dtype)
    u = _rand(sig.links[0][0].in_shape, dev, gen).to(dtype)
    skip = _rand(sig.route_maps[1].in_shape, dev, gen).to(dtype)
    w = ((torch.rand((k, k, 256, 255), generator=gen) - 0.5) / 8).to(
        dev, dtype)
    g = xc.Gemm("conv", (8, 28, 28, 256), tuple(w.shape), 1, "SAME")
    return sig, g, u, skip, w


def prologue_case(name: str, sig, g, u, skip, w) -> dict:
    """xchain_prologue of :func:`prologue_inputs`, within 2 gamma_K
    sum |x w| of its plain version (bf16 one bf16 ulp more); its plan and
    each of its two phases alone (the chain into the scratch, or the
    product over it) and the same work split in two calls logged."""
    got = xc.xchain_prologue(sig, g, 0, u, w, (skip,))
    ref = xc.xchain_prologue_plain(sig, g, 0, u, w, (skip,))
    cat = torch.cat([u.repeat_interleave(2, 1).repeat_interleave(2, 2),
                     skip], -1)
    tol = 2 * gamma(g.words()[3]) * conv_mag(cat, w)
    if u.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(ref)
    require_within(got, ref, tol, f"xchain_prologue {name} {dt(u.dtype)}")
    r = row("xchain_prologue", "xchain_prologue.cu",
            "src/repro/kernels/matmul_tm/chain.py:312", f"{name} {dt(u.dtype)}",
            max_abs_err(got, ref),
            (u.numel() + skip.numel() + w.numel() + got.numel())
            * u.element_size(),
            lambda: xc.xchain_prologue(sig, g, 0, u, w, (skip,)),
            lambda: xc.xchain_prologue_plain(sig, g, 0, u, w, (skip,)),
            f32_ops=g.flops())
    walk, product = (graph_ms(lambda: xc.xchain_prologue_phase(
        sig, g, 0, u, w, phase, (skip,))) for phase in ("chain", "product"))
    plan = xc.xchain_prologue_card_plan(g, cat)
    # the same work split: tm_chain, then the product through the port's
    # own conv2d (1x1: what the one launch has to beat) or the library's
    # call (TF32 off)
    C, k = w.shape[2], w.shape[0]
    if k == 1:
        w2 = w.reshape(C, -1)
        lib = graph_ms(lambda: torch.mm(ch.tm_chain(sig, u, (skip,))
                                        .reshape(-1, C), w2))
        mm = graph_ms(lambda: torch.mm(cat.reshape(-1, C), w2))
        ported = graph_ms(lambda: ik.conv2d(ch.tm_chain(sig, u, (skip,))
                                            .reshape(-1, 1, C), w))
        split = (f"tm_chain + conv2d {ported:.4f} (the one launch "
                 f"{'beats' if r['ms'] < ported else 'does not beat'} it), "
                 f"tm_chain + torch.mm {lib:.4f} (torch.mm alone {mm:.4f})")
    else:
        wn = w.permute(3, 2, 0, 1)
        lib = graph_ms(lambda: F.conv2d(ch.tm_chain(sig, u, (skip,))
                                        .permute(0, 3, 1, 2), wn,
                                        padding=k // 2))
        split = f"tm_chain + F.conv2d {lib:.4f}"
    log(f"kernel xchain_prologue {r['shape']}: {plan} (rounds "
        f"{plan.rounds}, last round {plan.last_fill:.3f} full), scratch "
        f"{tuple(cat.shape)}; {r['ms']:.4f} ms, "
        f"{r['ms'] / r['bound_ms']:.2f}x its bound; the kernel with one "
        f"phase: chain {walk:.4f}, product {product:.4f}; split {split}")
    return r


def prefill_case(dev, dtype: torch.dtype, B: int = LM_BATCH,
                 S: int = LM_PROMPT, H: int = 24, KV: int = 8,
                 D: int = 128) -> dict:
    """flash_attention causal, q (B, S, H, D) against k/v (B, S, KV, D)
    drawn from the seed, within fp_bounds.attention_tol of its plain
    version, with its achieved rate and its ratio to SDPA's time; the
    defaults are Phi-4-mini's prefill at batch 8."""
    bf16 = dtype == torch.bfloat16
    name = "flash_attention" if bf16 else "flash_attention_f32"
    gen = _gen()
    q, k, v = (torch.randn((B, S, n, D), generator=gen).to(dev, dtype)
               for n in (H, KV, KV))
    got = fa.flash_attention(q, k, v, causal=True)
    ref = fa.attention_ref(q, k, v, causal=True)
    require_within(got, ref, attention_tol(q, k, v, causal=True),
                   f"{name} ({B}, {S}, {D})")
    sdpa = sdpa_call(q, k, v, is_causal=True)
    sdpa_err = max_abs_err(sdpa().transpose(1, 2), got)
    flops = 4 * B * H * D * (S * S + S) // 2
    r = row(name, "flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:79",
            f"causal q ({B}, {S}, {H}, {D}) k/v ({B}, {S}, {KV}, {D}) "
            f"{str(dtype).removeprefix('torch.')}", max_abs_err(got, ref),
            (2 * q.numel() + 2 * k.numel()) * q.element_size(),
            lambda: fa.flash_attention(q, k, v),
            lambda: fa.attention_ref(q, k, v), sdpa,
            bf16_ops=flops if bf16 else 0, f32_ops=0 if bf16 else flops,
            iters=10 if bf16 else 3, plain_iters=3, plain_warmup=1)
    ms, lib = r["ms"], r["library_ms"]
    log(f"kernel {name} {r['shape']}: {flops / 1e9:.2f} GFLOP in {ms:.4f} ms "
        f"= {flops / ms / 1e9:.1f} TFLOP/s (bound {r['bound_ms']:.4f} ms); "
        f"SDPA {lib:.4f} ms, kernel / SDPA {ms / lib:.2f}; SDPA vs the "
        f"kernel {sdpa_err}")
    return r


def decode_inputs(dev, B: int = LM_BATCH, T: int = LM_PROMPT + LM_GEN,
                  H: int = 24, KV: int = 8, D: int = 128,
                  length: int = LM_PROMPT + 1):
    """A decode step, q (B, 1, H, D) against a (B, T, KV, D) bf16 cache at
    ``length`` (on the device as ``n``), drawn from the seed:
    ``(q, k, v, length, n)``; the defaults are Phi-4-mini's at batch 8."""
    gen = _gen()
    q = torch.randn((B, 1, H, D), generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn((B, T, KV, D), generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    return q, k, v, length, torch.tensor([length], dtype=torch.int32,
                                         device=dev)


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------

def block_row(dev) -> dict:
    """#1: tm_affine_block's transpose of the Table III map, 448x448x64
    f32 (the vector path); HWC -> CHW f32 (the tile path) and the int8
    transpose (16-byte vectors of 16 elements) logged beside it."""
    gen = _gen()
    x = _rand(TABLE3, dev, gen)
    xi = torch.randint(-128, 128, TABLE3, generator=gen,
                       dtype=torch.int8).to(dev)
    m = af.transpose_map(TABLE3)
    r = block_case("transpose", x, m,
                   lambda t: t.permute(1, 0, 2).contiguous())
    log(summary(block_case("HWC->CHW", x, af.axis_permutation_map(
        TABLE3, (2, 0, 1)), lambda t: t.permute(2, 0, 1).contiguous())))
    log(summary(block_case("transpose", xi, m,
                           lambda t: t.permute(1, 0, 2).contiguous())))
    return r


def gather_row(dev) -> dict:
    """#2: tm_affine_gather's upsample x2 of the Table III map, 448x448x64
    f32, against its plain version, the index gather and F.interpolate
    (nearest, channels-last: its library call); the pixel shuffle, pixel
    unshuffle and rearrange maps of Table III logged beside it."""
    from repro_torch.core.engine import gather_indices
    m = af.upsample_map(TABLE3, 2)
    x = _rand(TABLE3, dev, _gen())
    flat = gather_indices(m, dev)[0].reshape(-1)
    xf = x.reshape(-1)
    require_equal(xf[flat].reshape(m.out_shape), ta.gather_plain(x, m),
                  "upsample index")
    # the same upsample in one PyTorch call: x as a channels-last NCHW view
    xcl = x.permute(2, 0, 1).unsqueeze(0)

    def interp():
        return F.interpolate(xcl, scale_factor=2, mode="nearest")

    require_equal(interp()[0].permute(1, 2, 0), ta.tm_affine_gather(x, m),
                  "upsample interpolate")
    index_ms = graph_ms(lambda: xf[flat], iters=10)
    r = gather_case("upsample x2", x, m, interp)
    log(f"kernel tm_affine_gather upsample: library F.interpolate nearest "
        f"(channels-last) {r['library_ms']:.4f} ms, x.flatten()[index] "
        f"{index_ms:.4f} ms")
    xr = _rand((448, 448, 3), dev, torch.Generator().manual_seed(SEED + 1))
    for name, xx, mm in (
            ("pixel shuffle x2", x, af.pixel_shuffle_map(TABLE3, 2)),
            ("pixel unshuffle x2", x, af.pixel_unshuffle_map(TABLE3, 2)),
            ("rearrange 3 -> 16", xr, af.rearrange_map((448, 448, 3), 1, 16))):
        log(summary(gather_case(name, xx, mm)))
    return r


def evaluate_case(recs, capacity: int) -> dict:
    """rme_evaluate of the f32 record streams ``recs`` (B, N, D), score in
    column 4 against CONF, at most ``capacity`` rows kept a stream,
    bit-exact against its plain version; its bound is what this run's data
    needs, its scan rounds are logged."""
    got = rg.rme_evaluate(recs, CONF, capacity, score_index=4)
    ref = rg.evaluate_plain(recs, CONF, capacity, score_index=4)
    for g, r, what in zip(got, ref, ("rows", "idx", "count")):
        require_equal(g, r, f"rme_evaluate {what}")
    B, N, D = recs.shape
    cnt, scanned = ref[2].long(), _scanned(recs[..., 4] >= CONF, capacity)
    # a score sits a record (D * 4 bytes) from the next, so each scanned
    # row that is not kept costs one sector; a kept row is read whole; the
    # packed output is written
    nbytes = (int(((scanned - cnt) * SECTOR + cnt * D * 4).sum())
              + B * (capacity * D * 4 + capacity * 4 + 4))
    shape = f"{tuple(recs.shape)} f32 cap {capacity}"
    log(f"kernel rme_evaluate {shape}: {_rounds(scanned, N)}")
    return row("rme_evaluate", "rme_gather.cu",
               "src/repro/kernels/rme_gather/rme_gather.py:105",
               f"{shape}, {int(cnt.sum())} kept",
               max(max_abs_err(g, r) for g, r in zip(got, ref)), nbytes,
               lambda: rg.rme_evaluate(recs, CONF, capacity, score_index=4),
               lambda: rg.evaluate_plain(recs, CONF, capacity,
                                         score_index=4))


def assemble_case(recs, mask, capacity: int) -> dict:
    """rme_assemble of the record streams ``recs`` (B, N, D) under ``mask``
    (B, N), at most ``capacity`` rows kept a stream, bit-exact against its
    plain version; its bound is what this run's data needs, its scan
    rounds are logged."""
    got = rg.rme_assemble(recs, mask, capacity)
    ref = rg.assemble_plain(recs, mask, capacity)
    for g, r, what in zip(got, ref, ("rows", "count")):
        require_equal(g, r, f"rme_assemble {what}")
    B, N, D = recs.shape
    cnt, scanned = ref[1].long(), _scanned(mask, capacity)
    size = recs.element_size()
    # one mask byte a scanned row, a kept row read whole; the packed rows
    # and the count written
    nbytes = (int((scanned + cnt * D * size).sum())
              + B * (capacity * D * size + 4))
    shape = f"{tuple(recs.shape)} {dt(recs.dtype)} cap {capacity}"
    log(f"kernel rme_assemble {shape}: {_rounds(scanned, N)}")
    return row("rme_assemble", "rme_gather.cu",
               "src/repro/kernels/rme_gather/rme_gather.py:222",
               f"{shape}, {int(cnt.sum())} kept",
               max(max_abs_err(g, r) for g, r in zip(got, ref)), nbytes,
               lambda: rg.rme_assemble(recs, mask, capacity),
               lambda: rg.assemble_plain(recs, mask, capacity))


def evaluate_row(dev) -> dict:
    """#4-#5: :func:`evaluate_case` at YOLO head 2's detect tail,
    (8, 2352, 85) f32, capacity 256."""
    return evaluate_case(detect_records(dev), CAPACITY)


def chain_row(dev, dtype: torch.dtype = torch.float32, off: int = 0) -> dict:
    """#3: tm_chain at the YOLOv3-Tiny neck (:func:`_neck_sig`), against its
    plain version and upsample + concatenate, with its run plan; the row
    is f32 on aligned operands, ``off`` elements moves u off 16-byte
    alignment (accesses of one element)."""
    gen = _gen()
    sig = _neck_sig(dtype)
    plan = ch.chain_plan_of(sig)
    n = math.prod(sig.links[0][0].in_shape)
    buf = (torch.rand(n + 16, generator=gen) * 100).to(dev, dtype)
    u0 = buf[off:off + n].view(sig.links[0][0].in_shape)
    skip = (torch.rand(sig.route_maps[1].in_shape, generator=gen)
            * 100).to(dev, dtype)
    got = ch.tm_chain(sig, u0, (skip,))
    ref = ch.chain_plain(u0, plan, (skip,))
    require_equal(got, ref, f"tm_chain {dt(dtype)} off {off}")
    require_equal(got, torch.cat([u0.repeat_interleave(2, 1)
                                  .repeat_interleave(2, 2), skip], -1),
                  "tm_chain vs upsample + concatenate")
    nbytes = (u0.numel() + skip.numel() + got.numel()) * u0.element_size()
    consts = sum(a.nbytes for a in [plan.j]
                 + [a for lv in plan.levels for a in (lv.mask, lv.p)
                    if a is not None]
                 + [a for ex in plan.extras for a in (ex.idx, ex.mask)
                    if a is not None])
    rp = ch.build_run_plan(sig)
    table, outer = rp.table_bytes, rp.outer_bytes
    log(f"kernel tm_chain {dt(dtype)} off {off}: {nbytes} bytes of data; run "
        f"tables {table} bytes (staged per block) + {outer} bytes per-run "
        f"tables = {table + outer} bytes read in place of {consts} bytes of "
        f"full pullback constants (neither in the bound); runs of R = "
        f"{rp.run}, {rp.vec if off == 0 else 1} element(s) an access; "
        f"{len(plan.levels)} level(s), {len(plan.extras)} extra band(s)")
    if table + outer >= 64 * 1024:
        raise AssertionError(f"tm_chain: {table + outer} bytes of run tables "
                             f"at the neck, expected under 64 KB")
    return row("tm_chain", "tm_chain.cu",
               "src/repro/kernels/tm_affine/chain.py:340",
               "neck upsample x2 (8, 14, 14, 128) + Route (8, 28, 28, 128) "
               f"{dt(dtype)}{f', u {off} element(s) off' if off else ''}",
               max_abs_err(got, ref), nbytes,
               lambda: ch.tm_chain(sig, u0, (skip,)),
               lambda: ch.chain_plain(u0, plan, (skip,)))


def chained_evaluate_row(dev) -> dict:
    """#6: rme_evaluate_chained at head 2's detect tail: the raw grid
    (8, 28, 28, 255) pulled back as (8, 2352, 85) record streams."""
    m = af.batch_extend_map(af.reshape_map((28, 28, 255), (2352, 85)),
                            (IMG[0],))
    j, ok, fill = ch.fold_pullback((m,))
    idx = torch.from_numpy(j.reshape(m.out_shape)).to(dev)
    ok = None if ok is None else torch.from_numpy(
        ok.reshape(m.out_shape)).to(dev)
    pred = torch.randn(m.in_shape, generator=_gen()).to(dev)

    def call():
        return rg.rme_evaluate_chained(pred, idx, ok, fill, CONF, CAPACITY,
                                       score_index=4)

    def plain():
        return rg.evaluate_chained_plain(pred, idx, ok, fill, CONF, CAPACITY,
                                         score_index=4)

    got, ref = call(), plain()
    unchained = rg.evaluate_plain(pred.reshape(m.out_shape), CONF, CAPACITY,
                                  score_index=4)
    for g, r, u, what in zip(got, ref, unchained, ("rows", "idx", "count")):
        require_equal(g, r, f"rme_evaluate_chained {what}")
        require_equal(g, u, f"rme_evaluate_chained {what} vs unchained")
    B, N, D = m.out_shape
    cnt = ref[2].long()
    scanned = _scanned(pred.reshape(m.out_shape)[..., 4] >= CONF, CAPACITY)
    # a scanned, unkept row costs one sector of scores (and one of its
    # pullback index); a kept row is read whole (and its D indices)
    consts = int(((scanned - cnt) * SECTOR + cnt * D * 4).sum())
    nbytes = consts + B * (CAPACITY * D * 4 + CAPACITY * 4 + 4)
    log(f"kernel rme_evaluate_chained: {nbytes} bytes of data, {consts} "
        f"bytes of pullback index read (not in the bound), ok mask "
        f"{'none' if ok is None else 'present'}; {_rounds(scanned, N)}")
    return row("rme_evaluate_chained", "rme_gather.cu",
               "src/repro/kernels/rme_gather/rme_gather.py:176",
               f"(8, 28, 28, 255) -> (8, 2352, 85) f32 cap {CAPACITY}, "
               f"{int(cnt.sum())} kept",
               max(max_abs_err(g, r) for g, r in zip(got, ref)), nbytes,
               call, plain)


def assemble_row(dev) -> dict:
    """#7-#8: :func:`assemble_case` on :func:`evaluate_row`'s records under
    mask = score >= CONF, which is rme_evaluate's test, so the packed rows
    and counts must equal its as well."""
    recs = detect_records(dev)
    mask = recs[..., 4] >= CONF
    r = assemble_case(recs, mask, CAPACITY)
    got = rg.rme_assemble(recs, mask, CAPACITY)
    evaluated = rg.evaluate_plain(recs, CONF, CAPACITY, score_index=4)
    require_equal(got[0], evaluated[0], "rme_assemble rows vs rme_evaluate")
    require_equal(got[1], evaluated[2], "rme_assemble count vs rme_evaluate")
    return r


def img2col_row(dev) -> dict:
    """#11: img2col at Table III, (448, 448, 64) f32, 3x3 stride 1, no
    padding (overlapping slabs); the other dtypes are checked beside it,
    the 2x2 stride-2 case (#10) checked and logged as its own row."""
    x = _rand(TABLE3, dev, _gen())
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
    log(summary(row("img2col", "img2col.cu",
                    "src/repro/kernels/img2col/img2col.py:63",
                    "2x2 stride 2 (448, 448, 64) -> (50176, 256) f32", 0.0,
                    (x.numel() + s2.numel()) * 4,
                    lambda: ik.img2col(x, 2, 2, 2, 0),
                    lambda: ik.img2col_plain(x, 2, 2, 2, 0), lib2, iters=10,
                    plain_iters=3, plain_warmup=1)))
    del s2
    log(f"kernel img2col: int8, int32, bf16 at 3x3 s1 bit-exact; F.unfold "
        f"3x3 (columns channel-major, another layout) {unfold_ms:.4f} ms")
    return row("img2col", "img2col.cu",
               "src/repro/kernels/img2col/img2col.py:94",
               "3x3 stride 1 (448, 448, 64) -> (198916, 576) f32", err,
               nbytes, lambda: ik.img2col(x, 3, 3, 1, 0),
               lambda: ik.img2col_plain(x, 3, 3, 1, 0), lib3, iters=10,
               plain_iters=3, plain_warmup=1)


def conv2d_row(dev) -> dict:
    """#12: the implicit-GEMM conv at the EDSR body conv, (224, 224, 64) by
    (3, 3, 64, 64), pad 1, f32; EDSR's head (C = 3 -> 64, the cp.async
    path) and up conv (64 -> 12) in f32, and all three in bf16, checked and
    logged beside it."""
    gen = _gen()
    H, W = EDSR_IMG[1], EDSR_IMG[2]
    convs = []
    for name, cin, cout in (("EDSR head conv", 3, 64), ("EDSR up conv", 64, 12),
                            ("EDSR body conv", 64, 64)):
        x = _rand((H, W, cin), dev, gen)
        w = ((torch.rand((3, 3, cin, cout), generator=gen) - 0.5)
             * 0.1).to(dev)
        log(summary(conv_case(name, x.to(torch.bfloat16),
                              w.to(torch.bfloat16))))
        convs.append(conv_case(name, x, w))
    for r in convs[:-1]:
        log(summary(r))
    return convs[-1]


def resize_row(dev) -> dict:
    """#9: bilinear resize of the Table III map, (448, 448, 64) ->
    (224, 224, 64), f32 (timed) and bf16 (checked)."""
    x = _rand(TABLE3, dev, _gen())
    got = rk.resize_bilinear(x, 224, 224)
    ref = rk.resize_plain(x, 224, 224)
    require_within(got, ref, 1e-5, "resize f32")
    xb = x.to(torch.bfloat16)
    gb, rb = rk.resize_bilinear(xb, 224, 224), rk.resize_plain(xb, 224, 224)
    require_within(gb, rb, bf16_ulp(rb), "resize bf16")
    xn = x.permute(2, 0, 1)[None]

    def library():
        return F.interpolate(xn, size=(224, 224), mode="bilinear",
                             align_corners=False)

    log(f"kernel resize: f32 max |err| {max_abs_err(got, ref)} (tolerance "
        f"1e-5), bf16 {max_abs_err(gb, rb)} (one bf16 ulp); F.interpolate "
        f"vs the kernel {max_abs_err(library()[0].permute(1, 2, 0), got)}")
    return row("resize", "resize.cu",
               "src/repro/kernels/resize/resize.py:52",
               "(448, 448, 64) -> (224, 224, 64) f32", max_abs_err(got, ref),
               (x.numel() + got.numel()) * 4,
               lambda: rk.resize_bilinear(x, 224, 224),
               lambda: rk.resize_plain(x, 224, 224), library)


def matmul_tm_row(dev) -> dict:
    """#13: matmul_tm at ESPCN's last layer in im2col form: the
    (360, 640, 32) map's 3x3 patches (230400, 288) by the (288, 27)
    weights, stored through the pixel-shuffle epilogue as (1080, 1920, 3);
    the identity and transposed stores of the same product logged."""
    from repro_torch.kernels.img2col.ops import img2col_call
    e = espcn_setup(dev, _gen())
    (_, H, W, _), C, s = e["h"].shape, 3, 3
    patches = img2col_call(e["h"][0], kh=3, kw=3, stride=1, pad=1)
    w = e["model"].c3.reshape(-1, C * s * s).contiguous()
    name = "ESPCN last layer im2col"
    for mode in ("identity", "transpose"):
        log(summary(matmul_case(name, patches, w, mk.Epilogue(mode))))
    return matmul_case(name, patches, w,
                       mk.Epilogue("pixel_shuffle", H, W, C, s))


def xchain_commit_row(dev) -> dict:
    """#14: xchain_commit at ESPCN's crossing: the 3x3 conv of the
    (1, 360, 640, 32) map to 27 channels, through the PixelShuffle x3 chain
    into (1, 1080, 1920, 3)."""
    e = espcn_setup(dev, _gen())
    h, w = e["h"], e["model"].c3
    g = xc.Gemm("conv", tuple(h.shape), tuple(w.shape), 1, "SAME")
    m = af.batch_extend_map(af.pixel_shuffle_map(g.out_shape[1:], 3), (1,))
    sig = ch.ChainSig(links=((m, None),), dtype="float32")
    return commit_case(
        "ESPCN conv3 (1, 360, 640, 32) x (3, 3, 32, 27) -> PixelShuffle x3 "
        "(1, 1080, 1920, 3)", sig, g, h, w,
        2 * gamma(g.words()[3]) * shuffle(conv_mag(h, w), 3))


def xchain_prologue_row(dev) -> dict:
    """#15: :func:`prologue_case` at the YOLOv3-Tiny neck into head 2's 1x1
    conv (1, 1, 256, 255), f32."""
    return prologue_case("YOLO neck upsample (8, 14, 14, 128) + Route "
                         "(8, 28, 28, 128) -> head2 1x1 conv (1, 1, 256, "
                         "255)", *prologue_inputs(dev))


def flash_attention_row(dev) -> dict:
    """#16: :func:`prefill_case` at the Phi-4-mini prefill in bf16, on the
    tensor cores."""
    return prefill_case(dev, torch.bfloat16)


def flash_attention_f32_row(dev) -> dict:
    """16 f32: :func:`prefill_case` in f32 (the FMA kernel, off the LM's
    bf16 path: a row of the log's table, not of the ``kernels`` line)."""
    return prefill_case(dev, torch.float32)


def flash_decode_row(dev, **shape) -> dict:
    """#17: flash_decode at :func:`decode_inputs` (``shape``: its keyword
    arguments), within fp_bounds.attention_tol of its plain version, with
    its achieved rate, its split and its ratio to SDPA over the live
    rows."""
    q, k, v, length, n = decode_inputs(dev, **shape)
    (B, _, H, D), (T, KV) = q.shape, k.shape[1:3]
    got = fa.flash_decode(q, k, v, n)
    ref = fa.decode_ref(q, k, v, length)
    require_within(got, ref, attention_tol(q, k, v, causal=False,
                                           length=length), "flash_decode")
    sdpa = sdpa_call(q, k[:, :length], v[:, :length])
    log(f"kernel flash_decode: SDPA vs the kernel "
        f"{max_abs_err(sdpa().transpose(1, 2), got)}")
    nbytes = (2 * B * length * KV * D + 2 * q.numel()) * 2
    r = row("flash_decode", "flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:144",
            f"q ({B}, 1, {H}, {D}) vs cache ({B}, {T}, {KV}, {D}) bf16 at "
            f"length {length}", max_abs_err(got, ref), nbytes,
            lambda: fa.flash_decode(q, k, v, n),
            lambda: fa.decode_ref(q, k, v, n), sdpa,
            bf16_ops=4 * B * H * D * length)
    ms, lib = r["ms"], r["library_ms"]
    split_rows, splits = fa.decode_plan(B, T, H, KV, dev, torch.bfloat16)
    log(f"kernel flash_decode: {nbytes / 1e6:.2f} MB in {ms:.4f} ms = "
        f"{nbytes / ms / 1e9:.3f} TB/s (peak 3.35, bound "
        f"{r['bound_ms']:.4f} ms; {splits} splits of {split_rows} rows); "
        f"SDPA {lib:.4f} ms, kernel / SDPA {ms / lib:.2f}")
    return r


def flash_decode_partial_row(dev) -> dict:
    """17p: flash_decode_partial (#17's partial mode, the kernel of a
    decode over a cache whose rows lie over ranks) at :func:`decode_inputs`
    with the cache split into PARTIAL_BLOCKS row blocks, each block's local
    length on the device: each block's (o, lse) within attention_tol /
    decode_lse_tol of its plain version; the blocks combined
    (combine_partials) within #17's bound of the whole-cache flash_decode;
    one block's call timed against its byte bound and SDPA over the same
    block's live rows."""
    q, k, v, length, n = decode_inputs(dev)
    (B, _, H, D), (T, KV) = q.shape, k.shape[1:3]
    whole = fa.flash_decode(q, k, v, n)
    rows_b = T // PARTIAL_BLOCKS
    blocks, parts = [], []
    before = fa.flash_decode_partial.launches
    for b in range(PARTIAL_BLOCKS):
        kb, vb = (t[:, b * rows_b:(b + 1) * rows_b] for t in (k, v))
        nb = (n - b * rows_b).clamp(0, rows_b)   # on the device
        live = max(0, min(length - b * rows_b, rows_b))
        o, lse = fa.flash_decode_partial(q, kb, vb, nb)
        ro, rl = fa.decode_partial_ref(q, kb, vb, live)
        require_within(o, ro, attention_tol(q, kb, vb, causal=False,
                                            length=live),
                       f"flash_decode_partial block {b} o")
        require_within(lse, rl, decode_lse_tol(q, kb, live),
                       f"flash_decode_partial block {b} lse")
        blocks.append((kb, vb, nb, live))
        parts.append((o, lse, ro, rl))
    if fa.flash_decode_partial.launches - before != PARTIAL_BLOCKS:
        raise AssertionError(f"flash_decode_partial: "
                             f"{fa.flash_decode_partial.launches - before} "
                             f"launches for {PARTIAL_BLOCKS} blocks")
    comb = fa.combine_partials(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts]), q.dtype)
    require_within(comb, whole, attention_tol(q, k, v, causal=False,
                                              length=length),
                   "flash_decode_partial combined against flash_decode")
    kb, vb, nb, live = blocks[0]
    nbytes = (2 * B * live * KV * D + q.numel()) * 2 + B * H * (D + 1) * 4
    r = row("flash_decode_partial", "flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:144",
            f"q ({B}, 1, {H}, {D}) vs one of {PARTIAL_BLOCKS} blocks "
            f"({B}, {rows_b}, {KV}, {D}) bf16 of the cache at length "
            f"{length}",
            max(max(max_abs_err(p[0], p[2]), max_abs_err(
                p[1].masked_fill(p[1].isinf(), 0), p[3].masked_fill(
                    p[3].isinf(), 0))) for p in parts), nbytes,
            lambda: fa.flash_decode_partial(q, kb, vb, nb),
            lambda: fa.decode_partial_ref(q, kb, vb, nb),
            sdpa_call(q, kb[:, :live], vb[:, :live]),
            bf16_ops=4 * B * H * D * live)

    def every_block():
        got = [fa.flash_decode_partial(q, *blk[:3]) for blk in blocks]
        return fa.combine_partials(torch.stack([g[0] for g in got]),
                                   torch.stack([g[1] for g in got]), q.dtype)

    all_ms = events_ms(every_block)
    whole_ms = events_ms(lambda: fa.flash_decode(q, k, v, n))
    ms = r["ms"]
    log(f"kernel flash_decode_partial: one block of {rows_b} rows ({live} "
        f"live) {nbytes / 1e6:.2f} MB in {ms:.4f} ms = "
        f"{nbytes / ms / 1e9:.3f} TB/s (bound {r['bound_ms']:.4f} ms); SDPA "
        f"over the block {r['library_ms']:.4f} ms; the {PARTIAL_BLOCKS} "
        f"blocks and their combine {all_ms:.4f} ms a call against the "
        f"whole-cache flash_decode's {whole_ms:.4f}; max|err| combined "
        f"against it {max_abs_err(comb, whole)}")
    return r


def xent_row(dev) -> dict:
    """#19: the cross-entropy kernels at the train cell's shape against the
    plain loss on the same card tensors (``dnll`` the mean's 1 / rows):
    each row's nll within 1e-5 relative plus the rounding of lse at its
    magnitude, every gradient element within one bf16 ulp; ``xent_rows``
    and ``xent_grad`` each timed beside its bound (the logits read once
    each, the gradient written once), the plain version's forward and
    backward, and ``F.cross_entropy``'s forward and backward on the same
    bf16 logits (the library yardstick: the port never calls it)."""
    # the table may run under inference mode; the plain loss's gradient
    # needs autograd
    with torch.inference_mode(False):
        g = torch.Generator(device=dev).manual_seed(SEED)
        logits = torch.randn((XENT_ROWS, XENT_VOCAB), generator=g,
                             device=dev).to(torch.bfloat16)
        labels = torch.randint(0, XENT_VOCAB, (XENT_ROWS,), generator=g,
                               device=dev)
        dnll = torch.full((XENT_ROWS,), 1.0 / XENT_ROWS, device=dev)
        nll, mx, sm = xent.xent_rows(logits, labels)
        grad = xent.xent_grad(logits, labels, mx, sm, dnll)
        x = logits.clone().requires_grad_()
        want = xent.nll_plain(x, labels)
        (want_grad,) = torch.autograd.grad(want, [x], dnll)
        want = want.detach()
        nll_err = float(((nll - want).abs() / (1e-5 * want.abs()
                                               + 4 * U32 * mx.abs())).max())
        ulps = int(ulps_apart(grad, want_grad).max())
        log(f"kernel xent_rows + xent_grad: nll within {nll_err:.3g} of its "
            f"tolerance, the gradient {ulps} bf16 ulps from the plain "
            f"version's at most")
        if not (nll_err <= 1.0 and ulps <= 1):
            raise AssertionError(f"xent: nll {nll_err:.3g} of its "
                                 f"tolerance, gradient {ulps} ulps")
        del want_grad, grad
        fwd_ms = graph_ms(lambda: xent.xent_rows(logits, labels), iters=5)
        bwd_ms = graph_ms(lambda: xent.xent_grad(logits, labels, mx, sm,
                                                 dnll), iters=5)

        def kernels():
            _, m, s = xent.xent_rows(logits, labels)
            return xent.xent_grad(logits, labels, m, s, dnll)

        call_ms = events_ms(kernels, iters=10)
        plain_ms = events_ms(lambda: torch.autograd.grad(
            xent.nll_plain(x, labels), [x], dnll), iters=3, warmup=1)
        library_ms = events_ms(lambda: torch.autograd.grad(
            F.cross_entropy(x, labels, reduction="none"), [x],
            dnll.to(torch.bfloat16)), iters=3, warmup=1)
    elem = logits.numel() * logits.element_size()
    fwd_bound = bound_ms(elem + XENT_ROWS * (8 + 12))[0]
    bwd_bound = bound_ms(2 * elem + XENT_ROWS * (8 + 12))[0]
    log(f"kernel xent_rows {fwd_ms:.4f} ms (bound {fwd_bound:.4f}), "
        f"xent_grad {bwd_ms:.4f} ms (bound {bwd_bound:.4f}), both "
        f"{call_ms:.4f} ms per call; plain forward and backward "
        f"{plain_ms:.4f} ms, F.cross_entropy forward and backward "
        f"{library_ms:.4f} ms")
    return dict(
        name="xent_rows", route="cuda", source="src/repro_torch/csrc/xent.cu",
        replaces="none (the JAX package's loss is jnp)",
        max_abs_err=max_abs_err(nll, want), ms=fwd_ms + bwd_ms,
        call_ms=call_ms, plain_ms=plain_ms, bound_ms=fwd_bound + bwd_bound,
        bound_by="bytes", library_ms=library_ms,
        shape=f"xent_rows {fwd_ms:.4f} + xent_grad {bwd_ms:.4f} ms on "
              f"({XENT_ROWS}, {XENT_VOCAB}) bf16 logits; {ulps} ulps")


# the table's rows but #18 (AdamW, timed on a trained state by the train
# path's check), in the table's order
ROWS = (block_row, gather_row, evaluate_row, chain_row, chained_evaluate_row,
        assemble_row, img2col_row, conv2d_row, resize_row, matmul_tm_row,
        xchain_commit_row, xchain_prologue_row, flash_attention_row,
        flash_attention_f32_row, flash_decode_row, flash_decode_partial_row,
        xent_row)
