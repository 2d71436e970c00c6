#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (at first
use, into ``build/``, one ``nvcc`` per source, all at once), then runs its
phases and fails on any mismatch:

1. kernels  — every row of the kernel table but AdamW's
   (``repro_torch.tools.kernel_table.ROWS``): each kernel at the main
   path's shapes against its plain PyTorch version on the card, with its
   device time, its time per call with the wrapper's host work, the plain
   version's, its bound and the library call's, and what each row logs
   beside it (plans, paths, phases alone, the other dtypes);
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
6. slice 5, the LM serving loop: ``repro_torch.launch.serve.serve``
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
8. slice 12: YOLOv3-Tiny served under a seeded fault plan (12a) and
   ``DecodeSession`` on Phi-4-mini's full config, layer 0 (12b);
9. slice 13, the remaining model families: (13a) Qwen2-MoE-A2.7B at its
   full published config (all 24 layers, 60 routed experts padded to 64,
   top-4, 4 shared; random bf16 weights from seed 0) through ``serve`` on
   slice 5's traffic, batch 8, 1024-token prompts, 64 tokens: exactly 24
   ``rme_assemble`` launches a forward (the MoE dispatch, one launch a
   layer over the 512 record streams) and 24 / 24 x 63 flash launches; the
   flash kernels at its attention shape and the assemble kernel at its
   dispatch shape against their plain versions first; then the dispatch
   on the card bit-exact against its plain version at the prefill and
   decode shapes, layer 0 against a bf16 and an f32 plain run (slice 5's
   rule over the tokens routed alike, the routing decisions that differ
   at most MOE_FLIP_LIMIT), finite logits at every step and the greedy
   tokens' agreement with a bf16 plain run (reported); (13b) rwkv6-3b,
   zamba2-7b, internvl2-1b, musicgen-large at full depth and
   llama4-scout-17b-a16e at 4 of its 48 layers, full width, each through
   ``serve`` with batch 4, 512-token prompts, 16 tokens, freed before the
   next, its launches checked exactly (InternVL2 also prefills from
   ``vision_prefix`` of a patch grid; rwkv6 and zamba2 hold their step
   form against one prefill in f32), the flash kernels at each attention
   shape against their plain versions first;
10. slice 14, training: (14a) ``repro_torch.launch.train.train`` on
   Qwen2-MoE-A2.7B at full width (its published config, bf16, remat
   "full") cut to 4 of its 24 layers, batch 4 x 1024 tokens of
   ``SyntheticLM``, 6 steps at peak lr 1e-2: exactly 6 x 4 x 2
   ``rme_assemble`` launches (the MoE dispatch in each layer's forward and
   in its recompute), 6 of ``adamw_sumsq`` and of ``adamw_apply`` (the
   fused AdamW, one table of leaves a step), 6 of ``xent_rows`` and of
   ``xent_grad`` (the loss) and no other kernel (the train
   path runs the plain attention, as the reference trains); every loss
   finite and the last below the first; every parameter in bf16 after
   training; step ms, tokens/s, peak memory and the optimizer's share;
   then step 0 again from the same seed: its loss equal, bit for bit, to
   the path's and to the same forward with the plain dispatch, its
   gradient norm within 1e-2 of the plain one, the weights unchanged by it
   (lr 0 in warmup) and every leaf in bf16 after it; the fused AdamW
   against its plain version on the state's leaves up to 2^28 elements,
   and the optimizer timed beside its bound of 30 bytes a parameter, its
   plain version and ``torch.optim.AdamW(fused=True)``; (14b) the smoke config in f32 with int8
   gradient compression, checkpointed, restored bit for bit and resumed,
   its losses within 1e-3 of the same runs on the CPU, its checkpoints
   kept for 15b;
11. slice 15, distribution and the dry-run, on a (1, 1) ("data", "model")
   card mesh over a one-rank NCCL group: (15a) 14a's ``train()`` call with
   ``mesh=``: the state placed by the train rules, each batch split over
   the batch axes, every gradient redistributed to its parameter's
   placements; exactly 6 x 4 x 2 ``rme_assemble`` launches (through its
   sharding rule), 14a's AdamW launches (on each leaf's local shard) and no
   other kernel but the loss's two (its DTensor logits through
   ``local_map``, each rank's shard whole rows); steps 0-1's losses 14a's
   bit for bit, step 2 within MESH_STEP2_RTOL, steps 3-5 within
   MESH_LATE_RTOL
   (the run is chaotic there, 14a's own reruns differing by 5%); step ms
   beside 14a's; (15b)
   the 4-layer weights placed by ``reshard_state``, ``lm_loss`` on them
   under the train rules: 4 launches and one of ``xent_rows`` (no
   gradient is taken), the loss the plain forward's bit for bit, the
   weights back whole and placed again bit for bit, 14b's
   checkpoint restored onto the mesh with its spec tree bit for bit;
   (15d) Phi-4-mini at full width cut to 4 layers, batch 8, prefilled
   plainly into a 1088-row cache, then 8 decode steps on the card mesh
   under the decode rules (the cache's rows over "model"): exactly 4 x 8
   ``flash_decode_partial`` launches and no other kernel, the band
   written into the rank that owns the row, every step's logits and the
   final caches bit for bit the plain steps'; (15c) ``python -m
   repro_torch.launch.dryrun`` in a process of its own for each of
   qwen2-moe-a2.7b train_4k, phi4-mini-3.8b decode_32k and rwkv6-3b
   decode_32k on the single-pod mesh (256 ranks of a fake group) and
   zamba2-7b long_500k on the multi-pod one (512), each record printed
   (FLOPs and bytes > 0, the train cell's collectives > 0, each decode
   cell's all-gather under DECODE_GATHER_LIMIT bytes a device, its peak
   within the card's HBM and its step bound set by memory); then 14a's
   step traced on a (1, 1)
   mesh (the card cell), its matmul FLOPs within MATMUL_FLOPS_RTOL of
   FlopCounterMode over one real 14a step, its step-time bound beside the
   measured step;
12. the launch counts of each slice's path, read just after it ran with
   the counts set to 0 just before it: every kernel of the slice > 0; the
   ``kernels`` line gives each kernel its launches from the path of the
   slice that ported it.

The last three lines of standard output are the card's name and power
limit as nvidia-smi gives them, the ``{"kernels": [...]}`` line and
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or without the repository's ``src`` beside it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.fp_bounds import bf16_ulp, ulps_apart  # noqa: E402
from repro_torch.h100 import (bound_ms, card_line, events_ms,  # noqa: E402
                              graph_ms)
from repro_torch.tree import tree_map  # noqa: E402
from repro_torch.models.partitioned import (  # noqa: E402
    CAPACITY, CHAINED_PATHS, CONF, UNFUSED_PATHS, detect_program,
    edsr_partitioned_forward, eager_forward, partitioned_forward)
from repro_torch.tools import kernel_table  # noqa: E402
from repro_torch.tools.kernel_table import (  # noqa: E402
    EDSR_IMG, ESPCN_IMG, IMG, LM_BATCH, LM_GEN, LM_PROMPT, SEED, TABLE3,
    conv_mag, espcn_setup, log, max_abs_err, require_equal, require_within,
    shuffle)

N_CLASSES = 80
# partitioned EDSR vs the eager model: 18 stacked f32 convs (K <= 576)
# summed in other orders, and cuDNN may pick a transform algorithm; the
# residual branches are scaled by 0.1, so the errors stay near the f32
# rounding of one conv (about 1e-6 relative): 1e-4 of the output's largest
# magnitude leaves a factor of 100
EDSR_RTOL = 1e-4
# slice 5: Phi-4-mini 3.8B at full width (its published config), batch 8,
# 1024-token prompts, 64 generated tokens: a 1088-row KV cache
LM_ARCH = "phi4-mini-3.8b"
# the kernel path's logits may be at most 2x as far from the f32 plain run
# as the bf16 plain run is, plus LM_FLOOR_ULPS bf16 ulps of the step's
# largest |f32 logit| (two roundings of each logit, and one of its inputs
# either way)
LM_FLOOR_ULPS = 4


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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def _teacher_forced(cfg, params, prompts, toks, attention: str):
    """Prefill, then the decode steps fed ``toks`` (the kernel path's
    choices), with the family's KV caches and recurrent states: the
    last-position logits of every step, (gen, B, V) f32."""
    from repro_torch.models.transformer import init_caches, init_states
    from repro_torch.runtime.step import make_decode_step, make_prefill_step
    B, P = prompts.shape
    caches = init_caches(cfg, B, P + toks.shape[1], dtype=cfg.dtype,
                         device=prompts.device)
    states = init_states(cfg, B, device=prompts.device)
    lg, caches, states = make_prefill_step(cfg, attention=attention)(
        params, prompts, caches, states)
    out = [lg[:, -1].float()]
    decode = make_decode_step(cfg, attention=attention)
    for i, t in enumerate(range(P, P + toks.shape[1] - 1)):
        _, lg, caches, states = decode(params, toks[:, i:i + 1], caches,
                                       states, t)
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
    dev_ms = {k: events_ms(fn, iters=3, warmup=1) for k, fn in runs.items()}
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
    tol = 2 * gamma(3 * 3 * 32) * shuffle(conv_mag(e["h"], model.c3), 3)
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

    dev_f = events_ms(lambda: fused.run_phase(f_ph, env_f, backend="cuda"),
                    iters=10)
    dev_s = events_ms(split_tail, iters=10)
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
    tol = 2 * gamma(288) * shuffle(conv_mag(h, c3), 3)[0]
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
    tol = 2 * gamma(256) * conv_mag(cat, model.head2_w)
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
            tol2 = 2 * gamma(256) * conv_mag(cat, yolo.head2_w)
        else:
            eager = espcn(x)
            h = torch.tanh(cnn.conv2d(torch.tanh(cnn.conv2d(x, espcn.c1)),
                                      espcn.c2))
            tol = 2 * gamma(3 * 3 * 32) * shuffle(conv_mag(h, espcn.c3), 3)
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
               "blocks": tree_map(lambda t: t[:1].float(), params["blocks"])}
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


# ---------------------------------------------------------------------------
# slice 13: the remaining model families
# ---------------------------------------------------------------------------

# 13a: Qwen2-MoE-A2.7B at its full published config (all 24 layers, 60
# routed experts padded to 64, top-4, 4 shared), slice 5's traffic
MOE_ARCH = "qwen2-moe-a2.7b"
# the share of layer 0's routing decisions (each of a token's top-k expert
# choices) that may differ from the f32 run in the kernel path or the bf16
# plain run: a bf16 router score rounds to another value where an earlier
# sum took another order, and near-ties then flip
MOE_FLIP_LIMIT = 0.02
# 13b: the other five new archs at full published width through serve,
# batch 4, 512-token prompts, 16 tokens; llama4-scout's 48 layers (about
# 105 B parameters) do not fit one card, so it runs 4 of them
FAMILY_ARCHS = ("rwkv6-3b", "zamba2-7b", "internvl2-1b", "musicgen-large",
                "llama4-scout-17b-a16e")
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 4, 512, 16
LLAMA4_LAYERS = 4
# InternVL2's frontend: one InternViT patch grid a request
VISION_GRID = (FAMILY_BATCH, 32, 32, 1024)
# the serving steps of rwkv6 and zamba2 (the step form of the recurrence)
# against one prefill of the whole sequence (the chunked form), both in
# f32 on the same weights: the two sum in other orders through 32 or 81
# layers; within 1e-3 of the largest |logit|
RECUR_RTOL = 1e-3


@contextlib.contextmanager
def plain_dispatch():
    """MoE dispatch through its plain version for the plain reference runs
    (on a CUDA tensor ``dispatch_tokens`` launches the assemble kernel)."""
    from repro_torch.core import rme
    kernel = rme.dispatch_tokens
    rme.dispatch_tokens = rme.dispatch_tokens_plain
    try:
        yield
    finally:
        rme.dispatch_tokens = kernel


def _shape_cfg(arch: str):
    """The arch's config as this slice serves it (llama4-scout cut in
    depth only)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if arch == "llama4-scout-17b-a16e":
        cfg = dataclasses.replace(cfg, n_layers=LLAMA4_LAYERS)
    return cfg


def flash_check(name: str, B: int, S: int, H: int, KV: int, D: int,
                T: int, dev) -> None:
    """flash_attention (causal prefill) and flash_decode (at length S + 1
    of a T-row cache) at one model's attention shape, bf16, each within
    fp_bounds.attention_tol of its plain version (the kernel table's
    functions at this shape)."""
    log(f"kernel check {name}: " + kernel_table.summary(
        kernel_table.prefill_case(dev, torch.bfloat16, B, S, H, KV, D)))
    log(f"kernel check {name}: " + kernel_table.summary(
        kernel_table.flash_decode_row(dev, B=B, T=T, H=H, KV=KV, D=D,
                                      length=S + 1)))


def moe_kernel_checks(cfg, dev, gen) -> None:
    """Before slice 13a's path: the flash kernels at Qwen2-MoE's attention
    shape (MHA, G = 1) and the assemble kernel's dispatch timed at the
    served prefill shape beside its plain version and its byte bound."""
    from repro_torch.core import rme
    from repro_torch.models.moe import capacity_of
    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    flash_check(cfg.name, B, P, cfg.n_heads, cfg.n_kv_heads, cfg.hd, P + G,
                dev)
    E, k = cfg.num_experts_padded, cfg.top_k
    cap = capacity_of(P, k, cfg.num_experts, cfg.capacity_factor)
    eo = torch.randint(0, cfg.num_experts, (B, P * k), generator=gen).to(dev)
    mask = (eo[:, None, :] == torch.arange(E, device=dev)[None, :, None]
            ).reshape(B * E, P * k)
    recs = torch.arange(P * k, dtype=torch.int32, device=dev).expand(
        B * E, P * k)[..., None].contiguous()
    log(kernel_table.summary(kernel_table.assemble_case(recs, mask, cap)))
    whole_ms = graph_ms(lambda: rme.dispatch_tokens(eo, E, cap))
    whole_plain = events_ms(lambda: rme.dispatch_tokens_plain(eo, E, cap),
                            iters=5)
    log(f"kernel rme_assemble at the MoE dispatch: the whole dispatch_tokens "
        f"{whole_ms:.4f} ms device (its plain one-hot form "
        f"{whole_plain:.4f})")


def _sets(experts: torch.Tensor) -> torch.Tensor:
    return torch.sort(experts, dim=-1).values


def moe_layer0_check(cfg, params, prompts, dev) -> float:
    """Layer 0 of the served draw at the served prefill, the kernel path
    (flash prefill, dispatch on the assemble kernel) against a bf16 plain
    run and an f32 plain run (the bf16 weights, exactly, in f32), plain
    dispatch in both: over the tokens whose top-k expert sets agree in all
    three, the kernel path at most 2x the bf16 plain run's distance from
    f32 plus LM_FLOOR_ULPS bf16 ulps.  The dispatch on the card equals its
    plain version bit for bit at the prefill shape and at the decode shape
    (each sequence's first token).  Returns the share of routing decisions
    that differ from the f32 run."""
    import dataclasses

    from repro_torch.core import rme
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import embed, rmsnorm, rope_freqs

    B, S = prompts.shape
    lp = tt._layer(params["blocks"], 0)
    x = embed(params["embed"], prompts)

    def layer(c, p, x, attention):
        inv = rope_freqs(c.hd, c.rope_theta, device=dev)
        h, _ = attn.attention_block(
            p["attn"], rmsnorm(p["ln1"], x), inv, n_heads=c.n_heads,
            n_kv=c.n_kv_heads, head_dim=c.hd, chunk=c.attn_chunk,
            attention=attention, triangular=c.attn_impl == "triangular")
        x = x + h
        u = rmsnorm(p["ln2"], x)
        _, _, experts = moe_mod.route(p["moe"], u, top_k=c.top_k)
        m, _ = moe_mod.moe_block(p["moe"], u, num_experts=c.num_experts,
                                 top_k=c.top_k, n_shared=c.n_shared,
                                 capacity_factor=c.capacity_factor)
        return x + m, experts

    kern, e_kern = layer(cfg, lp, x, "flash")
    inv = rope_freqs(cfg.hd, cfg.rope_theta, device=dev)
    whole, _, _ = tt._moe_block(cfg, lp, x, inv, attention="flash")
    require_equal(whole, kern, "layer 0: the model's block against the "
                  "check's own layer")
    cap = moe_mod.capacity_of(S, cfg.top_k, cfg.num_experts,
                              cfg.capacity_factor)
    E = cfg.num_experts_padded
    for what, eo, c in (("prefill", e_kern.reshape(B, -1), cap),
                        ("decode", e_kern[:, 0], moe_mod.capacity_of(
                            1, cfg.top_k, cfg.num_experts,
                            cfg.capacity_factor))):
        got = rme.dispatch_tokens(eo, E, c)
        want = rme.dispatch_tokens_plain(eo, E, c)
        require_equal(got[0], want[0], f"MoE dispatch at the {what} shape")
        require_equal(got[1], want[1], f"MoE dispatch counts ({what})")
        log(f"MoE dispatch at the {what} shape: expert ids "
            f"{tuple(eo.shape)} -> ({B}, {E}, {c}) slots, bit-exact "
            f"against its plain version; {int(got[1].sum())} of "
            f"{eo.numel()} slots kept")
    with plain_dispatch():
        plain, e_plain = layer(cfg, lp, x, "plain")
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        ref, e_ref = layer(cfg32, tree_map(lambda t: t.float(), lp), x.float(),
                           "plain")
    agree = ((_sets(e_kern) == _sets(e_ref)).all(-1)
             & (_sets(e_plain) == _sets(e_ref)).all(-1))
    # a routing decision is one of a token's k expert choices: it differs
    # where the expert is missing from the f32 run's set in either bf16 run
    k = cfg.top_k
    missing = torch.maximum(
        k - (e_kern[..., :, None] == e_ref[..., None, :]).sum((-1, -2)),
        k - (e_plain[..., :, None] == e_ref[..., None, :]).sum((-1, -2)))
    flips = float(missing.sum()) / missing.numel() / k
    rows = 1.0 - float(agree.float().mean())
    kern, plain = kern.float()[agree], plain.float()[agree]
    ref = ref[agree]
    for what, t in (("kernel", kern), ("plain bf16", plain), ("f32", ref)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"MoE layer 0 {what}: non-finite output")
    d_kern = float((kern - ref).abs().max())
    d_plain = float((plain - ref).abs().max())
    floor = LM_FLOOR_ULPS * float(bf16_ulp(ref.abs().max()))
    worst = d_kern / (2 * d_plain + floor)
    log(f"MoE layer 0 at {B}x{S}: routing decisions (a token's k expert "
        f"choices) that differ from the f32 run in the kernel path or the "
        f"bf16 plain run {flips:.5f} (limit {MOE_FLIP_LIMIT}); tokens whose "
        f"expert sets differ among the three {rows:.5f} (kernel vs f32 "
        f"{1 - float((_sets(e_kern) == _sets(e_ref)).all(-1).float().mean()):.5f}"
        f", kernel vs bf16 plain "
        f"{1 - float((_sets(e_kern) == _sets(e_plain)).all(-1).float().mean()):.5f}"
        f"); over the {int(agree.sum())} tokens routed alike vs f32: kernel "
        f"{d_kern:.4g}, plain bf16 {d_plain:.4g}, floor {floor:.4g}; "
        f"kernel / (2 plain + floor) = {worst:.3f} (must be <= 1)")
    if flips > MOE_FLIP_LIMIT:
        raise AssertionError(f"MoE layer 0: {flips:.4f} of the routing "
                             f"decisions differ (limit {MOE_FLIP_LIMIT})")
    if worst > 1:
        raise AssertionError(f"MoE layer 0 kernel path too far from f32: "
                             f"{worst:.3f} of its bound")
    return flips


def moe_check(cfg, toks, stats, peak: int, dev) -> dict:
    """After slice 13a's path: the served tokens' shape and range, layer
    0 held against plain (moe_layer0_check), the logits of every step
    finite (the kernel path fed the served tokens), and the greedy tokens'
    agreement with a teacher-forced bf16 plain run (reported: router flips
    make a tight bound meaningless end to end)."""
    from repro_torch.launch.serve import lm_inputs

    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    if toks.shape != (B, G) or toks.dtype != torch.int32:
        raise AssertionError(f"served tokens {tuple(toks.shape)} {toks.dtype}")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError("served tokens outside the vocabulary")
    params, prompts = lm_inputs(cfg, batch=B, prompt_len=P, seed=SEED,
                                device=dev)
    flips = moe_layer0_check(cfg, params, prompts, dev)
    kern = _teacher_forced(cfg, params, prompts, toks, "flash")
    with plain_dispatch():
        plain = _teacher_forced(cfg, params, prompts, toks, "plain")
    for what, lg in (("kernel", kern), ("plain bf16", plain)):
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"MoE {what}: non-finite logits")
    replay = float((kern.argmax(-1).T == toks).float().mean())
    agree = float((plain.argmax(-1).T == toks).float().mean())
    log(f"model {cfg.name} {B}x{P}+{G}: logits finite at all {G} steps; "
        f"greedy tokens: the kernel replay picks the served token on "
        f"{replay:.4f}, the teacher-forced bf16 plain run on {agree:.4f} "
        f"(not gated)")
    log(f"model {cfg.name}: prefill {stats['prefill_s'] * 1e3:.3f} ms, "
        f"decode {stats['decode_s'] * 1e3 / (G - 1):.4f} ms/step, "
        f"{stats['tokens_per_s']:.1f} tokens/s (batch {B}, prompt {P}); "
        f"peak memory {peak / 2**30:.3f} GiB")
    return {"flips": flips, "agree": agree}


def family_kernel_checks(dev) -> None:
    """Before slice 13b's path: the flash kernels at each attention arch's
    shape (zamba2's shared attention at head dim 112, InternVL2's G = 7
    at 64, MusicGen's MHA at 64, Llama4-Scout's G = 5)."""
    B, P, G = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN
    for arch in FAMILY_ARCHS:
        cfg = _shape_cfg(arch)
        if cfg.family != "ssm":
            flash_check(cfg.name, B, P, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        P + G, dev)


def _expected(cfg) -> dict:
    """Kernel launches of one serve call of slice 13b (prefill + G - 1
    decode steps), and InternVL2's embeds prefill."""
    steps = FAMILY_GEN - 1
    if cfg.family == "ssm":
        n_attn = 0
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // (cfg.attn_every or cfg.n_layers)
    else:
        n_attn = cfg.n_layers
    want = {"flash_attention": n_attn, "flash_decode": n_attn * steps}
    if cfg.family == "moe":
        want["rme_assemble"] = cfg.n_layers * (steps + 1)
    if cfg.frontend == "vision_stub":
        want["flash_attention"] += n_attn
    return want


def recurrence_check(cfg, toks, dev) -> float:
    """rwkv6 / zamba2: the serving steps (prefill, then the decode steps
    fed the served tokens: the recurrence's step form) against one forward
    over the whole sequence (its chunked form), both in f32 on the served
    bf16 weights, plain attention: within RECUR_RTOL of the largest
    |logit|.  Returns the measured distance over the largest |logit|."""
    import dataclasses

    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models.transformer import forward, logits

    B, P, G = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN
    params, prompts = lm_inputs(cfg, batch=B, prompt_len=P, seed=SEED,
                                device=dev)
    p32 = tree_map(lambda t: t.float(), params)
    del params
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    steps = _teacher_forced(cfg32, p32, prompts, toks, "plain")  # (G, B, V)
    seq = torch.cat([prompts, toks[:, :-1].to(prompts.dtype)], dim=1)
    h, _, _, _ = forward(cfg32, p32, tokens=seq, attention="plain")
    whole = logits(cfg32, p32, h[:, P - 1:]).transpose(0, 1)
    del p32, h
    for what, t in (("steps", steps), ("whole", whole)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{cfg.name} {what}: non-finite logits")
    mag = float(whole.abs().max())
    rel = float((steps - whole).abs().max()) / mag
    log(f"model {cfg.name}: step form vs one prefill of {P + G - 1} tokens, "
        f"f32: max |diff| / max |logit| = {rel:.3g} (must be <= "
        f"{RECUR_RTOL})")
    if rel > RECUR_RTOL:
        raise AssertionError(f"{cfg.name}: the step form and the chunked "
                             f"form differ by {rel:.3g} of max |logit|")
    return rel


def family_paths(dev) -> dict:
    """Slice 13b: each of the five other new archs through ``serve`` at its
    full published width (llama4-scout at 4 layers), one at a time, each
    freed before the next; InternVL2 also prefills from ``vision_prefix``
    of a patch grid through ``make_prefill_embeds_step``; rwkv6 and zamba2
    hold their step form against their chunked form.  Each arch's kernel
    launches are checked exactly."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import lm_inputs, serve
    from repro_torch.models.transformer import init_caches, vision_prefix
    from repro_torch.runtime.step import make_prefill_embeds_step

    B, P, G = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN
    out = {}
    for arch in FAMILY_ARCHS:
        cfg, full = _shape_cfg(arch), get_config(arch)
        if cfg.n_layers != full.n_layers:
            log(f"model {arch}: cut to {cfg.n_layers} of its "
                f"{full.n_layers} layers at full width (d_model "
                f"{cfg.d_model}, {cfg.num_experts} experts of d_ff "
                f"{cfg.moe_d_ff}, vocab {cfg.vocab}): all {full.n_layers} "
                f"hold {full.param_count() / 1e9:.1f} B parameters "
                f"({full.param_count() * 2 / 1e9:.1f} GB in bf16), the "
                f"{cfg.n_layers} served {cfg.param_count() / 1e9:.2f} B")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = launch_counts()
        toks, stats = serve(cfg, batch=B, prompt_len=P, gen=G, seed=SEED,
                            device=dev, log=log)
        peak = torch.cuda.max_memory_allocated(dev)
        if toks.shape != (B, G) or not bool(
                ((toks >= 0) & (toks < cfg.vocab)).all()):
            raise AssertionError(f"{arch}: served tokens {toks.shape}")
        if cfg.frontend == "vision_stub":
            params, _ = lm_inputs(cfg, batch=B, prompt_len=P, seed=SEED,
                                  device=dev)
            grid = torch.randn(VISION_GRID, generator=torch.Generator(
                device=dev).manual_seed(SEED + 2), device=dev)
            emb = vision_prefix(cfg, params, grid)
            caches = init_caches(cfg, B, emb.shape[1], device=dev)
            lg, _, _ = make_prefill_embeds_step(cfg)(params, emb, caches,
                                                     None)
            torch.cuda.synchronize(dev)
            if lg.shape != (B, 1, cfg.padded_vocab) or not bool(
                    torch.isfinite(lg).all()):
                raise AssertionError(f"{arch}: embeds prefill logits "
                                     f"{tuple(lg.shape)}")
            log(f"model {arch}: vision_prefix of a {VISION_GRID} patch grid "
                f"-> embeds {tuple(emb.shape)} -> prefill logits finite")
            del params, caches, emb, lg
        after = launch_counts()
        got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        want = _expected(cfg)
        want = {k: v for k, v in want.items() if v}
        if got != want:
            raise AssertionError(f"{arch}: launches {got}, expected {want}")
        log(f"model {cfg.name} {B}x{P}+{G}: prefill "
            f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
            f"{stats['decode_s'] * 1e3 / (G - 1):.4f} ms/step, "
            f"{stats['tokens_per_s']:.1f} tokens/s, peak memory "
            f"{peak / 2**30:.3f} GiB; launches {got}")
        rel = None
        if cfg.family in ("ssm", "hybrid"):
            rel = recurrence_check(cfg, toks, dev)
        out[arch] = {**stats, "peak": peak, "launches": got, "recur": rel}
        del toks
    return out


# ---------------------------------------------------------------------------
# slice 14: training
# ---------------------------------------------------------------------------

# 14a: Qwen2-MoE-A2.7B trained at full width (d_model 2048, MHA 16 x 128,
# 60 routed experts of d_ff 1408 padded to 64, top-4, 4 shared, vocab
# 151936, bf16, remat "full"), 4 of its 24 layers: all 24 hold 14.83 B
# parameters, 237 GB at 16 bytes each (bf16 weights and gradients, f32
# master, m and v), which one card cannot hold; 4 hold 2.73 B
TRAIN_ARCH = "qwen2-moe-a2.7b"
TRAIN_LAYERS = 4
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 6, 4, 1024, 1e-2
# step 0's gradient norm through the kernels against the plain dispatch's:
# the backward of the gathers sums on the card with atomics, in no fixed
# order
GRAD_NORM_RTOL = 1e-2
# 14b: the smoke config of the same arch (f32, 2 layers) with int8
# gradient compression and checkpoints: CKPT_STEPS steps, then resumed to
# CKPT_RESUME, on the card and on the CPU (plain dispatch), the same way
CKPT_STEPS, CKPT_RESUME, CKPT_EVERY = 4, 6, 2
CKPT_BATCH, CKPT_SEQ = 4, 64
# the card's losses against the CPU's: f32 sums in other orders (cuBLAS
# against the CPU's products, TF32 off), amplified by 6 updates at lr
# 1e-2, where a rounding that moves one int8 code moves that gradient
# element by a whole quantization step
CKPT_LOSS_RTOL = 1e-3
# the fused AdamW against its plain version on the same card tensors, over
# the trained tree's leaves up to ADAMW_CHECK_ELEMS elements: the master, m
# and v within ADAMW_STATE_ULPS (the same operations, an eager kernel's
# FMA contracted or not), the bf16 parameter within one ulp (a rounding of
# a master weight a few ulps off), the norm within ADAMW_NORM_RTOL (f32
# sums in another order)
ADAMW_CHECK_ELEMS = 1 << 28
ADAMW_STATE_ULPS, ADAMW_PARAM_ULPS, ADAMW_NORM_RTOL = 4, 1, 1e-6
# what one update needs a parameter: the bf16 gradient read twice (the
# norm, the update), the f32 master, m and v read and written, the bf16
# parameter written (bench/counts/lm.py's ADAMW_BYTES)
ADAMW_BYTES_PER_PARAM = 30


def _train_cfg():
    import dataclasses

    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)


def _gib(n: float) -> str:
    return f"{n / 2**30:.3f} GiB"


def train_full_width(cfg, dev) -> dict:
    """Slice 14a's path: ``train()`` on the card, ``TRAIN_STEPS`` steps of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, a line logged a step.  A step's
    line comes after ``float(loss)``, which waits for the whole step (the
    update is queued before it), so the time between two lines is one
    step's wall time."""
    from repro_torch.launch.train import train

    marks = []

    def step_log(msg: str) -> None:
        if msg.startswith("step"):
            marks.append(time.perf_counter())
        log(f"train: {msg}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, losses = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, peak_lr=TRAIN_LR, seed=SEED,
                          log_every=1, log=step_log, device=dev)
    steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return {"state": state, "losses": losses, "steps_ms": steps_ms,
            "first_s": marks[0] - t0,
            "peak": torch.cuda.max_memory_allocated(dev)}


def _optimizer_ms(cfg, state, update=None) -> float:
    """Device time of one ``update`` (``adamw_update``: the kernels) over
    the whole state (zero gradients: its work does not depend on their
    values), a mean over back-to-back calls after an untimed one."""
    from repro_torch.optim.adamw import AdamWState, adamw_update
    from repro_torch.tree import tree_map
    update = update or adamw_update
    grads = tree_map(torch.zeros_like, state["params"])
    opt = AdamWState(**state["opt"])
    lr = torch.zeros((), device=opt.step.device)
    return events_ms(lambda: update(grads, opt, lr, param_dtype=cfg.dtype,
                                  params=state["params"]), iters=3, warmup=1)


def _fused_adamw_ms(state) -> float:
    """Device time of one ``torch.optim.AdamW(fused=True)`` step over the
    f32 master weights with f32 zero gradients, the state's m and v as its
    moments: PyTorch's own fused AdamW, timed as the library yardstick
    (the port never calls it; it writes no bf16 parameter and reads the
    gradient once)."""
    from repro_torch.tree import tree_leaves
    masters = tree_leaves(state["opt"]["master"])
    for w in masters:
        w.grad = torch.zeros_like(w)
    opt = torch.optim.AdamW(masters, lr=1e-4, betas=(0.9, 0.95),
                            weight_decay=0.1, fused=True)
    for w, mu, nu in zip(masters, tree_leaves(state["opt"]["m"]),
                         tree_leaves(state["opt"]["v"])):
        opt.state[w] = {"step": torch.zeros((), device=w.device),
                        "exp_avg": mu, "exp_avg_sq": nu}
    ms = events_ms(opt.step, iters=3, warmup=1)
    for w in masters:
        w.grad = None
    return ms


def adamw_check(cfg, state, dev) -> dict:
    """The fused AdamW (``adamw_update`` on card tensors) against its plain
    version (``adamw_update_plain``) on copies of the same leaves of a
    state after a step: the leaves of ``state`` in tree order that fit
    in ADAMW_CHECK_ELEMS, bf16 gradients of 1e-5 drawn from the seed (a
    global norm under 1: the clip scale is 1 on both paths, whose norms
    differ in the last bits), lr 1e-2.  Returns the largest distances in
    ulps and the norms' relative gap."""
    from repro_torch.kernels import adamw as ak
    from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                         adamw_update_plain)
    from repro_torch.tree import tree_leaves
    leaves = list(zip(*(tree_leaves(state[k]) if k == "params" else
                        tree_leaves(state["opt"][k])
                        for k in ("params", "master", "m", "v"))))
    picked, total = [], 0
    for leaf in leaves:
        if total + leaf[0].numel() <= ADAMW_CHECK_ELEMS:
            picked.append(leaf)
            total += leaf[0].numel()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    grads = [torch.randn(p.shape, generator=gen, device=dev).mul_(1e-5)
             .to(cfg.dtype) for p, *_ in picked]
    lr = torch.full((), 1e-2, device=dev)
    outs = []
    for update in (adamw_update, adamw_update_plain):
        params = [p.clone() for p, *_ in picked]
        opt = AdamWState(step=state["opt"]["step"].clone(),
                         master=[w.clone() for _, w, _, _ in picked],
                         m=[mu.clone() for _, _, mu, _ in picked],
                         v=[nu.clone() for *_, nu in picked])
        before = ak.adamw_apply.launches
        new, opt, met = update(grads, opt, lr, param_dtype=cfg.dtype,
                               params=params)
        launched = ak.adamw_apply.launches - before
        outs.append((new, opt, met["grad_norm"], launched))
    torch.cuda.synchronize(dev)
    (kp, ko, kn, k_launched), (pp, po, pn, p_launched) = outs
    if (k_launched, p_launched) != (len(ak.tables(len(picked))), 0):
        raise AssertionError(f"adamw: {k_launched} kernel launches, "
                             f"{p_launched} from the plain version")
    worst = {}
    for name, a, b in (("master", ko.master, po.master), ("m", ko.m, po.m),
                       ("v", ko.v, po.v), ("param", kp, pp)):
        worst[name] = max(int(ulps_apart(x, y).max()) for x, y in zip(a, b))
    rel = abs(float(kn) - float(pn)) / float(pn)
    if not float(pn) < 1.0:
        raise AssertionError(f"adamw: a gradient norm {float(pn)} clips")
    log(f"adamw: the kernels against the plain version on {len(picked)} of "
        f"the state's {len(leaves)} leaves ({total / 1e6:.1f} M elements), "
        f"a step at lr 1e-2 after step 0: at most {worst} ulps apart "
        f"(limits {ADAMW_STATE_ULPS}, parameter {ADAMW_PARAM_ULPS}); "
        f"gradient norm {float(kn)!r} against {float(pn)!r} ({rel:.3g}, "
        f"limit {ADAMW_NORM_RTOL})")
    if max(worst[k] for k in ("master", "m", "v")) > ADAMW_STATE_ULPS or \
            worst["param"] > ADAMW_PARAM_ULPS or not rel <= ADAMW_NORM_RTOL:
        raise AssertionError(f"adamw: the kernels against the plain "
                             f"version: {worst} ulps, norm {rel:.3g}")
    return {"ulps": worst, "norm_rel": rel}


def train_check(cfg, run: dict, card: str, dev) -> dict:
    """After slice 14a's path: every loss finite and the last below step
    0's; every parameter of the trained state in ``cfg.dtype``; then step
    0 again from the same seed and batch: through the kernels (one
    ``make_train_step`` on a fresh state) its loss equal, bit for bit, to
    the path's step 0 and to the same forward with the plain dispatch, its
    gradient norm within GRAD_NORM_RTOL of the plain one, and the weights
    after it those before it (lr 0), every leaf in ``cfg.dtype``; the
    optimizer timed alone."""
    import math

    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.optim.adamw import adamw_update_plain, global_norm
    from repro_torch.tree import tree_leaves
    from repro_torch.runtime.step import init_train_state, make_train_step

    losses = run.pop("losses")
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    state = run.pop("state")
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    wrong = {str(t.dtype) for t in tree_leaves(state["params"])
             if t.dtype != cfg.dtype}
    if wrong:
        raise AssertionError(f"train: parameters in {wrong} after "
                             f"{TRAIN_STEPS} steps, not {cfg.dtype}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    def seeded():
        return torch.Generator(device=dev).manual_seed(SEED)

    batch = to_device(SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                  SEED).batch_at(0), dev)
    params = init_lm(cfg, seeded(), device=dev)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    with plain_dispatch():
        plain_loss, _ = lm_loss(cfg, params, batch["tokens"],
                                batch["labels"])
        grads = torch.autograd.grad(plain_loss, leaves)
    plain_norm = float(global_norm(grads))
    plain_loss = plain_loss.detach()
    del params, leaves, grads
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    state = init_train_state(cfg, seeded(), device=dev)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    step = make_train_step(cfg, peak_lr=TRAIN_LR,
                           warmup=max(TRAIN_STEPS // 10, 1),
                           total=TRAIN_STEPS)
    state, met = step(state, batch)
    torch.cuda.synchronize(dev)
    init_s, again_ms = t1 - t0, (time.perf_counter() - t1) * 1e3
    require_equal(met["loss"], plain_loss, "step 0's loss through the "
                  "kernels against the plain dispatch")
    if float(met["loss"]) != losses[0]:
        raise AssertionError(f"step 0's loss {float(met['loss'])} differs "
                             f"from the path's {losses[0]}")
    norm = float(met["grad_norm"])
    rel = abs(norm - plain_norm) / plain_norm
    if not rel <= GRAD_NORM_RTOL:
        raise AssertionError(f"step 0's gradient norm {norm} against the "
                             f"plain dispatch's {plain_norm}: {rel:.3g}")
    if float(met["lr"]) != 0.0:
        raise AssertionError(f"step 0 ran at lr {float(met['lr'])}")
    for a, b in zip(tree_leaves(init_lm(cfg, seeded(), device=dev)),
                    tree_leaves(state["params"])):
        if b.dtype != cfg.dtype:
            raise AssertionError(f"a parameter in {b.dtype} after step 0")
        require_equal(b, a.to(cfg.dtype), "a parameter after step 0 at lr 0")
    check = adamw_check(cfg, state, dev)
    opt_ms = _optimizer_ms(cfg, state)
    plain_ms = _optimizer_ms(cfg, state, adamw_update_plain)
    library_ms = _fused_adamw_ms(state)
    bound, by = bound_ms(ADAMW_BYTES_PER_PARAM * n_params)
    del state, met
    torch.cuda.empty_cache()

    steps_ms = run["steps_ms"]
    step_ms = sorted(steps_ms)[len(steps_ms) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"model {cfg.name} trained at full width, {cfg.n_layers} of 24 "
        f"layers ({n_params / 1e9:.3f} B parameters with the pad experts "
        f"and the padded vocabulary), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps, on {card}: "
        f"losses {[round(x, 4) for x in losses]}; steps 1-{TRAIN_STEPS - 1} "
        f"{[round(x, 3) for x in steps_ms]} ms (step 0 with the set-up "
        f"{run['first_s']:.3f} s; again: init_train_state {init_s:.3f} s, "
        f"the step {again_ms:.3f} ms), median {step_ms:.3f} ms = "
        f"{tokens / step_ms * 1e3:.1f} tokens/s; peak {_gib(run['peak'])}; "
        f"the optimizer alone {opt_ms:.3f} ms "
        f"({opt_ms / step_ms:.3f} of a step; bound {bound:.3f} ms at "
        f"{ADAMW_BYTES_PER_PARAM} bytes a parameter, plain {plain_ms:.3f}, "
        f"torch.optim.AdamW(fused=True) {library_ms:.3f})")
    log(f"model {cfg.name} step 0: loss {float(plain_loss)!r} through the "
        f"kernels and the plain dispatch, bit for bit, and the path's; "
        f"gradient norm {norm:.6g} against {plain_norm:.6g} plain "
        f"({rel:.3g}, limit {GRAD_NORM_RTOL}); weights unchanged at lr 0; "
        f"every leaf {cfg.dtype} after step 0 and after step "
        f"{TRAIN_STEPS - 1}")
    row = dict(
        name="adamw_apply", route="cuda",
        source="src/repro_torch/csrc/adamw.cu",
        replaces="none (the JAX package's AdamW is jnp)",
        max_abs_err=None, ms=opt_ms, call_ms=opt_ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=library_ms,
        shape=f"adamw_update (adamw_sumsq + adamw_apply) over "
              f"{n_params / 1e9:.3f} B parameters, bf16 gradients and "
              f"parameters, f32 master, m and v; ulps {check['ulps']}")
    return {"step_ms": step_ms, "opt_ms": opt_ms, "norm_rel": rel,
            "row": row}


def _adamw_tables(state) -> int:
    """The fused AdamW's launches of each kernel a step on ``state``."""
    from repro_torch.kernels.adamw import tables
    from repro_torch.tree import tree_leaves
    return len(tables(len(tree_leaves(state["params"]))))


def train_checkpoint_path(dev, keep: str) -> dict:
    """Slice 14b: the smoke config in f32, from one state drawn on the CPU
    and checkpointed as step 0, trained with compression to CKPT_STEPS,
    checkpointed every CKPT_EVERY, the saved state restored bit for bit,
    then resumed to CKPT_RESUME; the same on the CPU (plain dispatch),
    each of the CKPT_RESUME losses within CKPT_LOSS_RTOL of the CPU's.
    (The card's generator draws other numbers than the CPU's, so each run
    resumes from the same step-0 checkpoint.)  The card's checkpoints stay
    in the directory ``keep`` (slice 15b restores them onto a mesh)."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.train import train
    from repro_torch.runtime.step import init_train_state

    cfg = get_smoke(TRAIN_ARCH)
    start = init_train_state(cfg, torch.Generator().manual_seed(SEED),
                             compress=True, device="cpu")
    kw = dict(batch=CKPT_BATCH, seq=CKPT_SEQ, peak_lr=TRAIN_LR, seed=SEED,
              compress=True, ckpt_every=CKPT_EVERY, log_every=1)
    runs = []
    for where in (dev, torch.device("cpu")):
        with (contextlib.nullcontext(keep) if where == dev
              else tempfile.TemporaryDirectory()) as d:
            CheckpointManager(d).save(0, start, blocking=True)
            notes = []
            state, first = train(cfg, steps=CKPT_STEPS, ckpt_dir=d,
                                 device=where, log=notes.append, **kw)
            if notes[0] != "[restore] resumed from step 0":
                raise AssertionError(f"14b on {where}: {notes[:1]}")
            saved, at = CheckpointManager(d).restore(device=where)
            flat, want = _flatten(saved), _flatten(state)
            if at != CKPT_STEPS or flat.keys() != want.keys():
                raise AssertionError(f"checkpoint at {at}: {sorted(flat)}")
            for k in want:
                require_equal(flat[k], want[k], f"restored {k} ({where})")
            notes = []
            _, rest = train(cfg, steps=CKPT_RESUME, ckpt_dir=d, device=where,
                            log=notes.append, **kw)
            if notes[0] != f"[restore] resumed from step {CKPT_STEPS}" or \
                    len(rest) != CKPT_RESUME - CKPT_STEPS:
                raise AssertionError(f"resume on {where}: {notes[:1]}, "
                                     f"{len(rest)} steps")
        runs.append(first + rest)
        del state, saved, flat, want
    card, cpu = runs
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    log(f"model {cfg.name} (smoke, f32) with int8 compression, from one "
        f"state drawn on the CPU and checkpointed as step 0: "
        f"{CKPT_STEPS} steps, the checkpoint restored bit for bit, resumed "
        f"to {CKPT_RESUME}; losses on the card {[round(x, 5) for x in card]},"
        f" on the CPU {[round(x, 5) for x in cpu]}: max relative "
        f"difference {rel:.3g} (limit {CKPT_LOSS_RTOL})")
    if not rel <= CKPT_LOSS_RTOL:
        raise AssertionError(f"14b: the card's losses {card} against the "
                             f"CPU's {cpu}")
    return {"rel": rel}


# ---------------------------------------------------------------------------
# slice 15: distribution and the dry-run
# ---------------------------------------------------------------------------

# 15a: slice 14a's run through ``train(mesh=)`` on a (1, 1) ("data",
# "model") card mesh.  Steps 0 and 1 see the same weights as 14a's (step 0
# runs at lr 0), so their losses are 14a's bit for bit.  Step 2 follows
# the first real update, whose gradient the card sums with atomics in the
# gathers' backward (GRAD_NORM_RTOL's comment): within MESH_STEP2_RTOL
# (measured 2.7e-5 to 1.6e-4 over four runs).  From step 3 on, lr 1e-2 on
# weights of scale 2048^-1/2 moves the loss by up to 85% a step, and two
# runs of 14a itself differ by up to 4.8% at step 4 (206.1 to 216.0 over
# seven runs of either path): steps 3-5 within MESH_LATE_RTOL, a check
# that the mesh trains like the plain path, not that it equals it
MESH_STEP2_RTOL = 1e-3
MESH_LATE_RTOL = 0.15
# 15c: four production cells of the dry-run, each in its own process
# (the fake process group of 256 or 512 ranks is process-global state)
DRYRUN_CELLS = (("qwen2-moe-a2.7b", "train_4k", "single"),
                ("phi4-mini-3.8b", "decode_32k", "single"),
                ("rwkv6-3b", "decode_32k", "single"),
                ("zamba2-7b", "long_500k", "multi"))
DRYRUN_TIMEOUT_S = 300
# a decode cell's all-gather bytes a device: the cache stays sharded along
# its rows (the distributed flash decode), so what is gathered is q's
# heads and the products' activations, not the 6.997e10 of a cache
# gathered every layer, nor, for rwkv6, the 1.342e10 of its fused
# projection gathered in f32 once a column band; its peak fits the card's
# 80 GB, and its step-time bound is set by memory, not by collectives
DECODE_GATHER_LIMIT = 2e9
# the card cell's matmul FLOPs (the trace on a (1, 1) mesh) against
# FlopCounterMode over one real 14a step: the same formulas on the same
# products, so equal up to MATMUL_FLOPS_RTOL
MATMUL_FLOPS_RTOL = 1e-2
# the card cell: slice 14a's step traced on a (1, 1) mesh of a fake group
_CARD_CELL = r"""
import dataclasses, json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group
arch, layers, batch, seq = sys.argv[1], *map(int, sys.argv[2:5])
cfg = dataclasses.replace(get_config(arch), n_layers=layers)
with fake_process_group(1):
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    rec = dryrun.record(cfg, ShapeSpec("card_14a", seq, batch, "train"), mesh)
print(json.dumps(rec))
"""


def _card_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def train_on_mesh(cfg, mesh, dev) -> dict:
    """Slice 15a's path: slice 14a's ``train()`` call with ``mesh=``."""
    from repro_torch.launch.train import train

    marks = []

    def step_log(msg: str) -> None:
        if msg.startswith("step"):
            marks.append(time.perf_counter())
        log(f"train on the mesh: {msg}")

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, losses = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, peak_lr=TRAIN_LR, seed=SEED,
                          log_every=1, log=step_log, device=dev, mesh=mesh)
    steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return {"state": state, "losses": losses, "steps_ms": steps_ms,
            "first_s": marks[0] - t0,
            "peak": torch.cuda.max_memory_allocated(dev)}


def mesh_train_check(cfg, run: dict, plain: dict) -> dict:
    """After 15a: steps 0-1's losses 14a's bit for bit, step 2 within
    MESH_STEP2_RTOL, steps 3-5 within MESH_LATE_RTOL, every parameter a
    DTensor in ``cfg.dtype``; the step ms beside 14a's from the same
    script."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves

    losses, want = run["losses"], plain["losses"]
    if losses[:2] != want[:2]:
        raise AssertionError(f"15a: steps 0-1's losses {losses[:2]!r} on "
                             f"the mesh, {want[:2]!r} in 14a")
    rel2 = abs(losses[2] - want[2]) / abs(want[2])
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[3:], want[3:]))
    if not (rel2 <= MESH_STEP2_RTOL and rel <= MESH_LATE_RTOL):
        raise AssertionError(f"15a: losses {losses} on the mesh against "
                             f"14a's {want}: step 2 {rel2:.3g}, steps 3-5 "
                             f"{rel:.3g}")
    leaves = tree_leaves(run.pop("state")["params"])
    if not all(isinstance(t, DTensor) and t.dtype == cfg.dtype
               for t in leaves):
        raise AssertionError("15a: a parameter is not a DTensor in "
                             f"{cfg.dtype} after training")
    step_ms = sorted(run["steps_ms"])[len(run["steps_ms"]) // 2]
    log(f"model {cfg.name} trained on a (1, 1) card mesh (train(mesh=), "
        f"the train rules, every gradient redistributed to its "
        f"parameter's placements): losses {[round(x, 4) for x in losses]} "
        f"against 14a's {[round(x, 4) for x in want]}, steps 0-1 bit for "
        f"bit, step 2 within {rel2:.3g} (limit {MESH_STEP2_RTOL}), steps "
        f"3-{TRAIN_STEPS - 1} within {rel:.3g} (limit {MESH_LATE_RTOL}); "
        f"steps 1-{TRAIN_STEPS - 1} "
        f"{[round(x, 3) for x in run['steps_ms']]} ms, median "
        f"{step_ms:.3f} ms against 14a's {plain['step_ms']:.3f} "
        f"({step_ms / plain['step_ms']:.3f}x); peak {_gib(run['peak'])}")
    return {"step_ms": step_ms, "rel2": rel2, "rel": rel}


def dtensor_loss_path(cfg, mesh, dev) -> dict:
    """Slice 15b's path: the 4-layer weights placed on the card mesh by
    ``reshard_state`` under the train rules, ``lm_loss`` of 14a's step-0
    batch on them (no gradient: one dispatch a layer, through the assemble
    op's sharding rule)."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.launch.mesh import rules_for_cell
    from repro_torch.models.transformer import init_lm, lm_loss, lm_specs
    from repro_torch.runtime import sharding as shard_lib
    from repro_torch.runtime.elastic import reshard_state

    rules = rules_for_cell("train")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
    batch = to_device(SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                  SEED).batch_at(0), dev)
    placed = reshard_state(params, lm_specs(cfg), mesh, rules)
    with torch.no_grad(), shard_lib.use_rules(mesh, rules):
        split = shard_lib.placements_of(shard_lib.spec_of(("batch", None)),
                                        mesh)
        toks, labels = (shard_lib.distribute(batch[k], mesh, split)
                        for k in ("tokens", "labels"))
        loss, _ = lm_loss(cfg, placed, toks, labels)
        loss = loss.full_tensor()
    torch.cuda.synchronize(dev)
    return {"params": params, "placed": placed, "batch": batch,
            "loss": loss}


def dtensor_check(cfg, out: dict, mesh, ckpt_dir: str) -> None:
    """After 15b: the DTensor loss equal, bit for bit, to the plain
    forward's on the same weights (the same local products on the same
    data: no redistribution moves a value on a (1, 1) mesh); the placed
    weights back whole bit for bit, and placed again from them bit for
    bit; 14b's last checkpoint restored onto the mesh with its spec tree
    bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.mesh import rules_for_cell
    from repro_torch.models.transformer import lm_loss, lm_specs
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.runtime.step import state_specs
    from repro_torch.tree import tree_leaves

    with torch.no_grad():
        plain, _ = lm_loss(cfg, out["params"], out["batch"]["tokens"],
                           out["batch"]["labels"])
    require_equal(out["loss"], plain, "15b: the DTensor loss against the "
                  "plain forward's")
    rules = rules_for_cell("train")
    back = [t.full_tensor() for t in tree_leaves(out["placed"])]
    for a, b in zip(back, tree_leaves(out["params"])):
        require_equal(a, b, "15b: a weight placed on the mesh and back")
    again = reshard_state(out["placed"], lm_specs(cfg), mesh, rules)
    for a, b in zip(tree_leaves(again), tree_leaves(out["params"])):
        require_equal(a.full_tensor(), b, "15b: a weight placed twice")
    smoke = get_smoke(TRAIN_ARCH)
    mgr = CheckpointManager(ckpt_dir)
    whole, step = mgr.restore(device=mesh.device_type)
    onto, _ = mgr.restore(device=mesh.device_type, mesh=mesh, spec_tree=
                          state_specs(lm_specs(smoke), compress=True),
                          rules=rules)
    flat, want = _flatten(onto), _flatten(whole)
    if flat.keys() != want.keys() or not all(
            isinstance(v, DTensor) for v in flat.values()):
        raise AssertionError("15b: the checkpoint restored onto the mesh "
                             "is not a tree of DTensors like the saved one")
    for k in want:
        require_equal(flat[k].full_tensor(), want[k],
                      f"15b: checkpoint leaf {k}")
    log(f"model {cfg.name} on a (1, 1) card mesh: lm_loss on DTensor "
        f"weights {float(out['loss'])!r}, the plain forward's bit for bit; "
        f"the weights placed and back, and placed again, bit for bit; "
        f"14b's checkpoint at step {step} restored onto the mesh with its "
        f"spec tree ({len(flat)} leaves, every one a DTensor) bit for bit")


# 15d: the decode step on the card mesh under the decode rules, which lay
# the cache's rows over "model": Phi-4-mini at full width cut to
# MESH_DECODE_LAYERS layers, slice 5's batch and cache, MESH_DECODE_STEPS
# steps, each layer's attention one flash_decode_partial launch
MESH_DECODE_LAYERS = 4
MESH_DECODE_STEPS = 8


def mesh_decode_setup(dev) -> dict:
    """15d's plain run: Phi-4-mini at full width (its published config,
    bf16, random weights from SEED) cut to MESH_DECODE_LAYERS layers, a
    batch of LM_BATCH LM_PROMPT-token prompts prefilled into a cache of
    LM_PROMPT + LM_GEN rows, then MESH_DECODE_STEPS greedy decode steps
    with no mesh: the cache after the prefill, the tokens fed, each
    step's logits, the final cache, ms a step."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_caches, init_lm
    from repro_torch.runtime.step import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=MESH_DECODE_LAYERS)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator().manual_seed(SEED),
                            dtype=torch.int32).to(dev)
    caches = init_caches(cfg, LM_BATCH, LM_PROMPT + LM_GEN, dtype=cfg.dtype,
                         device=dev)
    lg, caches, _ = make_prefill_step(cfg)(params, prompts, caches, None)
    start = {n: t.clone() for n, t in caches.items()}
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None].to(torch.int32)
    step = make_decode_step(cfg)
    toks, logits = [], []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(MESH_DECODE_STEPS):
        toks.append(tok)
        tok, lg, caches, _ = step(params, tok, caches, None, LM_PROMPT + i)
        logits.append(lg)
    torch.cuda.synchronize(dev)
    return {"cfg": cfg, "params": params, "start": start, "toks": toks,
            "logits": logits, "caches": caches,
            "step_ms": (time.perf_counter() - t0) * 1e3 / MESH_DECODE_STEPS}


def mesh_decode_path(ref: dict, mesh, dev) -> dict:
    """Slice 15d's path: ``ref``'s weights and post-prefill cache placed on
    the card mesh by ``reshard_state`` under the decode rules (the cache's
    rows over "model"), its decode steps run on them with the same tokens:
    each layer's band written into the rank that owns the row and its
    attention through ``flash_decode_partial`` on that rank's rows, the
    partials combined across "model" (one rank here)."""
    from repro_torch.launch.mesh import rules_for_cell
    from repro_torch.models.transformer import lm_specs
    from repro_torch.runtime import sharding as shard_lib
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.runtime.step import make_decode_step, serve_state_specs

    cfg = ref["cfg"]
    rules = rules_for_cell("decode")
    placed = reshard_state(ref["params"], lm_specs(cfg), mesh, rules)
    caches = reshard_state({n: t.clone() for n, t in ref["start"].items()},
                           serve_state_specs(cfg)[0], mesh, rules)
    step = make_decode_step(cfg)
    logits = []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad(), shard_lib.use_rules(mesh, rules):
        split = shard_lib.placements_of(shard_lib.spec_of(("batch", None)),
                                        mesh)
        for i, tok in enumerate(ref["toks"]):
            _, lg, caches, _ = step(placed, shard_lib.distribute(
                tok, mesh, split), caches, None, LM_PROMPT + i)
            logits.append(lg)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / MESH_DECODE_STEPS
    return {"logits": [lg.full_tensor() for lg in logits],
            "caches": {n: c.full_tensor() for n, c in caches.items()},
            "placements": str(caches["k"].placements), "step_ms": ms}


def mesh_decode_check(ref: dict, out: dict) -> None:
    """After 15d: every step's logits and the final caches equal, bit for
    bit, the plain steps' (on one rank the partial's o is the whole
    decode's out in f32, its weight exp(0) = 1, and the band lands where
    the plain write puts it), the cache still sharded along its rows."""
    for i, (a, b) in enumerate(zip(out["logits"], ref["logits"])):
        require_equal(a, b, f"15d: step {i}'s logits on the mesh against "
                      f"the plain step's")
    for n in ("k", "v"):
        require_equal(out["caches"][n], ref["caches"][n],
                      f"15d: the {n} cache on the mesh")
    if "Shard(dim=2)" not in out["placements"]:
        raise AssertionError(f"15d: the cache lies {out['placements']}, "
                             f"not along its rows")
    log(f"model {ref['cfg'].name} at {MESH_DECODE_LAYERS} layers, batch "
        f"{LM_BATCH}, cache {LM_PROMPT + LM_GEN} rows, on a (1, 1) card "
        f"mesh under the decode rules (cache {out['placements']}): "
        f"{MESH_DECODE_STEPS} steps, logits and caches bit for bit the "
        f"plain steps'; {out['step_ms']:.3f} ms a step against "
        f"{ref['step_ms']:.3f} plain")


def dryrun_cells(card: str) -> list[dict]:
    """Slice 15c: each of DRYRUN_CELLS through ``python -m
    repro_torch.launch.dryrun`` in its own process (a fake group of 256 or
    512 ranks, the step traced on meta shards); each record printed,
    FLOPs and bytes > 0, the train cell's collectives > 0, and each decode
    cell under DECODE_GATHER_LIMIT, within HBM and bound by memory."""
    import os
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    recs = []
    with tempfile.TemporaryDirectory() as out:
        for arch, shape, mesh in DRYRUN_CELLS:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--out", out],
                env=env, capture_output=True, text=True,
                timeout=DRYRUN_TIMEOUT_S)
            tail = proc.stdout.strip().splitlines()[-1:]
            if proc.returncode != 0:
                raise AssertionError(f"15c: {arch} {shape} {mesh}: exit "
                                     f"{proc.returncode} {tail} "
                                     f"{proc.stderr[-2000:]}")
            with open(Path(out) / f"{arch}__{shape}__{mesh}.json") as f:
                rec = json.load(f)
            if not (rec["flops_per_device"] > 0 and
                    rec["bytes_per_device"] > 0):
                raise AssertionError(f"15c: {arch} {shape}: {rec}")
            if shape == "train_4k" and not rec[
                    "collective_bytes_per_device"] > 0:
                raise AssertionError(f"15c: {arch} {shape} moves no "
                                     f"collective bytes")
            if shape == "decode_32k" and not (
                    rec["collectives"].get("all-gather", 0) <
                    DECODE_GATHER_LIMIT and rec["fits_hbm"] and
                    rec["dominant"] == "memory_s"):
                raise AssertionError(
                    f"15c: {arch} {shape} gathers "
                    f"{rec['collectives'].get('all-gather', 0):.4g} bytes a "
                    f"device (limit {DECODE_GATHER_LIMIT:.0e}), fits_hbm "
                    f"{rec['fits_hbm']}, dominant {rec['dominant']}: the KV "
                    f"cache or a fused weight gathered")
            log(f"dry-run {arch} {shape} {mesh} "
                f"({time.perf_counter() - t0:.1f} s with its process; "
                f"constants of {card}): {json.dumps(rec)}")
            recs.append(rec)
    return recs


def card_cell_check(cfg, plain: dict, dev) -> dict:
    """Slice 15c's card cell: 14a's step traced on a (1, 1) mesh in its
    own process; its matmul FLOPs against FlopCounterMode over one real
    14a step on the card, within MATMUL_FLOPS_RTOL; its step-time bound
    beside 14a's measured step."""
    import os

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.runtime.step import init_train_state, make_train_step

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", _CARD_CELL, TRAIN_ARCH, str(cfg.n_layers),
         str(TRAIN_BATCH), str(TRAIN_SEQ)], env=env, capture_output=True,
        text=True, timeout=DRYRUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"15c card cell: exit {proc.returncode} "
                             f"{proc.stderr[-2000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    batch = to_device(SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                  SEED).batch_at(0), dev)
    step = make_train_step(cfg, peak_lr=TRAIN_LR,
                           warmup=max(TRAIN_STEPS // 10, 1),
                           total=TRAIN_STEPS)
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    torch.cuda.synchronize(dev)
    del state
    torch.cuda.empty_cache()
    real = counter.get_total_flops()
    rel = abs(rec["matmul_flops"] - real) / real
    if not rel <= MATMUL_FLOPS_RTOL:
        raise AssertionError(f"15c card cell: matmul FLOPs "
                             f"{rec['matmul_flops']} traced, {real} on the "
                             f"card: {rel:.3g}")
    step_bound = rec["step_time_bound_s"] * 1e3
    log(f"dry-run card cell ({cfg.name}, {cfg.n_layers} layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, a (1, 1) mesh): matmul FLOPs "
        f"{rec['matmul_flops']:.6g} traced against {real:.6g} by "
        f"FlopCounterMode over one real step ({rel:.3g}, limit "
        f"{MATMUL_FLOPS_RTOL}); flops {rec['flops_per_device']:.6g}, bytes "
        f"{rec['bytes_per_device']:.6g}, peak "
        f"{_gib(rec['memory_analysis']['peak_bytes'])} traced; terms "
        f"compute {rec['compute_s'] * 1e3:.3f} / memory "
        f"{rec['memory_s'] * 1e3:.3f} / collective "
        f"{rec['collective_s'] * 1e3:.3f} ms, dominant {rec['dominant']}; "
        f"step-time bound {step_bound:.3f} ms against 14a's measured "
        f"{plain['step_ms']:.3f} ms ({step_bound / plain['step_ms']:.3f})")
    return {"rec": rec, "real": real}


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
    # slice 13 ports no kernel: MoE dispatch runs on the assemble kernel
    "13a": ("rme_assemble", "flash_attention", "flash_decode"),
    "13b": ("rme_assemble", "flash_attention", "flash_decode"),
    # slice 14 ports no kernel: the train path runs plain attention, as
    # the reference trains, and its MoE dispatch on the assemble kernel
    "14a": ("rme_assemble", "adamw_sumsq", "adamw_apply", "xent_rows",
            "xent_grad"),
    "14b": ("rme_assemble", "adamw_sumsq", "adamw_apply", "xent_rows",
            "xent_grad"),
    # slice 15 ports no kernel: the train path on a mesh and the loss on
    # DTensor weights reach the assemble kernel through its sharding rule
    # and the loss's kernels through local_map (15b takes no gradient)
    "15a": ("rme_assemble", "adamw_sumsq", "adamw_apply", "xent_rows",
            "xent_grad"),
    "15b": ("rme_assemble", "xent_rows"),
    # the decode step on the card mesh, its cache's rows over "model": the
    # partial mode of flash_decode
    "15d": ("flash_decode_partial",),
}


def _wrappers() -> dict:
    from repro_torch.kernels import adamw as ak
    from repro_torch.kernels import xent
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
            "flash_decode": fa.flash_decode,
            "flash_decode_partial": fa.flash_decode_partial,
            "adamw_sumsq": ak.adamw_sumsq,
            "adamw_apply": ak.adamw_apply,
            "xent_rows": xent.xent_rows,
            "xent_grad": xent.xent_grad}


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

    card = card_line()
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
        rows = [row(dev) for row in kernel_table.ROWS]
        for r in rows:
            log(kernel_table.summary(r))
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
    torch.cuda.empty_cache()

    with torch.inference_mode():
        moe = _shape_cfg(MOE_ARCH)
        moe_kernel_checks(moe, dev, gen)
        # the earlier paths' models may sit in reference cycles (servers,
        # threads, closures): collect them, so the peak below is 13a's
        gc.collect()
        torch.cuda.empty_cache()
        log(f"slice 13a starts with {torch.cuda.memory_allocated(dev) / 2**30:.3f}"
            f" GiB allocated")

        def slice13a():
            torch.cuda.reset_peak_memory_stats(dev)
            return serve(moe, batch=LM_BATCH, prompt_len=LM_PROMPT,
                         gen=LM_GEN, seed=SEED, device=dev, log=log)

        (toks, stats), counts13a = run_path("13a", slice13a)
        peak = torch.cuda.max_memory_allocated(dev)
        want = {k: 0 for k in counts13a}
        want.update(rme_assemble=moe.n_layers * LM_GEN,
                    flash_attention=moe.n_layers,
                    flash_decode=moe.n_layers * (LM_GEN - 1))
        if counts13a != want:
            raise AssertionError(f"slice 13a launches {counts13a}, expected "
                                 f"{want}")
        moe_check(moe, toks, stats, peak, dev)
        del toks
        torch.cuda.empty_cache()
        family_kernel_checks(dev)
        _, counts13b = run_path("13b", lambda: family_paths(dev))

    # slice 14 trains: autograd, so outside inference mode
    gc.collect()
    torch.cuda.empty_cache()
    train_cfg = _train_cfg()
    t14 = time.perf_counter()
    log(f"slice 14a starts with {_gib(torch.cuda.memory_allocated(dev))} "
        f"allocated")
    run, counts14a = run_path("14a", lambda: train_full_width(train_cfg, dev))
    want = {k: 0 for k in counts14a}
    # a launch a layer in the forward and one in the remat recompute
    want["rme_assemble"] = TRAIN_STEPS * train_cfg.n_layers * 2
    # a launch of each a table of the tree's leaves a step
    want["adamw_sumsq"] = want["adamw_apply"] = TRAIN_STEPS * _adamw_tables(
        run["state"])
    # the loss's two kernels once a step (outside the remat recompute)
    want["xent_rows"] = want["xent_grad"] = TRAIN_STEPS
    if counts14a != want:
        raise AssertionError(f"slice 14a launches {counts14a}, expected "
                             f"{want}")
    plain14a = {"losses": list(run["losses"])}
    plain14a.update(train_check(train_cfg, run, card, dev))
    rows.append(plain14a.pop("row"))
    del run
    ckpt14b = tempfile.TemporaryDirectory()
    _, counts14b = run_path("14b", lambda: train_checkpoint_path(
        dev, ckpt14b.name))
    log(f"slice 14: {time.perf_counter() - t14:.1f} s with its checks")

    # slice 15: a one-rank NCCL group for the (1, 1) card mesh; the
    # dry-run's fake groups live in processes of their own
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    from repro_torch.launch.mesh import card_process_group
    with card_process_group():
        mesh = _card_mesh()
        run, counts15a = run_path("15a", lambda: train_on_mesh(
            train_cfg, mesh, dev))
        want = {k: 0 for k in counts15a}
        want["rme_assemble"] = TRAIN_STEPS * train_cfg.n_layers * 2
        want["adamw_sumsq"] = want["adamw_apply"] = \
            TRAIN_STEPS * _adamw_tables(run["state"])
        want["xent_rows"] = want["xent_grad"] = TRAIN_STEPS
        if counts15a != want:
            raise AssertionError(f"slice 15a launches {counts15a}, expected "
                                 f"{want}")
        mesh_train_check(train_cfg, run, plain14a)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        out15b, counts15b = run_path("15b", lambda: dtensor_loss_path(
            train_cfg, mesh, dev))
        want = {k: 0 for k in counts15b}
        want["rme_assemble"] = train_cfg.n_layers
        want["xent_rows"] = 1
        if counts15b != want:
            raise AssertionError(f"slice 15b launches {counts15b}, expected "
                                 f"{want}")
        dtensor_check(train_cfg, out15b, mesh, ckpt14b.name)
        del out15b
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            ref15d = mesh_decode_setup(dev)
        out15d, counts15d = run_path("15d", lambda: mesh_decode_path(
            ref15d, mesh, dev))
        want = {k: 0 for k in counts15d}
        want["flash_decode_partial"] = MESH_DECODE_LAYERS * MESH_DECODE_STEPS
        if counts15d != want:
            raise AssertionError(f"slice 15d launches {counts15d}, expected "
                                 f"{want}")
        mesh_decode_check(ref15d, out15d)
        del ref15d, out15d
    ckpt14b.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_cells(card)
    card_cell_check(train_cfg, plain14a, dev)
    log(f"slice 15: {time.perf_counter() - t15:.1f} s with its checks")
    if (n_unf, n_chn, n_convs) != (8, 4, 144):
        raise AssertionError(f"TM launches per forward {n_unf} unfused, "
                             f"{n_chn} chained, EDSR conv launches "
                             f"{n_convs}; expected 8, 4 and 144")
    by_slice = {1: counts1, 2: counts2, 3: counts3, 4: counts4, 5: counts5,
                11: counts11, "12a": counts12a, "12b": counts12b,
                "13a": counts13a, "13b": counts13b, "14a": counts14a,
                "14b": counts14b, "15a": counts15a, "15b": counts15b,
                "15d": counts15d}
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
