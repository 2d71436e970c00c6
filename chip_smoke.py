#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (at first
use, into ``build/``), then runs four phases and fails on any mismatch:

1. kernels  — each kernel at the main path's shapes against its plain
   PyTorch version on the card (bit-exact), with its device time (from a
   CUDA graph of back-to-back launches) and its time per call with the
   wrapper's host work, the plain version's time, its bound (bytes /
   3.35 TB/s) and, where one PyTorch call computes the same function, that
   call's device time;
2. operators — the paper's Table III operators as single-instruction
   ``TMProgram``s through ``TMExecutor(backend="cuda")`` against
   ``backend="reference"``, bit-exact, with the expected ``cuda.*`` path;
3. model    — YOLOv3-Tiny at 448x448x3, 80 classes, batch 8, f32: the eager
   model and its detect tails against a hand-partitioned forward whose TM
   stages (Rearrange, Upsample + Route, reshape + Bboxcal for both heads)
   run as ``TMProgram``s through the cuda executor, packed boxes bit-exact;
4. the launch counts of phases 2-3 (the main path): every kernel > 0.

The last three lines of standard output are the card's name and power
limit as nvidia-smi gives them, the ``{"kernels": [...]}`` line and
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or without the repository's ``src`` beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
SECTOR = 32                # bytes: the least a strided load moves from HBM
SEED = 0
IMG = (8, 448, 448, 3)     # batch 8, paper Table III input
N_CLASSES = 80
CONF, CAPACITY = 0.5, 256
TABLE3 = (448, 448, 64)    # paper Table III feature map


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


def require_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise AssertionError(f"{what}: mismatch (shapes {tuple(a.shape)} / "
                             f"{tuple(b.shape)}, max |err| "
                             f"{max_abs_err(a, b) if a.shape == b.shape else 'n/a'})")


# ---------------------------------------------------------------------------
# the hand-partitioned YOLOv3-Tiny forward (what a compiler will partition)
# ---------------------------------------------------------------------------

def rearrange_program(img_core):
    """Paper Rearrange: the RGB stream into a 16-channel burst-friendly map."""
    from repro_torch.core import affine as af
    from repro_torch.core.instr import TMInstr, TMOpcode, TMProgram
    m = af.rearrange_map(img_core, 1, 16)
    return TMProgram([TMInstr(TMOpcode.COARSE, ("img",), "x", map_=m)],
                     ("img",), ("x",))


def neck_program(u0_core, skip_core):
    """The neck: Upsample x2 of the reduced map, Route with the skip map."""
    from repro_torch.core import affine as af
    from repro_torch.core.instr import TMInstr, TMOpcode, TMProgram
    up = af.upsample_map(u0_core, 2)
    route = tuple(af.route_maps([up.out_shape, skip_core]))
    return TMProgram([TMInstr(TMOpcode.COARSE, ("u0",), "u", map_=up),
                      TMInstr(TMOpcode.COARSE, ("u", "skip"), "cat",
                              maps=route)], ("u0", "skip"), ("cat",))


def detect_program(pred_core, conf, capacity):
    """A detect tail: the raw head grid laid out as record streams (COARSE
    reshape), then Bboxcal (FINE_EVALUATE)."""
    from repro_torch.core import affine as af
    from repro_torch.core.instr import (RMEConfig, TMInstr, TMOpcode,
                                        TMProgram)
    hg, wg, no = pred_core
    rows = af.reshape_map((hg, wg, no), (hg * wg * 3, no // 3))
    rme = RMEConfig(scheme="evaluate", threshold=conf, cmp="ge",
                    score_index=4, capacity=capacity)
    return TMProgram([TMInstr(TMOpcode.COARSE, ("p",), "rows", map_=rows),
                      TMInstr(TMOpcode.FINE_EVALUATE, ("rows",), "boxes",
                              rme=rme)], ("p",), ("boxes",))


def partitioned_forward(model, img, ex, *, conf=CONF, capacity=CAPACITY,
                        tm_events=None):
    """YOLOv3-Tiny with every TM stage run as a TMProgram through ``ex``
    (a ``TMExecutor``, batch axis lifted by the executor) and the
    convolutions as torch calls in between.  Returns ``(pred1, pred2,
    boxes1, boxes2, lowering paths)``.  With ``tm_events`` (a list), each
    TM stage is bracketed by a pair of CUDA events."""
    paths = []

    def stage(prog, bufs):
        if tm_events is not None:
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
        out, low, _ = ex.run(prog, bufs, batch_dims=1)
        if tm_events is not None:
            b.record()
            tm_events.append((a, b))
        paths.extend(low.paths())
        return out

    core = lambda t: tuple(t.shape[1:])  # noqa: E731
    x = stage(rearrange_program(core(img)), {"img": img})["x"]
    r, skip = model.trunk(x)
    pred1 = model.head1(r)
    u0 = model.neck_in(r)
    cat = stage(neck_program(core(u0), core(skip)),
                {"u0": u0, "skip": skip})["cat"]
    pred2 = model.head2(cat)
    boxes = [stage(detect_program(core(p), conf, capacity), {"p": p})["boxes"]
             for p in (pred1, pred2)]
    return pred1, pred2, boxes[0], boxes[1], paths


def eager_forward(model, img, *, conf=CONF, capacity=CAPACITY):
    """The port's eager model and its detect tails (the reference engine)."""
    from repro_torch.models import cnn
    pred1, pred2 = model(img)
    return (pred1, pred2, cnn.detect_tail_raw(pred1, conf, capacity),
            cnn.detect_tail_raw(pred2, conf, capacity))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_phase(dev, gen) -> list[dict]:
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
        library_ms=graph_ms(lambda: xf[flat], iters=10),
        shape="upsample x2 448x448x64 f32"))
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
    for r in rows:
        log(f"kernel {r['name']:17s} {r['shape']}: {r['ms']:.4f} ms device "
            f"({r['call_ms']:.4f} per call with host work; plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, library "
            f"{r['library_ms']}) max|err| {r['max_abs_err']}")
    return rows


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


def model_phase(dev, gen) -> None:
    from repro_torch.core.executor import TMExecutor
    from repro_torch.models import cnn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = cnn.init_yolov3_tiny(gen, n_classes=N_CLASSES, device=dev)
    img = torch.rand(IMG, generator=gen).to(dev)
    ex = TMExecutor(backend="cuda", device=dev)
    e1, e2, eb1, eb2 = eager_forward(model, img)
    p1, p2, b1, b2, paths = partitioned_forward(model, img, ex)
    for got, ref, what in ((p1, e1, "head 1"), (p2, e2, "head 2"),
                           (b1, eb1, "boxes head 1"),
                           (b2, eb2, "boxes head 2")):
        require_equal(got, ref, f"YOLOv3-Tiny {what}")
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"YOLOv3-Tiny {what}: non-finite values")
    expect = ["cuda.gather", "cuda.gather", "cuda.route", "cuda.gather",
              "cuda.rme.evaluate", "cuda.gather", "cuda.rme.evaluate"]
    if paths != expect:
        raise AssertionError(f"YOLOv3-Tiny TM stages lowered to {paths}")
    kept = [int((b[..., 4] >= CONF).sum()) for b in (b1, b2)]
    log(f"model YOLOv3-Tiny {IMG} {N_CLASSES} classes f32: heads "
        f"{tuple(p1.shape)} {tuple(p2.shape)}, boxes {tuple(b1.shape)} "
        f"{tuple(b2.shape)} bit-exact ({kept[0]} + {kept[1]} packed); "
        f"TM stages {paths}")
    # random weights may leave every confidence below CONF: hold the detect
    # tails also at a threshold the data crosses (head 2's 90th percentile)
    d = 5 + N_CLASSES
    conf2 = float(e2.reshape(-1, d)[:, 4].quantile(0.9))
    for i, pred in enumerate((p1, p2)):
        prog = detect_program(tuple(pred.shape[1:]), conf2, CAPACITY)
        got = ex.run(prog, {"p": pred}, batch_dims=1)[0]["boxes"]
        ref = cnn.detect_tail_raw(pred, conf2, CAPACITY)
        require_equal(got, ref, f"YOLOv3-Tiny boxes head {i + 1} at "
                                f"conf {conf2}")
        log(f"model detect tail {i + 1} at conf {conf2:.6g}: bit-exact, "
            f"{int((got[..., 4] >= conf2).sum())} packed")
    t_eager = wall_ms(lambda: eager_forward(model, img))
    t_part = wall_ms(lambda: partitioned_forward(model, img, ex))
    events: list = []
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    partitioned_forward(model, img, ex, tm_events=events)
    end.record()
    torch.cuda.synchronize()
    total = start.elapsed_time(end)
    tm = sum(a.elapsed_time(b) for a, b in events)
    log(f"model wall ms/forward: eager (engine TM) {t_eager:.3f}, "
        f"partitioned (cuda TM) {t_part:.3f}; TM share of one partitioned "
        f"forward {tm:.3f} of {total:.3f} ms = {tm / total:.3f}")


def launch_counts() -> dict[str, int]:
    from repro_torch.kernels.rme_gather.rme_gather import rme_evaluate
    from repro_torch.kernels.tm_affine.tm_affine import (tm_affine_block,
                                                         tm_affine_gather)
    return {"tm_affine_block": tm_affine_block.launches,
            "tm_affine_gather": tm_affine_gather.launches,
            "rme_evaluate": rme_evaluate.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels.rme_gather.rme_gather import rme_evaluate
    from repro_torch.kernels.tm_affine.tm_affine import (tm_affine_block,
                                                         tm_affine_gather)
    tm_affine_block.launches = 0
    tm_affine_gather.launches = 0
    rme_evaluate.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a GPU", file=sys.stderr)
        return 1
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
    with torch.inference_mode():
        rows = kernel_phase(dev, gen)
        reset_launch_counts()
        operator_phase(dev, gen)
        model_phase(dev, gen)
        counts = launch_counts()
    log(f"main-path launches: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: ({**r, "launches": counts[r["name"]]})[k] for k in keys}
               for r in rows]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
