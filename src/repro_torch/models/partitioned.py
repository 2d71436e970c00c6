"""Hand-partitioned forwards: the paper's networks with their TM stages run
as ``TMProgram``s through a :class:`~repro_torch.core.executor.TMExecutor`
(what a compiler front end will partition) and their convolutions in
between.

* :func:`partitioned_forward` — YOLOv3-Tiny: Rearrange, Upsample + Route
  and both detect tails (a COARSE reshape, then Bboxcal) as programs; its
  convolutions are the eager model's torch calls.
* :func:`edsr_partitioned_forward` — EDSR: every convolution through the
  implicit-GEMM ``conv2d_call``, the tail PixelShuffle as a program.

Each is held against the eager model of :mod:`repro_torch.models.cnn`.
"""

from __future__ import annotations

import torch

from repro_torch.core import affine as af
from repro_torch.core.instr import RMEConfig, TMInstr, TMOpcode, TMProgram
from repro_torch.kernels.img2col import ops as img2col_ops
from repro_torch.models import cnn

CONF, CAPACITY = 0.5, 256  # detect tails: score threshold, boxes kept

# the lowering of partitioned_forward's TM stages through the cuda
# executor, unfused and with fuse_chains=True
UNFUSED_PATHS = ["cuda.gather", "cuda.gather", "cuda.route", "cuda.gather",
                 "cuda.rme.evaluate", "cuda.gather", "cuda.rme.evaluate"]
CHAINED_PATHS = ["cuda.gather", "cuda.chain+route",
                 "cuda.chain+rme.evaluate", "cuda.chain+rme.evaluate"]


# ---------------------------------------------------------------------------
# YOLOv3-Tiny
# ---------------------------------------------------------------------------

def rearrange_program(img_core):
    """Paper Rearrange: the RGB stream into a 16-channel burst-friendly map."""
    m = af.rearrange_map(img_core, 1, 16)
    return TMProgram([TMInstr(TMOpcode.COARSE, ("img",), "x", map_=m)],
                     ("img",), ("x",))


def neck_program(u0_core, skip_core):
    """The neck: Upsample x2 of the reduced map, Route with the skip map."""
    up = af.upsample_map(u0_core, 2)
    route = tuple(af.route_maps([up.out_shape, skip_core]))
    return TMProgram([TMInstr(TMOpcode.COARSE, ("u0",), "u", map_=up),
                      TMInstr(TMOpcode.COARSE, ("u", "skip"), "cat",
                              maps=route)], ("u0", "skip"), ("cat",))


def detect_program(pred_core, conf, capacity):
    """A detect tail: the raw head grid laid out as record streams (COARSE
    reshape), then Bboxcal (FINE_EVALUATE)."""
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
    boxes1, boxes2, lowering paths, TM kernel launches)``.  With
    ``tm_events`` (a list), each TM stage is bracketed by a pair of CUDA
    events."""
    paths = []
    launches = 0

    def stage(prog, bufs):
        nonlocal launches
        if tm_events is not None:
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
        out, low, _ = ex.run(prog, bufs, batch_dims=1)
        if tm_events is not None:
            b.record()
            tm_events.append((a, b))
        paths.extend(low.paths())
        launches += low.launch_count()
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
    return pred1, pred2, boxes[0], boxes[1], paths, launches


def eager_forward(model, img, *, conf=CONF, capacity=CAPACITY):
    """The port's eager model and its detect tails (the reference engine)."""
    pred1, pred2 = model(img)
    return (pred1, pred2, cnn.detect_tail_raw(pred1, conf, capacity),
            cnn.detect_tail_raw(pred2, conf, capacity))


# ---------------------------------------------------------------------------
# EDSR
# ---------------------------------------------------------------------------

def pixel_shuffle_program(h_core, s):
    """The EDSR tail: PixelShuffle x s of the last conv's output."""
    m = af.pixel_shuffle_map(h_core, s)
    return TMProgram([TMInstr(TMOpcode.COARSE, ("h",), "y", map_=m)],
                     ("h",), ("y",))


def edsr_partitioned_forward(model, img, ex, *, res_scale=0.1):
    """EDSR with each conv through ``conv2d_call`` (the implicit-GEMM conv
    takes one (H, W, C) map, so image by image: 2 + 2 * n_blocks convs per
    image), the residual adds and ReLUs as torch calls in the eager model's
    order, and the tail PixelShuffle as a ``TMProgram`` through ``ex`` with
    the batch axis lifted.  Returns ``(output, lowering paths of the TM
    stage)``."""
    def conv(x, w):  # SAME padding of a stride-1 odd window
        return img2col_ops.conv2d_call(x, w, stride=1,
                                       pad=(w.shape[0] - 1) // 2)

    outs = []
    for x in img:
        h = conv(x, model.head)
        skip = h
        for blk in model.blocks:
            r = conv(torch.relu(conv(h, blk.c1)), blk.c2)
            h = h + r * res_scale
        outs.append(conv(h + skip, model.up))
    hs = torch.stack(outs)
    out, low, _ = ex.run(pixel_shuffle_program(tuple(hs.shape[1:]), model.s),
                         {"h": hs}, batch_dims=1)
    return out["y"], low.paths()
