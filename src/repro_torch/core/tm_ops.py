"""Functional API over the TM layer — one callable per paper operator.

Every coarse operator here is executed by the *same* engine
(:func:`repro_torch.core.engine.apply_map`) parameterized by a
:class:`~repro_torch.core.affine.MixedRadixMap`, or by the RME
(:mod:`repro_torch.core.rme`) for fine-grained ops — the executable form of
the paper's claim that one reconfigurable datapath covers all TM operators.
They run on the device of their input.

Conventions: feature maps are channel-last ``(..., H, W, C)``; leading axes
pass through as batch axes.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import affine as af
from repro_torch.core import rme, tm_primitive
from repro_torch.core.engine import apply_map, route_gather


def _bd(x: torch.Tensor, core_ndim: int) -> int:
    return x.ndim - core_ndim


def _core(x: torch.Tensor, b: int) -> tuple[int, ...]:
    return tuple(x.shape[b:])


def _run_map(m: af.MixedRadixMap, x: torch.Tensor, b: int) -> torch.Tensor:
    """Execute a coarse map — or, under :func:`tag_tm_ops`, leave one tagged
    ``tm_map`` node in the traced graph for the compiler to match."""
    if tm_primitive.tagging():
        return tm_primitive.bind_map(m, x, batch_dims=b)
    return apply_map(m, x, batch_dims=b)


# -- coarse-grained ---------------------------------------------------------

def transpose(x: torch.Tensor) -> torch.Tensor:
    """(…, H, W, C) -> (…, W, H, C) — paper Transpose."""
    b = _bd(x, 3)
    return _run_map(af.transpose_map(_core(x, b)), x, b)


def rot90(x: torch.Tensor) -> torch.Tensor:
    """90° CCW rotation of the spatial dims — paper Rot90."""
    b = _bd(x, 3)
    return _run_map(af.rot90_map(_core(x, b)), x, b)


def pixel_shuffle(x: torch.Tensor, s: int) -> torch.Tensor:
    """(…, H, W, C·s²) -> (…, H·s, W·s, C) — paper PixelShuffle."""
    b = _bd(x, 3)
    return _run_map(af.pixel_shuffle_map(_core(x, b), s), x, b)


def pixel_unshuffle(x: torch.Tensor, s: int) -> torch.Tensor:
    """(…, H·s, W·s, C) -> (…, H, W, C·s²) — paper PixelUnshuffle."""
    b = _bd(x, 3)
    return _run_map(af.pixel_unshuffle_map(_core(x, b), s), x, b)


def upsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """Nearest-neighbour ×s upsample — paper Upsample."""
    b = _bd(x, 3)
    return _run_map(af.upsample_map(_core(x, b), s), x, b)


def split(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """Channel split into ``n`` equal parts — paper Split."""
    b = _bd(x, 3)
    return [_run_map(af.split_map(_core(x, b), n, p), x, b)
            for p in range(n)]


def route(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Channel concat — paper Route.  Gather-form: each band map reads its
    source; bands are summed (disjoint supports)."""
    b = _bd(xs[0], 3)
    maps = af.route_maps([_core(x, b) for x in xs])
    if tm_primitive.tagging():
        return tm_primitive.bind_route(maps, xs, batch_dims=b)
    return route_gather(maps, xs, batch_dims=b)


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Element-wise Add (residual) — paper Add.  Identity map + EW stage."""
    return x + y


def img2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
            pad: int = 0) -> torch.Tensor:
    """(…, H, W, C) -> (…, OH·OW, KH·KW·C) patch matrix — paper Img2col."""
    b = _bd(x, 3)
    return _run_map(af.img2col_map(_core(x, b), kh, kw, stride, pad), x, b)


def rearrange(x: torch.Tensor, group: int, pad_c: int) -> torch.Tensor:
    """RGB-stream -> burst-friendly high-channel fmap — paper Rearrange."""
    b = _bd(x, 3)
    return _run_map(af.rearrange_map(_core(x, b), group, pad_c), x, b)


# -- generic sequence-model manipulations (same datapath) -------------------

def permute(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """Arbitrary axis permutation as a coarse TM op (head-layout transposes)."""
    return _run_map(af.axis_permutation_map(tuple(x.shape), perm), x, 0)


def repeat_heads(x: torch.Tensor, rep: int, axis: int) -> torch.Tensor:
    """GQA KV broadcast: repeat along ``axis`` (Upsample along a head axis).

    out[..., h, ...] = in[..., h // rep, ...]
    """
    in_shape = tuple(x.shape)
    out_shape = list(in_shape)
    out_shape[axis] *= rep
    n = len(in_shape)
    A = [[af.Frac(0)] * (n + 1) for _ in range(n)]
    for i in range(n):
        A[i][i] = af.Frac(1)
    m = af.MixedRadixMap(
        out_shape=tuple(out_shape), in_shape=in_shape,
        splits=(af.DigitSplit(axis, rep),),
        affine=af.AffineMap(tuple(tuple(r) for r in A),
                            tuple(af.Frac(0) for _ in range(n))),
    )
    return _run_map(m, x, 0)


# -- fine-grained ------------------------------------------------------------

def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear Resize — paper Resize (fine-grained; weighted 4-tap gather).

    Half-pixel convention (align_corners=False), computed in float32 as the
    JAX package computes it: the four taps are affine gathers, the weights
    their fractional parts."""
    if tm_primitive.tagging():
        return tm_primitive.tm_resize(x, out_h, out_w)
    return _resize_bilinear_impl(x, out_h, out_w)


def _resize_bilinear_impl(x: torch.Tensor, out_h: int,
                          out_w: int) -> torch.Tensor:
    b = _bd(x, 3)
    H, W, _ = x.shape[b:]
    dev = x.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) \
        * (H / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
        * (W / out_w) - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, H - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[None, :, None]

    def g(yi, xi):
        return x.index_select(b, yi).index_select(b + 1, xi)

    v00, v01 = g(y0, x0), g(y0, x1)
    v10, v11 = g(y1, x0), g(y1, x1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    return out.to(x.dtype)


def bboxcal(pred: torch.Tensor, conf_threshold: float, capacity: int,
            score_index: int = 4,
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bboxcal — extract high-confidence boxes from YOLO head output.

    ``pred``: (N, D) rows of (x, y, w, h, conf, classes…).  RME *evaluate*
    scheme: confidence threshold -> packed survivors.  Returns
    ``(boxes, src_indices, count)``.
    """
    return rme.evaluate(pred, conf_threshold, capacity, cmp="ge",
                        score_index=score_index)


def bboxcal_rows(pred: torch.Tensor, conf_threshold: float, capacity: int,
                 score_index: int = 4, cmp: str = "ge") -> torch.Tensor:
    """Bboxcal, rows-only form with leading batch axes.

    ``pred``: (…, N, D) record streams; returns (…, capacity, D) packed
    survivors per stream (a FINE_EVALUATE instruction's result)."""
    if tm_primitive.tagging():
        return tm_primitive.tm_evaluate(pred, float(conf_threshold),
                                        capacity, cmp, score_index)
    return _bboxcal_rows_impl(pred, conf_threshold, capacity, cmp,
                              score_index)


def _bboxcal_rows_impl(pred: torch.Tensor, conf_threshold: float,
                       capacity: int, cmp: str,
                       score_index: int) -> torch.Tensor:
    lead = tuple(pred.shape[:-2])
    streams = pred.reshape((-1,) + tuple(pred.shape[-2:]))
    rows = [rme.evaluate(s, conf_threshold, capacity, cmp=cmp,
                         score_index=score_index)[0] for s in streams]
    return torch.stack(rows).reshape(lead + (capacity, pred.shape[-1]))


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy non-maximum suppression (YOLO post-processing, paper Fig. 1).

    ``boxes``: (N, 4) xywh.  Static-shape greedy NMS: ``max_out`` rounds of
    the evaluate scheme.  Returns ``(keep_idx, count)`` — ``keep_idx`` is
    (max_out,) int32 padded with N."""
    n = boxes.shape[0]
    x, y, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    x1, y1, x2, y2 = x - w / 2, y - h / 2, x + w / 2, y + h / 2
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    live = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    keep = torch.full((max_out,), n, dtype=torch.int32, device=boxes.device)
    cnt = 0
    ninf = torch.tensor(-float("inf"), dtype=scores.dtype,
                        device=scores.device)
    for _ in range(max_out):
        masked = torch.where(live, scores, ninf)
        i = int(torch.argmax(masked))
        if not bool(masked[i] > ninf):
            break  # empty: every later round would select nothing
        keep[cnt] = i
        cnt += 1
        xx1 = torch.maximum(x1[i], x1)
        yy1 = torch.maximum(y1[i], y1)
        xx2 = torch.minimum(x2[i], x2)
        yy2 = torch.minimum(y2[i], y2)
        inter = torch.clamp(xx2 - xx1, min=0) * torch.clamp(yy2 - yy1, min=0)
        iou = inter / torch.clamp(area[i] + area - inter, min=1e-9)
        live = live & ~(iou > iou_threshold)
        live[i] = False
    return keep, torch.tensor(cnt, dtype=torch.int32, device=boxes.device)
