"""The paper's application networks: ESPCN, EDSR, YOLOv3-Tiny.

These are the models of paper Table IV / Fig. 10 — the system-level
demonstration that TM ops (Rearrange, PixelShuffle, Upsample, Route, Add,
Bboxcal) glue the compute-intensive convolutions.  Every TM op routes
through :mod:`repro_torch.core.tm_ops`; convolutions are torch calls (the
compute engine's role), each behind one custom op (``conv2d_nhwc``,
``max_pool_nhwc``) so that a traced forward shows it as one node.

Layouts match the JAX package at every interface: activations NHWC, conv
weights HWIO, so parameters carried across with
:func:`repro_torch.models.convert.params_from_numpy` plug in unchanged.
Inside, the convolutions run on NCHW views in channels-last memory, so no
activation is copied to change layout.

Each network is an ``nn.Module`` built from a parameter dict with the JAX
package's keys (``ESPCN(params)`` is ``espcn(params, ·)`` there); the
``init_*`` functions draw the parameters from a ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import tm_ops
from repro_torch.core.executor import resolve_device


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_out_hw(H: int, W: int, kh: int, kw: int, stride: int,
                pad: str) -> tuple[int, int, int, int]:
    """``(OH, OW, pad_top, pad_left)`` of an NHWC conv, SAME or VALID
    padding as ``lax.conv_general_dilated`` computes it."""
    if pad == "SAME":
        (t, _), (le, _) = _same_pad(H, kh, stride), _same_pad(W, kw, stride)
        return -(-H // stride), -(-W // stride), t, le
    if pad == "VALID":
        return (H - kh) // stride + 1, (W - kw) // stride + 1, 0, 0
    raise ValueError(f"unknown padding {pad!r}")


# The convolution and the max pool are custom ops so that each reaches a
# traced graph (torch.fx make_fx) as ONE node, as conv_general_dilated and
# reduce_window do in a jaxpr: aten would otherwise show the NCHW permutes
# and the padding around them, which the compiler would claim as TM work.
# Both take any number of leading batch axes (folded into one inside the
# op), so their vmap rule moves the mapped axis to the front and calls the
# op again: a ``torch.func.vmap`` of a model leaves one node per op, and
# no reshape around it that the compiler would claim as TM work.

def _fold(x: torch.Tensor) -> torch.Tensor:
    """(*lead, H, W, C) -> (prod(lead), H, W, C), a view of contiguous x."""
    return x.reshape((-1,) + tuple(x.shape[-3:]))


@torch.library.custom_op("repro_torch::conv2d_nhwc", mutates_args=())
def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
                padding: str) -> torch.Tensor:
    """x: (*lead, H, W, C); w: (kh, kw, C, OC) -> (*lead, OH, OW, OC)."""
    kh, kw = w.shape[0], w.shape[1]
    xn = _fold(x).permute(0, 3, 1, 2)   # NCHW view of NHWC memory
    if padding == "SAME":
        (t, bo), (le, r) = (_same_pad(x.shape[-3], kh, stride),
                            _same_pad(x.shape[-2], kw, stride))
        if t or bo or le or r:
            xn = F.pad(xn, (le, r, t, bo))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    out = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    out = out.permute(0, 2, 3, 1).contiguous()
    return out.reshape(tuple(x.shape[:-3]) + tuple(out.shape[1:]))


@conv2d_nhwc.register_fake
def _(x, w, stride, padding):
    OH, OW, _, _ = conv_out_hw(x.shape[-3], x.shape[-2], w.shape[0],
                               w.shape[1], stride, padding)
    return x.new_empty(tuple(x.shape[:-3]) + (OH, OW, w.shape[3]))


@conv2d_nhwc.register_vmap
def _(info, in_dims, x, w, stride, padding):
    dx, dw = in_dims[0], in_dims[1]
    if dw is not None:
        raise NotImplementedError("conv2d_nhwc under vmap: the weights must "
                                  "not be mapped")
    return conv2d_nhwc(x.movedim(dx, 0), w, stride, padding), 0


def conv2d(x, w, b=None, *, stride=1, pad="SAME"):
    """x: (B, H, W, C); w: (kh, kw, C, OC) -> (B, OH, OW, OC)."""
    out = conv2d_nhwc(x, w, stride, pad)
    if b is not None:
        out = out + b
    return out


@torch.library.custom_op("repro_torch::max_pool_nhwc", mutates_args=())
def max_pool_nhwc(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Max pooling with SAME padding (padded positions never win); x:
    (*lead, H, W, C)."""
    xn = _fold(x).permute(0, 3, 1, 2)
    (t, bo), (le, r) = (_same_pad(x.shape[-3], k, stride),
                        _same_pad(x.shape[-2], k, stride))
    if t or bo or le or r:
        xn = F.pad(xn, (le, r, t, bo), value=-float("inf"))
    out = F.max_pool2d(xn, k, stride).permute(0, 2, 3, 1).contiguous()
    return out.reshape(tuple(x.shape[:-3]) + tuple(out.shape[1:]))


@max_pool_nhwc.register_fake
def _(x, k, stride):
    return x.new_empty(tuple(x.shape[:-3]) + (-(-x.shape[-3] // stride),
                                              -(-x.shape[-2] // stride),
                                              x.shape[-1]))


@max_pool_nhwc.register_vmap
def _(info, in_dims, x, k, stride):
    return max_pool_nhwc(x.movedim(in_dims[0], 0), k, stride), 0


def max_pool_same(x: torch.Tensor, k: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pooling with SAME padding (padded positions never win)."""
    return max_pool_nhwc(x, k, stride)


def _w(gen, kh, kw, c, oc, dtype):
    fan = kh * kw * c
    return (torch.randn((kh, kw, c, oc), generator=gen, dtype=torch.float32)
            * fan ** -0.5).to(dtype)


def _param(t) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(t), requires_grad=False)


# ===========================================================================
# ESPCN — efficient sub-pixel CNN (paper Table IV row 1)
# ===========================================================================

class ESPCN(nn.Module):
    """x: (B, H, W, 3) -> (B, H·s, W·s, 3).  The tail PixelShuffle is the
    TM op the paper forwards from the last conv (output forwarding)."""

    def __init__(self, params):
        super().__init__()
        self.c1, self.c2, self.c3 = (_param(params[k])
                                     for k in ("c1", "c2", "c3"))
        self.s = int(params["s"])

    def forward(self, x):
        h = torch.tanh(conv2d(x, self.c1))
        h = torch.tanh(conv2d(h, self.c2))
        h = conv2d(h, self.c3)
        return tm_ops.pixel_shuffle(h, self.s)


def init_espcn(gen: torch.Generator, *, c_in=3, s=3, dtype=torch.float32,
               device=None) -> ESPCN:
    params = {"c1": _w(gen, 5, 5, c_in, 64, dtype),
              "c2": _w(gen, 3, 3, 64, 32, dtype),
              "c3": _w(gen, 3, 3, 32, c_in * s * s, dtype), "s": s}
    return ESPCN(params).to(resolve_device(device))


# ===========================================================================
# EDSR (paper Fig. 4b: conv -> N resblocks (Add) -> conv -> PixelShuffle)
# ===========================================================================

class EDSR(nn.Module):
    def __init__(self, params):
        super().__init__()
        self.head = _param(params["head"])
        self.blocks = nn.ModuleList()
        for blk in params["blocks"]:
            m = nn.Module()
            m.c1, m.c2 = _param(blk["c1"]), _param(blk["c2"])
            self.blocks.append(m)
        self.up = _param(params["up"])
        self.s = int(params["s"])

    def forward(self, x, *, res_scale=0.1):
        h = conv2d(x, self.head)
        skip = h
        for blk in self.blocks:
            r = conv2d(F.relu(conv2d(h, blk.c1)), blk.c2)
            h = tm_ops.add(h, r * res_scale)      # TM Add (residual)
        h = tm_ops.add(h, skip)
        h = conv2d(h, self.up)
        return tm_ops.pixel_shuffle(h, self.s)    # TM PixelShuffle


def init_edsr(gen: torch.Generator, *, c_in=3, feats=64, n_blocks=8, s=2,
              dtype=torch.float32, device=None) -> EDSR:
    params = {
        "head": _w(gen, 3, 3, c_in, feats, dtype),
        "blocks": [{"c1": _w(gen, 3, 3, feats, feats, dtype),
                    "c2": _w(gen, 3, 3, feats, feats, dtype)}
                   for _ in range(n_blocks)],
        "up": _w(gen, 3, 3, feats, c_in * s * s, dtype),
        "s": s,
    }
    return EDSR(params).to(resolve_device(device))


# ===========================================================================
# YOLOv3-Tiny (paper Table IV: RR, RO, US, BB)
# ===========================================================================

class YOLOv3Tiny(nn.Module):
    """img: (B, H, W, 3) raw; preprocessing Rearrange -> backbone ->
    Route/Upsample neck -> two heads.  Returns (pred1, pred2) raw grids.

    The convolution stages between the TM stages are exposed as methods
    (:meth:`trunk`, :meth:`head1`, :meth:`neck_in`, :meth:`head2`), so a
    caller can run the TM stages elsewhere — through a ``TMExecutor`` — and
    keep the convolutions here."""

    def __init__(self, params):
        super().__init__()
        self.backbone = nn.ParameterList(
            [_param(w) for w in params["backbone"]])
        self.conv7 = _param(params["conv7"])
        self.head1_reduce = _param(params["head1_reduce"])
        self.up_reduce = _param(params["up_reduce"])
        self.head1_w = _param(params["head1"])
        self.head2_w = _param(params["head2"])
        self.n_classes = int(params["n_classes"])

    def trunk(self, x):
        """Rearranged input -> (r, skip): the reduced 1/32 feature map that
        feeds head 1 and the neck, and the 1/16 map the Route joins."""
        feats = []
        for i, w in enumerate(self.backbone):
            x = F.leaky_relu(conv2d(x, w), 0.1)
            if i < 5:
                x = max_pool_same(x)
            feats.append(x)
        x = F.leaky_relu(conv2d(x, self.conv7), 0.1)
        r = F.leaky_relu(conv2d(x, self.head1_reduce), 0.1)
        return r, feats[3]

    def head1(self, r):
        return conv2d(r, self.head1_w)

    def neck_in(self, r):
        """The neck's conv before its TM Upsample."""
        return F.leaky_relu(conv2d(r, self.up_reduce), 0.1)

    def head2(self, cat):
        return conv2d(cat, self.head2_w)

    def forward(self, img):
        # paper preprocessing: Rearrange of the RGB stream into a
        # burst-friendly 16-channel fmap (Table III: 448×448×3 -> 448×448×16)
        x = tm_ops.rearrange(img, 1, 16)
        r, skip = self.trunk(x)
        pred1 = self.head1(r)
        u = tm_ops.upsample(self.neck_in(r), 2)           # TM Upsample
        cat = tm_ops.route([u, skip])                     # TM Route
        return pred1, self.head2(cat)


def init_yolov3_tiny(gen: torch.Generator, *, c_in=16, n_classes=80,
                     dtype=torch.float32, device=None) -> YOLOv3Tiny:
    chans = [c_in, 16, 32, 64, 128, 256, 512]
    no = 3 * (5 + n_classes)
    params = {
        "backbone": [_w(gen, 3, 3, chans[i], chans[i + 1], dtype)
                     for i in range(6)],
        "n_classes": n_classes,
        "conv7": _w(gen, 3, 3, 512, 1024, dtype),
        "head1_reduce": _w(gen, 1, 1, 1024, 256, dtype),
        "head1": _w(gen, 1, 1, 256, no, dtype),
        "up_reduce": _w(gen, 1, 1, 256, 128, dtype),
        "head2": _w(gen, 1, 1, 128 + 128, no, dtype),
    }
    return YOLOv3Tiny(params).to(resolve_device(device))


# ===========================================================================
# Demo blocks — plain model fragments whose TM work a compiler lowers to
# TM instructions (superres tail, YOLO neck, detect tails).
# ===========================================================================

def superres_tail(x, skip, s=2):
    """EDSR/ESPCN tail in plain torch: depth-to-space (reshape/permute/
    reshape), residual add, border crop, re-pad."""
    B, H, W, C = x.shape
    c = C // (s * s)
    h = x.reshape(B, H, W, s, s, c).permute(0, 1, 3, 2, 4, 5)
    h = h.reshape(B, H * s, W * s, c)              # depth-to-space
    h = h + skip                                   # residual (TM Add)
    h = h[:, s:H * s - s, s:W * s - s, :]          # crop the border ring
    return F.pad(h, (0, 0, 1, 1, 1, 1))            # re-pad for a conv


def yolo_neck(u, skip):
    """YOLOv3-Tiny neck fragment: TM Upsample + Route (concatenate)."""
    u = tm_ops.upsample(u, 2)
    return torch.cat([u, skip], dim=-1)


def detect_tail(pred, conf_threshold=0.5, capacity=64):
    """Batched Bboxcal over raw head grids: (B, N, D) -> (B, capacity, D)."""
    return tm_ops.bboxcal_rows(pred, conf_threshold, capacity, score_index=4)


def detect_tail_raw(pred, conf_threshold=0.5, capacity=64):
    """The full detect tail as the paper runs it: the raw head grid
    (B, Hg, Wg, 3·(5+nc)) is first *laid out* into record streams (a COARSE
    reshape — TM work) and then Bboxcal'd (FINE evaluate)."""
    B, Hg, Wg, no = pred.shape
    rows = pred.reshape(B, Hg * Wg * 3, no // 3)
    return tm_ops.bboxcal_rows(rows, conf_threshold, capacity, score_index=4)


def yolo_postprocess(pred, conf_threshold=0.5, capacity=256,
                     iou_threshold=0.45, max_out=64):
    """Bboxcal (RME evaluate) + NMS over a raw head grid.

    pred: (B, Hg, Wg, 3·(5+nc)) -> per image ``(boxes, keep, count,
    keep_count)``, stacked over the batch."""
    B, Hg, Wg, no = pred.shape
    rows = pred.reshape(B, Hg * Wg * 3, no // 3)
    outs = []
    for r in rows:
        boxes, _, cnt = tm_ops.bboxcal(r, conf_threshold, capacity,
                                       score_index=4)
        live = torch.arange(capacity, device=r.device) < cnt
        scores = torch.where(live, boxes[:, 4],
                             torch.tensor(-float("inf"), dtype=boxes.dtype,
                                          device=r.device))
        keep, kcnt = tm_ops.nms(boxes[:, :4], scores, iou_threshold, max_out)
        outs.append((boxes, keep, cnt, kcnt))
    return tuple(torch.stack(t) for t in zip(*outs))
