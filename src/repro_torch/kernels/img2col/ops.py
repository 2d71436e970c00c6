"""Entry points of the img2col / conv kernels + dispatch registration."""

from __future__ import annotations

import torch

from repro_torch.core.affine import img2col_map
from repro_torch.core.dispatch import register_rule
from repro_torch.core.instr import TMOpcode
from repro_torch.kernels.img2col.img2col import conv2d, img2col


def img2col_call(x: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                 pad: int = 0, fill: float = 0.0) -> torch.Tensor:
    """(H, W, C) -> (OH·OW, kh·kw·C) patch matrix, ``fill`` in the padding."""
    return img2col(x, kh, kw, stride, pad, fill)


def conv2d_call(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                pad: int = 0) -> torch.Tensor:
    """Implicit-GEMM conv: x (H, W, C), w (kh, kw, C, OC) -> (OH, OW, OC)."""
    return conv2d(x, w, stride, pad)


# ---------------------------------------------------------------------------
# dispatch-registry rule: COARSE instructions tagged with img2col metadata
# run the img2col kernel instead of the generic gather.
# ---------------------------------------------------------------------------

def _img2col_matches(ins, srcs, batch_dims, segment_bytes=None):
    if ins.opcode != TMOpcode.COARSE or ins.ew is not None:
        return None
    cfg = (ins.meta or {}).get("img2col")
    if cfg is None or batch_dims != 0 or len(srcs) != 1:
        return None
    if srcs[0].ndim != 3 or ins.map_ is None \
            or tuple(srcs[0].shape) != ins.map_.in_shape:
        return None
    # the map is ground truth, meta only a lowering hint: decline unless the
    # hint reconstructs the map exactly (the generic gather then runs map_)
    expect = img2col_map(ins.map_.in_shape, cfg["kh"], cfg["kw"],
                         cfg.get("stride", 1), cfg.get("pad", 0),
                         fill=ins.map_.fill)
    if expect != ins.map_:
        return None
    return "cuda.img2col"


def _img2col_run(ins, srcs, batch_dims, segment_bytes=None):
    # the kernel writes the map's fill into the padding, as the reference
    # engine does (the JAX package's Pallas kernel always pads with zeros)
    cfg = ins.meta["img2col"]
    return img2col_call(srcs[0].contiguous(), kh=cfg["kh"], kw=cfg["kw"],
                        stride=cfg.get("stride", 1), pad=cfg.get("pad", 0),
                        fill=ins.map_.fill)


register_rule("img2col", _img2col_matches, _img2col_run, priority=20)
