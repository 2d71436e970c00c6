"""Entry point of the bilinear-resize kernel + dispatch registration."""

from __future__ import annotations

import torch

from repro_torch.core.dispatch import register_rule
from repro_torch.core.instr import TMOpcode
from repro_torch.kernels.resize.resize import resize_bilinear


def resize_call(x: torch.Tensor, *, out_h: int, out_w: int) -> torch.Tensor:
    return resize_bilinear(x, out_h, out_w)


# ---------------------------------------------------------------------------
# dispatch-registry rule: RESIZE instructions (meta carries out_h/out_w)
# ---------------------------------------------------------------------------

def _resize_matches(ins, srcs, batch_dims, segment_bytes=None):
    if ins.opcode != TMOpcode.RESIZE or batch_dims != 0:
        return None
    if len(srcs) != 1 or srcs[0].ndim != 3:
        return None
    return "cuda.resize"


def _resize_run(ins, srcs, batch_dims, segment_bytes=None):
    return resize_call(srcs[0].contiguous(), out_h=ins.meta["out_h"],
                       out_w=ins.meta["out_w"])


register_rule("resize", _resize_matches, _resize_run, priority=20)
