"""Oracle for the tm_affine kernels: the reference engine itself."""

from __future__ import annotations

import torch

from repro_torch.core.affine import MixedRadixMap
from repro_torch.core.engine import apply_map


def tm_affine_ref(x: torch.Tensor, m: MixedRadixMap) -> torch.Tensor:
    return apply_map(m, x)
