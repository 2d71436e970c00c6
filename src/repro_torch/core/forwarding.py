"""Output forwarding — TM ops applied at producer tile-commit time.

Paper Fig. 5(c): the compute engine streams partial output tiles into the
TMU before the full operator finishes, so the next TM op starts early.  On
a GPU the analogue is applying the TM op's address map inside the producer
kernel's store: each product tile is written directly to its TM-transformed
destination, so the manipulation is finished the moment the product is.

Two realizations:
  * :func:`matmul_tm` — the ``matmul_tm`` kernels (the chain commit kernel
    applies ``m`` at commit, through
    :func:`repro_torch.kernels.matmul_tm.ops.matmul_tm_call`) or, as
    reference, the product followed by the engine;
  * :func:`forward_through` — generic producer wrapper for non-matmul ops.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.affine import MixedRadixMap
from repro_torch.core.engine import apply_map


def matmul_tm(x: torch.Tensor, w: torch.Tensor, m: MixedRadixMap | None,
              *, use_kernel: bool = False,
              batch_dims: int = 0) -> torch.Tensor:
    """``apply_map(m, x @ w)`` with the map folded into the producer.

    ``use_kernel`` selects the kernel path, whose store applies ``m`` at
    tile commit (true output forwarding); otherwise the product and the
    engine run one after the other."""
    if use_kernel and m is not None:
        from repro_torch.kernels.matmul_tm.ops import matmul_tm_call
        return matmul_tm_call(x, w, m)
    y = x @ w
    if m is None:
        return y
    return apply_map(m, y, batch_dims=batch_dims)


def forward_through(producer: Callable[..., torch.Tensor],
                    m: MixedRadixMap, *args, batch_dims: int = 0,
                    **kwargs) -> torch.Tensor:
    """Compose a TM map onto any producer's output."""
    y = producer(*args, **kwargs)
    return apply_map(m, y, batch_dims=batch_dims)
