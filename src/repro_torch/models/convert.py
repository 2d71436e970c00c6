"""Weights carried across from the JAX package.

:func:`params_from_numpy` turns a ``repro`` parameter pytree whose leaves
are numpy arrays (``jax.tree.map(np.asarray, p)``) into the port's
parameters: the same nested dicts and lists with torch tensors as leaves,
which the model classes in :mod:`repro_torch.models.cnn` and the LM of
:mod:`repro_torch.models.transformer` take as they are (bf16 leaves stay
bf16).  Python scalars (``"s"``, ``"n_classes"``) stay Python scalars.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray) -> torch.Tensor:
    # bf16 arrives as an ml_dtypes array numpy cannot hand to torch; the
    # round trip through f32 is exact.  np.array copies, so a read-only
    # buffer (what np.asarray gives for a device array) is never shared.
    if a.dtype.name == "bfloat16":
        return torch.tensor(np.array(a, dtype=np.float32)).to(torch.bfloat16)
    return torch.tensor(np.array(a))


def params_from_numpy(p, device=None):
    """Convert a pytree of numpy arrays into one of torch tensors, on
    ``device`` (None: the CPU, where conversion happens)."""
    if isinstance(p, dict):
        return {k: params_from_numpy(v, device) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [params_from_numpy(v, device) for v in p]
    if isinstance(p, (np.ndarray, np.generic)):
        t = _tensor(np.asarray(p))
        return t if device is None else t.to(device)
    return p
