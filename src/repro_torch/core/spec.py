"""Tensor/layout metadata used across the TM layer."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape+dtype (+ logical axis names for sharding) of a TM buffer."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    axes: tuple[str, ...] | None = None  # logical axis names, len == ndim

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def with_shape(self, shape: tuple[int, ...]) -> "TensorSpec":
        return dataclasses.replace(self, shape=tuple(shape))


def row_major_strides(shape: tuple[int, ...]) -> tuple[int, ...]:
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return tuple(strides)
