"""Fused AdamW on the card (``csrc/adamw.cu``).

Two wrappers over lists of leaves, each leaf a plain CUDA tensor (a
DTensor's local shard): :func:`adamw_sumsq`, each gradient's sum of
squares in f32, and :func:`adamw_apply`, one AdamW step that updates the
f32 master weights and moments in place and writes the parameter.  The
plain version of both is the eager code of :mod:`repro_torch.optim.adamw`
(``adamw_update_plain``), which is also what a CPU tensor takes; these
wrappers take only CUDA tensors and raise on anything else.

A launch holds a table of at most ``TABLE`` leaves, packed by the C entry
point into a kernel argument, so a tree of more leaves takes
``len(tables(n))`` launches of each (:func:`tables`).  ``launches`` on each
wrapper counts the tables it launched (the sums of squares' table is two
kernels: the partial sums and the final one).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TABLE = 64          # leaves a launch's table holds (kMaxLeaves in adamw.cu)
SUM_TILE = 16384    # elements a partial sum covers (kSumTile in adamw.cu)
GRAD_BF16, PARAM_BF16 = 1, 2  # bits of a leaf's kind
DTYPES = (torch.bfloat16, torch.float32)


def tables(n: int) -> list[range]:
    """The leaves of each launch, in order: consecutive runs of ``TABLE``,
    the last one shorter."""
    return [range(i, min(i + TABLE, n)) for i in range(0, n, TABLE)]


def _check(name: str, ts, dtypes, dev=None) -> torch.device:
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: every tensor must be a CUDA tensor, "
                             f"got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        dev = t.device
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
    return dev


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_uint64 * len(ts))(*(t.data_ptr() for t in ts))


def _counts(ts) -> ctypes.Array:
    return (ctypes.c_int64 * len(ts))(*(t.numel() for t in ts))


def _kinds(grads, params=None) -> ctypes.Array:
    kinds = [GRAD_BF16 * (g.dtype == torch.bfloat16) for g in grads]
    if params is not None:
        kinds = [k | PARAM_BF16 * (p.dtype == torch.bfloat16)
                 for k, p in zip(kinds, params)]
    return (ctypes.c_int * len(kinds))(*kinds)


def adamw_sumsq(grads: list[torch.Tensor]) -> torch.Tensor:
    """``(len(grads),)`` f32 on the card: each gradient's (bf16 or f32)
    sum of squares, the same bits on every run."""
    lib = build.library("adamw")
    if not grads:
        raise ValueError("adamw_sumsq: no gradients")
    dev = _check("adamw_sumsq", grads, DTYPES)
    groups = tables(len(grads))
    tiles = [sum(-(-grads[i].numel() // SUM_TILE) for i in r)
             for r in groups]
    partial = torch.empty(max(max(tiles), 1), dtype=torch.float32,
                          device=dev)
    sums = torch.empty(len(grads), dtype=torch.float32, device=dev)
    stream = build.current_stream(dev.index)
    for r, n_tiles in zip(groups, tiles):
        gs = grads[r.start:r.stop]
        rc = lib.adamw_sumsq(_ptrs(gs), _counts(gs), _kinds(gs), len(gs),
                             partial.data_ptr(), n_tiles,
                             sums[r.start:].data_ptr(), stream)
        build.check(rc, "adamw_sumsq")
        adamw_sumsq.launches += 1
    return sums


adamw_sumsq.launches = 0


def adamw_apply(grads, master, m, v, out, *, scale: torch.Tensor,
                c1: torch.Tensor, c2: torch.Tensor, lr: torch.Tensor,
                b1: float, b2: float, eps: float,
                weight_decay: float) -> None:
    """One AdamW step over the leaves: ``master``, ``m`` and ``v`` (f32)
    updated in place from ``grads`` (bf16 or f32), and each updated master
    weight written into ``out`` (bf16 or f32), leaf by leaf.  ``scale``,
    ``c1``, ``c2`` and ``lr`` are 0-d f32 tensors on the card, read there."""
    lib = build.library("adamw")
    if not grads:
        return
    n = len(grads)
    if not all(len(x) == n for x in (master, m, v, out)):
        raise ValueError("adamw_apply: the lists of leaves differ in length")
    dev = _check("adamw_apply", grads, DTYPES)
    _check("adamw_apply", [*master, *m, *v, scale, c1, c2, lr],
           (torch.float32,), dev)
    _check("adamw_apply", out, DTYPES, dev)
    for leaf in zip(grads, master, m, v, out):
        if len({t.numel() for t in leaf}) != 1:
            raise ValueError("adamw_apply: a leaf's tensors differ in size: "
                             f"{[tuple(t.shape) for t in leaf]}")
    if any(x.numel() != 1 for x in (scale, c1, c2, lr)):
        raise ValueError("adamw_apply: scale, c1, c2 and lr must be scalars")
    stream = build.current_stream(dev.index)
    for r in tables(n):
        gs, ps = grads[r.start:r.stop], out[r.start:r.stop]
        rc = lib.adamw_apply(
            _ptrs(gs), _ptrs(master[r.start:r.stop]),
            _ptrs(m[r.start:r.stop]), _ptrs(v[r.start:r.stop]), _ptrs(ps),
            _counts(gs), _kinds(gs, ps), len(gs), scale.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), lr.data_ptr(), b1, 1 - b1, b2,
            1 - b2, eps, weight_decay, stream)
        build.check(rc, "adamw_apply")
        adamw_apply.launches += 1


adamw_apply.launches = 0
