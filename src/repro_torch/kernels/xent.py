"""Cross entropy's row statistics and gradient on the card (``csrc/xent.cu``).

:func:`nll` gives each position's negative log-likelihood from two kernels,
through a ``torch.autograd.Function``: :func:`xent_rows` (each row's nll,
max and sum of exp, one pass over the logits) in the forward,
:func:`xent_grad` (the gradient with respect to the logits, one pass more)
in the backward.  It takes CUDA tensors, bf16 or f32, whose last dimension
is contiguous and a multiple of 8 long, and raises on anything else.

A DTensor runs the same kernels on each rank's shard (``local_map``): rows
split over ranks are each rank's own, and a vocabulary split over ranks
takes the partial form, :func:`xent_rows_part` writing each rank's (max,
sum, gold) over its own columns, which :func:`combine` reduces over the
ranks that share a row, before :func:`xent_grad` takes the combined max
and sum on each rank's columns.  Where no rank holds less than the whole
vocabulary the whole-row form runs, so a mesh of one rank gives the plain
tensor's bits.

:func:`nll_plain` is the plain version, the eager f32 chain and its
backward by autograd, which runs wherever the tensors lie; :func:`on_card`
says which of the two ``softmax_xent`` (``models/layers.py``) takes.
``launches`` on each wrapper counts its launches.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensor
from torch.autograd.function import once_differentiable
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import build

DTYPES = (torch.bfloat16, torch.float32)
VEC = 8  # a row is whole vectors of this many elements


def on_card(logits: torch.Tensor) -> bool:
    """Whether the kernels take ``logits``: a CUDA tensor, or a DTensor
    whose shards are.  A fake tensor takes the plain version, as the CPU's
    and the dry-run's meta tensors do."""
    if isinstance(logits, DTensor):
        logits = logits.to_local()
    return logits.is_cuda and not isinstance(logits, FakeTensor)


def nll_plain(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's nll, ``lse - logits[label]`` in f32, by eager
    PyTorch wherever the tensors lie: logits (..., V), labels (...); a
    negative label reads column 0."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None]
                        .to(torch.int64))
    # the difference taken before the last dim is dropped: under a mesh
    # whose vocab is sharded, ``gold`` is a masked partial sum over the
    # vocab shards, which DTensor reduces only at the gathered shape
    return (lse[..., None] - gold)[..., 0]


def _check_logits(logits: torch.Tensor) -> None:
    if logits.dtype not in DTYPES:
        raise TypeError(f"xent: unsupported logits dtype {logits.dtype}")
    if logits.ndim < 1 or logits.stride(-1) != 1 or \
            logits.shape[-1] < VEC or logits.shape[-1] % VEC:
        raise ValueError(f"xent: the logits' last dimension must be "
                         f"contiguous and a multiple of {VEC} long, got "
                         f"shape {tuple(logits.shape)}, strides "
                         f"{logits.stride()}")


def _check_rows(what: str, logits: torch.Tensor, labels: torch.Tensor,
                *rows: torch.Tensor) -> None:
    """logits (N, V) on the card, each row whole 16-byte vectors; labels
    and each of ``rows`` (N,) contiguous on the same card, int64 and
    f32."""
    _check_logits(logits)
    if logits.ndim != 2 or logits.stride(0) < logits.shape[1]:
        raise ValueError(f"{what}: logits must be (rows, V) with rows that do "
                         f"not overlap, got shape {tuple(logits.shape)}, "
                         f"strides {logits.stride()}")
    if not logits.is_cuda:
        raise ValueError(f"{what}: the logits must be a CUDA tensor, got "
                         f"{logits.device}")
    size = logits.element_size()
    if logits.data_ptr() % 16 or logits.stride(0) * size % 16:
        raise ValueError(f"{what}: every row of the logits must start "
                         f"16-byte aligned, got rows {logits.stride(0)} "
                         f"elements apart from address {logits.data_ptr()}")
    for t, dtype in ((labels, torch.int64), *((r, torch.float32)
                                              for r in rows)):
        if t.device != logits.device or t.dtype != dtype or \
                t.shape != logits.shape[:1] or not t.is_contiguous():
            raise ValueError(f"{what}: a row tensor must be ({logits.shape[0]},"
                             f") {dtype} contiguous on {logits.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _rows(logits, labels, col0: int, vocab: int, whole: bool):
    """One launch of ``xent_rows``: ``(nll or None, max, sum, gold or
    None)``."""
    _check_rows("xent_rows", logits, labels)
    lib = build.library("xent")
    N, V = logits.shape
    mx, sm = (torch.empty(N, dtype=torch.float32, device=logits.device)
              for _ in range(2))
    nll = torch.empty_like(mx) if whole else None
    gold = None if whole else torch.empty_like(mx)
    rc = lib.xent_rows(logits.data_ptr(), N, V, logits.stride(0),
                       int(logits.dtype == torch.bfloat16), col0, vocab,
                       labels.data_ptr(),
                       *(None if t is None else t.data_ptr()
                         for t in (nll, mx, sm, gold)),
                       build.current_stream(logits.get_device()))
    build.check(rc, "xent_rows")
    xent_rows.launches += 1
    return nll, mx, sm, gold


def xent_rows(logits: torch.Tensor, labels: torch.Tensor):
    """``(nll, max, sum)``, each ``(N,)`` f32 on the card: each row's nll
    ``max + log(sum) - logits[clamp(label, 0)]`` (NaN for a label >= V),
    its max and its sum of ``exp(logits - max)``, for logits (N, V) bf16
    or f32 and int64 labels (N,).  The same bits on every run."""
    nll, mx, sm, _ = _rows(logits, labels, 0, logits.shape[-1], whole=True)
    return nll, mx, sm


xent_rows.launches = 0


def xent_rows_part(logits: torch.Tensor, labels: torch.Tensor, col0: int,
                   vocab: int):
    """:func:`xent_rows` on the columns ``[col0, col0 + V)`` of a
    vocabulary of ``vocab`` (labels are its columns): ``(max, sum,
    gold)``, each ``(N,)`` f32, gold the row's gold logit where these
    columns hold it, else 0 (NaN for a label >= ``vocab``).  Counts in
    ``xent_rows.launches``."""
    _, mx, sm, gold = _rows(logits, labels, col0, vocab, whole=False)
    return mx, sm, gold


def xent_grad(logits: torch.Tensor, labels: torch.Tensor, mx: torch.Tensor,
              sm: torch.Tensor, dnll: torch.Tensor, col0: int = 0,
              vocab: int | None = None) -> torch.Tensor:
    """The gradient of ``sum(dnll * nll)`` with respect to ``logits`` (N,
    V), in their dtype: ``(dnll / sum) * exp(logits - max)``, less
    ``dnll`` at ``clamp(label, 0)``, from the rows' ``max`` and ``sum``;
    zeros where ``dnll`` is 0.  ``col0`` and ``vocab`` as for
    :func:`xent_rows_part`, with the max and sum over the whole
    vocabulary (:func:`combine`)."""
    _check_rows("xent_grad", logits, labels, mx, sm, dnll)
    lib = build.library("xent")
    N, V = logits.shape
    out = torch.empty((N, V), dtype=logits.dtype, device=logits.device)
    rc = lib.xent_grad(logits.data_ptr(), N, V, logits.stride(0),
                       int(logits.dtype == torch.bfloat16), col0,
                       V if vocab is None else vocab, labels.data_ptr(),
                       mx.data_ptr(), sm.data_ptr(), dnll.data_ptr(),
                       out.data_ptr(), V,
                       build.current_stream(logits.get_device()))
    build.check(rc, "xent_grad")
    xent_grad.launches += 1
    return out


xent_grad.launches = 0


def combine(mx, sm, gold, amax, total):
    """Each row's ``(max, sum, nll)`` over the whole vocabulary from each
    rank's ``(max, sum, gold)`` over its columns (:func:`xent_rows_part`):
    ``amax`` and ``total`` reduce a tensor over the ranks that share the
    rows, by max and by sum.  The sums rescaled to the common max, as the
    kernel merges two threads' pairs."""
    m = amax(mx)
    s = total(sm * torch.exp(mx - m))
    return m, s, (m + torch.log(s)) - total(gold)


class _Xent(torch.autograd.Function):
    """nll (N,) of logits (N, V) and int64 labels (N,); the backward
    returns the logits' gradient in their dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        nll, mx, sm = xent_rows(logits, labels)
        ctx.save_for_backward(logits, labels, mx, sm)
        return nll

    @staticmethod
    @once_differentiable
    def backward(ctx, dnll):
        logits, labels, mx, sm = ctx.saved_tensors
        return xent_grad(logits, labels, mx, sm, dnll.contiguous()), None


class _XentPart(torch.autograd.Function):
    """:class:`_Xent` on a rank's columns ``[col0, col0 + V)`` of a
    vocabulary of ``vocab``, reduced over the ranks that share the rows
    with ``amax`` and ``total`` (:func:`combine`)."""

    @staticmethod
    def forward(ctx, logits, labels, col0, vocab, amax, total):
        m, s, nll = combine(*xent_rows_part(logits, labels, col0, vocab),
                            amax, total)
        ctx.save_for_backward(logits, labels, m, s)
        ctx.cols = col0, vocab
        return nll

    @staticmethod
    @once_differentiable
    def backward(ctx, dnll):
        logits, labels, m, s = ctx.saved_tensors
        return (xent_grad(logits, labels, m, s, dnll.contiguous(),
                          *ctx.cols), None, None, None, None, None)


def _flat(logits, labels):
    """logits (N, V) and int64 labels (N,) of logits (..., V), labels
    (...)."""
    return (logits.reshape(-1, logits.shape[-1]),
            labels.reshape(-1).to(torch.int64).contiguous())


def _nll_whole(logits, labels):
    return _Xent.apply(*_flat(logits, labels)).view(labels.shape)


def _all_reduce(t, op: str, mesh, dims) -> torch.Tensor:
    """``t`` reduced with ``op`` over the mesh dims ``dims`` in turn."""
    for d in dims:
        t = funcol.all_reduce(t, op, (mesh, d))
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _nll_mesh(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """:func:`nll` of DTensor logits, each rank's shard through the
    kernels.  The rows keep the logits' placements (a ``Partial`` sum is
    taken first), labels (a plain tensor counts as replicated) are laid out
    like them, and so is the result.  A vocabulary split over more than
    one rank takes the partial form, its first column on this rank by
    ``torch.chunk``'s split, as DTensor shards."""
    mesh, last, vocab = logits.device_mesh, logits.ndim - 1, logits.shape[-1]
    places = tuple(Replicate() if p.is_partial() else p
                   for p in logits.placements)
    rows = tuple(Replicate() if p.is_shard(last) else p for p in places)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    split = [d for d, p in enumerate(places)
             if p.is_shard(last) and mesh.size(d) > 1]
    fn = _nll_whole
    if split:
        col0, extent = 0, vocab
        for d in split:
            chunk = -(-extent // mesh.size(d))
            start = min(mesh.get_local_rank(d) * chunk, extent)
            col0, extent = col0 + start, min(chunk, extent - start)

        def fn(x, lab):
            return _XentPart.apply(
                *_flat(x, lab), col0, vocab,
                lambda t: _all_reduce(t, "max", mesh, split),
                lambda t: _all_reduce(t, "sum", mesh, split)).view(lab.shape)

    # local_map reads a tuple as one entry per output, a list as one output
    return local_map(fn, out_placements=list(rows),
                     in_placements=(places, rows),
                     redistribute_inputs=True, device_mesh=mesh)(logits,
                                                                 labels)


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:func:`nll_plain` on the card: logits (..., V) bf16 or f32 with a
    contiguous last dimension a multiple of 8 long, labels (...); each
    position's nll in f32, differentiable with respect to the logits.  A
    DTensor's shards each take the kernels (:func:`_nll_mesh`)."""
    _check_logits(logits)
    if isinstance(logits, DTensor):
        return _nll_mesh(logits, labels)
    return _nll_whole(logits, labels)
