"""Flash attention: prefill and one-token decode.

Two hand-written CUDA kernels (``csrc/flash_attention.cu``), each beside
its plain PyTorch version (:mod:`.ref`):

* :func:`flash_attention` / :func:`attention_ref` — causal or non-causal
  online-softmax attention (Pallas ``flash_attention``);
* :func:`flash_decode` / :func:`decode_ref` — one query per head against a
  KV cache whose positions ``>= length`` are masked (Pallas
  ``flash_decode``); ``length`` stays on the device;
* :func:`flash_decode_partial` / :func:`decode_partial_ref` — the same
  kernel over one block of cache rows, in its partial mode: the f32 pair
  ``(o, lse)`` that a decode over a cache spread over ranks along its
  rows combines (:func:`combine_partials`), where GSPMD partitions the
  Pallas kernel's softmax.

All take the Pallas layout, q, k, v of shape ``(BH, S, D)``, or the
model's, q ``(B, S, H, D)`` against k, v ``(B, Sk, KV, D)``, any strides
with the last one 1: query head h reads KV head ``h // (H // KV)``, so the
GQA repeat costs no copy and a slice of the fused QKV projection or a
layer of the stacked KV cache is passed as it lies.

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, or raises; ``launches`` counts wrapper calls that launched.
Each is also a custom op (:func:`prefill_op`, :func:`decode_op`,
:func:`decode_partial_op`: the plain version on the CPU, the kernel on
the card, shapes on the meta device, a FLOP formula; the first two a
DTensor sharding rule, the third runs on each rank's shards inside a
``local_map``), which the wrappers call for DTensors and fake tensors
(the third also for meta tensors), so a model under a mesh, or under FakeTensorMode, runs and
traces through them; plain tensors skip the dispatcher.

The prefill kernel is chosen by the element type alone, never by a
failure: bf16 runs ``fwd_tc_kernel`` on the tensor cores (wgmma, its tiles
copied by TMA, so q, k and v must be 16-byte aligned with strides a
multiple of 8 elements, or the call raises); f32 runs ``fwd_kernel``, FMA
outside the tensor cores (TF32 would break the f32 tolerance).  A decode
call launches two kernels, counted once: a split kernel over row splits of
the cache (:func:`decode_split` picks them from T and the grid, never
from ``length``; bf16 on ``mma.sync``, f32 on FMA) and
``decode_combine_kernel``, which sums the splits (in the partial mode
into ``(o, lse)``).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_ref, combine_partials, decode_partial_ref, decode_ref)
from repro_torch.kernels.tm_affine.tm_affine import DTYPE_CODES

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256


def _operands(name: str, q, k, v):
    """Check the operands of a launch; return their model-layout views and
    whether q was given in the Pallas layout."""
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_cuda:
            raise ValueError(f"{name}: {what} must be a CUDA tensor, got "
                             f"{t.device}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"{name}: q, k, v lie on different devices")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of {DTYPES}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.ndim == k.ndim == v.ndim and q.ndim in (3, 4)):
        raise ValueError(f"{name}: q, k, v must all be (BH, S, D) or "
                         f"(B, S, H, D) / (B, Sk, KV, D)")
    flat = q.ndim == 3
    if flat:
        q, k, v = q[:, :, None], k[:, :, None], v[:, :, None]
    B, S, H, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or k.shape[2] == 0 or H % k.shape[2]):
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if D % 8 or not 8 <= D <= MAX_D:
        raise ValueError(f"{name}: head dim {D} unsupported (a multiple of 8 "
                         f"up to {MAX_D})")
    if min(B, S, H, k.shape[1]) == 0:
        raise ValueError(f"{name}: empty operand q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must have stride 1")
    return q, k, v, flat


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_aligned(name: str, tensors, vec: int) -> None:
    """16-byte loads (decode) or TMA copies (bf16 prefill) need 16-byte
    aligned bases and strides a multiple of ``vec`` elements; the stride
    of a dim of extent 1 is never followed."""
    for t, what in tensors:
        if t.data_ptr() % 16 or any(
                s % vec for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"{name}: {what} must be 16-byte aligned with "
                             f"strides a multiple of {vec} elements")


def _strides(t: torch.Tensor) -> list[int]:
    """The first three strides, a dim of extent 1 given the head dim's
    extent (TMA wants every stride a multiple of 16 bytes)."""
    return [s if n > 1 else t.shape[3] for s, n in zip(t.stride()[:3],
                                                         t.shape[:3])]


SPLIT_ROWS = 64     # cache rows of a decode split: a multiple of this
BLOCKS_PER_SM = 3   # decode blocks per SM in the one wave decode_split aims at


def decode_split(T: int, blocks: int, sms: int) -> tuple[int, int]:
    """``(rows, splits)`` of a decode launch over a T-row cache: splits of
    a multiple of SPLIT_ROWS rows, as many as ``blocks`` (batch x KV heads
    x head chunks) times the splits keep in one wave of BLOCKS_PER_SM
    blocks on each of ``sms`` SMs (at the LM's decode shape 6 splits of
    192 rows measured faster than 9 of 128 or 17 of 64: PERF.md).  A
    function of the shapes only, so one captured decode serves every
    length."""
    want = max(1, BLOCKS_PER_SM * sms // blocks)
    rows = max(SPLIT_ROWS, -(-T // want))
    rows = -(-rows // SPLIT_ROWS) * SPLIT_ROWS
    return rows, -(-T // rows)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_plan(B: int, T: int, H: int, KV: int, device: torch.device,
                dtype: torch.dtype) -> tuple[int, int]:
    """``(rows, splits)`` of :func:`flash_decode` on ``device``: its blocks
    are (KV head, chunk of query heads, split, batch), the chunk 16 heads
    in bf16 (mma's M) and 4 in f32."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    chunk = 16 if dtype == torch.bfloat16 else 4
    return decode_split(T, B * KV * -(-(H // KV) // chunk), _sm_count(index))


def _prefill_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float | None) -> torch.Tensor:
    """One launch of the prefill kernel, or an exception."""
    lib = build.library("flash_attention")  # a kernel that cannot be built raises
    q4, k4, v4, flat = _operands("flash_attention", q, k, v)
    B, S, H, D = q4.shape
    Sk, KV = k4.shape[1], k4.shape[2]
    if q.dtype == torch.bfloat16:  # tensor-core kernel: TMA copies
        _require_aligned("flash_attention", ((q4, "q"), (k4, "k"), (v4, "v")),
                         8)
        if H // KV > 128:  # a block's 128 rows hold every head of a group
            raise ValueError(f"flash_attention: {H // KV} query heads per "
                             f"KV head; the bf16 kernel takes at most 128")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    strides = [s for t in (q4, k4, v4, out) for s in _strides(t)]
    rc = lib.flash_attention_fwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, S, Sk, H, KV, D, *strides, scale,
        int(causal), _stream(q))
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out[:, :, 0] if flat else out


def _decode_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   length, scale: float | None, partial: bool = False):
    """One decode launch (its split and combine kernels), or an
    exception: out in q's type, or with ``partial`` the f32 pair
    ``(o, lse)`` of :func:`flash_decode_partial`."""
    name = "flash_decode_partial" if partial else "flash_decode"
    lib = build.library("flash_attention")  # a kernel that cannot be built raises
    q4, k4, v4, flat = _operands(name, q, k, v)
    B, S, H, D = q4.shape
    T, KV = k4.shape[1], k4.shape[2]
    if S != 1:
        raise ValueError(f"{name}: one query per head, got S = {S}")
    # the kernel reads k, v rows 16 bytes at a time
    _require_aligned(name, ((k4, "k"), (v4, "v")), 16 // k4.element_size())
    if isinstance(length, torch.Tensor):
        if length.numel() != 1 or length.dtype.is_floating_point:
            raise ValueError(f"{name}: length must be one integer")
        length = length.reshape(1).to(device=q.device, dtype=torch.int32)
    else:  # any length <= 0 masks all rows alike, any >= T none
        length = torch.full((1,), max(-1, min(int(length), T)),
                            dtype=torch.int32, device=q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty(q4.shape, dtype=torch.float32 if partial else q.dtype,
                      device=q.device)
    rows, splits = decode_plan(B, T, H, KV, q.device, q.dtype)
    part = torch.empty((B, H, splits, D + 2), dtype=torch.float32,
                       device=q.device)  # each split's m, l and acc
    args = (DTYPE_CODES[q.dtype], B, T, H, KV, D, splits, rows,
            q4.stride(0), q4.stride(2), *k4.stride()[:3], *v4.stride()[:3],
            out.stride(0), out.stride(2), scale, _stream(q))
    ptrs = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), length.data_ptr(),
            part.data_ptr(), out.data_ptr())
    if partial:
        lse = torch.empty((B, 1, H), dtype=torch.float32, device=q.device)
        rc = lib.flash_attention_decode_partial(*ptrs, lse.data_ptr(), *args)
        build.check(rc, name)
        flash_decode_partial.launches += 1
        return (out[:, :, 0], lse[:, :, 0]) if flat else (out, lse)
    rc = lib.flash_attention_decode(*ptrs, *args)
    build.check(rc, name)
    flash_decode.launches += 1
    return out[:, :, 0] if flat else out


def _decode_partial_launch(q, k, v, length, scale):
    return _decode_launch(q, k, v, length, scale, partial=True)




# The custom ops ``repro_torch::flash_attention`` and
# ``repro_torch::flash_decode``: the plain version on the CPU, the kernel on
# the card, shapes alone on the meta device (fake tensors, the dry-run's
# trace), a FLOP formula for FlopCounterMode and a DTensor sharding rule.
# The wrappers below call them for DTensors and fake tensors only.
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def prefill_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, scale: float | None) -> torch.Tensor:
    # contiguous, as the fake's result is: DTensor views a sharded result
    # by the fake's strides (the plain version's is a transposed view
    # where the heads are not grouped)
    return attention_ref(q, k, v, causal=causal, scale=scale).contiguous()


prefill_op.register_kernel("cuda")(_prefill_launch)


@prefill_op.register_fake
def _(q, k, v, causal, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=(),
                         device_types="cpu")
def decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              length: torch.Tensor, scale: float | None) -> torch.Tensor:
    return decode_ref(q, k, v, length, scale=scale)


decode_op.register_kernel("cuda")(_decode_launch)


@decode_op.register_fake
def _(q, k, v, length, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_decode_partial",
                         mutates_args=(), device_types="cpu")
def decode_partial_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      length: torch.Tensor, scale: float | None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    return decode_partial_ref(q, k, v, length, scale=scale)


decode_partial_op.register_kernel("cuda")(_decode_partial_launch)


@decode_partial_op.register_fake
def _(q, k, v, length, scale):
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(q.shape[:-1], dtype=torch.float32))


def _attention_flops(q_shape, k_shape) -> int:
    """Both products, QK^T and PV, over every key (the causal mask's skip
    uncounted, as FlopCounterMode counts ``scaled_dot_product_attention``):
    4 x query rows x heads x keys x head dim."""
    H = q_shape[2] if len(q_shape) == 4 else 1
    return 4 * q_shape[0] * H * q_shape[1] * k_shape[1] * q_shape[-1]


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return _attention_flops(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return _attention_flops(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.flash_decode_partial)
def _(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return _attention_flops(q_shape, k_shape)


def _attention_shardings(q, k, extra: list) -> list:
    """Per mesh dim: replicated, or local to each rank's batch rows (dim
    0), or, in the model layout, to its heads (dim 2) where q's and k's
    heads are sharded alike and every rank's query heads read its own KV
    heads: only when the KV heads divide evenly over the whole mesh, since
    the heads may be sharded over more than one mesh dim.  Heads sharded
    unevenly would map query heads to the wrong KV groups."""
    out = [([Replicate()], [Replicate()] * 3 + extra),
           ([Shard(0)], [Shard(0)] * 3 + extra)]
    if q.ndim == 4 and k.shape[2] % q.mesh.size() == 0:
        out.append(([Shard(2)], [Shard(2)] * 3 + extra))
    return out


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _(q, k, v, causal, scale):
    return _attention_shardings(q, k, [None, None])


@register_sharding(torch.ops.repro_torch.flash_decode.default)
def _(q, k, v, length, scale):
    return _attention_shardings(q, k, [Replicate(), None])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Attention of q over k, v; out has q's shape and dtype.  CPU tensors:
    the plain version; CUDA tensors: the kernel, or an exception;
    DTensors and fake tensors: :func:`prefill_op` (its sharding rule, its
    fake)."""
    if build.through_op(q, k, v):
        return prefill_op(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    return _prefill_launch(q, k, v, causal, scale)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length, *, scale: float | None = None) -> torch.Tensor:
    """One query per head (q ``(BH, 1, D)`` or ``(B, 1, H, D)``) against the
    cache rows ``< length`` of k, v.  ``length`` is an int or an integer
    tensor of one element; on the card a tensor is read by the kernel, so
    the host never waits for it.  CPU tensors: the plain version; CUDA
    tensors: the kernel, or an exception; DTensors and fake tensors:
    :func:`decode_op` (its sharding rule, its fake; the length as a
    tensor)."""
    if not build.through_op(q, k, v):
        if q.device.type == "cpu":
            return decode_ref(q, k, v, length, scale=scale)
        return _decode_launch(q, k, v, length, scale)
    if not isinstance(length, torch.Tensor):
        # any length <= 0 masks all rows alike, any >= T none
        length = torch.full((1,), max(-1, min(int(length), k.shape[1])),
                            dtype=torch.int32, device=q.device)
    if isinstance(q, DTensor) and not isinstance(length, DTensor):
        length = DTensor.from_local(length, q.device_mesh, [Replicate()] *
                                    q.device_mesh.ndim, run_check=False)
    return decode_op(q, k, v, length, scale)


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, length, *,
                         scale: float | None = None):
    """:func:`flash_decode` over one block of a cache's rows, as the f32
    pair ``(o, lse)`` (:func:`decode_partial_ref`): the attention over the
    rows < ``length``, normalised, and the log of its softmax denominator;
    ``o = 0, lse = -inf`` where ``length <= 0``.  A decode over a cache
    whose rows are spread over ranks runs it on each rank's rows and
    combines the pairs (:func:`combine_partials`).  CPU tensors: the plain
    version; CUDA tensors: the kernel (the split kernel of
    :func:`flash_decode` and its combine in the partial mode), or an
    exception; DTensors, fake tensors and meta tensors (a rank's shards
    in the dry-run, inside a ``local_map``): :func:`decode_partial_op`
    (its fake)."""
    if not (build.through_op(q, k, v) or q.is_meta):
        if q.device.type == "cpu":
            return decode_partial_ref(q, k, v, length, scale=scale)
        return _decode_partial_launch(q, k, v, length, scale)
    if not isinstance(length, torch.Tensor):
        length = torch.full((1,), max(-1, min(int(length), k.shape[1])),
                            dtype=torch.int32, device=q.device)
    return decode_partial_op(q, k, v, length, scale)


flash_attention.launches = 0
flash_decode.launches = 0
flash_decode_partial.launches = 0
