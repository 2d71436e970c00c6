"""Flash attention: prefill and one-token decode.

Two hand-written CUDA kernels (``csrc/flash_attention.cu``), each beside
its plain PyTorch version (:mod:`.ref`):

* :func:`flash_attention` / :func:`attention_ref` — causal or non-causal
  online-softmax attention (Pallas ``flash_attention``);
* :func:`flash_decode` / :func:`decode_ref` — one query per head against a
  KV cache whose positions ``>= length`` are masked (Pallas
  ``flash_decode``); ``length`` stays on the device.

Both take the Pallas layout, q, k, v of shape ``(BH, S, D)``, or the
model's, q ``(B, S, H, D)`` against k, v ``(B, Sk, KV, D)``, any strides
with the last one 1: query head h reads KV head ``h // (H // KV)``, so the
GQA repeat costs no copy and a slice of the fused QKV projection or a
layer of the stacked KV cache is passed as it lies.

Each wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, or raises; ``launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref, decode_ref
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Attention of q over k, v; out has q's shape and dtype.  CPU tensors:
    the plain version; CUDA tensors: the kernel, or an exception."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    lib = build.library("flash_attention")  # a kernel that cannot be built raises
    q4, k4, v4, flat = _operands("flash_attention", q, k, v)
    B, S, H, D = q4.shape
    Sk, KV = k4.shape[1], k4.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    strides = [s for t in (q4, k4, v4, out) for s in t.stride()[:3]]
    rc = lib.flash_attention_fwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, S, Sk, H, KV, D, *strides, scale,
        int(causal), _stream(q))
    build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out[:, :, 0] if flat else out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length, *, scale: float | None = None) -> torch.Tensor:
    """One query per head (q ``(BH, 1, D)`` or ``(B, 1, H, D)``) against the
    cache rows ``< length`` of k, v.  ``length`` is an int or an integer
    tensor of one element; on the card a tensor is read by the kernel, so
    the host never waits for it.  CPU tensors: the plain version; CUDA
    tensors: the kernel, or an exception."""
    if q.device.type == "cpu":
        return decode_ref(q, k, v, length, scale=scale)
    lib = build.library("flash_attention")  # a kernel that cannot be built raises
    q4, k4, v4, flat = _operands("flash_decode", q, k, v)
    B, S, H, D = q4.shape
    T, KV = k4.shape[1], k4.shape[2]
    if S != 1:
        raise ValueError(f"flash_decode: one query per head, got S = {S}")
    vec = 16 // k4.element_size()  # the kernel reads k, v rows 16 bytes at a time
    for t, what in ((k4, "k"), (v4, "v")):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_decode: {what} must be 16-byte aligned "
                             f"with strides a multiple of {vec} elements")
    if isinstance(length, torch.Tensor):
        if length.numel() != 1 or length.dtype.is_floating_point:
            raise ValueError("flash_decode: length must be one integer")
        length = length.reshape(1).to(device=q.device, dtype=torch.int32)
    else:  # any length <= 0 masks all rows alike, any >= T none
        length = torch.full((1,), max(-1, min(int(length), T)),
                            dtype=torch.int32, device=q.device)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty(q4.shape, dtype=q.dtype, device=q.device)
    rc = lib.flash_attention_decode(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), length.data_ptr(),
        out.data_ptr(), DTYPE_CODES[q.dtype], B, T, H, KV, D,
        q4.stride(0), q4.stride(2), *k4.stride()[:3], *v4.stride()[:3],
        out.stride(0), out.stride(2), scale, _stream(q))
    build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out[:, :, 0] if flat else out


flash_attention.launches = 0
flash_decode.launches = 0
