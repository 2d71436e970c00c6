"""Assigned input-shape set (train_4k / prefill_32k / decode_32k / long_500k)
and the per-(arch, shape) input stand-ins.

The JAX package's ``configs/shapes.py``: where it builds
``jax.ShapeDtypeStruct``s, this builds tensors on the ``meta`` device,
which carry a shape and a dtype and are never allocated.

``long_500k`` requires sub-quadratic attention: live only for the SSM
(rwkv6) and hybrid (zamba2) families; the eight pure full-attention archs
skip it (recorded as ``skipped(full-attention)``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_is_live(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(live?, reason).  long_500k only for sub-quadratic families."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "skipped(full-attention)"
    return True, "live"


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _embeds_input(cfg: ModelConfig, B: int, S: int):
    return _abstract((B, S, cfg.d_model), cfg.dtype)


def shape_spec(shape: str | ShapeSpec) -> ShapeSpec:
    """A shape's name -> its :class:`ShapeSpec`; a ShapeSpec as it is (a
    cell at another batch and length than the four, such as a run on one
    card)."""
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def input_specs(cfg: ModelConfig, shape: str | ShapeSpec, *,
                scale: float = 1.0) -> dict:
    """Meta-tensor stand-ins for every input of the cell's step function.

    ``scale`` < 1 shrinks batch/seq for reduced test runs.  Training
    inputs are (tokens, labels), or (embeds, labels) for the stub-frontend
    archs; serving inputs add caches/states.
    """
    sp = shape_spec(shape)
    B = max(1, int(sp.global_batch * scale))
    S = max(128, int(sp.seq_len * scale)) if sp.seq_len > 128 else sp.seq_len
    i32 = torch.int32

    if sp.kind == "train":
        if cfg.frontend in ("audio_stub", "vision_stub"):
            return {"batch": {"embeds": _embeds_input(cfg, B, S),
                              "labels": _abstract((B, S), i32)}}
        return {"batch": {"tokens": _abstract((B, S), i32),
                          "labels": _abstract((B, S), i32)}}

    caches = _cache_specs(cfg, B, S)
    states = _state_specs(cfg, B)
    if sp.kind == "prefill":
        if cfg.frontend in ("audio_stub", "vision_stub"):
            tok = {"embeds": _embeds_input(cfg, B, S)}
        else:
            tok = {"tokens": _abstract((B, S), i32)}
        return {**tok, "caches": caches, "states": states}
    # decode: one new token against a seq_len-deep cache
    return {"token": _abstract((B, 1), i32),
            "caches": caches, "states": states,
            "index": _abstract((), i32)}


def _cache_specs(cfg: ModelConfig, B: int, S: int):
    cdt = torch.bfloat16
    if cfg.family in ("dense", "moe"):
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    elif cfg.family == "hybrid":
        k = cfg.attn_every or cfg.n_layers
        shape = (cfg.n_layers // k, B, S, cfg.n_kv_heads, cfg.hd)
    else:
        return None
    return {"k": _abstract(shape, cdt), "v": _abstract(shape, cdt)}


def _state_specs(cfg: ModelConfig, B: int):
    f32 = torch.float32
    if cfg.family == "ssm":
        L, D = cfg.n_layers, cfg.d_model
        H = D // cfg.ssm_head_dim
        K = cfg.ssm_head_dim
        return {"tprev": _abstract((L, B, 1, D), cfg.dtype),
                "fprev": _abstract((L, B, 1, D), cfg.dtype),
                "wkv": _abstract((L, B, H, K, K), f32)}
    if cfg.family == "hybrid":
        k = cfg.attn_every or cfg.n_layers
        ng, rem = divmod(cfg.n_layers, k)
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        return {"main": _abstract((ng, k, B, H, P, N), f32),
                "tail": _abstract((rem, B, H, P, N), f32)}
    return None
