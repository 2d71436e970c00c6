"""A configuration file's sizes, read two ways: as the port's
``ModelConfig`` (the program under test) and as the plain numbers the
reference and the counts use.

A configuration file holds the published ``config.json`` keys (with the
cut ones changed and listed under ``reduced``), ``assumed`` (where the
port's block departs from the published model) and ``run_as``: the
settings the configuration is run with, which the reference follows.
"""

from __future__ import annotations

import dataclasses

DTYPES = {"bfloat16", "float32"}


@dataclasses.dataclass(frozen=True)
class Dims:
    """What the reference and the counts read of a configuration."""
    L: int            # layers
    D: int            # hidden size
    H: int            # query heads
    KV: int           # key/value heads
    hd: int           # head size
    F: int            # dense MLP width (the shared expert's for MoE)
    V: int            # vocabulary
    E: int = 0        # routed experts (0: dense)
    k: int = 0        # experts per token
    Fe: int = 0       # routed expert width
    E_phys: int = 0   # experts the port holds (pad experts get no tokens)
    theta: float = 10000.0
    eps: float = 1e-6
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    dtype: str = "bfloat16"
    init_std: float = 0.02

    @property
    def moe(self) -> bool:
        return self.E > 0


def dims(c: dict) -> Dims:
    ra = c["run_as"]
    if ra.get("rotary_fraction", 1.0) != 1.0 or not ra.get(
            "tie_word_embeddings", True) or ra.get("dtype") not in DTYPES:
        raise ValueError(f"{c['name']}: run_as asks for a block the "
                         f"reference does not implement")
    D, H = c["hidden_size"], c["num_attention_heads"]
    moe = "num_experts" in c
    E = c["num_experts"] if moe else 0
    return Dims(
        L=c["num_hidden_layers"], D=D, H=H,
        KV=c.get("num_key_value_heads", H), hd=c.get("head_dim") or D // H,
        F=c["shared_expert_intermediate_size"] if moe
        else c["intermediate_size"],
        V=c["vocab_size"], E=E, k=c["num_experts_per_tok"] if moe else 0,
        Fe=c["moe_intermediate_size"] if moe else 0,
        E_phys=max(E, ra.get("moe_pad_experts", 0)) if moe else 0,
        theta=float(c["rope_theta"]), eps=float(ra["norm_eps"]),
        capacity_factor=float(ra.get("capacity_factor", 1.25)),
        aux_coef=float(ra.get("aux_coef", 0.01)), dtype=ra["dtype"],
        init_std=float(c["initializer_range"]))


def port_config(c: dict):
    """The port's ``ModelConfig`` for configuration ``c``."""
    import torch
    from repro_torch.models.transformer import ModelConfig
    d = dims(c)
    ra = c["run_as"]
    extra = {}
    if d.moe:
        extra = dict(num_experts=d.E, top_k=d.k, n_shared=ra["n_shared"],
                     moe_d_ff=d.Fe, capacity_factor=d.capacity_factor,
                     moe_pad_experts=ra.get("moe_pad_experts", 0),
                     moe_drop_sp=ra.get("moe_drop_sp", False))
    return ModelConfig(
        name=c["name"], family="moe" if d.moe else "dense", n_layers=d.L,
        d_model=d.D, n_heads=d.H, n_kv_heads=d.KV, head_dim=d.hd, d_ff=d.F,
        vocab=d.V, rope_theta=d.theta, max_seq=ra["max_seq"],
        dtype=getattr(torch, d.dtype), remat=ra.get("remat", "full"),
        attn_impl=ra.get("attn_impl", "scan"), **extra)
