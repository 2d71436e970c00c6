"""The work a step needs, from the shapes alone: model FLOPs and the bytes
it has to move at the least, for the whole step and for the attention
kernels.  Frozen with the benchmark, so a change to a kernel cannot change
its yardstick.

Products count 2 FLOPs a multiply-add.  Parameters are counted as
published: the routed experts are the E published ones (never the port's
pad experts), k of them a token, every one of them live at these batches
(their weights read once a step).  Tied embeddings: the table is read by
the lookup and by the logits.  Bytes count each needed input once and each
output once, in the type it is served in (bf16, 2 bytes); recomputation is
not counted.
"""

from __future__ import annotations

from bench.counts.peaks import BF16_FLOPS, HBM_BYTES_PER_S

BF16 = 2
# AdamW at its fused least, bytes a parameter: the bf16 gradient read twice
# (its norm, then the update), the f32 master, m and v read and written,
# the bf16 parameter written
ADAMW_BYTES = 2 * 2 + 3 * 4 * 2 + 2
# a training step's weights read by the forward and by the backward, and
# the bf16 gradient written once
TRAIN_WEIGHT_BYTES = 2 * BF16 + BF16


def attn_params(d) -> int:
    return d.D * (d.H + 2 * d.KV) * d.hd + d.H * d.hd * d.D


def ffn_params(d) -> int:
    """One layer's MLP parameters: the dense SwiGLU, or the router, the E
    routed experts and the shared expert."""
    if not d.moe:
        return 3 * d.D * d.F
    return d.D * d.E + d.E * 3 * d.D * d.Fe + 3 * d.D * d.F


def active_ffn_params(d) -> int:
    """The MLP parameters one token multiplies by."""
    if not d.moe:
        return 3 * d.D * d.F
    return d.D * d.E + d.k * 3 * d.D * d.Fe + 3 * d.D * d.F


def params(d) -> int:
    """Every parameter: the table, the layers (two norms each), the final
    norm."""
    return d.V * d.D + d.L * (attn_params(d) + ffn_params(d) + 2 * d.D) \
        + d.D


def causal_attention_flops(B: int, S: int, H: int, hd: int) -> int:
    """QK^T and PV over the S(S+1)/2 live (query, key) pairs of each of B x
    H causal heads."""
    return 2 * 2 * B * H * hd * S * (S + 1) // 2


def forward_flops(d, tokens: int, B: int, S: int, logits: int) -> int:
    """A forward pass over ``tokens`` = B x S positions (causal within
    each sequence), ``logits`` of them unembedded."""
    return (2 * tokens * d.L * (attn_params(d) + active_ffn_params(d))
            + d.L * causal_attention_flops(B, S, d.H, d.hd)
            + 2 * logits * d.V * d.D)


def train_step(d, B: int, S: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one training step on B x S tokens: the forward
    and the backward (twice the forward's products), AdamW over every
    parameter."""
    flops = 3 * forward_flops(d, B * S, B, S, B * S)
    return flops, (TRAIN_WEIGHT_BYTES + ADAMW_BYTES) * params(d)


def kv_row_bytes(d) -> int:
    """One position's keys and values across the layers."""
    return 2 * d.L * d.KV * d.hd * BF16


def decode_step(d, B: int, length: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode step of B sequences whose caches hold
    ``length`` positions after it: the weights read once, the cache rows
    read once, the new row written."""
    flops = (2 * B * (d.L * (attn_params(d) + active_ffn_params(d))
                      + d.V * d.D)
             + d.L * 2 * 2 * B * d.H * d.hd * length)
    return flops, BF16 * params(d) + B * (length + 1) * kv_row_bytes(d)


def prefill(d, S: int) -> tuple[int, int]:
    """(FLOPs, bytes) of prefilling one prompt of S tokens into its cache,
    logits at the last position only."""
    return (forward_flops(d, S, 1, S, 1),
            BF16 * params(d) + S * kv_row_bytes(d))


def flash_decode_bytes(B: int, H: int, KV: int, hd: int, length: int,
                       elem: int = BF16) -> int:
    """One decode call: the cache rows up to ``length`` (keys and values)
    read once, q read and o written once."""
    return 2 * B * length * KV * hd * elem + 2 * B * H * hd * elem


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
