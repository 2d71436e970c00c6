"""The yardstick's counts against hand arithmetic at small shapes, and
against the figures of the port's kernel table."""

import pytest

from bench.counts import lm as counts
from bench.counts.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from bench.harness.lmcfg import Dims

DENSE = Dims(L=2, D=8, H=2, KV=1, hd=4, F=16, V=32)
MOE = Dims(L=3, D=8, H=2, KV=2, hd=4, F=12, V=32, E=4, k=2, Fe=6, E_phys=6)


def test_params_dense():
    attn = 8 * (2 + 2) * 4 + 2 * 4 * 8            # wqkv + wo
    mlp = 3 * 8 * 16
    assert counts.attn_params(DENSE) == attn == 192
    assert counts.params(DENSE) == 32 * 8 + 2 * (attn + mlp + 16) + 8


def test_params_moe_count_published_experts_only():
    ffn = 8 * 4 + 4 * 3 * 8 * 6 + 3 * 8 * 12       # router, 4 experts, shared
    active = 8 * 4 + 2 * 3 * 8 * 6 + 3 * 8 * 12
    assert counts.ffn_params(MOE) == ffn
    assert counts.active_ffn_params(MOE) == active
    attn = 8 * 6 * 4 + 8 * 8
    assert counts.params(MOE) == 32 * 8 + 3 * (attn + ffn + 16) + 8


def test_causal_attention_flops():
    # 2 products x 2 FLOPs x B x H x hd over S(S+1)/2 pairs
    assert counts.causal_attention_flops(1, 3, 1, 1) == 2 * 2 * 6
    assert counts.causal_attention_flops(2, 4, 3, 5) == 4 * 2 * 3 * 5 * 10


def test_train_step():
    B, S = 2, 4
    fwd = (2 * B * S * DENSE.L * (192 + 384)
           + DENSE.L * counts.causal_attention_flops(B, S, 2, 4)
           + 2 * B * S * 32 * 8)
    flops, nbytes = counts.train_step(DENSE, B, S)
    assert flops == 3 * fwd
    assert nbytes == 36 * counts.params(DENSE)      # 6 weights + 30 AdamW


def test_decode_step():
    B, n = 3, 10
    flops, nbytes = counts.decode_step(DENSE, B, n)
    assert flops == 2 * B * (2 * (192 + 384) + 32 * 8) + 2 * 4 * B * 2 * 4 * n
    # every weight once in bf16, then (n + 1) cache rows of K and V a layer
    assert nbytes == 2 * counts.params(DENSE) + B * (n + 1) * 2 * 2 * 1 * 4 * 2


def test_flash_kernels_match_the_kernel_table():
    # PERF.md's table: causal (8, 1024, 24, 128) is 51.59 GFLOP; the decode
    # of (8, 1, 24, 128) against (8, 1088, 8, 128) at length 1025 33.69 MB
    assert counts.causal_attention_flops(8, 1024, 24, 128) / 1e9 == \
        pytest.approx(51.59, abs=0.005)
    assert counts.flash_decode_bytes(8, 24, 8, 128, 1025) / 1e6 == \
        pytest.approx(33.69, abs=0.005)


def test_least_seconds_is_the_longer_bound():
    assert counts.least_seconds(BF16_FLOPS, 0) == 1.0
    assert counts.least_seconds(0, HBM_BYTES_PER_S) == 1.0
    assert counts.least_seconds(BF16_FLOPS, 2 * HBM_BYTES_PER_S) == 2.0
