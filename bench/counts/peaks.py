"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit)."""

BF16_FLOPS = 989e12          # bf16 tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3, bytes/s
