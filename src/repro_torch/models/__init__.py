"""Model zoo built on the TM layer (repro_torch.core.tm_ops)."""
