"""Oracle for bilinear resize: the tm_ops implementation."""

from repro_torch.core.tm_ops import resize_bilinear as resize_ref  # noqa: F401
