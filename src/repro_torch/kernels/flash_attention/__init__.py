from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention_call, flash_decode_call)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    attention_ref, combine_partials, decode_partial_ref, decode_ref)
