from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update, cosine_schedule,
                                     global_norm_clip)
from repro_torch.optim.compression import (compress_decompress,  # noqa: F401
                                           compression_init)
