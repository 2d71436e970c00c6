"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers, the JAX package's ten archs in its order."""

from __future__ import annotations

from repro_torch.configs import (command_r_plus_104b, granite_8b,
                                 internvl2_1b, llama4_scout_17b_a16e,
                                 mistral_nemo_12b, musicgen_large,
                                 phi4_mini_3p8b, qwen2_moe_a2p7b, rwkv6_3b,
                                 zamba2_7b)
from repro_torch.models.transformer import ModelConfig

ARCHS = {
    "mistral-nemo-12b": mistral_nemo_12b,
    "command-r-plus-104b": command_r_plus_104b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "granite-8b": granite_8b,
    "musicgen-large": musicgen_large,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "qwen2-moe-a2.7b": qwen2_moe_a2p7b,
    "zamba2-7b": zamba2_7b,
    "rwkv6-3b": rwkv6_3b,
    "internvl2-1b": internvl2_1b,
}


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    return ARCHS[arch].config()


def get_smoke(arch: str) -> ModelConfig:
    return ARCHS[arch].smoke_config()
