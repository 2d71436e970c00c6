"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  It lists what the port can run: the dense archs without a
frontend.  The JAX package's other six arrive with their family."""

from __future__ import annotations

from repro_torch.configs import (command_r_plus_104b, granite_8b,
                                 mistral_nemo_12b, phi4_mini_3p8b)
from repro_torch.models.transformer import ModelConfig

ARCHS = {
    "mistral-nemo-12b": mistral_nemo_12b,
    "command-r-plus-104b": command_r_plus_104b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "granite-8b": granite_8b,
}


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(arch: str) -> ModelConfig:
    return ARCHS[arch].config()


def get_smoke(arch: str) -> ModelConfig:
    return ARCHS[arch].smoke_config()
