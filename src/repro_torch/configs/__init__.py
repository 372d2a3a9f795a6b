"""Architecture registry: ``--arch <id>`` resolution.

Only configurations whose model path has been ported are registered.
"""
from __future__ import annotations

from repro_torch.configs import (chatglm3_6b, falcon_mamba_7b,
                                  phi_3_vision_4_2b, recurrentgemma_2b)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "chatglm3-6b": chatglm3_6b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
}

ARCH_IDS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _MODULES[arch].reduced()
