"""Architecture registry: ``--arch <id>`` resolution and the per-cell skip
rules (the port's copy of ``repro/configs/__init__.py``).

All ten configs are registered as data (``ARCH_IDS``): the ``tpu`` cost
model and the schedule search read them.  ``SERVED_ARCHS`` names the ones
whose model path is ported, the only ones a serve entry point builds: all
ten (the model still raises ``NotImplementedError`` on a config feature
none of them sets, ``check_ported``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import (chatglm3_6b, dbrx_132b, falcon_mamba_7b,
                                  llama4_maverick_400b, phi_3_vision_4_2b,
                                  qwen2_7b, recurrentgemma_2b, stablelm_1_6b,
                                  starcoder2_3b, whisper_small)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "falcon-mamba-7b": falcon_mamba_7b,
    "chatglm3-6b": chatglm3_6b,
    "starcoder2-3b": starcoder2_3b,
    "qwen2-7b": qwen2_7b,
    "stablelm-1.6b": stablelm_1_6b,
    "dbrx-132b": dbrx_132b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "whisper-small": whisper_small,
}

ARCH_IDS = list(_MODULES)

#: the configs whose model path the port runs (``launch/serve.py``)
SERVED_ARCHS = ["chatglm3-6b", "recurrentgemma-2b", "falcon-mamba-7b",
                "phi-3-vision-4.2b", "qwen2-7b", "stablelm-1.6b",
                "starcoder2-3b", "whisper-small", "dbrx-132b",
                "llama4-maverick-400b-a17b"]


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _MODULES[arch].reduced()


def cell_skip_reason(arch: str, shape_name: str) -> Optional[str]:
    """Why a (arch x shape) cell is skipped, or None if it runs:
    ``long_500k`` needs a sub-quadratic mixer, so pure full-attention archs
    skip it."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or (cfg.attn_chunk > 0))
        if not sub_quadratic:
            return "pure full-attention arch: 500k context is quadratic"
        if cfg.is_encdec:
            return "enc-dec decoder beyond published context"
    return None


def iter_cells():
    """All 40 (arch, shape) cells with skip annotations."""
    for arch in ARCH_IDS:
        for sname, shape in SHAPES.items():
            yield arch, sname, shape, cell_skip_reason(arch, sname)


__all__ = ["ARCH_IDS", "SERVED_ARCHS", "SHAPES", "ModelConfig",
           "ShapeConfig", "cell_skip_reason", "get_config", "get_reduced",
           "iter_cells"]
