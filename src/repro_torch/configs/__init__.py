"""Architecture registry of the port: one module per architecture it runs.

``get_config(name)`` returns the full published config (``CONFIG`` of
``repro_torch.configs.<arch>``), under the same names and aliases as
``repro.configs``; the port runs every one of them.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

ARCHS = (
    "recurrentgemma_2b",
    "deepseek_v3_671b",
    "granite_moe_1b_a400m",
    "xlstm_125m",
    "whisper_tiny",
    "internlm2_1_8b",
    "yi_9b",
    "starcoder2_7b",
    "qwen1_5_0_5b",
    "qwen2_vl_72b",
)

_ALIASES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "xlstm-125m": "xlstm_125m",
    "whisper-tiny": "whisper_tiny",
    "internlm2-1.8b": "internlm2_1_8b",
    "yi-9b": "yi_9b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


__all__ = ["ARCHS", "get_config", "get_shape", "SHAPES"]
