"""Architecture registry: ``get_config("<arch-id>")`` (+ ``SHAPES``)."""

from importlib import import_module
from typing import Dict, List

from .base import (
    SHAPES,
    EncDecConfig,
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    VLMConfig,
    XLSTMConfig,
    cells_for,
    shape_applicable,
)

_MODULES = {
    "granite-20b": "granite_20b",
    "chatglm3-6b": "chatglm3_6b",
    "mistral-large-123b": "mistral_large_123b",
    "minitron-4b": "minitron_4b",
    "xlstm-1.3b": "xlstm_1_3b",
    "internvl2-26b": "internvl2_26b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-small": "whisper_small",
    "zamba2-2.7b": "zamba2_2_7b",
    "bert-base-paper": "bert_base",
}

ARCH_IDS: List[str] = [k for k in _MODULES if k != "bert-base-paper"]


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    return import_module(f"{__name__}.{_MODULES[arch]}").CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
