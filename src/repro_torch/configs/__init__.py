"""Architecture registry of the port: ``--arch <id>`` resolves here,
for every architecture the reference builds."""
from __future__ import annotations

import importlib

from .base import ModelConfig, MoEConfig  # noqa: F401

_MODULES = {
    "qwen3-0.6b": "qwen3_06b",
    "qwen2-0.5b": "qwen2_05b",
    "stablelm-1.6b": "stablelm_16b",
    "qwen1.5-110b": "qwen15_110b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the port knows {ARCH_NAMES}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get(name: str) -> ModelConfig:
    return _module(name).FULL


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
