"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures the port runs are registered."""
from __future__ import annotations

import importlib

from .base import ModelConfig, MoEConfig  # noqa: F401

_MODULES = {
    "qwen3-0.6b": "qwen3_06b",
    "qwen2-0.5b": "qwen2_05b",
    "stablelm-1.6b": "stablelm_16b",
    "qwen1.5-110b": "qwen15_110b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
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
