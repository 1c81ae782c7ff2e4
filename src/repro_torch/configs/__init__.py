"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures the port runs are registered."""
from __future__ import annotations

import importlib

from .base import ModelConfig, MoEConfig  # noqa: F401

_MODULES = {
    "qwen3-0.6b": "qwen3_06b",
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
