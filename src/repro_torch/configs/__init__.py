"""Architecture registry of the port: ``--arch <id>`` resolves here,
for every architecture the reference builds; and the dry run's cell
table (every architecture at every shape of ``SHAPES``, ``cells()``)
with the reference's per-architecture optimized settings."""
from __future__ import annotations

import importlib

from .base import (  # noqa: F401
    ModelConfig, MoEConfig, ShapeSpec, SHAPES, shape_by_name,
)

_MODULES = {               # the reference registry's order
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-tiny": "whisper_tiny",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen1.5-110b": "qwen15_110b",
    "qwen2-0.5b": "qwen2_05b",
    "qwen3-0.6b": "qwen3_06b",
    "stablelm-1.6b": "stablelm_16b",
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


#: per-arch optimized settings (config overrides, rules-variant name),
#: the reference's values: ``launch/dryrun.py --variant opt`` applies
#: them.  Per-shape exceptions in OPT_SHAPE_SETTINGS override these.
OPT_SETTINGS = {
    "qwen1.5-110b": ({"loss_chunk": "512", "param_dtype": "bfloat16",
                      "train_microbatch": "8"}, "sp"),
    "llama4-scout-17b-a16e": ({"loss_chunk": "512",
                               "param_dtype": "bfloat16",
                               "grad_accum_dtype": "bfloat16",
                               "train_microbatch": "8"}, "sp"),
    "deepseek-moe-16b": ({"loss_chunk": "512", "param_dtype": "bfloat16",
                          "grad_accum_dtype": "bfloat16"}, "sp"),
    "qwen2-vl-7b": ({"loss_chunk": "512", "param_dtype": "bfloat16"},
                    "sp"),
    "recurrentgemma-2b": ({"loss_chunk": "512",
                           "param_dtype": "bfloat16"}, "sp"),
    "rwkv6-3b": ({"loss_chunk": "512", "param_dtype": "bfloat16"}, "sp"),
    "qwen2-0.5b": ({"loss_chunk": "512", "param_dtype": "bfloat16"},
                   "default"),
    "qwen3-0.6b": ({"loss_chunk": "512", "param_dtype": "bfloat16"},
                   "default"),
    "stablelm-1.6b": ({"loss_chunk": "512", "param_dtype": "bfloat16"},
                      "default"),
    "whisper-tiny": ({"param_dtype": "bfloat16"}, "default"),
}

OPT_SHAPE_SETTINGS = {
    ("rwkv6-3b", "train_4k"): ({"loss_chunk": "512",
                                "param_dtype": "bfloat16"}, "default"),
    ("qwen2-0.5b", "train_4k"): ({"param_dtype": "bfloat16"}, "default"),
    ("whisper-tiny", "train_4k"): ({}, "default"),
}


def opt_settings_for(arch: str, shape: str):
    """(config overrides, rules-variant name) of one cell under
    ``--variant opt``."""
    if (arch, shape) in OPT_SHAPE_SETTINGS:
        return OPT_SHAPE_SETTINGS[(arch, shape)]
    return OPT_SETTINGS.get(arch, ({}, "default"))


def cells():
    """Every (arch, shape) cell, with skip reasons where applicable.

    Yields (arch_name, shape, skip_reason | None)."""
    for name in ARCH_NAMES:
        cfg = get(name)
        for shape in SHAPES:
            skip = None
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                skip = ("full quadratic attention at 524k context: "
                        "KV/score cost infeasible; brief directs skip "
                        "for pure full-attention archs")
            yield name, shape, skip

