"""Architecture config registry.

``get_config(arch_id)`` returns the full published config;
``get_reduced(arch_id)`` a CPU-smoke-testable shrink of the same family.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeSpec, reduced

ARCHS = [
    "rwkv6_3b",
    "whisper_small",
    "yi_34b",
    "mistral_large_123b",
    "h2o_danube_3_4b",
    "granite_3_8b",
    "internvl2_2b",
    "grok_1_314b",
    "deepseek_v2_lite_16b",
    "zamba2_2p7b",
]

# public ids (dashes) → module names (underscores)
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({a: a for a in ARCHS})
# the assignment's canonical ids
_ALIASES.update(
    {
        "rwkv6-3b": "rwkv6_3b",
        "whisper-small": "whisper_small",
        "yi-34b": "yi_34b",
        "mistral-large-123b": "mistral_large_123b",
        "h2o-danube-3-4b": "h2o_danube_3_4b",
        "granite-3-8b": "granite_3_8b",
        "internvl2-2b": "internvl2_2b",
        "grok-1-314b": "grok_1_314b",
        "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
        "zamba2-2.7b": "zamba2_2p7b",
    }
)


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{_ALIASES[arch_id]}", __package__)
    return mod.CONFIG


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)


def all_arch_ids() -> list[str]:
    return [a.replace("_", "-").replace("2p7b", "2.7b") for a in ARCHS]


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "get_reduced",
    "all_arch_ids",
    "reduced",
]
