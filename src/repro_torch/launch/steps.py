"""Step builders: prefill_step / serve_step per (arch × shape).

The port of the serving half of ``repro.launch.steps``.  The train step,
``cell()`` and the sharding specs come with the training slice (see
ROADMAP.md): on one GPU there is nothing to shard.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import decode_step, prefill

__all__ = ["make_serve_step", "make_prefill_step", "cell_config", "skip_reason"]

# archs whose attention is quadratic-full → long_500k is skipped
_FULL_ATTN_SKIP = {
    "whisper-small",
    "yi-34b",
    "mistral-large-123b",
    "granite-3-8b",
    "internvl2-2b",
    "grok-1-314b",
    "deepseek-v2-lite-16b",
}


def skip_reason(arch_id: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch_id in _FULL_ATTN_SKIP:
        return "full quadratic attention — 524k decode is not sub-quadratic (DESIGN.md §Arch-applicability)"
    return None


def cell_config(arch_id: str, shape_name: str, **overrides) -> ModelConfig:
    """Shape-specialized config (e.g. zamba2 long-context window)."""
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    kw: dict[str, Any] = {}
    if shape_name == "long_500k" and cfg.family == "hybrid":
        # zamba2's shared attention runs a sliding window at 500k
        kw["swa_window"] = 4096
    if shape.kind != "train":
        kw["remat"] = False
        kw["microbatches"] = 1
    kw.update(overrides)
    return cfg.replace(**kw) if kw else cfg


def make_prefill_step(cfg, shape: ShapeSpec) -> Callable:
    """``prefill_step(params, batch)``: the batch goes to ``prefill`` whole,
    so whisper's ``enc_frames`` and internvl2's ``img_emb`` travel with
    its ``tokens``; ``shape.seq_len`` is the cache capacity, an image
    prefix included."""

    def prefill_step(params, batch):
        return prefill(cfg, params, batch, max_len=shape.seq_len)

    return prefill_step


def make_serve_step(cfg) -> Callable:
    def serve_step(params, state, tokens):
        logits, new_state = decode_step(cfg, params, tokens, state)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, new_state

    return serve_step
