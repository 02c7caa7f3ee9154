"""Flash attention (causal, sliding window, GQA) as a hand-written CUDA
kernel, with its plain PyTorch version beside it."""
from .ops import (
    BF16_REL_TOL,
    bf16_rel_err,
    flash_attention,
    flash_attention_plain,
    launches,
    load,
    reset_launches,
)

__all__ = [
    "BF16_REL_TOL",
    "bf16_rel_err",
    "flash_attention",
    "flash_attention_plain",
    "launches",
    "reset_launches",
    "load",
]
