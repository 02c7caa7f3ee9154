"""Flash attention (causal, sliding window, GQA) as a hand-written CUDA
kernel, with its plain PyTorch version beside it."""
from .ops import flash_attention, flash_attention_plain, launches, load, reset_launches

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "launches",
    "reset_launches",
    "load",
]
