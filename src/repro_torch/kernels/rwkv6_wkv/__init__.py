"""The RWKV6 wkv recurrence as a hand-written CUDA kernel, with its plain
PyTorch version beside it."""
from .ops import launches, load, reset_launches, wkv6, wkv6_plain

__all__ = ["wkv6", "wkv6_plain", "launches", "reset_launches", "load"]
