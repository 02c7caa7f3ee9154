"""The Mamba2 SSD scan as a hand-written CUDA kernel, with its plain
PyTorch version beside it."""
from .ops import launches, load, reset_launches, ssd_scan, ssd_scan_plain

__all__ = ["ssd_scan", "ssd_scan_plain", "launches", "reset_launches", "load"]
