"""Gradient compression for the cross-pod all-reduce axis.

The port of ``repro.resilience.compression``.  Two transforms, both
usable as ``AdamW(grad_transform=...)``; they compress and decompress
locally, modelling the wire quantization error.  Gradients are mappings
of names to tensors (the port's ``AdamW`` convention).

* **int8 stochastic-rounding quantization** — 4× wire reduction,
  unbiased.  The noise comes from a seeded ``torch.Generator`` on the
  gradients' device: the same seed gives the same noise on every call,
  as ``jax.random.PRNGKey(seed)`` does in the JAX package, though not
  the same numbers.
* **top-k with error feedback** — keeps the k largest-|g| entries per
  leaf, accumulating the residual locally (Stich et al.); sparsity ~99%.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

__all__ = [
    "int8_quantize",
    "int8_dequantize",
    "int8_compress_transform",
    "topk_ef_transform",
]


def int8_quantize(g: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Per-tensor symmetric int8, with stochastic rounding when a
    ``generator`` is given (round to nearest, ties to even, without)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    x = g / scale
    if generator is not None:
        x = x + (torch.rand(g.shape, generator=generator, device=g.device) - 0.5)
    q = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    return q, scale.float()


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_compress_transform(seed: int = 0):
    """Round-trip int8 transform (models the wire quantization error)."""

    def transform(grads: Mapping) -> dict:
        out, gen = {}, None
        for name, g in grads.items():
            if gen is None:
                gen = torch.Generator(device=g.device).manual_seed(seed)
            q, s = int8_quantize(g.float(), gen)
            out[name] = int8_dequantize(q, s).to(g.dtype)
        return out

    return transform


def topk_ef_transform(k_frac: float = 0.01):
    """Top-k sparsification with error feedback.  Stateful: returns
    (transform, init_state) — the residual mapping must be threaded by
    the caller."""

    def init_state(grads: Mapping) -> dict:
        return {n: torch.zeros_like(g, dtype=torch.float32) for n, g in grads.items()}

    def transform(grads: Mapping, residual: Mapping):
        sent, new_residual = {}, {}
        for name, g in grads.items():
            x = g.float() + residual[name]
            flat = x.reshape(-1)
            k = max(1, int(flat.numel() * k_frac))
            thresh = torch.topk(torch.abs(flat), k).values[-1]
            mask = (torch.abs(x) >= thresh).float()
            s = x * mask
            sent[name], new_residual[name] = s.to(g.dtype), x - s
        return sent, new_residual

    return transform, init_state
