"""Common neural-net layers (torch, weights as ``[in, out]`` tensors, so
``linear`` is ``x @ w`` as in the JAX package).

The port of ``repro.models.layers``: the same functions with the f32
upcasts at the same places, so bf16 activations round where the JAX
code rounds them.  ``dense_init`` draws from an explicit
``torch.Generator``; the numbers differ from ``jax.random``'s, so tests
carry JAX's weights over with ``repro_torch.models.convert``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "resolve_device",
    "dense_init",
    "rmsnorm",
    "layernorm",
    "linear",
    "MLP",
    "mlp_apply",
    "rope_freqs",
    "apply_rope",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``None`` means the GPU, and
    raises when none is visible (there is no fallback to the CPU: pass
    ``device="cpu"`` to run there)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: no CUDA device is visible; pass "
            f"device='cpu' to run the model on the host"
        )
    return dev


@torch.no_grad()
def dense_init(w: torch.Tensor, generator: torch.Generator, scale=None) -> torch.Tensor:
    """Fill ``w`` in place with a truncated-normal fan-in init: values in
    [-2, 2] standard deviations, times ``scale`` (default 1/sqrt(fan_in)),
    drawn in f32 and cast to ``w``'s dtype."""
    fan_in = w.shape[0] if w.ndim > 1 else w.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    draw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.copy_(draw * scale)


def rmsnorm(x, gamma, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def layernorm(x, gamma, beta, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def linear(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class MLP(nn.Module):
    """``w_in`` and ``w_out``, and ``w_gate`` for the gated (SwiGLU) MLP."""

    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w_in = nn.Parameter(torch.empty(d_model, d_ff, **kw), requires_grad=False)
        self.w_out = nn.Parameter(torch.empty(d_ff, d_model, **kw), requires_grad=False)
        if act == "silu":
            self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw),
                                       requires_grad=False)


def mlp_apply(p: MLP, x, act="silu", hint=None):
    if act == "silu":
        h = F.silu(linear(x, p.w_gate)) * linear(x, p.w_in)
    else:  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(linear(x, p.w_in), approximate="tanh")
    if hint is not None:
        h = hint(h)
    return linear(h, p.w_out)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` copied to ``device`` once, not on every call."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta=1e4):
    """x: [..., S, H, hd]; positions: [..., S] int."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)  # [hd/2]
    ang = positions[..., :, None].float() * freqs  # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
    dt = x.dtype
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1).to(dt)
