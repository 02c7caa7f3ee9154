"""AdamW with global-norm clipping and LR schedules, on torch tensors.

The port of ``repro.optim.adamw``.  The optimizer state dtype is
configurable (``cfg.opt_state_dtype``): f32 moments by default, bf16 for
the >100B archs where the moment memory would not fit the device.

``params`` is the port's model (an ``nn.Module``, its parameters by
``named_parameters()`` name) or a mapping of names to tensors; gradients
and the moments are mappings under the same names.  The JAX package
returns new arrays; here ``update`` writes the parameters and the
moments **in place** (a second copy of h2o-danube-3-4b's weights would
take another 8 GB of the card) and returns them, with the same
arithmetic: moments updated in f32 and stored in ``moment_dtype``, the
step in f32 from the f32 moments, decoupled decay on tensors with
``ndim >= 2`` only, the global norm in f32.

Distributed-optimization hooks:

* ``grad_transform`` — applied to the gradient mapping *before* the
  update; used by ``repro_torch.resilience.compression`` to plug in int8
  / top-k error-feedback compression.
* the update is shape-preserving and elementwise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, NamedTuple, Optional

import torch
from torch import nn

__all__ = ["AdamW", "OptState", "cosine_schedule", "linear_warmup_cosine"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


class OptState(NamedTuple):
    step: torch.Tensor  # scalar int32
    mu: dict  # first moment, by parameter name
    nu: dict  # second moment, by parameter name


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def lr(step):
        t = torch.clamp(_f32(step), max=float(total_steps)) / max(1, total_steps)
        c = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * c)

    return lr


def linear_warmup_cosine(
    base_lr: float, warmup: int, total_steps: int, final_frac: float = 0.1
):
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup), final_frac)

    def lr(step):
        step = torch.as_tensor(step)
        warm = base_lr * _f32(step) / max(1, warmup)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return lr


def named(params) -> dict:
    """``params`` as a dict of names to tensors (an ``nn.Module``'s by
    ``named_parameters()``)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"
    grad_transform: Optional[Callable] = None  # e.g. compression

    def init(self, params) -> OptState:
        dt = _DTYPES[self.moment_dtype]
        ps = named(params)
        device = next(iter(ps.values())).device if ps else None
        z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu={n: z(p) for n, p in ps.items()},
            nu={n: z(p) for n, p in ps.items()},
        )

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads: Mapping, state: OptState, params):
        """Returns (params, new_state, metrics); ``params`` and the
        moments are updated in place."""
        if self.grad_transform is not None:
            grads = self.grad_transform(grads)
        ps = named(params)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

        step = state.step + 1
        b1, b2 = self.b1, self.b2
        lr = self._lr(step)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        for name, p in ps.items():
            g32 = grads[name].float()
            if scale is not None:
                g32 = g32 * scale
            m, v = state.mu[name], state.nu[name]
            if m.dtype == torch.float32:  # in place: m itself is m32
                m32 = m.mul_(b1).add_((1 - b1) * g32)
                v32 = v.mul_(b2).add_((1 - b2) * g32 * g32)
            else:
                m32 = m.float() * b1 + (1 - b1) * g32
                v32 = v.float() * b2 + (1 - b2) * g32 * g32
                m.copy_(m32)
                v.copy_(v32)
            del g32
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
            if p.ndim >= 2:  # decoupled decay on matrices only
                delta = delta + self.weight_decay * p.float()
            if p.dtype == torch.float32:
                p.sub_(lr * delta)
            else:
                p.copy_(p.float() - lr * delta)
        return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
