"""Carry the JAX package's parameters into the port.

``params_from_jax(cfg, tree)`` takes the pytree that
``repro.models.init_params`` builds, with every leaf a numpy array
(``jax.tree.map(np.asarray, params)``), and returns the port's
:class:`~repro_torch.models.model.Model` holding the same weights.  A
segment whose reps the JAX package stacks along a leading axis is
un-stacked into one module per rep, and so are the encoder's stacked
blocks; zamba2's ``shared_attn`` block, the Mamba2 and RWKV6 leaves, the
MoE leaves (the router in f32, the experts ``[E, D, F]``/``[E, F, D]``,
the shared experts), MLA's, a decoder block's ``lnx``/``xattn``, the
encoder's ``norm`` and a VLM's ``img_norm`` come over as they are.  Importing this module imports no JAX: it reads numpy arrays only.

bf16 leaves arrive as numpy arrays of ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses.  They cross as their bits: a ``uint16``
view becomes a ``torch.uint16`` tensor, viewed as ``torch.bfloat16``.
Nothing is rounded on the way.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import resolve_device
from .model import Model, plan_segments

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor with a copy of ``a``'s values, in its dtype (bf16
    through its bits)."""
    a = np.array(a)  # a copy: arrays from JAX are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def params_from_jax(cfg, tree, device=None) -> Model:
    """The port's model with the weights of the JAX parameter tree
    ``tree`` (numpy leaves).  Raises on a missing leaf or a leaf whose
    shape or dtype differs from the port's parameter."""
    device = resolve_device(device)
    model = Model(cfg, device)

    def put(param: torch.Tensor, leaf, where: str) -> None:
        t = tensor_from_numpy(leaf)
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(
                f"params_from_jax: {where} is {tuple(t.shape)} {t.dtype}, the "
                f"port wants {tuple(param.shape)} {param.dtype}"
            )
        param.copy_(t)

    put(model.embed, tree["embed"], "embed")
    put(model.final_norm, tree["final_norm"], "final_norm")
    if not cfg.tie_embeddings:
        put(model.unembed, tree["unembed"], "unembed")
    def walk(subtree, name: str):
        for part in name.split("."):
            subtree = subtree[part]
        return subtree

    for si, seg in enumerate(plan_segments(cfg)):
        for r in range(seg.reps):
            for key, block in model.segs[si][r].items():
                for name, param in block.named_parameters():
                    leaf = walk(tree["segs"][si][key], name)
                    if seg.reps > 1:
                        leaf = np.asarray(leaf)[r]
                    put(param, leaf, f"segs[{si}][{key!r}].{name}[{r}]")
    if hasattr(model, "shared_attn"):
        for name, param in model.shared_attn.named_parameters():
            put(param, walk(tree["shared_attn"], name), f"shared_attn.{name}")
    if hasattr(model, "encoder"):
        for i, block in enumerate(model.encoder.blocks):
            for name, param in block.named_parameters():
                leaf = np.asarray(walk(tree["encoder"]["blocks"], name))[i]
                put(param, leaf, f"encoder.blocks.{name}[{i}]")
        put(model.encoder.norm, tree["encoder"]["norm"], "encoder.norm")
    if hasattr(model, "img_norm"):
        put(model.img_norm, tree["img_norm"], "img_norm")
    return model
