"""Step builders: train_step / prefill_step / serve_step per (arch × shape).

The port of ``repro.launch.steps``.  ``cell()`` returns everything the
dry-run needs: the step function, its arguments as fake tensors at full
size (``FakeTensorMode``: shapes and dtypes, no data, where the
reference has ``ShapeDtypeStruct``s) and the specs of its inputs and
outputs on a mesh (``launch.sharding``).

The train step differentiates ``loss_fn`` with torch autograd through
the torch twins of the kernels (``cfg.use_flash=False``), as the JAX
package trains through its jnp twins: no kernel has a backward.  It
turns gradients on for the parameters of the model it trains for the
length of the step and back off after, and AdamW updates the
parameters and moments in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models import decode_step, loss_fn, make_decode_state, prefill
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, OptState

from .sharding import P, batch_specs, param_specs, state_specs

__all__ = ["cell", "Cell", "make_train_step", "make_optimizer", "make_serve_step",
           "make_prefill_step", "cell_config", "skip_reason", "param_specs_like"]

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


def make_optimizer(cfg) -> AdamW:
    return AdamW(lr=3e-4, moment_dtype=cfg.opt_state_dtype)


def _grads(cfg, params, named: dict, batch):
    """(loss, gradients by parameter name) of ``loss_fn`` on ``batch``;
    a parameter the loss does not reach gets zeros, as in JAX."""
    with torch.enable_grad():
        loss, _ = loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named.items(), grads)}


def make_train_step(cfg, optimizer: Optional[AdamW] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: gradients of the mean loss over ``cfg.microbatches``
    microbatches (accumulated in f32, split along the batch), then one
    AdamW update in place."""
    cfg = cfg.replace(use_flash=False)
    opt = optimizer or make_optimizer(cfg)

    def train_step(params, opt_state, batch):
        mb = cfg.microbatches
        named = dict(params.named_parameters())
        wanted = {n: p.requires_grad for n, p in named.items()}
        try:
            for p in named.values():
                p.requires_grad_(True)
            if mb <= 1:
                loss, grads = _grads(cfg, params, named, batch)
            else:
                grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for n, p in named.items()}
                loss = 0.0
                for i in range(mb):
                    mbatch = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                              for k, v in batch.items()}
                    l, g = _grads(cfg, params, named, mbatch)
                    for n, gn in g.items():
                        grads[n] += gn.float()
                    loss = loss + l
                    del g
                grads = {n: g / mb for n, g in grads.items()}
                loss = loss / mb
        finally:
            for n, p in named.items():
                p.requires_grad_(wanted[n])
        new_params, new_opt, opt_metrics = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, **opt_metrics}

    return train_step


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


# ---------------------------------------------------------------------------
# cell assembly (fn + fake arguments + specs)
# ---------------------------------------------------------------------------

# the device the fake tensors name: a dry-run computes nothing, and the
# kernel wrappers take their fake route on any device
_FAKE_DEVICE = "cpu"


@dataclass
class Cell:
    arch_id: str
    shape: ShapeSpec
    cfg: ModelConfig
    fn: Callable
    args: tuple  # fake tensors (and the model holding them)
    in_shardings: tuple  # spec trees
    out_shardings: Any
    kind: str


def _param_shapes(cfg, fake_mode: FakeTensorMode) -> Model:
    """The model of ``cfg`` at full size on fake tensors: ``Model(cfg,
    "meta")`` (no data and no generator), each parameter then replaced by
    a fake tensor of its shape and dtype."""
    model = Model(cfg, "meta")
    with fake_mode:
        for mod in model.modules():
            for name, p in list(mod._parameters.items()):
                mod._parameters[name] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device=_FAKE_DEVICE),
                    requires_grad=p.requires_grad)
    return model


def _fake_batch(cfg, shape: ShapeSpec) -> dict:
    """One global batch of ``make_batch_specs``'s shapes and dtypes (token
    ids as numpy dtypes, embeddings as torch ones), under the caller's
    fake mode."""
    return {k: torch.empty(s, device=_FAKE_DEVICE, dtype=dt if isinstance(dt, torch.dtype)
                           else torch.from_numpy(np.empty(0, dt)).dtype)
            for k, (s, dt) in make_batch_specs(cfg, shape).items()}


def cell(arch_id: str, shape_name: str, mesh, **cfg_overrides) -> Cell:
    """Build the dry-run cell for (arch × shape) on ``mesh`` (a
    ``DeviceMesh`` or a mapping of axis name to size)."""
    cfg = cell_config(arch_id, shape_name, **cfg_overrides)
    shape = SHAPES[shape_name]
    # real tensors a step makes from constants (a cached rotary table)
    # join the fake ones
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    params = _param_shapes(cfg, fake_mode)
    p_spec = param_specs(params, mesh)
    seq_sharded = shape.global_batch == 1

    with fake_mode:
        if shape.kind == "train":
            opt = make_optimizer(cfg)
            opt_state = opt.init(params)
            o_spec = param_specs_like(opt_state, p_spec)
            batch = _fake_batch(cfg, shape)
            b_spec = batch_specs(batch, mesh, seq_sharded=seq_sharded)
            return Cell(
                arch_id, shape, cfg, make_train_step(cfg, opt),
                (params, opt_state, batch),
                (p_spec, o_spec, b_spec),
                (p_spec, o_spec, P()),
                "train",
            )

        if shape.kind == "prefill":
            batch = _fake_batch(cfg, shape)
            b_spec = batch_specs(batch, mesh, seq_sharded=seq_sharded)
            st_spec = state_specs(make_decode_state(cfg, shape.global_batch, shape.seq_len,
                                                    device=_FAKE_DEVICE), mesh)
            return Cell(
                arch_id, shape, cfg, make_prefill_step(cfg, shape),
                (params, batch),
                (p_spec, b_spec),
                (P(), st_spec),
                "prefill",
            )

        # decode: one token against a seq_len-deep cache
        state = make_decode_state(cfg, shape.global_batch, shape.seq_len,
                                  start_pos=shape.seq_len - 1, device=_FAKE_DEVICE)
        st_spec = state_specs(state, mesh)
        tokens = torch.empty((shape.global_batch,), dtype=torch.int32, device=_FAKE_DEVICE)
        t_spec = batch_specs(tokens, mesh)
        return Cell(
            arch_id, shape, cfg, make_serve_step(cfg),
            (params, state, tokens),
            (p_spec, st_spec, t_spec),
            (t_spec, st_spec),
            "decode",
        )


def param_specs_like(opt_state: OptState, p_spec):
    """Optimizer state inherits each param's spec (moments are
    shape-congruent); the step scalar is replicated."""
    return type(opt_state)(P(), p_spec, p_spec)
