"""repro_torch.models — the LM substrate, ported from ``repro.models``.

Parameters are an ``nn.Module`` tree (``Model``) under the JAX package's
key names, built by ``init_params(cfg, seed, device)`` or carried over
from JAX by ``convert.params_from_jax``; the forward passes are plain
functions of ``(cfg, params, inputs)``.  Attention-only architectures
(block letters ``A``/``D``) are ported; prefill attention runs on the
hand-written CUDA flash kernel.
"""
from .model import (
    DecodeState,
    Model,
    decode_step,
    forward,
    init_params,
    make_decode_state,
    plan_segments,
    prefill,
)

__all__ = [
    "Model",
    "DecodeState",
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "make_decode_state",
    "plan_segments",
]
