"""repro_torch.models — the LM substrate, ported from ``repro.models``.

Parameters are an ``nn.Module`` tree (``Model``) under the JAX package's
key names, built by ``init_params(cfg, seed, device)`` or carried over
from JAX by ``convert.params_from_jax``; the forward passes are plain
functions of ``(cfg, params, inputs)``.  Every block letter is ported:
attention (``A``/``D``), MoE (``E``), Mamba2 (``M``), zamba2 hybrid
(``H``) and RWKV6 (``R``), with MLA attention, the encoder-decoder and
the VLM image prefix; with ``cfg.use_flash`` prefill runs on the
hand-written CUDA kernels (flash attention, the SSD scan, the wkv
recurrence).
"""
from .model import (
    DecodeState,
    Model,
    decode_step,
    forward,
    init_params,
    loss_fn,
    make_decode_state,
    plan_segments,
    prefill,
)

__all__ = [
    "Model",
    "DecodeState",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "make_decode_state",
    "plan_segments",
]
