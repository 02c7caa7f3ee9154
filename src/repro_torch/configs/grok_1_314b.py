"""Grok-1 (314B) — MoE, 8 experts top-2 [hf:xai-org/grok-1; unverified].

64L, d_model=6144, 48 heads / 8 KV heads (head_dim 128), expert d_ff=32768,
vocab=131072.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    layer_pattern="E",
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    microbatches=8,
    opt_state_dtype="bfloat16",  # >100B: bf16 optimizer moments
)
