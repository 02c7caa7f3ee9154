"""Mistral-Large-Instruct-2407 (123B) — dense GQA
[hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L, d_model=12288, 96 heads / 8 KV heads (head_dim 128), d_ff=28672,
vocab=32768.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    layer_pattern="A",
    rope_theta=1e6,
    microbatches=8,
    opt_state_dtype="bfloat16",  # >100B: bf16 optimizer moments
)
