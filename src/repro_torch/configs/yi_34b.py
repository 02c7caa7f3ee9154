"""Yi-34B — llama-architecture dense GQA [arXiv:2403.04652; hf].

60L, d_model=7168, 56 heads / 8 KV heads (head_dim 128), d_ff=20480,
vocab=64000.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    layer_pattern="A",
    rope_theta=5e6,
    microbatches=4,
)
