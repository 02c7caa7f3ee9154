"""RWKV6 "Finch" 3B — attention-free linear recurrence [arXiv:2404.05892; hf].

32L, d_model=2560, d_ff=8960, vocab=65536, head size 64 (40 wkv heads).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # wkv heads = d_model / rwkv_head_size
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    layer_pattern="R",
    rwkv_head_size=64,
    ssm_chunk=256,       # wkv chunk length
    tie_embeddings=False,
)
