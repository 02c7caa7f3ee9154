"""InternVL2-2B — InternViT frontend (STUB) + InternLM2-1.8B LM backbone
[arXiv:2404.16821; hf].

24L, d_model=2048, 16 heads / 8 KV heads (head_dim 128), d_ff=8192,
vocab=92553.  ``input_specs()`` supplies 256 precomputed patch embeddings
per image (the ViT+pixel-shuffle frontend is a stub per the assignment).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    layer_pattern="A",
    rope_theta=1e6,
    n_img_tokens=256,
    tie_embeddings=True,
)
