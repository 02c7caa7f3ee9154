"""Zamba2-2.7B — Mamba2 backbone with a single SHARED attention(+MLP)
block applied every 6th layer [arXiv:2411.15242; hf].

54L, d_model=2560, shared attn 32 heads (MHA), d_ff=10240 (shared block
MLP), vocab=32000, ssm_state=64.  Pattern (MMMMMH)×9: the 'H' layers run
the one shared attention block, then their own Mamba2 mixer.
(The published model concatenates the original embedding into the shared
block input and uses per-layer LoRA deltas on it; we use the standard
residual form — noted in DESIGN.md §Arch-applicability.)
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    layer_pattern="MMMMMH" * 9,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)
