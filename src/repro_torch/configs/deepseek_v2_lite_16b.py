"""DeepSeek-V2-Lite (16B total / 2.4B active) — MLA + fine-grained MoE
[arXiv:2405.04434; hf].

27L, d_model=2048, 16 heads, MLA kv_lora_rank=512 (qk_nope 128, qk_rope 64,
v_head 128), vocab=102400.  Layer 0 dense (d_ff=10944), layers 1-26 MoE:
64 routed experts top-6 + 2 shared experts, expert d_ff=1408.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,           # layer-0 dense FFN
    vocab_size=102400,
    layer_pattern="D" + "E" * 26,
    attn_impl="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
)
