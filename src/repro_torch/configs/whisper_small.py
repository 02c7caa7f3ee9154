"""Whisper-small — encoder-decoder ASR backbone [arXiv:2212.04356; unverified].

12 enc + 12 dec layers, d_model=768, 12 heads (MHA: kv=12), d_ff=3072,
vocab=51865.  The conv/mel frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings [B, 1500, 768].
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,          # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    layer_pattern="A",
    act="gelu",
    enc_dec=True,
    n_enc_layers=12,
    enc_seq=1500,
    tie_embeddings=True,
)
