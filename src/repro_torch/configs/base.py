"""Model/config schema shared by all assigned architectures.

One :class:`ModelConfig` describes every architecture family in the pool:
dense GQA transformers, MoE (top-k routed + shared experts), MLA
(DeepSeek latent attention), Mamba2 SSM, RWKV6, hybrid (Mamba2 + shared
attention), encoder–decoder (whisper) and VLM/audio frontend stubs.

``layer_pattern`` selects the block type per layer:
  ``A`` attention+MLP, ``M`` mamba2, ``R`` rwkv6, ``E`` attention+MoE,
  ``D`` attention+dense-MLP (used for MoE archs' leading dense layers),
  ``H`` mamba2 with a *shared* attention block applied before it (zamba2).
A single letter means "all layers"; otherwise it must have one letter per
layer.

The port's copy of ``repro.configs.base``: the same fields and defaults,
with torch dtypes (``tdtype``/``tparam_dtype``) in place of the jnp ones.
One default differs: ``use_flash`` is True, so prefill goes to the
hand-written CUDA kernels: attention to the flash kernel
(``repro_torch.kernels.flash_attention``), the Mamba2 scan to the SSD
kernel (``kernels.mamba2_scan``), the RWKV6 recurrence to the wkv kernel
(``kernels.rwkv6_wkv``); False runs the torch twins of the JAX code.  The
JAX package never reads the field, so no JAX result depends on it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "reduced"]


@dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str = "custom"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm

    # trunk
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 = d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    layer_pattern: str = "A"
    act: str = "silu"  # mlp activation: silu (swiglu) | gelu (whisper)
    tie_embeddings: bool = False

    # attention
    attn_impl: str = "gqa"  # gqa | mla
    rope_theta: float = 1e4
    swa_window: Optional[int] = None  # sliding-window size (h2o-danube)
    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden (d_ff used for dense layers)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2

    # SSM (mamba2)
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # RWKV6
    rwkv_head_size: int = 64

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500  # precomputed frame-embedding positions (stub)

    # VLM stub
    n_img_tokens: int = 0  # patch-embedding positions prepended (stub)

    # numerics / execution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # bf16 for the >100B archs
    remat: bool = True
    scan_layers: bool = True
    # prefill on the hand-written CUDA kernels (flash attention, the SSD
    # scan, the wkv recurrence); False runs their torch twins
    # (chunked_attention, ssd_chunked, wkv_chunked).  The one default that
    # differs from repro.configs.base, where the field is never read
    use_flash: bool = True
    attn_chunk: int = 1024  # KV-chunk for the online-softmax jnp path
    overlap: str = "ring"  # paper technique: "ring" (LH) | "none" (blocking)
    microbatches: int = 1  # gradient-accumulation steps per train step
    moe_group_size: int = 4096  # token-group chunking of the MoE dispatch
    # cost-pass mode: unroll every scan/map so the compiled artifact's
    # cost_analysis counts true FLOPs (XLA counts while bodies ONCE)
    unroll_scans: bool = False
    # ---- beyond-paper schedule optimizations (§Perf hillclimb) ----
    # vocab-parallel-safe cross-entropy: one-hot·sum + explicit logsumexp
    # instead of take_along_axis (which forces a full logits all-reduce
    # when the vocab dim is model-sharded)
    vocab_parallel_loss: bool = False
    # explicit activation sharding constraints (Megatron-style): pin the
    # residual stream to batch-over-dp and hidden/head dims to model,
    # stopping GSPMD from flip-flopping layouts (AG/AR storms)
    act_sharding: bool = False

    # ----------------------------------------------------------------- utils
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> str:
        p = self.layer_pattern
        return p * self.n_layers if len(p) == 1 else p

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def tparam_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def __post_init__(self):
        if len(self.pattern) != self.n_layers:
            raise ValueError(
                f"layer_pattern length {len(self.pattern)} != n_layers {self.n_layers}"
            )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter count (for 6ND MODEL_FLOPS)
    def param_count(self, active_only: bool = False) -> int:
        D, F, V, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        H, KV = self.n_heads, self.n_kv_heads
        n = V * D  # embed
        if not self.tie_embeddings:
            n += V * D
        per = {}
        per["A"] = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D + 3 * D * F + 2 * D
        per["D"] = per["A"]
        if self.attn_impl == "mla":
            qk = self.qk_nope_head_dim + self.qk_rope_head_dim
            attn = (
                D * H * qk
                + D * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * H * (self.qk_nope_head_dim + self.v_head_dim)
                + H * self.v_head_dim * D
            )
            per["A"] = attn + 3 * D * F + 2 * D
            per["D"] = per["A"]
        mf = self.moe_d_ff or F
        e_all = self.n_experts * 3 * D * mf + self.n_shared_experts * 3 * D * mf
        e_act = (self.top_k + self.n_shared_experts) * 3 * D * mf
        attn_part = per["A"] - 3 * D * F - 2 * D
        per["E"] = attn_part + (e_act if active_only else e_all) + D * self.n_experts + 2 * D
        d_in = self.ssm_expand * D
        nh = d_in // self.ssm_head_dim
        per["M"] = (
            D * (2 * d_in + 2 * self.ssm_state + nh)
            + self.ssm_conv * (d_in + 2 * self.ssm_state)
            + d_in * D
            + 2 * nh
            + D
        )
        per["H"] = per["M"]  # + shared attention counted once below
        hs = self.rwkv_head_size
        per["R"] = 4 * D * D + D * D + 3 * D * F // 2 + 6 * D * 32 + 2 * D  # approx
        for ch in set(self.pattern):
            n += self.pattern.count(ch) * per[ch]
        if "H" in self.pattern:
            n += per["A"] - 3 * D * F  # one shared attention block
        if self.enc_dec:
            # encoder layers + decoder cross-attention
            n += self.n_enc_layers * per["A"]
            n += self.pattern.count("A") * (2 * D * (KV * hd) + D * (H * hd) + (H * hd) * D)
        return int(n)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a full config to a CPU-smoke-testable size of the same family
    (same layer pattern shape, tiny dims)."""
    pat = cfg.pattern
    small_layers = min(cfg.n_layers, 4 if "H" not in pat else 12)
    if "H" in pat:
        # keep the hybrid periodicity: groups of (pattern period)
        period = pat.index("H", 1) if pat.count("H") > 1 else 6
        small_layers = 2 * period
        small_pat = pat[: small_layers]
    elif len(set(pat)) == 1:
        small_pat = pat[0]
    else:
        small_pat = pat[:1] + pat[-1] * (small_layers - 1)
    kw = dict(
        n_layers=small_layers,
        layer_pattern=small_pat,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=32 if cfg.attn_impl == "mla" else cfg.qk_nope_head_dim,
        qk_rope_head_dim=16 if cfg.attn_impl == "mla" else cfg.qk_rope_head_dim,
        v_head_dim=32 if cfg.attn_impl == "mla" else cfg.v_head_dim,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=32,
        rwkv_head_size=32,
        n_enc_layers=2 if cfg.enc_dec else 0,
        enc_seq=16 if cfg.enc_dec else cfg.enc_seq,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        swa_window=min(cfg.swa_window, 16) if cfg.swa_window else None,
        dtype="float32",
        param_dtype="float32",
        remat=False,
        scan_layers=False,
        microbatches=1,
        attn_chunk=64,
    )
    kw.update(overrides)
    return cfg.replace(**kw)
