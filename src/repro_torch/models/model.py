"""Model assembly: the attention (``A``/``D``), MoE (``E``), Mamba2
(``M``), zamba2 hybrid (``H``) and RWKV6 (``R``) architectures, MLA
attention, the encoder-decoder (whisper) and the VLM image prefix.

The port of ``repro.models.model``.  Parameters live in an ``nn.Module``
tree under the JAX package's key names: a :class:`Model` holds ``embed``
[V, D], ``final_norm``, ``unembed`` [D, V] (absent when the embeddings
are tied), ``shared_attn`` (zamba2's one attention + MLP :class:`Block`,
present when the pattern has an ``H``) and ``segs[i][r]["{j}{letter}"]``,
the block at body position j of rep r of segment i (``plan_segments``):
a :class:`Block` for ``A``/``D``/``E`` (``E`` holds ``moe`` where the
others hold ``mlp``; its ``attn`` is an :class:`~.attention.MLA` under
``attn_impl="mla"``; a decoder block of an encoder-decoder adds ``lnx``
and ``xattn``), a :class:`MambaBlock` (``ln``, ``mamba``) for ``M``/``H``,
an :class:`~repro_torch.models.rwkv6.RWKV6` for ``R``.  An encoder-
decoder's ``encoder`` holds ``blocks`` (one ``A`` block a layer) and
``norm``; a VLM's ``img_norm`` normalises the image prefix.  The JAX
package stacks a segment's reps along a leading axis for ``lax.scan``;
the port keeps one module per rep and loops.  An ``H`` layer runs
``shared_attn`` (with its own KV cache) and then its own Mamba2 mixer.

``prefill`` and ``decode_step`` are plain functions on an explicit
:class:`DecodeState`.  Both update it in place and return it.

``cfg.use_flash`` (the port's default) sends prefill to the hand-written
CUDA kernels: attention to the flash kernel wherever the call fits its
contract — queries from position 0, keys masked past a static
``sk_valid``: the cache-free forward, and a prefill into a fresh decode
state (ring or not); whisper's encoder and the cross-attention to it,
both non-causal — the Mamba2 sequence scan to the SSD kernel and the
RWKV6 recurrence to the wkv kernel.  ``use_flash=False`` runs the torch
twins of the JAX package's jnp code instead (``chunked_attention``,
``ssd_chunked``, ``wkv_chunked``).  Decode steps run the torch code
(``chunked_attention``, ``ssd_step``, ``wkv_step``), as the JAX package
runs them.  MLA and the MoE block have no kernel on either route (the
JAX package has none for them): MLA runs ``chunked_attention`` and its
absorbed latent form, the MoE block batched matmuls.

``loss_fn`` (training) differentiates ``forward``'s body under autograd;
the kernels have no backward, so it runs with ``use_flash=False``, as
the JAX package trains through its jnp twins.  Parameters are made with
``requires_grad=False`` and ``init_params``, ``forward``, ``prefill`` and
``decode_step`` run under ``no_grad``; the train step
(``launch/steps.py``) turns gradients on for the length of a step.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention

from . import mamba2, rwkv6
from .attention import MLA, Attention, attention, chunked_attention, mla_attention, write_cache
from .hints import shard_hint
from .layers import (
    MLP,
    apply_rope,
    dense_init,
    linear,
    mlp_apply,
    resolve_device,
    rmsnorm,
)
from .mamba2 import Mamba2, init_mamba2_state, mamba2_apply, mamba2_step
from .moe import MoE, moe_apply
from .rwkv6 import RWKV6, init_rwkv6_state, rwkv6_apply, rwkv6_step

__all__ = [
    "Block",
    "MambaBlock",
    "Encoder",
    "Model",
    "DecodeState",
    "Segment",
    "plan_segments",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "make_decode_state",
]

_LETTERS = ("A", "D", "E", "M", "H", "R")
_MAMBA_STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")
# init_params: the leaves the JAX package fills with a constant, and the
# scale of those drawn at another scale than 1/sqrt(fan_in)
_CONST_INIT = {"ln1": 1.0, "ln2": 1.0, "lnx": 1.0, "ln": 1.0, "final_norm": 1.0,
               "norm": 1.0, "img_norm": 1.0, **mamba2.CONST_INIT, **rwkv6.CONST_INIT}
_SCALED_INIT = {"embed": 0.02, **rwkv6.SCALED_INIT}


# ---------------------------------------------------------------------------
# pattern → segments
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    body: str  # block letters executed per rep, in order
    reps: int  # number of reps (the JAX package's stacked leading axis)
    scan: bool  # the JAX package scans over reps (False: reps == 1, inline)


def plan_segments(cfg) -> tuple[Segment, ...]:
    pat = cfg.pattern
    n = len(pat)
    # smallest period p with pat == pat[:p] * (n // p)
    for p in range(1, n + 1):
        if n % p == 0 and pat == pat[:p] * (n // p):
            break
    if n // p > 1:
        return (Segment(pat[:p], n // p, cfg.scan_layers),)
    # fall back to maximal same-letter runs
    segs = []
    i = 0
    while i < n:
        j = i
        while j < n and pat[j] == pat[i]:
            j += 1
        segs.append(Segment(pat[i], j - i, cfg.scan_layers and (j - i) > 1))
        i = j
    return tuple(segs)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _check_letters(cfg) -> None:
    unknown = sorted(set(cfg.pattern) - set(_LETTERS))
    if unknown:
        raise ValueError(f"{cfg.arch_id}: unknown block letters {unknown}")


class Block(nn.Module):
    """Pre-norm attention + FFN block (letters ``A``, ``D`` and ``E``):
    ``ln1``, ``attn`` (:class:`Attention`, or :class:`MLA` under
    ``attn_impl="mla"``), ``ln2`` and ``mlp`` (``moe``, a :class:`MoE`,
    for ``E``); a decoder block of an encoder-decoder adds ``lnx`` and
    ``xattn`` (the cross-attention, an :class:`Attention`)."""

    def __init__(self, cfg, device=None, letter: str = "A"):
        super().__init__()
        D, dt = cfg.d_model, cfg.tparam_dtype

        def norm():
            return nn.Parameter(torch.ones(D, dtype=dt, device=device), requires_grad=False)

        self.ln1 = norm()
        self.attn = MLA(cfg, device) if cfg.attn_impl == "mla" else Attention(cfg, device)
        self.ln2 = norm()
        if letter == "E":
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(D, cfg.d_ff, cfg.act, dt, device)
        if cfg.enc_dec:
            self.lnx = norm()
            self.xattn = Attention(cfg, device)


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 block (letters ``M`` and ``H``): ``ln``, ``mamba``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.tparam_dtype,
                                          device=device), requires_grad=False)
        self.mamba = Mamba2(cfg, device)


class Encoder(nn.Module):
    """An encoder-decoder's encoder: ``blocks`` (one attention + MLP
    :class:`Block` a layer, no cross-attention) and ``norm``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        enc_cfg = cfg.replace(enc_dec=False)
        self.blocks = nn.ModuleList(Block(enc_cfg, device) for _ in range(cfg.n_enc_layers))
        self.norm = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.tparam_dtype,
                                            device=device), requires_grad=False)


def _block(cfg, letter: str, device) -> nn.Module:
    if letter in ("A", "D", "E"):
        return Block(cfg, device, letter)
    if letter in ("M", "H"):
        return MambaBlock(cfg, device)
    return RWKV6(cfg, device)  # "R": the block is the RWKV6 leaves themselves


class Model(nn.Module):
    """The parameter tree of one config (uninitialised: see
    ``init_params`` and ``convert.params_from_jax``), on ``device``
    (``None``: the GPU)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_letters(cfg)
        device = resolve_device(device)
        D, V, dt = cfg.d_model, cfg.vocab_size, cfg.tparam_dtype
        kw = dict(dtype=dt, device=device)
        self.embed = nn.Parameter(torch.empty(V, D, **kw), requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(D, **kw), requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(D, V, **kw), requires_grad=False)
        self.segs = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleDict({f"{j}{letter}": _block(cfg, letter, device)
                               for j, letter in enumerate(seg.body)})
                for _ in range(seg.reps)
            )
            for seg in plan_segments(cfg)
        )
        if "H" in cfg.pattern:  # zamba2's single shared attention+MLP block
            self.shared_attn = Block(cfg.replace(enc_dec=False), device)
        if cfg.enc_dec:
            self.encoder = Encoder(cfg, device)
        if cfg.n_img_tokens:  # the VLM stub: normalises the patch embeddings
            self.img_norm = nn.Parameter(torch.ones(D, **kw), requires_grad=False)


@torch.no_grad()
def init_params(cfg, seed: int = 0, device=None) -> Model:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    of the kinds ``repro.models.init_params`` draws (with other random
    numbers): norm gains at one and biases at zero, the Mamba2 and RWKV6
    constants (``A_log`` 0, ``D`` 1, ``dt_bias`` 0, ``mu_x``/``cm_mu``
    0.5, ``w0`` −0.6), ``embed`` truncated-normal × 0.02, ``u`` × 0.5,
    every other leaf truncated-normal × 1/sqrt(fan_in)."""
    device = resolve_device(device)
    model = Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _CONST_INIT:
            p.fill_(_CONST_INIT[leaf])
        else:
            dense_init(p, gen, scale=_SCALED_INIT.get(leaf))
    return model


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _attn_block(cfg, p: Block, x, *, pos, cache, window=None, fresh=False,
                enc_out=None):
    """Pre-norm attention (+ cross-attention to ``enc_out``) + FFN block.
    Returns (x, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p.ln1)
    cache_pos = None if cache is None else cache.get("pos")
    if cfg.attn_impl == "mla":
        a, new_att = mla_attention(
            cfg, p.attn, h, positions=pos,
            cache=None if cache is None else cache["att"], cache_pos=cache_pos,
        )
    else:
        # ring iff the cache was allocated at window size (the allocation in
        # make_decode_state is min(max_len, window))
        ring = (
            cache is not None
            and cfg.swa_window is not None
            and cache["att"]["k"].shape[1] == cfg.swa_window
        )
        a, new_att = _gqa(
            cfg, p.attn, h,
            pos=pos, cache=None if cache is None else cache["att"],
            cache_pos=cache_pos, window=window, ring=ring, fresh=fresh,
        )
    x = x + a
    if cfg.enc_dec and enc_out is not None:
        # K/V re-projected from enc_out at every call, as the JAX package does
        hx = rmsnorm(x, p.lnx)
        c, _ = attention(cfg, p.xattn, hx, causal=False, rope=False, kv_from=enc_out,
                         flash=cfg.use_flash and (cache is None or fresh))
        x = x + c
    h2 = rmsnorm(x, p.ln2)
    if hasattr(p, "moe"):
        m, aux = moe_apply(cfg, p.moe, h2)
    else:
        hint = (lambda h: shard_hint(h, "dp", None, "model")) if cfg.act_sharding else None
        m = mlp_apply(p.mlp, h2, cfg.act, hint=hint)
    return x + m, new_att, aux


def _gqa(cfg, p: Attention, x, *, pos, cache, cache_pos, window, ring, fresh):
    """GQA attention with optional ring-buffer KV cache (SWA decode).

    ``fresh`` is the static fact that ``cache_pos`` is 0 (``prefill``
    built the state), which puts a prefill over the cache inside the
    flash kernel's contract without reading ``cache_pos`` back."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(x, p.wq).reshape(B, S, H, hd)
    k = linear(x, p.wk).reshape(B, S, KV, hd)
    v = linear(x, p.wv).reshape(B, S, KV, hd)
    if cfg.act_sharding:
        q = shard_hint(q, "dp", None, "model", None)
        k = shard_hint(k, "dp", None, "model", None)
        v = shard_hint(v, "dp", None, "model", None)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    # with no cache, or a cache that prefill built (cache_pos == 0), every
    # branch below attends the fresh K/V from position 0: the kernel's case
    flash = cfg.use_flash and (cache is None or fresh)
    out = flash_attention(q, k, v, causal=True, window=window) if flash else None

    if cache is None:
        if out is None:
            out = chunked_attention(q, k, v, causal=True, window=window,
                                    chunk=cfg.attn_chunk)
        return linear(out.reshape(B, S, H * hd), p.wo), None

    L = cache["k"].shape[1]
    if ring:
        # ring-buffer cache (SWA): global position p lives at slot p % L.
        if S > 1:
            # prefill into a ring (cache assumed empty, cache_pos == 0):
            # attend the full fresh K/V, cache only the last L tokens.
            if out is None:
                out = chunked_attention(q, k, v, causal=True, window=window,
                                        q_offset=cache_pos, chunk=cfg.attn_chunk)
            tail = min(S, L)
            slots = (cache_pos[:, None] + S - tail
                     + torch.arange(tail, device=x.device)[None, :]) % L
            rows = torch.arange(B, device=x.device)[:, None]
            cache["k"][rows, slots] = k[:, -tail:]
            cache["v"][rows, slots] = v[:, -tail:]
            ck, cv = cache["k"], cache["v"]
        else:
            slot = cache_pos % L  # [B]
            ck = write_cache(cache["k"], k, slot)
            cv = write_cache(cache["v"], v, slot)
            if out is None:
                idx = torch.arange(L, device=x.device)
                k_pos = cache_pos[:, None] - (cache_pos[:, None] - idx[None, :]) % L
                out = chunked_attention(
                    q, ck, cv, causal=True, window=window,
                    q_offset=cache_pos, k_positions=k_pos, chunk=cfg.attn_chunk,
                )
    else:
        ck = write_cache(cache["k"], k, cache_pos)
        cv = write_cache(cache["v"], v, cache_pos)
        if out is None:
            out = chunked_attention(
                q, ck, cv, causal=True, window=window,
                q_offset=cache_pos, kv_len=cache_pos + S, chunk=cfg.attn_chunk,
            )
    new_cache = {"k": ck, "v": cv}
    return linear(out.reshape(B, S, H * hd), p.wo), new_cache


# ---------------------------------------------------------------------------
# trunk / forward
# ---------------------------------------------------------------------------


def _apply_block(cfg, letter, p, x, *, pos, st, cache_pos, shared, fresh,
                 enc_out=None):
    """Run one block.  ``st``: None (no state) or this block's decode
    state.  Returns (x, new_st, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new = None if st is None else {}
    if letter in ("A", "D", "E", "H"):
        # an H layer runs the shared attention block first (zamba2), with
        # its own KV cache, then its own mamba mixer
        cache = None if st is None else {"att": st["att"], "pos": cache_pos}
        x, new_att, aux = _attn_block(
            cfg, shared if letter == "H" else p, x,
            pos=pos, cache=cache, window=cfg.swa_window, fresh=fresh,
            enc_out=None if letter == "H" else enc_out,
        )
        if st is not None:
            new["att"] = new_att
        if letter != "H":
            return x, new, aux
    if letter in ("M", "H"):
        h = rmsnorm(x, p.ln)
        if st is None:
            m, _ = mamba2_apply(cfg, p.mamba, h)
            return x + m, None, aux
        ms = {k: st[k] for k in _MAMBA_STATE_KEYS}
        if x.shape[1] == 1:
            m, ms = mamba2_step(cfg, p.mamba, h, ms)
        else:
            m, ms = mamba2_apply(cfg, p.mamba, h, init_state=ms)
        return x + m, {**new, **ms}, aux
    # "R"
    if st is None:
        y, _ = rwkv6_apply(cfg, p, x)
        return y, None, aux
    if x.shape[1] == 1:
        return (*rwkv6_step(cfg, p, x, st), aux)
    return (*rwkv6_apply(cfg, p, x, state=st), aux)


@dataclass
class DecodeState:
    """Per-block decode state and the next position.

    ``segs[i][r]["{j}{letter}"]`` is a dict of tensors, shaped as the JAX
    package's ``_block_state`` shapes them (without the reps axis):

    - ``A``/``D``/``E``: ``att`` = ``{"k", "v"}``, each ``[B, L, KV, hd]``
      in ``cfg.dtype``, where L is ``max_len``, or the sliding window when
      that is smaller (a ring: position p at slot p % L); under MLA
      ``att`` = ``{"ckv"}`` ``[B, max_len, r + dr]``, the latent and the
      rotary key;
    - ``M``: ``conv_x`` ``[B, K-1, d_in]``, ``conv_B``/``conv_C``
      ``[B, K-1, n]`` (the convolutions' last inputs, ``cfg.dtype``) and
      ``ssm`` ``[B, nh, head_dim, n]`` f32;
    - ``H``: ``att`` (the shared block's cache at this layer) and the
      ``M`` entries;
    - ``R``: ``shift_tm``/``shift_cm`` ``[B, D]`` (``cfg.dtype``) and
      ``wkv`` ``[B, H, N, N]`` f32.

    ``pos`` [B] int32 is the position the next token takes; ``enc_out``
    [B, enc_seq, D] the encoder's output (an encoder-decoder's decode
    steps cross-attend to it), else None."""

    segs: list
    pos: torch.Tensor
    enc_out: Optional[torch.Tensor] = None


def _trunk(cfg, params: Model, x, *, pos, state: Optional[DecodeState] = None,
           fresh: bool = False, enc_out=None):
    """Run all segments.  Returns (x, new_state, aux_total).  Under
    autograd with ``cfg.remat`` and no state, each rep of a segment with
    more than one runs under ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint`` of a segment's body)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = getattr(params, "shared_attn", None)
    remat = cfg.remat and state is None and torch.is_grad_enabled()
    for si, seg in enumerate(plan_segments(cfg)):
        for r in range(seg.reps):
            def rep(x, aux, si=si, r=r, seg=seg):
                for j, letter in enumerate(seg.body):
                    key = f"{j}{letter}"
                    st = None if state is None else state.segs[si][r][key]
                    x, new_b, aux_b = _apply_block(
                        cfg, letter, params.segs[si][r][key], x, pos=pos, st=st,
                        cache_pos=None if state is None else state.pos,
                        shared=shared, fresh=fresh, enc_out=enc_out,
                    )
                    if cfg.act_sharding:
                        x = shard_hint(x, "dp", None, None)
                    aux = aux + aux_b
                    if state is not None:
                        state.segs[si][r][key] = new_b
                return x, aux

            if remat and seg.reps > 1:
                x, aux_total = checkpoint(rep, x, aux_total, use_reentrant=False)
            else:
                x, aux_total = rep(x, aux_total)
    if state is not None:
        state.pos = state.pos + x.shape[1]
    return x, state, aux_total


def _sinusoid(S: int, D: int) -> torch.Tensor:
    pos = np.arange(S)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / D)
    return torch.from_numpy(np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
                            .astype(np.float32))


def _enc_block(cfg, p: Block, x):
    """One encoder block: non-causal self-attention without rotary
    positions, then the MLP."""
    h = rmsnorm(x, p.ln1)
    a, _ = attention(cfg.replace(enc_dec=False), p.attn, h, causal=False, rope=False,
                     flash=cfg.use_flash)
    x = x + a
    return x + mlp_apply(p.mlp, rmsnorm(x, p.ln2), cfg.act)


def _enc_input(cfg, frames):
    """The encoder's input: frames [B, Se, D] plus sinusoidal positions."""
    return frames.to(cfg.tdtype) + _sinusoid(frames.shape[1], cfg.d_model).to(
        device=frames.device, dtype=cfg.tdtype)


def _encode(cfg, params: Model, frames):
    """Whisper-style encoder over precomputed frame embeddings (the stub
    frontend of the JAX package).  frames: [B, Se, D].  Under autograd
    each block is rematerialised where the JAX package's scanned encoder
    is (``cfg.remat`` and ``cfg.scan_layers``, scans not unrolled)."""
    x = _enc_input(cfg, frames)
    remat = (cfg.remat and cfg.scan_layers and not cfg.unroll_scans
             and torch.is_grad_enabled())
    for p in params.encoder.blocks:
        if remat:
            x = checkpoint(functools.partial(_enc_block, cfg, p), x, use_reentrant=False)
        else:
            x = _enc_block(cfg, p, x)
    return rmsnorm(x, params.encoder.norm)


def _embed_inputs(cfg, params: Model, batch):
    """tokens (+ the VLM's image prefix) → (x, positions)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    if cfg.n_img_tokens and "img_emb" in batch:
        img = rmsnorm(batch["img_emb"].to(cfg.tdtype), params.img_norm)
        x = torch.cat([img, x], dim=1)
        S = x.shape[1]
    pos = torch.arange(S, device=x.device).expand(B, S)
    return x, pos


def _embed(cfg, params: Model, tokens):
    """The token embeddings (a gather).  ``F.embedding``: on the card its
    backward sums each row's gradient in f32 before it rounds to the
    weight's dtype, where an indexed read's backward adds the tokens'
    contributions into bf16 one by one."""
    return F.embedding(tokens.long(), params.embed.to(cfg.tdtype))


def _unembed(cfg, params: Model):
    if cfg.tie_embeddings:
        return params.embed.to(cfg.tdtype).T
    return params.unembed.to(cfg.tdtype)


def _forward(cfg, params: Model, batch):
    """``forward``'s body, under whatever autograd mode the caller set
    (``loss_fn`` differentiates it)."""
    x, pos = _embed_inputs(cfg, params, batch)
    enc_out = _encode(cfg, params, batch["enc_frames"]) if cfg.enc_dec else None
    x, _, aux = _trunk(cfg, params, x, pos=pos, enc_out=enc_out)
    x = rmsnorm(x, params.final_norm)
    if cfg.n_img_tokens and "img_emb" in batch:
        x = x[:, batch["img_emb"].shape[1]:]
    return x @ _unembed(cfg, params), aux


@torch.no_grad()
def forward(cfg, params: Model, batch):
    """Forward over the whole batch (no state).  Returns (logits, aux);
    a VLM's logits are the text positions' only."""
    return _forward(cfg, params, batch)


def loss_fn(cfg, params: Model, batch):
    """Next-token cross-entropy in f32 over the tokens whose label is
    >= 0 (+ the MoE aux term).  Returns (loss, metrics).  Differentiable:
    the train step calls it under autograd with the model's parameters
    requiring grad and ``cfg.use_flash`` off (the kernels have no
    backward; the JAX package trains through its jnp twins).  With
    ``cfg.vocab_parallel_loss`` the JAX package builds the same values
    from per-shard pieces; on one device both are this."""
    logits, aux = _forward(cfg, params, batch)
    labels = batch["labels"].long()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    nll = ((logz - gold) * mask).sum() / denom
    loss = nll + cfg.router_aux_weight * aux
    return loss, {"nll": nll, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def make_decode_state(cfg, batch_size: int, max_len: int, *, start_pos=None,
                      device=None) -> DecodeState:
    """Empty decode state: zeroed caches and recurrent states (and a
    zeroed ``enc_out`` for an encoder-decoder), ``pos`` = ``start_pos``
    or 0."""
    _check_letters(cfg)
    device = resolve_device(device)
    L = max_len
    if cfg.swa_window is not None:
        L = min(max_len, cfg.swa_window)  # ring buffer
    shape = (batch_size, L, cfg.n_kv_heads, cfg.hd)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.tdtype, device=device)

    def block_state(letter: str) -> dict:
        st = {}
        if letter in ("A", "D", "E", "H"):
            if cfg.attn_impl == "mla":
                st["att"] = {"ckv": zeros(batch_size, max_len,
                                          cfg.kv_lora_rank + cfg.qk_rope_head_dim)}
            else:
                st["att"] = {"k": zeros(*shape), "v": zeros(*shape)}
        if letter in ("M", "H"):
            st.update((k, v[0]) for k, v in
                      init_mamba2_state(cfg, batch_size, 1, device).items())
        if letter == "R":
            st.update((k, v[0]) for k, v in
                      init_rwkv6_state(cfg, batch_size, 1, device).items())
        return st

    segs = [
        [{f"{j}{letter}": block_state(letter) for j, letter in enumerate(seg.body)}
         for _ in range(seg.reps)]
        for seg in plan_segments(cfg)
    ]
    if start_pos is None:
        pos = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    else:
        pos = torch.as_tensor(start_pos, dtype=torch.int32, device=device).expand(
            batch_size).clone()
    enc_out = zeros(batch_size, cfg.enc_seq, cfg.d_model) if cfg.enc_dec else None
    return DecodeState(segs=segs, pos=pos, enc_out=enc_out)


@torch.no_grad()
def prefill(cfg, params: Model, batch, max_len: int):
    """Run the prompt through the model filling fresh caches.
    Returns (last_logits [B, V], state).  ``max_len`` is the total cache
    capacity; a VLM's image prefix counts toward it.  An encoder-decoder
    encodes ``batch["enc_frames"]`` first and keeps the output in the
    state for the decode steps."""
    x, pos = _embed_inputs(cfg, params, batch)
    state = make_decode_state(cfg, x.shape[0], max(max_len, x.shape[1]),
                              device=x.device)
    if cfg.enc_dec:
        state.enc_out = _encode(cfg, params, batch["enc_frames"])
    x, state, _ = _trunk(cfg, params, x, pos=pos, state=state, fresh=True,
                         enc_out=state.enc_out)
    x = rmsnorm(x[:, -1:, :], params.final_norm)
    return (x @ _unembed(cfg, params))[:, 0], state


@torch.no_grad()
def decode_step(cfg, params: Model, tokens, state: DecodeState):
    """One decode step.  tokens: [B] int → (logits [B, V], state), the
    state updated in place."""
    x = _embed(cfg, params, tokens)[:, None, :]
    pos = state.pos[:, None]
    x, state, _ = _trunk(cfg, params, x, pos=pos, state=state, enc_out=state.enc_out)
    x = rmsnorm(x, params.final_norm)
    return (x @ _unembed(cfg, params))[:, 0], state
