"""Model assembly for the attention-only architectures (letters ``A``/``D``).

The port of ``repro.models.model``.  Parameters live in an ``nn.Module``
tree under the JAX package's key names: a :class:`Model` holds ``embed``
[V, D], ``final_norm``, ``unembed`` [D, V] (absent when the embeddings
are tied) and ``segs[i][r]["{j}{letter}"]``, the :class:`Block` at body
position j of rep r of segment i (``plan_segments``).  The JAX package
stacks a segment's reps along a leading axis for ``lax.scan``; the port
keeps one module per rep and loops.

``prefill`` and ``decode_step`` are plain functions on an explicit
:class:`DecodeState`.  Both update its caches in place and return it.

Prefill attention goes to the hand-written flash kernel when
``cfg.use_flash`` (the port's default) wherever the call fits the
kernel's contract — queries from position 0, keys masked past a static
``sk_valid``: the cache-free forward, and a prefill into a fresh decode
state (ring or not).  Decode steps and everything else run the torch
``chunked_attention``, as the JAX package runs them.

Not ported yet (see ROADMAP.md): the letters ``E`` (MoE), ``M``/``H``
(Mamba2, zamba2 hybrid) and ``R`` (RWKV6), MLA, the encoder-decoder
(whisper) and the VLM image prefix; a config that needs one raises
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention

from .attention import Attention, chunked_attention, mla_init, write_cache
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

__all__ = [
    "Block",
    "Model",
    "DecodeState",
    "Segment",
    "plan_segments",
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "make_decode_state",
]

_PORTED_LETTERS = ("A", "D")


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


def _check_ported(cfg) -> None:
    missing = sorted(set(cfg.pattern) - set(_PORTED_LETTERS))
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: block letters {missing} (MoE E, Mamba2 M/H, "
            f"RWKV6 R) are not ported to repro_torch yet: see ROADMAP.md, queue 1"
        )
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.arch_id}: the encoder-decoder stack is not ported to "
            f"repro_torch yet: see ROADMAP.md, queue 1"
        )
    if cfg.n_img_tokens:
        raise NotImplementedError(
            f"{cfg.arch_id}: the VLM image prefix is not ported to "
            f"repro_torch yet: see ROADMAP.md, queue 1"
        )


class Block(nn.Module):
    """Pre-norm attention + MLP block (letters ``A`` and ``D``): ``ln1``,
    ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, dt = cfg.d_model, cfg.tparam_dtype
        self.ln1 = nn.Parameter(torch.ones(D, dtype=dt, device=device),
                                requires_grad=False)
        self.attn = mla_init(cfg) if cfg.attn_impl == "mla" else Attention(cfg, device)
        self.ln2 = nn.Parameter(torch.ones(D, dtype=dt, device=device),
                                requires_grad=False)
        self.mlp = MLP(D, cfg.d_ff, cfg.act, dt, device)


class Model(nn.Module):
    """The parameter tree of one config (uninitialised: see
    ``init_params`` and ``convert.params_from_jax``), on ``device``
    (``None``: the GPU)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_ported(cfg)
        device = resolve_device(device)
        D, V, dt = cfg.d_model, cfg.vocab_size, cfg.tparam_dtype
        kw = dict(dtype=dt, device=device)
        self.embed = nn.Parameter(torch.empty(V, D, **kw), requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(D, **kw), requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.empty(D, V, **kw), requires_grad=False)
        self.segs = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleDict({f"{j}{letter}": Block(cfg, device)
                               for j, letter in enumerate(seg.body)})
                for _ in range(seg.reps)
            )
            for seg in plan_segments(cfg)
        )


@torch.no_grad()
def init_params(cfg, seed: int = 0, device=None) -> Model:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``:
    norms at one, ``embed`` truncated-normal × 0.02, every other matrix
    truncated-normal × 1/sqrt(fan_in), as ``repro.models.init_params``
    draws them (with other random numbers)."""
    device = resolve_device(device)
    model = Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "final_norm"):
            p.fill_(1)
        else:
            dense_init(p, gen, scale=0.02 if leaf == "embed" else None)
    return model


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _attn_block(cfg, p: Block, x, *, pos, cache, window=None, fresh=False):
    """Pre-norm attention + FFN block.  Returns (x, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(x, p.ln1)
    cache_pos = None if cache is None else cache.get("pos")
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
    h2 = rmsnorm(x, p.ln2)
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


@dataclass
class DecodeState:
    """Per-block KV caches and the next position.

    ``segs[i][r]["{j}{letter}"]["att"]`` is ``{"k", "v"}``, each
    ``[B, L, KV, hd]`` in ``cfg.dtype``, where L is ``max_len``, or the
    sliding window when that is smaller (a ring: position p at slot
    p % L).  ``pos`` [B] int32 is the position the next token takes."""

    segs: list
    pos: torch.Tensor


def _trunk(cfg, params: Model, x, *, pos, state: Optional[DecodeState] = None,
           fresh: bool = False):
    """Run all segments.  Returns (x, new_state, aux_total)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, seg in enumerate(plan_segments(cfg)):
        for r in range(seg.reps):
            for j, letter in enumerate(seg.body):
                key = f"{j}{letter}"
                cache = None
                if state is not None:
                    cache = {"att": state.segs[si][r][key]["att"], "pos": state.pos}
                x, new_att, aux_b = _attn_block(
                    cfg, params.segs[si][r][key], x,
                    pos=pos, cache=cache, window=cfg.swa_window, fresh=fresh,
                )
                if cfg.act_sharding:
                    x = shard_hint(x, "dp", None, None)
                aux_total = aux_total + aux_b
                if state is not None:
                    state.segs[si][r][key]["att"] = new_att
    if state is not None:
        state.pos = state.pos + x.shape[1]
    return x, state, aux_total


def _embed_inputs(cfg, params: Model, batch):
    """tokens → (x, positions)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params.embed.to(cfg.tdtype)[tokens.long()]
    pos = torch.arange(S, device=x.device).expand(B, S)
    return x, pos


def _unembed(cfg, params: Model):
    if cfg.tie_embeddings:
        return params.embed.to(cfg.tdtype).T
    return params.unembed.to(cfg.tdtype)


@torch.no_grad()
def forward(cfg, params: Model, batch):
    """Forward over the whole batch (no state).  Returns (logits, aux)."""
    x, pos = _embed_inputs(cfg, params, batch)
    x, _, aux = _trunk(cfg, params, x, pos=pos)
    x = rmsnorm(x, params.final_norm)
    return x @ _unembed(cfg, params), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def make_decode_state(cfg, batch_size: int, max_len: int, *, start_pos=None,
                      device=None) -> DecodeState:
    """Empty decode state: zeroed caches, ``pos`` = ``start_pos`` or 0."""
    _check_ported(cfg)
    device = resolve_device(device)
    L = max_len
    if cfg.swa_window is not None:
        L = min(max_len, cfg.swa_window)  # ring buffer
    shape = (batch_size, L, cfg.n_kv_heads, cfg.hd)

    def att():
        return {"k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.tdtype, device=device)}

    segs = [
        [{f"{j}{letter}": {"att": att()} for j, letter in enumerate(seg.body)}
         for _ in range(seg.reps)]
        for seg in plan_segments(cfg)
    ]
    if start_pos is None:
        pos = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    else:
        pos = torch.as_tensor(start_pos, dtype=torch.int32, device=device).expand(
            batch_size).clone()
    return DecodeState(segs=segs, pos=pos)


@torch.no_grad()
def prefill(cfg, params: Model, batch, max_len: int):
    """Run the prompt through the model filling fresh caches.
    Returns (last_logits [B, V], state).  ``max_len`` is the total cache
    capacity."""
    x, pos = _embed_inputs(cfg, params, batch)
    state = make_decode_state(cfg, x.shape[0], max(max_len, x.shape[1]),
                              device=x.device)
    x, state, _ = _trunk(cfg, params, x, pos=pos, state=state, fresh=True)
    x = rmsnorm(x[:, -1:, :], params.final_norm)
    return (x @ _unembed(cfg, params))[:, 0], state


@torch.no_grad()
def decode_step(cfg, params: Model, tokens, state: DecodeState):
    """One decode step.  tokens: [B] int → (logits [B, V], state), the
    state updated in place."""
    x = params.embed.to(cfg.tdtype)[tokens.long()][:, None, :]
    pos = state.pos[:, None]
    x, state, _ = _trunk(cfg, params, x, pos=pos, state=state)
    x = rmsnorm(x, params.final_norm)
    return (x @ _unembed(cfg, params))[:, 0], state
