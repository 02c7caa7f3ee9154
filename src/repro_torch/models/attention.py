"""Attention: GQA (+ sliding window) with KV caches for decode.

The port of ``repro.models.attention``.  ``chunked_attention`` is the
online softmax over KV chunks that the JAX package runs everywhere (its
"jnp twin of the Pallas flash kernel"), here a Python loop over chunks:
live memory stays O(Sq · chunk).  The model sends the prefill calls
that fit the flash kernel's contract to
``repro_torch.kernels.flash_attention`` instead (``model._gqa``).

Caches are updated in place (the JAX code returns new arrays): a
``[B, L, KV, hd]`` cache is written where ``dynamic_update_slice``
would write, and the same tensor is returned.  ``attention`` (the
whisper encoder's self-attention and the decoders' cross-attention)
sends its cache-free calls to the flash kernel too when the caller asks
(``flash=True``: prefill under ``cfg.use_flash``); a head dim the
kernel does not take raises there, as in ``model._gqa``.
MLA (``mla_attention``) runs ``chunked_attention`` and its absorbed
latent form, as the JAX package does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention

from .layers import apply_rope, dense_init, linear, resolve_device

__all__ = [
    "Attention",
    "MLA",
    "attn_init",
    "attention",
    "chunked_attention",
    "init_kv_cache",
    "write_cache",
    "mla_init",
    "mla_attention",
    "init_mla_cache",
]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# core: online-softmax attention over KV chunks
# ---------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, KV, hd]
    v: torch.Tensor,  # [B, Sk, KV, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset=0,  # int or [B] — global position of q[0]
    kv_len=None,  # int or [B] — #valid cache entries (None = Sk)
    k_positions=None,  # [B, Sk] explicit global key positions (ring caches);
    # overrides the linear arange — entries < 0 are masked out.
    chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    hdv = v.shape[-1]  # value head dim may differ (MLA)
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    dev = q.device

    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if k_positions is not None:
            k_positions = F.pad(k_positions, (0, pad), value=-1)
    n_chunks = (Sk + pad) // chunk

    q_offset = torch.as_tensor(q_offset, device=dev)
    kv_len = torch.as_tensor(Sk if kv_len is None else kv_len, device=dev)
    q_pos = (q_offset[..., None] + torch.arange(Sq, device=dev)).expand(B, Sq)
    kv_len = kv_len.expand(B)

    # q * scale rounds in q's dtype, then widens (as the JAX code does)
    qr = (q.reshape(B, Sq, KV, G, hd) * scale).float()
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hdv), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        lo, hi = c * chunk, (c + 1) * chunk
        # scores: [B, KV, G, Sq, C]
        s = torch.einsum("bqkgd,bckd->bkgqc", qr, k[:, lo:hi].float())
        if k_positions is not None:
            k_pos = k_positions[:, lo:hi]  # [B, C] explicit global positions
            ok = (k_pos >= 0)[:, None, :]  # [B, 1(Sq), C]
        else:
            k_pos = torch.arange(lo, hi, device=dev).expand(B, chunk)
            ok = (k_pos < kv_len[:, None])[:, None, :]  # [B, 1(Sq), C]
        if causal:
            ok = ok & (q_pos[:, :, None] >= k_pos[:, None, :])
        if window is not None:
            ok = ok & (q_pos[:, :, None] - k_pos[:, None, :] < window)
        s = torch.where(ok[:, None, None, :, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p, v[:, lo:hi].float()
        )
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hdv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA projections ``wq`` [D, H·hd], ``wk``/``wv`` [D, KV·hd] and
    ``wo`` [H·hd, D]."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        kw = dict(dtype=cfg.tparam_dtype, device=device)
        for name, shape in (("wq", (D, H * hd)), ("wk", (D, KV * hd)),
                            ("wv", (D, KV * hd)), ("wo", (H * hd, D))):
            setattr(self, name, nn.Parameter(torch.empty(shape, **kw),
                                             requires_grad=False))


def attn_init(cfg, generator: torch.Generator, *, device=None,
              cross: bool = False) -> Attention:
    """A GQA layer on ``device`` (``None``: the GPU) with fan-in
    truncated-normal weights from ``generator`` (``cross`` only names the
    use: the weights have the same shapes)."""
    p = Attention(cfg, device=resolve_device(device))
    for w in (p.wq, p.wk, p.wv, p.wo):
        dense_init(w, generator)
    return p


def init_kv_cache(cfg, batch: int, max_len: int, n_layers: int, stacked=True,
                  device=None):
    """Zeroed ``{"k", "v"}`` caches on ``device`` (``None``: the GPU)."""
    device = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.hd
    shape = (n_layers, batch, max_len, KV, hd) if stacked else (batch, max_len, KV, hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.tdtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.tdtype, device=device),
    }


def write_cache(buf: torch.Tensor, new: torch.Tensor, start) -> torch.Tensor:
    """``buf[b, start[b] : start[b] + S] = new[b]`` in place, for each b,
    with each start clamped into ``[0, L - S]`` as ``dynamic_update_slice``
    clamps it.  buf ``[B, L, ...]``, new ``[B, S, ...]``, start ``[B]``."""
    B, S = new.shape[:2]
    start = torch.as_tensor(start, device=buf.device).expand(B)
    idx = start.clamp(0, buf.shape[1] - S)[:, None] + torch.arange(S, device=buf.device)
    buf[torch.arange(B, device=buf.device)[:, None], idx] = new.to(buf.dtype)
    return buf


def attention(
    cfg,
    p: Attention,
    x: torch.Tensor,  # [B, S, D]
    *,
    positions=None,  # [B, S] or None -> arange
    causal: bool = True,
    window: Optional[int] = None,
    rope: bool = True,
    kv_from: Optional[torch.Tensor] = None,  # cross-attention source [B, Se, D]
    cache: Optional[dict] = None,  # {"k","v"} [B, L_max, KV, hd], written in place
    cache_pos=None,  # [B] write offset for this step
    flash: bool = False,  # cache-free calls on the flash kernel
):
    """Returns (out [B,S,D], cache or None)."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv_from is None else kv_from
    q = linear(x, p.wq).reshape(B, S, H, hd)
    k = linear(src, p.wk).reshape(B, src.shape[1], KV, hd)
    v = linear(src, p.wv).reshape(B, src.shape[1], KV, hd)

    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if rope and kv_from is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        ck = write_cache(cache["k"], k, cache_pos)
        cv = write_cache(cache["v"], v, cache_pos)
        new_cache = {"k": ck, "v": cv}
        out = chunked_attention(
            q, ck, cv,
            causal=causal, window=window,
            q_offset=cache_pos, kv_len=cache_pos + S, chunk=cfg.attn_chunk,
        )
    elif flash:
        # queries from position 0 over all of k: the kernel's contract
        out = flash_attention(q, k, v, causal=causal and kv_from is None, window=window)
    else:
        out = chunked_attention(
            q, k, v,
            causal=causal and kv_from is None, window=window,
            q_offset=0, chunk=cfg.attn_chunk,
        )
    return linear(out.reshape(B, S, H * hd), p.wo), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 latent attention)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """MLA projections: ``wq`` [D, H·(dn+dr)], ``wdkv`` [D, r+dr] (the
    latent c_kv and the shared rotary key), ``wuk`` [r, H·dn], ``wuv``
    [r, H·dv] and ``wo`` [H·dv, D]."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        kw = dict(dtype=cfg.tparam_dtype, device=device)
        for name, shape in (("wq", (D, H * (dn + dr))), ("wdkv", (D, r + dr)),
                            ("wuk", (r, H * dn)), ("wuv", (r, H * dv)),
                            ("wo", (H * dv, D))):
            setattr(self, name, nn.Parameter(torch.empty(shape, **kw),
                                             requires_grad=False))


def mla_init(cfg, generator: torch.Generator, *, device=None) -> MLA:
    """An MLA layer on ``device`` (``None``: the GPU) with fan-in
    truncated-normal weights from ``generator``."""
    p = MLA(cfg, device=resolve_device(device))
    for w in p.parameters():
        dense_init(w, generator)
    return p


def init_mla_cache(cfg, batch: int, max_len: int, n_layers: int, device=None):
    """Zeroed latent caches ``{"ckv": [n_layers, B, L, r + dr]}``."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    return {"ckv": torch.zeros((n_layers, batch, max_len, r + dr), dtype=cfg.tdtype,
                               device=resolve_device(device))}


def mla_attention(cfg, p: MLA, x, *, positions=None, cache=None, cache_pos=None):
    """MLA forward.  Returns (out [B, S, D], ``{"ckv"}`` or None).

    With no cache the latent is expanded to per-head K/V and attended by
    ``chunked_attention``: q·k over dn + dr = 192 columns at deepseek's
    widths, v 128 wide, scale (dn + dr)^-0.5.  The flash kernel takes
    neither (d ≤ 128, k and v of one shape), and the JAX package runs
    its jnp ``chunked_attention`` here too, with no Pallas kernel: this
    is the reference's route, not a fallback.

    With a cache (prefill into a decode state, and decode) the *absorbed*
    form in f32, as the JAX package computes it: the queries are
    projected into the latent space, so the cache stays ``r + dr`` wide
    per token and is never expanded.  ``cache["ckv"]`` [B, L, r + dr] is
    written in place at ``cache_pos``."""
    B, S, D = x.shape
    H = cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)

    q = linear(x, p.wq).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = linear(x, p.wdkv)  # [B, S, r + dr]
    ckv, k_rope = dkv[..., :r], dkv[..., r:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    scale = (dn + dr) ** -0.5

    if cache is None:
        k_nope = linear(ckv, p.wuk).reshape(B, S, H, dn)
        vv = linear(ckv, p.wuv).reshape(B, S, H, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
        qc = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(qc, k, vv, causal=True, chunk=cfg.attn_chunk, scale=scale)
        return linear(out.reshape(B, S, H * dv), p.wo), None

    # --- absorbed form -------------------------------------------------------
    buf = write_cache(cache["ckv"], torch.cat([ckv, k_rope], dim=-1), cache_pos)
    cache_pos = torch.as_tensor(cache_pos, device=x.device).expand(B)
    kv_len = cache_pos + S
    L = buf.shape[1]
    c_all, kr_all = buf[..., :r].float(), buf[..., r:].float()
    # absorb W_uk into q:  q_lat[b,s,h,r] = q_nope · W_uk[·,h,·]
    wuk = p.wuk.reshape(r, H, dn).float()
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), wuk)
    s = (torch.einsum("bshr,blr->bhsl", q_lat, c_all)
         + torch.einsum("bshd,bld->bhsl", q_rope.float(), kr_all)) * scale
    k_pos = torch.arange(L, device=x.device)
    q_pos = cache_pos[:, None] + torch.arange(S, device=x.device)
    ok = (k_pos[None, None, :] < kv_len[:, None, None]) & (
        q_pos[:, :, None] >= k_pos[None, None, :])
    s = torch.where(ok[:, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhsl,blr->bshr", w, c_all)  # [B, S, H, r]
    wuv = p.wuv.reshape(r, H, dv).float()
    out = torch.einsum("bshr,rhd->bshd", o_lat, wuv).to(x.dtype)
    return linear(out.reshape(B, S, H * dv), p.wo), {"ckv": buf}
