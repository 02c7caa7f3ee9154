"""RWKV6 "Finch" block: data-dependent decay linear recurrence (letter ``R``).

The port of ``repro.models.rwkv6``: the same functions with the f32
upcasts at the same places.  Per head (head size N), with per-channel
data-dependent decay w_t ∈ (0,1):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The prompt's recurrence (T > 1) goes to the hand-written CUDA wkv kernel
(``repro_torch.kernels.rwkv6_wkv``) when ``cfg.use_flash``, and to
``wkv_chunked``, the torch twin of the JAX package's chunked algorithm,
otherwise.  ``wkv_chunked`` loops over the chunks: the JAX code builds
the ``[B, nc, t, j, H, N]`` decay tensor of every chunk at once (43 GB
in f32 at 2 × 8192 tokens of rwkv6-3b), one chunk of it is 1.34 GB.  A
single decode token runs ``wkv_step``, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rwkv6_wkv import wkv6

from .layers import layernorm, linear, resolve_device

__all__ = [
    "RWKV6",
    "rwkv6_apply",
    "rwkv6_step",
    "init_rwkv6_state",
    "wkv_chunked",
    "wkv_step",
    "CONST_INIT",
    "SCALED_INIT",
]

LORA_R = 32  # low-rank dim of the ddlerp / decay LoRAs

# the leaves repro.models.rwkv6.rwkv6_init fills with a constant, and the
# one drawn at another scale than 1/sqrt(fan_in); every other leaf is a
# fan-in truncated normal
CONST_INIT = {"mu_x": 0.5, "w0": -0.6, "ln_g": 1.0, "ln_b": 0.0, "cm_mu": 0.5,
              "ln1_g": 1.0, "ln1_b": 0.0, "ln2_g": 1.0, "ln2_b": 0.0}
SCALED_INIT = {"u": 0.5}


class RWKV6(nn.Module):
    """The leaves ``repro.models.rwkv6.rwkv6_init`` builds for one block,
    under its key names (uninitialised; ``models.init_params`` fills them
    with its kinds of values, ``CONST_INIT``, ``SCALED_INIT`` and fan-in
    truncated normals): the time mix
    (``mu_x``, ``lora_A``/``lora_B``, the decay ``w0``/``wA``/``wB``, the
    bonus ``u``, ``Wr``/``Wk``/``Wv``/``Wg``/``Wo``, the group norm
    ``ln_g``/``ln_b``), the channel mix (``cm_mu``, ``Wck``/``Wcv``/``Wcr``)
    and the pre-norms ``ln1_*``/``ln2_*``.  ``w0`` and ``u`` are f32."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        N = cfg.rwkv_head_size
        H = D // N
        r = LORA_R
        dt, f32 = cfg.tparam_dtype, torch.float32
        for name, shape, dtype in (
            ("mu_x", (5, D), dt), ("lora_A", (5, D, r), dt), ("lora_B", (5, r, D), dt),
            ("w0", (D,), f32), ("wA", (D, r), dt), ("wB", (r, D), dt),
            ("u", (H, N), f32), ("Wr", (D, D), dt), ("Wk", (D, D), dt),
            ("Wv", (D, D), dt), ("Wg", (D, D), dt), ("Wo", (D, D), dt),
            ("ln_g", (D,), dt), ("ln_b", (D,), dt), ("cm_mu", (2, D), dt),
            ("Wck", (D, Fd), dt), ("Wcv", (Fd, D), dt), ("Wcr", (D, D), dt),
            ("ln1_g", (D,), dt), ("ln1_b", (D,), dt),
            ("ln2_g", (D,), dt), ("ln2_b", (D,), dt),
        ):
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device), requires_grad=False))


def init_rwkv6_state(cfg, batch: int, n_layers: int, device=None) -> dict:
    """Zeroed decode state of ``n_layers`` blocks on ``device`` (``None``:
    the GPU): both token-shift carries and the f32 wkv state."""
    device = resolve_device(device)
    D = cfg.d_model
    N = cfg.rwkv_head_size
    H = D // N
    kw = dict(dtype=cfg.tdtype, device=device)
    return {
        "shift_tm": torch.zeros((n_layers, batch, D), **kw),
        "shift_cm": torch.zeros((n_layers, batch, D), **kw),
        "wkv": torch.zeros((n_layers, batch, H, N, N), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# chunked wkv
# ---------------------------------------------------------------------------


def wkv_chunked(r, k, v, w, u, *, chunk: int, init_state=None):
    """r,k,v: [B,T,H,N]; w: [B,T,H,N] decay in (0,1); u: [H,N] bonus.
    Returns (y [B,T,H,N] in r's dtype, final_state [B,H,N,N] f32)."""
    B, T, H, N = r.shape
    pad = (-T) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
             if init_state is None else init_state.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    ys = []
    for z0 in range(0, r.shape[1], chunk):
        sl = slice(z0, z0 + chunk)
        rc, kc, vc = r[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        logw = torch.log(torch.clamp_min(w[:, sl].float(), 1e-12))  # [B,c,H,N]
        cum = torch.cumsum(logw, dim=1)  # Π_{τ<=t} w_τ, log-space (<= 0)
        cumprev = cum - logw  # exclusive: Π_{τ<t} w_τ (y_t sees S_{t-1})

        # intra-chunk: y_t += Σ_{j<t} Σ_i r_t[i]·decay(t,j)[i]·k_j[i]·v_j
        # decay(t, j) applies w_{j+1..t-1} = exp(cumprev_t - cum_j)
        dec = torch.exp(torch.clamp(
            cumprev[:, :, None] - cum[:, None, :], -60.0, 0.0))  # [B,t,j,H,N]
        att = torch.einsum("bthn,btjhn,bjhn->btjh", rc, dec, kc)
        del dec
        att = att * tri[None, :, :, None]
        y = torch.einsum("btjh,bjhn->bthn", att, vc)
        # diagonal (j == t) with bonus u
        diag = torch.einsum("bthn,hn,bthn->bth", rc, u, kc)
        y = y + diag[..., None] * vc

        # inter-chunk: y_t += (r_t ⊙ exp(cumprev_t)) · S_prev — the
        # pre-chunk state reaching step t has decayed by w_{1..t-1}
        r_dec = rc * torch.exp(torch.clamp(cumprev, -60.0, 0.0))
        ys.append(y + torch.einsum("bthn,bhnm->bthm", r_dec, state))

        # chunk-final state: S = diag(exp(cum_C)) S_prev
        #                       + Σ_j (k_j ⊙ exp(cum_C - cum_j)) v_jᵀ
        k_dec = kc * torch.exp(torch.clamp(cum[:, -1:] - cum, -60.0, 0.0))
        s_local = torch.einsum("bjhn,bjhm->bhnm", k_dec, vc)  # [B,H,N,N]
        chunk_dec = torch.exp(torch.clamp(cum[:, -1], -60.0, 0.0))  # [B,H,N]
        state = state * chunk_dec[..., None] + s_local
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(r.dtype), state


def wkv_step(state, r_t, k_t, v_t, w_t, u):
    """One token.  state: [B,H,N,N]; r/k/v/w_t: [B,H,N]; u: [H,N]."""
    r_t, k_t, v_t, w_t = (a.float() for a in (r_t, k_t, v_t, w_t))
    kv = torch.einsum("bhn,bhm->bhnm", k_t, v_t)
    y = torch.einsum("bhn,bhnm->bhm", r_t, state + u[None, :, :, None] * kv)
    new = state * w_t[..., None] + kv
    return y, new


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------


def _group_norm(y, g, b, H, N, eps=64e-5):
    """Per-head LayerNorm (RWKV 'ln_x'), y: [..., H*N]."""
    shp = y.shape
    y = y.reshape(*shp[:-1], H, N).float()
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + eps)
    y = y.reshape(*shp)
    return y * g.float() + b.float()


def _ddlerp(p: RWKV6, x, xx):
    """Data-dependent lerp producing the 5 probe inputs [5, B, T, D].
    xx = shifted(x) - x."""
    base = x + xx * p.mu_x[:, None, None, :]  # [5, B, T, D] via broadcast
    lo = torch.tanh(torch.einsum("sbtd,sdr->sbtr", base, p.lora_A.to(x.dtype)))
    mix = p.mu_x[:, None, None, :] + torch.einsum(
        "sbtr,srd->sbtd", lo, p.lora_B.to(x.dtype))
    return x[None] + xx[None] * mix


def _time_mix(cfg, p: RWKV6, x, shifted, wkv_state, *, chunk=None):
    B, T, D = x.shape
    N = cfg.rwkv_head_size
    H = D // N
    xx = shifted - x
    xr, xk, xv, xw, xg = _ddlerp(p, x, xx)  # the 5 probes (r, k, v, w, g)
    r = linear(xr, p.Wr).reshape(B, T, H, N)
    k = linear(xk, p.Wk).reshape(B, T, H, N)
    v = linear(xv, p.Wv).reshape(B, T, H, N)
    g = F.silu(linear(xg, p.Wg))
    ww = p.w0 + torch.einsum(
        "btr,rd->btd", torch.tanh(linear(xw, p.wA)), p.wB.to(x.dtype)).float()
    w = torch.exp(-torch.exp(ww)).reshape(B, T, H, N)  # decay ∈ (0,1)

    if T == 1 and wkv_state is not None:
        y, new_state = wkv_step(wkv_state, r[:, 0], k[:, 0], v[:, 0], w[:, 0], p.u)
        y = y[:, None]
    elif cfg.use_flash:
        y, new_state = wkv6(r, k, v, w, p.u, wkv_state)
    else:
        y, new_state = wkv_chunked(r, k, v, w, p.u, chunk=chunk or 64,
                                   init_state=wkv_state)
    y = _group_norm(y.reshape(B, T, D), p.ln_g, p.ln_b, H, N)
    out = linear((y * g.float()).to(x.dtype), p.Wo)
    return out, new_state


def _channel_mix(p: RWKV6, x, shifted):
    xx = shifted - x
    xk = x + xx * p.cm_mu[0].to(x.dtype)
    xr = x + xx * p.cm_mu[1].to(x.dtype)
    kk = torch.square(F.relu(linear(xk, p.Wck)))
    return torch.sigmoid(linear(xr, p.Wcr)) * linear(kk, p.Wcv)


def _shift(x, last):
    """shifted[t] = x[t-1]; shifted[0] = last (carried state)."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def rwkv6_apply(cfg, p: RWKV6, x, *, state=None):
    """Full block (pre-LN → time-mix → residual → pre-LN → channel-mix →
    residual).  x: [B, T, D] → (y, new_state{shift_tm, shift_cm, wkv}).
    The shift states hold the *normed* last token (mixers see LN'd input),
    as copies: a view would keep the whole normed prompt alive in the
    decode state."""
    B, T, D = x.shape
    if state is None:
        last_tm = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        last_cm = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        wkv0 = None
    else:
        last_tm, last_cm, wkv0 = state["shift_tm"], state["shift_cm"], state["wkv"]
    a = layernorm(x, p.ln1_g, p.ln1_b)
    tm, new_wkv = _time_mix(cfg, p, a, _shift(a, last_tm), wkv0, chunk=cfg.ssm_chunk)
    x = x + tm
    b = layernorm(x, p.ln2_g, p.ln2_b)
    cm = _channel_mix(p, b, _shift(b, last_cm))
    y = x + cm
    new_state = {"shift_tm": a[:, -1, :].clone(), "shift_cm": b[:, -1, :].clone(),
                 "wkv": new_wkv}
    return y, new_state


def rwkv6_step(cfg, p: RWKV6, x_t, state):
    """Single token.  x_t: [B, 1, D]."""
    a = layernorm(x_t, p.ln1_g, p.ln1_b)
    tm, new_wkv = _time_mix(
        cfg, p, a, state["shift_tm"][:, None, :].to(x_t.dtype), state["wkv"])
    h = x_t + tm
    b = layernorm(h, p.ln2_g, p.ln2_b)
    cm = _channel_mix(p, b, state["shift_cm"][:, None, :].to(x_t.dtype))
    y = h + cm
    new_state = {"shift_tm": a[:, -1, :], "shift_cm": b[:, -1, :], "wkv": new_wkv}
    return y, new_state
