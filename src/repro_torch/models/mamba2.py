"""Mamba2 (SSD) mixer: the zamba2 ``M``/``H`` layers' state-space block.

The port of ``repro.models.mamba2``: the same functions with the f32
upcasts at the same places.  The sequence scan of ``mamba2_apply`` goes
to the hand-written CUDA SSD kernel (``repro_torch.kernels.mamba2_scan``)
when ``cfg.use_flash``, and to ``ssd_chunked``, the torch twin of the
JAX package's chunked scan, otherwise.  ``ssd_chunked`` loops over the
chunks (the JAX code builds every chunk's ``[c, c]`` decay matrix at
once), so its live memory is one chunk's.  Decode (``mamba2_step``)
runs the one-token recurrence ``ssd_step``, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mamba2_scan import ssd_scan

from .layers import linear, resolve_device, rmsnorm

__all__ = [
    "Mamba2",
    "mamba2_apply",
    "mamba2_step",
    "init_mamba2_state",
    "ssd_chunked",
    "ssd_step",
    "CONST_INIT",
]

# the leaves repro.models.mamba2.mamba2_init fills with a constant; every
# other leaf is a fan-in truncated normal
CONST_INIT = {"conv_x_b": 0.0, "conv_B_b": 0.0, "conv_C_b": 0.0,
              "A_log": 0.0, "D": 1.0, "dt_bias": 0.0, "norm_g": 1.0}


class Mamba2(nn.Module):
    """The leaves ``repro.models.mamba2.mamba2_init`` builds, under its key
    names (uninitialised; ``models.init_params`` fills them with its kinds
    of values, ``CONST_INIT`` and fan-in truncated normals): projections
    ``w_z``/``w_x`` [D, d_in], ``w_B``/``w_C`` [D, n], ``w_dt`` [D, nh],
    ``w_out`` [d_in, D]; depthwise convolutions ``conv_*`` [K, C] with
    biases ``conv_*_b``; ``A_log``, ``D`` and ``dt_bias`` [nh] in f32; the
    gated norm's ``norm_g`` [d_in]."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D = cfg.d_model
        d_in = cfg.ssm_expand * D
        n, K = cfg.ssm_state, cfg.ssm_conv
        nh = d_in // cfg.ssm_head_dim
        dt, f32 = cfg.tparam_dtype, torch.float32
        for name, shape, dtype in (
            ("w_z", (D, d_in), dt), ("w_x", (D, d_in), dt), ("w_B", (D, n), dt),
            ("w_C", (D, n), dt), ("w_dt", (D, nh), dt), ("conv_x", (K, d_in), dt),
            ("conv_B", (K, n), dt), ("conv_C", (K, n), dt),
            ("conv_x_b", (d_in,), dt), ("conv_B_b", (n,), dt), ("conv_C_b", (n,), dt),
            ("A_log", (nh,), f32), ("D", (nh,), f32), ("dt_bias", (nh,), f32),
            ("norm_g", (d_in,), dt), ("w_out", (d_in, D), dt),
        ):
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device), requires_grad=False))


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum' producing the lower-triangular decay matrix:
    out[i, j] = sum_{k=j+1..i} x[k]  (for j < i), -inf above diagonal."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)  # [..., i, j] = x[i]
    ones = torch.ones((T, T), dtype=torch.bool, device=x.device)
    x = torch.where(torch.tril(ones, -1), x, 0.0)
    x_seg = torch.cumsum(x, dim=-2)
    return torch.where(torch.tril(ones, 0), x_seg, -torch.inf)


def ssd_chunked(x, dt, A, B, C, *, chunk: int, init_state=None):
    """Chunked SSD scan, one chunk at a time.

    x:  [b, s, h, p]   (inputs, p = head dim)
    dt: [b, s, h]      (softplus'd step sizes, >0)
    A:  [h]            (negative decay rates)
    B:  [b, s, n]      (input projection, shared across heads; ngroups=1)
    C:  [b, s, n]      (output projection)
    init_state: [b, h, p, n] or None.
    Returns (y [b, s, h, p] in x's dtype, final_state [b, h, p, n] f32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for z0 in range(0, x.shape[1], chunk):
        sl = slice(z0, z0 + chunk)
        xc = x[:, sl].float()  # [b, c, h, p]
        dtc = dt[:, sl].float()  # [b, c, h]
        Bc, Cc = B[:, sl].float(), C[:, sl].float()  # [b, c, n]
        dA = dtc * A  # [b, c, h] (negative)
        dA_cum = torch.cumsum(dA, dim=1)

        # intra-chunk (dense): Y_diag = (L ⊙ C Bᵀ) · (dt x)
        L = torch.exp(_segsum(dA.transpose(1, 2)))  # [b, h, c, c]
        scores = torch.einsum("bcn,bln->bcl", Cc, Bc)  # [b, c(l_q), c(l_k)]
        xdt = xc * dtc[..., None]  # [b, c, h, p]
        y_diag = torch.einsum("bhcl,bcl,blhp->bchp", L, scores, xdt)

        # inter-chunk output from the state entering this chunk:
        # y_off = C_l · (decay_in[l] * state)
        y_off = torch.einsum("bcn,bhpn,bch->bchp", Cc, state, torch.exp(dA_cum))
        ys.append(y_diag + y_off)

        # chunk-final state: Σ_l exp(dA_cum[-1] - dA_cum[l]) B_l x_l dt_l
        decay_states = torch.exp(dA_cum[:, -1:, :] - dA_cum)  # [b, c, h]
        st_z = torch.einsum("bln,blh,blhp->bhpn", Bc, decay_states * dtc, xc)
        state = state * torch.exp(dA_cum[:, -1, :])[..., None, None] + st_z
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """One recurrent step.  state: [b,h,p,n]; x_t: [b,h,p]; dt_t: [b,h];
    B_t, C_t: [b,n].  Returns (y_t [b,h,p], new_state)."""
    dA = torch.exp(dt_t.float() * A)  # [b, h]
    dBx = torch.einsum("bn,bh,bhp->bhpn", B_t.float(), dt_t.float(), x_t.float())
    new = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new, C_t.float())
    return y.to(x_t.dtype), new


def init_mamba2_state(cfg, batch: int, n_layers: int, device=None) -> dict:
    """Zeroed decode state of ``n_layers`` mixers on ``device`` (``None``:
    the GPU): the convolutions' last K-1 inputs and the f32 SSM state."""
    device = resolve_device(device)
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    K = cfg.ssm_conv
    kw = dict(dtype=cfg.tdtype, device=device)
    return {
        "conv_x": torch.zeros((n_layers, batch, K - 1, d_in), **kw),
        "conv_B": torch.zeros((n_layers, batch, K - 1, n), **kw),
        "conv_C": torch.zeros((n_layers, batch, K - 1, n), **kw),
        "ssm": torch.zeros((n_layers, batch, nh, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
    }


def _causal_conv(x, w, b, hist):
    """Depthwise causal conv.  x: [B, S, C]; w: [K, C]; hist: [B, K-1, C]
    (zeros for fresh sequences).  Returns (y [B, S, C], new_hist), the
    history a copy: a view would keep the whole padded input alive in the
    decode state."""
    K = w.shape[0]
    S = x.shape[1]
    padded = torch.cat([hist.to(x.dtype), x], dim=1)  # [B, S+K-1, C]
    y = sum(padded[:, k: k + S, :] * w[k] for k in range(K)) + b
    return F.silu(y), padded[:, -(K - 1):, :].clone()


def mamba2_apply(cfg, p: Mamba2, x, *, init_state=None):
    """Full-sequence forward.  x: [B, S, D] → (y [B, S, D], final state)."""
    Bsz, S, D = x.shape
    d_in = cfg.ssm_expand * D
    n = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    K = cfg.ssm_conv

    z = linear(x, p.w_z)
    xs = linear(x, p.w_x)
    Bm = linear(x, p.w_B)
    Cm = linear(x, p.w_C)
    dt = linear(x, p.w_dt)

    def hist(key, c):
        if init_state is None:
            return torch.zeros((Bsz, K - 1, c), dtype=x.dtype, device=x.device)
        return init_state[key]

    xs, new_hx = _causal_conv(xs, p.conv_x.to(x.dtype), p.conv_x_b.to(x.dtype),
                              hist("conv_x", d_in))
    Bm, new_hB = _causal_conv(Bm, p.conv_B.to(x.dtype), p.conv_B_b.to(x.dtype),
                              hist("conv_B", n))
    Cm, new_hC = _causal_conv(Cm, p.conv_C.to(x.dtype), p.conv_C_b.to(x.dtype),
                              hist("conv_C", n))

    xs = xs.reshape(Bsz, S, nh, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p.dt_bias)  # [B, S, nh]
    A = -torch.exp(p.A_log)  # [nh]

    s0 = None if init_state is None else init_state["ssm"]
    if cfg.use_flash:
        y, fin = ssd_scan(xs, dt, A, Bm, Cm, s0)
    else:
        y, fin = ssd_chunked(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk, init_state=s0)
    y = y + xs * p.D.to(xs.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, d_in)
    y = rmsnorm(y * F.silu(z), p.norm_g)
    out = linear(y, p.w_out)
    state = {"conv_x": new_hx, "conv_B": new_hB, "conv_C": new_hC, "ssm": fin}
    return out, state


def mamba2_step(cfg, p: Mamba2, x_t, state):
    """Single-token decode.  x_t: [B, 1, D]."""
    Bsz = x_t.shape[0]
    D = x_t.shape[-1]
    d_in = cfg.ssm_expand * D
    nh = d_in // cfg.ssm_head_dim
    xt = x_t[:, 0, :]

    z = linear(xt, p.w_z)
    xs = linear(xt, p.w_x)
    Bm = linear(xt, p.w_B)
    Cm = linear(xt, p.w_C)
    dt = linear(xt, p.w_dt)

    def conv1(v, w, b, hist):
        window = torch.cat([hist, v[:, None, :].to(hist.dtype)], dim=1)  # [B, K, C]
        y = torch.einsum("bkc,kc->bc", window, w.to(window.dtype)) + b.to(window.dtype)
        return F.silu(y), window[:, 1:, :]

    xs, new_hx = conv1(xs, p.conv_x, p.conv_x_b, state["conv_x"])
    Bm, new_hB = conv1(Bm, p.conv_B, p.conv_B_b, state["conv_B"])
    Cm, new_hC = conv1(Cm, p.conv_C, p.conv_C_b, state["conv_C"])

    xs = xs.reshape(Bsz, nh, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p.dt_bias)  # [B, nh]
    A = -torch.exp(p.A_log)

    y, new_ssm = ssd_step(state["ssm"], xs, dt, A, Bm, Cm)
    y = y + xs * p.D.to(xs.dtype)[None, :, None]
    y = y.reshape(Bsz, d_in)
    y = rmsnorm(y * F.silu(z), p.norm_g)
    out = linear(y, p.w_out)[:, None, :]
    return out, {"conv_x": new_hx, "conv_B": new_hB, "conv_C": new_hC, "ssm": new_ssm}
