"""Mixture-of-Experts FFN: top-k token-choice routing with capacity,
plus DeepSeek-style always-on shared experts.

The port of ``repro.models.moe``: the same routing (f32 router logits
and softmax, top-k, gates renormalised, the Switch load-balance loss on
the first choice) and the same drop rule.  Per group of ``g`` tokens
(``cfg.moe_group_size``, the last group padded with zero-gate rows that
route to expert 0) each expert takes ``C = max(1, int(g·K/E ·
capacity_factor))`` choices; a choice's position in its expert is the
count of earlier choices to that expert in the flattened (token, choice)
order, token-major, and it is kept iff that position is below ``C``.

The JAX package builds the expert inputs ``[E, C, D]`` and combines
them with dense one-hot einsums (``"tke,tkc,td->ecd"``: T·E·C entries a
group, ~126 M at deepseek-v2-lite's prefill).  The port builds the same
capacity buffers by index: each kept choice's row is written into its
(expert, slot), which is exact, the experts' SwiGLU runs over the
buffers as batched matmuls (``torch.bmm``), and each token gathers its
kept choices' rows back, weighted by their gates.  The reference has no
Pallas kernel here; these are library matmuls, as its einsums are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, mlp_apply

__all__ = ["MoE", "moe_apply", "moe_routes", "route", "capacity", "dispatch_slots"]


class MoE(nn.Module):
    """``router`` [D, E] (always f32), ``w_gate``/``w_in`` [E, D, F],
    ``w_out`` [E, F, D], and ``shared`` (an :class:`MLP` of width
    ``n_shared_experts · F``, silu) when the config has shared experts."""

    def __init__(self, cfg, device=None):
        super().__init__()
        D, E, dt = cfg.d_model, cfg.n_experts, cfg.tparam_dtype
        Fd = cfg.moe_d_ff or cfg.d_ff
        kw = dict(dtype=dt, device=device)
        self.router = nn.Parameter(torch.empty(D, E, dtype=torch.float32, device=device),
                                   requires_grad=False)
        self.w_gate = nn.Parameter(torch.empty(E, D, Fd, **kw), requires_grad=False)
        self.w_in = nn.Parameter(torch.empty(E, D, Fd, **kw), requires_grad=False)
        self.w_out = nn.Parameter(torch.empty(E, Fd, D, **kw), requires_grad=False)
        if cfg.n_shared_experts:
            self.shared = MLP(D, cfg.n_shared_experts * Fd, "silu", dt, device)


def route(cfg, router: torch.Tensor, xf: torch.Tensor):
    """Top-k routing of tokens ``xf`` [T, D].  Returns (gates [T, K] f32,
    renormalised; expert indices [T, K]; the load-balance loss).  Equal
    probabilities take the lower expert first, as ``lax.top_k`` does."""
    probs = torch.softmax(xf.float() @ router, dim=-1)  # [T, E]
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = order.values[:, : cfg.top_k], order.indices[:, : cfg.top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    # Switch/GShard load-balance loss: E * Σ_e fraction_e · prob_e
    E = cfg.n_experts
    f = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(f * probs.mean(0))
    return gate, idx, aux


def capacity(cfg, group: int) -> int:
    """Choices an expert takes from a group of ``group`` tokens."""
    return max(1, int(group * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def dispatch_slots(cfg, idx: torch.Tensor, group: int):
    """Slot of each (token, choice) in its expert's capacity buffer, per
    group of ``group`` rows of ``idx`` [n·group, K] (padded rows
    included): the count of earlier choices to its expert in the
    flattened (token, choice) order.  Returns (slot [n·group, K], keep
    [n·group, K]).

    The reference counts them with a cumulative sum down a [g·K, E]
    one-hot; here a stable sort by expert keeps that order within each
    expert, and a choice's slot is its rank in its expert's run: the
    same slots without the one-hot or a scan the length of the group."""
    n, K = idx.shape[0] // group, idx.shape[1]
    flat = idx.reshape(n, group * K)
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros(n, cfg.n_experts, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    first = torch.cumsum(counts, dim=1) - counts  # each expert's run starts here
    rank = torch.arange(group * K, device=flat.device) - first.gather(1, flat.gather(1, order))
    slot = torch.empty_like(flat).scatter_(1, order, rank).reshape(n * group, K)
    return slot, slot < capacity(cfg, group)


def _plan(cfg, router, xf, group_size):
    """Route ``xf`` [T, D] and pad it to whole groups.  Returns (xf, gate
    with dropped choices zeroed, idx, slot, keep, group, aux), padded."""
    T = xf.shape[0]
    gate, idx, aux = route(cfg, router, xf)
    g = min(cfg.moe_group_size if group_size is None else group_size, T)
    pad = -T % g
    if pad:  # zero-gate rows to expert 0, after every real row
        xf = F.pad(xf, (0, 0, 0, pad))
        gate = F.pad(gate, (0, 0, 0, pad))
        idx = F.pad(idx, (0, 0, 0, pad))
    slot, keep = dispatch_slots(cfg, idx, g)
    return xf, gate * keep, idx, slot, keep, g, aux


def moe_routes(cfg, p: MoE, x: torch.Tensor, *, group_size=None):
    """The routing ``moe_apply`` takes for x [B, S, D]: (expert indices
    [B·S, K], kept [B·S, K])."""
    T = x.shape[0] * x.shape[1]
    _, _, idx, _, keep, _, _ = _plan(cfg, p.router, x.reshape(T, -1), group_size)
    return idx[:T], keep[:T]


def moe_apply(cfg, p: MoE, x: torch.Tensor, *, group_size=None):
    """x: [B, S, D] → (y [B, S, D], aux loss)."""
    B, S, D = x.shape
    T = B * S
    xf, gate, idx, slot, keep, g, aux = _plan(cfg, p.router, x.reshape(T, D), group_size)
    E, C = cfg.n_experts, capacity(cfg, g)
    dt = x.dtype
    wg, wi, wo = p.w_gate.to(dt), p.w_in.to(dt), p.w_out.to(dt)
    routed = torch.empty_like(xf)
    for i in range(xf.shape[0] // g):
        rows = slice(i * g, (i + 1) * g)
        t, k = torch.nonzero(keep[rows], as_tuple=True)
        xe = xf.new_zeros(E, C, D)
        xe[idx[rows][t, k], slot[rows][t, k]] = xf[rows][t]  # one (expert, slot) a kept choice
        h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi)
        ye = torch.bmm(h, wo)  # [E, C, D]
        # combine: each token's choices, weighted by their gates (a dropped
        # choice's gate is 0; its clamped slot reads some other row)
        yk = ye[idx[rows], slot[rows].clamp(max=C - 1)]  # [g, K, D]
        w = gate[rows].to(dt).float()
        routed[rows] = (w[..., None] * yk.float()).sum(1).to(dt)
    routed = routed[:T]
    # the shared experts: local compute beside the routed path
    if hasattr(p, "shared"):
        routed = routed + mlp_apply(p.shared, x.reshape(T, D), "silu")
    return routed.reshape(B, S, D), aux
