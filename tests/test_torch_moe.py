"""The port's MoE block against the JAX package's, on the CPU, in f32.

``repro_torch.models.moe.moe_apply`` against ``repro.models.moe.moe_apply``
on the same weights (drawn by ``repro.models.moe.moe_init``, carried
over as numpy arrays) and seeded numpy tokens: one group, several groups
with the last one padded, and a decode-sized batch where the capacity is
one choice an expert.  The kept (token, choice) pairs must be those the
reference keeps, computed here by the reference's own drop rule on its
own routing, y must agree within 1e-4 and the aux loss to f32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.models import moe as jmoe
import repro_torch.configs as tcfg
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import tensor_from_numpy

TOL = 1e-4

# name: (arch, B, S, moe_group_size)
CASES = {
    "one_group": ("grok-1-314b", 2, 24, 4096),
    "groups_padded": ("deepseek-v2-lite-16b", 2, 37, 16),  # 74 tokens: 5 groups, 6 pad rows
    "decode_capacity_one": ("grok-1-314b", 2, 1, 4096),
}


def _setup(case):
    arch, B, S, g = CASES[case]
    kw = dict(moe_group_size=g, capacity_factor=1.0)
    jc, tc = jcfg.get_reduced(arch, **kw), tcfg.get_reduced(arch, **kw)
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(3), jc))
    mod = tmoe.MoE(tc, device="cpu")
    for name, param in mod.named_parameters():
        leaf = p
        for part in name.split("."):
            leaf = leaf[part]
        param.copy_(tensor_from_numpy(leaf))
    x = np.random.default_rng(5).standard_normal((B, S, tc.d_model)).astype(np.float32)
    if S == 1:
        x[1] = x[0]  # two tokens with one route: the second one's choices drop
    return jc, tc, p, mod, x


def _reference_keep(jc, p, x):
    """The reference's kept choices: its routing, then its drop rule
    (``repro.models.moe._dispatch_group``: position = cumulative count
    over the flattened (token, choice) order, kept iff below C) per group,
    the last group padded with expert-0 rows."""
    T = x.shape[0] * x.shape[1]
    _, idx, _ = jmoe._route(jc, jnp.asarray(p["router"]), jnp.asarray(x.reshape(T, -1)))
    idx = np.asarray(idx)
    g = min(jc.moe_group_size, T)
    idx = np.pad(idx, ((0, -T % g), (0, 0)))
    E, K = jc.n_experts, jc.top_k
    C = max(1, int(g * K / E * jc.capacity_factor))
    keep = []
    for grp in idx.reshape(-1, g, K):
        flat = jax.nn.one_hot(grp.reshape(-1), E, dtype=jnp.int32)
        pos = ((jnp.cumsum(flat, axis=0) - 1) * flat).sum(-1)
        keep.append(np.asarray(pos < C).reshape(g, K))
    return idx[:T], np.concatenate(keep)[:T], C


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_repro(case):
    jc, tc, p, mod, x = _setup(case)
    want_y, want_aux = jmoe.moe_apply(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    with torch.no_grad():
        y, aux = tmoe.moe_apply(tc, mod, torch.from_numpy(x))
        idx, keep = tmoe.moe_routes(tc, mod, torch.from_numpy(x))
    want_idx, want_keep, C = _reference_keep(jc, p, x)
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(keep.numpy(), want_keep)
    assert 0 < want_keep.sum() < want_keep.size  # the case drops some choices, not all
    if case == "decode_capacity_one":
        assert C == 1 and want_keep[0].all() and not want_keep[1].any()
    assert y.shape == x.shape
    assert float(np.abs(y.numpy() - np.asarray(want_y)).max()) < TOL
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


def test_moe_slots_follow_token_major_order():
    """Choices fill an expert's slots in (token, choice) order, and a
    choice past the capacity is dropped, whatever its gate."""
    cfg = tcfg.get_reduced("grok-1-314b", capacity_factor=1.0)  # 8 experts, top-2
    idx = torch.tensor([[3, 1], [1, 3], [3, 0], [5, 3]])
    slot, keep = tmoe.dispatch_slots(cfg, idx, 4)
    assert tmoe.capacity(cfg, 4) == 1
    assert slot.tolist() == [[0, 0], [1, 1], [2, 0], [0, 3]]
    assert keep.tolist() == [[True, True], [False, False], [False, True], [True, False]]


def test_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities: the lower expert first, as ``lax.top_k``."""
    cfg = tcfg.get_reduced("deepseek-v2-lite-16b")
    router = torch.zeros(cfg.d_model, cfg.n_experts)  # every probability equal
    x = np.random.default_rng(1).standard_normal((3, cfg.d_model)).astype(np.float32)
    gate, idx, aux = tmoe.route(cfg, router, torch.from_numpy(x))
    _, want, _ = jmoe._route(jcfg.get_reduced("deepseek-v2-lite-16b"),
                             jnp.zeros((cfg.d_model, cfg.n_experts)), jnp.asarray(x))
    assert idx.tolist() == np.asarray(want).tolist() == [[0, 1]] * 3
    assert torch.allclose(gate, torch.full((3, 2), 0.5))
    assert float(aux) == pytest.approx(1.0)


@pytest.mark.parametrize("experts", [64, 5])
def test_dispatch_slots_equal_the_cumulative_count(experts):
    """The sort-based slots are the reference's cumulative count over the
    flattened (token, choice) one-hot, per group, at deepseek's 64
    experts top-6 and with every token's choices among 5 experts."""
    cfg = tcfg.get_reduced("deepseek-v2-lite-16b", n_experts=64, top_k=6)
    rng = np.random.default_rng(4)
    g, n, K = 96, 3, 6
    idx = np.stack([rng.permutation(64)[:K] for _ in range(n * g)]) % experts
    slot, keep = tmoe.dispatch_slots(cfg, torch.from_numpy(idx), g)
    onehot = np.eye(64, dtype=np.int64)[idx.reshape(n, g * K)]
    want = ((np.cumsum(onehot, axis=1) - 1) * onehot).sum(-1).reshape(n * g, K)
    assert np.array_equal(slot.numpy(), want)
    assert np.array_equal(keep.numpy(), want < tmoe.capacity(cfg, g))
