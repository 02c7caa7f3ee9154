"""The port's MLA (DeepSeek-V2 latent attention) against the JAX
package's, on the CPU, in f32.

The reduced deepseek-v2-lite config (r 64, dn 32, dr 16, dv 32, 4
heads), weights drawn by ``repro.models.attention.mla_init`` and carried
over as numpy arrays, seeded numpy inputs: the cache-free form (the
latent expanded to per-head K/V, ``chunked_attention`` with qk width
dn + dr and v width dv), a prefill into a zeroed latent cache (the
absorbed form over the whole prompt), then absorbed decode steps, each
step's output and the cache it writes against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.models import attention as jattn
import repro_torch.configs as tcfg
from repro_torch.models import attention as tattn
from repro_torch.models.convert import tensor_from_numpy

TOL = 1e-4
B, S, MAX_LEN, STEPS = 2, 10, 16, 4


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.get_reduced("deepseek-v2-lite-16b")
    tc = tcfg.get_reduced("deepseek-v2-lite-16b")
    p = jax.tree.map(np.asarray, jattn.mla_init(jax.random.PRNGKey(2), jc))
    mod = tattn.MLA(tc, device="cpu")
    for name, param in mod.named_parameters():
        param.requires_grad_(False).copy_(tensor_from_numpy(p[name]))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    steps = rng.standard_normal((STEPS, B, 1, tc.d_model)).astype(np.float32)
    return jc, tc, p, mod, x, steps


def _err(got, want) -> float:
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def test_mla_cache_free_matches_repro(setup):
    jc, tc, p, mod, x, _ = setup
    want, none = jattn.mla_attention(jc, p, jnp.asarray(x))
    with torch.no_grad():
        got, cache = tattn.mla_attention(tc, mod, torch.from_numpy(x))
    assert none is None and cache is None
    assert got.shape == x.shape and _err(got, want) < TOL


def test_mla_prefill_and_absorbed_decode_match_repro(setup):
    jc, tc, p, mod, x, steps = setup
    jcache = {"ckv": jattn.init_mla_cache(jc, B, MAX_LEN, 1)["ckv"][0]}
    tcache = {"ckv": tattn.init_mla_cache(tc, B, MAX_LEN, 1, device="cpu")["ckv"][0]}
    assert tcache["ckv"].shape == (B, MAX_LEN, tc.kv_lora_rank + tc.qk_rope_head_dim)
    jpos = jnp.zeros((B,), jnp.int32)
    tpos = torch.zeros(B, dtype=torch.int32)
    feeds = [x] + list(steps)  # the prompt, then one token a step
    with torch.no_grad():
        for feed in feeds:
            n = feed.shape[1]
            positions = np.asarray(jpos)[:, None] + np.arange(n)[None, :]
            want, jcache = jattn.mla_attention(jc, p, jnp.asarray(feed),
                                               positions=jnp.asarray(positions),
                                               cache=jcache, cache_pos=jpos)
            buf = tcache["ckv"]
            got, tcache = tattn.mla_attention(tc, mod, torch.from_numpy(feed),
                                              positions=torch.from_numpy(positions),
                                              cache=tcache, cache_pos=tpos)
            assert tcache["ckv"] is buf  # written in place
            assert _err(got, want) < TOL
            assert _err(tcache["ckv"], jcache["ckv"]) < TOL
            jpos, tpos = jpos + n, tpos + n
    assert tpos.tolist() == [S + STEPS] * B
    # the slots past the last token stay zero
    assert not tcache["ckv"][:, S + STEPS:].any()


def test_mla_absorbed_prefill_equals_the_expanded_form(setup):
    """The two forms compute one function: the absorbed prefill over a
    zeroed cache gives the cache-free output."""
    _, tc, _, mod, x, _ = setup
    with torch.no_grad():
        free, _ = tattn.mla_attention(tc, mod, torch.from_numpy(x))
        cache = tattn.init_mla_cache(tc, B, MAX_LEN, 1, device="cpu")
        absorbed, _ = tattn.mla_attention(tc, mod, torch.from_numpy(x),
                                          cache={"ckv": cache["ckv"][0]},
                                          cache_pos=torch.zeros(B, dtype=torch.int32))
    assert float((free - absorbed).abs().max()) < TOL


def test_mla_init_draws_the_reference_shapes(setup):
    jc, tc, p, _, _, _ = setup
    a = tattn.mla_init(tc, torch.Generator().manual_seed(0), device="cpu")
    b = tattn.mla_init(tc, torch.Generator().manual_seed(0), device="cpu")
    for name, w in a.named_parameters():
        assert tuple(w.shape) == p[name].shape and w.dtype == torch.float32
        assert torch.equal(w, dict(b.named_parameters())[name])
        assert 0 < float(w.abs().max()) <= 2 / w.shape[0] ** 0.5 + 1e-6  # 2 std, fan-in
