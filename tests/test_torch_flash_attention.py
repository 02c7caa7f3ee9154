"""The port's attention against the JAX package's, on the CPU.

``flash_attention_plain`` (what the flash wrapper runs for CPU tensors,
and what the CUDA kernel is held to on the card) against the Pallas
kernel in interpret mode and the dense ``flash_attention_ref`` oracle;
the torch ``chunked_attention`` and ``attention`` against their JAX
originals.  Inputs come from seeded numpy and cross as numpy arrays;
bf16 inputs are rounded from the same f32 values on both sides.
Tolerances are those of tests/test_kernels.py: f32 5e-4, bf16 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention_kernel as pallas_kernel
from repro.models import attention as jax_attention
from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
    launches,
)
from repro_torch.kernels.flash_attention.ops import (
    BF16_REL_TOL,
    BLOCK_K,
    BLOCK_Q,
    NEG_INF,
    _check_tma,
    bf16_rel_err,
)
from repro_torch.models import attention as port_attention
from repro_torch.models.convert import tensor_from_numpy

TOL = {"float32": 5e-4, "bfloat16": 5e-2}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores; torch's
    default of one thread per core in each would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    jx = [jnp.asarray(x).astype(dtype) for x in xs]
    tx = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    return jx, tx


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("B,Sq,Sk,H,KV,d", [
    (1, 128, 128, 2, 2, 64),
    (2, 130, 130, 4, 2, 64),     # ragged: the Pallas wrapper pads, the port does not
    (1, 64, 192, 2, 1, 80),      # cross-length (queries from position 0), d = 80
    (1, 96, 96, 4, 4, 128),
    (2, 70, 70, 8, 2, 120),      # the h2o-danube head dim, GQA 4:1
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_ref(B, Sq, Sk, H, KV, d, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, d)], dtype)
    before = launches["flash_attention"]
    got = flash_attention(tq, tk, tv, causal=True)
    assert launches["flash_attention"] == before  # CPU tensors: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64)
    ref = flash_attention_ref(jq, jk, jv, causal=True)
    assert _err(got, pallas) < TOL[dtype]
    assert _err(got, ref) < TOL[dtype]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 37),
                                           (False, 50)])
def test_plain_masks_match_pallas_kernel_and_ref(causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, [(1, 256, 2, 64)] * 3)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64)
    ref = flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert _err(got, pallas) < 5e-4
    assert _err(got, ref) < 5e-4


# every query row keeps a valid key (rows with none: test_rows_with_no_valid_key_are_zero)
@pytest.mark.parametrize("sk_valid,window", [(1, None), (50, 30), (77, 30)])
def test_plain_sk_valid_masks_the_key_tail(sk_valid, window):
    """Keys at or past ``sk_valid`` never count: the same as attending the
    first ``sk_valid`` keys only (the Pallas kernel's padded-key mask)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, [(2, 77, 4, 32), (2, 100, 2, 32),
                                             (2, 100, 2, 32)])
    got = flash_attention_plain(tq, tk, tv, causal=True, window=window,
                                sk_valid=sk_valid)
    ref = flash_attention_ref(jq, jk[:, :sk_valid], jv[:, :sk_valid], causal=True,
                              window=window)
    assert _err(got, ref) < 5e-4


# (causal, window, sk_valid) over 256 queries and 256 keys, each with
# query rows that have no valid key
KEYLESS_CASES = [(True, 30, 50), (False, 40, 100), (True, None, 0), (True, 64, 1)]


@pytest.mark.parametrize("causal,window,sk_valid", KEYLESS_CASES)
def test_rows_with_no_valid_key_are_zero(causal, window, sk_valid):
    """A query row whose keys are all masked is 0: in the plain version
    at its default tiles and at the wgmma kernel's order, and through
    the wrapper.  ``first_keyless_row`` agrees with the mask itself.
    The Pallas kernel returns there the mean of v over the masked keys
    of the tiles it ran, which moves with its tiles: a known, intended
    difference.  The other rows still match it."""
    from repro_torch.kernels.flash_attention.ops import first_keyless_row

    Sq = Sk = 256  # the Pallas kernel takes whole tiles of 64 and 128
    (jq, jk, jv), (tq, tk, tv) = _inputs(9, [(1, Sq, 2, 32), (1, Sk, 1, 32), (1, Sk, 1, 32)])
    i, j = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    ok = (j < sk_valid) & ((i >= j) if causal else True)
    if window is not None:
        ok = ok & (i - j < window)
    keyless = first_keyless_row(Sq, sk_valid, window)
    assert 0 <= keyless < Sq
    assert list(np.flatnonzero(~ok.any(axis=1))) == list(range(keyless, Sq))
    kw = dict(causal=causal, window=window, sk_valid=sk_valid)
    outs = [flash_attention_plain(tq, tk, tv, **kw),
            flash_attention_plain(tq, tk, tv, **kw, block_q=BLOCK_Q, block_k=BLOCK_K),
            flash_attention(tq, tk, tv, **kw)]
    pallas = {}
    for tile in (64, 128):
        pallas[tile] = np.asarray(pallas_kernel(
            jq.transpose(0, 2, 1, 3), jnp.repeat(jk, 2, axis=2).transpose(0, 2, 1, 3),
            jnp.repeat(jv, 2, axis=2).transpose(0, 2, 1, 3), causal=causal, window=window,
            block_q=tile, block_k=tile, sk_valid=sk_valid, interpret=True,
        ).transpose(0, 2, 1, 3))
    for got in outs:
        assert torch.equal(got[:, keyless:], torch.zeros_like(got[:, keyless:]))
        if keyless:
            assert _err(got[:, :keyless], pallas[64][:, :keyless]) < 5e-4
    if sk_valid:  # with no valid key at all the Pallas kernel runs no tile: 0 too
        assert np.abs(pallas[64][:, keyless:]).max() > 0.05


def test_plain_block_sizes_do_not_change_the_result():
    _, (tq, tk, tv) = _inputs(3, [(1, 200, 4, 48), (1, 200, 2, 48), (1, 200, 2, 48)])
    a = flash_attention_plain(tq, tk, tv, window=45)
    b = flash_attention_plain(tq, tk, tv, window=45, block_q=32, block_k=128)
    assert (a - b).abs().max().item() < 1e-5


# (name, B, Sq, Sk, H, KV, d, causal, window, sk_valid): the wgmma kernel's
# tiles (128 rows, 128 keys) with a causal window that starts inside a
# key tile, and a ragged sk_valid in the third key tile under GQA
TILE_CASES = [
    ("causal_window", 1, 256, 256, 2, 2, 64, True, 100, None),
    ("ragged_sk_valid", 2, 128, 384, 4, 2, 64, False, None, 300),
]


@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_plain_at_the_wgmma_tiles_matches_pallas_kernel_and_ref(case):
    """``flash_attention_plain`` at ``block_q=BLOCK_Q, block_k=BLOCK_K``
    (the tile order of the bf16 wgmma kernel, which the card holds to
    this function) against the Pallas kernel at the same 128 x 128 tiles
    in interpret mode, called with its own ``sk_valid``, and ``ref.py``
    over the first ``sk_valid`` keys."""
    _, B, Sq, Sk, H, KV, d, causal, window, sk_valid = case
    assert (BLOCK_Q, BLOCK_K) == (128, 128)
    (jq, jk, jv), (tq, tk, tv) = _inputs(6, [(B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, d)])
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                sk_valid=sk_valid, block_q=BLOCK_Q, block_k=BLOCK_K)
    G = H // KV
    pallas = pallas_kernel(
        jq.transpose(0, 2, 1, 3), jnp.repeat(jk, G, axis=2).transpose(0, 2, 1, 3),
        jnp.repeat(jv, G, axis=2).transpose(0, 2, 1, 3), causal=causal, window=window,
        block_q=BLOCK_Q, block_k=BLOCK_K, sk_valid=sk_valid, interpret=True,
    ).transpose(0, 2, 1, 3)
    n = Sk if sk_valid is None else sk_valid
    ref = flash_attention_ref(jq, jk[:, :n], jv[:, :n], causal=causal, window=window)
    assert _err(got, pallas) < 5e-4
    assert _err(got, ref) < 5e-4


def _emulated_bf16_kernel(q, k, v, *, window, fault):
    """Dense attention that rounds as the wgmma kernel does (P to bf16
    before P·V, the sum l from the f32 P, the output to bf16), with one
    of the faults a bound on the bf16 route has to catch."""
    S = q.shape[1]
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    diag = {"diagonal_minus_1": -1, "diagonal_plus_1": 1}.get(fault, 0)
    w = window + {"window_edge_minus_1": -1, "window_edge_plus_1": 1}.get(fault, 0)
    ok = (i + diag >= j) & (i - j < w)
    k, v = k.clone(), v.clone()
    if fault == "drop_key_tile":
        ok &= ~((j >= 256) & (j < 384))
    if fault == "repeat_key_tile":  # a ring stage read one tile late
        k[:, 256:384], v[:, 256:384] = k[:, 128:256], v[:, 128:256]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[3] ** -0.5
    s = torch.where(ok, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * ok
    o = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v)
    o = o / torch.clamp_min(p.sum(dim=-1), 1e-30).transpose(1, 2)[..., None]
    return o.bfloat16()


BF16_FAULTS = ["drop_key_tile", "repeat_key_tile", "window_edge_minus_1",
               "window_edge_plus_1", "diagonal_minus_1", "diagonal_plus_1"]


@pytest.mark.parametrize("fault", [None] + BF16_FAULTS)
def test_bf16_measure_passes_rounding_and_catches_faults(fault):
    """``bf16_rel_err`` against the plain version in f32, on bf16-valued
    inputs at a long window (h2o-danube's head dim, 512 keys a row): the
    kernel's bf16 rounding stays under half of ``BF16_REL_TOL``, and each
    fault a pipeline or mask slip would make lands at least ten times
    above it.  An absolute bound of 5e-2 passes most of these faults."""
    _, (tq, tk, tv) = _inputs(7, [(1, 1024, 2, 120)] * 3, "bfloat16")
    q, k, v = tq.float(), tk.float(), tv.float()
    want = flash_attention_plain(q, k, v, window=512)
    got = _emulated_bf16_kernel(q, k, v, window=512, fault=fault)
    err = bf16_rel_err(got, want)
    if fault is None:
        assert err < BF16_REL_TOL / 2
    else:
        assert err > 10 * BF16_REL_TOL


def test_bf16_measure_of_rows_without_keys():
    """Rows that see no key are 0 in both: they count 0, not 0 / 0."""
    zero = torch.zeros(1, 3, 2, 8)
    assert bf16_rel_err(zero, zero) == 0.0
    assert bf16_rel_err(zero + 1e-3, zero) == float("inf")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 4, 16)
    with pytest.raises(TypeError):
        flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError):
        flash_attention(x, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_attention(x, x, x, sk_valid=9)
    with pytest.raises(ValueError):
        flash_attention(x[0], x, x)
    # The bf16 (wgmma) route's own checks, which the wrapper applies only
    # to CUDA tensors, after the device dispatch: a CPU tensor runs the
    # plain version, which takes any head dim and address.  So they are
    # shown here on ``_check_tma``, the function the wrapper calls, and on
    # the card by tests/test_torch_gpu.py through the wrapper itself.
    odd = torch.zeros(1, 8, 2, 20, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        _check_tma(odd, odd, odd)
    before = dict(launches)
    assert flash_attention(odd, odd, odd).shape == odd.shape  # the plain version
    assert launches == before
    shifted = torch.zeros(8 * 2 * 16 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 2, 16)
    ok = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 and ok.data_ptr() % 16 == 0
    _check_tma(ok, ok, ok)
    for args in ((shifted, ok, ok), (ok, shifted, ok), (ok, ok, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            _check_tma(*args)


# (q shape, kv shape, v head dim, kwargs): every argument of chunked_attention
CHUNKED_CASES = {
    "causal": ((2, 96, 4, 32), (2, 96, 2, 32), 32, dict(causal=True, chunk=32)),
    "kv_len": ((2, 1, 2, 16), (2, 64, 2, 16), 16,
               dict(causal=False, kv_len=np.array([10, 30]), chunk=16)),
    "q_offset_window": ((2, 5, 4, 16), (2, 40, 2, 16), 16,
                        dict(causal=True, window=7, q_offset=np.array([5, 9]),
                             kv_len=np.array([10, 14]), chunk=16)),
    "ring": ((2, 1, 4, 16), (2, 16, 2, 16), 16, dict(causal=True, window=16, chunk=8)),
    "scale_hdv": ((1, 33, 2, 32), (1, 33, 2, 32), 24,
                  dict(causal=True, scale=0.3, chunk=16)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_attention_matches_repro(case, dtype):
    qs, ks, dv, kw = CHUNKED_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _inputs(4, [qs, ks, ks[:3] + (dv,)], dtype)
    jkw, tkw = dict(kw), dict(kw)
    if case == "ring":  # slots of a ring cache at positions 20 and 37
        L = ks[1]
        pos = np.array([20, 37])
        k_pos = pos[:, None] - (pos[:, None] - np.arange(L)[None, :]) % L
        jkw.update(q_offset=jnp.asarray(pos), k_positions=jnp.asarray(k_pos))
        tkw.update(q_offset=torch.from_numpy(pos), k_positions=torch.from_numpy(k_pos))
    for key in ("kv_len", "q_offset"):
        if key in kw:
            jkw[key], tkw[key] = jnp.asarray(kw[key]), torch.from_numpy(kw[key])
    want = jax_attention.chunked_attention(jq, jk, jv, **jkw)
    got = port_attention.chunked_attention(tq, tk, tv, **tkw)
    assert got.dtype == tq.dtype and tuple(got.shape) == want.shape
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("mode", ["self", "cache", "cross"])
def test_attention_matches_repro(mode):
    cfg_j = jax_reduced("h2o-danube-3-4b", n_kv_heads=2)
    cfg_t = get_reduced("h2o-danube-3-4b", n_kv_heads=2)
    pj = jax_attention.attn_init(jax.random.PRNGKey(0), cfg_j, cross=mode == "cross")
    pt = port_attention.Attention(cfg_t, device="cpu")
    for name in ("wq", "wk", "wv", "wo"):
        getattr(pt, name).copy_(tensor_from_numpy(pj[name]))
    B, S, D = 2, 12, cfg_j.d_model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    jkw, tkw = dict(window=cfg_j.swa_window), dict(window=cfg_t.swa_window)
    if mode == "cache":
        pos = np.array([3, 7], np.int32)
        cache = rng.standard_normal((2, B, 24, cfg_j.n_kv_heads, cfg_j.hd),
                                    dtype=np.float32)
        jkw.update(cache={"k": jnp.asarray(cache[0]), "v": jnp.asarray(cache[1])},
                   cache_pos=jnp.asarray(pos),
                   positions=jnp.asarray(pos[:, None] + np.arange(S)))
        tkw.update(cache={"k": torch.from_numpy(cache[0].copy()),
                          "v": torch.from_numpy(cache[1].copy())},
                   cache_pos=torch.from_numpy(pos),
                   positions=torch.from_numpy(pos[:, None] + np.arange(S)))
    if mode == "cross":
        src = rng.standard_normal((B, 20, D), dtype=np.float32)
        jkw.update(causal=False, rope=False, kv_from=jnp.asarray(src))
        tkw.update(causal=False, rope=False, kv_from=torch.from_numpy(src))
    want, want_cache = jax_attention.attention(cfg_j, pj, jnp.asarray(x), **jkw)
    got, got_cache = port_attention.attention(cfg_t, pt, torch.from_numpy(x), **tkw)
    assert _err(got, want) < 5e-4
    assert (got_cache is None) == (want_cache is None)
    if got_cache is not None:
        for key in ("k", "v"):
            assert _err(got_cache[key], want_cache[key]) < 5e-4
