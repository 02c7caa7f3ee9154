"""The port on a CUDA device: kernels against their plain versions, the
paper's eight apps with blocks on the GPU against the NumPy interpreter
of the JAX package's runtime (which imports no JAX on this path), and
the LM's prefill with the flash kernel against its torch attention.
Marked ``gpu``; each test skips where no CUDA device is visible.

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import apps
from repro_torch.api import ExecutionPolicy, RuntimeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import stencil as ks

pytestmark = pytest.mark.gpu

# the CPU suite's sizes and blocks (tests/test_torch_runtime.py)
SMALL = dict(
    fractal=dict(n=128, iters=4),
    black_scholes=dict(n=50_000, iters=3),
    nbody=dict(n=192, steps=2),
    knn=dict(n=512, d=16),
    lbm2d=dict(h=128, w=128, steps=2),
    lbm3d=dict(d=16, h=16, w=16, steps=2),
    jacobi=dict(n=256, nrhs=256, iters=3),
    jacobi_stencil=dict(n=256, iters=3),
)
SMALL_BLOCKS = dict(
    fractal=32, black_scholes=8192, nbody=64, knn=128,
    lbm2d=32, lbm3d=8, jacobi=64, jacobi_stencil=64,
)
EXACT = {"fractal", "lbm2d", "lbm3d", "jacobi_stencil"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 1), (33, 700), (300, 257)])
def test_stencil5_kernel_equals_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(1)
    rows, cols = shape
    bigs = [torch.randn(rows + 2, cols + 3, dtype=dtype, device=cuda, generator=g)
            for _ in range(5)]
    xs = [b[1:rows + 1, 1:cols + 1] for b in bigs]
    before = ks.launches["stencil5_block"]
    got = ks.stencil5_block(*xs, weight=0.2)
    torch.cuda.synchronize()
    assert ks.launches["stencil5_block"] == before + 1
    assert torch.equal(got, ks.stencil5_block_plain(*xs, weight=0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 5), (3, 3), (100, 64), (257, 1031)])
def test_jacobi_sweep_kernel_equals_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(*shape, dtype=dtype, device=cuda, generator=g)
    a = b = x
    for _ in range(3):
        a, b = ks.jacobi_sweep(a), ks.jacobi_sweep_plain(b)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_wrappers_raise_on_cuda_inputs_they_do_not_take(cuda):
    x = torch.zeros(8, 8, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        ks.jacobi_sweep(x.T[:, ::2])
    with pytest.raises(ValueError):
        ks.stencil5_block(x, x, x, x, x.cpu(), weight=0.2)


@pytest.mark.parametrize("app", list(SMALL))
@pytest.mark.parametrize("fusion", [False, True])
def test_apps_on_gpu_match_numpy_interpreter(cuda, app, fusion):
    from benchmarks.paper_apps import run_app as run_ref

    cfg = RuntimeConfig(nprocs=4, block_size=SMALL_BLOCKS[app], fusion=fusion,
                        device="cuda")
    _, got = apps.run_app(app, cfg, ExecutionPolicy(flush="async"), **SMALL[app])
    _, want = run_ref(app, nprocs=4, block_size=SMALL_BLOCKS[app],
                      fusion=fusion, flush_backend="async",
                      exec_backend="numpy", **SMALL[app])
    assert got.dtype == want.dtype and got.shape == want.shape
    if app in EXACT:
        assert np.array_equal(got, want, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# (B, Sq, Sk, H, KV, d, causal, window, sk_valid): tests/test_kernels.py's
# shapes, plus the LM path's head dim, GQA, window and a short sk_valid
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True, None, None),
    (2, 130, 130, 4, 2, 64, True, None, None),
    (1, 64, 192, 2, 1, 80, True, None, None),
    (1, 96, 96, 4, 4, 128, True, None, None),
    (1, 256, 256, 2, 2, 64, False, None, None),
    (1, 256, 256, 2, 2, 64, True, 37, None),
    (2, 333, 333, 8, 2, 120, True, 100, None),
    (2, 77, 200, 8, 2, 120, True, 50, 77),
    (1, 1, 5, 4, 1, 32, False, None, 3),
]
FLASH_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, case):
    B, Sq, Sk, H, KV, d, causal, window, sk_valid = case
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(B, Sq, H, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, Sk, KV, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, Sk, KV, d, device=cuda, generator=g).to(dtype)
    kw = dict(causal=causal, window=window, sk_valid=sk_valid)
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == before + 1
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() < FLASH_TOL[dtype]


def test_flash_attention_raises_on_cuda_inputs_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 8, 2, 136, device=cuda)
        fa.flash_attention(big, big, big)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q)


def test_lm_prefill_flash_matches_torch_attention(cuda):
    from repro_torch.configs import get_reduced
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_reduced("h2o-danube-3-4b", n_kv_heads=2)
    params = init_params(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 41), device=cuda, generator=g)
    outs = []
    for use_flash in (True, False):  # prompt 40 > window 16: a ring prefill
        c = cfg.replace(use_flash=use_flash)
        fa.reset_launches()
        logits, state = prefill(c, params, {"tokens": tokens[:, :40]}, max_len=48)
        assert fa.launches["flash_attention"] == (cfg.n_layers if use_flash else 0)
        step, _ = decode_step(c, params, tokens[:, 40], state)
        outs.append((logits, step))
    for a, b in zip(*outs):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() < 1e-3
