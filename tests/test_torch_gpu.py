"""The port on a CUDA device: kernels against their plain versions, the
paper's eight apps with blocks on the GPU against the NumPy interpreter
of the JAX package's runtime (which imports no JAX on this path), the
executor's device clock (gated event pairs), and the LMs' prefill with
the kernels (flash, SSD scan, wkv) against their torch twins.
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil5_group_kernel_equals_plain(cuda, dtype):
    """The grouped kernel, each case of ``chip_smoke.py`` phase 2 one
    call, against its plain version (torch.equal): the generic loads on
    strided slivers and fragments, the shared-memory route on shifted
    views of one block, a staged aliased output, and a group split over
    two launches."""
    import chip_smoke

    g = torch.Generator(device=cuda).manual_seed(4)
    for name, frags in chip_smoke.stencil_group_cases(torch, g, dtype):
        # the plain version first, on the operands as they are now, into
        # fresh tensors (an aliased output would change its own operands)
        want = [ks.stencil5_block_plain(*xs, weight=0.2) for xs, _ in frags]
        ks.reset_launches()
        ks.stencil5_group(frags, weight=0.2)
        torch.cuda.synchronize()
        for (xs, out), w in zip(frags, want):
            assert torch.equal(out, w), name
        n_launch = -(-len(frags) // ks.GROUP_MAX_FRAGS)
        assert ks.launches["stencil5_block"] == n_launch, name
        assert sum(ks.fragment_shapes.values()) == len(frags), name
        assert sum(ks.staged_copies.values()) == (name == "aliased output"), name


def test_device_time_shows_in_compute_busy(cuda):
    """A payload of known device time (``torch.cuda._sleep``, about 5
    ms) counts in compute_busy, and not in host_busy, which is the
    host's cost of queueing it; the makespan ends when the device has
    run them all."""
    from repro_torch.core.graph import COMPUTE, AccessNode, DependencySystem, OperationNode
    from repro_torch.exec import AsyncExecutor, ComputeBackend

    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    cycles = int(10_000_000 * 5.0 / a.elapsed_time(b))  # about 5 ms

    class Sleep(ComputeBackend):
        def execute(self, op):
            torch.cuda._sleep(cycles)

    n_ops = 12
    deps = DependencySystem()
    for i in range(n_ops):
        op = OperationNode(COMPUTE, None, procs=(i % 4,))
        op.add_access(AccessNode(("b", i), None, write=True))
        deps.insert(op)
    ex = AsyncExecutor(4, {}, {}, backend=Sleep({}, {}), device="cuda")
    try:
        st = ex.run(deps)
    finally:
        ex.close()
    expect = n_ops * 5e-3
    assert st.n_compute_ops == n_ops
    assert 0.85 * expect <= st.total_compute <= 1.3 * expect, st.total_compute
    assert st.total_host < 0.2 * expect, st.total_host
    assert st.makespan >= 0.95 * st.total_compute


def _sleep_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles that take about ``ms`` on this card."""
    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return int(10_000_000 * ms / a.elapsed_time(b))


def _drain(payload, n_ops: int, nworkers: int = 2):
    """``n_ops`` independent ops of ``payload`` through an executor with a
    device clock; returns (stats, the clock's timeout log)."""
    from repro_torch.core.graph import COMPUTE, AccessNode, DependencySystem, OperationNode
    from repro_torch.exec import AsyncExecutor, ComputeBackend

    class Backend(ComputeBackend):
        def execute(self, op):
            payload()

    deps = DependencySystem()
    for i in range(n_ops):
        op = OperationNode(COMPUTE, None, procs=(i % nworkers,))
        op.add_access(AccessNode(("b", i), None, write=True))
        deps.insert(op)
    ex = AsyncExecutor(nworkers, {}, {}, backend=Backend({}, {}), device="cuda")
    try:
        st = ex.run(deps)
        log = list(ex._clock.timeout_log)
    finally:
        ex.close()
    return st, log


def test_gated_pair_counts_no_host_gap(cuda):
    """A payload of two ~0.2 ms kernels with 5 ms of host time between
    them: the gate holds the pair's start until both are queued, so the
    pair counts the kernels (<= 0.6 ms a payload), not the host's 5 ms."""
    import time

    cycles = _sleep_cycles(0.2)

    def payload():
        torch.cuda._sleep(cycles)
        time.sleep(0.005)
        torch.cuda._sleep(cycles)

    n_ops = 6
    st, log = _drain(payload, n_ops)
    assert st.n_compute_ops == n_ops and st.gate_timeouts == 0 and log == []
    assert 0.3e-3 * n_ops <= st.total_compute <= 0.6e-3 * n_ops, st.total_compute


def test_payload_that_synchronises_counts_one_gate_timeout(cuda):
    """A payload that waits for the device inside waits out its gate's
    limit once, completes, and is counted and logged as a timeout."""
    from repro_torch.exec.backend import _DeviceClock

    cycles = _sleep_cycles(0.2)

    def payload():
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()

    st, log = _drain(payload, 1, nworkers=1)
    assert st.n_compute_ops == 1 and st.gate_timeouts == 1
    assert len(log) == 1 and log[0][1] == "it synchronised", log
    assert log[0][2] >= _DeviceClock.GATE_TIMEOUT_S
    assert 0.1e-3 <= st.total_compute <= 5e-3, st.total_compute


def test_flash_attention_rows_without_keys_are_zero(cuda):
    """The bf16 (wgmma) and f32 kernels return 0 for a query row whose
    keys are all masked, as the plain version does at both tile orders
    (tests/test_torch_flash_attention.py), and agree with it elsewhere."""
    from repro_torch.kernels.flash_attention.ops import BLOCK_K, BLOCK_Q, first_keyless_row

    g = torch.Generator(device=cuda).manual_seed(5)
    for dtype in (torch.bfloat16, torch.float32):
        for causal, window, sk_valid in [(True, 30, 50), (False, 40, 100), (True, None, 0),
                                         (True, 64, 1)]:
            q = torch.randn(1, 256, 2, 64, device=cuda, generator=g).to(dtype)
            k = torch.randn(1, 256, 1, 64, device=cuda, generator=g).to(dtype)
            v = torch.randn(1, 256, 1, 64, device=cuda, generator=g).to(dtype)
            kw = dict(causal=causal, window=window, sk_valid=sk_valid)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw, block_q=BLOCK_Q, block_k=BLOCK_K)
            torch.cuda.synchronize()
            first = first_keyless_row(256, sk_valid, window)
            assert first < 256
            assert torch.equal(got[:, first:], torch.zeros_like(got[:, first:]))
            assert torch.equal(want[:, first:], torch.zeros_like(want[:, first:]))
            if first:
                e = (got[:, :first].double() - want[:, :first].double()).abs().max()
                assert e < FLASH_TOL[dtype], (dtype, kw, e)


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
# shapes, plus the LM path's head dim, GQA, window and a short sk_valid;
# then cases that put the diagonal, the window's lower edge and sk_valid
# at other offsets inside the wgmma kernel's 128-row and 128-key tiles
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
    (1, 300, 300, 2, 1, 16, True, None, None),      # d 16, Sq ragged against 128
    (2, 37, 37, 4, 2, 128, True, None, None),       # Sq < 64: one warpgroup's rows only
    (1, 50, 50, 2, 2, 32, False, None, None),       # Sq < 64, not causal
    (1, 200, 500, 4, 2, 64, False, None, 333),      # Sk > Sq, sk_valid inside a key tile
    (2, 100, 300, 4, 4, 80, True, None, 250),       # Sk > Sq, causal, sk_valid
    (1, 390, 390, 4, 1, 128, True, 1, None),        # window 1: the diagonal alone
    (2, 333, 333, 4, 2, 120, True, 37, None),       # window 37
    (1, 517, 517, 2, 2, 80, True, 129, None),       # window 129: one tile and one key
    (1, 300, 640, 2, 1, 64, False, 129, 600),       # window, not causal, with sk_valid
    (1, 260, 130, 2, 2, 120, True, None, None),     # Sq > Sk
    (1, 1500, 1500, 12, 12, 64, False, None, None), # whisper's encoder: non-causal, Sk 1500
    (2, 448, 1500, 12, 12, 64, False, None, None),  # whisper's cross-attention
    (1, 384, 384, 48, 8, 128, True, None, None),    # grok: d 128, GQA 6:1
    (1, 300, 300, 16, 8, 128, True, None, None),    # internvl2: d 128, GQA 2:1
]
FLASH_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}
FLASH_ROUTE = {torch.float32: "flash_attention_simt", torch.bfloat16: "flash_attention_wgmma"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, case):
    B, Sq, Sk, H, KV, d, causal, window, sk_valid = case
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(B, Sq, H, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, Sk, KV, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, Sk, KV, d, device=cuda, generator=g).to(dtype)
    kw = dict(causal=causal, window=window, sk_valid=sk_valid)
    before = dict(fa.launches)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    route = FLASH_ROUTE[dtype]
    assert fa.launches["flash_attention"] == before["flash_attention"] + 1
    assert fa.launches[route] == before[route] + 1  # bf16 only on wgmma, f32 only on FMA
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() < FLASH_TOL[dtype]
    if dtype == torch.bfloat16:  # and relative to the plain version in f32
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        assert fa.bf16_rel_err(got, want) <= fa.BF16_REL_TOL


def test_flash_attention_raises_on_cuda_inputs_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 8, 2, 136, device=cuda)
        fa.flash_attention(big, big, big)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.bfloat16(), q)


def test_flash_attention_bf16_raises_on_what_tma_does_not_take(cuda):
    """The wgmma kernel's TMA loads need d % 8 == 0 and 16-byte-aligned
    tensors: a bf16 input that fails either raises, with no launch and no
    fallback to the FMA kernel, while f32 takes the same shapes."""
    before = dict(fa.launches)
    odd = torch.zeros(1, 8, 2, 20, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(odd, odd, odd)
    n = 8 * 2 * 16
    shifted = torch.empty(n + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 8, 2, 16)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    ok = torch.zeros(1, 8, 2, 16, device=cuda, dtype=torch.bfloat16)
    for args in ((shifted, ok, ok), (ok, shifted, ok), (ok, ok, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.flash_attention(*args)
    with pytest.raises(ValueError, match="scale"):
        fa.flash_attention(ok, ok, ok, scale=-1.0)
    assert fa.launches == before
    got = fa.flash_attention(odd.float(), odd.float(), odd.float())
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_simt"] == before["flash_attention_simt"] + 1
    assert fa.launches["flash_attention_wgmma"] == before["flash_attention_wgmma"]
    assert torch.equal(got, torch.zeros_like(got))


def test_flash_attention_without_keys_is_zero(cuda):
    """Sk = 0: every row is 0, as the plain version gives.  The FMA kernel
    launches on no key tile; the wgmma kernel is not launched (a tensor
    map cannot have an empty dim)."""
    for dtype, launched in ((torch.float32, 1), (torch.bfloat16, 0)):
        q = torch.randn(1, 3, 2, 16, device=cuda).to(dtype)
        k = torch.zeros(1, 0, 2, 16, device=cuda, dtype=dtype)
        before = fa.launches["flash_attention"]
        got = fa.flash_attention(q, k, k)
        torch.cuda.synchronize()
        assert fa.launches["flash_attention"] == before + launched
        assert torch.equal(got, fa.flash_attention_plain(q, k, k))
        assert torch.equal(got, torch.zeros_like(q))


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
        assert fa.launches[FLASH_ROUTE[cfg.tdtype]] == fa.launches["flash_attention"]
        step, _ = decode_step(c, params, tokens[:, 40], state)
        outs.append((logits, step))
    for a, b in zip(*outs):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() < 1e-3


@pytest.mark.parametrize("arch,flash_calls", [
    ("grok-1-314b", 4), ("deepseek-v2-lite-16b", 0), ("whisper-small", 10),
    ("internvl2-2b", 4)])
def test_four_families_prefill_on_the_card(cuda, arch, flash_calls):
    """The reduced MoE, MLA, encoder-decoder and VLM models on the card:
    use_flash True and False give the same prefill and decode logits in
    f32, with one flash launch a layer, and for whisper one a layer of
    the encoder and one a cross-attention, all on the FMA kernel."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_reduced(arch)
    params = init_params(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 20), device=cuda, generator=g)}
    if cfg.enc_dec:
        batch["enc_frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model, device=cuda,
                                          generator=g)
    if cfg.n_img_tokens:
        batch["img_emb"] = torch.randn(2, cfg.n_img_tokens, cfg.d_model, device=cuda,
                                       generator=g)
    nxt = torch.randint(0, cfg.vocab_size, (2,), device=cuda, generator=g)
    outs = []
    for use_flash in (True, False):
        c = cfg.replace(use_flash=use_flash)
        fa.reset_launches()
        logits, state = prefill(c, params, batch, max_len=cfg.n_img_tokens + 24)
        assert fa.launches["flash_attention"] == (flash_calls if use_flash else 0)
        assert fa.launches["flash_attention_simt"] == fa.launches["flash_attention"]
        step, _ = decode_step(c, params, nxt, state)
        assert fa.launches["flash_attention"] == (flash_calls if use_flash else 0)
        outs.append((logits, step))
    for a, b in zip(*outs):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() < 1e-3


# (b, s, h, p, n, with_state): tests/test_kernels.py's shapes, a ragged s
# and p, an n that is no multiple of 8, the largest n, one token
SSD_CASES = [
    (2, 64, 3, 16, 8, False), (1, 100, 2, 32, 16, True), (1, 256, 1, 64, 64, True),
    (2, 333, 5, 20, 40, True), (1, 70, 2, 64, 128, True), (1, 1, 1, 1, 1, False),
]
# (B, T, H, N, with_state): tests/test_kernels.py's shapes, a head size in
# two column groups (one ragged), a small one, one token
WKV_CASES = [
    (2, 64, 3, 16, False), (1, 100, 2, 32, True), (1, 128, 2, 64, True),
    (2, 333, 3, 40, True), (1, 33, 1, 8, True), (1, 1, 1, 1, False),
]
# tests/test_kernels.py's f32 tolerances; a bf16 y (both sides sum in f32
# and round once) within one bf16 ulp of its largest value
SSD_TOL, WKV_TOL, BF16_REL = 2e-3, 1e-3, 2.0 ** -7
# bf16 runs the chunked dual form on tensor cores, f32 the FMA recurrence
SSD_ROUTE = {torch.float32: "ssd_scan_simt", torch.bfloat16: "ssd_scan_tc"}


def _assert_recurrent_close(got, want, tol):
    (y, fin), (y_ref, fin_ref) = got, want
    assert y.dtype == y_ref.dtype and fin.dtype == fin_ref.dtype == torch.float32
    tol_y = tol if y.dtype == torch.float32 else BF16_REL * y_ref.float().abs().max().item()
    assert (y.float() - y_ref.float()).abs().max().item() <= tol_y
    assert (fin - fin_ref).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, dtype, case):
    from repro_torch.kernels import mamba2_scan as ssd

    b, s, h, p, n, with_state = case
    g = torch.Generator(device=cuda).manual_seed(5)
    f = lambda *shape: torch.randn(*shape, device=cuda, generator=g)
    x, dt = f(b, s, h, p).to(dtype), torch.nn.functional.softplus(f(b, s, h))
    A, B, C = -torch.exp(f(h) * 0.5), f(b, s, n).to(dtype), f(b, s, n).to(dtype)
    s0 = f(b, h, p, n) if with_state else None
    route = SSD_ROUTE[dtype]
    before = dict(ssd.launches)
    got = ssd.ssd_scan(x, dt, A, B, C, s0)
    torch.cuda.synchronize()
    assert ssd.launches["ssd_scan"] == before["ssd_scan"] + 1
    assert ssd.launches[route] == before[route] + 1, f"not on {route}"
    _assert_recurrent_close(got, ssd.ssd_scan_plain(x, dt, A, B, C, s0), SSD_TOL)


def test_ssd_scan_tc_kernel_at_the_zamba2_path_shape(cuda):
    """x [2, 8192, 80, 64], n 64 in bf16 with an initial state, as the
    zamba2-2.7b prefill calls it: on the tensor-core kernel, within the
    tolerances of the cases above."""
    from repro_torch.kernels import mamba2_scan as ssd

    b, s, h, p, n = 2, 8192, 80, 64, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    f = lambda *shape: torch.randn(*shape, device=cuda, generator=g)
    x, dt = f(b, s, h, p).bfloat16(), torch.nn.functional.softplus(f(b, s, h))
    A, B, C = -torch.exp(f(h) * 0.5), f(b, s, n).bfloat16(), f(b, s, n).bfloat16()
    s0 = f(b, h, p, n)
    before = ssd.launches["ssd_scan_tc"]
    got = ssd.ssd_scan(x, dt, A, B, C, s0)
    torch.cuda.synchronize()
    assert ssd.launches["ssd_scan_tc"] == before + 1
    _assert_recurrent_close(got, ssd.ssd_scan_plain(x, dt, A, B, C, s0), SSD_TOL)


def _wkv_decay(f, shape, draw, g):
    """The decay w of a draw: "path", 0.4 + 0.55 sigmoid(N(0, 1)) as
    tests/test_kernels.py draws it; "strong", exp(-exp(x)), x ~ N(1.5, 1),
    with 2% of w exactly 0; "zeros", the path's draw with 10% of w 0."""
    if draw == "strong":
        w = torch.exp(-torch.exp(f(*shape) + 1.5))
        zero = torch.rand(shape, device=w.device, generator=g) < 0.02
    else:
        w = torch.sigmoid(f(*shape)) * 0.55 + 0.4
        zero = torch.rand(shape, device=w.device, generator=g) < (0.1 if draw == "zeros" else 0)
    return torch.where(zero, 0.0, w)


# bf16 runs the chunked form on tensor cores, f32 the FMA recurrence
WKV_ROUTE = {torch.float32: "wkv6_simt", torch.bfloat16: "wkv6_tc"}


@pytest.mark.parametrize("draw", ["path", "strong", "zeros"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_kernel_matches_plain(cuda, dtype, case, draw):
    """Each case on its dtype's kernel within the tolerances; a bf16 y
    also within ``bf16_rel_err`` 2^-6 of the plain version in f32 on the
    same bf16 values."""
    from repro_torch.kernels import rwkv6_wkv as wkv

    B, T, H, N, with_state = case
    g = torch.Generator(device=cuda).manual_seed(6)
    f = lambda *shape: torch.randn(*shape, device=cuda, generator=g)
    r, k, v = (f(B, T, H, N).to(dtype) for _ in range(3))
    w, u = _wkv_decay(f, (B, T, H, N), draw, g), f(H, N)
    s0 = f(B, H, N, N) if with_state else None
    route = WKV_ROUTE[dtype]
    before = dict(wkv.launches)
    got = wkv.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv.launches["wkv6"] == before["wkv6"] + 1
    assert wkv.launches[route] == before[route] + 1, f"not on {route}"
    _assert_recurrent_close(got, wkv.wkv6_plain(r, k, v, w, u, s0), WKV_TOL)
    if dtype == torch.bfloat16:
        want = wkv.wkv6_plain(r.float(), k.float(), v.float(), w, u, s0)[0]
        assert fa.bf16_rel_err(got[0], want) <= fa.BF16_REL_TOL


def test_wkv6_tc_kernel_at_the_rwkv6_path_shape(cuda):
    """r/k/v [2, 8192, 40, 64] in bf16 with an initial state, as the
    rwkv6-3b prefill calls it: on the tensor-core kernel, within the
    tolerances of the cases above."""
    from repro_torch.kernels import rwkv6_wkv as wkv

    B, T, H, N = 2, 8192, 40, 64
    g = torch.Generator(device=cuda).manual_seed(8)
    f = lambda *shape: torch.randn(*shape, device=cuda, generator=g)
    r, k, v = (f(B, T, H, N).bfloat16() for _ in range(3))
    w, u, s0 = _wkv_decay(f, (B, T, H, N), "path", g), f(H, N), f(B, H, N, N)
    before = wkv.launches["wkv6_tc"]
    got = wkv.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv.launches["wkv6_tc"] == before + 1
    _assert_recurrent_close(got, wkv.wkv6_plain(r, k, v, w, u, s0), WKV_TOL)
    want = wkv.wkv6_plain(r.float(), k.float(), v.float(), w, u, s0)[0]
    assert fa.bf16_rel_err(got[0], want) <= fa.BF16_REL_TOL


def test_recurrent_wrappers_raise_on_cuda_inputs_they_do_not_take(cuda):
    from repro_torch.kernels import mamba2_scan as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv

    x = torch.zeros(1, 8, 2, 4, device=cuda)
    dt, A, B = torch.ones(1, 8, 2, device=cuda), -torch.ones(2, device=cuda), torch.zeros(
        1, 8, 16, device=cuda)
    before = ssd.launches["ssd_scan"]
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, B)
    big = torch.zeros(1, 8, 129, device=cuda)
    with pytest.raises(ValueError, match="state size"):
        ssd.ssd_scan(x, dt, A, big, big)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt.bfloat16(), A, B, B)
    with pytest.raises(ValueError, match="devices"):
        ssd.ssd_scan(x, dt, A, B, B.cpu())
    assert ssd.launches["ssd_scan"] == before
    r = torch.zeros(1, 8, 2, 65, device=cuda)
    with pytest.raises(ValueError, match="head size"):
        wkv.wkv6(r, r, r, r, torch.zeros(2, 65, device=cuda))
    r = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        wkv.wkv6(r, r, r, torch.zeros(1, 8, 2, 32, device=cuda)[..., :16],
                 torch.zeros(2, 16, device=cuda))
    with pytest.raises(TypeError):
        wkv.wkv6(r.bfloat16(), r.bfloat16(), r.bfloat16(), r.bfloat16(),
                 torch.zeros(2, 16, device=cuda))


@pytest.mark.parametrize("arch,kw,counts", [
    ("zamba2-2.7b", dict(n_layers=12, layer_pattern="MMMMMH" * 2),
     {"ssd_scan": 12, "flash_attention": 2}),
    ("rwkv6-3b", {}, {"wkv6": 4}),
])
def test_recurrent_lm_prefill_kernels_match_torch_twins(cuda, arch, kw, counts):
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import mamba2_scan as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.models import decode_step, init_params, prefill

    mods = {"ssd_scan": ssd, "flash_attention": fa, "wkv6": wkv}
    cfg = get_reduced(arch, **kw)
    params = init_params(cfg, seed=0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (2, 41), device=cuda, generator=g)
    outs = []
    for use_flash in (True, False):
        c = cfg.replace(use_flash=use_flash)
        for m in mods.values():
            m.reset_launches()
        logits, state = prefill(c, params, {"tokens": tokens[:, :40]}, max_len=48)
        got = {name: m.launches[name] for name, m in mods.items() if name in counts}
        assert got == (counts if use_flash else dict.fromkeys(counts, 0))
        step, _ = decode_step(c, params, tokens[:, 40], state)
        assert all(m.launches[name] == got[name] for name, m in mods.items()
                   if name in counts)
        outs.append((logits, step))
    for a, b in zip(*outs):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() < 1e-3


def _numpy_sweeps(full, iters):
    """The fig. 10 sweeps on the host in float64 (chip_smoke.numpy_sweeps)."""
    for _ in range(iters):
        acc = full[1:-1, 1:-1] + full[0:-2, 1:-1]
        acc += full[2:, 1:-1]
        acc += full[1:-1, 0:-2]
        acc += full[1:-1, 2:]
        full[1:-1, 1:-1] = 0.2 * acc
    return full


def test_server_tenants_on_gpu_bit_identical_through_stencil5_group(cuda):
    """Two tenants of a small Jacobi request on a Server on the card, each
    on its own grid (a request scatters it, sweeps twice and gathers it):
    every result equals host NumPy bit for bit, every fused map went to
    stencil5_group, and no gate timed out."""
    import threading

    import repro_torch
    from repro_torch.kernels import stream_gate

    n, block, sweeps, requests = 256, 64, 2, 2
    grids = []
    for i in range(2):
        g = np.zeros((n + 2, n + 2))
        g[0, :] = g[:, 0] = 1.0 + i
        grids.append(g)
    results, errors = [[], []], []
    ks.reset_launches()
    stream_gate.reset_launches()
    with repro_torch.Server(nprocs=4, block_size=block, fusion=True, device="cuda",
                            flush="async", channel="async", sync="demand",
                            max_inflight=2, max_queue=2) as srv:
        def client(i):
            host = grids[i]
            sess = srv.session(f"t{i}")
            try:
                for _ in range(requests):
                    def fn(h=host):
                        return apps.stencil_sweeps(repro_torch.array(h), sweeps)
                    host = sess.request(fn).result()
                    results[i].append(host)
            except BaseException as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        ex = srv.runtime._exec_executor_obj
        timeouts = sum(w.stats.gate_timeouts for w in ex.workers)
        log = list(ex._clock.timeout_log)
        tenants = srv.stats()
    for i in range(2):
        want = grids[i].copy()
        for got in results[i]:
            _numpy_sweeps(want, sweeps)
            assert np.array_equal(got, want), i
    frags = sum(ks.fragment_shapes.values())
    assert frags == 2 * requests * sweeps * 9 * (n // block) ** 2
    assert 0 < ks.launches["stencil5_block"] < frags
    assert stream_gate.launches["gate_wait"] > 0
    assert timeouts == 0 and log == [], log
    assert all(st.gate_timeouts == 0 and st.n_failed == 0 for st in tenants.values())


def test_attribution_on_gpu_charges_device_time_not_host_time(cuda):
    """A traced drain whose payloads spend ~10 ms of host CPU between two
    ~0.2 ms kernels: attribution charges the gated pairs' device time
    (equal to compute_busy), not the host's, and its wait_fraction agrees
    with the device-timed WaitStats within 0.02."""
    import time

    import repro_torch
    from repro_torch.core.graph import COMPUTE, AccessNode, DependencySystem, OperationNode
    from repro_torch.exec import AsyncExecutor, ComputeBackend

    cycles = _sleep_cycles(0.2)

    class Backend(ComputeBackend):
        def execute(self, op):
            torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.01:  # host work, on the CPU
                pass
            torch.cuda._sleep(cycles)

    n_ops = 8
    deps = DependencySystem()
    for i in range(n_ops):
        op = OperationNode(COMPUTE, None, procs=(i % 2,))
        op.add_access(AccessNode(("b", i), None, write=True))
        deps.insert(op)
    with repro_torch.trace() as tr:
        ex = AsyncExecutor(2, {}, {}, backend=Backend({}, {}), device="cuda")
        try:
            st = ex.run(deps)
        finally:
            ex.close()
    rep = repro_torch.attribution(tr)
    assert st.gate_timeouts == 0
    assert sum(1 for e in tr.events if e[1] == "compute-device") == n_ops
    assert rep.total_compute == pytest.approx(st.total_compute, abs=1e-6)
    assert rep.total_compute <= 0.6e-3 * n_ops, rep.total_compute
    assert abs(rep.wait_fraction - st.wait_fraction) <= 0.02
    repro_torch.validate_trace(repro_torch.export_trace(tr))


def test_copies_on_another_thread_hold_no_gate_to_its_timeout(cuda):
    """A drain in flight while another thread scatters host arrays onto
    the card and gathers them back (a serving tenant's copies): the
    copies queue under the runtime's stream lock, so none waits behind a
    gated pair and blocks its holder until the gate times out; no pair
    times out, and every copy and the drain's result are exact."""
    import threading

    import repro_torch
    from repro_torch.core import engine

    n = 512
    host = np.random.default_rng(3).standard_normal((256, 256))
    with repro_torch.runtime(nprocs=8, block_size=64, fusion=True, device="cuda",
                             flush="async", channel="async", sync="demand") as rt:
        full = apps.jacobi_stencil(n=n, iters=10)
        ticket = rt.flush(wait=False, targets=[full])
        copies, errors = [0], []

        def tenant():
            engine._tls.runtime = rt
            try:
                while not ticket.done():
                    a = repro_torch.array(host)
                    assert np.array_equal(np.asarray(a), host)
                    copies[0] += 1
            except BaseException as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        t = threading.Thread(target=tenant)
        t.start()
        st = ticket.wait()
        t.join(60.0)
        assert not t.is_alive() and not errors, errors
        log = list(rt._exec_executor_obj._clock.timeout_log)
        got = np.asarray(full)
    assert copies[0] > 0
    assert st.gate_timeouts == 0 and log == [], log
    want = np.zeros((n + 2, n + 2))
    want[0, :] = want[:, 0] = 1.0
    assert np.array_equal(got, _numpy_sweeps(want, 10))


@pytest.fixture
def nccl_world(cuda, tmp_path):
    """A process group of one rank on NCCL, on the card (one card gives
    NCCL one rank); no fallback to another backend."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("overlap", ["ring", "none"])
def test_jacobi_step_sharded_on_nccl_equals_the_sweep_kernel_and_numpy(nccl_world, overlap):
    """``comm.jacobi_step_sharded`` on one NCCL rank: bit for bit the CUDA
    ``jacobi_sweep`` and the host NumPy sweep of the same f64 grid (the
    same summation order in all three)."""
    from repro_torch.comm import jacobi_step_sharded

    host = np.random.default_rng(4).standard_normal((258, 300))
    x = torch.from_numpy(host).cuda()
    got = jacobi_step_sharded(x, None, overlap=overlap)
    want = ks.jacobi_sweep(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64 and torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), _numpy_sweeps(host.copy(), 1))


@pytest.mark.parametrize("overlap", ["ring", "none"])
def test_collective_matmuls_on_nccl_equal_torch_matmul(nccl_world, overlap):
    """``ag_matmul`` and ``matmul_rs`` on one NCCL rank, bf16: bit for bit
    ``torch.matmul`` of the same operands."""
    from repro_torch.comm import ag_matmul, matmul_rs

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(256, 384, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(384, 512, device="cuda", generator=g).to(torch.bfloat16)
    want = torch.matmul(x, w)
    assert torch.equal(ag_matmul(x, w, None, overlap=overlap), want)
    assert torch.equal(matmul_rs(x, w, None, overlap=overlap), want)
