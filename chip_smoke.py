#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, each asserted (any failure exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc``, one
   nvcc per source, all started together;
2. hold every kernel to its plain PyTorch version on the card (the
   stencil kernels, then flash attention in f32 and bf16 over head dims
   80, 120 and 128, ragged lengths, GQA, windows, a short ``sk_valid``,
   and the LM path's own shape in f32 and bf16);
3. the main path: the paper's flagship Jacobi stencil through
   ``repro_torch.runtime`` (async executor, torch backend, fusion on,
   blocks on the GPU) at 16384², 6 sweeps, 16 processes, 2048² blocks,
   then its compiled-sweep check (whole-grid ``jacobi_sweep``); both
   must equal a sequential host-NumPy float64 stencil bit for bit, and
   every kernel of the path must have been launched;
4. the paper's own regime (4096², 512² blocks, 16 processes) under
   ``sync="demand"`` and ``sync="barrier"``;
5. the overlap probe of examples/stencil_latency_hiding.py (256², 8
   workers, 10 ms injected latency) on the async and blocking channels;
6. each stencil kernel's time at the main path's shapes beside its
   bound, its plain version's time and a PyTorch yardstick where one
   exists;
7. the LM path: h2o-danube-3-4b at full width and depth (24 layers,
   d_model 3840, 32/8 heads of 120, window 4096, bf16, random weights
   from seed 0) serving two prompts of 8192 seeded tokens —
   ``make_prefill_step`` then 16 greedy ``make_serve_step`` steps — with
   exactly one flash launch per layer in prefill and none in decode;
8. the same prompts through the torch ``chunked_attention``
   (``use_flash=False``), teacher-forced on the tokens of phase 7, in
   bf16 at full depth and in f32 at full width with 2 layers;
9. the flash kernel's time at the LM path's shape beside its bound, its
   plain version's time and ``F.scaled_dot_product_attention`` with a
   band mask as a yardstick (which the port never calls).

The second-to-last line of output is the JSON ``kernels`` record, the
line before it the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no GPU is visible or the port is missing.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor cores, NVIDIA data sheet
STENCIL_CU = "src/repro_torch/kernels/stencil/csrc/stencil.cu"
FLASH_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
MAIN_N, MAIN_ITERS, MAIN_PROCS, MAIN_BLOCK = 16384, 6, 16, 2048
PAPER_N, PAPER_BLOCK = 4096, 512
# the LM path: SHAPES["prefill_32k"] (32 x 32768) cut to 2 x 8192 (twice
# the 4096 window, so the window mask and the ring cache both run)
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "h2o-danube-3-4b", 2, 8192, 16
FLASH_TOL = {"float32": 5e-4, "bfloat16": 5e-2}  # tests/test_kernels.py's
# flash vs torch attention through the whole model: bf16 at 24 layers,
# max |logit difference| over the max |logit|; f32 at 2 layers, absolute
LM_BF16_REL_TOL, LM_F32_ABS_TOL = 5e-2, 5e-4
# (B, Sq, Sk, H, KV, d, causal, window, sk_valid)
FLASH_CASES = [
    (1, 64, 192, 2, 1, 80, True, None, None),      # cross-length, d 80
    (2, 130, 130, 4, 2, 64, True, None, None),     # ragged S
    (1, 96, 96, 4, 4, 128, True, None, None),      # d 128
    (1, 256, 256, 2, 2, 64, False, 50, None),      # window, not causal
    (2, 1000, 1000, 32, 8, 120, True, 300, None),  # the LM's heads, ragged S
    (2, 700, 1024, 32, 8, 120, True, 256, 700),    # prefill over a cache
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def numpy_stencil(n: int, iters: int) -> np.ndarray:
    """The paper's fig. 10 program, sequential, on the host in float64."""
    full = np.zeros((n + 2, n + 2))
    full[0, :] = 1.0
    full[:, 0] = 1.0
    for _ in range(iters):
        acc = full[1:-1, 1:-1] + full[0:-2, 1:-1]
        acc += full[2:, 1:-1]
        acc += full[1:-1, 0:-2]
        acc += full[1:-1, 2:]
        full[1:-1, 1:-1] = 0.2 * acc
    return full


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` launches, by CUDA
    events around each launch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels_vs_plain(ks, torch, gen) -> dict:
    """Every kernel against its plain version on the card; returns the
    largest |kernel - plain| seen per kernel."""
    err = {"stencil5_block": 0.0, "jacobi_sweep": 0.0}
    for dtype in (torch.float64, torch.float32):
        for rows, cols in ((512, 512), (2048, 2048), (500, 37)):
            # strided views: slices of larger blocks, as the runtime passes
            bigs = [torch.randn(rows + 3, cols + 5, dtype=dtype, device=DEVICE,
                                generator=gen) for _ in range(5)]
            xs = [b[1:rows + 1, 2:cols + 2] for b in bigs]
            assert not xs[0].is_contiguous()
            got = ks.stencil5_block(*xs, weight=0.2)
            want = ks.stencil5_block_plain(*xs, weight=0.2)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (dtype, rows, cols)
            err["stencil5_block"] = max(err["stencil5_block"], max_abs_err(got, want))
        for H, W in ((4098, 4098), (1000, 777)):
            x = torch.randn(H, W, dtype=dtype, device=DEVICE, generator=gen)
            a, b = x, x
            for sweep in range(4):
                a = ks.jacobi_sweep(a)
                b = ks.jacobi_sweep_plain(b)
                e = max_abs_err(a, b)
                if dtype == torch.float64:
                    assert torch.equal(a, b), (H, W, sweep)
                else:
                    assert e <= 1e-6, (H, W, sweep, e)
                err["jacobi_sweep"] = max(err["jacobi_sweep"], e)
    log(f"[2] kernels == plain versions on the card "
        f"(stencil5 f64/f32 512², 2048², 500x37 strided: torch.equal; "
        f"jacobi 4098², 1000x777, 4 sweeps: f64 equal, f32 atol 1e-6); "
        f"max |err| {err}")
    return err


def flash_inputs(torch, gen, B, Sq, Sk, H, KV, d, dtype):
    q = torch.randn(B, Sq, H, d, device=DEVICE, generator=gen).to(dtype)
    k = torch.randn(B, Sk, KV, d, device=DEVICE, generator=gen).to(dtype)
    v = torch.randn(B, Sk, KV, d, device=DEVICE, generator=gen).to(dtype)
    return q, k, v


def phase_flash_vs_plain(fa, torch, gen) -> dict:
    """The flash kernel against its plain version: the case table, then
    the LM path's shape, each in f32 and bf16.  Returns the largest
    |kernel - plain| per dtype and at the path's shape."""
    err = {"float32": 0.0, "bfloat16": 0.0}
    for name in err:
        dtype = getattr(torch, name)
        for B, Sq, Sk, H, KV, d, causal, window, sk_valid in FLASH_CASES:
            q, k, v = flash_inputs(torch, gen, B, Sq, Sk, H, KV, d, dtype)
            kw = dict(causal=causal, window=window, sk_valid=sk_valid)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            assert got.dtype == dtype and e < FLASH_TOL[name], (name, B, Sq, Sk, d, e)
            err[name] = max(err[name], e)
    # the LM path's shape, in f32 (the tight check: the kernel accumulates
    # in f32 whatever the input) and in bf16 (the path's own dtype)
    for name, key in (("float32", "path_f32"), ("bfloat16", "path")):
        q, k, v = flash_inputs(torch, gen, LM_BATCH, LM_PROMPT, LM_PROMPT, 32, 8, 120,
                               getattr(torch, name))
        got = fa.flash_attention(q, k, v, causal=True, window=4096)
        want = fa.flash_attention_plain(q, k, v, causal=True, window=4096)
        torch.cuda.synchronize()
        err[key] = max_abs_err(got, want)
        assert err[key] < FLASH_TOL[name], (name, err)
        del q, k, v, got, want
    log(f"[2] flash_attention == plain version on the card ({len(FLASH_CASES)} "
        f"cases: d 64/80/120/128, ragged, cross-length, GQA, windows, sk_valid; "
        f"f32 tol {FLASH_TOL['float32']}, bf16 tol {FLASH_TOL['bfloat16']}; "
        f"and the LM path's shape [{LM_BATCH}, {LM_PROMPT}, 32, 120] / 8 KV "
        f"heads, window 4096, in f32 and bf16); max |err| f32 {err['float32']:.3g}, "
        f"bf16 {err['bfloat16']:.3g}, path f32 {err['path_f32']:.3g}, "
        f"path bf16 {err['path']:.3g}")
    return err


def run_stencil(repro_torch, apps, n, iters, nprocs, block, **policy_kw):
    """The flagship through the port's runtime; returns (result, stats,
    timings, peak device bytes)."""
    import torch

    from repro_torch.api import ExecutionPolicy, RuntimeConfig

    cfg = RuntimeConfig(nprocs=nprocs, block_size=block, fusion=True,
                        device=DEVICE)
    policy = ExecutionPolicy(flush="async", channel="async", backend="torch",
                             **policy_kw)
    torch.cuda.reset_peak_memory_stats()
    with repro_torch.runtime(cfg, policy) as rt:
        t0 = time.perf_counter()
        full = apps.jacobi_stencil(n=n, iters=iters)
        t1 = time.perf_counter()
        repro_torch.evaluate(full).block_until_ready()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        assert rt.storage and all(t.device.type == DEVICE for t in rt.storage.values())
        assert all(t.device.type == DEVICE for t in rt.scratch.values())
        result = np.asarray(full)
        t3 = time.perf_counter()
        stats = rt.stats()
    times = dict(record_s=t1 - t0, drain_s=t2 - t1, gather_s=t3 - t2)
    return result, stats, times, torch.cuda.max_memory_allocated()


def phase_main_path(repro_torch, apps, ks) -> dict:
    import torch

    ks.reset_launches()
    result, st, times, peak = run_stencil(
        repro_torch, apps, MAIN_N, MAIN_ITERS, MAIN_PROCS, MAIN_BLOCK
    )
    t0 = time.perf_counter()
    swept = apps.jacobi_sweeps(MAIN_N, MAIN_ITERS, device=DEVICE)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    swept = swept.cpu().numpy()
    launches = dict(ks.launches)
    shapes = {k: dict(v) for k, v in ks.launch_shapes.items()}
    t0 = time.perf_counter()
    want = numpy_stencil(MAIN_N, MAIN_ITERS)
    numpy_s = time.perf_counter() - t0
    assert result.shape == want.shape == (MAIN_N + 2, MAIN_N + 2)
    assert np.isfinite(result).all()
    assert np.array_equal(result, want), "runtime stencil != host NumPy"
    assert np.array_equal(swept, want), "jacobi_sweep iterations != host NumPy"
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    log(f"[3] main path: jacobi_stencil n={MAIN_N} iters={MAIN_ITERS} "
        f"nprocs={MAIN_PROCS} block={MAIN_BLOCK} f64 fusion on, blocks on cuda; "
        f"== host NumPy bit for bit (runtime and {MAIN_ITERS} jacobi_sweep launches)")
    log(f"    makespan {st.makespan * 1e3:.3f} ms  wait_fraction "
        f"{st.wait_fraction:.4f}  comm_wait_fraction "
        f"{st.comm_wait_fraction:.4f}  ops/s "
        f"{st.ops_per_sec:.1f}  compute ops {st.n_compute_ops}  comm ops "
        f"{st.n_comm_ops}")
    log(f"    record {times['record_s']:.3f} s  drain+sync {times['drain_s']:.3f} s  "
        f"gather (host copy of {result.nbytes / 1e9:.2f} GB) {times['gather_s']:.3f} s  "
        f"jacobi_sweeps {sweep_s:.3f} s  host NumPy {numpy_s:.3f} s  "
        f"peak device memory {peak / 1e9:.2f} GB")
    log(f"    launches {launches}")
    top = sorted(shapes["stencil5_block"].items(), key=lambda kv: -kv[1])[:5]
    log(f"    stencil5_block launch shapes (top 5 of "
        f"{len(shapes['stencil5_block'])}): {top}")
    return dict(launches=launches, shapes=shapes)


def phase_paper_regime(repro_torch, apps, ks) -> None:
    want = numpy_stencil(PAPER_N, MAIN_ITERS)
    for sync in ("demand", "barrier"):
        before = ks.launches["stencil5_block"]
        result, st, times, _ = run_stencil(
            repro_torch, apps, PAPER_N, MAIN_ITERS, MAIN_PROCS, PAPER_BLOCK,
            sync=sync,
        )
        assert np.array_equal(result, want), f"paper regime sync={sync}"
        assert ks.launches["stencil5_block"] > before
        log(f"[4] paper regime n={PAPER_N} block={PAPER_BLOCK} sync={sync}: "
            f"== host NumPy; makespan {st.makespan * 1e3:.3f} ms wait_fraction "
            f"{st.wait_fraction:.4f} ops/s {st.ops_per_sec:.1f} "
            f"drain+sync {times['drain_s']:.3f} s")


def phase_overlap_probe(repro_torch, apps) -> None:
    from repro_torch.api import ExecutionPolicy, RuntimeConfig

    n, iters, procs, alpha = 256, 4, 8, 10e-3
    cfg = RuntimeConfig(nprocs=procs, block_size=64, device=DEVICE)
    measured = ExecutionPolicy(flush="async", channel="async", latency=alpha,
                               backend="torch")
    st_on, r_on = apps.run_app("jacobi_stencil", cfg, measured, n=n, iters=iters)
    st_off, r_off = apps.run_app("jacobi_stencil", cfg,
                                 measured.replace(channel="blocking"),
                                 n=n, iters=iters)
    assert np.array_equal(r_on, r_off), "channel discipline changed the result"
    assert np.array_equal(r_on, numpy_stencil(n, iters))
    log(f"[5] overlap probe {n}² {procs} workers {alpha * 1e3:.0f} ms latency "
        f"(unfused, generic torch payloads): async wait_fraction "
        f"{st_on.wait_fraction:.4f} makespan {st_on.makespan * 1e3:.1f} ms | "
        f"blocking wait_fraction {st_off.wait_fraction:.4f} makespan "
        f"{st_off.makespan * 1e3:.1f} ms | results bit-identical")


def phase_times(ks, torch, gen, main: dict, err: dict) -> list:
    import torch.nn.functional as F

    records = []
    # stencil5_block at the main path's largest fragment shape, on strided
    # views of 2048² blocks as the runtime passes them
    shape = max(main["shapes"]["stencil5_block"], key=lambda s: s[0] * s[1])
    rows, cols = shape
    blocks = [torch.randn(MAIN_BLOCK, MAIN_BLOCK, dtype=torch.float64,
                          device=DEVICE, generator=gen) for _ in range(5)]
    xs = [b[:rows, :cols] for b in blocks]
    ms = cuda_ms(lambda: ks.stencil5_block(*xs, weight=0.2))
    plain_ms = cuda_ms(lambda: ks.stencil5_block_plain(*xs, weight=0.2))
    nbytes = 6 * rows * cols * 8  # five operands read, one result written
    records.append(dict(
        name="stencil5_block", route="cuda", source=STENCIL_CU,
        replaces="src/repro/kernels/stencil/kernel.py:88",
        launches=main["launches"]["stencil5_block"],
        max_abs_err=err["stencil5_block"], ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
    ))
    log(f"[6] stencil5_block {rows}x{cols} f64 (strided views of "
        f"{MAIN_BLOCK}² blocks): kernel {ms:.4f} ms | bound {records[-1]['bound_ms']:.4f} ms "
        f"({nbytes / 1e6:.1f} MB at 3.35 TB/s) | plain {plain_ms:.4f} ms | "
        f"library: none (no single PyTorch call computes the 5-way sum)")
    del blocks, xs
    # jacobi_sweep at the main path's grid
    H = W = MAIN_N + 2
    x = torch.rand(H, W, dtype=torch.float64, device=DEVICE, generator=gen)
    ms = cuda_ms(lambda: ks.jacobi_sweep(x), reps=10)
    plain_ms = cuda_ms(lambda: ks.jacobi_sweep_plain(x), reps=10)
    w = torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2], [0.0, 0.2, 0.0]],
                     dtype=torch.float64, device=DEVICE).view(1, 1, 3, 3)
    x4 = x.view(1, 1, H, W)
    conv_ms = cuda_ms(lambda: F.conv2d(x4, w), reps=10)
    nbytes = 2 * H * W * 8  # grid read once, written once
    records.append(dict(
        name="jacobi_sweep", route="cuda", source=STENCIL_CU,
        replaces="src/repro/kernels/stencil/kernel.py:51",
        launches=main["launches"]["jacobi_sweep"],
        max_abs_err=err["jacobi_sweep"], ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=conv_ms,
    ))
    log(f"[6] jacobi_sweep {H}x{W} f64: kernel {ms:.4f} ms | bound "
        f"{records[-1]['bound_ms']:.4f} ms ({nbytes / 1e9:.2f} GB at 3.35 TB/s) | "
        f"plain {plain_ms:.4f} ms | yardstick F.conv2d 3x3 over the interior "
        f"(not used by the port) {conv_ms:.4f} ms")
    return records


# ---------------------------------------------------------------------------
# the LM path
# ---------------------------------------------------------------------------


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return max_abs_err(a, b) / float(b.double().abs().max())


def profile_device(torch, what: str, fn) -> float:
    """Device time by kernel over one call of ``fn``, from torch.profiler;
    returns the total in ms (0.0 when the profiler records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # kernel rows only: an aten op's row repeats its kernels' device time
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    total = sum(r[0] for r in rows)
    if total <= 0:
        log(f"    profiler: no device time recorded over {what} (not measured)")
        return 0.0
    log(f"    profiler: device time over {what} {total / 1e3:.2f} ms; top:")
    for us, count, key in rows[:6]:
        log(f"      {us / 1e3:9.2f} ms {100 * us / total:5.1f}%  x{count}  {key[:90]}")
    return total / 1e3


def phase_lm(fa, torch) -> dict:
    """The LM main path: prefill then greedy decode, flash launches counted."""
    from repro_torch.configs import SHAPES, ShapeSpec
    from repro_torch.launch.steps import cell_config, make_prefill_step, make_serve_step
    from repro_torch.models import init_params

    cfg = cell_config(LM_ARCH, "prefill_32k")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.swa_window, cfg.dtype, cfg.use_flash) == (
        24, 3840, 32, 8, 120, 4096, "bfloat16", True), cfg
    full = SHAPES["prefill_32k"]
    shape = ShapeSpec(f"{full.name} cut to {LM_BATCH}x{LM_PROMPT}",
                      LM_PROMPT + LM_NEW, LM_BATCH, "prefill")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    # param_count() leaves out the final norm's d_model weights
    assert n_params == cfg.param_count() + cfg.d_model, (n_params, cfg.param_count())
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), device=DEVICE,
                           generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens}
    prefill_step = make_prefill_step(cfg, shape)
    serve_step = make_serve_step(cfg)
    prefill_step(params, {"tokens": tokens[:, :512]})  # warm-up: cuBLAS set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launches()
    t0 = time.perf_counter()
    last, state = prefill_step(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n_prefill = fa.launches["flash_attention"]
    toks = [last.argmax(-1).to(torch.int32)]
    step_s = []
    for _ in range(LM_NEW):
        t0 = time.perf_counter()
        nxt, state = serve_step(params, state, toks[-1])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        toks.append(nxt)
    n_total = fa.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated()

    assert n_prefill == cfg.n_layers, f"prefill launched flash {n_prefill} times"
    assert n_total == n_prefill, f"decode launched flash {n_total - n_prefill} times"
    assert last.shape == (LM_BATCH, cfg.vocab_size) and torch.isfinite(last).all()
    assert state.pos.tolist() == [LM_PROMPT + LM_NEW] * LM_BATCH
    ring = state.segs[0][0]["0A"]["att"]["k"]
    assert ring.shape == (LM_BATCH, cfg.swa_window, cfg.n_kv_heads, cfg.hd)
    kv_bytes = 2 * cfg.n_layers * ring.numel() * ring.element_size()
    step_ms = statistics.median(step_s) * 1e3
    log(f"[7] LM main path: {LM_ARCH} full width and depth ({n_params / 1e9:.3f} B "
        f"params, bf16, seed 0; init {init_s:.2f} s), {LM_BATCH} prompts x "
        f"{LM_PROMPT} tokens, max_len {shape.seq_len}, then {LM_NEW} greedy steps")
    log(f"    prefill {prefill_s:.3f} s ({LM_BATCH * LM_PROMPT / prefill_s:.0f} "
        f"tokens/s); flash launches: prefill {n_prefill}, decode {n_total - n_prefill}")
    log(f"    decode median {step_ms:.2f} ms/step (min {min(step_s) * 1e3:.2f}, max "
        f"{max(step_s) * 1e3:.2f}), {LM_BATCH / (step_ms / 1e3):.1f} tokens/s at "
        f"batch {LM_BATCH}; ring KV cache {kv_bytes / 1e9:.3f} GB; peak device "
        f"memory {peak / 1e9:.2f} GB; logits finite")
    log(f"    greedy tokens, sequence 0: {[int(t[0]) for t in toks]}")
    profile_device(torch, "one prefill", lambda: prefill_step(params, batch))
    dev_ms = profile_device(torch, "one decode step",
                            lambda: serve_step(params, state, toks[-1]))
    if dev_ms:
        log(f"    decode: device busy {dev_ms:.2f} ms of a {step_ms:.2f} ms median "
            f"step, idle share {1 - dev_ms / step_ms:.3f}")
    return dict(cfg=cfg, shape=shape, params=params, batch=batch, toks=toks,
                launches=n_prefill)


def phase_lm_agreement(torch, lm: dict) -> None:
    """The flash path against the torch ``chunked_attention`` path on the
    same prompts, decode teacher-forced on phase 7's tokens."""
    from repro_torch.models import decode_step, init_params, prefill

    cfg, params, batch, toks = lm["cfg"], lm["params"], lm["batch"], lm["toks"]
    max_len = lm["shape"].seq_len
    ref = cfg.replace(use_flash=False)
    last_f, st_f = prefill(cfg, params, batch, max_len)
    last_r, st_r = prefill(ref, params, batch, max_len)
    errs, same = [rel_err(last_f, last_r)], [bool((last_f.argmax(-1) == last_r.argmax(-1)).all())]
    for t in toks[:-1]:
        lf, st_f = decode_step(cfg, params, t, st_f)
        lr, st_r = decode_step(ref, params, t, st_r)
        assert torch.isfinite(lf).all()
        errs.append(rel_err(lf, lr))
        same.append(bool((lf.argmax(-1) == lr.argmax(-1)).all()))
    worst = max(errs)
    assert worst <= LM_BF16_REL_TOL, errs
    log(f"[8] flash vs torch attention, bf16, 24 layers: max |logit diff| / max "
        f"|logit| {worst:.4f} (tol {LM_BF16_REL_TOL}) over prefill + {len(toks) - 1} "
        f"teacher-forced steps; greedy tokens agree at {sum(same)}/{len(same)} "
        f"positions; per step {[round(e, 4) for e in errs]}")
    del params, lm["params"], st_f, st_r
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(n_layers=2, dtype="float32", param_dtype="float32")
    p32 = init_params(cfg32, seed=0)
    last_f, st_f = prefill(cfg32, p32, batch, max_len)
    last_r, st_r = prefill(cfg32.replace(use_flash=False), p32, batch, max_len)
    errs = [max_abs_err(last_f, last_r)]
    for t in toks[:4]:
        lf, st_f = decode_step(cfg32, p32, t, st_f)
        lr, st_r = decode_step(cfg32.replace(use_flash=False), p32, t, st_r)
        errs.append(max_abs_err(lf, lr))
    assert max(errs) <= LM_F32_ABS_TOL, errs
    log(f"    f32, full width, 2 layers: max |logit diff| {max(errs):.3g} (tol "
        f"{LM_F32_ABS_TOL}; max |logit| {float(last_r.abs().max()):.3f}) over "
        f"prefill + 4 teacher-forced steps")


def valid_pairs(S: int, window: int, B: int, H: int) -> int:
    """(query, key) pairs a causal, windowed prefill of S tokens keeps."""
    per_head = sum(min(i + 1, window) for i in range(S))
    return per_head * B * H


def phase_flash_times(fa, torch, gen, launches: int, err: dict) -> dict:
    import torch.nn.functional as F

    B, S, H, KV, d, W = LM_BATCH, LM_PROMPT, 32, 8, 120, 4096
    q, k, v = flash_inputs(torch, gen, B, S, S, H, KV, d, torch.bfloat16)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True, window=W), reps=10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True, window=W),
                       reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    i = torch.arange(S, device=DEVICE)
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)

    lib_err = max_abs_err(library().transpose(1, 2), fa.flash_attention(
        q, k, v, causal=True, window=W))
    library_ms = cuda_ms(library, reps=5, warmup=1)
    pairs = valid_pairs(S, W, B, H)
    flops = 4 * d * pairs  # q.k and p.v: 2 d multiply-adds per kept pair
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # bf16 q, k, v, out
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    log(f"[9] flash_attention [{B}, {S}, {H}, {d}] / {KV} KV heads, window {W}, bf16: "
        f"kernel {ms:.3f} ms | bound {bound_ms:.4f} ms ({pairs / 1e9:.3f} G kept pairs "
        f"x {4 * d} flop at 989 TFLOP/s; bytes {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) | plain {plain_ms:.3f} ms | "
        f"yardstick F.scaled_dot_product_attention, band mask, enable_gqa (not "
        f"used by the port) {library_ms:.3f} ms, |diff| {lib_err:.3g} | "
        f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s on kept pairs")
    return dict(
        name="flash_attention", route="cuda", source=FLASH_CU,
        replaces="src/repro/kernels/flash_attention/kernel.py:100",
        launches=launches, max_abs_err=err["path"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="operations" if flops / BF16_FLOP_PER_S
        >= nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=library_ms,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import apps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import stencil as ks

    # f32 products in full f32, as the CPU reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"[0] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"numpy {np.__version__} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source
        builds = [pool.submit(mod.load) for mod in (ks, fa)]
        built = [b.result() for b in builds]
    log(f"[1] built {', '.join(b.path.name for b in built)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{', '.join(f'{b.seconds:.2f} s' for b in built)}, in parallel)")
    for b in built:
        for line in b.log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    err = phase_kernels_vs_plain(ks, torch, gen)
    flash_err = phase_flash_vs_plain(fa, torch, gen)
    main_info = phase_main_path(repro_torch, apps, ks)
    phase_paper_regime(repro_torch, apps, ks)
    phase_overlap_probe(repro_torch, apps)
    records = phase_times(ks, torch, gen, main_info, err)
    torch.cuda.empty_cache()
    lm = phase_lm(fa, torch)
    phase_lm_agreement(torch, lm)
    launches = lm["launches"]
    del lm
    torch.cuda.empty_cache()
    records.append(phase_flash_times(fa, torch, gen, launches, flash_err))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
