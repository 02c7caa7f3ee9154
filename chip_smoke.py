#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, each asserted (any failure exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
2. hold every kernel to its plain PyTorch version on the card;
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
6. each kernel's time at the main path's shapes beside its bound, its
   plain version's time and a PyTorch yardstick where one exists.

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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
STENCIL_CU = "src/repro_torch/kernels/stencil/csrc/stencil.cu"
MAIN_N, MAIN_ITERS, MAIN_PROCS, MAIN_BLOCK = 16384, 6, 16, 2048
PAPER_N, PAPER_BLOCK = 4096, 512


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import apps
    from repro_torch.kernels import stencil as ks

    t_start = time.perf_counter()
    card = card_line()
    log(f"[0] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"numpy {np.__version__} | python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = ks.load()
    log(f"[1] built {built.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    err = phase_kernels_vs_plain(ks, torch, gen)
    main_info = phase_main_path(repro_torch, apps, ks)
    phase_paper_regime(repro_torch, apps, ks)
    phase_overlap_probe(repro_torch, apps)
    records = phase_times(ks, torch, gen, main_info, err)
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
