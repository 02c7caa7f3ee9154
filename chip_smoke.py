#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases, each asserted (any failure exits non-zero):

1. build the CUDA kernels and the stream gate from
   ``src/repro_torch/kernels/*/csrc`` into one library
   (``kernels/build.py::kernel_library``: one nvcc a source, each with
   its own flags, all started together, one link; only the stencil
   takes ``--fmad=false``); print ptxas's report of each kernel
   (registers, shared memory, spills), the counts of ``HGMMA`` and
   ``UTMALDG`` instructions in ``flash_attention_wgmma_kernel``'s SASS
   (its bf16 kernel runs on wgmma and TMA), of ``HMMA`` and ``LDGSTS``
   in ``ssd_scan_tc_kernel``'s (mma.sync and cp.async) and of ``HMMA``
   and ``UTMALDG`` in ``wkv6_tc_kernel``'s (mma.sync and TMA), counted
   per function and each asserted above 0, and ptxas's registers and
   spills of ``wkv6_tc_kernel``;
P. the profiler's primed sessions: ``torch.profiler``'s clock check
   (spin kernels held to CUDA events, ``CheckedProfile``) over
   PROBE_SESSIONS sessions with PROFILER_PRIMES primes each, in a fresh
   process per case, after a profiled drain of the runtime, with none
   and with all five of the port's kernels launched in each session;
   asserts every session passed and lost fewer records at its start
   than it had primes; one line a case.  ``python3 chip_smoke.py
   --probe`` runs every case of the probe instead (``PROBE_CASES``: 0,
   1, 2 and 5 kernels, lazy and ``CUDA_MODULE_LOADING=EAGER``, no
   primes, then the primed cases) and nothing else; ``python3
   chip_smoke.py --probe-train [ROUNDS]`` profiles one full-size train
   step of phase T in ROUNDS pairs of sessions, without and with the
   host's settle wait (``PROFILER_SETTLE_S``), and nothing else;
2. hold every kernel to its plain PyTorch version on the card (the
   stencil kernels, ``torch.equal``: ``stencil5_group`` on strided
   slivers, the shared-memory route, an aliased output and a group over
   two launches; then flash attention in f32 and bf16 over head dims
   80, 120 and 128, ragged lengths, GQA, windows, a short ``sk_valid``,
   h2o-danube's path shape in f32 and bf16 and zamba2's in bf16; each
   launch asserted on its dtype's kernel: bf16 on wgmma, f32 on FMA);
3. the main path: the paper's flagship Jacobi stencil through
   ``repro_torch.runtime`` (async executor, torch backend, fusion on,
   blocks on the GPU) at 16384², 6 sweeps, 16 processes, 2048² blocks,
   then its compiled-sweep check (whole-grid ``jacobi_sweep``); both
   must equal a sequential host-NumPy float64 stencil bit for bit, and
   every kernel of the path must have been launched, the stencil kernel
   fewer times than it computed fragments, with no copy after one.
   Prints the drain's device-timed ``compute_busy`` (gated event pairs),
   ``host_busy``, the device busy share, a makespan that ends at device
   completion and ``wait_fraction``; then runs it once more under
   ``torch.profiler`` for the device time of its kernels and copies (the
   gate kernels apart) and asserts the pairs' sum within 1.5 x that plus
   5 us a pair; prints the pairs, ``gate_timeouts`` (each timeout named
   with its payload's kind and cause) and the longest a payload held the
   gate;
4. the paper's own regime (4096², 512² blocks, 16 processes) under
   ``sync="demand"`` and ``sync="barrier"``;
5. the overlap probe of examples/stencil_latency_hiding.py (256², 8
   workers, 10 ms injected latency) on the async and blocking channels;
S. the serving path: ``repro_torch.Server`` on the card at the paper's
   regime (16 processes, 512² blocks, flush, channel async, sync
   demand), 8 closed-loop tenant threads with a 4098² f64 grid each,
   1 request a tenant (scatter the grid, 2 sweeps, gather it back),
   serialised (``max_inflight=1``) and concurrent (``max_inflight=8``):
   every result equal to host NumPy and to a barrier-flush run bit for
   bit, every fused map on ``stencil5_group`` (fewer launches than
   fragments), admitted + rejected = submitted with 0 rejected,
   ``gate_timeouts`` 0; prints requests/s, latency quantiles, makespan,
   ``wait_fraction``, device busy share, ``host_busy`` and peak memory;
   then the concurrent variant under ``torch.profiler``, its gated pairs
   within 1.5 x the kernels and copies + 5 us a pair;
V. verification and the trace: the paper-regime stencil (6 sweeps)
   with ``verify="full"``, the plan cache and a trace export path:
   equal to host NumPy, 0 diagnostics over verified flushes, the cached
   plans re-verified clean, ``validate_trace`` accepting the file,
   ``attribution``'s ``wait_fraction`` within 0.02 of the device-timed
   ``WaitStats`` and its compute the gated pairs' own; the fig. 6
   rendezvous schedule rejected before any thread starts;
6. each stencil kernel's time at the main path's shapes beside its
   bound, its plain version's time and a PyTorch yardstick where one
   exists: ``stencil5_block`` on the interior fragment as the runtime
   passes it (five shifts of one 2048² block, written into a block
   slice) and on one whole sweep's 576 fragments, each beside the
   distinct-bytes bound and the five-operand bound;
C. the paper's collectives (``repro_torch.comm``) on an NCCL group of
   one rank on the card (one card gives NCCL one rank; the group must
   start on NCCL, nothing falls back): ``jacobi_step_sharded`` on the
   main path's 16386² f64 grid in both overlap modes, bit for bit the
   CUDA ``jacobi_sweep`` and one host-NumPy sweep, with each ring hop's
   post / compute / wait events printed and its time by CUDA events
   beside the kernel's; ``ag_matmul`` and ``matmul_rs`` at h2o-danube's
   MLP projection (x [8192, 3840] x w [3840, 10240] bf16) in both modes,
   bit for bit ``torch.matmul``; ``ring_all_gather``,
   ``ring_reduce_scatter``, ``halo_exchange`` (periodic and not) and
   ``stencil_1d_sharded`` on the grid's rows against plain slicing;
7. the LM path: h2o-danube-3-4b at full width and depth (24 layers,
   d_model 3840, 32/8 heads of 120, window 4096, bf16, random weights
   from seed 0) serving two prompts of 8192 seeded tokens —
   ``make_prefill_step`` then 16 greedy ``make_serve_step`` steps — with
   exactly one flash launch per layer in prefill, every one on the wgmma
   kernel, and none in decode;
8. the per-layer check: each block fed the bf16 twin's activation, its
   update y - x with the kernels and with the twin against the block in
   f32 (``layer_update_errors``), the kernels within max(2^-6, 1.5 x the
   twin) on every block; then the same prompts through the torch twins
   of the kernels (``use_flash=False``), teacher-forced on the tokens of
   phase 7, in bf16 at full depth and in f32 at full width with 2 layers;
9. zamba2-2.7b served the same way (54 layers ``MMMMMH`` x 9, d_model
   2560, 80 SSM heads of 64, state 64, the shared MHA block 32 x 80,
   d_ff 10240, vocab 32000, tied embeddings): exactly 54 SSD scan
   launches (all 54 on the tensor-core kernel) and 9 flash launches (all
   9 on wgmma) in prefill, none in decode;
10. zamba2's kernels against its torch twins, as phase 8 (f32: the 6
    layers ``MMMMMH``);
11. rwkv6-3b served the same way (32 layers, d_model 2560, 40 heads of
    64, d_ff 8960, vocab 65536, untied): exactly 32 wkv launches in
    prefill (all 32 on the tensor-core kernel), none in decode;
12. rwkv6's kernel against its torch twin, as phase 8 (f32: 2 layers);
13. the bf16 flash kernel's time at both of its path shapes beside its
    bound and its plain version's time, with
    ``F.scaled_dot_product_attention`` as a yardstick (which the port
    never calls): with a band mask and ``enable_gqa`` at h2o-danube's
    shape, with ``is_causal=True`` at zamba2's;
14. the SSD scan (bf16: the tensor-core kernel, with ptxas's registers
    and spills) and wkv kernels' times at their paths' shapes beside
    their bounds and their plain versions' times, wkv on both routes
    (bf16: the tensor-core kernel, f32: the FMA kernel);
15. deepseek-v2-lite-16b served the same way at full width and depth
    (27 layers ``D`` + ``E`` x 26, d_model 2048, MLA with r 512 and
    16 heads of 128 + 64 rotary, 64 experts top-6 of width 1408 and 2
    shared, vocab 102400; 2 prompts x 2048 tokens): 0 flash launches
    (MLA runs the torch route, as the JAX package does: its prefill the
    absorbed latent form in f32); then the per-layer check with each
    block's prefill route (a fresh decode state) against the block in
    f32, the cache-free route as the twin, printing per ``E`` block the
    (token, choice) pairs routed differently in bf16 and in f32;
16. grok-1-314b at full width with its depth cut from 64 layers to 4
    (d_model 6144, 48/8 heads of 128, 8 experts top-2 of width 32768,
    vocab 131072 untied; 2 x 2048): exactly 4 flash launches, on wgmma
    at d 128 and GQA 6:1; the per-layer check and the agreement of
    phases 8-12 (the f32 yardstick upcast block by block, ``Upcast``);
17. whisper-small at full size (12 encoder + 12 decoder layers, d_model
    768, 12 heads of 64, 1500 frames a sequence, 2 x 448 decoder
    tokens): exactly 36 flash launches, 12 non-causal in the encoder, 12
    causal in the decoder, 12 non-causal cross-attentions of 448 queries
    over 1500 keys; the per-layer check (encoder blocks first) and the
    agreement;
18. internvl2-2b at full size (24 layers, 16/8 heads of 128, a 256-
    embedding image prefix before 2 x 2048 tokens): exactly 24 flash
    launches; the per-layer check and the agreement;
19. the bf16 flash kernel's time at the four new shapes (grok's,
    internvl2's, whisper's encoder and cross-attention) beside its
    bound, its plain version and SDPA, as phase 13;
T. training: h2o-danube-3-4b at full width and depth (bf16 weights, f32
   AdamW moments, remat, 1 microbatch), ``make_train_step`` on
   ``TokenPipeline`` batches of 2 x 4096 tokens from seed 0 (train_4k's
   global batch of 256 cut to 2), a warm-up step and 4 timed steps
   (loss, ``grad_norm``, lr, time, tokens/s and
   ``train_model_flops_share`` = 6 N tokens / step time / 989 TFLOP/s
   each), peak memory, one more step under the checked profiler, no
   kernel launched (the torch twins under autograd, as the reference
   trains through its jnp twins); (a) the same step in bf16 and in f32
   at 2 layers of full width on the same batch and weights: loss within
   1e-2 relative, ``grad_norm`` within 5e-2, every gradient leaf's
   cosine >= 0.99; (b) at the reduced size, the state saved after step 2
   restored into a fresh model and optimizer bit for bit, and step 3
   from it within the distance of two uninterrupted step 3s;
D. the dry-run against the card: ``repro_torch.roofline.analyze_step``
   of h2o-danube's prefill at phase 7's 2 x 8192 and of its train step
   at phase T's 2 x 4096 on fake tensors, each counted peak of live
   bytes within 20% of the ``max_memory_allocated`` that phase measured,
   printed beside it with the counted FLOPs beside ``model_flops`` and
   the roofline terms (``roofline.HW``) beside the measured times.

Every ``torch.profiler`` session of the run (phases 3 and S, the LM
phases' prefill and decode, the train step) must pass its clock check.

Phases 7-18 free each model before the next and print their peak
device memory.  In an MoE model a near-tie between experts can route a
token differently on two runs (bf16 against f32, or the kernels against
the twins): the checks measure each route on the token rows routed as
in the run it is held to, and count and print the rest (at most 1/4 of
a block's rows in the per-layer check, 1/2 of the logits rows).

Phase 2 also holds the SSD scan and wkv kernels to their plain versions
(f32 and the paths' bf16/f32 mix; ragged lengths, initial states,
several heads, and each path's own shape; for wkv also a strong-decay
draw with some w = 0, and a bf16 y within ``bf16_rel_err`` 2^-6 of the
plain version in f32), each launch asserted on its dtype's kernel: bf16
on the tensor-core kernel, f32 on FMA.

The third-to-last line of output is the JSON ``kernels`` record, the
second-to-last the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when no GPU is visible or the port is missing.
"""
from __future__ import annotations

import functools
import json
import operator
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.roofline import HW  # noqa: E402

DEVICE = "cuda"
HBM_BYTES_PER_S = HW.hbm_bw  # H100 SXM, NVIDIA data sheet (repro_torch.roofline.HW)
BF16_FLOP_PER_S = HW.peak_flops  # dense bf16 tensor cores, NVIDIA data sheet
STENCIL_CU = "src/repro_torch/kernels/stencil/csrc/stencil.cu"
FLASH_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_CU = "src/repro_torch/kernels/mamba2_scan/csrc/ssd_scan.cu"
WKV_CU = "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv6.cu"
MAIN_N, MAIN_ITERS, MAIN_PROCS, MAIN_BLOCK = 16384, 6, 16, 2048
PAPER_N, PAPER_BLOCK = 4096, 512
# phase S: closed-loop tenants of a Server at the paper's regime, each
# with its own grid (tenant i's edge is 1 + i); a request scatters the
# tenant's grid, records SERVE_SWEEPS sweeps and gathers the grid back.
# One request a tenant: at two, the phase took ~120 s of the run's time
SERVE_TENANTS, SERVE_REQUESTS, SERVE_SWEEPS = 8, 1, 2
# phase V: attribution's wait_fraction against the device-timed one
ATTRIBUTION_TOL = 0.02
# the LM paths: SHAPES["prefill_32k"] (32 x 32768) cut to 2 x 8192 (for
# h2o-danube, twice the 4096 window, so the window mask and the ring
# cache both run), then 16 greedy steps; each model at its published
# width and depth, as its config (and the kernels' launches per prefill)
LM_BATCH, LM_PROMPT, LM_NEW = 2, 8192, 16
DANUBE = ("h2o-danube-3-4b", dict(n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
                                  hd=120, swa_window=4096, d_ff=10240, vocab_size=32000))
ZAMBA = ("zamba2-2.7b", dict(n_layers=54, layer_pattern="MMMMMH" * 9, d_model=2560,
                             ssm_expand=2, ssm_head_dim=64, ssm_state=64, n_heads=32,
                             n_kv_heads=32, hd=80, swa_window=None, d_ff=10240,
                             vocab_size=32000, tie_embeddings=True))
RWKV = ("rwkv6-3b", dict(n_layers=32, layer_pattern="R", d_model=2560,
                         rwkv_head_size=64, d_ff=8960, vocab_size=65536,
                         tie_embeddings=False))
# the four families of phases 15-18, each at its published width: prompts
# of FAMILY_PROMPT tokens (whisper: its published decoder context of 448,
# beside 1500 encoder frames; internvl2: after a 256-embedding image
# prefix), then LM_NEW greedy steps.  deepseek-v2-lite at full depth
# (~31.4 GB in bf16); grok-1 cut from 64 layers to GROK_LAYERS (its full
# depth needs ~628 GB in bf16; 4 layers and the untied embeddings take
# ~42.6 GB); whisper-small and internvl2-2b at full depth
FAMILY_PROMPT, WHISPER_PROMPT, GROK_LAYERS = 2048, 448, 4
DEEPSEEK = ("deepseek-v2-lite-16b", dict(
    n_layers=27, layer_pattern="D" + "E" * 26, d_model=2048, n_heads=16, attn_impl="mla",
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    d_ff=10944, n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    vocab_size=102400))
GROK = ("grok-1-314b", dict(n_layers=GROK_LAYERS, layer_pattern="E", d_model=6144,
                            n_heads=48, n_kv_heads=8, hd=128, n_experts=8, top_k=2,
                            moe_d_ff=32768, vocab_size=131072, tie_embeddings=False))
WHISPER = ("whisper-small", dict(n_layers=12, n_enc_layers=12, enc_dec=True, d_model=768,
                                 n_heads=12, n_kv_heads=12, hd=64, enc_seq=1500, d_ff=3072,
                                 act="gelu", vocab_size=51865, tie_embeddings=True))
INTERNVL = ("internvl2-2b", dict(n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
                                 hd=128, n_img_tokens=256, d_ff=8192, vocab_size=92553,
                                 tie_embeddings=True))
# an MoE model's checks leave out the rows whose kept experts differ
# between the runs compared (near-ties flipped by rounding), count them
# and print them.  The per-layer check (4096 token rows a block) leaves
# out at most MOE_FLIP_SHARE of a block's rows: about 4x the largest
# share seen on the H100 (deepseek-v2-lite 87 of 4096 rows, 2.1%;
# grok-1 28, 0.7%; PERF.md).  The logits comparison (2 rows a step, 17
# steps) keeps at least one row of every step and leaves out at most
# MOE_LOGIT_FLIP_SHARE of all rows: about 4x what grok-1's per-layer
# share predicts for a row through its 4 layers (~2.7%; none seen).
MOE_FLIP_SHARE, MOE_LOGIT_FLIP_SHARE = 0.08, 0.125
# the recurrent kernels at their paths' shapes: x [b, s, h, p] with state
# n, and r/k/v/w [B, T, H, N]
SSD_PATH = (LM_BATCH, LM_PROMPT, 80, 64, 64)
WKV_PATH = (LM_BATCH, LM_PROMPT, 40, 64)
# tests/test_kernels.py's f32 tolerances; a bf16 output (the kernel and
# its plain version both sum in f32 and round once) may differ by one
# bf16 ulp of the largest output, 2^-7 of it
SSD_TOL, WKV_TOL, BF16_REL = 2e-3, 1e-3, 2.0 ** -7
SSD_ROUTE = {"float32": "ssd_scan_simt", "bfloat16": "ssd_scan_tc"}
WKV_ROUTE = {"float32": "wkv6_simt", "bfloat16": "wkv6_tc"}
# the main path's event pairs against the profiler's kernel-and-copy time
# of the same run: at most this factor, plus this much a pair (the
# device's own gaps between a payload's kernels and around its events)
PAIR_FACTOR, PAIR_SLACK_S = 1.5, 5e-6
# (b, s, h, p, n, with_state): tests/test_kernels.py's shapes, then a
# ragged s and p, an n that is no multiple of 8, the largest n and one token
SSD_CASES = [
    (2, 64, 3, 16, 8, False), (1, 100, 2, 32, 16, True), (1, 256, 1, 64, 64, True),
    (2, 333, 5, 20, 40, True), (1, 70, 2, 64, 128, True), (1, 1, 1, 1, 1, False),
]
# (B, T, H, N, with_state): tests/test_kernels.py's shapes, then a head
# size that is no multiple of 32 (two column groups, one ragged), a small
# one and one token
WKV_CASES = [
    (2, 64, 3, 16, False), (1, 100, 2, 32, True), (1, 128, 2, 64, True),
    (2, 333, 3, 40, True), (1, 33, 1, 8, True), (1, 1, 1, 1, False),
]
# tests/test_kernels.py's; bf16 is held besides to fa.BF16_REL_TOL in
# fa.bf16_rel_err against the plain version in f32 on the same bf16 values
FLASH_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
FLASH_ROUTE = {"float32": "flash_attention_simt", "bfloat16": "flash_attention_wgmma"}
# the flash kernel's path shapes: (B, Sq, Sk, H, KV, d, causal, window);
# the first two time in phase 13, the rest in phase 19
FLASH_PATHS = {
    "danube": (LM_BATCH, LM_PROMPT, LM_PROMPT, 32, 8, 120, True, 4096),
    "zamba2": (LM_BATCH, LM_PROMPT, LM_PROMPT, 32, 32, 80, True, None),
    "grok": (LM_BATCH, FAMILY_PROMPT, FAMILY_PROMPT, 48, 8, 128, True, None),
    "internvl2": (LM_BATCH, 256 + FAMILY_PROMPT, 256 + FAMILY_PROMPT, 16, 8, 128, True, None),
    "whisper_enc": (LM_BATCH, 1500, 1500, 12, 12, 64, False, None),
    "whisper_cross": (LM_BATCH, WHISPER_PROMPT, 1500, 12, 12, 64, False, None),
}
# kernels vs torch twins through the whole model: bf16 at full depth,
# max |logit difference| over the max |logit|; f32 at a few layers, absolute.
# A model with random weights may amplify bf16 rounding past 5e-2 over
# its depth (rwkv6 at d_model 256, on the CPU: a 1e-3 relative change of
# the embeddings moves the residual stream by 0.9 of its size within 9
# layers); there the bf16 bound is LM_NOISE_FACTOR times the twins' own
# distance from the f32 twins
LM_BF16_REL_TOL, LM_F32_ABS_TOL, LM_NOISE_FACTOR = 5e-2, 5e-4, 1.5
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


def ptxas_report(log: str, kernel: str) -> list:
    """(entry, registers, spill stores, spill loads) of every entry
    function whose mangled name contains ``kernel``, from nvcc's
    ``-Xptxas=-v`` output."""
    import re

    out, entry, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1) if kernel in m.group(1) else None
        elif entry and "spill stores" in line:
            spills = tuple(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif entry and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((entry, regs, *spills))
            entry = None
    return out


def sass_counts(lib: Path, opcodes: tuple, function: str) -> dict:
    """How many instructions of each opcode the SASS of the library's
    functions whose symbol contains ``function`` holds: the sections that
    ``cuobjdump -sass`` heads ``Function : <symbol>``, all instances of a
    template summed."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    counts, inside, n_functions = dict.fromkeys(opcodes, 0), False, 0
    for line in out.splitlines():
        if "Function : " in line:
            inside = function in line.split("Function : ", 1)[1]
            n_functions += inside
        elif inside:
            for op in opcodes:
                counts[op] += op in line
    assert n_functions > 0, f"no function {function} in {lib.name}'s SASS"
    return counts


def numpy_grid(n: int, edge: float = 1.0) -> np.ndarray:
    """The fig. 10 program's starting grid: zeros, its first row and
    column ``edge``."""
    full = np.zeros((n + 2, n + 2))
    full[0, :] = edge
    full[:, 0] = edge
    return full


def numpy_sweeps(full: np.ndarray, iters: int) -> np.ndarray:
    """``iters`` sweeps of the fig. 10 program over ``full``, in place,
    sequential, on the host in float64."""
    for _ in range(iters):
        acc = full[1:-1, 1:-1] + full[0:-2, 1:-1]
        acc += full[2:, 1:-1]
        acc += full[1:-1, 0:-2]
        acc += full[1:-1, 2:]
        full[1:-1, 1:-1] = 0.2 * acc
    return full


def numpy_stencil(n: int, iters: int) -> np.ndarray:
    """The paper's fig. 10 program, sequential, on the host in float64."""
    return numpy_sweeps(numpy_grid(n), iters)


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


def cuda_ms_alternating(fns, reps: int = 10, warmup: int = 2) -> list:
    """Median device times of each of ``fns``, timed in turn within each
    of ``reps`` rounds, so that a drift of the card's clocks over the run
    falls on all of them alike."""
    import torch

    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
    return [statistics.median(ts) for ts in times]


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def plus_views(blk, rows: int, cols: int, c0: int = 1) -> tuple:
    """The five operands of an interior fragment as the runtime passes
    them: the centre of ``blk`` (rows from 1, columns from ``c0``) and its
    shifts by one row up and down and one column left and right."""
    r, c = slice(1, rows + 1), slice(c0, c0 + cols)
    return (blk[r, c], blk[0:rows, c], blk[2:rows + 2, c],
            blk[r, c0 - 1:c0 - 1 + cols], blk[r, c0 + 1:c0 + 1 + cols])


def stencil_group_cases(torch, gen, dtype) -> list:
    """(name, fragments) of stencil5_group on the card: strided slivers
    and fragments, the shared-memory route (shifts of one block at each
    16-byte phase, and an odd row stride), an output that is one of its
    operands (staged), and more fragments than one launch holds."""
    def rnd(*shape):
        return torch.randn(*shape, dtype=dtype, device=DEVICE, generator=gen)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype, device=DEVICE)

    mixed = []
    for rows, cols in ((1, 1), (1, 2046), (2046, 1), (500, 37), (1, 1), (2046, 2046)):
        xs = tuple(rnd(rows + 2, 2 * cols + 3)[1:rows + 1, 1:2 * cols + 1:2] for _ in range(5))
        mixed.append((xs, zeros(rows + 3, 3 * cols + 4)[2:rows + 2, 1::3][:, :cols]))
    shared = []
    for n, c0 in ((2048, 1), (516, 2), (516, 3), (516, 4), (301, 1)):
        shared.append((plus_views(rnd(n, n), n - 2, n - 1 - c0, c0),
                       zeros(n, n)[1:n - 1, c0:n - 1]))
    blk = rnd(600, 700)
    return [("mixed strided", mixed), ("shared route", shared),
            ("aliased output", [(plus_views(blk, 598, 698), blk[1:599, 1:699])]),
            ("two launches", [(tuple(rnd(3, 5) for _ in range(5)), zeros(3, 5))
                              for _ in range(300)])]


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
        for name, frags in stencil_group_cases(torch, gen, dtype):
            want = [ks.stencil5_block_plain(*xs, weight=0.2) for xs, _ in frags]
            before, staged = ks.launches["stencil5_block"], sum(ks.staged_copies.values())
            ks.stencil5_group(frags, weight=0.2)
            torch.cuda.synchronize()
            for (_, out), w in zip(frags, want):
                assert torch.equal(out, w), (dtype, name)
            assert ks.launches["stencil5_block"] - before == -(-len(frags) // ks.GROUP_MAX_FRAGS)
            assert sum(ks.staged_copies.values()) - staged == (name == "aliased output")
            del frags, want
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
    log(f"[2] kernels == plain versions on the card (stencil5_block f64/f32 512², "
        f"2048², 500x37 strided: torch.equal; stencil5_group f64/f32, torch.equal: "
        f"strided slivers and fragments with strided outputs, the shared-memory route "
        f"on shifts of one block (2048², 516² at 3 more centre columns, an odd row "
        f"stride), an "
        f"aliased output staged, 300 fragments over 2 launches; "
        f"jacobi 4098², 1000x777, 4 sweeps: f64 equal, f32 atol 1e-6); "
        f"max |err| {err}")
    return err


def flash_inputs(torch, gen, B, Sq, Sk, H, KV, d, dtype):
    q = torch.randn(B, Sq, H, d, device=DEVICE, generator=gen).to(dtype)
    k = torch.randn(B, Sk, KV, d, device=DEVICE, generator=gen).to(dtype)
    v = torch.randn(B, Sk, KV, d, device=DEVICE, generator=gen).to(dtype)
    return q, k, v


def phase_flash_vs_plain(fa, torch, gen) -> dict:
    """The flash kernels against their plain version: the case table in
    f32 (FMA kernel) and bf16 (wgmma kernel), then the LM paths' shapes.
    Asserts each launch on its dtype's kernel, and each bf16 output also
    within ``fa.BF16_REL_TOL`` of the plain version in f32 by
    ``fa.bf16_rel_err``.  Returns the largest |kernel - plain| per dtype
    and at each path's shape, and the largest relative errors
    (``bf16_rel``, ``<path>_rel``)."""
    err = {"float32": 0.0, "bfloat16": 0.0, "bf16_rel": 0.0}

    def run(name, q, k, v, **kw):
        before = dict(fa.launches)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        route = FLASH_ROUTE[name]
        assert fa.launches[route] == before[route] + 1, (name, "not on", route)
        assert fa.launches["flash_attention"] == before["flash_attention"] + 1
        assert got.dtype == q.dtype
        e = max_abs_err(got, want)
        assert e < FLASH_TOL[name], (name, q.shape, kw, e)
        if name == "float32":
            return e, 0.0
        del want
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        rel = fa.bf16_rel_err(got, want)
        assert rel <= fa.BF16_REL_TOL, (name, q.shape, kw, rel)
        return e, rel

    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        for B, Sq, Sk, H, KV, d, causal, window, sk_valid in FLASH_CASES:
            q, k, v = flash_inputs(torch, gen, B, Sq, Sk, H, KV, d, dtype)
            e, rel = run(name, q, k, v, causal=causal, window=window, sk_valid=sk_valid)
            err[name] = max(err[name], e)
            err["bf16_rel"] = max(err["bf16_rel"], rel)
    # the LM paths' shapes: h2o-danube's in f32 (the tight check: the FMA
    # kernel accumulates in f32) and in bf16 (the path's own dtype, on the
    # wgmma kernel), the others in bf16
    for name, key, path in (("float32", "path_f32", "danube"),
                            *(("bfloat16", path, path) for path in FLASH_PATHS)):
        B, Sq, Sk, H, KV, d, causal, W = FLASH_PATHS[path]
        q, k, v = flash_inputs(torch, gen, B, Sq, Sk, H, KV, d, getattr(torch, name))
        err[key], err[f"{key}_rel"] = run(name, q, k, v, causal=causal, window=W)
        del q, k, v
        torch.cuda.empty_cache()
    log(f"[2] flash_attention == plain version on the card ({len(FLASH_CASES)} "
        f"cases: d 64/80/120/128, ragged, cross-length, GQA, windows, sk_valid; "
        f"f32 tol {FLASH_TOL['float32']} on the FMA kernel, bf16 tol "
        f"{FLASH_TOL['bfloat16']} and bf16_rel_err <= {fa.BF16_REL_TOL} against the "
        f"plain version in f32 on the wgmma kernel; and the LM paths' shapes: "
        f"h2o-danube [{LM_BATCH}, {LM_PROMPT}, 32, 120] / 8 KV heads, window 4096, "
        f"in f32 and bf16, the others in bf16: {FLASH_PATHS}); max |err| f32 "
        f"{err['float32']:.3g}, bf16 {err['bfloat16']:.3g}, danube f32 "
        f"{err['path_f32']:.3g}, "
        + ", ".join(f"{path} bf16 {err[path]:.3g}" for path in FLASH_PATHS)
        + f"; bf16_rel_err cases {err['bf16_rel']:.4g}, "
        + ", ".join(f"{path} {err[path + '_rel']:.4g}" for path in FLASH_PATHS)
        + f" (tol {fa.BF16_REL_TOL})")
    return err


def ssd_inputs(torch, gen, b, s, h, p, n, dtype, with_state=True):
    """x, dt = softplus(N(0, 1)), A = -exp(N(0, 1/4)), B, C and an initial
    state, drawn as tests/test_kernels.py draws them; x, B, C in ``dtype``,
    the rest f32."""
    f = lambda *shape: torch.randn(*shape, device=DEVICE, generator=gen)
    x, dt = f(b, s, h, p).to(dtype), torch.nn.functional.softplus(f(b, s, h))
    A = -torch.exp(f(h) * 0.5)
    B, C = f(b, s, n).to(dtype), f(b, s, n).to(dtype)
    s0 = f(b, h, p, n) if with_state else None
    return x, dt, A, B, C, s0


def wkv_inputs(torch, gen, B, T, H, N, dtype, with_state=True, strong=False):
    """r, k, v in ``dtype``; the decay w = 0.4 + 0.55 sigmoid(N(0, 1)), the
    bonus u and an initial state in f32, as tests/test_kernels.py draws
    them; with ``strong``, w = exp(-exp(x)), x ~ N(1.5, 1), and 2% of w
    exactly 0."""
    f = lambda *shape: torch.randn(*shape, device=DEVICE, generator=gen)
    r, k, v = (f(B, T, H, N).to(dtype) for _ in range(3))
    if strong:
        w = torch.exp(-torch.exp(f(B, T, H, N) + 1.5))
        w = torch.where(torch.rand(w.shape, device=DEVICE, generator=gen) < 0.02, 0.0, w)
    else:
        w = torch.sigmoid(f(B, T, H, N)) * 0.55 + 0.4
    u = f(H, N)
    s0 = f(B, H, N, N) if with_state else None
    return r, k, v, w, u, s0


def recurrent_err(name, got, want, tol) -> float:
    """|kernel - plain| of (y, final state), asserted: the f32 state to
    ``tol``, y to ``tol`` in f32 and to one bf16 ulp of its largest value
    in bf16.  Returns the larger error."""
    (y, fin), (y_ref, fin_ref) = got, want
    e_y, e_f = max_abs_err(y, y_ref), max_abs_err(fin, fin_ref)
    tol_y = tol if y.element_size() == 4 else BF16_REL * float(y_ref.double().abs().max())
    assert y.dtype == y_ref.dtype and fin.dtype == fin_ref.dtype
    assert e_y <= tol_y and e_f <= tol, (name, y.dtype, e_y, tol_y, e_f)
    return max(e_y, e_f)


def phase_recurrent_vs_plain(ssd, wkv, fa, torch, gen) -> dict:
    """The SSD scan and wkv kernels against their plain versions: the case
    tables, then each path's own shape, in f32 and in the path's dtypes
    (bf16 activations with f32 dt, decay and states); wkv also on a
    strong-decay draw with some w = 0, and a bf16 y also within
    ``fa.BF16_REL_TOL`` of the plain version in f32 by ``fa.bf16_rel_err``.
    Returns the largest |kernel - plain| per kernel and dtype, and the
    largest wkv bf16 relative error (``("wkv6", "bf16_rel")``)."""
    err = {("wkv6", "bf16_rel"): 0.0}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        route = SSD_ROUTE[name]
        e = 0.0
        for b, s, h, p, n, with_state in SSD_CASES + [(*SSD_PATH, True)]:
            ins = ssd_inputs(torch, gen, b, s, h, p, n, dtype, with_state)
            before = dict(ssd.launches)
            got = ssd.ssd_scan(*ins)
            want = ssd.ssd_scan_plain(*ins)
            torch.cuda.synchronize()
            assert ssd.launches[route] == before[route] + 1, (name, "not on", route)
            assert ssd.launches["ssd_scan"] == before["ssd_scan"] + 1
            e = max(e, recurrent_err(("ssd_scan", b, s, h, p, n), got, want, SSD_TOL))
            del ins, got, want
        err[("ssd_scan", name)] = e
        e = 0.0
        route = WKV_ROUTE[name]
        for strong in (False, True):
            for B, T, H, N, with_state in WKV_CASES + [(*WKV_PATH, True)]:
                ins = wkv_inputs(torch, gen, B, T, H, N, dtype, with_state, strong)
                before = dict(wkv.launches)
                got = wkv.wkv6(*ins)
                want = wkv.wkv6_plain(*ins)
                torch.cuda.synchronize()
                assert wkv.launches[route] == before[route] + 1, (name, "not on", route)
                assert wkv.launches["wkv6"] == before["wkv6"] + 1
                e = max(e, recurrent_err(("wkv6", B, T, H, N, strong), got, want, WKV_TOL))
                if name == "bfloat16":
                    r, k, v, *rest = ins
                    want = wkv.wkv6_plain(r.float(), k.float(), v.float(), *rest)[0]
                    rel = fa.bf16_rel_err(got[0], want)
                    assert rel <= fa.BF16_REL_TOL, (B, T, H, N, strong, rel)
                    err[("wkv6", "bf16_rel")] = max(err[("wkv6", "bf16_rel")], rel)
                del ins, got, want
        err[("wkv6", name)] = e
    log(f"[2] ssd_scan and wkv6 == plain versions on the card ({len(SSD_CASES)} + "
        f"{len(WKV_CASES)} cases: ragged lengths, initial states, several heads, "
        f"n 1..128, N 1..64; then the paths' shapes, SSD {list(SSD_PATH)} and wkv "
        f"{list(WKV_PATH)}, with initial states; wkv on the path's decay draw and "
        f"on a strong-decay draw with 2% of w = 0; f32 tol {SSD_TOL} / {WKV_TOL}, "
        f"bf16 y within one bf16 ulp of its largest value, wkv bf16 y within "
        f"bf16_rel_err {fa.BF16_REL_TOL} of the plain version in f32; bf16 on the "
        f"tensor-core kernels, f32 on FMA); max |err| "
        f"{ {f'{k[0]} {k[1]}': f'{v:.3g}' for k, v in err.items()} }")
    return err


def run_stencil(repro_torch, apps, n, iters, nprocs, block, profile=False, **policy_kw):
    """The flagship through the port's runtime; returns (result, stats,
    timings, peak device bytes).  ``timings`` holds the device clock's
    ``timeout_log`` and ``max_hold_s``; with ``profile``, also
    ``kernel_s``: the device time of every kernel and copy that ran from
    the start of recording to the end of the drain but the stream gates,
    whose time (``gate_s``) is the device waiting on the host, from
    ``torch.profiler`` (CUDA activity only)."""
    import contextlib

    import torch

    from repro_torch.api import ExecutionPolicy, RuntimeConfig

    cfg = RuntimeConfig(nprocs=nprocs, block_size=block, fusion=True,
                        device=DEVICE)
    policy = ExecutionPolicy(flush="async", channel="async", backend="torch",
                             **policy_kw)
    torch.cuda.reset_peak_memory_stats()
    window = (CheckedProfile(torch, "the main path's profiled run") if profile
              else contextlib.nullcontext())
    with repro_torch.runtime(cfg, policy) as rt:
        with window:
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
        clock = rt._exec_executor_obj._clock
        times = dict(record_s=t1 - t0, drain_s=t2 - t1, gather_s=t3 - t2,
                     timeout_log=list(clock.timeout_log), max_hold_s=clock.max_hold_s)
    if profile and window.ok:
        us = {"kernel_s": 0.0, "gate_s": 0.0}
        for key, (t, _) in window.rows().items():
            us["gate_s" if "gate_wait" in key else "kernel_s"] += t
        times.update({k: v / 1e6 for k, v in us.items()})
    return result, stats, times, torch.cuda.max_memory_allocated()


def thread_time_step() -> float:
    """The smallest step of ``time.thread_time()`` seen while spinning:
    the granularity of the host_busy readings on this machine."""
    steps = []
    t = time.thread_time()
    while len(steps) < 5:
        u = time.thread_time()
        if u != t:
            steps.append(u - t)
            t = u
    return min(steps)


def log_gate(st, times, pairs: int) -> None:
    """The stream gates of one run: pairs, timeouts (each named with its
    payload's kind and cause) and the longest a payload held its gate."""
    from repro_torch.exec.backend import _DeviceClock

    log(f"    gated event pairs {pairs}, gate_timeouts {st.gate_timeouts}, longest a "
        f"payload held its gate {times['max_hold_s'] * 1e3:.3f} ms (limit "
        f"{_DeviceClock.GATE_TIMEOUT_S * 1e3:.0f} ms)")
    for kind, cause, held in times["timeout_log"]:
        log(f"    gate timeout: {kind}: {cause} (held {held * 1e3:.3f} ms)")
    assert len(times["timeout_log"]) == st.gate_timeouts


def phase_main_path(repro_torch, apps, ks) -> dict:
    """The flagship through the runtime with every kernel launch counted
    from 0, then once more under torch.profiler for the device's own
    busy time, which the gated event pairs must match."""
    import torch

    from repro_torch.kernels import stream_gate

    ks.reset_launches()
    stream_gate.reset_launches()
    result, st, times, peak = run_stencil(
        repro_torch, apps, MAIN_N, MAIN_ITERS, MAIN_PROCS, MAIN_BLOCK
    )
    pairs = stream_gate.launches["gate_wait"]
    t0 = time.perf_counter()
    swept = apps.jacobi_sweeps(MAIN_N, MAIN_ITERS, device=DEVICE)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    swept = swept.cpu().numpy()
    launches = dict(ks.launches)
    frags = dict(ks.fragment_shapes)
    sizes = dict(sorted(ks.group_sizes.items()))
    staged = sum(ks.staged_copies.values())
    n_frags = sum(frags.values())
    t0 = time.perf_counter()
    want = numpy_stencil(MAIN_N, MAIN_ITERS)
    numpy_s = time.perf_counter() - t0
    assert result.shape == want.shape == (MAIN_N + 2, MAIN_N + 2)
    assert np.isfinite(result).all()
    assert np.array_equal(result, want), "runtime stencil != host NumPy"
    assert np.array_equal(swept, want), "jacobi_sweep iterations != host NumPy"
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    assert pairs > 0, "no payload of the main path was gated"
    assert launches["stencil5_block"] < n_frags, "no fragment shared a launch"
    # no copy launch after a stencil fragment: each wrote into its block
    assert staged == 0, f"{staged} fragments were staged and copied"
    log(f"[3] main path: jacobi_stencil n={MAIN_N} iters={MAIN_ITERS} "
        f"nprocs={MAIN_PROCS} block={MAIN_BLOCK} f64 fusion on, blocks on cuda; "
        f"== host NumPy bit for bit (runtime and {MAIN_ITERS} jacobi_sweep launches)")
    log(f"    makespan {st.makespan * 1e3:.3f} ms (to device completion)  wait_fraction "
        f"{st.wait_fraction:.4f}  comm_wait_fraction {st.comm_wait_fraction:.4f}  ops/s "
        f"{st.ops_per_sec:.1f}  compute ops {st.n_compute_ops}  comm ops {st.n_comm_ops}; "
        f"compute_busy (device) {st.total_compute:.4f} s, host_busy {st.total_host:.4f} s, "
        f"device busy share {st.total_compute / st.makespan:.4f}")
    log(f"    record {times['record_s']:.3f} s  drain+sync {times['drain_s']:.3f} s  "
        f"gather (host copy of {result.nbytes / 1e9:.2f} GB) {times['gather_s']:.3f} s  "
        f"jacobi_sweeps {sweep_s:.3f} s  host NumPy {numpy_s:.3f} s  peak device memory "
        f"{peak / 1e9:.2f} GB")
    log(f"    launches {launches}; stencil5 fragments {n_frags} in "
        f"{launches['stencil5_block']} launches, {n_frags / launches['stencil5_block']:.2f} "
        f"a launch; launches by fragments {sizes}; staged copies {staged} (no copy "
        f"launch after a fragment)")
    top = sorted(frags.items(), key=lambda kv: -kv[1])[:5]
    log(f"    stencil5 fragment shapes (top 5 of {len(frags)}): {top}")
    log(f"    host_busy is thread time, which here steps by {thread_time_step() * 1e3:.3f} ms")
    log_gate(st, times, pairs)
    # the gated pairs against the device's own busy time: the profiler's
    # kernels and copies, the gates (the device waiting on the host) apart
    del result
    stream_gate.reset_launches()
    result, prof_st, prof_times, _ = run_stencil(
        repro_torch, apps, MAIN_N, MAIN_ITERS, MAIN_PROCS, MAIN_BLOCK, profile=True)
    prof_pairs = stream_gate.launches["gate_wait"]
    assert np.array_equal(result, want), "profiled run != host NumPy"
    window = prof_times["record_s"] + prof_times["drain_s"]
    if "kernel_s" not in prof_times:
        log_gate(prof_st, prof_times, prof_pairs)
        log("    profiled run: the profiler failed its clock check; the pairs' bound "
            "against it not measured")
        return dict(launches=launches, fragments=frags)
    kernel_s = prof_times["kernel_s"]
    log(f"    profiled run after (torch.profiler, CUDA activity): kernels and copies "
        f"{kernel_s:.4f} s of device time over record + drain ({window:.3f} s, share "
        f"{kernel_s / window:.4f}) and {kernel_s / prof_st.makespan:.4f} of its makespan "
        f"{prof_st.makespan * 1e3:.3f} ms; the gates waited {prof_times['gate_s']:.4f} s; "
        f"its gated pairs' compute_busy {prof_st.total_compute:.4f} s (share "
        f"{prof_st.total_compute / prof_st.makespan:.4f})")
    log_gate(prof_st, prof_times, prof_pairs)
    assert kernel_s > 0, "the profiler recorded no device time"
    for name, run_st, n in (("profiled run", prof_st, prof_pairs), ("first run", st, pairs)):
        bound = PAIR_FACTOR * kernel_s + PAIR_SLACK_S * n
        log(f"    {name}: pairs' sum {run_st.total_compute:.4f} s over {n} pairs against the "
            f"profiler's {kernel_s:.4f} s: ratio {run_st.total_compute / kernel_s:.3f}, bound "
            f"{bound:.4f} s = {PAIR_FACTOR} x profiler + {PAIR_SLACK_S * 1e6:.0f} us a pair")
        assert run_st.total_compute <= bound, (name, run_st.total_compute, bound)
    return dict(launches=launches, fragments=frags)


def phase_paper_regime(repro_torch, apps, ks) -> dict:
    """Returns the ``sync="demand"`` run's timings, and the host-NumPy
    grid both runs equal (``want``)."""
    want = numpy_stencil(PAPER_N, MAIN_ITERS)
    out = {}
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
        out.setdefault(sync, times)
    return dict(out["demand"], want=want)


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


def profiled_device_s(window) -> dict:
    """A torch.profiler window's device time in seconds: ``kernel_s``
    (kernels but the stream gates), ``copy_s`` (memcpy and memset), of
    it ``host_copy_s`` (the copies to and from the host: the tenants'
    scatter and gather, which no gated pair may hold) and ``gate_s`` (the
    gates: the device waiting on the host)."""
    out = {"kernel_s": 0.0, "copy_s": 0.0, "host_copy_s": 0.0, "gate_s": 0.0}
    for name, (t, _) in window.rows().items():
        key = ("gate_s" if "gate_wait" in name else
               "copy_s" if name.startswith(("Memcpy", "Memset")) else "kernel_s")
        out[key] += t / 1e6
        if name.startswith(("Memcpy HtoD", "Memcpy DtoH")):
            out["host_copy_s"] += t / 1e6
    return out


def serve_fn(repro_torch, apps, host):
    """One tenant request: scatter ``host`` (the tenant's grid), record
    SERVE_SWEEPS sweeps of the flagship's body over it, return the grid."""
    def fn():
        return apps.stencil_sweeps(repro_torch.array(host), SERVE_SWEEPS)
    return fn


def run_serve(repro_torch, apps, grids, max_inflight, profile=False) -> dict:
    """SERVE_TENANTS closed-loop tenant threads against one Server on the
    card, SERVE_REQUESTS requests each, the next request on the grid the
    last one returned.  Returns the results per tenant, the merged
    latency histogram, the admission counters, the executor's
    device-clock totals and Python's garbage-collection passes during the
    load (the longest stall a gate holder may meet); with ``profile``,
    the profiler's device time over the load (:func:`profiled_device_s`)."""
    import contextlib
    import gc
    import threading

    import torch

    from repro_torch.serve import LatencyHistogram

    srv = repro_torch.Server(
        nprocs=MAIN_PROCS, block_size=PAPER_BLOCK, fusion=True, device=DEVICE,
        flush="async", channel="async", sync="demand", backend="torch",
        max_inflight=max_inflight, max_queue=len(grids))
    results = [[] for _ in grids]
    errors = []

    def client(i: int) -> None:
        host = grids[i]
        sess = srv.session(f"tenant-{i}")
        try:
            for _ in range(SERVE_REQUESTS):
                host = sess.request(serve_fn(repro_torch, apps, host)).result()
                results[i].append(host)
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append((i, exc))

    gc_passes = []  # (generation, seconds)

    def on_gc(phase, info, started=[0.0]):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            gc_passes.append((info["generation"], time.perf_counter() - started[0]))

    threads = [threading.Thread(target=client, args=(i,), name=f"tenant-{i}")
               for i in range(len(grids))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window = (CheckedProfile(torch, "the concurrent serving load") if profile
              else contextlib.nullcontext())
    with srv:
        with window:
            gc.callbacks.append(on_gc)
            try:
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                gc.callbacks.remove(on_gc)
        if errors:
            raise RuntimeError(f"tenant {errors[0][0]} failed") from errors[0][1]
        ex = srv.runtime._exec_executor_obj
        clock = ex._clock
        out = dict(
            results=results, wall_s=wall, peak=torch.cuda.max_memory_allocated(),
            compute_s=sum(w.stats.compute_busy for w in ex.workers),
            host_s=sum(w.stats.host_busy for w in ex.workers),
            gate_timeouts=sum(w.stats.gate_timeouts for w in ex.workers),
            timeout_log=list(clock.timeout_log) if clock else [],
            max_hold_s=clock.max_hold_s if clock else 0.0, nworkers=ex.nworkers,
            lock_hold_p50_s=srv.lock_hold.quantile(0.5),
            plan_p50_s=srv.plan_time.quantile(0.5), gc_passes=len(gc_passes),
            gc_longest=max(gc_passes, key=lambda p: p[1], default=(None, 0.0)))
        cache = srv.runtime._plan_cache
        out["plan_cache"] = (cache.hits, cache.misses) if cache is not None else None
    adm = srv.admission
    hist = LatencyHistogram()
    tenants = srv.stats()
    for st in tenants.values():
        hist.merge(st.latency)
    out.update(hist=hist, n_admitted=adm.n_admitted, n_rejected=adm.n_rejected,
               peak_inflight=adm.peak_inflight, tenants=tenants,
               n_failed=sum(st.n_failed for st in tenants.values()))
    if profile and window.ok:
        out.update(profiled_device_s(window))
    return out


def serve_barrier_reference(repro_torch, apps, grids) -> list:
    """The tenants' requests, one after another, through one runtime with
    a whole-graph barrier flush for each: the served results' second
    reference."""
    out = []
    with repro_torch.runtime(nprocs=MAIN_PROCS, block_size=PAPER_BLOCK, fusion=True,
                             device=DEVICE, flush="async", channel="async",
                             sync="barrier") as rt:
        for host in grids:
            seq = []
            for _ in range(SERVE_REQUESTS):
                full = serve_fn(repro_torch, apps, host)()
                rt.flush()
                host = np.asarray(full)
                seq.append(host)
            out.append(seq)
    return out


def phase_serve(repro_torch, apps, ks) -> dict:
    """The serving path at the paper's regime: SERVE_TENANTS tenants of a
    Server on the card, serialised (max_inflight=1) and concurrent
    (max_inflight=SERVE_TENANTS), each result held to host NumPy and to a
    barrier-flush run bit for bit, every fused map on stencil5_group,
    admission counted, no gate timing out; then the concurrent variant
    once more under torch.profiler, its gated pairs within PAIR_FACTOR x
    the profiler's kernel-and-copy time + PAIR_SLACK_S a pair.  Returns
    the concurrent variant's stencil launches and fragments."""
    from repro_torch.kernels import stream_gate

    t_phase = time.perf_counter()
    grids = [numpy_grid(PAPER_N, edge=1.0 + i) for i in range(SERVE_TENANTS)]
    t0 = time.perf_counter()
    want = []
    for g in grids:
        full, seq = g.copy(), []
        for _ in range(SERVE_REQUESTS):
            seq.append(numpy_sweeps(full, SERVE_SWEEPS).copy())
        want.append(seq)
    numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    barrier = serve_barrier_reference(repro_torch, apps, grids)
    barrier_s = time.perf_counter() - t0
    for i in range(SERVE_TENANTS):
        for got, w in zip(barrier[i], want[i]):
            assert np.array_equal(got, w), f"barrier run, tenant {i} != host NumPy"
    n_req = SERVE_TENANTS * SERVE_REQUESTS
    # the fused maps of a sweep: each of the (n/block)² output blocks in
    # 9 fragments (interior, slivers, corners), as phase 3's 3456 = 6 x 576
    expect_frags = n_req * SERVE_SWEEPS * 9 * (PAPER_N // PAPER_BLOCK) ** 2
    log(f"[S] serving path: Server on cuda, {SERVE_TENANTS} closed-loop tenants x "
        f"{SERVE_REQUESTS} requests, each request a scatter of the tenant's {PAPER_N + 2}² "
        f"f64 grid ({(PAPER_N + 2) ** 2 * 8 / 1e6:.1f} MB), {SERVE_SWEEPS} jacobi_stencil "
        f"sweeps and a gather; {MAIN_PROCS} processes, {PAPER_BLOCK}² blocks, fusion on, "
        f"flush=async channel=async sync=demand; host NumPy {numpy_s:.3f} s, barrier-flush "
        f"reference run {barrier_s:.3f} s (== host NumPy)")
    info = {}
    for label, inflight in (("serialised", 1), ("concurrent", SERVE_TENANTS)):
        ks.reset_launches()
        stream_gate.reset_launches()
        r = run_serve(repro_torch, apps, grids, inflight)
        pairs = stream_gate.launches["gate_wait"]
        launches = ks.launches["stencil5_block"]
        frags = sum(ks.fragment_shapes.values())
        staged = sum(ks.staged_copies.values())
        for i in range(SERVE_TENANTS):
            assert len(r["results"][i]) == SERVE_REQUESTS
            for k, (got, w, b) in enumerate(zip(r["results"][i], want[i], barrier[i])):
                assert got.shape == w.shape and np.isfinite(got).all()
                assert np.array_equal(got, w), f"{label}: tenant {i} request {k} != host NumPy"
                assert np.array_equal(got, b), f"{label}: tenant {i} request {k} != barrier run"
        assert frags == expect_frags, (label, frags, expect_frags)
        assert 0 < launches < frags, (label, launches, frags)
        assert staged == 0, (label, staged)
        assert r["n_admitted"] + r["n_rejected"] == n_req and r["n_rejected"] == 0, r
        assert r["n_failed"] == 0
        assert r["gate_timeouts"] == len(r["timeout_log"])
        h, wall = r["hist"], r["wall_s"]
        log(f"[S] {label} (max_inflight={inflight}, max_queue={SERVE_TENANTS}): {n_req} "
            f"requests in {wall:.3f} s = {n_req / wall:.3f} requests/s; latency p50 "
            f"{h.p50 * 1e3:.1f} ms p95 {h.p95 * 1e3:.1f} ms p99 {h.p99 * 1e3:.1f} ms max "
            f"{h.max * 1e3:.1f} ms; admitted {r['n_admitted']} rejected {r['n_rejected']} "
            f"peak inflight {r['peak_inflight']}; == host NumPy and the barrier run, bit for bit")
        log(f"    makespan (first request to last result) {wall * 1e3:.3f} ms; wait_fraction "
            f"{1 - r['compute_s'] / (r['nworkers'] * wall):.4f}; compute_busy (device, gated "
            f"pairs) {r['compute_s']:.4f} s over {pairs} pairs, device busy share "
            f"{r['compute_s'] / wall:.4f}; host_busy {r['host_s']:.4f} s; peak device memory "
            f"{r['peak'] / 1e9:.2f} GB; record-lock hold p50 {r['lock_hold_p50_s'] * 1e3:.2f} ms, "
            f"plan p50 {r['plan_p50_s'] * 1e3:.2f} ms; plan cache (hits, misses) "
            f"{r['plan_cache']}")
        log(f"    stencil5_group: {frags} fragments (every fused map of the load) in {launches} "
            f"launches, {frags / launches:.2f} a launch; staged copies {staged}")
        for name, st in r["tenants"].items():
            log(f"    {name}: {st.n_requests} requests, p50 {st.latency.p50 * 1e3:.1f} ms, "
                f"wait_fraction {st.wait_fraction:.4f}, compute_busy {st.total_compute:.4f} s, "
                f"gate_timeouts {st.gate_timeouts}")
        log_gate_timeouts(r, pairs)
        assert r["gate_timeouts"] == 0, f"{label}: {r['gate_timeouts']} gate timeouts"
        info[label] = dict(launches=launches, fragments=frags)
    # the concurrent variant once more, under the profiler: the pairs
    # against the device's own time for kernels and copies
    stream_gate.reset_launches()
    r = run_serve(repro_torch, apps, grids, SERVE_TENANTS, profile=True)
    pairs = stream_gate.launches["gate_wait"]
    for i in range(SERVE_TENANTS):
        for got, w in zip(r["results"][i], want[i]):
            assert np.array_equal(got, w), f"profiled run: tenant {i} != host NumPy"
    log_gate_timeouts(r, pairs)
    assert r["gate_timeouts"] == 0, f"profiled run: {r['gate_timeouts']} gate timeouts"
    if "kernel_s" not in r:
        log("[S] profiled concurrent run: the profiler failed its clock check; the pairs' "
            "bound against it not measured")
        log(f"[S] phase S took {time.perf_counter() - t_phase:.1f} s")
        return info["concurrent"]
    dev = r["kernel_s"] + r["copy_s"]
    # what a pair may hold: kernels and device-to-device copies, never the
    # tenants' copies to and from the host (those queue outside the pairs)
    on_device = dev - r["host_copy_s"]
    bound = PAIR_FACTOR * dev + PAIR_SLACK_S * pairs
    tight = PAIR_FACTOR * on_device + PAIR_SLACK_S * pairs
    log(f"[S] profiled concurrent run: torch.profiler (CUDA activity) kernels "
        f"{r['kernel_s']:.4f} s + copies {r['copy_s']:.4f} s = {dev:.4f} s of device time "
        f"over {r['wall_s']:.3f} s, of it copies to and from the host (scatter, gather) "
        f"{r['host_copy_s']:.4f} s; the gates waited {r['gate_s']:.4f} s; gated pairs "
        f"{r['compute_s']:.4f} s over {pairs} pairs: {r['compute_s'] / dev:.3f} x kernels and "
        f"copies (bound {bound:.4f} s = {PAIR_FACTOR} x profiler + {PAIR_SLACK_S * 1e6:.0f} us "
        f"a pair), {r['compute_s'] / on_device:.3f} x them without the host copies (bound "
        f"{tight:.4f} s)")
    assert r["compute_s"] <= bound, (r["compute_s"], bound)
    assert r["compute_s"] <= tight, ("a pair held host copies", r["compute_s"], tight)
    log(f"[S] phase S took {time.perf_counter() - t_phase:.1f} s")
    return info["concurrent"]


def log_gate_timeouts(r: dict, pairs: int) -> None:
    """A serve run's gates: timeouts, each named with its payload's kind
    and cause, and the longest a payload held the gate."""
    from repro_torch.exec.backend import _DeviceClock

    gen, longest = r["gc_longest"]
    log(f"    gated event pairs {pairs}, gate_timeouts {r['gate_timeouts']}, longest a "
        f"payload held its gate {r['max_hold_s'] * 1e3:.3f} ms (limit "
        f"{_DeviceClock.GATE_TIMEOUT_S * 1e3:.0f} ms); Python's GC ran {r['gc_passes']} "
        f"passes during the load, the longest {longest * 1e3:.3f} ms (generation {gen})")
    for kind, cause, held in r["timeout_log"]:
        log(f"    gate timeout: {kind}: {cause} (held {held * 1e3:.3f} ms)")


def phase_verify_trace(repro_torch, apps, paper: dict) -> None:
    """The paper-regime stencil once with verify="full", the plan cache
    and a trace export path: == host NumPy, no diagnostic over verified
    flushes, every cached plan re-verified clean, the exported trace
    valid, attribution's wait_fraction within ATTRIBUTION_TOL of the
    device-timed WaitStats' and its compute the gated pairs' (no host
    launch time); then the fig. 6 rendezvous schedule rejected before
    any thread starts, and a well-ordered one run."""
    import os
    import tempfile
    import threading

    import torch

    from repro_torch.api import ExecutionPolicy, RuntimeConfig
    from repro_torch.exec.backend import DeadlockError, run_rendezvous_bsp_async

    want = paper["want"]
    cfg = RuntimeConfig(nprocs=MAIN_PROCS, block_size=PAPER_BLOCK, fusion=True,
                        device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        policy = ExecutionPolicy(flush="async", channel="async", backend="torch",
                                 verify="full", plan_cache=True, trace=path)
        with repro_torch.runtime(cfg, policy) as rt:
            t0 = time.perf_counter()
            full = apps.jacobi_stencil(n=PAPER_N, iters=MAIN_ITERS)
            t1 = time.perf_counter()
            repro_torch.evaluate(full).block_until_ready()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            result = np.asarray(full)
            st = rt.stats()
            vs = rt.verify_stats
            reports = rt.verify_cached_plans()  # raises on an error finding
            tracer = rt.tracer
        summary = repro_torch.validate_trace(path)  # exported at close
        size = os.path.getsize(path)
    assert np.array_equal(result, want), "verified run != host NumPy"
    assert vs.n_flushes_verified > 0 and vs.n_diagnostics == 0, vs
    assert reports and all(r.ok for r in reports), reports
    rep = repro_torch.attribution(tracer)
    gap = abs(rep.wait_fraction - st.wait_fraction)
    drain_s = t2 - t1
    log(f"[V] verify='full', plan_cache, trace export: jacobi_stencil n={PAPER_N} "
        f"iters={MAIN_ITERS} block={PAPER_BLOCK} on cuda == host NumPy; "
        f"{vs.n_flushes_verified} flushes verified, {vs.n_diagnostics} diagnostics, "
        f"{len(reports)} cached plans re-verified clean; verify_seconds "
        f"{vs.verify_seconds:.4f} s = {vs.verify_seconds / drain_s:.4f} of drain+sync "
        f"{drain_s:.3f} s (record {t1 - t0:.3f} s); unverified phase 4 drain+sync "
        f"{paper['drain_s']:.3f} s")
    log(f"    race oracle: {vs.n_race_checks} checks, {vs.n_key_conflicts} key-level "
        f"conflicts, {vs.n_region_false_positives} region-level false positives, precision "
        f"{vs.precision}")
    log(f"    trace: {tracer.n_emitted} events ({tracer.dropped} dropped), exported "
        f"{summary['n_events']} trace events, {size / 1e6:.2f} MB; validate_trace ok")
    log(f"    attribution wait_fraction {rep.wait_fraction:.6f} vs WaitStats "
        f"{st.wait_fraction:.6f} (|gap| {gap:.6f}, tol {ATTRIBUTION_TOL}); compute "
        f"charged {rep.total_compute:.6f} s vs gated pairs {st.total_compute:.6f} s "
        f"(host_busy {st.total_host:.4f} s, not charged)")
    for line in rep.format(5).splitlines():
        log(f"    {line}")
    assert gap <= ATTRIBUTION_TOL, (rep.wait_fraction, st.wait_fraction)
    assert abs(rep.total_compute - st.total_compute) <= 1e-6, (
        rep.total_compute, st.total_compute)
    p0 = [{"kind": "recv", "tag": "x", "peer": 1}, {"kind": "send", "tag": "y", "peer": 1}]
    p1 = [{"kind": "recv", "tag": "y", "peer": 0}, {"kind": "send", "tag": "x", "peer": 0}]
    before = threading.active_count()
    try:
        run_rendezvous_bsp_async([p0, p1])
    except DeadlockError as exc:
        assert "statically at plan time" in str(exc), exc
        assert threading.active_count() == before
    else:
        raise AssertionError("the fig. 6 schedule was not rejected")
    ok = [[{"kind": "send", "tag": "y", "peer": 1}, {"kind": "compute"},
           {"kind": "recv", "tag": "x", "peer": 1}],
          [{"kind": "recv", "tag": "y", "peer": 0}, {"kind": "send", "tag": "x", "peer": 0}]]
    steps = run_rendezvous_bsp_async(ok)
    assert steps == 5, steps
    log(f"    run_rendezvous_bsp_async: the fig. 6 schedule rejected statically before any "
        f"thread started; a well-ordered schedule ran its {steps} steps")


def sweep_fragments(torch, gen, n: int, block: int) -> list:
    """One sweep of the flagship's fused stencil as the runtime splits
    it: ``work`` (n², in block² blocks) from five shifted views of
    ``full`` ((n+2)², in block² blocks, the last row and column of blocks
    2 wide).  Each output block has 9 fragments, cut where an operand
    crosses into the next block: (block-2)² with its five operands in
    one block (the shared route), and 1-wide slivers and 1 x 1 corners."""
    N = n + 2
    nb = -(-N // block)
    full = {(i, j): torch.rand(min(block, N - i * block), min(block, N - j * block),
                               dtype=torch.float64, device=DEVICE, generator=gen)
            for i in range(nb) for j in range(nb)}
    segs = ((0, block - 2), (block - 2, block - 1), (block - 1, block))
    shifts = ((1, 1), (0, 1), (2, 1), (1, 0), (1, 2))  # centre, up, down, left, right
    frags = []
    for bi in range(n // block):
        for bj in range(n // block):
            work = torch.zeros(block, block, dtype=torch.float64, device=DEVICE)
            for r0, r1 in segs:
                for c0, c1 in segs:
                    xs = []
                    for dy, dx in shifts:
                        R, C = bi * block + r0 + dy, bj * block + c0 + dx
                        blk = full[(R // block, C // block)]
                        xs.append(blk[R % block:R % block + r1 - r0,
                                      C % block:C % block + c1 - c0])
                    frags.append((tuple(xs), work[r0:r1, c0:c1]))
    return frags


def phase_times(ks, torch, gen, main: dict, err: dict) -> list:
    import torch.nn.functional as F

    records = []
    frags_run = main["fragments"]
    n_interior = frags_run.get((MAIN_BLOCK - 2, MAIN_BLOCK - 2), 0)
    # the interior fragment as the runtime passes it: five shifts of one
    # 2048² block, written straight into another block's slice (the
    # shared-memory route); the table is built before the timed launches
    rows = cols = MAIN_BLOCK - 2
    blk = torch.randn(MAIN_BLOCK, MAIN_BLOCK, dtype=torch.float64, device=DEVICE,
                      generator=gen)
    dst = torch.zeros_like(blk)
    frag = [(plus_views(blk, rows, cols), dst[1:rows + 1, 1:cols + 1])]
    prep = ks.prepare_group(frag)
    assert prep.table[0, -1] & 3 == 3, "interior fragment not on the 16-byte shared route"
    ms = cuda_ms(lambda: prep.launch(0.2))
    plain_ms = cuda_ms(lambda: ks.stencil5_group_plain(frag, weight=0.2))
    got = dst.clone()
    prep.launch(0.2)
    torch.cuda.synchronize()
    assert torch.equal(got, dst)
    plus = torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2], [0.0, 0.2, 0.0]],
                        dtype=torch.float64, device=DEVICE).view(1, 1, 3, 3)
    library_ms = cuda_ms(lambda: F.conv2d(blk.view(1, 1, MAIN_BLOCK, MAIN_BLOCK), plus))
    five = 6 * rows * cols * 8  # five operands read, one result written
    distinct = (MAIN_BLOCK * MAIN_BLOCK - 4) * 8 + rows * cols * 8  # the block's plus, once
    records.append(dict(
        name="stencil5_block[interior fragment]", route="cuda", source=STENCIL_CU,
        replaces="src/repro/kernels/stencil/kernel.py:88",
        launches=main["launches"]["stencil5_block"], fragments=n_interior,
        max_abs_err=err["stencil5_block"], ms=ms, plain_ms=plain_ms,
        bound_ms=distinct / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bound_ms_five_operands=five / HBM_BYTES_PER_S * 1e3, library_ms=library_ms,
    ))
    log(f"[6] stencil5_block {rows}x{cols} f64, the main path's interior fragment "
        f"({n_interior} of them; five shifts of one {MAIN_BLOCK}² block, written in place "
        f"into a block slice, the shared-memory route): kernel {ms:.4f} ms | bound "
        f"{records[-1]['bound_ms']:.4f} ms (distinct bytes {distinct / 1e6:.1f} MB at 3.35 "
        f"TB/s); five separate operands {records[-1]['bound_ms_five_operands']:.4f} ms "
        f"({five / 1e6:.1f} MB) | plain {plain_ms:.4f} ms | yardstick F.conv2d 3x3 plus "
        f"over the block (not used by the port) {library_ms:.4f} ms")
    del blk, dst, frag, prep, got
    # one whole sweep's group: 576 fragments of a 16384² run, as one
    # worker would send them if it held them all (three launches)
    frags = sweep_fragments(torch, gen, MAIN_N, MAIN_BLOCK)
    t0 = time.perf_counter()
    prep = ks.prepare_group(frags)
    table_ms = (time.perf_counter() - t0) * 1e3
    n_shared = int(((prep.table[:, -1] & 1) == 1).sum())
    ms = cuda_ms(lambda: prep.launch(0.2), reps=10)
    per_call = -(-len(frags) // ks.GROUP_MAX_FRAGS)
    got = [out.clone() for _, out in frags]
    plain_ms = cuda_ms(lambda: ks.stencil5_group_plain(frags, weight=0.2), reps=3, warmup=1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, out) for a, (_, out) in zip(got, frags)), "sweep group != plain"
    del got
    # the host's cost of a sweep's 576 fragments, on one thread: the
    # table and the launches, against one launch into a new tensor and a
    # copy into the block a fragment (the per-fragment route)
    host = {"grouped": [], "per fragment": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ks.stencil5_group(frags, weight=0.2)
        host["grouped"].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for xs, out in frags:
            out.copy_(ks.stencil5_block(*xs, weight=0.2))
        host["per fragment"].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    host = {k: statistics.median(v) * 1e3 for k, v in host.items()}
    log(f"[6] host time of one sweep's {len(frags)} fragments, one thread (median of 5): "
        f"grouped {host['grouped']:.3f} ms ({host['grouped'] * 1e3 / len(frags):.1f} us a "
        f"fragment) | per-fragment route {host['per fragment']:.3f} ms "
        f"({host['per fragment'] * 1e3 / len(frags):.1f} us); difference x {MAIN_ITERS} "
        f"sweeps {(host['per fragment'] - host['grouped']) * MAIN_ITERS / 1e3:.4f} s a run")
    five = 6 * MAIN_N * MAIN_N * 8
    distinct = ((MAIN_N + 2) ** 2 - 4) * 8 + MAIN_N * MAIN_N * 8  # the grid once, work once
    records.append(dict(
        name="stencil5_block[sweep group]", route="cuda", source=STENCIL_CU,
        replaces="src/repro/kernels/stencil/kernel.py:88",
        launches=main["launches"]["stencil5_block"], fragments=sum(frags_run.values()),
        max_abs_err=err["stencil5_block"], ms=ms, plain_ms=plain_ms,
        bound_ms=distinct / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bound_ms_five_operands=five / HBM_BYTES_PER_S * 1e3, library_ms=None,
    ))
    log(f"[6] stencil5_group over one sweep's {len(frags)} fragments of the {MAIN_N}² "
        f"run ({n_shared} on the shared route; {per_call} launches; table built on the host "
        f"in {table_ms:.2f} ms, {table_ms * 1e3 / len(frags):.1f} us a fragment): kernel "
        f"{ms:.4f} ms | bound {records[-1]['bound_ms']:.4f} ms (the grid read once, work "
        f"written once: {distinct / 1e9:.2f} GB at 3.35 TB/s); five separate operands "
        f"{records[-1]['bound_ms_five_operands']:.4f} ms | plain {plain_ms:.4f} ms | "
        f"library: none (no single PyTorch call computes a table of fragments)")
    del frags, prep
    torch.cuda.empty_cache()
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


# torch.profiler's clock check: a spin kernel before and one after the
# profiled window, each also timed by CUDA events (~5 ms at the H100's
# clock); the profiler's readings of both must be within
# PROFILER_CLOCK_TOL of the events'.  A shorter spin ahead of each keeps
# the stream busy past its first event, so the events time the spin
# alone: recorded on an idle stream, the last one's pair once also
# timed the host's 0.47 ms delay in launching it, with a Server's 16
# worker threads alive (PERF.md).  On the H100 machine a session
# loses its first device records (1-3 after a profiled drain of the
# runtime's worker threads, up to 27 late in a full run; phase P,
# PERF.md), so the LM sessions lost their first spin kernels.  (With one
# library a kernel source it also lost records mid-session: hence
# kernels/build.py's one library.)  A session therefore
# starts with PROFILER_PRIMES launches of a one-element add, synchronised,
# whose records may be lost, and counts device time only between its
# first and last spin kernels.  A session over one train step (~21,400
# records) also lost its last records, the last spin kernel among them,
# once in the full run and in some sessions of a probe (PERF.md; not
# reproduced by ``--probe-train`` on other machines).  So a session
# also ends with PROFILER_PRIMES adds after its last spin kernel, whose
# records may be lost, and the host waits PROFILER_SETTLE_S after the
# profiler starts and again before it stops.
SPIN_CYCLES, PROFILER_CLOCK_TOL, PROFILER_PRIMES = 10_000_000, 0.03, 64
PROFILER_SPINS = 4  # a short spin, then a timed one, at each end
PROFILER_SETTLE_S = 0.25


class CheckedProfile:
    """``torch.profiler`` (CUDA activity) over a window bracketed by
    spin kernels that CUDA events time as well, after ``primes`` launches
    that absorb the records the session loses at its start.  After the
    window, ``ok`` says whether the profiler found all four spin kernels
    with both timed ones within ``PROFILER_CLOCK_TOL`` of the events,
    ``lost`` how many of the primes at its start it did not record,
    ``lost_tail`` how many of those at its end (after the last spin
    kernel found), and ``rows()``
    gives the device time by kernel name between the first and the last
    spin kernel, the spin kernels left out.  The host waits ``settle_s``
    after the profiler starts and before it stops."""

    sessions: list = []  # (what, passed) of every session in this process

    def __init__(self, torch, what: str, quiet: bool = False, primes: int = PROFILER_PRIMES,
                 settle_s: float = PROFILER_SETTLE_S):
        self.torch, self.what, self.quiet, self.primes = torch, what, quiet, primes
        self.settle_s = settle_s
        self.ok, self.spins, self.lost, self.by_prof, self.by_events = False, 0, 0, [], []
        self.records, self.lost_tail = 0, 0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self._ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        self._one = one = torch.zeros(1, device=DEVICE)
        torch.cuda._sleep(1)  # loads the spin kernel's module outside the session
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(self.settle_s)
        for _ in range(self.primes):
            one.add_(1.0)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES // 4)
        self._ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        self._ev[1].record()
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        torch = self.torch
        if exc[0] is None:
            torch.cuda._sleep(SPIN_CYCLES // 4)
            self._ev[2].record()
            torch.cuda._sleep(SPIN_CYCLES)
            self._ev[3].record()
            for _ in range(self.primes):
                self._one.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(self.settle_s)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        device = [e for e in self.prof.events() if e.device_type == DeviceType.CUDA]
        spins = sorted((e for e in device if "spin_kernel" in e.name),
                       key=lambda e: e.time_range.start)
        start = spins[0].time_range.start if spins else float("inf")
        self.lost = self.primes - sum(e.time_range.start < start for e in device)
        end = spins[-1].time_range.end if spins else float("inf")
        self.lost_tail = self.primes - sum(e.time_range.start > end for e in device)
        self._window = [e for e in device if "spin_kernel" not in e.name
                        and spins and start <= e.time_range.start <= spins[-1].time_range.end]
        self.spins, self.records = len(spins), len(device)
        self.by_prof = [e.time_range.elapsed_us() / 1e3 for e in spins[1::2]]
        self.by_events = [self._ev[0].elapsed_time(self._ev[1]),
                          self._ev[2].elapsed_time(self._ev[3])]
        self.ok = len(spins) == PROFILER_SPINS and all(abs(p / e - 1) <= PROFILER_CLOCK_TOL
                                          for p, e in zip(self.by_prof, self.by_events))
        CheckedProfile.sessions.append((self.what, self.ok))
        if self.quiet:
            return False
        log(f"    profiler clock check over {self.what}: spin kernels "
            f"{[round(t, 4) for t in self.by_prof]} ms by the profiler (of {len(spins)} "
            f"found, {PROFILER_SPINS} launched), {[round(t, 4) for t in self.by_events]} ms by CUDA events: "
            f"{'passed' if self.ok else 'FAILED'}; {self.lost} of {self.primes} primes lost "
            f"at the start, {self.lost_tail} at the end")
        if not self.ok:
            log(f"    profiler: lost spin kernels or a clock off CUDA events by more than "
                f"{PROFILER_CLOCK_TOL:.0%}; device time over {self.what} not measured")
        return False

    def clock_errors(self) -> list:
        return [p / e - 1 for p, e in zip(self.by_prof, self.by_events)]

    def events(self) -> list:
        """The device records between the first and last spin kernel."""
        return list(self._window)

    def rows(self) -> dict:
        """Device microseconds and records by name over ``events()``."""
        out = {}
        for e in self._window:
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        return out


# phase P, the profiler probe: each case in a fresh process (a loaded
# library cannot be unloaded), PROBE_SESSIONS profiler sessions one
# after another (as the LM phases profile one session after another in
# one process), each over one of torch's kernels and one launch of each
# of the first k of the port's kernels (PROBE_KERNELS' order) between
# the clock check's spin kernels.  A label starts with "kernels:k"; the
# port's library is loaded when k > 0 or the runtime drains.  label ->
# (environment, primes a session, whether a profiled drain of the
# runtime comes first): the cases without primes show lost records as
# lost spin kernels; PRIMED_CASES, with PROFILER_PRIMES primes a session
# as every measured session has, count the records a session loses at
# its start after the runtime's worker threads drained under the
# profiler, as phase 3 drains them before the LM phases.  main() runs
# PRIMED_CASES; ``--probe`` runs every case.
PROBE_SESSIONS = 4
PRIMED_CASES = {f"kernels:{k} primed, after a profiled drain": ({}, PROFILER_PRIMES, True)
                for k in (0, 5)}
PROBE_CASES = {
    **{f"kernels:{k}": ({}, 0, False) for k in (0, 1, 2, 5)},
    **{f"kernels:{k} eager": ({"CUDA_MODULE_LOADING": "EAGER"}, 0, False)
       for k in (0, 1, 2, 5)},
    **PRIMED_CASES,
}
# the kernel that each library's probe launch runs, as the profiler names it
PROBE_KERNELS = {"stencil": "jacobi_sweep_kernel", "flash_attention": "flash_attention_wgmma",
                 "ssd_scan": "ssd_scan_tc_kernel", "wkv6": "wkv6_tc_kernel",
                 "stream_gate": "gate_wait_kernel"}


def probe_launches(torch, names) -> list:
    """One thunk a library in ``names``, each launching that library's
    kernel once on small inputs made here."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba2_scan import ops as ssd
    from repro_torch.kernels.rwkv6_wkv import ops as wkv
    from repro_torch.kernels.stencil import ops as ks
    from repro_torch.kernels.stream_gate import ops as gate

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    grid = torch.rand(258, 258, dtype=torch.float64, device=DEVICE, generator=gen)
    qkv = flash_inputs(torch, gen, 1, 256, 256, 2, 2, 64, torch.bfloat16)
    xs = ssd_inputs(torch, gen, 1, 128, 2, 64, 64, torch.bfloat16)
    rs = wkv_inputs(torch, gen, 1, 128, 2, 64, torch.bfloat16)

    def gate_once():
        g = gate.StreamGate(DEVICE)
        g.open(g.wait(torch.cuda.current_stream(), 1.0))
        torch.cuda.synchronize()
        g.close()

    thunks = {"stencil": lambda: ks.jacobi_sweep(grid),
              "flash_attention": lambda: fa.flash_attention(*qkv, causal=True),
              "ssd_scan": lambda: ssd.ssd_scan(*xs), "wkv6": lambda: wkv.wkv6(*rs),
              "stream_gate": gate_once}
    return [thunks[n] for n in names]


def probe_case(label: str) -> int:
    """One case of phase P (``PROBE_CASES[label]``; the parent sets its
    environment), in this process: prints one line ``PROBE {json}``,
    per session the spin kernels found, the clock's errors, whether it
    passed and the port's kernel records found."""
    t0 = time.perf_counter()
    import torch

    how = label.split()[0]  # "kernels:k"
    _, primes, drain_first = PROBE_CASES[label]
    names = list(PROBE_KERNELS)[:int(how.split(":")[1])]
    x = torch.ones(1 << 20, device=DEVICE)
    thunks = probe_launches(torch, names)
    for fn in thunks:  # each kernel's module loaded before any session, as in use
        fn()
    torch.cuda.synchronize()
    if drain_first:  # the runtime's worker threads drain under the profiler
        import repro_torch
        from repro_torch import apps

        run_stencil(repro_torch, apps, MAIN_N // 2, MAIN_ITERS, MAIN_PROCS, MAIN_BLOCK // 2,
                    profile=True)
    t_ready = time.perf_counter() - t0
    sessions = []
    for i in range(PROBE_SESSIONS):
        with CheckedProfile(torch, f"probe {label}, session {i}", quiet=True,
                            primes=primes) as window:
            x.add_(1.0)  # one of torch's own kernels
            for fn in thunks:
                fn()
        events = window.events()
        sessions.append(dict(
            ok=window.ok, spins=window.spins, clock_errors=window.clock_errors(),
            lost=window.lost if primes else None,
            lost_tail=window.lost_tail if primes else None,
            recorded={n: sum(PROBE_KERNELS[n] in e.name for e in events) for n in names},
            torch_kernel=any("elementwise" in e.name for e in events)))
    print("PROBE " + json.dumps(dict(label=label, launched=len(names),
                                     sessions=sessions, ready_s=t_ready,
                                     sessions_s=time.perf_counter() - t0 - t_ready)),
          flush=True)
    return 0


def probe_passed(session: dict) -> bool:
    """A probe session passed: the clock check, every launched kernel
    recorded once, torch's kernel recorded."""
    return (session["ok"] and session["torch_kernel"]
            and all(n == 1 for n in session["recorded"].values()))


def phase_profiler_probe(cases=PRIMED_CASES) -> dict:
    """Phase P: every case of ``cases`` in a fresh process, one line a
    case; asserts every primed session passed and lost fewer records at
    its start than it had primes.  Returns the cases' records by
    label."""
    import os

    out = {}
    for label in cases:
        env = {**os.environ, **PROBE_CASES[label][0]}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--probe-case",
                               label], capture_output=True, text=True, env=env, timeout=300)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("PROBE ")]
        if proc.returncode != 0 or not lines:
            log(f"[P] case {label}: the probe process failed (exit {proc.returncode})\n"
                f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            raise AssertionError(f"profiler probe case {label} failed")
        r = out[label] = json.loads(lines[-1][len("PROBE "):])
        passed = [probe_passed(ss) for ss in r["sessions"]]
        lost = [ss["lost"] for ss in r["sessions"]]
        tail = [ss["lost_tail"] for ss in r["sessions"]]
        log(f"[P] {label:42s}: {sum(passed)} of {len(passed)} sessions passed "
            f"({''.join('+' if ok else '-' for ok in passed)}); spins found "
            f"{[ss['spins'] for ss in r['sessions']]} of {PROFILER_SPINS}"
            f"{f'; records lost at the start {lost} of {PROBE_CASES[label][1]} primes' if lost[0] is not None else ''}"
            f"{f', at the end {tail}' if lost[0] is not None else ''}"
            f"; worst clock error "
            f"{max((abs(e) for ss in r['sessions'] for e in ss['clock_errors']), default=0):.2%}"
            f"; port kernels recorded {[sum(v > 0 for v in ss['recorded'].values()) for ss in r['sessions']]}"
            f" of {r['launched']}; set-up {r['ready_s']:.1f} s, sessions {r['sessions_s']:.1f} s "
            f"({time.perf_counter() - t0:.1f} s)")
        if PROBE_CASES[label][1]:
            assert all(passed) and all(n < PROBE_CASES[label][1] for n in lost), (
                label, r["sessions"])
    return out


def profile_device(torch, what: str, fn) -> float:
    """Device time by kernel over one call of ``fn``, from torch.profiler;
    returns the total in ms, or 0.0 (not measured) when the profiler
    records none or fails its clock check (``CheckedProfile``)."""
    with CheckedProfile(torch, what) as window:
        fn()
    if not window.ok:
        return 0.0
    rows = sorted(((us, n, key) for key, (us, n) in window.rows().items()), reverse=True)
    total = sum(r[0] for r in rows)
    if total <= 0:
        log(f"    profiler: no device time recorded over {what} (not measured)")
        return 0.0
    log(f"    profiler: device time over {what} {total / 1e3:.2f} ms; top:")
    for us, count, key in rows[:6]:
        log(f"      {us / 1e3:9.2f} ms {100 * us / total:5.1f}%  x{count}  {key[:90]}")
    return total / 1e3


class FlashShapes:
    """While active, tallies the flash wrapper's calls from the models by
    shape, ``(Sq, Sk, H, KV, d, causal)`` -> calls.  It wraps the name
    that ``models.model`` and ``models.attention`` call; the launches
    themselves are counted by the wrapper alone."""

    def __enter__(self):
        import collections

        from repro_torch.models import attention, model

        self.calls = collections.Counter()
        self._real = real = model.flash_attention

        def spy(q, k, v, **kw):
            self.calls[(q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                        kw.get("causal", True))] += 1
            return real(q, k, v, **kw)

        model.flash_attention = attention.flash_attention = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention, model

        model.flash_attention = attention.flash_attention = self._real


class RouteLog:
    """While active, records the routing of every MoE block call: its
    kept experts per token, ``[T, K]`` sorted, -1 for a dropped choice
    (``moe_routes`` on the block's input, beside the block's own call)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.models import model, moe

        self._real = real = model.moe_apply

        def spy(cfg, p, x, **kw):
            idx, keep = moe.moe_routes(cfg, p, x, **kw)
            self.calls.append(torch.where(keep, idx, -1).sort(dim=-1).values)
            return real(cfg, p, x, **kw)

        model.moe_apply = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model

        model.moe_apply = self._real


def route_diff(a, b):
    """Two routings of the same tokens (``RouteLog`` rows): the tokens
    whose kept experts differ [T] and the (token, choice) pairs routed
    differently."""
    a_in_b = ((a[:, :, None] == b[:, None, :]).any(-1) & (a >= 0)).sum(-1)
    b_in_a = ((b[:, :, None] == a[:, None, :]).any(-1) & (b >= 0)).sum(-1)
    pairs = ((a >= 0).sum(-1) - a_in_b).maximum((b >= 0).sum(-1) - b_in_a)
    return pairs > 0, int(pairs.sum())


def upcast_block(torch, p, cfg32, letter: str):
    """An f32 copy of block ``p`` (built in f32, then filled: no second
    bf16 copy on the way)."""
    from repro_torch.models.model import _block

    p32 = _block(cfg32, letter, next(p.parameters()).device)
    with torch.no_grad():
        for (n32, a), (n, b) in zip(p32.named_parameters(), p.named_parameters(),
                                    strict=True):
            assert n32 == n, (n32, n)
            a.copy_(b)
    return p32


class _UpcastRep:
    def __init__(self, torch, rep, cfg32):
        self.torch, self.rep, self.cfg32 = torch, rep, cfg32

    def __getitem__(self, key):
        return upcast_block(self.torch, self.rep[key], self.cfg32, key[-1])


class Upcast:
    """A model read in f32 by ``prefill`` and ``decode_step`` without an
    f32 copy of all of it (grok-1's four layers would take 85 GB): the
    embeddings, norms, encoder and shared block are upcast once, each
    trunk block when the trunk reaches it, and freed after."""

    def __init__(self, torch, params, cfg32):
        import copy

        for name in ("embed", "final_norm", "unembed", "img_norm"):
            if hasattr(params, name):
                setattr(self, name, getattr(params, name).float())
        for name in ("encoder", "shared_attn"):
            if hasattr(params, name):
                setattr(self, name, copy.deepcopy(getattr(params, name)).float())
        self.segs = [[_UpcastRep(torch, rep, cfg32) for rep in seg] for seg in params.segs]


def phase_lm(torch, tag: str, arch: str, expect: dict, kernels: dict,
             prompt: int = LM_PROMPT, overrides=None) -> dict:
    """One LM main path: prefill then greedy decode at full width (and
    depth unless ``overrides`` cut it), every kernel's launches counted.
    ``kernels`` maps a kernel's name to (its ops module, its launches
    per prefill).  The prompts are ``prompt`` seeded tokens a sequence,
    with seeded frames for an encoder-decoder and a seeded image prefix
    for a VLM."""
    from repro_torch.configs import SHAPES, ShapeSpec
    from repro_torch.launch.steps import cell_config, make_prefill_step, make_serve_step
    from repro_torch.models import init_params

    cfg = cell_config(arch, "prefill_32k", **(overrides or {}))
    got = {k: getattr(cfg, k) for k in expect}
    assert got == expect and cfg.dtype == "bfloat16" and cfg.use_flash, (arch, got)
    full = SHAPES["prefill_32k"]
    n_img = cfg.n_img_tokens
    shape = ShapeSpec(f"{full.name} cut to {LM_BATCH}x{prompt}",
                      n_img + prompt + LM_NEW, LM_BATCH, "prefill")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if set(cfg.pattern) <= {"A", "D"} and not cfg.enc_dec:
        # param_count() is exact for attention blocks (the M/R counts are
        # its own approximations) and leaves out the final norm and a
        # VLM's image norm
        assert n_params == cfg.param_count() + cfg.d_model * (1 + bool(n_img)), (
            n_params, cfg.param_count())
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, prompt), device=DEVICE,
                           generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens}
    if cfg.enc_dec:
        batch["enc_frames"] = torch.randn(LM_BATCH, cfg.enc_seq, cfg.d_model, device=DEVICE,
                                          generator=gen).to(cfg.tdtype)
    if n_img:
        batch["img_emb"] = torch.randn(LM_BATCH, n_img, cfg.d_model, device=DEVICE,
                                       generator=gen).to(cfg.tdtype)
    prefill_step = make_prefill_step(cfg, shape)
    serve_step = make_serve_step(cfg)
    prefill_step(params, dict(batch, tokens=tokens[:, :512]))  # warm-up: cuBLAS set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for mod, _ in kernels.values():
        mod.reset_launches()
    with FlashShapes() as shapes:
        t0 = time.perf_counter()
        last, state = prefill_step(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    n_prefill = {name: mod.launches[name] for name, (mod, _) in kernels.items()}
    toks = [last.argmax(-1).to(torch.int32)]
    step_s = []
    for _ in range(LM_NEW):
        t0 = time.perf_counter()
        nxt, state = serve_step(params, state, toks[-1])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        toks.append(nxt)
    n_decode = {name: mod.launches[name] - n_prefill[name]
                for name, (mod, _) in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    for name, (_, per_prefill) in kernels.items():
        assert n_prefill[name] == per_prefill, f"prefill launched {name} {n_prefill[name]} times"
        assert n_decode[name] == 0, f"decode launched {name} {n_decode[name]} times"
    if "flash_attention" in kernels:
        assert sum(shapes.calls.values()) == n_prefill["flash_attention"], shapes.calls
    assert last.shape == (LM_BATCH, cfg.vocab_size) and torch.isfinite(last).all()
    assert state.pos.tolist() == [n_img + prompt + LM_NEW] * LM_BATCH
    # the device memory the decode state holds: its tensors' storages, so
    # that a view into a larger activation counts the whole activation
    held = [t for rep in state.segs for blocks in rep for blk in blocks.values()
            for v in blk.values() for t in (v.values() if isinstance(v, dict) else (v,))]
    if state.enc_out is not None:
        held.append(state.enc_out)
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in held}
    state_bytes = sum(storages.values())
    step_ms = statistics.median(step_s) * 1e3
    n_tok = LM_BATCH * (n_img + prompt)
    log(f"[{tag}] LM main path: {arch} full width, {cfg.n_layers} layers "
        f"{cfg.pattern[:6]}...{' + ' + str(cfg.n_enc_layers) + ' encoder layers' if cfg.enc_dec else ''} "
        f"({n_params / 1e9:.3f} B params, bf16, seed 0; init {init_s:.2f} s), {LM_BATCH} "
        f"prompts x {prompt} tokens{f' after {n_img} image embeddings' if n_img else ''}"
        f"{f' beside {cfg.enc_seq} encoder frames' if cfg.enc_dec else ''}, max_len "
        f"{shape.seq_len}, then {LM_NEW} greedy steps")
    log(f"    prefill {prefill_s:.3f} s ({n_tok / prefill_s:.0f} tokens/s); launches in "
        f"prefill {n_prefill}, in decode {n_decode}; flash calls by (Sq, Sk, H, KV, d, "
        f"causal): {dict(shapes.calls)}")
    log(f"    decode median {step_ms:.2f} ms/step (min {min(step_s) * 1e3:.2f}, max "
        f"{max(step_s) * 1e3:.2f}), {LM_BATCH / (step_ms / 1e3):.1f} tokens/s at "
        f"batch {LM_BATCH}; decode state (caches, recurrent states) "
        f"{state_bytes / 1e9:.3f} GB; peak device memory {peak / 1e9:.2f} GB; "
        f"logits finite")
    log(f"    greedy tokens, sequence 0: {[int(t[0]) for t in toks]}")
    profile_device(torch, "one prefill", lambda: prefill_step(params, batch))
    dev_ms = profile_device(torch, "one decode step",
                            lambda: serve_step(params, state, toks[-1]))
    if dev_ms:
        log(f"    decode: device busy {dev_ms:.2f} ms of a {step_ms:.2f} ms median "
            f"step, idle share {1 - dev_ms / step_ms:.3f}")
    if "E" in cfg.pattern:
        # at decode's batch every expert runs over a capacity of 1, so a
        # block reads all its experts' weights: one block by CUDA events
        from repro_torch.models.moe import MoE, moe_apply

        moe = next(m for m in params.modules() if isinstance(m, MoE))
        experts = sum(t.numel() * t.element_size() for t in (moe.w_gate, moe.w_in, moe.w_out))
        x1 = torch.randn(LM_BATCH, 1, cfg.d_model, device=DEVICE, generator=gen).to(cfg.tdtype)
        moe_ms = cuda_ms(lambda: moe_apply(cfg, moe, x1), reps=10)
        floor_ms = experts / HBM_BYTES_PER_S * 1e3
        n_moe = cfg.pattern.count("E")
        log(f"    decode: one E block's moe_apply at batch {LM_BATCH} by CUDA events "
            f"{moe_ms:.3f} ms for its experts' {experts / 1e9:.2f} GB ({experts / moe_ms / 1e9:.2f} "
            f"TB/s; at least {floor_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); x "
            f"{n_moe} blocks = {moe_ms * n_moe:.2f} ms of a {step_ms:.2f} ms step")
        assert moe_ms >= floor_ms, (moe_ms, floor_ms)
    if cfg.attn_impl == "mla":
        # MLA's prefill: the reference's absorbed f32 form into a fresh
        # latent cache, no kernel; one block's call by CUDA events
        from repro_torch.models.attention import MLA, mla_attention

        mla = next(m for m in params.modules() if isinstance(m, MLA))
        h = torch.randn(LM_BATCH, prompt, cfg.d_model, device=DEVICE, generator=gen).to(cfg.tdtype)
        ckv = torch.zeros(LM_BATCH, shape.seq_len, cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                          dtype=cfg.tdtype, device=DEVICE)
        at0 = torch.zeros(LM_BATCH, dtype=torch.int32, device=DEVICE)
        pos = torch.arange(prompt, device=DEVICE).expand(LM_BATCH, prompt)
        mla_ms = cuda_ms(lambda: mla_attention(cfg, mla, h, positions=pos, cache={"ckv": ckv},
                                               cache_pos=at0), reps=5, warmup=1)
        log(f"    prefill: one block's mla_attention (the torch route, absorbed f32) by CUDA "
            f"events {mla_ms:.2f} ms; x {cfg.n_layers} blocks = {mla_ms * cfg.n_layers:.1f} ms "
            f"of a {prefill_s * 1e3:.1f} ms prefill")
        del h, ckv
    return dict(cfg=cfg, shape=shape, params=params, batch=batch, toks=toks, peak=peak,
                prefill_s=prefill_s,
                launches=n_prefill, arch=arch, flash_shapes=dict(shapes.calls))


def teacher_forced(torch, cfg, params, batch, toks, max_len, routes=None) -> list:
    """Prefill's last logits, then the logits of a decode step fed each
    token of ``toks`` but the last, as f32.  ``routes``, when given, gets
    per logits row set the kept experts of those rows (``RouteLog``), one
    [B, K] a MoE layer."""
    from repro_torch.models import decode_step, prefill

    B = batch["tokens"].shape[0]
    with RouteLog() as rl:
        last, st = prefill(cfg, params, batch, max_len)
    outs = [last.float()]
    if routes is not None:  # the last row of each sequence gives the logits
        routes.append([c.reshape(B, -1, c.shape[-1])[:, -1] for c in rl.calls])
    for t in toks[:-1]:
        rl.calls.clear()
        with rl:
            lg, st = decode_step(cfg, params, t, st)
        assert torch.isfinite(lg).all()
        outs.append(lg.float())
        if routes is not None:
            routes.append(list(rl.calls))
    return outs


def flipped_rows(ra, rb) -> list:
    """Per logits row set of two ``teacher_forced`` runs: the rows [B]
    whose kept experts differ in some MoE layer."""
    return [functools.reduce(operator.or_, (route_diff(a, b)[0]
                                            for a, b in zip(la, lb, strict=True)))
            for la, lb in zip(ra, rb, strict=True)]


def held_err(a, b, flip, rel: bool = True) -> float:
    """max |a - b| over the rows that ``flip`` (None: no MoE) leaves,
    over max |b| when ``rel``; fails when ``flip`` leaves no row."""
    if flip is not None:
        assert not bool(flip.all()), f"every row of a logits step flipped: {flip.tolist()}"
        a, b = a[~flip], b[~flip]
    e = max_abs_err(a, b)
    return e / float(b.double().abs().max()) if rel else e


def count_flips(flips) -> int:
    return sum(int(f.sum()) for f in flips if f is not None)


def assert_few_flips(flips, what: str) -> None:
    rows = sum(f.numel() for f in flips if f is not None)
    assert count_flips(flips) <= MOE_LOGIT_FLIP_SHARE * rows, (what, count_flips(flips), rows)


def phase_lm_agreement(torch, tag: str, lm: dict, f32_kw: dict) -> None:
    """The kernel path (``use_flash=True``) against the torch twins
    (``use_flash=False``) on the same prompts, decode teacher-forced on the
    greedy tokens: in bf16 at the path's depth, beside the twins in f32 on
    the same weights (each block upcast when reached, ``Upcast``) as the
    yardstick of the model's own bf16 noise; then in f32 at full width
    with the layers ``f32_kw`` keeps.  For an MoE model a logits row whose
    own token routes to other experts in some layer on the two runs
    compared (a near-tie flipped by rounding) is left out of that
    comparison, counted, and printed."""
    from repro_torch.models import init_params

    cfg, params, batch, toks = lm["cfg"], lm["params"], lm["batch"], lm["toks"]
    max_len = lm["shape"].seq_len
    moe = "E" in cfg.pattern
    torch.cuda.reset_peak_memory_stats()
    rk, rt, rx = [], [], []
    kern = teacher_forced(torch, cfg, params, batch, toks, max_len, rk)
    twin = teacher_forced(torch, cfg.replace(use_flash=False), params, batch, toks, max_len, rt)
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32", use_flash=False)
    exact = teacher_forced(torch, cfg32, Upcast(torch, params, cfg32), batch, toks, max_len, rx)
    del params, lm["params"]
    torch.cuda.empty_cache()
    none = [None] * len(kern)
    f_kt, f_kx, f_tx = ((flipped_rows(a, b) if moe else none)
                        for a, b in ((rk, rt), (rk, rx), (rt, rx)))
    k_t = [held_err(a, b, f) for a, b, f in zip(kern, twin, f_kt)]
    k_x = [held_err(a, b, f) for a, b, f in zip(kern, exact, f_kx)]
    t_x = [held_err(a, b, f) for a, b, f in zip(twin, exact, f_tx)]
    same = sum(bool((a.argmax(-1) == b.argmax(-1)).all()) for a, b in zip(kern, twin))
    # the danube tolerance, or half again the twins' own distance from f32
    # where the model amplifies bf16 rounding beyond it
    tol = max(LM_BF16_REL_TOL, LM_NOISE_FACTOR * max(t_x))
    assert max(k_t) <= tol and max(k_x) <= tol, (k_t, k_x, t_x)
    log(f"[{tag}] {lm['arch']}: kernels vs torch twins, bf16, {cfg.n_layers} layers, "
        f"max |logit diff| / max |logit| over prefill + {len(toks) - 1} teacher-forced "
        f"steps: {max(k_t):.4f} (tol {tol:.4f} = max({LM_BF16_REL_TOL}, "
        f"{LM_NOISE_FACTOR} x the twins' distance from f32)); from the f32 twins: "
        f"kernels {max(k_x):.4f}, twins {max(t_x):.4f}; greedy tokens agree at "
        f"{same}/{len(kern)} positions; per step {[round(e, 4) for e in k_t]}")
    if moe:
        n_rows = len(kern) * LM_BATCH
        log(f"    MoE routing flips (logits rows whose own token routes to other experts "
            f"in some layer, left out of the comparison) of {n_rows} rows: kernels vs "
            f"twins {count_flips(f_kt)}, kernels vs f32 {count_flips(f_kx)}, twins vs "
            f"f32 {count_flips(f_tx)}")
        for f, what in ((f_kt, "kernels vs twins"), (f_kx, "kernels vs f32"),
                        (f_tx, "twins vs f32")):
            assert_few_flips(f, what)

    cfg32 = cfg32.replace(use_flash=True, **f32_kw)
    p32 = init_params(cfg32, seed=0, device=DEVICE)
    rk, rt = [], []
    kern = teacher_forced(torch, cfg32, p32, batch, toks[:5], max_len, rk)
    twin = teacher_forced(torch, cfg32.replace(use_flash=False), p32, batch, toks[:5],
                          max_len, rt)
    f_kt = flipped_rows(rk, rt) if moe else [None] * len(kern)
    errs = [held_err(a, b, f, rel=False) for a, b, f in zip(kern, twin, f_kt)]
    assert max(errs) <= LM_F32_ABS_TOL, errs
    if moe:
        assert_few_flips(f_kt, "f32 kernels vs twins")
    log(f"    f32, full width, {cfg32.n_layers} layers ({cfg32.pattern}): max |logit "
        f"diff| {max(errs):.3g} (tol {LM_F32_ABS_TOL}; max |logit| "
        f"{float(twin[0].abs().max()):.3f}) over prefill + 4 teacher-forced steps"
        f"{f'; MoE flips {count_flips(f_kt)} of {len(kern) * LM_BATCH} rows' if moe else ''}"
        f"; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del p32
    torch.cuda.empty_cache()


# the per-layer check's floor on the row-normalised error of a block's
# update (fa.bf16_rel_err): fa.BF16_REL_TOL, four times the largest
# relative rounding error of one bf16 value
LAYER_FLOOR = 2.0 ** -6


def layer_update_errors(torch, cfg, params, batch, *, fresh_state: bool = False,
                        routes=None) -> list:
    """Teacher-forced, per block: the bf16 twin's prefill (``use_flash``
    False) runs through the trunk one block at a time (an encoder's
    blocks first), and each block's input x_i goes to that block with
    the kernels (``use_flash`` True; with ``fresh_state`` into a fresh
    decode state, as prefill runs it: MLA's absorbed form), to the bf16
    twin, and to the twin with the block's weights upcast to f32 (one
    block at a time).  Compares the blocks' updates y - x_i, not y, whose
    residual stream would hide a wrong kernel.  Returns ``(index,
    letter, err(kernels, f32), err(twin, f32))`` per block, by
    ``bf16_rel_err`` (row-normalised) over the whole [B, S, d_model]; of
    an MoE block each route's over the token rows whose kept experts
    agree with the f32 block's (the others, near-ties flipped by
    rounding, are counted into ``routes`` when given, one dict a block)."""
    import copy

    from repro_torch.kernels.flash_attention import bf16_rel_err
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import (
        _apply_block,
        _embed_inputs,
        _enc_block,
        _enc_input,
        make_decode_state,
        plan_segments,
    )

    twin, kern = cfg.replace(use_flash=False), cfg.replace(use_flash=True)
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32", use_flash=False)
    shared = getattr(params, "shared_attn", None)
    shared32 = None if shared is None else copy.deepcopy(shared).float()
    out = []

    def record(letter, x, y_k, y_t, u32, held_k=None, held_t=None):
        x32 = x.float()
        d_k, d_t = y_k.float() - x32, y_t.float() - x32
        e_k = (bf16_rel_err(d_k, u32) if held_k is None
               else bf16_rel_err(d_k[held_k], u32[held_k]))
        e_t = (bf16_rel_err(d_t, u32) if held_t is None
               else bf16_rel_err(d_t[held_t], u32[held_t]))
        out.append((len(out), letter, e_k, e_t))

    with torch.no_grad():
        x, pos = _embed_inputs(twin, params, batch)
        enc_out = enc_out32 = None
        if cfg.enc_dec:
            h = _enc_input(twin, batch["enc_frames"])
            enc32 = cfg32.replace(enc_dec=False)
            for p in params.encoder.blocks:
                y_t, y_k = _enc_block(twin, p, h), _enc_block(kern, p, h)
                p32 = upcast_block(torch, p, enc32, "A")
                record("enc", h, y_k, y_t, _enc_block(cfg32, p32, h.float()) - h.float())
                del p32
                h = y_t
            enc_out = rmsnorm(h, params.encoder.norm)
            enc_out32 = enc_out.float()
        B = x.shape[0]
        state = make_decode_state(kern, B, x.shape[1], device=x.device) if fresh_state else None
        kw = dict(pos=pos, st=None, cache_pos=None, fresh=False)
        for si, seg in enumerate(plan_segments(cfg)):
            for r in range(seg.reps):
                for j, letter in enumerate(seg.body):
                    key = f"{j}{letter}"
                    p = params.segs[si][r][key]
                    kw_k = kw if state is None else dict(
                        pos=pos, st=state.segs[si][r][key], fresh=True,
                        cache_pos=torch.zeros(B, dtype=torch.int32, device=x.device))
                    with RouteLog() as rl_t:
                        y_t = _apply_block(twin, letter, p, x, shared=shared,
                                           enc_out=enc_out, **kw)[0]
                    with RouteLog() as rl_k:
                        y_k = _apply_block(kern, letter, p, x, shared=shared,
                                           enc_out=enc_out, **kw_k)[0]
                    p32 = upcast_block(torch, p, cfg32, letter)
                    x32 = x.float()
                    with RouteLog() as rl_x:
                        u32 = _apply_block(cfg32, letter, p32, x32, shared=shared32,
                                           enc_out=enc_out32, **kw)[0] - x32
                    del p32, x32
                    held_k = held_t = None
                    if rl_x.calls:  # an MoE block: the rows routed as in f32 are held
                        (a,), (b,), (c,) = rl_k.calls, rl_t.calls, rl_x.calls
                        f_k, p_k = route_diff(a, c)
                        f_t, p_t = route_diff(b, c)
                        held_k, held_t = ~f_k.reshape(x.shape[:2]), ~f_t.reshape(x.shape[:2])
                        if routes is not None:
                            routes.append(dict(
                                block=len(out), pairs=a.numel(), kern_f32=p_k, twin_f32=p_t,
                                kern_twin=route_diff(a, b)[1], rows=f_k.numel(),
                                held=(int(held_k.sum()), int(held_t.sum()))))
                    record(letter, x, y_k, y_t, u32, held_k, held_t)
                    del y_k, u32
                    x = y_t
    return out


def layer_bound(err_twin: float) -> float:
    """A block's kernels may be off the f32 update by the floor, or by
    half again the twin's own error where that is larger."""
    return max(LAYER_FLOOR, LM_NOISE_FACTOR * err_twin)


def layers_within_bound(errs) -> bool:
    return all(e_k <= layer_bound(e_t) for _, _, e_k, e_t in errs)


def phase_layer_check(torch, tag: str, lm: dict, fresh_state: bool = False) -> None:
    """The per-layer check at full width and depth on the path's prompts
    (``layer_update_errors``), asserted on every block; prints the worst
    block, by its margin to the bound, and each MoE block's routing flips."""
    torch.cuda.reset_peak_memory_stats()
    routes = []
    errs = layer_update_errors(torch, lm["cfg"], lm["params"], lm["batch"],
                               fresh_state=fresh_state, routes=routes)
    i, letter, e_k, e_t = max(errs, key=lambda e: e[2] / layer_bound(e[3]))
    kern = "prefill's route (fresh state)" if fresh_state else "kernels"
    log(f"[{tag}] {lm['arch']}: per-layer check, {len(errs)} blocks teacher-forced on the "
        f"bf16 twin's activations, update y - x against the block in f32, "
        f"bf16_rel_err: worst block {i} ({letter}) {kern} {e_k:.4g}, twin {e_t:.4g}, "
        f"bound {layer_bound(e_t):.4g} = max({LAYER_FLOOR:.4g}, {LM_NOISE_FACTOR} x twin); "
        f"largest {kern} error {max(e[2] for e in errs):.4g}, twin "
        f"{max(e[3] for e in errs):.4g}")
    if routes:
        log(f"    MoE routing flips per E block, (token, choice) pairs routed differently "
            f"of {routes[0]['pairs']}: bf16 {kern} vs f32 "
            f"{[r['kern_f32'] for r in routes]}; bf16 twin vs f32 "
            f"{[r['twin_f32'] for r in routes]}; {kern} vs twin "
            f"{[r['kern_twin'] for r in routes]}; token rows measured ({kern}, twin: "
            f"kept experts as in f32) {[r['held'] for r in routes]} of {routes[0]['rows']}")
        assert all(min(r["held"]) >= (1 - MOE_FLIP_SHARE) * r["rows"] for r in routes), routes
    log(f"    peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    assert layers_within_bound(errs), [e for e in errs if e[2] > layer_bound(e[3])]
    torch.cuda.empty_cache()


def valid_pairs(B: int, Sq: int, Sk: int, H: int, causal: bool, window) -> int:
    """(query, key) pairs an attention keeps: key j for query i when
    j <= i if causal and i - j < window if windowed."""
    from repro_torch.kernels.flash_attention.ops import kept_pairs

    return kept_pairs(Sq, Sk, Sk, causal, window) * B * H


def phase_flash_times(fa, torch, gen, tag: str, path: str, launches: int, err: dict) -> dict:
    """The bf16 (wgmma) flash kernel at one LM path's shape beside its
    bound, its plain version and one SDPA call: with a band mask and
    ``enable_gqa`` where the path has a window (h2o-danube), with
    ``is_causal=True`` where it is causal without one, with no mask
    where it is not causal (whisper's encoder and cross-attention);
    ``enable_gqa`` where the heads are grouped."""
    import torch.nn.functional as F

    B, Sq, Sk, H, KV, d, causal, W = FLASH_PATHS[path]
    q, k, v = flash_inputs(torch, gen, B, Sq, Sk, H, KV, d, torch.bfloat16)
    kw = dict(causal=causal, window=W)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = dict(enable_gqa=True) if H != KV else {}
    if W is not None:
        assert causal and Sq == Sk
        i = torch.arange(Sq, device=DEVICE)
        sdpa["attn_mask"] = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)
        lib_name = "band mask"
    elif causal:
        assert Sq == Sk
        sdpa["is_causal"] = True
        lib_name = "is_causal=True"
    else:
        lib_name = "no mask"
    lib_name += ", enable_gqa" if H != KV else ""

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, **sdpa)

    lib_err = max_abs_err(library().transpose(1, 2), fa.flash_attention(q, k, v, **kw))
    # the kernel and the library call in alternating rounds
    ms, library_ms = cuda_ms_alternating(
        [lambda: fa.flash_attention(q, k, v, **kw), library], reps=10)
    pairs = valid_pairs(B, Sq, Sk, H, causal, W)
    flops = 4 * d * pairs  # q.k and p.v: 2 d multiply-adds per kept pair
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # bf16 q, k, v, out
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    what = (f"window {W}" if W else "causal, no window") if causal else "not causal"
    log(f"[{tag}] flash_attention q [{B}, {Sq}, {H}, {d}], k/v [{B}, {Sk}, {KV}, {d}], "
        f"{what}, bf16 (the {path} path's shape; {launches} launches over its prefill): "
        f"kernel {ms:.3f} ms | bound "
        f"{bound_ms:.4f} ms ({pairs / 1e9:.3f} G kept pairs x {4 * d} flop at 989 "
        f"TFLOP/s; bytes {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) | plain {plain_ms:.3f} ms | "
        f"yardstick F.scaled_dot_product_attention, {lib_name} (not used by the "
        f"port; timed in rounds alternating with the kernel) {library_ms:.3f} ms, "
        f"|diff| {lib_err:.3g} | "
        f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s on kept pairs, "
        f"{100 * bound_ms / ms:.1f}% of the bound")
    return dict(
        name=f"flash_attention_wgmma[{path}]", route="cuda", source=FLASH_CU,
        replaces="src/repro/kernels/flash_attention/kernel.py:100",
        launches=launches, max_abs_err=err[path], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by="operations" if flops / BF16_FLOP_PER_S
        >= nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=library_ms,
    )


def phase_recurrent_times(ssd, wkv, torch, gen, launches: dict, err: dict) -> list:
    """The SSD scan and wkv kernels at their paths' shapes and dtypes (bf16
    activations, f32 dt / decay, zero initial state as a fresh prefill
    passes it), beside their bounds and plain versions.  No single
    PyTorch call computes either recurrence, so neither has a library
    time."""
    records = []
    b, s, h, p, n = SSD_PATH
    # the build of the path's instance: n 64, cp.async loads
    for entry, regs, spill_st, spill_ld in ptxas_report(ssd.load().log,
                                                        "ssd_scan_tc_kernelILi64ELb1E"):
        log(f"[14] ptxas, ssd_scan_tc_kernel<64, async> ({entry}): {regs} registers, "
            f"{spill_st} bytes spill stores, {spill_ld} bytes spill loads")
    x, dt, A, B, C, _ = ssd_inputs(torch, gen, b, s, h, p, n, torch.bfloat16, False)
    s0 = torch.zeros(b, h, p, n, device=DEVICE)
    ms = cuda_ms(lambda: ssd.ssd_scan(x, dt, A, B, C, s0))
    plain_ms = cuda_ms(lambda: ssd.ssd_scan_plain(x, dt, A, B, C, s0), reps=2, warmup=1)
    outs = ssd.ssd_scan(x, dt, A, B, C, s0)
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, A, B, C, s0, *outs))
    flops = 4 * b * s * h * p * n  # state update and output: 2 multiply-adds an entry
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    records.append(dict(
        name="ssd_scan_tc", route="cuda", source=SSD_CU,
        replaces="src/repro/kernels/mamba2_scan/kernel.py:94",
        launches=launches["ssd_scan_tc"], max_abs_err=err[("ssd_scan", "bfloat16")],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
        else "operations", library_ms=None,
    ))
    log(f"[14] ssd_scan x [{b}, {s}, {h}, {p}] n {n}, bf16 x/B/C, f32 dt/A/state "
        f"(the tensor-core kernel; {launches['ssd_scan_tc']} launches over zamba2's prefill): "
        f"kernel {ms:.3f} ms | bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"3.35 TB/s; {flops / 1e9:.1f} GFLOP = {flops / BF16_FLOP_PER_S * 1e3:.4f} ms "
        f"at 989 TFLOP/s, {flops / 67e12 * 1e3:.4f} ms at the 67 TFLOP/s f32 rate) | "
        f"plain {plain_ms:.1f} ms | library: none (no single PyTorch call computes "
        f"the scan) | {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")
    del x, dt, A, B, C, s0, outs
    B_, T, H, N = WKV_PATH
    r, k, v, w, u, _ = wkv_inputs(torch, gen, B_, T, H, N, torch.bfloat16, False)
    s0 = torch.zeros(B_, H, N, N, device=DEVICE)
    r32, k32, v32 = r.float(), k.float(), v.float()
    # the two routes in alternating rounds: bf16 on the tensor-core kernel,
    # f32 (the same values) on the FMA kernel
    ms, ms_simt = cuda_ms_alternating([lambda: wkv.wkv6(r, k, v, w, u, s0),
                                       lambda: wkv.wkv6(r32, k32, v32, w, u, s0)])
    plain_ms = cuda_ms(lambda: wkv.wkv6_plain(r, k, v, w, u, s0), reps=2, warmup=1)
    outs = wkv.wkv6(r, k, v, w, u, s0)
    nbytes = sum(t.numel() * t.element_size() for t in (r, k, v, w, u, s0, *outs))
    nbytes32 = nbytes + 2 * (r.numel() * 3 + outs[0].numel())  # f32 r/k/v and y
    flops = 4 * B_ * T * H * N * N
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    records.append(dict(
        name="wkv6_tc", route="cuda", source=WKV_CU,
        replaces="src/repro/kernels/rwkv6_wkv/kernel.py:88",
        launches=launches["wkv6_tc"], max_abs_err=err[("wkv6", "bfloat16")],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S
        else "operations", library_ms=None,
    ))
    log(f"[14] wkv6 r/k/v [{B_}, {T}, {H}, {N}] bf16, f32 w/u/state (the tensor-core "
        f"kernel; {launches['wkv6_tc']} launches over rwkv6's prefill): kernel {ms:.3f} ms "
        f"| bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s; "
        f"{flops / 1e9:.1f} GFLOP = {flops / BF16_FLOP_PER_S * 1e3:.4f} ms at 989 "
        f"TFLOP/s, {flops / 67e12 * 1e3:.4f} ms at the 67 TFLOP/s f32 rate) | plain "
        f"{plain_ms:.1f} ms | library: none (no single PyTorch call computes the "
        f"recurrence) | {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s | bf16_rel_err "
        f"{err[('wkv6', 'bf16_rel')]:.4g} (phase 2)")
    log(f"[14] wkv6 the same values in f32 (the FMA kernel, timed in rounds alternating "
        f"with the tensor-core kernel): {ms_simt:.3f} ms | bound "
        f"{nbytes32 / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes32 / 1e6:.1f} MB)")
    return records


# the train phase: h2o-danube-3-4b at full width and depth (DANUBE), bf16
# parameters, f32 AdamW moments, remat on, 1 microbatch; train_4k's
# sequence of 4096 at a global batch of TRAIN_BATCH, cut from 256 to fit
# one card; TokenPipeline batches from seed 0; one warm-up step, then
# TRAIN_STEPS timed steps, then one more under the profiler
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 4
# (a) bf16 against f32 on the same batch and weights, 2 layers at full width
TRAIN_LOSS_REL, TRAIN_GNORM_REL, TRAIN_GRAD_COS = 1e-2, 5e-2, 0.99


def train_grads(torch, cfg, params, batch):
    """One train step of ``params`` on ``batch``; returns (metrics, the
    gradients by parameter name as the optimizer received them)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW

    seen = {}
    opt = AdamW(lr=1e-4, grad_transform=lambda g: seen.setdefault("g", g))
    _, _, m = make_train_step(cfg, opt)(params, opt.init(params), batch)
    return m, seen["g"]


def danube_training(torch, n_total: int):
    """The train phase's set-up: h2o-danube-3-4b (DANUBE) at full size on
    the card, AdamW over ``n_total`` steps, ``TokenPipeline`` batches of
    TRAIN_BATCH x TRAIN_SEQ tokens from seed 0.  Returns (cfg, params,
    opt_state, step_fn, pipe)."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import cell_config, make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW, linear_warmup_cosine

    arch, expect = DANUBE
    cfg = cell_config(arch, "train_4k").replace(microbatches=1)
    assert {k: getattr(cfg, k) for k in expect} == expect, cfg
    assert cfg.remat and cfg.param_dtype == "bfloat16" and cfg.opt_state_dtype == "float32"
    params = init_params(cfg, seed=0, device=DEVICE)
    opt = AdamW(lr=linear_warmup_cosine(1e-4, warmup=2, total_steps=n_total),
                moment_dtype=cfg.opt_state_dtype)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    return cfg, params, opt.init(params), make_train_step(cfg, opt), pipe


def phase_train(torch, card: str, tag: str = "T") -> dict:
    """The training path at full size, then (a) bf16 against f32 and (b)
    an exact resume on the card.  Returns its measurements."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_to_device, train_state_tree
    from repro_torch.models import init_params
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, linear_warmup_cosine

    arch = DANUBE[0]
    seq = TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, opt_state, step_fn, pipe = danube_training(torch, 1 + TRAIN_STEPS + 1)
    n_params = sum(p.numel() for p in params.parameters())
    tokens = TRAIN_BATCH * seq
    for mod in (fa, ssd, wkv):
        mod.reset_launches()
    rows = []
    for step in range(1 + TRAIN_STEPS):
        batch = batch_to_device(cfg, pipe.batch_at(step), DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        row = dict(step=step, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   lr=float(m["lr"]), s=dt, tokens_per_s=tokens / dt,
                   mfu=6 * n_params * tokens / dt / BF16_FLOP_PER_S)
        rows.append(row)
        log(f"[{tag}] step {step}{' (warm-up)' if step == 0 else ''}: loss {row['loss']:.4f} "
            f"grad_norm {row['grad_norm']:.4f} lr {row['lr']:.3e} | {dt:.3f} s, "
            f"{row['tokens_per_s']:.0f} tokens/s, model-flops share {row['mfu']:.4f}")
        assert np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"]), row
    timed = rows[1:]
    step_s = statistics.median(r["s"] for r in timed)
    peak = torch.cuda.max_memory_allocated()
    kernel_launches = {k: v for mod in (fa, ssd, wkv) for k, v in mod.launches.items()}
    assert not any(kernel_launches.values()), kernel_launches
    batch = batch_to_device(cfg, pipe.batch_at(1 + TRAIN_STEPS), DEVICE)
    holder = {}

    def profiled_step():
        holder["out"] = step_fn(params, opt_state, batch)

    dev_ms = profile_device(torch, "one train step", profiled_step)
    params, opt_state, m = holder.pop("out")
    assert np.isfinite(float(m["loss"])), m
    flops = 6 * n_params * tokens
    log(f"[{tag}] {arch} training at full width and depth ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters in bf16, f32 AdamW moments, remat "
        f"on, 1 microbatch): train_4k cut to {TRAIN_BATCH} x {seq} tokens a step; "
        f"median of {TRAIN_STEPS} steps {step_s:.3f} s, {tokens / step_s:.0f} tokens/s, "
        f"train_model_flops_share {flops / step_s / BF16_FLOP_PER_S:.4f} (6 N tokens = "
        f"{flops:.3e} FLOP at 989 TFLOP/s; the bound with remat, 8 N tokens, "
        f"{8 * n_params * tokens / BF16_FLOP_PER_S:.3f} s); peak device memory "
        f"{peak / 1e9:.2f} GB; kernel launches {kernel_launches} (the torch twins under "
        f"autograd, as the reference trains through its jnp twins); {card}")
    if dev_ms:
        log(f"[{tag}] one train step: device busy {dev_ms:.1f} ms of a {step_s * 1e3:.1f} ms "
            f"median step, idle share {1 - dev_ms / (step_s * 1e3):.3f}")
    out = dict(step_s=step_s, tokens_per_s=tokens / step_s, peak=peak, rows=rows,
               mfu=flops / step_s / BF16_FLOP_PER_S, dev_ms=dev_ms, n_params=n_params)
    del params, opt_state, step_fn, holder, m, batch
    torch.cuda.empty_cache()

    # (a) bf16 against f32: 2 layers at full width, one step each on the
    # same batch and weights (the f32 model holds the bf16 weights exactly)
    cfg2 = cfg.replace(n_layers=2)
    p16 = init_params(cfg2, seed=1, device=DEVICE)
    cfg32 = cfg2.replace(dtype="float32", param_dtype="float32")
    p32 = Model(cfg32, DEVICE)
    with torch.no_grad():
        for a, b in zip(p32.parameters(), p16.parameters()):
            a.copy_(b)
    batch = batch_to_device(cfg2, pipe.batch_at(0), DEVICE)
    m16, g16 = train_grads(torch, cfg2, p16, batch)
    m32, g32 = train_grads(torch, cfg32, p32, batch)
    loss_rel = abs(float(m16["loss"]) / float(m32["loss"]) - 1)
    gn_rel = abs(float(m16["grad_norm"]) / float(m32["grad_norm"]) - 1)
    cos = {n: float(torch.nn.functional.cosine_similarity(
        g16[n].float().reshape(1, -1), g32[n].reshape(1, -1)))
        for n in g32}
    worst = min(cos, key=cos.get)
    log(f"[{tag}a] the lowest gradient cosines: "
        f"{[(n, round(c, 5)) for n, c in sorted(cos.items(), key=lambda kv: kv[1])[:4]]}")
    log(f"[{tag}a] bf16 against f32, {cfg2.n_layers} layers at full width, one step on the "
        f"same batch and weights: loss {float(m16['loss']):.5f} / {float(m32['loss']):.5f} "
        f"(relative difference {loss_rel:.2e}, tol {TRAIN_LOSS_REL}), grad_norm "
        f"{float(m16['grad_norm']):.4f} / {float(m32['grad_norm']):.4f} ({gn_rel:.2e}, tol "
        f"{TRAIN_GNORM_REL}); worst gradient cosine {cos[worst]:.5f} ({worst}; tol "
        f"{TRAIN_GRAD_COS}) over {len(cos)} leaves")
    assert loss_rel <= TRAIN_LOSS_REL and gn_rel <= TRAIN_GNORM_REL, (loss_rel, gn_rel)
    assert cos[worst] >= TRAIN_GRAD_COS, (worst, cos[worst])
    out.update(loss_rel=loss_rel, gnorm_rel=gn_rel, worst_cos=cos[worst])
    del p16, p32, g16, g32, m16, m32, batch
    torch.cuda.empty_cache()

    # (b) resume on the card, at the reduced size: save after step 2,
    # restore into a fresh model and optimizer, step 3 from both
    rc = get_reduced(arch)
    ropt = AdamW(lr=linear_warmup_cosine(1e-3, warmup=1, total_steps=4))
    rstep = make_train_step(rc, ropt)
    rpipe = TokenPipeline(DataConfig(vocab_size=rc.vocab_size, seq_len=64, global_batch=4))
    rb = [batch_to_device(rc, rpipe.batch_at(i), DEVICE) for i in range(3)]
    model = init_params(rc, seed=0, device=DEVICE)
    st = ropt.init(model)
    for i in range(2):
        model, st, _ = rstep(model, st, rb[i])

    def flat(model, st):
        return {**{f"p.{n}": p.detach().clone() for n, p in model.named_parameters()},
                **{f"mu.{n}": t.clone() for n, t in st.mu.items()},
                **{f"nu.{n}": t.clone() for n, t in st.nu.items()}, "step": st.step.clone()}

    saved = flat(model, st)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(2, train_state_tree(model, st))  # async: on the host before it returns
        twin = init_params(rc, seed=0, device=DEVICE)  # a second uninterrupted run
        twin_st = ropt.init(twin)
        with torch.no_grad():
            for a, b in zip(twin.parameters(), model.parameters()):
                a.copy_(b)
        for n in st.mu:
            twin_st.mu[n].copy_(st.mu[n])
            twin_st.nu[n].copy_(st.nu[n])
        twin_st = twin_st._replace(step=st.step.clone())
        model, st, _ = rstep(model, st, rb[2])  # in place, racing the save
        mgr.wait()
        fresh = init_params(rc, seed=7, device=DEVICE)
        fresh_st = ropt.init(fresh)
        _, step = mgr.restore(train_state_tree(fresh, fresh_st))
    assert step == 2
    restored = flat(fresh, fresh_st)
    bad = [k for k in saved if not torch.equal(saved[k], restored[k])]
    assert not bad, f"restored state differs from the saved one: {bad[:5]}"
    fresh, fresh_st, _ = rstep(fresh, fresh_st, rb[2])
    twin, twin_st, _ = rstep(twin, twin_st, rb[2])
    after, resumed, again = flat(model, st), flat(fresh, fresh_st), flat(twin, twin_st)
    d_resume = max(float((after[k].double() - resumed[k].double()).abs().max()) for k in after)
    d_twin = max(float((after[k].double() - again[k].double()).abs().max()) for k in after)
    log(f"[{tag}b] resume at the reduced size ({rc.n_layers} layers, d_model {rc.d_model}): "
        f"the state saved after step 2 restored into a fresh model and optimizer bit for bit "
        f"({len(saved)} tensors); step 3 from it against the uninterrupted step 3: max "
        f"|diff| {d_resume:.3e}; two uninterrupted runs of step 3: {d_twin:.3e}")
    assert d_resume <= d_twin, (d_resume, d_twin)
    out.update(d_resume=d_resume, d_twin=d_twin)
    del model, st, fresh, fresh_st, twin, twin_st
    torch.cuda.empty_cache()
    return out


# phase C: the paper's collectives on NCCL at world size 1 (one card gives
# NCCL one rank), at the main path's grid and h2o-danube's projection
COLL_X, COLL_W = (LM_BATCH * 4096, 3840), (3840, 10240)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_collectives(torch, ks, card: str) -> None:
    """Phase C: ``repro_torch.comm`` on an NCCL group of one rank on the
    card: ``jacobi_step_sharded`` at 16386² f64 (both overlap modes) bit
    for bit the CUDA ``jacobi_sweep`` and one host-NumPy sweep, timed by
    CUDA events beside the kernel; ``ag_matmul`` and ``matmul_rs`` at
    h2o-danube's MLP projection in bf16 bit for bit ``torch.matmul``;
    ``ring_all_gather``, ``ring_reduce_scatter``, ``halo_exchange``
    (periodic and not) and ``stencil_1d_sharded`` on the grid's rows
    against plain slicing.  The group must start on NCCL: nothing falls
    back to another backend or to the host."""
    import torch.distributed as dist

    from repro_torch.comm import collectives as col

    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        host = numpy_grid(MAIN_N)
        full = torch.from_numpy(host).to(DEVICE)
        want_host = numpy_sweeps(host.copy(), 1)
        kernel = ks.jacobi_sweep(full)
        for overlap in ("ring", "none"):
            with col.record_collectives() as rec:
                got = col.jacobi_step_sharded(full, None, overlap=overlap)
            torch.cuda.synchronize()
            assert got.dtype == torch.float64 and torch.equal(got, kernel), overlap
            assert np.array_equal(got.cpu().numpy(), want_host), overlap
            kinds = [(e, r.kind) if e != "compute" else (e, r) for e, r in rec.events]
            log(f"[C] jacobi_step_sharded {MAIN_N + 2}² f64, overlap {overlap!r}: equal to the "
                f"CUDA jacobi_sweep and to host NumPy bit for bit; events {kinds}")
            del got
        del kernel, want_host, host
        ms = cuda_ms_alternating([lambda: ks.jacobi_sweep(full),
                                  lambda: col.jacobi_step_sharded(full, None, overlap="ring"),
                                  lambda: col.jacobi_step_sharded(full, None, overlap="none")],
                                 reps=5, warmup=1)
        log(f"[C] jacobi at {MAIN_N + 2}² f64 by CUDA events (in alternating rounds): the "
            f"CUDA jacobi_sweep kernel {ms[0]:.3f} ms | jacobi_step_sharded ring "
            f"{ms[1]:.3f} ms, none {ms[2]:.3f} ms (torch ops, one NCCL rank: its halos are "
            f"local copies) | {card}")

        rows = full.shape[1]
        zero = torch.zeros(1, rows, dtype=full.dtype, device=DEVICE)
        assert torch.equal(col.ring_all_gather(full, None), full)
        assert torch.equal(col.ring_reduce_scatter(full, None), full)
        for periodic, want in ((False, (zero, zero)), (True, (full[-1:], full[:1]))):
            got = col.halo_exchange(full, None, periodic=periodic)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), periodic

        def point(left, center, right):
            return 0.25 * left + 0.5 * center + 0.25 * right

        for periodic in (False, True):
            lo, hi = (full[-1:], full[:1]) if periodic else (zero, zero)
            ext = torch.cat([lo, full, hi])
            want = point(ext[:-2], ext[1:-1], ext[2:])
            del ext
            for overlap in ("ring", "none"):
                got = col.stencil_1d_sharded(full, None, point, overlap=overlap,
                                             periodic=periodic)
                assert torch.equal(got, want), (periodic, overlap)
                del got
            del want
        log(f"[C] ring_all_gather, ring_reduce_scatter, halo_exchange (periodic and not) and "
            f"stencil_1d_sharded (both modes, periodic and not) on the grid's "
            f"{MAIN_N + 2} rows: equal to plain slicing")
        del full, zero
        torch.cuda.empty_cache()

        gen = torch.Generator(device=DEVICE).manual_seed(24)
        x = torch.randn(*COLL_X, device=DEVICE, generator=gen).to(torch.bfloat16)
        w = torch.randn(*COLL_W, device=DEVICE, generator=gen).to(torch.bfloat16)
        want = torch.matmul(x, w)
        for overlap in ("ring", "none"):
            assert torch.equal(col.ag_matmul(x, w, None, overlap=overlap), want), overlap
            assert torch.equal(col.matmul_rs(x, w, None, overlap=overlap), want), overlap
        ms = cuda_ms_alternating([lambda: torch.matmul(x, w),
                                  lambda: col.ag_matmul(x, w, None),
                                  lambda: col.matmul_rs(x, w, None)], reps=10)
        log(f"[C] ag_matmul and matmul_rs, x {list(COLL_X)} x w {list(COLL_W)} bf16 (h2o-danube's "
            f"MLP input projection at 2 x 4096 tokens), both modes: equal to torch.matmul bit "
            f"for bit; by CUDA events torch.matmul {ms[0]:.3f} ms, ag_matmul {ms[1]:.3f} ms, "
            f"matmul_rs {ms[2]:.3f} ms | {card}")
        del x, w, want
    finally:
        dist.destroy_process_group()
    log(f"[C] phase C took {time.perf_counter() - t_phase:.1f} s")


# phase D: the dry-run's peak within this of the measured peak
DRYRUN_PEAK_TOL = 0.2


def phase_dryrun(torch, card: str, prefill: dict, train: dict) -> None:
    """Phase D: ``repro_torch.roofline.analyze_step`` of h2o-danube's
    prefill at phase 7's 2 x 8192 and of its train step at phase T's
    2 x 4096 on fake tensors (nothing allocated), beside what those
    phases measured on the card: the counted peak of live bytes within
    DRYRUN_PEAK_TOL of ``torch.cuda.max_memory_allocated``, the counted
    FLOPs beside ``model_flops``, the roofline terms beside the measured
    times."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import (_param_shapes, cell_config, make_optimizer,
                                          make_prefill_step, make_train_step)
    from repro_torch.roofline import analyze_step, model_flops, roofline_terms
    from torch._subclasses.fake_tensor import FakeTensorMode

    t_phase = time.perf_counter()
    arch = DANUBE[0]
    runs = []
    cfg = cell_config(arch, "prefill_32k")
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    params = _param_shapes(cfg, fake)
    with fake:
        tokens = torch.empty((LM_BATCH, LM_PROMPT), dtype=torch.int32)
    shape = ShapeSpec("prefill cut", LM_PROMPT + LM_NEW, LM_BATCH, "prefill")
    runs.append(("prefill", cfg, ShapeSpec("tokens", LM_PROMPT, LM_BATCH, "prefill"),
                 analyze_step(make_prefill_step(cfg, shape), params, {"tokens": tokens}),
                 prefill["peak"], prefill["prefill_s"], "phase 7"))
    cfg = cell_config(arch, "train_4k").replace(microbatches=1)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    params = _param_shapes(cfg, fake)
    opt = make_optimizer(cfg)
    with fake:
        opt_state = opt.init(params)
        batch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32)
                 for k in ("tokens", "labels")}
    runs.append(("train step", cfg, ShapeSpec("tokens", TRAIN_SEQ, TRAIN_BATCH, "train"),
                 analyze_step(make_train_step(cfg, opt), params, opt_state, batch),
                 train["peak"], train["step_s"], "phase T"))
    del params, opt_state, batch, tokens
    for what, cfg, shape, a, peak, seconds, where in runs:
        dry = a["memory"]["peak_size_in_bytes"]
        terms = roofline_terms(a, n_devices=1)
        mf = model_flops(cfg, shape)
        log(f"[D] {arch} {what} at {shape.global_batch} x {shape.seq_len} on fake tensors: "
            f"peak live {dry / 1e9:.3f} GB (arguments {a['memory']['argument_size_in_bytes'] / 1e9:.3f}"
            f" GB) against {peak / 1e9:.3f} GB max_memory_allocated in {where} (ratio "
            f"{dry / peak:.4f}); counted {a['flops']:.4e} FLOP (kernels' "
            f"{a['kernel_flops']:.3e}, launches {a['kernel_launches']}) against model_flops "
            f"{mf:.4e} ({a['flops'] / mf:.3f}x); {a['bytes_accessed'] / 1e9:.1f} GB accessed "
            f"over {a['n_ops']} ops; roofline on HW: compute {terms['t_compute']:.4f} s, memory "
            f"{terms['t_memory']:.4f} s, collective {terms['t_collective']:.4f} s, bound by "
            f"{terms['dominant']} | measured {seconds:.3f} s in {where} | {card}")
        assert abs(dry / peak - 1) <= DRYRUN_PEAK_TOL, (what, dry, peak)
    log(f"[D] phase D took {time.perf_counter() - t_phase:.1f} s")


def phase_build(libs) -> None:
    """Phase 1: the kernel library, the ptxas report and the SASS checks;
    every module of ``libs`` loads that one library."""
    t0 = time.perf_counter()
    from repro_torch.kernels import build

    lib = build.kernel_library()  # one nvcc a source, all started together, one link
    assert all(mod.load() is lib for mod in libs)
    log(f"[1] built {lib.path.name} in {time.perf_counter() - t0:.2f} s (nvcc "
        f"{', '.join(f'{n} {t:.2f} s' for n, t in lib.compile_seconds.items())}, in "
        f"parallel, then one link; {lib.seconds:.2f} s in all)")
    for line in lib.log.splitlines():
        if line.startswith("== ") or any(w in line for w in ("Compiling entry", "registers",
                                                             "spill")):
            log(f"    {line.strip()}")
    sass = sass_counts(lib.path, ("HGMMA", "UTMALDG"), "flash_attention_wgmma_kernel")
    log(f"[1] flash_attention_wgmma_kernel SASS: {sass['HGMMA']} HGMMA (wgmma) and "
        f"{sass['UTMALDG']} UTMALDG (TMA load) instructions")
    assert sass["HGMMA"] > 0 and sass["UTMALDG"] > 0, sass
    sass = sass_counts(lib.path, ("HMMA", "LDGSTS"), "ssd_scan_tc_kernel")
    log(f"[1] ssd_scan_tc_kernel SASS: {sass['HMMA']} HMMA (mma.sync) and {sass['LDGSTS']} "
        f"LDGSTS (cp.async) instructions")
    assert sass["HMMA"] > 0 and sass["LDGSTS"] > 0, sass
    # the wkv kernel's bf16 route loads by the TMA, not cp.async
    sass = sass_counts(lib.path, ("HMMA", "UTMALDG", "LDGSTS"), "wkv6_tc_kernel")
    log(f"[1] wkv6_tc_kernel SASS: {sass['HMMA']} HMMA (mma.sync), {sass['UTMALDG']} UTMALDG "
        f"(TMA load) and {sass['LDGSTS']} LDGSTS (cp.async) instructions")
    assert sass["HMMA"] > 0 and sass["UTMALDG"] > 0, sass
    # the path's instance: head size 64, TMA loads
    for entry, regs, spill_st, spill_ld in ptxas_report(lib.log, "wkv6_tc_kernelILi64ELb1E"):
        log(f"[1] ptxas, wkv6_tc_kernel<64, TMA> ({entry}): {regs} registers, "
            f"{spill_st} bytes spill stores, {spill_ld} bytes spill loads")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import apps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import stencil as ks
    from repro_torch.kernels import stream_gate

    # f32 products in full f32, as the CPU reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"[0] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"numpy {np.__version__} | python {sys.version.split()[0]}")
    phase_build((ks, fa, ssd, wkv, stream_gate))
    phase_profiler_probe()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    err = phase_kernels_vs_plain(ks, torch, gen)
    flash_err = phase_flash_vs_plain(fa, torch, gen)
    rec_err = phase_recurrent_vs_plain(ssd, wkv, fa, torch, gen)
    torch.cuda.empty_cache()
    main_info = phase_main_path(repro_torch, apps, ks)
    paper = phase_paper_regime(repro_torch, apps, ks)
    phase_overlap_probe(repro_torch, apps)
    serve_info = phase_serve(repro_torch, apps, ks)
    phase_verify_trace(repro_torch, apps, paper)
    torch.cuda.empty_cache()
    records = phase_times(ks, torch, gen, main_info, err)
    for rec in records:
        if rec["name"].startswith("stencil5_block"):
            # this slice's path: phase S's concurrent variant, counted from 0
            rec["serve_launches"] = serve_info["launches"]
            rec["serve_fragments"] = serve_info["fragments"]
    torch.cuda.empty_cache()
    phase_collectives(torch, ks, card)
    torch.cuda.empty_cache()
    launches, measured = {}, {}
    # every bf16 flash launch of a prefill goes to the wgmma kernel, every
    # bf16 SSD launch to the tensor-core kernel
    for tags, (arch, expect), kernels, f32_kw in (
        (("7", "8"), DANUBE, {"flash_attention": (fa, 24), "flash_attention_wgmma": (fa, 24)},
         dict(n_layers=2)),
        (("9", "10"), ZAMBA, {"ssd_scan": (ssd, 54), "ssd_scan_tc": (ssd, 54),
                              "flash_attention": (fa, 9),
                              "flash_attention_wgmma": (fa, 9)},
         dict(n_layers=6, layer_pattern="MMMMMH")),
        (("11", "12"), RWKV, {"wkv6": (wkv, 32), "wkv6_tc": (wkv, 32)}, dict(n_layers=2)),
    ):
        lm = phase_lm(torch, tags[0], arch, expect, kernels)
        phase_layer_check(torch, tags[1], lm)
        phase_lm_agreement(torch, tags[1], lm, f32_kw)
        launches[arch] = lm["launches"]
        measured[arch] = dict(peak=lm["peak"], prefill_s=lm["prefill_s"])
        del lm
        torch.cuda.empty_cache()
    for path, arch in (("danube", DANUBE[0]), ("zamba2", ZAMBA[0])):
        records.append(phase_flash_times(fa, torch, gen, "13", path,
                                         launches[arch]["flash_attention_wgmma"], flash_err))
        torch.cuda.empty_cache()
    records += phase_recurrent_times(ssd, wkv, torch, gen, {
        "ssd_scan_tc": launches[ZAMBA[0]]["ssd_scan_tc"],
        "wkv6_tc": launches[RWKV[0]]["wkv6_tc"]}, rec_err)
    torch.cuda.empty_cache()
    # the four families: flash launches a prefill, each on wgmma, by shape
    # (Sq, Sk, H, KV, d, causal); deepseek's MLA and every MoE block run
    # no kernel (the JAX package has none for them)
    P, W, I = FAMILY_PROMPT, WHISPER_PROMPT, 256 + FAMILY_PROMPT
    shapes = {}
    for tags, (arch, expect), by_shape, run in (
        (("15", "15b"), DEEPSEEK, {}, dict(fresh_state=True)),
        (("16", "16b"), GROK, {(P, P, 48, 8, 128, True): GROK_LAYERS},
         dict(overrides=dict(n_layers=GROK_LAYERS), f32_kw=dict(n_layers=1))),
        (("17", "17b"), WHISPER, {(1500, 1500, 12, 12, 64, False): 12,
                                  (W, W, 12, 12, 64, True): 12,
                                  (W, 1500, 12, 12, 64, False): 12},
         dict(prompt=WHISPER_PROMPT, f32_kw={})),
        (("18", "18b"), INTERNVL, {(I, I, 16, 8, 128, True): 24}, dict(f32_kw=dict(n_layers=2))),
    ):
        n = sum(by_shape.values())
        lm = phase_lm(torch, tags[0], arch, expect,
                      {"flash_attention": (fa, n), "flash_attention_wgmma": (fa, n)},
                      prompt=run.get("prompt", FAMILY_PROMPT), overrides=run.get("overrides"))
        assert lm["flash_shapes"] == by_shape, (arch, lm["flash_shapes"])
        shapes.update(lm["flash_shapes"])
        phase_layer_check(torch, tags[1], lm, fresh_state=run.get("fresh_state", False))
        if "f32_kw" in run:
            phase_lm_agreement(torch, tags[1], lm, run["f32_kw"])
        del lm
        torch.cuda.empty_cache()
    for path in ("grok", "internvl2", "whisper_enc", "whisper_cross"):
        B, Sq, Sk, H, KV, d, causal, _ = FLASH_PATHS[path]
        records.append(phase_flash_times(fa, torch, gen, "19", path,
                                         shapes[(Sq, Sk, H, KV, d, causal)], flash_err))
        torch.cuda.empty_cache()
    train = phase_train(torch, card)
    phase_dryrun(torch, card, measured[DANUBE[0]], train)
    checked = CheckedProfile.sessions
    failed = [what for what, ok in checked if not ok]
    log(f"[P] profiler sessions of this run that passed the clock check: "
        f"{len(checked) - len(failed)} of {len(checked)}; failed: {failed}")
    assert not failed, failed
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def probe_main() -> int:
    """``--probe``: phase 1's build, then every case of the profiler
    probe (``PROBE_CASES``)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import stencil as ks
    from repro_torch.kernels import stream_gate

    log(f"[0] {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build((ks, fa, ssd, wkv, stream_gate))
    phase_profiler_probe(PROBE_CASES)
    return 0


def probe_train_main(rounds: int) -> int:
    """``--probe-train [ROUNDS]``: phase 1's build, then ROUNDS pairs of
    profiler sessions over one full-size train step of phase T, each pair
    one session without the host's settle wait and one with
    PROFILER_SETTLE_S; one line a session, then how many of each passed."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as ssd
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import stencil as ks
    from repro_torch.kernels import stream_gate
    from repro_torch.launch.train import batch_to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[0] {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build((ks, fa, ssd, wkv, stream_gate))
    cfg, params, opt_state, step_fn, pipe = danube_training(torch, 1 + 2 * rounds)
    batch = batch_to_device(cfg, pipe.batch_at(0), DEVICE)
    state = [params, opt_state]

    def step():
        state[0], state[1], _ = step_fn(state[0], state[1], batch)

    step()  # warm-up
    torch.cuda.synchronize()
    passed = {0.0: [], PROFILER_SETTLE_S: []}
    for i in range(rounds):
        for settle in passed:
            with CheckedProfile(torch, f"one train step, settle {settle} s", quiet=True,
                                settle_s=settle) as window:
                step()
            passed[settle].append(window.ok)
            log(f"[PT] round {i} settle {settle} s: {'passed' if window.ok else 'FAILED'}; "
                f"spins found {window.spins} of {PROFILER_SPINS}; records {window.records}; primes lost "
                f"{window.lost} of {PROFILER_PRIMES} at the start, {window.lost_tail} at the "
                f"end; clock errors "
                f"{[round(e, 5) for e in window.clock_errors()]}")
    log(f"[PT] sessions over one train step that passed the clock check: "
        + "; ".join(f"settle {k} s: {sum(v)} of {len(v)}" for k, v in passed.items())
        + f"; {card_line()}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) in (2, 3) and sys.argv[1] == "--probe-train":
        sys.exit(probe_train_main(int(sys.argv[2]) if len(sys.argv) == 3 else 6))
    if len(sys.argv) == 3 and sys.argv[1] == "--probe-case":
        sys.exit(probe_case(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == "--probe":
        sys.exit(probe_main())
    sys.exit(main())
