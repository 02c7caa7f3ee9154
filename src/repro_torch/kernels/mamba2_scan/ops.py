"""Wrapper of the hand-written Mamba2 SSD scan kernel, with its plain
version.

``ssd_scan`` checks its inputs, then either launches a CUDA kernel
(``csrc/ssd_scan.cu``) on the current stream — for tensors on a CUDA
device — or runs ``ssd_scan_plain`` — for tensors on the CPU, where no
kernel exists.  On the card the dtype picks the kernel: bf16 x, B, C run
``ssd_scan_tc_kernel`` (the chunked dual form on tensor cores, with
asynchronous chunk loads), f32 ``ssd_scan_simt_kernel`` (the recurrence
token by token on FP32 FMA).  There is no other route: a CUDA tensor
launches its dtype's kernel or raises.  (A dry-run's fake tensor reaches neither:
``repro_torch.kernels.fake_launch``.)

The layout is the JAX wrapper's (``repro.kernels.mamba2_scan``): x
``[b, s, h, p]``, dt ``[b, s, h]``, A ``[h]``, B and C ``[b, s, n]``
(shared by all heads), an initial state ``[b, h, p, n]``.  Unlike that
wrapper nothing is padded: the kernel walks the true ``s``.  There is no
``chunk`` argument: the Pallas kernel's chunk is a VMEM tiling choice,
and the function does not depend on it beyond float rounding.

``launches`` counts kernel launches (plain-version calls are not
launches): ``"ssd_scan"`` every launch, ``"ssd_scan_tc"`` and
``"ssd_scan_simt"`` each route's.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import fake_launch, is_fake, refuse_grad
from repro_torch.kernels.build import BuiltLibrary, kernel_library

__all__ = ["ssd_scan", "ssd_scan_plain", "launches", "reset_launches", "load"]

MAX_STATE = 128  # kMaxState in ssd_scan.cu: the largest n the kernels hold
TC_CHUNK = 64  # tc::kQ in ssd_scan.cu: tokens per chunk of the tensor-core kernel

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ROUTE = {torch.float32: "ssd_scan_simt", torch.bfloat16: "ssd_scan_tc"}

launches = {"ssd_scan": 0, "ssd_scan_tc": 0, "ssd_scan_simt": 0}
_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_bound: set = set()


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _count(route: str) -> None:
    with _count_lock:
        launches["ssd_scan"] += 1
        launches[route] += 1


def load() -> BuiltLibrary:
    """The kernel library (built at first use, every kernel in it) with
    this module's functions declared."""
    built = kernel_library()
    with _bind_lock:
        if built.path not in _bound:
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            for sfx in _SUFFIX.values():
                fn = getattr(built.lib, f"ssd_scan_{sfx}")
                fn.argtypes = [p] * 8 + [i64] * 5 + [p]
                fn.restype = ctypes.c_int
            for name, want in (("ssd_scan_max_state", MAX_STATE),
                               ("ssd_scan_tc_chunk", TC_CHUNK)):
                fn = getattr(built.lib, name)
                fn.argtypes = []
                fn.restype = ctypes.c_int
                if fn() != want:
                    raise RuntimeError(f"ssd_scan.cu and ops.py disagree on {name}")
            _bound.add(built.path)
    return built


def _check(x, dt, A, B, C, init_state) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C))
    for name, t in named + (("init_state", init_state),):
        if t is None and name == "init_state":
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ssd_scan: {name} is a {type(t).__name__}, not a tensor")
    if x.ndim != 4:
        raise ValueError(f"ssd_scan: x must be [b, s, h, p], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1] if B.ndim == 3 else -1
    want = {"dt": (b, s, h), "A": (h,), "B": (b, s, n), "C": (b, s, n),
            "init_state": (b, h, p, n)}
    for name, t in named[1:] + (("init_state", init_state),):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} is {tuple(t.shape)}, want "
                             f"{want[name]} for x {tuple(x.shape)}")
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in _SUFFIX:
        raise TypeError(f"ssd_scan: x, B, C are {x.dtype}, {B.dtype}, {C.dtype}; "
                        f"all must be float32 or all bfloat16")
    f32 = [("dt", dt), ("A", A)] + ([("init_state", init_state)]
                                    if init_state is not None else [])
    for name, t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, must be float32")
    devs = {t.device for _, t in named} | (
        {init_state.device} if init_state is not None else set())
    if len(devs) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: devices {sorted(map(str, devs))}; all must be "
                         f"one cpu or cuda device")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def ssd_scan_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in torch ops: the per-token recurrence in
    f32, in the kernel's order,

        state = exp(dt_t A) state + (dt_t x_t) B_tᵀ;   y_t = state C_t

    Returns (y ``[b, s, h, p]`` in x's dtype, final state ``[b, h, p, n]``
    f32)."""
    _check(x, dt, A, B, C, init_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.clone())
    dA = torch.exp(dt * A)  # [b, s, h]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    for t in range(s):
        dtx = dt[:, t, :, None] * x[:, t].float()  # [b, h, p]
        state = (state * dA[:, t, :, None, None]
                 + dtx[..., None] * B[:, t, None, None, :].float())
        y[:, t] = (state * C[:, t, None, None, :].float()).sum(-1)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan (one group: B and C shared by all heads).

    x ``[b, s, h, p]`` and B, C ``[b, s, n]`` in one dtype (float32 or
    bfloat16); dt ``[b, s, h]`` (> 0), A ``[h]`` (< 0) and ``init_state``
    ``[b, h, p, n]`` (None: zeros) in float32; contiguous, ``n <= 128``
    on the card, where bf16 runs the tensor-core kernel and float32 the
    FMA kernel.  Returns (y ``[b, s, h, p]`` in x's dtype, final state
    ``[b, h, p, n]`` float32)."""
    refuse_grad("ssd_scan", x, dt, A, B, C, init_state)
    _check(x, dt, A, B, C, init_state)
    if is_fake(x):  # a dry-run: state update and output, 2 multiply-adds an entry
        b, s, h, p = x.shape
        n = B.shape[-1]
        y = torch.empty_like(x)
        final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
        fake_launch("ssd_scan", 4 * b * s * h * p * n, (x, dt, A, B, C, init_state, y, final))
        return y, final
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, init_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    ins = (x, dt, A, B, C) + ((init_state,) if init_state is not None else ())
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("ssd_scan: x, dt, A, B, C and init_state must be contiguous")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: state size {n} outside [1, {MAX_STATE}]")
    if b > 65535 or h > 65535:
        raise ValueError(f"ssd_scan: b {b} or h {h} above the grid's 65535")
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if final.numel() == 0:
        return y, final
    fn = getattr(load().lib, f"ssd_scan_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), 0 if init_state is None else init_state.data_ptr(),
                y.data_ptr(), final.data_ptr(), b, s, h, p, n,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed (cudaError {rc})")
    _count(_ROUTE[x.dtype])
    return y, final
