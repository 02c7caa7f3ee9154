"""Wrapper of the hand-written RWKV6 wkv kernel, with its plain version.

``wkv6`` checks its inputs, then either launches a CUDA kernel
(``csrc/wkv6.cu``) on the current stream — for tensors on a CUDA device
— or runs ``wkv6_plain`` — for tensors on the CPU, where no kernel
exists.  On the card the dtype picks the kernel: bf16 r, k, v run
``wkv6_tc_kernel`` (the chunked form on tensor cores, with asynchronous
chunk loads), f32 ``wkv6_simt_kernel`` (the recurrence token by token on
FP32 FMA).  There is no other route: a CUDA tensor launches its dtype's
kernel or raises.  (A dry-run's fake tensor reaches neither:
``repro_torch.kernels.fake_launch``.)

The layout is the JAX wrapper's (``repro.kernels.rwkv6_wkv``): r, k, v
and the decay w ``[B, T, H, N]``, the bonus u ``[H, N]``, an initial
state ``[B, H, N, N]`` indexed ``S[i (key), j (value)]``.  Unlike that
wrapper nothing is padded: the kernel walks the true ``T``.

``launches`` counts kernel launches (plain-version calls are not
launches): ``"wkv6"`` every launch, ``"wkv6_tc"`` and ``"wkv6_simt"``
each route's.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import fake_launch, is_fake, refuse_grad
from repro_torch.kernels.build import BuiltLibrary, kernel_library

__all__ = ["wkv6", "wkv6_plain", "launches", "reset_launches", "load"]

MAX_HEAD = 64  # kMaxN in wkv6.cu: the largest head size the kernels hold
TC_CHUNK = 64  # tc::kQ in wkv6.cu: tokens per chunk of the tensor-core kernel

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ROUTE = {torch.float32: "wkv6_simt", torch.bfloat16: "wkv6_tc"}

launches = {"wkv6": 0, "wkv6_tc": 0, "wkv6_simt": 0}
_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_bound: set = set()


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _count(route: str) -> None:
    with _count_lock:
        launches["wkv6"] += 1
        launches[route] += 1


def load() -> BuiltLibrary:
    """The kernel library (built at first use, every kernel in it) with
    this module's functions declared."""
    built = kernel_library()
    with _bind_lock:
        if built.path not in _bound:
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            for sfx in _SUFFIX.values():
                fn = getattr(built.lib, f"wkv6_{sfx}")
                fn.argtypes = [p] * 8 + [i64] * 4 + [p]
                fn.restype = ctypes.c_int
            for name, want in (("wkv6_max_head", MAX_HEAD), ("wkv6_tc_chunk", TC_CHUNK)):
                fn = getattr(built.lib, name)
                fn.argtypes = []
                fn.restype = ctypes.c_int
                if fn() != want:
                    raise RuntimeError(f"wkv6.cu and ops.py disagree on {name}")
            _bound.add(built.path)
    return built


def _check(r, k, v, w, u, init_state) -> None:
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u))
    for name, t in named + (("init_state", init_state),):
        if t is None and name == "init_state":
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"wkv6: {name} is a {type(t).__name__}, not a tensor")
    if r.ndim != 4:
        raise ValueError(f"wkv6: r must be [B, T, H, N], got {tuple(r.shape)}")
    B, T, H, N = r.shape
    want = {"k": r.shape, "v": r.shape, "w": r.shape, "u": (H, N),
            "init_state": (B, H, N, N)}
    for name, t in named[1:] + (("init_state", init_state),):
        if t is not None and tuple(t.shape) != tuple(want[name]):
            raise ValueError(f"wkv6: {name} is {tuple(t.shape)}, want "
                             f"{tuple(want[name])} for r {tuple(r.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _SUFFIX:
        raise TypeError(f"wkv6: r, k, v are {r.dtype}, {k.dtype}, {v.dtype}; "
                        f"all must be float32 or all bfloat16")
    f32 = [("w", w), ("u", u)] + ([("init_state", init_state)]
                                  if init_state is not None else [])
    for name, t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {name} is {t.dtype}, must be float32")
    devs = {t.device for _, t in named} | (
        {init_state.device} if init_state is not None else set())
    if len(devs) != 1 or r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv6: devices {sorted(map(str, devs))}; all must be one "
                         f"cpu or cuda device")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def wkv6_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in torch ops: the per-token recurrence in
    f32, in the kernel's order,

        y_t = r_t · S + (r_t · (u ⊙ k_t)) v_t;   S = diag(w_t) S + k_t v_tᵀ

    (``y_t = r_t · (S + diag(u) k_t v_tᵀ)`` regrouped).  Returns (y
    ``[B, T, H, N]`` in r's dtype, final state ``[B, H, N, N]`` f32)."""
    _check(r, k, v, w, u, init_state)
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if init_state is None else init_state.clone())
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    for t in range(T):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()  # [B, H, N]
        bonus = (rt * u * kt).sum(-1, keepdim=True)  # [B, H, 1]
        y[:, t] = torch.einsum("bhi,bhij->bhj", rt, S) + bonus * vt
        S = S * w[:, t, :, :, None] + kt[..., :, None] * vt[..., None, :]
    return y.to(r.dtype), S


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 wkv recurrence with per-channel, data-dependent decay.

    r, k, v ``[B, T, H, N]`` in one dtype (float32 or bfloat16); the
    decay w ``[B, T, H, N]`` (in [0, 1)), the bonus u ``[H, N]`` and
    ``init_state`` ``[B, H, N, N]`` (None: zeros) in float32;
    contiguous, ``N <= 64`` on the card, where bf16 runs the
    tensor-core kernel (``T < 2**31``) and float32 the FMA kernel.
    Returns (y ``[B, T, H, N]`` in r's dtype, final state ``[B, H, N,
    N]`` float32)."""
    refuse_grad("wkv6", r, k, v, w, u, init_state)
    _check(r, k, v, w, u, init_state)
    if is_fake(r):  # a dry-run: r.S and the state update, 2 multiply-adds an entry
        B, T, H, N = r.shape
        y = torch.empty_like(r)
        final = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
        fake_launch("wkv6", 4 * B * T * H * N * N, (r, k, v, w, u, init_state, y, final))
        return y, final
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, init_state)
    B, T, H, N = r.shape
    ins = (r, k, v, w, u) + ((init_state,) if init_state is not None else ())
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("wkv6: r, k, v, w, u and init_state must be contiguous")
    if not 1 <= N <= MAX_HEAD:
        raise ValueError(f"wkv6: head size {N} outside [1, {MAX_HEAD}]")
    if B > 65535 or H > 65535:
        raise ValueError(f"wkv6: B {B} or H {H} above the grid's 65535")
    y = torch.empty_like(r)
    final = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if final.numel() == 0:
        return y, final
    fn = getattr(load().lib, f"wkv6_{_SUFFIX[r.dtype]}")
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), 0 if init_state is None else init_state.data_ptr(),
                y.data_ptr(), final.data_ptr(), B, T, H, N,
                torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        why = (f"cuTensorMapEncodeTiled returned CUresult {-1000 - rc}" if rc <= -1000
               else f"cudaError {rc}")
        raise RuntimeError(f"wkv6: kernel launch failed ({why})")
    _count(_ROUTE[r.dtype])
    return y, final
