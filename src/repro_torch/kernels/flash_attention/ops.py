"""Wrapper of the hand-written flash attention kernel, with its plain
version.

``flash_attention`` checks its inputs, then either launches the CUDA
kernel (``csrc/flash_attention.cu``) on the current stream — for tensors
on a CUDA device — or runs ``flash_attention_plain`` — for tensors on the
CPU, where no kernel exists.  There is no other route: a CUDA tensor
launches the kernel or raises.

The layout is the JAX wrapper's (``repro.kernels.flash_attention``):
q ``[B, Sq, H, d]``, k and v ``[B, Sk, KV, d]``, out ``[B, Sq, H, d]``.
Unlike that wrapper nothing is padded or repeated: the kernel reads KV
head ``h // (H // KV)`` in place and keeps ``d`` at its true value.

``launches`` counts kernel launches (plain-version calls are not
launches).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import BuiltLibrary, build_library

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "launches",
    "reset_launches",
    "load",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NEG_INF = -1e30
BLOCK_Q = BLOCK_K = 64  # the kernel's query and key tiles (kBlockQ, kBlockK)
MAX_HEAD_DIM = 128  # kMaxD

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

launches = {"flash_attention": 0}
_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_bound: set = set()


def reset_launches() -> None:
    with _count_lock:
        launches["flash_attention"] = 0


def _count() -> None:
    with _count_lock:
        launches["flash_attention"] += 1


def load() -> BuiltLibrary:
    """Build (at first use) and load the flash attention library."""
    built = build_library("flash_attention", SOURCE)
    with _bind_lock:
        if built.path not in _bound:
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for sfx in _SUFFIX.values():
                fn = getattr(built.lib, f"flash_attention_{sfx}")
                fn.argtypes = [p, p, p, p] + [i64] * 7 + [i32, i32, i64,
                                                          ctypes.c_float, p]
                fn.restype = ctypes.c_int
            built.lib.flash_attention_max_head_dim.argtypes = []
            built.lib.flash_attention_max_head_dim.restype = ctypes.c_int
            if built.lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
                raise RuntimeError("flash_attention.cu and ops.py disagree on "
                                   "the largest head dim")
            _bound.add(built.path)
    return built


def _check(q, k, v, sk_valid) -> int:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"flash_attention: {name} is a {type(x).__name__}, "
                            f"not a tensor")
        if x.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(x.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SUFFIX:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; all must be float32 or all bfloat16")
    if not (q.device == k.device == v.device) or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: devices {q.device}, {k.device}, "
                         f"{v.device}; all must be one cpu or cuda device")
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"[B,Sq,H,d], [B,Sk,KV,d]")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads over {KV} KV heads")
    sk_valid = Sk if sk_valid is None else int(sk_valid)
    if not 0 <= sk_valid <= Sk:
        raise ValueError(f"flash_attention: sk_valid {sk_valid} outside [0, {Sk}]")
    return sk_valid


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _key_range(q0: int, q1: int, Sk: int, sk_valid: int, causal: bool,
               window: Optional[int], block_k: int) -> tuple[int, int]:
    """Key tiles [begin, end) that some query in [q0, q1) can see: the
    tiles the Pallas kernel does not skip."""
    end = min(sk_valid, Sk)
    if causal:
        end = min(end, q1)
    begin = max(0, q0 - window + 1) if window is not None else 0
    return begin - begin % block_k, end


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    sk_valid: Optional[int] = None,
    block_q: int = BLOCK_Q,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """The kernel's function in torch ops: per query tile, an online
    softmax over the key tiles it can see, in f32, in the kernel's order.
    Live memory is O(block_q · block_k) scores per head, never Sq × Sk."""
    sk_valid = _check(q, k, v, sk_valid)
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    out = torch.empty_like(q)
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        nq = q1 - q0
        qf = (q[:, q0:q1].float() * scale).reshape(B, nq, KV, G, d)
        q_pos = torch.arange(q0, q1, device=dev)
        m = torch.full((B, KV, G, nq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, nq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, nq, d), dtype=torch.float32, device=dev)
        begin, end = _key_range(q0, q1, Sk, sk_valid, causal, window, block_k)
        for k0 in range(begin, end, block_k):
            k1 = min(k0 + block_k, Sk)
            s = torch.einsum("bqkgd,bckd->bkgqc", qf, k[:, k0:k1].float())
            k_pos = torch.arange(k0, k1, device=dev)
            ok = (k_pos < sk_valid)[None, :]
            if causal:
                ok = ok & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p, v[:, k0:k1].float()
            )
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(B, nq, H, d).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    sk_valid: Optional[int] = None,
) -> torch.Tensor:
    """Causal / sliding-window / GQA attention, online softmax in f32.

    q ``[B, Sq, H, d]``, k and v ``[B, Sk, KV, d]`` (contiguous, one
    dtype: float32 or bfloat16, ``H % KV == 0``, ``d <= 128`` on the
    card).  Query row i sits at position i whatever Sk is; key j is
    valid when ``j < sk_valid`` (default Sk), ``j <= i`` if ``causal``
    and ``i - j < window`` if ``window`` is set.  Returns
    ``[B, Sq, H, d]`` in q's dtype."""
    sk_valid = _check(q, k, v, sk_valid)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, sk_valid=sk_valid)
    B, Sq, H, d = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B {B} or H {H} above the grid's 65535")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = getattr(load().lib, f"flash_attention_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, KV, d, sk_valid, int(causal),
                int(window is not None), 0 if window is None else int(window),
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed (cudaError {rc})")
    _count()
    return out
