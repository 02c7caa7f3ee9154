"""Wrapper of the hand-written flash attention kernels, with their plain
version.

``flash_attention`` checks its inputs, then either launches a CUDA
kernel of ``csrc/flash_attention.cu`` on the current stream — for
tensors on a CUDA device — or runs ``flash_attention_plain`` — for
tensors on the CPU, where no kernel exists.  There is no other route: a
CUDA tensor launches its dtype's kernel or raises.  (A dry-run's fake tensor
reaches neither: ``repro_torch.kernels.fake_launch``.)  The dtype picks
the kernel:

- **bfloat16: the wgmma kernel** (``flash_attention_wgmma_kernel``): TMA
  loads into a ring of shared-memory stages, both products on the
  tensor cores, 128-row query tiles and 128-key tiles (``BLOCK_Q``,
  ``BLOCK_K``).  It takes a head dim that is a multiple of 8 and at most
  128, 16-byte-aligned q, k and v, and a positive scale (``_check_tma``
  and the scale check raise ``ValueError`` otherwise).  Counted in
  ``launches["flash_attention_wgmma"]``.
- **float32: the FMA kernel** (``flash_attention_simt_kernel``): FP32
  FMA only, so it holds the f32 tolerance (5e-4) that TF32 tensor cores
  would not; 64-row and 64-key tiles, any head dim up to 128.  Counted in ``launches["flash_attention_simt"]``.

``launches["flash_attention"]`` counts every launch of either.

The wgmma kernel rounds P to bf16 before P·V, where the plain version
keeps it in f32.  ``bf16_rel_err`` is the measure the bf16 route is held
to on the card, against the plain version in f32 on the same
bf16-valued inputs, with ``BF16_REL_TOL`` as its bound.

The layout is the JAX wrapper's (``repro.kernels.flash_attention``):
q ``[B, Sq, H, d]``, k and v ``[B, Sk, KV, d]``, out ``[B, Sq, H, d]``.
Unlike that wrapper nothing is padded or repeated: the kernel reads KV
head ``h // (H // KV)`` in place and keeps ``d`` at its true value.

Plain-version calls are not launches.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import fake_launch, is_fake, refuse_grad
from repro_torch.kernels.build import BuiltLibrary, kernel_library

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "first_keyless_row",
    "kept_pairs",
    "BF16_REL_TOL",
    "bf16_rel_err",
    "launches",
    "reset_launches",
    "load",
]

NEG_INF = -1e30
BLOCK_Q = BLOCK_K = 128  # the wgmma kernel's query and key tiles (wg::kBlockQ, kBlockK)
MAX_HEAD_DIM = 128  # kMaxD
# bf16_rel_err's bound: 2^-6, four times the largest relative rounding
# error of one bf16 value.  Rounding P and the output to bf16 stays near
# half of it; a kernel that drops or repeats a key tile, or moves the
# window's edge or the diagonal by one key, lands many times above it
# (tests/test_torch_flash_attention.py)
BF16_REL_TOL = 2.0 ** -6

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ROUTE = {torch.float32: "flash_attention_simt", torch.bfloat16: "flash_attention_wgmma"}

launches = {"flash_attention": 0, "flash_attention_wgmma": 0, "flash_attention_simt": 0}
_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_bound: set = set()


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _count(route: str) -> None:
    with _count_lock:
        launches["flash_attention"] += 1
        launches[route] += 1


def load() -> BuiltLibrary:
    """The kernel library (built at first use, every kernel in it) with
    this module's functions declared."""
    built = kernel_library()
    with _bind_lock:
        if built.path not in _bound:
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for sfx in _SUFFIX.values():
                fn = getattr(built.lib, f"flash_attention_{sfx}")
                fn.argtypes = [p, p, p, p] + [i64] * 7 + [i32, i32, i64,
                                                          ctypes.c_float, p]
                fn.restype = ctypes.c_int
            config = built.lib.flash_attention_config
            config.argtypes = [ctypes.c_int]
            config.restype = ctypes.c_int
            ours = (MAX_HEAD_DIM, BLOCK_Q, BLOCK_K)
            theirs = tuple(config(i) for i in range(len(ours)))
            if theirs != ours:
                raise RuntimeError(f"flash_attention.cu (largest d, tiles {theirs}) "
                                   f"and ops.py ({ours}) disagree")
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


def _check_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the wgmma kernel's TMA loads need beyond ``_check``: rows of
    16-byte multiples (a head dim that is a multiple of 8) and 16-byte-
    aligned base addresses.  Raises ``ValueError``; nothing is copied or
    padded to make an input fit."""
    d = q.shape[3]
    if d % 8:
        raise ValueError(f"flash_attention: bf16 head dim {d} is not a multiple of 8 "
                         f"(the TMA loads need 16-byte rows)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: bf16 {name} at address "
                             f"{x.data_ptr():#x} is not 16-byte aligned (TMA)")


_LAUNCH_ERRORS = {
    -1: "an argument the kernel does not take",
    -2: "the wgmma kernel was not built at the 168 registers a thread that "
        "its setmaxnreg split assumes (see ptxas's report)",
}


def _launch_error(rc: int) -> str:
    if rc > 0:
        return f"cudaError {rc}"
    if rc <= -1000:
        return f"cuTensorMapEncodeTiled returned CUresult {-1000 - rc}"
    return _LAUNCH_ERRORS.get(rc, f"code {rc}")


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


def first_keyless_row(Sq: int, sk_valid: int, window: Optional[int]) -> int:
    """The first query row with no valid key: rows from it on attend to
    nothing.  Key j is valid for row i when ``j < sk_valid``, ``j <= i``
    if causal and ``i - j < window`` if windowed; causal or not, a row
    i >= 0 has one exactly when ``sk_valid > 0`` and, with a window,
    ``sk_valid > i - window + 1``."""
    if sk_valid == 0:
        return 0
    if window is None:
        return Sq
    return min(Sq, sk_valid + window - 1)


def kept_pairs(Sq: int, Sk: int, sk_valid: int, causal: bool,
               window: Optional[int]) -> int:
    """(query, key) pairs of one head that the mask keeps: key j for
    query i when ``j < sk_valid``, ``j <= i`` if causal and
    ``i - j < window`` if windowed."""
    import numpy as np

    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, sk_valid) if causal else np.full(Sq, min(Sk, sk_valid))
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo).sum())


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    sk_valid: Optional[int] = None,
    block_q: int = 64,
    block_k: int = 64,
) -> torch.Tensor:
    """The kernels' function in torch ops: per query tile, an online
    softmax over the key tiles it can see, in f32.  The default tiles are
    the FMA kernel's and the Pallas kernel's; ``BLOCK_Q`` and ``BLOCK_K``
    give the wgmma kernel's order.  Live memory is O(block_q · block_k)
    scores per head, never Sq × Sk.  A row with no valid key is 0, as
    ``flash_attention`` gives it."""
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
    out[:, first_keyless_row(Sq, sk_valid, window):] = 0
    return out


def bf16_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want| / (|want| + r)`` over the outputs, r the
    root mean square of ``want`` over the output's row of d values (0 / 0
    counts 0).  An attention output averages many values: most of its
    entries are far smaller than its rounding error's scale, so the bf16
    route is held to this, not to an absolute bound."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    r = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    ratio = torch.where(err == 0, 0.0, err / (want.abs() + r))
    return float(ratio.max()) if ratio.numel() else 0.0


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
    card; in bfloat16 on the card also ``d % 8 == 0``, 16-byte-aligned
    tensors and ``scale > 0``).  Query row i sits at position i whatever
    Sk is; key j is valid when ``j < sk_valid`` (default Sk), ``j <= i``
    if ``causal`` and ``i - j < window`` if ``window`` is set.  Returns
    ``[B, Sq, H, d]`` in q's dtype.

    A query row with no valid key (``sk_valid`` 0, or with a window the
    rows from ``sk_valid + window - 1`` on: ``first_keyless_row``) is 0
    on every route and at every tile size.  The Pallas kernel returns
    there the mean of v over the masked keys of the tiles it ran, which
    depends on its tiles; the port does not copy that.  A model's
    prefill never makes such a row (a causal row always sees key 0)."""
    refuse_grad("flash_attention", q, k, v)
    sk_valid = _check(q, k, v, sk_valid)
    if is_fake(q):  # a dry-run: q.k and p.v, 2 d multiply-adds a kept pair
        B, Sq, H, d = q.shape
        out = torch.empty_like(q)
        pairs = B * H * kept_pairs(Sq, k.shape[1], sk_valid, causal, window)
        fake_launch("flash_attention", 4 * d * pairs, (q, k, v, out))
        return out
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
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
        if not scale > 0:
            raise ValueError(f"flash_attention: bf16 scale {scale} is not positive")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if Sk == 0 and q.dtype == torch.bfloat16:
        # no keys (a tensor map cannot have an empty dim): every row is
        # 0 / 1e-30 = 0, as the plain version gives
        return out.zero_()
    fn = getattr(load().lib, f"flash_attention_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, H, KV, d, sk_valid, int(causal),
                int(window is not None), 0 if window is None else int(window),
                float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed: {_launch_error(rc)}")
    _count(_ROUTE[q.dtype])
    keyless = first_keyless_row(Sq, sk_valid, window)
    if keyless < Sq:
        out[:, keyless:] = 0
    return out
