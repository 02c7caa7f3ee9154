"""Wrappers of the hand-written stencil kernels, with their plain versions.

Each wrapper checks its inputs, then either launches the CUDA kernel
(``csrc/stencil.cu``) on the current stream — for tensors on a CUDA
device — or runs the plain PyTorch version beside it — for tensors on
the CPU, where no kernel exists.  There is no other route: a CUDA tensor
launches the kernel or raises.  The plain versions repeat the kernels'
arithmetic (same dtype, same order) and are the reference the kernels
are held to on the card.

``launches`` counts kernel launches per kernel (plain-version calls are
not launches); ``launch_shapes`` counts them per input shape.
"""
from __future__ import annotations

import collections
import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import BuiltLibrary, build_library

__all__ = [
    "stencil5_block",
    "stencil5_block_plain",
    "jacobi_sweep",
    "jacobi_sweep_plain",
    "launches",
    "launch_shapes",
    "reset_launches",
    "load",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "stencil.cu"
# both kernels must round as the NumPy interpreter does: no a*b+c contracts
NVCC_FLAGS = ("--fmad=false",)

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

launches = {"stencil5_block": 0, "jacobi_sweep": 0}
launch_shapes = {k: collections.Counter() for k in launches}
_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_bound: set = set()  # library paths whose C signatures are declared


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0
            launch_shapes[k].clear()


def _count(name: str, shape) -> None:
    with _count_lock:
        launches[name] += 1
        launch_shapes[name][tuple(shape)] += 1


def load() -> BuiltLibrary:
    """Build (at first use) and load the stencil kernel library."""
    built = build_library("stencil", SOURCE, flags=NVCC_FLAGS)
    with _bind_lock:
        if built.path not in _bound:
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            for sfx in _SUFFIX.values():
                fn = getattr(built.lib, f"stencil5_block_{sfx}")
                fn.argtypes = [p, i64, i64] * 5 + [p, i64, i64, ctypes.c_double, p]
                fn.restype = ctypes.c_int
                fn = getattr(built.lib, f"jacobi_sweep_{sfx}")
                fn.argtypes = [p, p, i64, i64, p]
                fn.restype = ctypes.c_int
            _bound.add(built.path)
    return built


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def _check_float_2d(name: str, x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, float64)")
    if x.ndim != 2:
        raise ValueError(f"{name}: expected a 2-D tensor, got shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: device {x.device} not supported (cpu, cuda)")


# ---------------------------------------------------------------------------
# stencil5_block
# ---------------------------------------------------------------------------


def stencil5_block_plain(x0, x1, x2, x3, x4, *, weight: float) -> torch.Tensor:
    """``weight * ((((x0+x1)+x2)+x3)+x4)`` in the inputs' dtype."""
    acc = x0 + x1
    acc = acc + x2
    acc = acc + x3
    acc = acc + x4
    return weight * acc


def stencil5_block(x0, x1, x2, x3, x4, *, weight: float) -> torch.Tensor:
    """Fused ``weight * ((((x0+x1)+x2)+x3)+x4)`` over five same-shape
    2-D blocks of one float dtype, accumulated in that dtype.

    The inputs may be strided views (any row and column strides, e.g.
    slices of larger blocks): the kernel reads them in place.  The
    output is a new contiguous tensor."""
    xs = (x0, x1, x2, x3, x4)
    for x in xs:
        _check_float_2d("stencil5_block", x)
    if any(x.shape != x0.shape or x.dtype != x0.dtype or x.device != x0.device
           for x in xs):
        raise ValueError(
            "stencil5_block: inputs differ in shape, dtype or device: "
            + ", ".join(f"{tuple(x.shape)} {x.dtype} {x.device}" for x in xs)
        )
    if x0.device.type == "cpu":
        return stencil5_block_plain(*xs, weight=weight)
    rows, cols = x0.shape
    out = torch.empty((rows, cols), dtype=x0.dtype, device=x0.device)
    if out.numel() == 0:
        return out
    fn = getattr(load().lib, f"stencil5_block_{_SUFFIX[x0.dtype]}")
    args = []
    for x in xs:
        args += [x.data_ptr(), x.stride(0), x.stride(1)]
    with torch.cuda.device(x0.device):
        rc = fn(*args, out.data_ptr(), rows, cols, float(weight),
                _stream(x0.device))
    _check_launch("stencil5_block", rc)
    _count("stencil5_block", (rows, cols))
    return out


# ---------------------------------------------------------------------------
# jacobi_sweep
# ---------------------------------------------------------------------------


def jacobi_sweep_plain(x: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi sweep on [H, W]; rows 0 and H-1 and columns 0
    and W-1 keep their values (the paper's five-view form)."""
    out = x.clone()
    if x.shape[0] > 2 and x.shape[1] > 2:
        acc = x[1:-1, 1:-1] + x[0:-2, 1:-1]
        acc = acc + x[2:, 1:-1]
        acc = acc + x[1:-1, 0:-2]
        acc = acc + x[1:-1, 2:]
        out[1:-1, 1:-1] = 0.2 * acc
    return out


def jacobi_sweep(x: torch.Tensor) -> torch.Tensor:
    """One fused 5-point Jacobi sweep on a contiguous [H, W] float grid
    (Dirichlet boundary), in the grid's dtype.  Any H and W: a ragged
    grid needs no padding."""
    _check_float_2d("jacobi_sweep", x)
    if not x.is_contiguous():
        raise ValueError("jacobi_sweep: the grid must be contiguous")
    if x.device.type == "cpu":
        return jacobi_sweep_plain(x)
    H, W = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = getattr(load().lib, f"jacobi_sweep_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), H, W, _stream(x.device))
    _check_launch("jacobi_sweep", rc)
    _count("jacobi_sweep", (H, W))
    return out
