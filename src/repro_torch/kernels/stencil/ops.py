"""Wrappers of the hand-written stencil kernels, with their plain versions.

Each wrapper checks its inputs, then either launches the CUDA kernel
(``csrc/stencil.cu``) on the current stream — for tensors on a CUDA
device — or runs the plain PyTorch version beside it — for tensors on
the CPU, where no kernel exists.  There is no other route: a CUDA tensor
launches the kernel or raises.  The plain versions repeat the kernels'
arithmetic (same dtype, same order) and are the reference the kernels
are held to on the card.

``stencil5_group`` computes a table of fused 5-point fragments in one
launch of ``stencil5_group_kernel``, each written straight into its
output view; ``stencil5_block`` is a group of one into a new tensor.

``launches`` counts kernel launches per kernel (plain-version calls are
not launches): ``launches["stencil5_block"]`` every launch of the
stencil5 kernel, from either wrapper.  ``fragment_shapes`` counts the
fragments those launches computed, by shape, ``group_sizes`` the
launches by their number of fragments, and ``staged_copies`` the
outputs copied back from a temporary; ``launch_shapes`` counts
``jacobi_sweep``'s launches by grid shape.
"""
from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels.build import BuiltLibrary, kernel_library

__all__ = [
    "stencil5_block",
    "stencil5_block_plain",
    "stencil5_group",
    "stencil5_group_plain",
    "prepare_group",
    "PreparedGroup",
    "jacobi_sweep",
    "jacobi_sweep_plain",
    "launches",
    "launch_shapes",
    "fragment_shapes",
    "group_sizes",
    "staged_copies",
    "reset_launches",
    "load",
]


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# stencil5_group_kernel's launch parameters (csrc/stencil.cu, checked at
# load): fragments a launch, int64 values a fragment in the host table,
# and a CTA's tile
GROUP_MAX_FRAGS, _FIELDS, TILE_ROWS, TILE_COLS = 256, 21, 16, 128
_INT32_MAX = 2**31 - 1

launches = {"stencil5_block": 0, "jacobi_sweep": 0}
launch_shapes = {"jacobi_sweep": collections.Counter()}
fragment_shapes = collections.Counter()
group_sizes = collections.Counter()
staged_copies = collections.Counter()  # outputs copied back from a temporary, by shape
_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_bound: set = set()  # library paths whose C signatures are declared


def reset_launches() -> None:
    with _count_lock:
        for k in launches:
            launches[k] = 0
        launch_shapes["jacobi_sweep"].clear()
        fragment_shapes.clear()
        group_sizes.clear()
        staged_copies.clear()


def _count_jacobi(shape) -> None:
    with _count_lock:
        launches["jacobi_sweep"] += 1
        launch_shapes["jacobi_sweep"][tuple(shape)] += 1


def _count_group(shapes) -> None:
    with _count_lock:
        launches["stencil5_block"] += 1
        group_sizes[len(shapes)] += 1
        fragment_shapes.update(shapes)


def load() -> BuiltLibrary:
    """The kernel library (built at first use, every kernel in it) with
    this module's functions declared."""
    built = kernel_library()
    with _bind_lock:
        if built.path not in _bound:
            p, i32 = ctypes.c_void_p, ctypes.c_int
            for sfx in _SUFFIX.values():
                fn = getattr(built.lib, f"stencil5_group_{sfx}")
                fn.argtypes = [p, i32, ctypes.c_double, p]
                fn.restype = ctypes.c_int
                fn = getattr(built.lib, f"jacobi_sweep_{sfx}")
                fn.argtypes = [p, p, ctypes.c_int64, ctypes.c_int64, p]
                fn.restype = ctypes.c_int
            config = built.lib.stencil5_group_config
            config.argtypes = [i32]
            config.restype = i32
            ours = (GROUP_MAX_FRAGS, _FIELDS, TILE_ROWS, TILE_COLS)
            theirs = tuple(config(i) for i in range(len(ours)))
            if theirs != ours:
                raise RuntimeError(f"stencil.cu (fragments a launch, fields, tile {theirs}) "
                                   f"and ops.py ({ours}) disagree")
            _bound.add(built.path)
    return built


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_launch(name: str, rc: int) -> None:
    if rc == -1:
        raise RuntimeError(f"{name}: the kernel refused the fragment table")
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


def stencil5_group_plain(frags, *, weight: float) -> None:
    """``stencil5_group`` in torch ops: each fragment's result computed
    by ``stencil5_block_plain``, then written into its output."""
    for xs, out in frags:
        out.copy_(stencil5_block_plain(*xs, weight=weight))


def _check_group(frags) -> None:
    if not frags:
        return
    ref = frags[0][1]
    _check_float_2d("stencil5_group", ref)
    dtype, device, shape = ref.dtype, ref.device, ref.shape
    for xs, out in frags:
        if len(xs) != 5:
            raise ValueError(f"stencil5_group: a fragment has {len(xs)} operands, not 5")
        for x in (*xs, out):
            if not (isinstance(x, torch.Tensor) and x.dtype == dtype
                    and x.device == device and x.shape == out.shape):
                for y in (*xs, out):
                    _check_float_2d("stencil5_group", y)
                raise ValueError(
                    "stencil5_group: a fragment's operands and output differ in shape, "
                    f"or the group in dtype or device (the first output: {tuple(shape)} "
                    f"{dtype} {device}): "
                    + ", ".join(f"{tuple(y.shape)} {y.dtype} {y.device}" for y in (*xs, out))
                )


def _span(x: torch.Tensor) -> tuple[int, int]:
    """First and last element offset ``x`` touches in its storage."""
    lo = x.storage_offset()
    return lo, lo + sum((n - 1) * s for n, s in zip(x.shape, x.stride()))


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two 2-D views of one dtype may share an element: exact for
    row-major views of one row stride, conservative (their spans meet)
    otherwise."""
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    (alo, ahi), (blo, bhi) = _span(a), _span(b)
    if ahi < blo or bhi < alo:
        return False
    rs = a.stride(0)
    if a.stride() == b.stride() and a.stride(1) == 1 and rs > 0:
        (ar, ac), (br, bc) = divmod(alo, rs), divmod(blo, rs)
        if ac + a.shape[1] <= rs and bc + b.shape[1] <= rs:  # no row wraps
            return (ar < br + b.shape[0] and br < ar + a.shape[0]
                    and ac < bc + b.shape[1] and bc < ac + a.shape[1])
    return True


# the shared route's codes: an operand's offset from the centre, in
# (rows, columns), is that of its code's index (csrc/stencil.cu, code_dy/dx)
_SHIFTS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def _shared_mode(geo, rows: int, cols: int, es: int) -> tuple[int, int]:
    """(mode, centre address) for the kernel's shared-memory route, from
    the operands' (address, row stride, column stride), or (0, 0) when
    they are not the centre and its four neighbours (row stride rs >= 2,
    unit column stride) at addresses that differ by 0, +-rs and +-1
    elements: then every address the route reads belongs to one of the
    operands."""
    rs = geo[0][1]
    if rs < 2 or any(g[1] != rs or g[2] != 1 for g in geo):
        return 0, 0
    if (rows + 1) * rs + cols > _INT32_MAX:  # halo offsets in 32 bits
        return 0, 0
    ptrs = [g[0] for g in geo]
    c = sorted(ptrs)[2]
    codes = {c + (dy * rs + dx) * es: k for k, (dy, dx) in enumerate(_SHIFTS)}
    if len(set(ptrs)) != 5 or not codes.keys() >= set(ptrs):
        return 0, 0
    mode = 1 | (2 if (rs * es) % 16 == 0 else 0)
    for i, ptr in enumerate(ptrs):
        mode |= codes[ptr] << (4 + 3 * i)
    return mode, c


def _shared_route(xs) -> tuple[int, int]:
    """``_shared_mode`` of five operand views."""
    rows, cols = xs[0].shape
    return _shared_mode([(x.data_ptr(), *x.stride()) for x in xs], rows, cols,
                        xs[0].element_size())


def _table(xs, out) -> list:
    """One fragment's row of the kernel's host table (csrc/stencil.cu,
    launch_group_n): five operand addresses, their row and column
    strides, the output's address and strides, rows, cols, mode.  The
    kernel indexes in 32 bits within a fragment: a view that spans more
    elements raises."""
    rows, cols = out.shape
    geo = []
    for x in (*xs, out):
        rs, cs = x.stride()
        if max(rs, cs) > _INT32_MAX or (rows - 1) * rs + (cols - 1) * cs > _INT32_MAX:
            raise ValueError(f"stencil5_group: a view of shape {(rows, cols)} and strides "
                             f"{(rs, cs)} spans more than 2^31 - 1 elements")
        geo.append((x.data_ptr(), rs, cs))
    mode, centre = _shared_mode(geo[:5], rows, cols, out.element_size())
    if mode:
        rs = geo[0][1]
        return [centre, 0, 0, 0, 0, rs, rs, rs, rs, rs, 1, 1, 1, 1, 1,
                *geo[5], rows, cols, mode]
    return [*(g[0] for g in geo[:5]), *(g[1] for g in geo[:5]), *(g[2] for g in geo[:5]),
            *geo[5], rows, cols, mode]


def _writes_own_operand(xs, out) -> bool:
    """Whether ``out`` may share an element with one of ``xs``: first by
    the address ranges the views span (disjoint ranges cannot share),
    then exactly by ``_overlaps``."""
    rows, cols = out.shape
    es = out.element_size()

    def span(x):
        rs, cs = x.stride()
        lo = x.data_ptr()
        return lo, lo + ((rows - 1) * rs + (cols - 1) * cs + 1) * es

    olo, ohi = span(out)
    for x in xs:
        lo, hi = span(x)
        if lo < ohi and olo < hi and _overlaps(out, x):
            return True
    return False


class PreparedGroup:
    """A group's fragment table, built on the host by ``prepare_group``
    for CUDA tensors.  ``launch`` runs the kernel over it on the current
    stream (one launch per ``GROUP_MAX_FRAGS`` fragments), reading the
    operands' values as they are then; it may run again.  Fragments
    whose output overlaps one of their own operands go to temporaries,
    copied into their outputs after the launches."""

    def __init__(self, frags):
        self.device = frags[0][1].device if frags else None
        self.dtype = frags[0][1].dtype if frags else None
        self.shapes = [tuple(out.shape) for _, out in frags]
        self.staged = []
        rows = []
        for xs, out in frags:
            dst = out
            if _writes_own_operand(xs, out):
                dst = torch.empty(out.shape, dtype=out.dtype, device=out.device)
                self.staged.append((out, dst))
            rows.append(_table(xs, dst))
        self.table = np.asarray(rows, dtype=np.int64)
        self._keep = frags  # the views the table points into

    def launch(self, weight: float) -> None:
        if not self.shapes:
            return
        fn = getattr(load().lib, f"stencil5_group_{_SUFFIX[self.dtype]}")
        with torch.cuda.device(self.device):
            stream = _stream(self.device)
            for i in range(0, len(self.shapes), GROUP_MAX_FRAGS):
                part = self.table[i:i + GROUP_MAX_FRAGS]
                rc = fn(part.ctypes.data, len(part), float(weight), stream)
                _check_launch("stencil5_group", rc)
                _count_group(self.shapes[i:i + GROUP_MAX_FRAGS])
            for out, dst in self.staged:
                out.copy_(dst)
        if self.staged:
            with _count_lock:
                staged_copies.update(tuple(out.shape) for out, _ in self.staged)


def _nonempty_group(frags) -> list:
    frags = [(tuple(xs), out) for xs, out in frags]
    _check_group(frags)
    return [(xs, out) for xs, out in frags if out.numel()]


def prepare_group(frags) -> PreparedGroup:
    """The fragment table of ``stencil5_group`` on CUDA tensors, built
    without launching (to time the launch apart from the host's work)."""
    frags = _nonempty_group(frags)
    if frags and frags[0][1].device.type != "cuda":
        raise ValueError("prepare_group: the fragments are not on a CUDA device")
    return PreparedGroup(frags)


def stencil5_group(frags, *, weight: float) -> None:
    """Fused ``out = weight * ((((x0+x1)+x2)+x3)+x4)`` for every
    ``(xs, out)`` of ``frags``, ``xs`` five 2-D views of ``out``'s shape,
    all of one float dtype and device, accumulated in that dtype.

    Each result is written into its ``out`` view in place (any strides:
    a slice of a larger block).  A fragment whose output may overlap one
    of its own operands is staged through a temporary and copied back
    after the launch.  No fragment may write what another fragment of
    the group reads or writes: they run at once (the runtime's batches
    hold operations that are ready together, which never conflict).  On
    the card one launch takes up to ``GROUP_MAX_FRAGS`` fragments;
    larger groups take several launches of the same kernel."""
    frags = _nonempty_group(frags)
    if not frags:
        return
    if frags[0][1].device.type == "cpu":
        stencil5_group_plain(frags, weight=weight)
        return
    PreparedGroup(frags).launch(weight)


def stencil5_block(x0, x1, x2, x3, x4, *, weight: float) -> torch.Tensor:
    """Fused ``weight * ((((x0+x1)+x2)+x3)+x4)`` over five same-shape
    2-D blocks of one float dtype, accumulated in that dtype.

    The inputs may be strided views (any row and column strides, e.g.
    slices of larger blocks): the kernel reads them in place.  The
    output is a new contiguous tensor: ``stencil5_group`` of one
    fragment."""
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
    out = torch.empty(x0.shape, dtype=x0.dtype, device=x0.device)
    stencil5_group([(xs, out)], weight=weight)
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
    _count_jacobi((H, W))
    return out
