"""Block decomposition of distributed arrays (paper §5.2).

Implements the paper's three-level block hierarchy:

* **base-block** — a tile of an array-base, owned by exactly one process,
  assigned by an N-D block-cyclic distribution (paper follows HPF).
* **view-block** — a tile of an array-view (user-visible coordinates).
* **sub-view-block** — the intersection of a view-block with one base-block
  of every operand; the unit of scheduling.

The fragmentation routine is generalized to an *iteration space*: an
operation iterates over an N-D index space; every operand maps a subset of
the iteration dims onto its own view dims.  The common refinement of all
operands' base-block grids then yields fragments such that every fragment
touches exactly one base-block of every operand — the paper's
sub-view-block decomposition.  Elementwise ufuncs, axis reductions,
broadcasts and blocked matmul (SUMMA) all fragment through this one
mechanism.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "Layout",
    "ViewSpec",
    "Region",
    "Fragment",
    "OperandSpec",
    "fragment_iteration_space",
    "default_process_grid",
]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def default_process_grid(nprocs: int, ndim: int) -> tuple[int, ...]:
    """Factor ``nprocs`` into an ``ndim``-dimensional near-square grid."""
    if ndim == 0:
        return ()
    grid = [1] * ndim
    n = nprocs
    f = 2
    factors = []
    while f * f <= n:
        while n % f == 0:
            factors.append(f)
            n //= f
        f += 1
    if n > 1:
        factors.append(n)
    for f in sorted(factors, reverse=True):
        i = int(np.argmin(grid))
        grid[i] *= f
    return tuple(grid)


@dataclass(frozen=True)
class Layout:
    """N-D block-cyclic distribution of an array-base (paper §5.2)."""

    shape: tuple[int, ...]
    block_shape: tuple[int, ...]
    pgrid: tuple[int, ...]  # process grid, same ndim as shape

    def __post_init__(self):
        if len(self.shape) != len(self.block_shape):
            raise ValueError("shape/block_shape ndim mismatch")
        if len(self.pgrid) != len(self.shape):
            raise ValueError("pgrid ndim mismatch")
        if any(b <= 0 for b in self.block_shape):
            raise ValueError("non-positive block size")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def grid(self) -> tuple[int, ...]:
        """Number of base-blocks per dimension."""
        return tuple(
            _ceil_div(s, b) if s else 0 for s, b in zip(self.shape, self.block_shape)
        )

    @property
    def nblocks(self) -> int:
        return int(np.prod(self.grid)) if self.ndim else 1

    def owner(self, coord: tuple[int, ...]) -> int:
        """Block-cyclic owner rank of base-block ``coord`` (round-robin
        per-dimension over the process grid, HPF style)."""
        if not coord:
            return 0
        rank = 0
        for c, p in zip(coord, self.pgrid):
            rank = rank * p + (c % p)
        return rank

    def block_slices(self, coord: tuple[int, ...]) -> tuple[slice, ...]:
        return tuple(
            slice(c * b, min((c + 1) * b, s))
            for c, b, s in zip(coord, self.block_shape, self.shape)
        )

    def block_shape_at(self, coord: tuple[int, ...]) -> tuple[int, ...]:
        return tuple(
            min((c + 1) * b, s) - c * b
            for c, b, s in zip(coord, self.block_shape, self.shape)
        )

    def blocks(self) -> Iterator[tuple[tuple[int, ...], tuple[slice, ...]]]:
        for coord in np.ndindex(*self.grid):
            yield coord, self.block_slices(coord)


@dataclass(frozen=True)
class ViewSpec:
    """Strided view of an array-base: per-dim ``(offset, step, length)``.

    A view maps view-index ``i`` (0 <= i < length) to base index
    ``offset + i*step``.  This is the paper's array-view (§5.1): the
    hierarchy is flat — views refer directly to a base, never to another
    view.
    """

    offset: tuple[int, ...]
    step: tuple[int, ...]
    vshape: tuple[int, ...]

    @staticmethod
    def full(shape: Sequence[int]) -> "ViewSpec":
        n = len(shape)
        return ViewSpec((0,) * n, (1,) * n, tuple(shape))

    @property
    def ndim(self) -> int:
        return len(self.vshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.vshape)) if self.vshape else 1

    def compose_slice(self, key: tuple[slice, ...]) -> "ViewSpec":
        """Compose this view with a basic slice (positive steps only)."""
        off, st, sh = [], [], []
        for o, s, L, sl in zip(self.offset, self.step, self.vshape, key):
            start, stop, stride = sl.indices(L)
            if stride <= 0:
                raise NotImplementedError("negative slice steps not supported")
            n = max(0, _ceil_div(stop - start, stride))
            off.append(o + start * s)
            st.append(s * stride)
            sh.append(n)
        return ViewSpec(tuple(off), tuple(st), tuple(sh))

    def base_range(self, dim: int, lo: int, hi: int) -> tuple[int, int]:
        """Base-index interval [first, last] covered by view interval
        [lo, hi) on ``dim``; requires hi > lo."""
        first = self.offset[dim] + lo * self.step[dim]
        last = self.offset[dim] + (hi - 1) * self.step[dim]
        return first, last


# A Region is a per-dim (start, stop) interval tuple in base-block-local
# coordinates; used for fine-grained conflict detection inside one block.
Region = tuple[tuple[int, int], ...]


@dataclass(frozen=True)
class Fragment:
    """One sub-view-block: the part of one operand touched by one fragment
    of the iteration space.  ``local`` is per-operand-dim (start, stop,
    step) inside base-block ``block``."""

    block: tuple[int, ...]
    local: tuple[tuple[int, int, int], ...]
    owner: int

    @property
    def region(self) -> Region:
        return tuple((s, e) for s, e, _ in self.local)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(_ceil_div(e - s, st) for s, e, st in self.local)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.local else 1

    @property
    def slices(self) -> tuple[slice, ...]:
        return tuple(slice(s, e, st) for s, e, st in self.local)


@dataclass(frozen=True)
class OperandSpec:
    """An operand of a fragmented operation.

    ``dims[d]`` gives, for operand dim ``d``, the iteration-space dim it is
    indexed by.  Elementwise ops use ``dims = (0, 1, ..., n-1)`` for every
    operand; a matmul ``C[m,n] += A[m,k] B[k,n]`` uses iteration space
    ``(M, N, K)`` with dims ``(0, 2)``, ``(2, 1)`` and ``(0, 1)``.
    """

    view: ViewSpec
    layout: Layout
    dims: tuple[int, ...]


def _dim_cuts(view: ViewSpec, layout: Layout, dim: int) -> np.ndarray:
    """View-coordinate cut points on ``dim`` where the base-block index of
    ``view`` changes (sorted, interior only)."""
    L = view.vshape[dim]
    if L <= 1:
        return np.empty(0, dtype=np.int64)
    o, s = view.offset[dim], view.step[dim]
    bs = layout.block_shape[dim]
    idx = o + np.arange(L, dtype=np.int64) * s
    bid = idx // bs
    return (np.nonzero(np.diff(bid))[0] + 1).astype(np.int64)


@functools.lru_cache(maxsize=8192)
def _fragment_cached(
    iter_shape: tuple[int, ...],
    operands: tuple[OperandSpec, ...],
) -> tuple[tuple[tuple[tuple[int, int], ...], tuple[Fragment, ...]], ...]:
    nd = len(iter_shape)
    cuts: list[list[np.ndarray]] = [
        [np.array([0, iter_shape[d]], dtype=np.int64)] for d in range(nd)
    ]
    for op in operands:
        for od, idim in enumerate(op.dims):
            cuts[idim].append(_dim_cuts(op.view, op.layout, od))
    per_dim = [np.unique(np.concatenate(c)) for c in cuts]
    intervals = [
        [(int(c[i]), int(c[i + 1])) for i in range(len(c) - 1)] for c in per_dim
    ]
    out = []
    for combo in np.ndindex(*[len(iv) for iv in intervals]):
        vint = tuple(intervals[d][combo[d]] for d in range(nd))
        frags = []
        for op in operands:
            block, local = [], []
            for od, idim in enumerate(op.dims):
                lo, hi = vint[idim]
                if op.view.vshape[od] == 1 and iter_shape[idim] > 1:
                    lo, hi = 0, 1  # broadcast dim: single element read by all
                first, last = op.view.base_range(od, lo, hi)
                bs = op.layout.block_shape[od]
                b0 = first // bs
                assert last // bs == b0, "fragment spans base blocks"
                block.append(int(b0))
                start = first - b0 * bs
                stop = last - b0 * bs + 1
                local.append((int(start), int(stop), int(op.view.step[od])))
            block_t = tuple(block)
            frags.append(Fragment(block_t, tuple(local), op.layout.owner(block_t)))
        out.append((vint, tuple(frags)))
    return tuple(out)


def fragment_iteration_space(
    iter_shape: Sequence[int],
    operands: Sequence[OperandSpec],
):
    """Decompose an operation's iteration space into sub-view-block
    fragments (cached on (iter_shape, operand specs))."""
    if any(s == 0 for s in iter_shape):
        return ()
    return _fragment_cached(tuple(iter_shape), tuple(operands))
