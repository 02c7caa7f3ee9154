"""Latency-hiding collective primitives (paper §5.4/§5.7) on ``torch.distributed``.

The port of ``repro.comm.collectives``.  The functions are per-rank SPMD
code, as the reference's are per-shard code inside ``shard_map``: each
takes ``group`` (a ``ProcessGroup``; None is the default group) where
the reference takes ``axis_name``, in the same position, and reads its
rank and size from it.  The ring variants decompose one big collective
into per-block hops, and every hop keeps the paper's order:

1. post the hop's send and receive (one ``dist.batch_isend_irecv`` of an
   ``isend`` and an ``irecv``: the reference's ``lax.ppermute``);
2. issue the compute that overlaps them (the block's matmul, the next
   partial, the stencil interior);
3. wait on the work handles right before the received buffer is used.

On NCCL the wait makes the current stream wait on NCCL's stream, so the
compute issued between post and wait overlaps the transfer on the card.
A send buffer stays referenced, and unchanged, until its wait.  The
blocking baselines (``overlap="none"``) are one ``all_gather_into_tensor``
or ``reduce_scatter_single`` (``lax.all_gather`` / ``lax.psum_scatter``),
which work along dim 0: the gathered or scattered axis moves to the
front and back.

A hop whose peer is the rank itself (a ring of one) is a local copy, not
a send: gloo refuses a send to the sender's own rank.  Peers are group
ranks, turned into global ranks for the point-to-point calls.

``record_collectives()`` makes a :class:`CommLog`: while it is active,
every primitive appends one :class:`CollectiveRecord` a collective it
issues (its kind named as in the reference's HLO, the group size, the
per-rank input and output bytes) and the post / compute / wait events in
the order they happened.  ``repro_torch.roofline`` turns the records
into wire bytes.

Shape convention: ``x`` is the *local shard*; matmuls contract the last
dim of ``x`` with the first dim of ``w``.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.distributed as dist

__all__ = [
    "ring_all_gather",
    "ring_reduce_scatter",
    "ag_matmul",
    "matmul_rs",
    "halo_exchange",
    "stencil_1d_sharded",
    "jacobi_step_sharded",
    "CollectiveRecord",
    "CommLog",
    "record_collectives",
]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class CollectiveRecord:
    """One collective a rank issued: ``kind`` as the reference's HLO names
    it (``collective-permute``, ``all-gather``, ``reduce-scatter``), the
    group's size, the bytes this rank put in and got out, and for a
    permute its (source, target) pairs in global ranks, the whole ring's."""

    kind: str
    group_size: int
    in_bytes: int
    out_bytes: int
    pairs: tuple = ()


@dataclass
class CommLog:
    """What the primitives issued while the log was active: ``records``
    in issue order, and ``events``, each ``("post", record)``,
    ``("compute", what)`` or ``("wait", record)``, in the order they
    happened."""

    records: list = field(default_factory=list)
    events: list = field(default_factory=list)


_logs: contextvars.ContextVar = contextvars.ContextVar("repro_torch_comm_logs", default=())


@contextlib.contextmanager
def record_collectives():
    """Yield a fresh :class:`CommLog` that records every collective the
    primitives issue in this context until the block ends."""
    log = CommLog()
    token = _logs.set(_logs.get() + (log,))
    try:
        yield log
    finally:
        _logs.reset(token)


def _note_post(rec: CollectiveRecord) -> CollectiveRecord:
    for log in _logs.get():
        log.records.append(rec)
        log.events.append(("post", rec))
    return rec


def _note_compute(what: str) -> None:
    for log in _logs.get():
        log.events.append(("compute", what))


def _note_wait(rec: CollectiveRecord) -> None:
    for log in _logs.get():
        log.events.append(("wait", rec))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# groups, hops and the blocking collectives
# ---------------------------------------------------------------------------


def _size_rank(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _global(group, r: int) -> int:
    """Global rank of group rank ``r``."""
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _fwd_perm(n: int):
    """ring: rank i sends to i+1 (accumulators travel forward)."""
    return [(i, (i + 1) % n) for i in range(n)]


def _bwd_perm(n: int):
    """ring: rank i sends to i-1 (so we *receive* rank i+1's block)."""
    return [(i, (i - 1) % n) for i in range(n)]


class _Hop:
    """One ring hop in flight: ``send`` posted to the next rank of ``perm``
    and a receive from the previous one; ``wait()`` returns the received
    buffer.  A ring of one copies locally."""

    def __init__(self, send: torch.Tensor, group, perm):
        n, me = _size_rank(group)
        dst = dict(perm)[me]
        src = next(i for i, j in perm if j == me)
        self.send = send.contiguous()  # referenced, unchanged, until wait()
        self.recv = torch.empty_like(self.send)
        self.rec = _note_post(CollectiveRecord(
            "collective-permute", n, _nbytes(self.send), _nbytes(self.recv),
            tuple((_global(group, i), _global(group, j)) for i, j in perm)))
        if dst == me:
            self.recv.copy_(self.send)
            self.works = []
        else:
            self.works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, self.send, _global(group, dst), group),
                dist.P2POp(dist.irecv, self.recv, _global(group, src), group),
            ])

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        _note_wait(self.rec)
        self.send = None
        return self.recv


def _all_gather(x: torch.Tensor, axis: int, group) -> torch.Tensor:
    """``lax.all_gather(x, tiled=True)`` along ``axis``: the ranks' shards
    concatenated in rank order."""
    n, _ = _size_rank(group)
    xt = x.movedim(axis, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    rec = _note_post(CollectiveRecord("all-gather", n, _nbytes(xt), _nbytes(out)))
    _all_gather_single(out, xt, group=group, async_op=True).wait()
    _note_wait(rec)
    return out.movedim(0, axis)


def _reduce_scatter(y: torch.Tensor, axis: int, group) -> torch.Tensor:
    """``lax.psum_scatter(y, tiled=True)`` along ``axis``: this rank's
    block of the sum over the ranks."""
    n, _ = _size_rank(group)
    yt = y.movedim(axis, 0).contiguous()
    out = yt.new_empty((yt.shape[0] // n, *yt.shape[1:]))
    rec = _note_post(CollectiveRecord("reduce-scatter", n, _nbytes(yt), _nbytes(out)))
    _reduce_scatter_single(out, yt, group=group, async_op=True).wait()
    _note_wait(rec)
    return out.movedim(0, axis)


# newer torch names them all_gather_single and reduce_scatter_single;
# earlier releases have only all_gather_into_tensor and
# reduce_scatter_tensor, the same calls
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# ---------------------------------------------------------------------------
# Ring all-gather / reduce-scatter (building blocks)
# ---------------------------------------------------------------------------


def ring_all_gather(x: torch.Tensor, group=None, *, axis: int = 0) -> torch.Tensor:
    """All-gather via a ring of permutes — n-1 hops, each hop's transfer
    overlapped with the write of the block already held.

    Returns the gathered array with shard blocks concatenated along
    ``axis`` in rank order.
    """
    n, idx = _size_rank(group)
    shape = list(x.shape)
    size_local = shape[axis]
    shape[axis] = size_local * n
    out = x.new_empty(shape)

    blk = x
    for k in range(n):
        src = (idx + k) % n  # the rank this block originated from
        hop = _Hop(blk, group, _bwd_perm(n)) if k < n - 1 else None  # comm first
        _note_compute("write block")
        out.narrow(axis, src * size_local, size_local).copy_(blk)
        if hop is not None:
            blk = hop.wait()
    return out


def ring_reduce_scatter(
    partials: Callable[[int], torch.Tensor] | torch.Tensor,
    group=None,
    *,
    axis: int = 0,
) -> torch.Tensor:
    """Reduce-scatter via a forward ring.

    ``partials`` is either the full local partial-sum array (scattered
    along ``axis``) or a callable ``chunk_index -> partial block`` that
    *computes* the partial lazily — the lazy form overlaps each hop's
    transfer with the *next* partial's computation (the paper's
    sub-view-block interleave).
    """
    n, idx = _size_rank(group)

    if callable(partials):
        get = partials
    else:
        full = partials
        size_local = full.shape[axis] // n

        def get(c):
            return full.narrow(axis, c * size_local, size_local)

    # accumulator for chunk c starts at rank c+1 and travels forward,
    # visiting every rank once and ending at rank c after n-1 hops.
    c0 = (idx - 1) % n
    acc = get(c0)
    for t in range(1, n):
        hop = _Hop(acc, group, _fwd_perm(n))  # comm first
        _note_compute("next partial")
        nxt_partial = get((idx - 1 - t) % n)
        acc = hop.wait() + nxt_partial
    if n == 1 and not callable(partials):
        acc = acc.clone()  # a result, not a view of the input
    return acc


# ---------------------------------------------------------------------------
# Overlapped collective matmuls (the TP workhorses)
# ---------------------------------------------------------------------------


def ag_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    group=None,
    *,
    overlap: str = "ring",
    gather_axis: int = -2,
) -> torch.Tensor:
    """``all_gather(x) @ w`` with the gather hidden behind the matmul.

    ``x``: local shard ``[..., S/n, K]`` (sharded along ``gather_axis``);
    ``w``: ``[K, N_local]`` (already the local TP shard).
    Returns ``[..., S, N_local]``.

    overlap="ring": n partial matmuls, each overlapped with the hop
    bringing the next x-block (paper §5.4 schedule).
    overlap="none": one blocking all-gather then one matmul (paper's
    blocking baseline).
    """
    n, idx = _size_rank(group)
    ga = gather_axis % x.ndim
    if overlap == "none" or n == 1:
        return torch.matmul(_all_gather(x, ga, group), w)

    s_local = x.shape[ga]
    out_shape = list(x.shape)
    out_shape[ga] = s_local * n
    out_shape[-1] = w.shape[-1]
    out = x.new_empty(out_shape, dtype=torch.result_type(x, w))

    blk = x
    for k in range(n):
        src = (idx + k) % n
        hop = _Hop(blk, group, _bwd_perm(n)) if k < n - 1 else None  # comm first
        _note_compute("block matmul")
        out.narrow(ga, src * s_local, s_local).copy_(torch.matmul(blk, w))
        if hop is not None:
            blk = hop.wait()
    return out


def matmul_rs(
    x: torch.Tensor,
    w: torch.Tensor,
    group=None,
    *,
    overlap: str = "ring",
    scatter_axis: int = -2,
) -> torch.Tensor:
    """``reduce_scatter(x @ w)`` with the scatter hidden behind the matmul.

    ``x``: ``[..., S, K_local]`` (K TP-sharded); ``w``: ``[K_local, N]``.
    Returns ``[..., S/n, N]`` — the fully-reduced shard of rows.

    overlap="ring": the partial matmul for each row-chunk is computed
    just-in-time while the accumulator travels the ring (each hop
    overlapped).  overlap="none": full matmul then one blocking
    reduce-scatter.
    """
    n, _ = _size_rank(group)
    if overlap == "none" or n == 1:
        y = torch.matmul(x, w)
        return _reduce_scatter(y, scatter_axis % y.ndim, group)

    sa = scatter_axis % x.ndim
    s_local = x.shape[sa] // n

    def partial_chunk(c):
        return torch.matmul(x.narrow(sa, c * s_local, s_local), w)

    return ring_reduce_scatter(partial_chunk, group, axis=sa)


# ---------------------------------------------------------------------------
# Halo exchange + stencils (the paper's flagship application class)
# ---------------------------------------------------------------------------


class _Halo:
    """Both halo hops of ``halo_exchange`` in flight; ``wait()`` returns
    ``(left_halo, right_halo)``, zeroed at the global edges when not
    periodic (after the transfer, so the wire pattern is uniform)."""

    def __init__(self, u: torch.Tensor, group, halo: int, axis: int, periodic: bool):
        n, self.idx = _size_rank(group)
        self.n, self.periodic = n, periodic
        L = u.shape[axis]
        send_right = u.narrow(axis, L - halo, halo)
        send_left = u.narrow(axis, 0, halo)
        # both hops posted back to back, before any compute that follows
        self.left = _Hop(send_right, group, _fwd_perm(n))
        self.right = _Hop(send_left, group, _bwd_perm(n))

    def wait(self) -> tuple[torch.Tensor, torch.Tensor]:
        left_halo, right_halo = self.left.wait(), self.right.wait()
        if not self.periodic:
            if self.idx == 0:
                left_halo.zero_()
            if self.idx == self.n - 1:
                right_halo.zero_()
        return left_halo, right_halo


def halo_exchange(
    u: torch.Tensor,
    group=None,
    *,
    halo: int = 1,
    axis: int = 0,
    periodic: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange ``halo``-wide boundary slabs with ring neighbours.

    Returns ``(left_halo, right_halo)`` — the slabs received from the
    previous/next rank of ``group``.  Non-periodic boundaries get zero
    slabs (zeroed after the transfer so the wire pattern is uniform).
    """
    return _Halo(u, group, halo, axis, periodic).wait()


def stencil_1d_sharded(
    u: torch.Tensor,
    group,
    point_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    overlap: str = "ring",
    periodic: bool = False,
) -> torch.Tensor:
    """One 3-point-stencil sweep over a 1-D sharded array.

    ``point_fn(left, center, right)`` computes the new center value from the
    shifted neighbours (all same-shape arrays).

    overlap="ring" (paper §5.4): post the halo hops, compute the
    *interior* (needs no remote data) while they fly, then wait and patch
    the two boundary cells.  overlap="none": wait for the halos, then one
    full update — the halo transfer sits on the critical path.
    """
    L = u.shape[0]
    halos = _Halo(u, group, 1, 0, periodic)

    if overlap == "none":
        lh, rh = halos.wait()
        ext = torch.cat([lh, u, rh], dim=0)
        return point_fn(ext[:-2], ext[1:-1], ext[2:])

    _note_compute("interior")
    interior = point_fn(u[:-2], u[1:-1], u[2:])  # rows 1..L-2
    lh, rh = halos.wait()
    first = point_fn(lh[0], u[0], u[1])
    last = point_fn(u[L - 2], u[L - 1], rh[0])
    return torch.cat([first[None], interior, last[None]], dim=0)


def _jacobi_rows(dst: torch.Tensor, up: torch.Tensor, c: torch.Tensor,
                 down: torch.Tensor) -> None:
    """``dst = 0.2 * (c + up + down + left + right)`` over the interior
    columns of the rows ``c``, summed left to right in that order (the
    reference's, and the fig. 10 program's), in place."""
    torch.add(c[:, 1:-1], up[:, 1:-1], out=dst)
    dst.add_(down[:, 1:-1]).add_(c[:, :-2]).add_(c[:, 2:]).mul_(0.2)


def jacobi_step_sharded(
    full: torch.Tensor,
    group=None,
    *,
    overlap: str = "ring",
) -> torch.Tensor:
    """One 5-point Jacobi sweep on a 2-D grid sharded along rows (axis 0).

    Boundary rows/cols of the *global* grid are Dirichlet (kept fixed);
    interior is updated with the classic 0.2·(c+u+d+l+r) rule from the
    paper's Jacobi-Stencil benchmark (fig. 10), in ``full``'s dtype.
    """
    n, idx = _size_rank(group)
    L = full.shape[0]
    halos = _Halo(full, group, 1, 0, False)
    out = full.clone()

    if overlap == "none":
        lh, rh = halos.wait()
        ext = torch.cat([lh, full, rh], dim=0)
        _jacobi_rows(out[:, 1:-1], ext[:-2], ext[1:-1], ext[2:])
    else:
        # interior rows first (local-only), boundary rows after the halos.
        _note_compute("interior rows")
        _jacobi_rows(out[1:L - 1, 1:-1], full[:-2], full[1:-1], full[2:])
        lh, rh = halos.wait()
        _jacobi_rows(out[:1, 1:-1], lh, full[:1], full[1:2])
        _jacobi_rows(out[L - 1:, 1:-1], full[L - 2:L - 1], full[L - 1:], rh)

    # re-pin global Dirichlet boundary rows (first row of rank 0, last of n-1)
    if idx == 0:
        out[0] = full[0]
    if idx == n - 1:
        out[L - 1] = full[L - 1]
    return out
