"""Demand-driven evaluation surface: futures over distributed arrays.

The paper drains the lazily recorded graph only when a wait state is
unavoidable; this module makes that contract *explicit* in the public
API, JAX-style:

* :func:`evaluate` — start draining the dependency cone of one or more
  arrays **without blocking**: returns :class:`ArrayFuture` handles
  (wrapping the executor's :class:`repro_torch.exec.futures.Future` via the
  runtime's :class:`~repro_torch.core.engine.FlushTicket`), while the main
  thread keeps recording.
* :func:`gather` — block until an array's cone has drained and return
  the host ``np.ndarray`` (the explicit spelling of ``np.asarray``).
* :func:`wait` — block until the given arrays/futures are ready without
  transferring data back (``DistArray.block_until_ready()`` is the
  method spelling).

Under ``ExecutionPolicy(sync="demand")`` a readback forces only the
transitive producer cone of its base; ``sync="barrier"`` restores the
paper's whole-graph flush for every call here, so the two surfaces stay
interchangeable.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

__all__ = ["ArrayFuture", "evaluate", "gather", "wait"]


class ArrayFuture:
    """Handle on the asynchronous evaluation of one DistArray.

    Holds a strong reference to the array (so its base blocks cannot be
    garbage-collected out from under the pending readback) and the
    :class:`~repro_torch.core.engine.FlushTicket` of the cone flush that is
    materializing it.  ``result()`` blocks and returns the host
    ndarray; ``block_until_ready()`` blocks without transferring.
    """

    __slots__ = ("_array", "_ticket")

    def __init__(self, array, ticket):
        self._array = array
        self._ticket = ticket

    @property
    def array(self):
        """The underlying DistArray (metadata is always available)."""
        return self._array

    @property
    def shape(self):
        return self._array.shape

    @property
    def dtype(self):
        return self._array.dtype

    def done(self) -> bool:
        """True once the cone drain submitted by ``evaluate`` finished.
        Operations recorded *after* the evaluate call are not covered —
        ``result()`` picks them up with a fresh cone flush."""
        return self._ticket is None or self._ticket.done()

    def block_until_ready(self):
        """Join the cone drain (JAX idiom); returns the DistArray."""
        if self._ticket is not None:
            self._ticket.wait()
        return self._array

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until ready and gather the host ndarray.

        ``timeout`` bounds the wait on *this future's* drain only; if
        operations were recorded on the array after ``evaluate``, the
        gather below forces their cone with a fresh (unbounded, like
        every readback) flush."""
        if self._ticket is not None:
            self._ticket.wait(timeout)
        # readback through the normal demand path: any operation recorded
        # since the evaluate() call is forced by its own cone flush here
        return np.asarray(self._array)

    def __array__(self, dtype=None, copy=None):
        arr = self.result()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        state = "ready" if self.done() else "pending"
        return (
            f"ArrayFuture(shape={self._array.shape}, "
            f"dtype={self._array.dtype}, {state})"
        )


def _as_array(x, rt):
    """Coerce one evaluate/wait operand to a DistArray (materializing
    lazy Expr trees); pass ArrayFutures through unchanged."""
    from repro_torch.core.darray import DistArray, Expr

    if isinstance(x, ArrayFuture):
        return x
    if isinstance(x, Expr):
        return x.materialize()
    if isinstance(x, DistArray):
        return x
    raise TypeError(
        f"evaluate/wait expects DistArrays, Exprs or ArrayFutures, "
        f"got {type(x).__name__}"
    )


def evaluate(*arrays) -> Union[ArrayFuture, tuple]:
    """Start evaluating ``arrays`` without blocking.

    Submits ONE non-blocking flush of the joint dependency cone of all
    requested arrays (their transitive producer closure — nothing else)
    and returns an :class:`ArrayFuture` per array, all sharing the
    in-flight :class:`~repro_torch.core.engine.FlushTicket`.  With a single
    argument the future is returned bare, else as a tuple.

    Recording continues on the calling thread while workers drain; under
    the simulated backend (or ``sync="barrier"``, which flushes the
    whole graph to preserve the paper's semantics) the returned futures
    are already completed.
    """
    from repro_torch.core.engine import current_runtime

    rt = current_runtime()
    if not arrays:
        raise TypeError("evaluate() needs at least one array")
    coerced = [_as_array(x, rt) for x in arrays]
    plain = [c.array if isinstance(c, ArrayFuture) else c for c in coerced]
    if rt.sync_mode == "barrier":
        ticket = rt.flush(wait=False)
    else:
        # DistArray targets resolve to the block keys their views touch,
        # so evaluating a sub-view forces only its sub-cone
        ticket = rt.flush(wait=False, targets=plain)
    # every returned future wraps the NEW ticket — an ArrayFuture passed
    # in is rewrapped, so waiting on the result covers the drain this
    # call just submitted (which includes any operation recorded on the
    # array since the older future was created)
    futures = tuple(ArrayFuture(a, ticket) for a in plain)
    return futures[0] if len(futures) == 1 else futures


def gather(x) -> np.ndarray:
    """Block until ``x`` is evaluated and return the host ndarray.

    Accepts a DistArray, a lazy Expr, or an :class:`ArrayFuture`; host
    ndarrays pass through.  This is the explicit spelling of
    ``np.asarray(x)`` — under ``sync="demand"`` it forces only ``x``'s
    dependency cone, blocking until that cone has drained (like every
    readback).  Raises ``RuntimeError`` when no runtime is active.
    """
    from repro_torch.core.engine import current_runtime

    if isinstance(x, ArrayFuture):
        return x.result()
    if isinstance(x, np.ndarray):
        return x
    rt = current_runtime()
    arr = _as_array(x, rt)
    return np.asarray(arr)


def wait(*xs):
    """Block until every argument is evaluated, without gathering.

    Accepts DistArrays, Exprs and ArrayFutures; returns the arguments
    (single argument bare, else a tuple) so calls chain:
    ``c = repro_torch.wait(repro_torch.evaluate(c))``.  The JAX-style method
    spelling is ``DistArray.block_until_ready()``.
    """
    if not xs:
        raise TypeError("wait() needs at least one array or future")
    plain = [x for x in xs if not isinstance(x, ArrayFuture)]
    if plain:
        evaluated = evaluate(*plain)
        futs = (evaluated,) if isinstance(evaluated, ArrayFuture) else evaluated
        for f in futs:
            f.block_until_ready()
    for x in xs:
        if isinstance(x, ArrayFuture):
            x.block_until_ready()
    return xs[0] if len(xs) == 1 else xs
