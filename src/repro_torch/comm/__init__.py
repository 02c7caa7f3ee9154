"""repro_torch.comm — the paper's communication patterns on ``torch.distributed``.

The paper's flush algorithm (§5.7) aggressively *initiates* communication
and lazily evaluates compute so transfers hide behind local work.  Each
primitive here posts its send and receive (``batch_isend_irecv``)
**before** the compute that overlaps them, and waits on them right
before the received data is used; on NCCL that wait orders the
compute stream after the transfer, so the two overlap on the card.

Each primitive has a ``overlap="ring"`` mode (the paper's latency-hiding
schedule: blocked transfers interleaved with per-block compute — §5.4's
sub-view-block walk) and an ``overlap="none"`` mode (the paper's blocking
baseline: one monolithic collective on the critical path).

The port of ``repro.comm``; :mod:`~repro_torch.comm.emulation` bridges
the modeled cluster and the runtime's transfer channels, and
:func:`~repro_torch.comm.collectives.record_collectives` records what
the primitives issue.
"""
from .collectives import (
    ag_matmul,
    halo_exchange,
    jacobi_step_sharded,
    matmul_rs,
    ring_all_gather,
    ring_reduce_scatter,
    stencil_1d_sharded,
)

__all__ = [
    "ag_matmul",
    "matmul_rs",
    "ring_all_gather",
    "ring_reduce_scatter",
    "halo_exchange",
    "stencil_1d_sharded",
    "jacobi_step_sharded",
]
