"""Operation-flush schedulers (paper §5.7).

``run_schedule`` is an event-driven simulation of the paper's flush
algorithm over a recorded dependency system:

* ``mode="latency_hiding"`` — the paper's algorithm: every ready
  communication is initiated immediately (non-blocking), computation is
  evaluated lazily while transfers are in flight, and a process only waits
  when it has no ready computation (§5.7 invariants 1–3).
* ``mode="blocking"`` — the paper's baseline setup: communication is
  synchronous; a transfer occupies both end-point CPUs for its duration.

The simulation maintains per-process CPU clocks and per-process NIC
clocks; transfers serialize on the NICs of both end points, compute ops on
the owner's CPU.  If an ``executor`` is supplied, each operation's payload
is executed (real NumPy block work) at the moment it is scheduled, so the
numerical result is produced by exactly the schedule being measured —
mirroring the paper, where the measured run *is* the computation.

``run_rendezvous_bsp`` demonstrates the paper's fig. 6 deadlock: the naive
bulk-synchronous evaluation with two-sided rendezvous messaging deadlocks
on schedules that the flush algorithm executes fine.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional

from repro_torch.api.registry import register_scheduler

from .graph import COMM, COMPUTE, DependencySystem, OperationNode
from .timeline import ClusterSpec, TimelineResult

__all__ = ["run_schedule", "run_rendezvous_bsp", "DeadlockError", "format_stuck_ops"]


class DeadlockError(RuntimeError):
    pass


def format_stuck_ops(ops: list[OperationNode], limit: int = 20) -> str:
    """Render pending operation-nodes for deadlock diagnostics (shared by
    the simulated scheduler and the repro_torch.exec async executor)."""
    lines = [
        f"  op#{o.uid} [{o.kind}] refcount={o.refcount} procs={o.procs} "
        f"{o.label or type(o.payload).__name__}"
        for o in ops[:limit]
    ]
    if len(ops) > limit:
        lines.append(f"  ... and {len(ops) - limit} more")
    return "\n".join(lines)


def _drain_ready(deps: DependencySystem, schedule, t: float) -> None:
    """Comm-first drain of the ready queue (invariants 2 & 3): every
    ready communication is initiated before any ready computation."""
    for kind in (COMM, COMPUTE):
        while True:
            op = deps.pop_ready(kind)
            if op is None:
                break
            schedule(op, t)


def run_schedule(
    deps: DependencySystem,
    cluster: ClusterSpec,
    mode: str = "latency_hiding",
    executor: Optional[Callable[[OperationNode], None]] = None,
) -> TimelineResult:
    """Drain ``deps`` under the chosen scheduling mode; return the timeline.

    Event-driven list scheduling: when an operation's refcount reaches zero
    it is placed on its resources at the earliest feasible time.  The
    comm-first invariant is structural: communication never competes with
    computation for the CPU in latency-hiding mode (initiation is
    non-blocking), so every ready transfer is in flight before any ready
    compute is allowed to make the process busy.

    ``deps`` may be the recorded system or a plan-stage rewrite of it
    (:mod:`repro_torch.core.plan`): coalesced transfer nodes carry their summed
    byte count, so one merged message pays a single α under the cluster
    model, and fused compute nodes carry their summed cost.
    """
    if mode not in ("latency_hiding", "blocking"):
        raise ValueError(f"unknown mode {mode!r}")
    res = TimelineResult(mode=mode, cluster=cluster)
    cpu_free = [0.0] * cluster.nprocs
    nic_free = [0.0] * cluster.nprocs
    # (end_time, seq, op) completion events
    events: list[tuple[float, int, OperationNode]] = []
    seq = itertools.count()

    def schedule(op: OperationNode, ready_t: float) -> None:
        if executor is not None:
            executor(op)
        if op.kind == COMM:
            src, dst = op.procs
            dur = cluster.comm_time(op.nbytes)
            occ = cluster.occupancy(op.nbytes)
            res.comm_bytes += op.nbytes
            res.n_comm_ops += 1
            if mode == "latency_hiding":
                # non-blocking: the NICs serialize injection/drain, the wire
                # latency is pipelined; CPUs stay free (MPI_Testsome progress)
                start = max(ready_t, nic_free[src], nic_free[dst])
                end = start + dur
                nic_free[src] = nic_free[dst] = start + occ
                res.procs[src].nic_busy += occ
                res.procs[dst].nic_busy += occ
            else:  # blocking: synchronous send/recv occupies both CPUs
                start = max(ready_t, cpu_free[src], cpu_free[dst])
                end = start + dur
                cpu_free[src] = cpu_free[dst] = end
                nic_free[src] = nic_free[dst] = end
                for p in (src, dst):
                    res.procs[p].comm_busy += dur
                    res.procs[p].n_comm += 1
                    res.procs[p].last_end = max(res.procs[p].last_end, end)
        else:
            (p,) = op.procs
            start = max(ready_t, cpu_free[p])
            end = start + op.cost
            cpu_free[p] = end
            st = res.procs[p]
            st.compute_busy += op.cost
            st.n_compute += 1
            st.last_end = max(st.last_end, end)
            res.n_compute_ops += 1
            res.seq_time += op.cost
        heapq.heappush(events, (end, next(seq), op))

    # comm-first initial drain of the ready queue (invariant 2)
    _drain_ready(deps, schedule, 0.0)

    while events:
        t, _, op = heapq.heappop(events)
        res.makespan = max(res.makespan, t)
        for newly in deps.complete(op):
            pass  # ready queue already holds them
        _drain_ready(deps, schedule, t)

    if not deps.done:
        stuck = deps.pending_ops() if hasattr(deps, "pending_ops") else []
        raise DeadlockError(
            f"{deps.n_pending} operations never became ready — dependency "
            "cycle.\nstuck operation-nodes:\n" + format_stuck_ops(stuck)
        )
    return res


# The two paper modes are the built-in entries of the scheduler
# registry; Runtime.flush resolves ``mode`` through it, so alternative
# flush disciplines plug in with one register_scheduler call.
def _registered_mode(mode: str):
    def scheduler(deps, cluster, executor=None):
        return run_schedule(deps, cluster, mode=mode, executor=executor)

    scheduler.__name__ = f"run_schedule[{mode}]"
    return scheduler


register_scheduler("latency_hiding", _registered_mode("latency_hiding"))
register_scheduler("blocking", _registered_mode("blocking"))


# ---------------------------------------------------------------------------
# Fig. 6 demonstration: naive BSP + two-sided rendezvous messaging
# ---------------------------------------------------------------------------

def run_rendezvous_bsp(
    per_proc_programs: list[list[dict]],
) -> tuple[bool, int]:
    """Simulate the paper's *naive* evaluation (fig. 6): each process walks
    its own operation list **in order**, and a two-sided rendezvous message
    blocks until the partner reaches the matching call.

    ``per_proc_programs[p]`` is a list of ops, each
    ``{"kind": "send"|"recv"|"compute", "tag": hashable, "peer": int}``.

    Returns ``(deadlocked, steps_completed)``.  The flush algorithm of
    :func:`run_schedule` cannot deadlock on the equivalent one-sided graph
    (§5.7.1); this runner shows the naive schedule can.
    """
    pc = [0] * len(per_proc_programs)
    done = lambda p: pc[p] >= len(per_proc_programs[p])
    steps = 0
    while not all(done(p) for p in range(len(pc))):
        progressed = False
        for p in range(len(pc)):
            if done(p):
                continue
            op = per_proc_programs[p][pc[p]]
            if op["kind"] == "compute":
                pc[p] += 1
                steps += 1
                progressed = True
            else:
                q = op["peer"]
                if done(q):
                    continue
                partner = per_proc_programs[q][pc[q]]
                want = "recv" if op["kind"] == "send" else "send"
                if (
                    partner["kind"] == want
                    and partner["peer"] == p
                    and partner["tag"] == op["tag"]
                ):
                    pc[p] += 1
                    pc[q] += 1
                    steps += 2
                    progressed = True
        if not progressed:
            return True, steps
    return False, steps
