"""Measured wait-for-communication statistics (wall-clock counterpart of
:class:`repro_torch.core.timeline.TimelineResult`).

The discrete-event simulator *models* the paper's headline metric — the
fraction of CPU time each process spends waiting for communication.  The
asynchronous executor *measures* it: every worker thread accounts the
wall-clock time it spends executing compute payloads (busy), blocked
inside channel operations (comm wait), and idle with an empty ready
queue (dependency wait).  :class:`WaitStats` exposes the same properties
and ``summary()`` layout as ``TimelineResult`` so the two can be printed
side by side in the paper tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["WorkerStats", "WaitStats"]


@dataclass
class WorkerStats:
    """Per-worker accounting (mirrors ``ProcStats``).

    * ``compute_busy``: the time compute payloads take.  With blocks on
      the CPU it is per-thread CPU time around each payload (GIL and
      scheduler preemption excluded), as in the reference.  With blocks
      on a CUDA device it is device time: a CUDA event pair around each
      payload or grouped launch on the stream it launches on, split
      across a group's ops by element count.  A stream gate holds each
      pair's start event until the whole payload is queued, so a pair
      counts the payload's kernels and the device's gaps between them,
      not the host's dispatch.  The executor serialises the pairs, so
      their sum over all workers is the device's busy time.
    * ``host_busy``: per-thread CPU time around each payload on either
      device — on a GPU the host's cost of queueing it (a launch returns
      once it is queued).  Equal to ``compute_busy`` on the CPU.
    * ``comm_busy`` and ``idle`` are wall-clock — being blocked is the
      thing measured.
    * ``gate_timeouts``: payloads whose stream gate let go on its time
      limit before the host opened it (a payload that synchronised
      inside, or a host slower than the limit), read from the device when
      the drain settles; their pairs count from the timeout on.  Always 0
      on the CPU, where nothing is gated."""

    compute_busy: float = 0.0  # executing compute payloads (see above)
    host_busy: float = 0.0  # host CPU time spent launching compute payloads
    comm_busy: float = 0.0  # blocked inside channel ops (blocking mode)
    idle: float = 0.0  # ready queue empty, waiting on dependencies
    n_compute: int = 0
    n_comm: int = 0
    n_wakeups: int = 0  # queue pops (one per batch under batched dispatch)
    n_steals: int = 0  # successful steal attempts (batches taken)
    n_stolen: int = 0  # ops obtained by stealing from loaded peers
    gate_timeouts: int = 0  # gated payloads whose gate timed out (see above)

    def absorb(self, other: "WorkerStats") -> None:
        self.compute_busy += other.compute_busy
        self.host_busy += other.host_busy
        self.comm_busy += other.comm_busy
        self.idle += other.idle
        self.n_compute += other.n_compute
        self.n_comm += other.n_comm
        self.n_wakeups += other.n_wakeups
        self.n_steals += other.n_steals
        self.n_stolen += other.n_stolen
        self.gate_timeouts += other.gate_timeouts

    def snapshot(self) -> "WorkerStats":
        """Value copy, taken by the persistent executor at submit time so
        each drain's stats are a delta, not the lifetime totals."""
        return WorkerStats(
            compute_busy=self.compute_busy,
            host_busy=self.host_busy,
            comm_busy=self.comm_busy,
            idle=self.idle,
            n_compute=self.n_compute,
            n_comm=self.n_comm,
            n_wakeups=self.n_wakeups,
            n_steals=self.n_steals,
            n_stolen=self.n_stolen,
            gate_timeouts=self.gate_timeouts,
        )

    def since(self, base: "WorkerStats") -> "WorkerStats":
        """Per-drain delta: current totals minus a ``snapshot()``."""
        return WorkerStats(
            compute_busy=self.compute_busy - base.compute_busy,
            host_busy=self.host_busy - base.host_busy,
            comm_busy=self.comm_busy - base.comm_busy,
            idle=self.idle - base.idle,
            n_compute=self.n_compute - base.n_compute,
            n_comm=self.n_comm - base.n_comm,
            n_wakeups=self.n_wakeups - base.n_wakeups,
            n_steals=self.n_steals - base.n_steals,
            n_stolen=self.n_stolen - base.n_stolen,
            gate_timeouts=self.gate_timeouts - base.gate_timeouts,
        )


@dataclass
class WaitStats:
    """Aggregated measured timeline of one (or several merged) flushes."""

    mode: str  # "async" | "blocking-channel"
    nworkers: int
    elapsed: float = 0.0  # wall-clock duration of the drain(s)
    procs: list[WorkerStats] = field(default_factory=list)
    comm_bytes: int = 0
    n_comm_ops: int = 0
    n_compute_ops: int = 0
    seq_time: float = 0.0  # Σ measured compute durations = 1-worker time
    n_flushes: int = 0
    # dispatch-overhead counters (plan-stage batching/coalescing wins)
    n_handoffs: int = 0  # producer→worker queue pushes (wakeup requests)
    n_messages: int = 0  # messages posted on the transfer channel

    def __post_init__(self):
        if not self.procs:
            self.procs = [WorkerStats() for _ in range(self.nworkers)]

    # -- paper metrics (same contract as TimelineResult) ------------------
    @property
    def makespan(self) -> float:
        return self.elapsed

    @property
    def total_compute(self) -> float:
        return sum(p.compute_busy for p in self.procs)

    @property
    def total_host(self) -> float:
        """Σ host CPU time spent launching compute (``host_busy``)."""
        return sum(p.host_busy for p in self.procs)

    @property
    def wait_fraction(self) -> float:
        """Measured fraction of worker time not spent computing.  Time
        blocked in synchronous channel calls counts as waiting, exactly as
        blocking communication does in the simulated metric."""
        if self.elapsed <= 0:
            return 0.0
        total = self.nworkers * self.elapsed
        return max(0.0, 1.0 - self.total_compute / total)

    @property
    def cpu_utilization(self) -> float:
        return 1.0 - self.wait_fraction

    @property
    def speedup(self) -> float:
        """Measured speedup vs. draining every compute payload on one
        worker (Σ compute durations / wall-clock)."""
        return self.seq_time / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def comm_wait_fraction(self) -> float:
        """Share of worker time blocked specifically inside channel ops."""
        if self.elapsed <= 0:
            return 0.0
        return sum(p.comm_busy for p in self.procs) / (self.nworkers * self.elapsed)

    def merge(self, other: "WaitStats") -> "WaitStats":
        """Accumulate a later flush (flushes are serialized, so wall-clock
        durations add).

        Merging stats from runs with different worker counts pads
        ``procs`` to the wider of the two — ``zip`` would silently drop
        the extra workers' accounting (and misattribute rank i of one
        run to rank i of the other being the *same* thread, which they
        are not across runtimes; per-rank rows after a mixed merge are
        positional sums, the totals are exact)."""
        if other.nworkers > self.nworkers:
            self.procs.extend(
                WorkerStats() for _ in range(other.nworkers - self.nworkers)
            )
            self.nworkers = other.nworkers
        self.elapsed += other.elapsed
        self.comm_bytes += other.comm_bytes
        self.n_comm_ops += other.n_comm_ops
        self.n_compute_ops += other.n_compute_ops
        self.seq_time += other.seq_time
        self.n_flushes += max(1, other.n_flushes)
        self.n_handoffs += other.n_handoffs
        self.n_messages += other.n_messages
        for mine, theirs in zip(self.procs, other.procs):
            mine.absorb(theirs)
        return self

    @property
    def n_steals(self) -> int:
        """Successful work-steal batches across all workers."""
        return sum(p.n_steals for p in self.procs)

    @property
    def n_stolen(self) -> int:
        """Ops moved between workers by stealing."""
        return sum(p.n_stolen for p in self.procs)

    @property
    def gate_timeouts(self) -> int:
        """Gated payloads whose stream gate timed out (see
        :class:`WorkerStats`); 0 on the CPU."""
        return sum(p.gate_timeouts for p in self.procs)

    @property
    def ops_per_sec(self) -> float:
        """Measured dispatch throughput: operations drained per
        wall-clock second."""
        total = self.n_compute_ops + self.n_comm_ops
        return total / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def handoffs_per_flush(self) -> float:
        """Worker-queue pushes per flush — the lock+event round trips
        that batched dispatch amortizes."""
        return self.n_handoffs / max(1, self.n_flushes)

    @property
    def messages_per_flush(self) -> float:
        """Messages posted on the transfer channel per flush — what
        transfer coalescing reduces."""
        return self.n_messages / max(1, self.n_flushes)

    def summary(self) -> str:
        return (
            f"[{self.mode:>14s}] makespan={self.elapsed * 1e3:9.3f} ms "
            f"wait={self.wait_fraction * 100:5.1f}% "
            f"speedup={self.speedup:6.2f} "
            f"comm={self.comm_bytes / 1e6:8.2f} MB "
            f"ops={self.n_compute_ops}c/{self.n_comm_ops}m "
            f"handoffs={self.n_handoffs} msgs={self.n_messages}"
        )

    def per_worker_table(self) -> str:
        lines = [f"{'worker':>6s} {'compute ms':>11s} {'comm-wait ms':>13s} "
                 f"{'idle ms':>9s} {'ops':>9s} {'wakeups':>8s}"]
        for i, p in enumerate(self.procs):
            lines.append(
                f"{i:6d} {p.compute_busy * 1e3:11.3f} {p.comm_busy * 1e3:13.3f} "
                f"{p.idle * 1e3:9.3f} {p.n_compute:4d}c/{p.n_comm:3d}m "
                f"{p.n_wakeups:8d}"
            )
        return "\n".join(lines)
