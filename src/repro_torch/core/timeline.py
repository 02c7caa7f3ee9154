"""Discrete-event cluster timeline (paper §6 measurement substrate).

The scheduler emits (op, start, end, resource) events against this model;
the model supplies α–β communication costs and per-element compute costs,
and accounts busy/waiting time per process — reproducing the paper's
"time spent waiting for communication" metric.

Two built-in calibrations:

* ``GIGE_2012``  — the paper's testbed: 16 nodes, GbE (α≈50 µs,
  β≈8.4 ns/B ⇒ ~119 MB/s), ~2012-era per-core element throughput.
* ``H100_NVLINK`` — the port's target: one host's 8 H100 cards on
  NVLink, per-card bf16 compute and HBM rate from the port's roofline
  constants (``repro_torch.roofline.HW``).  Used to project the paper's
  schedule benefit onto the target hardware.
* ``TPU_V5E_ICI`` — the reference's TPU-pod projection, kept as the JAX
  package exports it: no figure of the port's card.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.roofline.analysis import HW

__all__ = ["ClusterSpec", "ProcStats", "TimelineResult", "GIGE_2012", "TPU_V5E_ICI",
           "H100_NVLINK"]


@dataclass(frozen=True)
class ClusterSpec:
    """LogGP-style model: a message of B bytes occupies each end-point NIC
    for ``o + B·β`` (send/recv overhead + bandwidth serialization) and is
    delivered after ``α + B·β`` (wire latency is pipelined — it does not
    hold the NIC, so many small messages overlap their latencies)."""

    nprocs: int
    alpha: float  # end-to-end message latency, seconds
    beta: float  # seconds per byte (inverse bandwidth)
    o_msg: float  # per-message NIC/CPU injection overhead, seconds
    elem_time: float  # seconds per scalar ufunc element
    flop_time: float  # seconds per FLOP (dense kernels, e.g. matmul)
    name: str = "cluster"

    def comm_time(self, nbytes: int) -> float:
        """End-to-end delivery time of one message."""
        return self.alpha + nbytes * self.beta

    def occupancy(self, nbytes: int) -> float:
        """NIC occupancy per message (serialization resource)."""
        return self.o_msg + nbytes * self.beta

    def with_nprocs(self, nprocs: int) -> "ClusterSpec":
        return ClusterSpec(
            nprocs,
            self.alpha,
            self.beta,
            self.o_msg,
            self.elem_time,
            self.flop_time,
            self.name,
        )

    def replace(self, **overrides) -> "ClusterSpec":
        """Derive a variant spec (same contract as the api config
        objects' ``.replace()``)."""
        import dataclasses

        return dataclasses.replace(self, **overrides)


# Paper testbed: Gigabit Ethernet, Xeon E5345 (2.33 GHz).  elem_time is
# calibrated to ~3 × 10^8 double-precision ufunc elements/s/core (NumPy-era
# memory-bound ufunc throughput); matmul at ~5 GFLOP/s/core (ATLAS dgemm).
GIGE_2012 = ClusterSpec(
    nprocs=16,
    alpha=50e-6,
    beta=1.0 / 119e6,
    o_msg=10e-6,
    elem_time=1.0 / 3.0e8,
    flop_time=1.0 / 5.0e9,
    name="gige-2012",
)

# The reference's TPU v5e-class projection (repro.core.timeline), exported
# for parity with the JAX package: ICI 50 GB/s/link, ~1 µs collective hop
# latency, 197 TFLOP/s bf16, HBM-bound ufunc elements at 819 GB/s / 4 B.
# None of these is a figure of the H100 the port runs on (H100_NVLINK).
TPU_V5E_ICI = ClusterSpec(
    nprocs=256,
    alpha=1e-6,
    beta=1.0 / 50e9,
    o_msg=0.2e-6,
    elem_time=4.0 / 819e9,
    flop_time=1.0 / 197e12,
    name="tpu-v5e-ici",
)

# One H100 host's NVLink domain, 8 cards all to all (an HGX H100 board):
# NVLink 450 GB/s a direction a card, 989 TFLOP/s bf16, HBM-bound ufunc
# elements at 3.35 TB/s / 4 B — the port's roofline constants (HW, NVIDIA's
# data sheet).  α and o_msg are assumptions, not measurements (one card
# cannot time a hop between two): 5 µs end to end for a small NCCL
# point-to-point message between two cards of a host, 1 µs to post one.
H100_NVLINK = ClusterSpec(
    nprocs=8,
    alpha=5e-6,
    beta=1.0 / HW.ici_bw,
    o_msg=1e-6,
    elem_time=4.0 / HW.hbm_bw,
    flop_time=1.0 / HW.peak_flops,
    name="h100-nvlink",
)


@dataclass
class ProcStats:
    compute_busy: float = 0.0
    comm_busy: float = 0.0  # CPU time spent inside blocking comm calls
    nic_busy: float = 0.0  # NIC occupancy (injection + serialization)
    last_end: float = 0.0
    n_compute: int = 0
    n_comm: int = 0


@dataclass
class TimelineResult:
    mode: str
    cluster: ClusterSpec
    makespan: float = 0.0
    procs: list[ProcStats] = field(default_factory=list)
    comm_bytes: int = 0
    n_comm_ops: int = 0
    n_compute_ops: int = 0
    seq_time: float = 0.0  # sum of all compute costs = 1-proc execution

    def __post_init__(self):
        if not self.procs:
            self.procs = [ProcStats() for _ in range(self.cluster.nprocs)]

    # -- paper metrics -----------------------------------------------------
    @property
    def total_compute(self) -> float:
        return sum(p.compute_busy for p in self.procs)

    @property
    def wait_fraction(self) -> float:
        """Fraction of total CPU time spent waiting for communication
        (the paper's headline metric).  Blocking comm counts as waiting."""
        if self.makespan <= 0:
            return 0.0
        total = self.cluster.nprocs * self.makespan
        return max(0.0, 1.0 - self.total_compute / total)

    @property
    def speedup(self) -> float:
        """Speedup vs. the sequential (1-process, no-comm) execution."""
        return self.seq_time / self.makespan if self.makespan > 0 else 0.0

    @property
    def ops_per_sec(self) -> float:
        """Modeled dispatch throughput: operations scheduled per
        simulated second (the measured counterpart lives on
        ``WaitStats``)."""
        total = self.n_compute_ops + self.n_comm_ops
        return total / self.makespan if self.makespan > 0 else 0.0

    @property
    def cpu_utilization(self) -> float:
        return 1.0 - self.wait_fraction

    def merge(self, other: "TimelineResult") -> "TimelineResult":
        """Accumulate a later flush into this result (timelines are
        concatenated: flushes are serialized by the interpreter)."""
        assert other.cluster.nprocs == self.cluster.nprocs
        self.makespan += other.makespan
        self.comm_bytes += other.comm_bytes
        self.n_comm_ops += other.n_comm_ops
        self.n_compute_ops += other.n_compute_ops
        self.seq_time += other.seq_time
        for mine, theirs in zip(self.procs, other.procs):
            mine.compute_busy += theirs.compute_busy
            mine.comm_busy += theirs.comm_busy
            mine.nic_busy += theirs.nic_busy
            mine.last_end += theirs.last_end
            mine.n_compute += theirs.n_compute
            mine.n_comm += theirs.n_comm
        return self

    def summary(self) -> str:
        return (
            f"[{self.mode:>14s}] makespan={self.makespan * 1e3:9.3f} ms "
            f"wait={self.wait_fraction * 100:5.1f}% "
            f"speedup={self.speedup:6.2f} "
            f"comm={self.comm_bytes / 1e6:8.2f} MB "
            f"ops={self.n_compute_ops}c/{self.n_comm_ops}m"
        )
