"""Wrapper of the bounded stream gate (``csrc/stream_gate.cu``).

A :class:`StreamGate` owns one block of pinned host memory mapped into
the device: the flag the host opens, the count of timeouts and the epochs
that timed out.  :meth:`StreamGate.wait` queues the one-thread
``gate_wait_kernel`` on a stream; the stream's later work runs once
:meth:`StreamGate.open` has been called with that epoch, or once the
kernel's time limit has passed (a timeout, counted on the device).  It
ports no TPU kernel and has no plain version: on the CPU nothing is
gated.  The library is built at first use, and a CUDA device is
required.

``launches`` counts gate launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.build import BuiltLibrary, kernel_library

__all__ = ["StreamGate", "launches", "reset_launches", "load"]

RING = 256  # kRing in stream_gate.cu: the timed-out epochs the gate keeps

launches = {"gate_wait": 0}
_count_lock = threading.Lock()
_bind_lock = threading.Lock()
_bound: set = set()


def reset_launches() -> None:
    with _count_lock:
        launches["gate_wait"] = 0


def load() -> BuiltLibrary:
    """The kernel library (built at first use, every kernel in it) with
    this module's functions declared."""
    built = kernel_library()
    with _bind_lock:
        if built.path not in _bound:
            lib, p = built.lib, ctypes.c_void_p
            u32, u64 = ctypes.c_uint32, ctypes.c_uint64
            for name, args, res in (
                ("gate_ring", [], ctypes.c_int),
                ("gate_create", [ctypes.POINTER(p), ctypes.POINTER(p)], ctypes.c_int),
                ("gate_destroy", [p], ctypes.c_int),
                ("gate_wait", [p, u32, u64, p], ctypes.c_int),
                ("gate_open", [p, u32], None),
                ("gate_timeouts", [p], u64),
                ("gate_timed_out_epoch", [p, u64], u32),
            ):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            if lib.gate_ring() != RING:
                raise RuntimeError("stream_gate.cu and ops.py disagree on the ring size")
            _bound.add(built.path)
    return built


class StreamGate:
    """One gate on ``device``: ``epoch = wait(stream, timeout_s)``, then
    the work to hold back, then ``open(epoch)``.  Epochs count up from 1;
    ``timeouts()`` and ``timed_out_epoch(n)`` read what the device wrote,
    valid once an event queued after the gate has completed.  ``close()``
    frees the gate; call it once the device is done with every gate
    queued."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"StreamGate: {self.device} is not a CUDA device")
        self._lib = load().lib
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(self.device):
            rc = self._lib.gate_create(ctypes.byref(host), ctypes.byref(dev))
        if rc != 0:
            raise RuntimeError(f"StreamGate: mapped host memory failed (cudaError {rc})")
        self._host, self._dev = host, dev
        self._epoch = 0

    def wait(self, stream: torch.cuda.Stream, timeout_s: float) -> int:
        """Queue a gate on ``stream``; returns the epoch that opens it."""
        self._epoch = (self._epoch + 1) & 0xFFFFFFFF
        with torch.cuda.device(self.device):
            rc = self._lib.gate_wait(self._dev, self._epoch, int(timeout_s * 1e9),
                                     stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"StreamGate: gate launch failed (cudaError {rc})")
        with _count_lock:
            launches["gate_wait"] += 1
        return self._epoch

    def open(self, epoch: int) -> None:
        self._lib.gate_open(self._host, epoch)

    def timeouts(self) -> int:
        return self._lib.gate_timeouts(self._host)

    def timed_out_epoch(self, n: int) -> int:
        """The epoch of timeout ``n`` (counting from 0), while it is among
        the last ``RING``."""
        return self._lib.gate_timed_out_epoch(self._host, n)

    def close(self) -> None:
        if self._host:
            rc = self._lib.gate_destroy(self._host)
            self._host = self._dev = None
            if rc != 0:
                raise RuntimeError(f"StreamGate: freeing the gate failed (cudaError {rc})")
