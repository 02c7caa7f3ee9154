"""repro_torch — runtime-managed communication latency-hiding for NumPy
programs (reproduction of cs.DC 2012), on PyTorch and CUDA.

The port of :mod:`repro` (the JAX package, kept as the reference): the
same lazy record → plan → execute runtime, with the block store and the
payload compute on a ``torch.device`` — the GPU unless the caller asks
for the CPU — and the fused stencil payloads on hand-written CUDA
kernels (:mod:`repro_torch.kernels.stencil`).  The programming model
stays plain NumPy::

    import numpy as np
    import repro_torch

    with repro_torch.runtime(nprocs=16, block_size=64, flush="async"):
        a = repro_torch.array(np.arange(65536.0).reshape(256, 256))
        b = np.exp(a) + np.sum(a, axis=0, keepdims=True)  # recorded lazily
        out = np.asarray(b)  # readback triggers the flush

The public front-end lives in :mod:`repro_torch.api` and is re-exported
here lazily (PEP 562).
"""
from __future__ import annotations

_API_EXPORTS = (
    "runtime",
    "RuntimeConfig",
    "ExecutionPolicy",
    "ServeConfig",
    "Runtime",
    "FlushTicket",
    "current_runtime",
    "ArrayFuture",
    "evaluate",
    "gather",
    "wait",
    "register_backend",
    "get_backend",
    "available_backends",
    "register_channel",
    "get_channel",
    "available_channels",
    "register_scheduler",
    "get_scheduler",
    "available_schedulers",
    "register_pass",
    "get_pass",
    "available_passes",
    "register_rule",
    "get_rule",
    "available_rules",
    "check",
    "Diagnostic",
    "AnalysisReport",
    "VerificationError",
    "VerifyStats",
    "DistArray",
    "array",
    "empty",
    "zeros",
    "ones",
    "full",
    "arange",
    "random",
    "ClusterSpec",
    "GIGE_2012",
    "TPU_V5E_ICI",
    "H100_NVLINK",
    "format_stats",
    "trace",
    "TraceCollector",
    "export_trace",
    "validate_trace",
    "attribution",
    "AttributionReport",
    "Server",
    "Session",
    "Request",
    "TenantStats",
    "AdmissionError",
    "LatencyHistogram",
)

__all__ = list(_API_EXPORTS)


def __getattr__(name):
    if name in _API_EXPORTS:
        from repro_torch import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API_EXPORTS))
