"""Build hand-written CUDA sources into shared libraries and load them.

Each kernel library is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared object with a plain C interface and loaded with :mod:`ctypes`:
no PyTorch headers are compiled, so a build takes seconds.  The build
runs at first use, from the sources in this package only, into
``repro_torch/kernels/_build/``; the object's name carries a hash of the
source and the flags, so an edited source is rebuilt and an unchanged
one is reused.  A failed build raises with the compiler's output.

Every library gets ``NVCC_FLAGS``; a library adds its own ``flags``
(the stencil, which must round as NumPy does, adds ``--fmad=false``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BuiltLibrary", "build_library", "BUILD_DIR"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler=-fPIC",
)

_lock = threading.Lock()  # guards _built; nvcc runs outside it
_built: dict[str, "BuiltLibrary"] = {}


@dataclass
class BuiltLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc call; 0.0 when reused
    log: str  # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are built from source at first use"
    )


def build_library(name: str, source: Path, flags: tuple = ()) -> BuiltLibrary:
    """Compile ``source`` with ``NVCC_FLAGS`` plus ``flags`` (once per
    process, and once per hash of source and flags on disk) and return the
    loaded library.  Different libraries may be built from several threads
    at once."""
    with _lock:
        if name in _built:
            return _built[name]
    text = source.read_bytes()
    all_flags = (*NVCC_FLAGS, *flags)
    digest = hashlib.sha256(text + " ".join(all_flags).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *all_flags, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {source.name} "
                f"(exit {proc.returncode}):\n{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    with _lock:
        return _built.setdefault(name, BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log))
