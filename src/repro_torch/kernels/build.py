"""Build the hand-written CUDA sources into one shared library and load it.

Every kernel source (``SOURCES``) is compiled by ``nvcc`` for Hopper
(``sm_90a``) into an object of its own, with its own flags: the stencil,
which must round as NumPy does, adds ``--fmad=false``; flash attention,
the SSD scan and wkv6 keep their fused multiply-adds.  The objects are
linked once into ``librepro_kernels-<hash>.so`` and loaded with
:mod:`ctypes`; each kernel family's ``ops.load()`` binds its functions in
that one library.  No PyTorch headers are compiled, so a build takes
seconds.  It runs at first use, from the sources in this package only,
into ``repro_torch/kernels/_build/``; an object's and the library's
names carry a hash of their sources and flags, so an edited source is
rebuilt and an unchanged one reused.  A failed build raises with the
compiler's output.

One library, not one a source: on the chip machine, once a
multi-threaded drain has run under ``torch.profiler`` with more than
one of the port's libraries loaded, later sessions lose device records
mid-session or read durations ~3% short; with the one library they held
(``chip_smoke.py --probe-case`` on both layouts, ``PERF.md``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

__all__ = ["BuiltLibrary", "SOURCES", "kernel_library", "BUILD_DIR"]

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
LIBRARY = "repro_kernels"

ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler=-fPIC")

# name -> (source, the flags it adds to COMPILE_FLAGS); the stencil's kernels must round as the
# NumPy interpreter does: no a*b+c contracts
SOURCES = {
    "stencil": (KERNELS_DIR / "stencil" / "csrc" / "stencil.cu", ("--fmad=false",)),
    "flash_attention": (KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu", ()),
    "ssd_scan": (KERNELS_DIR / "mamba2_scan" / "csrc" / "ssd_scan.cu", ()),
    "wkv6": (KERNELS_DIR / "rwkv6_wkv" / "csrc" / "wkv6.cu", ()),
    "stream_gate": (KERNELS_DIR / "stream_gate" / "csrc" / "stream_gate.cu", ()),
}

_lock = threading.Lock()  # one build of the kernel library a process
_built: Optional["BuiltLibrary"] = None


@dataclass
class BuiltLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc calls; 0.0 when reused
    log: str  # nvcc's output (ptxas register/shared-memory report), per source
    compile_seconds: dict  # source name -> its nvcc call's seconds (0.0: reused)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are built from source at first use"
    )


def _digest(*parts: bytes) -> str:
    return hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]


def _run_nvcc(args: list, out: Path, what: str) -> tuple[float, str]:
    """Run nvcc with ``args`` writing ``out`` (atomically, unless it
    exists).  Returns (seconds, nvcc's output)."""
    if out.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *args, "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {what} (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return seconds, log


def _compile_object(name: str) -> tuple[Path, float, str]:
    source, flags = SOURCES[name]
    all_flags = (*COMPILE_FLAGS, *flags)
    out = BUILD_DIR / f"{name}-{_digest(source.read_bytes(), ' '.join(all_flags).encode())}.o"
    seconds, log = _run_nvcc([*all_flags, "-c", str(source)], out, source.name)
    return out, seconds, log


def kernel_library() -> BuiltLibrary:
    """The one library of every kernel in ``SOURCES``: each source
    compiled to its own object (one nvcc each, all started together),
    linked once, loaded once per process."""
    global _built
    with _lock:
        if _built is not None:
            return _built
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
            objects = dict(zip(SOURCES, pool.map(_compile_object, SOURCES)))
        link = (*ARCH_FLAGS, "-shared")
        digest = _digest(*(p.name.encode() for p, _, _ in objects.values()),
                         " ".join(link).encode())
        out = BUILD_DIR / f"lib{LIBRARY}-{digest}.so"
        link_s, link_log = _run_nvcc([*link, *(str(p) for p, _, _ in objects.values())],
                                     out, out.name)
        reused = all(s == 0.0 for _, s, _ in objects.values()) and link_s == 0.0
        log = "".join(f"== {SOURCES[n][0].name}\n{lg}" for n, (_, _, lg) in objects.items())
        _built = BuiltLibrary(
            ctypes.CDLL(str(out)), out,
            0.0 if reused else time.perf_counter() - t0,
            log + link_log,
            {n: s for n, (_, s, _) in objects.items()},
        )
        return _built

