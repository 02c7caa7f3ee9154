"""The paper's eight benchmark applications (§6, figs. 11–18) on the
PyTorch runtime — the port's counterpart of ``benchmarks/paper_apps.py``,
with the same programs, default sizes and distribution block sizes.

Every app is written in the DistArray API exactly the way the paper's
NumPy code is written (fig. 9/10) — no manual parallelism.  The blocks
and the payload compute live on the runtime's device.

:func:`run_app` runs one app in a fresh runtime; :func:`jacobi_sweeps`
is the flagship's compiled form — the same stencil as whole-grid
``jacobi_sweep`` kernel launches on one tensor, which the runtime's
result must equal bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import ExecutionPolicy, RuntimeConfig
from repro_torch.core import Runtime
from repro_torch.core import darray as dnp
from repro_torch.kernels.stencil import jacobi_sweep

__all__ = ["APPS", "run_app", "jacobi_sweeps", "stencil_sweeps"]


# ---------------------------------------------------------------------------
# applications
# ---------------------------------------------------------------------------


def fractal(n=1024, iters=20):
    """Mandelbrot set (fig. 11) — embarrassingly parallel."""
    xs = np.linspace(-2.0, 0.5, n)
    ys = np.linspace(-1.25, 1.25, n)
    cr = dnp.array(np.repeat(xs[None, :], n, axis=0))
    ci = dnp.array(np.repeat(ys[:, None], n, axis=1))
    zr = dnp.zeros((n, n))
    zi = dnp.zeros((n, n))
    count = dnp.zeros((n, n))
    for _ in range(iters):
        zr2 = zr * zr
        zi2 = zi * zi
        inside = dnp.less(zr2 + zi2, 4.0)
        count += inside
        nzr = zr2 - zi2 + cr
        nzi = 2.0 * (zr * zi) + ci
        zr = dnp.where(inside, nzr, zr)
        zi = dnp.where(inside, nzi, zi)
    return count


def black_scholes(n=2_000_000, iters=8):
    """Black–Scholes pricing (figs. 9/12) — embarrassingly parallel."""
    rng = np.random.default_rng(0)
    S = dnp.array(rng.uniform(5, 65, n))
    X = dnp.array(rng.uniform(5, 65, n))
    r, v = 0.08, 0.3

    def cnd(d):  # logistic approximation (same comm pattern as A&S poly)
        e = dnp.exp(-1.702 * d)
        return 1.0 / (1.0 + e)

    total = dnp.zeros(1)
    for i in range(1, iters + 1):
        T = i / iters
        d1 = (dnp.log(S / X) + (r + v * v / 2.0) * T) / (v * np.sqrt(T))
        d2 = d1 - v * np.sqrt(T)
        call = S * cnd(d1) - X * np.exp(-r * T) * cnd(d2)
        total += call.sum(keepdims=True) / n
    return total


def nbody(n=2048, steps=4):
    """Naive O(n²) Newtonian N-body (fig. 13).

    The pairwise matrices are built with SUMMA outer products; the force
    reduction uses broadcast-multiply + axis-sum, which the runtime
    executes as partial-reduce-at-owner + tiny partial transfers — the
    communication-avoiding form of the matvec (paper §6.1.1: the N-body
    matmuls are 'specialized operations')."""
    rng = np.random.default_rng(1)
    G, eps, dt = 6.674e-11, 1e-2, 0.1
    m_np = rng.uniform(1e5, 1e6, (n, 1))
    m = dnp.array(m_np)
    m_row = dnp.array(m_np.reshape(1, n))  # the transposed masses
    px = dnp.array(rng.uniform(0, 1e3, (n, 1)))
    py = dnp.array(rng.uniform(0, 1e3, (n, 1)))
    vx = dnp.zeros((n, 1))
    vy = dnp.zeros((n, 1))
    ones = dnp.ones((n, 1))

    def pairwise(a):
        A = dnp.matmul(a, ones, trans_b=True)  # [i, j] = a[i]
        At = dnp.matmul(ones, a, trans_b=True)  # [i, j] = a[j]
        return At - A

    for _ in range(steps):
        dx = pairwise(px)
        dy = pairwise(py)
        r2 = dx * dx + dy * dy + eps
        inv_r3 = r2 ** -1.5
        fx = G * m * (dx * inv_r3 * m_row).sum(axis=1, keepdims=True)
        fy = G * m * (dy * inv_r3 * m_row).sum(axis=1, keepdims=True)
        vx += dt * fx / m
        vy += dt * fy / m
        px += dt * vx
        py += dt * vy
    return px


def knn(n=4096, d=64):
    """Naive nearest-neighbour search (fig. 14) — O(n²) distances."""
    rng = np.random.default_rng(2)
    X = dnp.array(rng.random((n, d)))
    ones = dnp.ones((n, 1))
    G = dnp.matmul(X, X, trans_b=True)  # [n, n]
    sq = (X * X).sum(axis=1, keepdims=True)  # [n, 1]
    SQ = dnp.matmul(sq, ones, trans_b=True)  # row broadcast
    SQT = dnp.matmul(ones, sq, trans_b=True)  # col broadcast
    D = SQ + SQT - 2.0 * G
    big = dnp.ones((n, n)) * 1e18
    eye_mask = dnp.array(np.eye(n))
    D = dnp.where(eye_mask, big, D)
    return D.min(axis=1)


_D2Q9 = [(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, 1), (-1, -1), (1, -1)]
_W2 = [4 / 9] + [1 / 9] * 4 + [1 / 36] * 4


def lbm2d(h=512, w=512, steps=6):
    """D2Q9 lattice-Boltzmann channel flow (fig. 15)."""
    omega = 1.0
    f = [dnp.ones((h, w)) * wgt for wgt in _W2]
    for _ in range(steps):
        # streaming: roll each population along its lattice vector
        f = [
            dnp.roll(dnp.roll(fi, cy, axis=0), cx, axis=1)
            for fi, (cx, cy) in zip(f, _D2Q9)
        ]
        rho = f[0]
        for fi in f[1:]:
            rho = rho + fi
        ux = dnp.zeros((h, w))
        uy = dnp.zeros((h, w))
        for fi, (cx, cy) in zip(f, _D2Q9):
            if cx:
                ux = ux + float(cx) * fi
            if cy:
                uy = uy + float(cy) * fi
        ux = ux / rho
        uy = uy / rho
        usq = 1.5 * (ux * ux + uy * uy)
        for i, (cx, cy) in enumerate(_D2Q9):
            cu = 3.0 * (cx * ux + cy * uy)
            feq = _W2[i] * rho * (1.0 + cu + 0.5 * cu * cu - usq)
            f[i] = f[i] + omega * (feq - f[i])
    return f[0]


# D3Q19 velocity set
_D3Q19 = [(0, 0, 0),
          (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
          (1, 1, 0), (-1, -1, 0), (1, -1, 0), (-1, 1, 0),
          (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
          (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1)]
_W3 = [1 / 3] + [1 / 18] * 6 + [1 / 36] * 12


def lbm3d(d=64, h=64, w=64, steps=4):
    """D3Q19 lattice-Boltzmann fluid (fig. 16)."""
    omega = 1.0
    f = [dnp.ones((d, h, w)) * wgt for wgt in _W3]
    for _ in range(steps):
        f = [
            dnp.roll(dnp.roll(dnp.roll(fi, cz, 0), cy, 1), cx, 2)
            for fi, (cx, cy, cz) in zip(f, _D3Q19)
        ]
        rho = f[0]
        for fi in f[1:]:
            rho = rho + fi
        ux = dnp.zeros((d, h, w))
        uy = dnp.zeros((d, h, w))
        uz = dnp.zeros((d, h, w))
        for fi, (cx, cy, cz) in zip(f, _D3Q19):
            if cx:
                ux = ux + float(cx) * fi
            if cy:
                uy = uy + float(cy) * fi
            if cz:
                uz = uz + float(cz) * fi
        ux, uy, uz = ux / rho, uy / rho, uz / rho
        usq = 1.5 * (ux * ux + uy * uy + uz * uz)
        for i, (cx, cy, cz) in enumerate(_D3Q19):
            cu = 3.0 * (cx * ux + cy * uy + cz * uz)
            feq = _W3[i] * rho * (1.0 + cu + 0.5 * cu * cu - usq)
            f[i] = f[i] + omega * (feq - f[i])
    return f[0]


def jacobi(n=2048, nrhs=2048, iters=6):
    """Jacobi iteration on systemS of linear equations (fig. 17): one
    [n,n] matmul per sweep over the nrhs right-hand sides (SUMMA)."""
    rng = np.random.default_rng(3)
    A = rng.random((n, n)) + n * np.eye(n)
    R_np = A - np.diag(np.diag(A))
    inv_d = (1.0 / np.diag(A)).reshape(n, 1)
    R = dnp.array(R_np)
    b = dnp.array(rng.random((n, nrhs)))
    invd = dnp.array(inv_d)
    x = dnp.zeros((n, nrhs))
    for _ in range(iters):
        x = (b - dnp.matmul(R, x)) * invd
    return x


def jacobi_stencil(n=4096, iters=6):
    """Jacobi with stencil views (figs. 10/18) — the paper's flagship."""
    full = dnp.zeros((n + 2, n + 2))
    full[0, :] = 1.0
    full[:, 0] = 1.0
    return stencil_sweeps(full, iters)


def stencil_sweeps(full, iters):
    """:func:`jacobi_stencil`'s body: ``iters`` 5-point sweeps of the
    interior of ``full`` (an (n+2)² DistArray), in place; returns it."""
    for _ in range(iters):
        work = 0.2 * (
            full[1:-1, 1:-1]
            + full[0:-2, 1:-1]
            + full[2:, 1:-1]
            + full[1:-1, 0:-2]
            + full[1:-1, 2:]
        )
        full[1:-1, 1:-1] = work
    return full


# app -> (fn, default kwargs, distribution block size).  Block sizes follow
# the paper: the array is split so there are ~4-16× more blocks than the
# 16 processes (strong scaling, §6.1.2); problem sizes chosen so the
# per-block compute sits in the paper's regime (ms-scale blocks).
APPS = {
    "fractal": (fractal, {}, 128),
    "black_scholes": (black_scholes, {}, 65536),
    "nbody": (nbody, {}, 256),
    "knn": (knn, {}, 512),
    "lbm2d": (lbm2d, {}, 64),
    "lbm3d": (lbm3d, {}, 16),
    "jacobi": (jacobi, {}, 256),
    "jacobi_stencil": (jacobi_stencil, {}, 512),
}


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def run_app(
    name: str,
    config: RuntimeConfig = None,
    policy: ExecutionPolicy = None,
    **kw,
):
    """Run one paper app and return ``(stats, result)``; ``kw`` are the
    app's own arguments over its defaults.  ``config`` defaults to 16
    processes at the app's block size on the GPU, ``policy`` to the
    measured async executor on the torch backend."""
    fn, defaults, default_bs = APPS[name]
    if config is None:
        config = RuntimeConfig(nprocs=16, block_size=default_bs)
    if policy is None:
        policy = ExecutionPolicy(flush="async", backend="torch")
    with Runtime.from_config(config, policy) as rt:
        out = fn(**{**defaults, **kw})
        result = np.asarray(out) if config.execute else None
        stats = rt.stats()
    return stats, result


def jacobi_sweeps(n: int, iters: int, device=None) -> torch.Tensor:
    """:func:`jacobi_stencil`'s grid after ``iters`` sweeps, computed by
    the whole-grid ``jacobi_sweep`` kernel on one tensor (the flagship's
    compiled-sweep check).  ``device=None`` means the GPU."""
    full = torch.zeros((n + 2, n + 2), dtype=torch.float64,
                       device=torch.device("cuda" if device is None else device))
    full[0, :] = 1.0
    full[:, 0] = 1.0
    for _ in range(iters):
        full = jacobi_sweep(full)
    return full
