"""Serving driver: synthetic tenants against one shared runtime.

    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 2 --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Each tenant is a client thread submitting halo-exchange stencil
requests to a :class:`repro_torch.serve.Server`.  All tenants share one
runtime, one work-stealing worker pool and one device (``--device``,
the GPU unless the caller asks for the CPU); their request cones are
disjoint, so they drain concurrently — the demo prints each tenant's
measured wait%, request quantiles (p50/p95/p99), and the admission
counters via :func:`repro_torch.format_stats`.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np


def tenant_workload(seed: int, n: int):
    """One tenant's request: a 5-point stencil step over a private
    array, plus its NumPy closed form for verification."""
    import repro_torch

    host = np.random.default_rng(seed).standard_normal((n, n))

    def fn():
        a = repro_torch.array(host)
        b = (np.roll(a, 1, axis=0) + np.roll(a, -1, axis=0)
             + np.roll(a, 1, axis=1) + np.roll(a, -1, axis=1)) * 0.25
        return b - a * 0.5

    expect = (np.roll(host, 1, axis=0) + np.roll(host, -1, axis=0)
              + np.roll(host, 1, axis=1) + np.roll(host, -1, axis=1)) * 0.25 \
        - host * 0.5
    return fn, expect


def serve(
    tenants: int = 2,
    requests: int = 8,
    *,
    nprocs: int = 4,
    block: int = 16,
    n: int = 32,
    latency: float = 5e-3,
    max_inflight: int = 8,
    seed: int = 0,
    device=None,
):
    """Run ``tenants`` concurrent client threads, ``requests`` stencil
    requests each, against one shared Server; verifies every result and
    returns ``{tenant: TenantStats}``."""
    import repro_torch

    srv = repro_torch.Server(
        nprocs=nprocs,
        block_size=block,
        latency=latency,
        max_inflight=max_inflight,
        max_queue=max(tenants, 8),
        device=device,
    )
    mismatches = []

    def client(name: str, widx: int):
        fn, expect = tenant_workload(seed + widx, n)
        sess = srv.session(name)
        for _ in range(requests):
            got = sess.request(fn).result()
            if not np.array_equal(got, expect):
                mismatches.append(name)

    t0 = time.perf_counter()
    with srv:
        threads = [
            threading.Thread(target=client, args=(f"tenant-{i}", i))
            for i in range(tenants)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
        assert not mismatches, f"result mismatch for {sorted(set(mismatches))}"
        print(srv.format_stats())
        adm = srv.admission
        print(f"[serve] {tenants} tenants x {requests} requests in "
              f"{elapsed * 1e3:.0f} ms "
              f"({tenants * requests / elapsed:.1f} req/s); admission: "
              f"{adm.n_admitted} admitted, {adm.n_rejected} rejected, "
              f"peak inflight {adm.peak_inflight}")
        return srv.stats()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per tenant")
    ap.add_argument("--nprocs", type=int, default=4)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--latency", type=float, default=5e-3)
    ap.add_argument("--max-inflight", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device of the blocks (default: cuda)")
    a = ap.parse_args()
    serve(a.tenants, a.requests, nprocs=a.nprocs, block=a.block, n=a.n,
          latency=a.latency, max_inflight=a.max_inflight, device=a.device)


if __name__ == "__main__":
    main()
