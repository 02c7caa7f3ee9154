"""``python -m repro_torch.analysis`` — the graph-lint entry point.

Runs real programs under ``verify="full"`` and gates on zero
diagnostics, all in-process on one device (``--device``, the GPU unless
the caller asks for the CPU):

* the Jacobi stencil (:data:`repro_torch.apps.APPS` ``"jacobi_stencil"``,
  the paper's flagship) at a lint-sized problem, so the verifier's
  precision statistic (key-level cone conflicts that were region-level
  false positives) can be read off ``Runtime.verify_stats``;
* the concurrent-drain overlap probe (:func:`lint_overlap_probe`), which
  gives the race oracle in-flight drains to check against;
* the other seven paper apps of :mod:`repro_torch.apps` at small sizes.

Every flush they perform is plan-verified and race-checked; a
:class:`~repro_torch.analysis.VerificationError` fails the program.
Writes ``results/BENCH_graph_lint_torch.json`` and exits non-zero when
any program failed verification or produced a diagnostic.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu
    PYTHONPATH=src python -m repro_torch.analysis --skip-apps   # stencil + probe
"""
from __future__ import annotations

import argparse
import json
import os
import time

REPO = os.path.abspath(
    os.path.join(os.path.dirname(__file__), os.pardir, os.pardir, os.pardir)
)

# the other paper apps at lint sizes: (app kwargs, distribution block)
APP_SIZES = {
    "fractal": (dict(n=128, iters=4), 32),
    "black_scholes": (dict(n=50_000, iters=3), 8192),
    "nbody": (dict(n=192, steps=2), 64),
    "knn": (dict(n=512, d=16), 128),
    "lbm2d": (dict(h=128, w=128, steps=2), 32),
    "lbm3d": (dict(d=16, h=16, w=16, steps=2), 8),
    "jacobi": (dict(n=256, nrhs=256, iters=3), 64),
}


def _verified(program: str, rt, t0: float) -> dict:
    vs = rt.verify_stats
    report = rt.last_verify_report
    result = {
        "program": program,
        "ok": vs.n_diagnostics == 0,
        "seconds": round(time.perf_counter() - t0, 3),
        "n_flushes_verified": vs.n_flushes_verified,
        "n_race_checks": vs.n_race_checks,
        "n_diagnostics": vs.n_diagnostics,
        "n_key_conflicts": vs.n_key_conflicts,
        "n_region_false_positives": vs.n_region_false_positives,
        "precision": vs.precision,
        "verify_seconds": vs.verify_seconds,
    }
    if report is not None and report.diagnostics:
        result["diagnostics"] = [str(d) for d in report.diagnostics]
    return result


def _failed(program: str, t0: float, exc: BaseException) -> dict:
    return {
        "program": program,
        "ok": False,
        "seconds": round(time.perf_counter() - t0, 3),
        "failure": f"{type(exc).__name__}: {exc}",
    }


def lint_app(name: str, kw: dict, block: int, nprocs: int = 4,
             device=None) -> dict:
    """Run one paper app in-process under verify="full" and return the
    verifier's counters."""
    import numpy as np

    from repro_torch.api.config import ExecutionPolicy, RuntimeConfig
    from repro_torch.apps import APPS
    from repro_torch.core.engine import Runtime

    fn, defaults, _bs = APPS[name]
    args = ", ".join(f"{k}={v}" for k, v in kw.items())
    program = f"repro_torch.apps:{name}({args})"
    config = RuntimeConfig(nprocs=nprocs, block_size=block, device=device)
    policy = ExecutionPolicy(
        flush="async", channel="async", verify="full", sync="demand"
    )
    t0 = time.perf_counter()
    try:
        with Runtime.from_config(config, policy) as rt:
            np.asarray(fn(**{**defaults, **kw}))
            return _verified(program, rt, t0)
    except Exception as exc:  # a VerificationError (or any crash) fails it
        return _failed(program, t0, exc)


def lint_overlap_probe(nprocs: int = 4, device=None) -> dict:
    """Concurrent-drain probe for the race oracle: two pairs of
    overlapping drains against one shared block.  The first pair
    conflicts only at key granularity (disjoint sub-block regions — the
    expected over-approximation), the second really overlaps, so the
    precision statistic gets a real denominator (expected 50%).

    Best-effort on counters: on a loaded box the producer drain can
    finish before the second flush checks it, so only the zero-
    diagnostics gate is asserted — the counts are reported as-is."""
    import numpy as np

    import repro_torch

    program = "repro_torch.analysis:overlap_probe"
    t0 = time.perf_counter()
    try:
        with repro_torch.runtime(nprocs=nprocs, block_size=64, flush="async",
                                 channel="async", sync="demand",
                                 verify="full", latency=2e-3,
                                 device=device) as rt:
            shared = repro_torch.zeros((64,))
            a = repro_torch.ones((256,))  # 4 blocks: rolls force halo messages
            b = repro_torch.ones((16,))
            rt.flush()  # drain creations: the probed cones are the chains

            def slow_write(lo, hi):
                # a cross-block roll chain keeps the drain in flight long
                # enough (simulated latency per halo message) for the next
                # flush's race check to see it
                c = a
                for _ in range(30):
                    c = np.roll(c, 1, axis=0) * 1.001
                shared[lo:hi] = c[lo:hi]
                return rt.flush(wait=False, targets=[shared])

            # pair 1: in-flight write of [0:16) vs read of [32:48) — same
            # block key, disjoint regions: the false positive
            t1 = slow_write(0, 16)
            y = b * 2.0 + shared[32:48]
            rt.flush(wait=False, targets=[y]).wait()
            t1.wait()
            # pair 2: in-flight write of [0:16) vs read of [8:24) — a real
            # region-level overlap
            t2 = slow_write(0, 16)
            z = b * 3.0 + shared[8:24]
            rt.flush(wait=False, targets=[z]).wait()
            t2.wait()
            np.asarray(y)
            np.asarray(z)
            return _verified(program, rt, t0)
    except Exception as exc:
        return _failed(program, t0, exc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="graph-lint: run programs under verify='full' and "
        "gate on zero diagnostics",
    )
    ap.add_argument("--device", default=None,
                    help="torch device of the blocks (default: cuda)")
    ap.add_argument("--skip-apps", action="store_true",
                    help="lint only the stencil and the overlap probe")
    ap.add_argument("--n", type=int, default=512,
                    help="stencil problem size (default 512)")
    ap.add_argument("--iters", type=int, default=3,
                    help="stencil sweeps (default 3)")
    ap.add_argument("--out", default=os.path.join(
                        REPO, "results", "BENCH_graph_lint_torch.json"),
                    help="result JSON path ('' disables the write)")
    args = ap.parse_args(argv)
    dev = args.device

    print("graph-lint: jacobi_stencil (in-process) ...", flush=True)
    results = [lint_app("jacobi_stencil", dict(n=args.n, iters=args.iters), 64,
                        device=dev)]
    print("graph-lint: concurrent-drain overlap probe ...", flush=True)
    results.append(lint_overlap_probe(device=dev))
    if not args.skip_apps:
        for name, (kw, block) in APP_SIZES.items():
            print(f"graph-lint: {name} ...", flush=True)
            results.append(lint_app(name, kw, block, device=dev))
    for r in results:
        state = "ok" if r["ok"] else "FAILED"
        if "failure" in r:
            print(f"  {r['program']}: {state} ({r['seconds']:.1f}s) — "
                  f"{r['failure']}")
            continue
        print(f"  {r['program']}: {state} ({r['seconds']:.1f}s) — "
              f"{r['n_flushes_verified']} flushes verified, "
              f"{r['n_race_checks']} race checks, "
              f"{r['n_diagnostics']} diagnostics")
        if r["precision"] is not None:
            print(f"  cone-conflict precision: {r['precision'] * 100:.1f}% "
                  f"({r['n_region_false_positives']} of "
                  f"{r['n_key_conflicts']} key-level conflicts were "
                  f"region-level false positives)")
        for d in r.get("diagnostics", ()):
            print(f"  {d}")

    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"section": "graph-lint", "device": dev or "cuda",
                       "results": results}, f, indent=2)
        print(f"wrote {args.out}")

    failed = [r["program"] for r in results if not r["ok"]]
    if failed:
        print(f"graph-lint FAILED for: {', '.join(failed)}")
        return 1
    print("graph-lint: all programs verified clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
