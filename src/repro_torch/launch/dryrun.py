"""Dry-run every (arch × shape × mesh) cell on fake tensors.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for 512 placeholder TPU devices; the port has no compiler to
ask, so it runs the cell's step once on fake tensors at full size
(``FakeTensorMode``: shapes and dtypes, no data, nothing allocated) and
counts what it dispatches (``repro_torch.roofline.analyze_step``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh h100|pod16x16|pod2x16x16] [--out DIR]

Meshes:

* ``h100`` (the default): one card, no process group.  The record holds
  the step's FLOPs, bytes accessed and peak live bytes as counted,
  ``model_flops`` and ``useful_ratio``, the roofline terms against
  ``roofline.HW`` and ``fits``: the peak against the card's memory.
* ``pod16x16`` / ``pod2x16x16``: the production meshes over a process
  group of 512 ranks on the ``fake`` backend (the counterpart of the
  reference's 512 placeholder devices).  The record holds the per-device
  resident bytes of the parameters, plus the AdamW moments for ``train``
  or the decode state for ``decode``, under ``launch.sharding``'s specs
  (each leaf's DTensor local shape).  The step itself is not run sharded
  there: the reference runs it through GSPMD, and its DTensor
  counterpart is left for later (ROADMAP).

``--cost-pass`` records, beside the full-depth count, the reference's
two-probe linear extrapolation in depth (``_probe_pattern``): the port
counts every op it dispatches, so it needs none, and the two agree.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch.distributed as dist
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.checkpoint.store import _leaf_paths, model_tree
from repro_torch.configs import SHAPES, all_arch_ids
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import _is_spec, shardings, state_tree
from repro_torch.launch.steps import Cell, cell, skip_reason
from repro_torch.optim.adamw import named
from repro_torch.roofline.analysis import HW, analyze_step, model_flops, roofline_terms

DEFAULT_OUT = Path("results/dryrun_torch")
MESHES = {"h100": None, "pod16x16": False, "pod2x16x16": True}
# one card: every axis of the reference's mesh of size 1
H100_MESH = {"data": 1, "model": 1}
_ANALYSIS_KEYS = ("flops", "bytes_accessed", "coll_ici_bytes", "coll_dci_bytes", "coll_ops")


def fake_world(world_size: int = 512) -> None:
    """Start the process group the production meshes need: ``world_size``
    ranks on the ``fake`` backend, this process rank 0 (no peers, no
    communication)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _mesh(mesh_name: str):
    multi_pod = MESHES[mesh_name]
    if multi_pod is None:
        return H100_MESH
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _resident_bytes(tensors, specs, mesh) -> int:
    """Bytes one device holds of ``tensors`` (a tree in the layout of
    ``specs``) under ``specs``: each leaf's DTensor local shape on this
    rank of ``mesh``."""
    leaves = dict(_leaf_paths(tensors))
    total = 0
    for path, spec in _leaf_paths(specs, is_leaf=_is_spec):
        leaf = leaves[path]
        local, _ = compute_local_shape_and_global_offset(tuple(leaf.shape), mesh,
                                                         shardings(spec, mesh))
        total += math.prod(local) * leaf.dtype.itemsize
    return total


def _pod_record(c: Cell, mesh) -> dict:
    """Per-device resident bytes under the cell's specs on a pod mesh."""
    p_spec = c.in_shardings[0]
    out = {"param_bytes_per_device": _resident_bytes(model_tree(named(c.args[0])), p_spec,
                                                      mesh)}
    if c.kind == "train":
        opt_state, o_spec = c.args[1], c.in_shardings[1]
        out["opt_bytes_per_device"] = sum(
            _resident_bytes(model_tree(m), o_spec.mu, mesh) for m in (opt_state.mu, opt_state.nu))
    elif c.kind == "decode":
        out["state_bytes_per_device"] = _resident_bytes(state_tree(c.args[1]),
                                                        c.in_shardings[1], mesh)
    out["resident_bytes_per_device"] = sum(out.values())
    out["fits"] = out["resident_bytes_per_device"] <= HW.hbm_bytes
    return out


def run_cell(arch: str, shape_name: str, *, mesh_name: str = "h100", out_dir: Path,
             overrides: dict | None = None, tag: str = "") -> dict:
    t0 = time.time()
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "tag": tag,
        "status": "unknown",
    }
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return _save(rec, out_dir)
    try:
        mesh = _mesh(mesh_name)
        c = cell(arch, shape_name, mesh, **(overrides or {}))
        mf = model_flops(c.cfg, c.shape)
        rec.update(kind=c.kind, model_flops=mf)
        if MESHES[mesh_name] is None:
            analysis = analyze_step(c.fn, *c.args, n_devices=1)
            terms = roofline_terms(analysis, n_devices=1)
            peak = analysis["memory"]["peak_size_in_bytes"]
            rec.update(
                status="ok", n_devices=1,
                useful_ratio=mf / analysis["flops"] if analysis["flops"] else None,
                **analysis, **terms,
                peak_bytes=peak, fits=peak <= HW.hbm_bytes,
            )
        else:
            rec.update(status="ok", n_devices=mesh.size(), **_pod_record(c, mesh))
    except Exception as e:  # a cell that fails is recorded, and the run goes on
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    return _save(rec, out_dir)


def _probe_pattern(cfg):
    """Two shallow probe configs (k1, k2 layers) such that the full cost
    is linear: F(L) = F(k2) + (L-k2)/(k2-k1) · (F(k2)-F(k1)).

    Periodic patterns probe 1 and 2 periods; prefix+tail patterns (e.g.
    deepseek 'D'+'E'*26) probe prefix+1 and prefix+2 tail units.
    """
    pat = cfg.pattern
    L = len(pat)
    for p in range(1, L + 1):
        if L % p == 0 and pat == pat[:p] * (L // p):
            break
    if L // p > 1:
        k1, k2 = p, 2 * p
    else:
        # prefix of runs + homogeneous tail: unit = one tail layer
        tail = pat[-1]
        t0 = L
        while t0 > 0 and pat[t0 - 1] == tail:
            t0 -= 1
        k1, k2 = t0 + 1, t0 + 2
    assert (L - k2) % (k2 - k1) == 0, (pat, k1, k2)
    return k1, k2


def run_cost_probe(arch: str, shape_name: str, *, out_dir: Path,
                   overrides: dict | None = None, tag: str = "cost") -> dict:
    """The reference's extrapolated-cost record (tag='cost') on one card,
    beside the full-depth count: two shallow probes (``_probe_pattern``)
    counted and extrapolated linearly in depth."""
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": "h100", "tag": tag, "status": "unknown"}
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return _save(rec, out_dir)
    try:
        c_full = cell(arch, shape_name, H100_MESH, **(overrides or {}))
        base_cfg = c_full.cfg
        k1, k2 = _probe_pattern(base_cfg)
        L = base_cfg.n_layers
        probes = []
        for k in (k1, k2):
            ov = dict(overrides or {})
            ov.update(
                n_layers=k, layer_pattern=base_cfg.pattern[:k],
                n_enc_layers=(max(1, base_cfg.n_enc_layers * k // L)
                              if base_cfg.enc_dec else 0),
                unroll_scans=True, scan_layers=False, microbatches=1,
            )
            c = cell(arch, shape_name, H100_MESH, **ov)
            probes.append(analyze_step(c.fn, *c.args, n_devices=1))
        a1, a2 = probes
        scale = (L - k2) / (k2 - k1)

        def extrap(key):
            return a2[key] + scale * (a2[key] - a1[key])

        analysis = {key: extrap(key) for key in _ANALYSIS_KEYS}
        analysis["coll_ops"] = int(analysis["coll_ops"])
        analysis["coll_by_kind"] = {
            kk: a2["coll_by_kind"].get(kk, 0.0)
            + scale * (a2["coll_by_kind"].get(kk, 0.0) - a1["coll_by_kind"].get(kk, 0.0))
            for kk in set(a1["coll_by_kind"]) | set(a2["coll_by_kind"])
        }
        analysis["memory"] = a2["memory"]
        analysis["probe_layers"] = [k1, k2]
        full = analyze_step(c_full.fn, *c_full.args, n_devices=1)
        mf = model_flops(c_full.cfg, c_full.shape)
        terms = roofline_terms(analysis, n_devices=1)
        rec.update(
            status="ok", kind=c_full.kind, n_devices=1, model_flops=mf,
            useful_ratio=mf / analysis["flops"] if analysis["flops"] else None,
            **analysis, **terms,
            full_depth={key: full[key] for key in _ANALYSIS_KEYS},
        )
    except Exception as e:  # a cell that fails is recorded, and the run goes on
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    return _save(rec, out_dir)


def _save(rec: dict, out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{tag}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1, default=str))
    status = rec["status"]
    extra = ""
    if status == "ok" and "dominant" in rec:
        extra = (f" dom={rec['dominant']} frac={rec['roofline_fraction']:.3f}"
                 f" peak={rec['memory']['peak_size_in_bytes'] / 1e9:.2f}GB"
                 f" wall={rec.get('wall_s', 0):.0f}s")
    elif status == "ok":
        extra = f" resident={rec['resident_bytes_per_device'] / 1e9:.2f}GB/device"
    elif status == "fail":
        extra = " " + rec["error"][:140]
    print(f"[dryrun] {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:10s} {status}{extra}",
          flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="h100", choices=list(MESHES))
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (int/float/str)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--cost-pass", action="store_true",
                    help="also extrapolate the count from two shallow probes, as the "
                         "reference does (one card only); tags the record 'cost'")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                overrides[k] = {"true": True, "false": False, "none": None}.get(v.lower(), v)
    if args.cost_pass and args.mesh != "h100":
        ap.error("--cost-pass counts the step, which runs on the h100 mesh only")

    out_dir = Path(args.out)
    archs = all_arch_ids() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]

    pods = MESHES[args.mesh] is not None
    if pods:
        fake_world()
    n_fail = 0
    try:
        for arch in archs:
            for shape in shapes:
                if args.cost_pass:
                    rec = run_cost_probe(arch, shape, out_dir=out_dir, overrides=overrides,
                                         tag=args.tag or "cost")
                else:
                    rec = run_cell(arch, shape, mesh_name=args.mesh, out_dir=out_dir,
                                   overrides=overrides, tag=args.tag)
                n_fail += rec["status"] == "fail"
    finally:
        if pods:
            dist.destroy_process_group()
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
