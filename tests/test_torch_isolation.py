"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package, and needs a GPU unless the caller asks for the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s+import\b))",
    re.MULTILINE,
)


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.apps\n"
        "import repro_torch.exec, repro_torch.core.plan_cache\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.launch.steps\n"
        "import repro_torch.models.convert, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.mamba2_scan, repro_torch.kernels.rwkv6_wkv\n"
        "import repro_torch.models.mamba2, repro_torch.models.rwkv6\n"
        "import repro_torch.analysis, repro_torch.analysis.__main__\n"
        "import repro_torch.obs, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.comm, repro_torch.comm.collectives, repro_torch.roofline\n"
        "import repro_torch.launch.mesh, repro_torch.launch.sharding\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.train\n"
        "for name in repro_torch.__all__: getattr(repro_torch, name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "from repro.core import engine", "from repro import api"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import engine",
                 "import jaxlib", "x = 1  # import jax later"):
        assert not _FORBIDDEN.search(line), line


def test_runtime_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.runtime()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.Runtime(nprocs=2)


def test_lm_entry_points_without_device_need_a_gpu():
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params, make_decode_state
    from repro_torch.models.attention import init_kv_cache
    from repro_torch.models.convert import params_from_jax

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    cfg = get_reduced("h2o-danube-3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_decode_state(cfg, 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_kv_cache(cfg, 2, 32, cfg.n_layers)


def test_unported_features_raise():
    """The port lacks no feature of the reference any more: the sharded
    collectives it lacked last are there, with the reference's names."""
    import repro_torch.comm

    names = ["ring_all_gather", "ring_reduce_scatter", "ag_matmul", "matmul_rs",
             "halo_exchange", "stencil_1d_sharded", "jacobi_step_sharded"]
    assert sorted(repro_torch.comm.__all__) == sorted(names)
    assert all(callable(getattr(repro_torch.comm, n)) for n in names)


def test_every_reference_module_has_a_counterpart():
    """Each ``.py`` of ``src/repro`` has one at the same relative path in
    ``src/repro_torch``, the Pallas kernels' ``kernel.py`` and ``ref.py``
    aside (their CUDA sources and plain versions stand in for them)."""
    ref = ROOT / "src" / "repro"
    port = ROOT / "src" / "repro_torch"
    missing = [str(f.relative_to(ref)) for f in sorted(ref.rglob("*.py"))
               if not (f.parts[-3] == "kernels" and f.name in ("kernel.py", "ref.py"))
               and not (port / f.relative_to(ref)).exists()]
    assert not missing, missing


def test_exports_cover_the_reference():
    """Every name the JAX package exports, the port exports too."""
    pytest.importorskip("jax")
    import repro

    assert set(repro.__all__) <= set(repro_torch.__all__)
    from repro import api as ref_api
    from repro_torch import api

    assert set(ref_api.__all__) <= set(api.__all__)


def test_verify_and_trace_export_run(tmp_path, monkeypatch):
    """verify="plan"|"full", REPRO_VERIFY, trace="path", REPRO_TRACE=path
    and trace(path), which raised before the port had them."""
    import numpy as np

    for verify in ("plan", "full"):
        with repro_torch.runtime(device="cpu", flush="async", verify=verify) as rt:
            np.asarray(repro_torch.array(np.ones(8)) + 1.0)
            assert rt.verify_stats.n_flushes_verified >= 1
    monkeypatch.setenv("REPRO_VERIFY", "plan")
    assert repro_torch.Runtime(nprocs=2, device="cpu").verify_mode == "plan"
    monkeypatch.delenv("REPRO_VERIFY")
    paths = [tmp_path / f"{k}.json" for k in range(3)]
    with repro_torch.runtime(device="cpu", flush="async", trace=str(paths[0])):
        np.asarray(repro_torch.array(np.ones(8)) + 1.0)
    monkeypatch.setenv("REPRO_TRACE", str(paths[1]))
    with repro_torch.runtime(device="cpu", flush="async"):
        np.asarray(repro_torch.array(np.ones(8)) + 1.0)
    monkeypatch.delenv("REPRO_TRACE")
    with repro_torch.trace(str(paths[2])):
        with repro_torch.runtime(device="cpu", flush="async"):
            np.asarray(repro_torch.array(np.ones(8)) + 1.0)
    for path in paths:
        assert repro_torch.validate_trace(str(path))["n_events"] > 0
