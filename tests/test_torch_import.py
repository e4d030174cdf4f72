"""The port stands alone: no JAX, no mosaic_tpu, and the card by default."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mosaic_tpu_torch"

MODULES = [
    "mosaic_tpu_torch",
    "mosaic_tpu_torch.convert",
    "mosaic_tpu_torch.datasets",
    "mosaic_tpu_torch.core.tessellate",
    "mosaic_tpu_torch.core.geometry.device",
    "mosaic_tpu_torch.core.index.h3",
    "mosaic_tpu_torch.core.index.custom",
    "mosaic_tpu_torch.dispatch.bucket",
    "mosaic_tpu_torch.kernels.pip",
    "mosaic_tpu_torch.kernels.zonal",
    "mosaic_tpu_torch.kernels._build",
    "mosaic_tpu_torch.raster",
    "mosaic_tpu_torch.raster.zonal",
    "mosaic_tpu_torch.runtime",
    "mosaic_tpu_torch.runtime.escalate",
    "mosaic_tpu_torch.runtime.watchdog",
    "mosaic_tpu_torch.obs.trace",
    "mosaic_tpu_torch.context",
    "mosaic_tpu_torch.dispatch.core",
    "mosaic_tpu_torch.core.index.bng",
    "mosaic_tpu_torch.tools.calibrate_margins",
    "mosaic_tpu_torch.sql.join",
    "mosaic_tpu_torch.sql.stream",
    "mosaic_tpu_torch.sql.raster_stream",
    "mosaic_tpu_torch.dispatch.pipeline",
    "mosaic_tpu_torch.runtime.checkpoint",
    "mosaic_tpu_torch.runtime.quarantine",
    "mosaic_tpu_torch.obs.metrics",
    "mosaic_tpu_torch.tune.resolve",
    "mosaic_tpu_torch.core.geometry.oracle",
    "mosaic_tpu_torch.dispatch",
    "mosaic_tpu_torch.dispatch.programs",
    "mosaic_tpu_torch.obs.slo",
    "mosaic_tpu_torch.obs.health",
    "mosaic_tpu_torch.serve",
    "mosaic_tpu_torch.serve.admission",
    "mosaic_tpu_torch.serve.batcher",
    "mosaic_tpu_torch.serve.bucket",
    "mosaic_tpu_torch.serve.engine",
    "mosaic_tpu_torch.serve.router",
    "mosaic_tpu_torch.expr",
    "mosaic_tpu_torch.expr.ast",
    "mosaic_tpu_torch.expr.compile",
    "mosaic_tpu_torch.expr.eval",
    "mosaic_tpu_torch.expr.host_oracle",
    "mosaic_tpu_torch.kernels.overlay",
    "mosaic_tpu_torch.sql.overlay",
    "mosaic_tpu_torch.core.geometry.hostops",
    "mosaic_tpu_torch.tools.first_call_sweep",
    "mosaic_tpu_torch.core.geometry.predicates",
    "mosaic_tpu_torch.functions.geometry",
    "mosaic_tpu_torch.knn",
    "mosaic_tpu_torch.knn.frontend",
    "mosaic_tpu_torch.knn.index",
    "mosaic_tpu_torch.knn.oracle",
    "mosaic_tpu_torch.models",
    "mosaic_tpu_torch.models.knn",
    "mosaic_tpu_torch.index",
    "mosaic_tpu_torch.index.epoch",
    "mosaic_tpu_torch.tune",
    "mosaic_tpu_torch.tune.profiler",
    "mosaic_tpu_torch.tune.recommend",
    "mosaic_tpu_torch.tune.store",
    "mosaic_tpu_torch.sql.analyzer",
    "mosaic_tpu_torch.functions._coerce",
    "mosaic_tpu_torch.tools.card_priors",
]


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mosaic_tpu' or m.startswith('mosaic_tpu.')]\n"
        "print(bad)\nsys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_stream_modules_leave_jax_and_reference_out():
    """The streaming slice's entry modules, imported alone."""
    code = (
        "import mosaic_tpu_torch.sql.stream, mosaic_tpu_torch.sql.raster_stream, "
        "mosaic_tpu_torch.dispatch.pipeline, sys; "
        "assert 'jax' not in sys.modules and 'mosaic_tpu' not in sys.modules"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serve_modules_leave_jax_and_reference_out():
    """The serving slice's entry modules, imported alone."""
    code = (
        "import mosaic_tpu_torch.serve, mosaic_tpu_torch.dispatch, sys; "
        "assert 'jax' not in sys.modules and 'mosaic_tpu' not in sys.modules"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_expr_and_overlay_modules_leave_jax_and_reference_out():
    """The expression compiler's and the overlay join's entry modules,
    imported alone."""
    code = (
        "import mosaic_tpu_torch.expr, mosaic_tpu_torch.sql.overlay, sys; "
        "assert 'jax' not in sys.modules and 'mosaic_tpu' not in sys.modules"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_knn_modules_leave_jax_and_reference_out():
    """The KNN slice's entry modules, imported alone."""
    code = (
        "import mosaic_tpu_torch.knn, mosaic_tpu_torch.models, sys; "
        "assert 'jax' not in sys.modules and 'mosaic_tpu' not in sys.modules"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "mosaic_tpu"), f"{path}: imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    from mosaic_tpu_torch import DeviceUnavailable, resolve_device

    with pytest.raises(DeviceUnavailable, match="device='cpu'"):
        resolve_device()
    with pytest.raises(DeviceUnavailable):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_entry_points_raise_without_cuda(no_cuda):
    from mosaic_tpu_torch import DeviceUnavailable
    from mosaic_tpu_torch.core.geometry.device import pack_to_device
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.datasets import synthetic_zones
    from mosaic_tpu_torch.sql.join import build_chip_index, pip_join

    zones = synthetic_zones(1, 1, bbox=(-74.0, 40.7, -73.99, 40.71), verts=8)
    pts = np.asarray([[-73.995, 40.705]])
    with pytest.raises(DeviceUnavailable):
        pip_join(pts, zones, H3IndexSystem(), 9)
    with pytest.raises(DeviceUnavailable):  # never answered by the host oracle
        pip_join(pts, zones, H3IndexSystem(), 9, recheck=True)
    with pytest.raises(DeviceUnavailable):
        pack_to_device(zones)
    from mosaic_tpu_torch.core.tessellate import tessellate

    table = tessellate(zones, H3IndexSystem(), 9, keep_core_geoms=False)
    with pytest.raises(DeviceUnavailable):
        build_chip_index(table)
    # the same calls run when the CPU is asked for
    ix = build_chip_index(table, device="cpu")
    out = pip_join(pts, None, H3IndexSystem(), 9, chip_index=ix, device="cpu")
    assert out.shape == (1,) and out.dtype == np.int32
    out = pip_join(pts, None, H3IndexSystem(), 9, chip_index=ix, device="cpu",
                   recheck=True)
    assert out.shape == (1,) and not getattr(out, "degraded", False)
    from mosaic_tpu_torch.sql.stream import StreamJoin, hbm_peak, ring_from_host

    with pytest.raises(DeviceUnavailable):
        ring_from_host([pts])
    with pytest.raises(DeviceUnavailable):
        hbm_peak()
    ring = ring_from_host([pts], device="cpu")
    assert StreamJoin(ix, H3IndexSystem(), 9).run(ring, 1).n_points == 1
    from mosaic_tpu_torch.tools.calibrate_margins import measure_cell_drift

    with pytest.raises(DeviceUnavailable):
        measure_cell_drift(H3IndexSystem(), pts, 9)
    assert measure_cell_drift(H3IndexSystem(), pts, 9, device="cpu")["resolution"] == 9
    from mosaic_tpu_torch.serve import ServeEngine

    with ServeEngine(ix, H3IndexSystem(), 9) as eng:  # the index's device
        assert eng.core.device.type == "cpu"
        assert eng.join(pts, deadline_s=30.0).shape == (1,)
    from mosaic_tpu_torch import expr as E
    from mosaic_tpu_torch.raster import Raster
    from mosaic_tpu_torch.sql.overlay import intersects_join, overlay_measures

    r = Raster(data=np.ones((2, 4, 4)), gt=(-74.0, 0.001, 0.0, 40.71, 0.0, -0.001))
    with pytest.raises(DeviceUnavailable):
        E.map_pixels(E.ndvi(), r)
    assert E.map_pixels(E.ndvi(), r, device="cpu")[1].all()
    with pytest.raises(DeviceUnavailable):
        overlay_measures(zones, zones, H3IndexSystem(), 9)
    got = overlay_measures(zones, zones, H3IndexSystem(), 9, device="cpu")
    assert got.lane == "device" and got.pairs.tolist() == [[0, 0]]
    with pytest.raises(DeviceUnavailable):  # never answered by the host oracle
        intersects_join(zones, zones, H3IndexSystem(), 9)
    assert intersects_join(zones, zones, H3IndexSystem(), 9,
                           device="cpu").tolist() == [[0, 0]]
