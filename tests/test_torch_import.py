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
    "mosaic_tpu_torch.kernels.pip",
    "mosaic_tpu_torch.kernels._build",
    "mosaic_tpu_torch.runtime.escalate",
    "mosaic_tpu_torch.sql.join",
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
