"""The CUDA kernels of `mosaic_tpu_torch/kernels/csrc/pip.cu` against their
plain torch versions, on the card.

The kernels have no CPU mode, so every test here is marked ``gpu`` and
skips without CUDA. The file imports neither JAX nor the JAX package (the
CPU tests hold the plain versions to the reference), so it runs on a
machine that has PyTorch, the CUDA toolkit and one card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX.) The bar is bit
equality with the plain version (tolerance 0): both evaluate every f32
operation with round-to-nearest and no fused multiply-add.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu_torch.core.geometry.device import pack_to_device
from mosaic_tpu_torch.datasets import synthetic_zones
from mosaic_tpu_torch.kernels import pip as TP

pytestmark = pytest.mark.gpu

BBOX = (-74.0, 40.7, -73.9, 40.786)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _heavy_inputs(K, seed=9, H=37, E2=64, M2=32, pad_rows=7):
    """Random short edges with slot bits (all 32 slots, so bit 31, the
    sign bit of the int32 slot bits, is set); the last ``pad_rows`` rows
    -1."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (H, E2, 2))
    b = a + rng.uniform(-0.5, 0.5, (H, E2, 2))
    edges = np.concatenate([a, b], axis=2).astype(np.float32)
    slot = rng.integers(0, M2, (H, E2))
    bits = (np.uint32(1) << slot.astype(np.uint32)).view(np.int32)
    bits[:, -5:] = 0  # pad edges carry no bit
    geom = rng.integers(0, 50, (H, M2)).astype(np.int32)
    geom[0, 1] = -1  # an empty slot must never win
    px = rng.uniform(-1, 1, K).astype(np.float32)
    py = rng.uniform(-1, 1, K).astype(np.float32)
    rows = rng.integers(0, H, K).astype(np.int32)
    rows[max(K - pad_rows, 0):] = -1
    return px, py, rows, edges, bits, geom


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("K", [1, 129, 20_000])
def test_pip_heavy_kernel_equals_plain(cuda, K, banded):
    args = [torch.as_tensor(a, device=cuda) for a in _heavy_inputs(K)]
    eps2 = torch.tensor(1e-3, dtype=torch.float32, device=cuda) if banded else None
    before = TP.pip_heavy_tiled.launches
    kb, kn = TP.pip_heavy_tiled(*args, eps2=eps2)
    pb, pn = TP.pip_heavy_plain(*args, eps2=eps2)
    torch.cuda.synchronize()
    assert TP.pip_heavy_tiled.launches == before + 1
    assert kb.dtype == torch.int32 and kb.shape == (K,)
    assert torch.equal(kb, pb)
    if banded:
        assert torch.equal(kn, pn)
    else:
        assert kn is None and pn is None


def test_pip_heavy_kernel_empty_batch(cuda):
    """No points: no launch, empty outputs of the right types."""
    px, py, rows, edges, bits, geom = _heavy_inputs(0)
    args = [torch.as_tensor(a, device=cuda) for a in (px, py, rows, edges, bits, geom)]
    before = TP.pip_heavy_tiled.launches
    best, near = TP.pip_heavy_tiled(*args, eps2=torch.tensor(1e-3, device=cuda))
    assert TP.pip_heavy_tiled.launches == before
    assert best.shape == (0,) and best.dtype == torch.int32
    assert near.shape == (0,) and near.dtype == torch.bool


@pytest.mark.parametrize(
    "nx, ny, verts, n",
    [(5, 7, 40, 1), (5, 7, 40, 5_000), (4, 4, 256, 20_001)],
    ids=["one_point", "35_zones", "verts256"],
)
def test_pip_zone_kernel_equals_plain(cuda, nx, ny, verts, n):
    """Zone counts that are not a multiple of the kernel's 32-zone tile,
    point counts that are not a multiple of its block."""
    zones = synthetic_zones(nx, ny, bbox=BBOX, verts=verts)
    dev = pack_to_device(zones, dtype=torch.float32, recenter=True, device=cuda)
    planes, n_real = TP.edge_planes(dev)
    rng = np.random.default_rng(n)
    raw = rng.uniform(BBOX[:2], BBOX[2:], (n, 2)) - dev.shift.cpu().numpy()
    pts = torch.as_tensor(raw.astype(np.float32), device=cuda)
    before = TP.pip_zone.launches
    got = TP.pip_zone(pts, planes, n_real)
    want = TP.pip_zone_plain(pts, planes, n_real)
    torch.cuda.synchronize()
    assert TP.pip_zone.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, want)
    if n > 1000:
        assert (got >= 0).any() and (got < 0).any()


def test_pip_zone_kernel_rejects_f64(cuda):
    zones = synthetic_zones(2, 2, bbox=BBOX, verts=8)
    dev = pack_to_device(zones, dtype=torch.float64, recenter=True, device=cuda)
    planes, n_real = TP.edge_planes(dev)
    with pytest.raises(ValueError, match="float32"):
        TP.pip_zone(torch.zeros((4, 2), dtype=torch.float64, device=cuda), planes, n_real)
