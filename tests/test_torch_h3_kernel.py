"""H3 cell assignment through `mosaic_tpu_torch/kernels/h3.py` on the CPU.

The kernel itself runs only on the card (`tests/test_torch_h3_kernel_gpu.py`
holds it to the plain version there). Here: a CPU tensor takes the plain
torch chain and counts its points in ``h3.cells_points{lane="plain"}``
without reading a value back; numpy input counts nothing; a count made
under a CUDA graph capture runs at each replay instead; the launcher
refuses a CPU tensor; the libraries the cell assignment names on the card;
and the projection's three-term dots, written out left to right, give
numpy's bits on the CPU at the face edges.
"""

import numpy as np
import pytest
import torch

import torch_h3_points as P
from mosaic_tpu_torch.core.index.bng import BNGIndexSystem
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.index.h3 import core, hexmath as hm
from mosaic_tpu_torch.kernels import _build
from mosaic_tpu_torch.kernels import h3 as K
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.runtime.errors import KernelCompileError, KernelLaunchError

H3 = H3IndexSystem()


def _counts() -> dict:
    c = metrics.counter("h3.cells_points")
    return {(lane, v): c.value(lane=lane, variant=v)
            for lane in ("kernel", "plain") for v in ("cells", "margin", "alt")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("res", [0, 1, 9, 15])
def test_cpu_tensor_takes_the_plain_chain(dtype, res):
    xy = torch.as_tensor(P.nyc(3000, res), dtype=dtype)
    launches = K.geo_to_cell_kernel.launches
    lng, lat = torch.deg2rad(xy[:, 0]), torch.deg2rad(xy[:, 1])
    xp = hm.TorchNamespace("cpu")
    assert torch.equal(H3.point_to_cell(xy, res), core.geo_to_cell(lat, lng, res, xp))
    c, m = H3.point_to_cell_margin(xy, res)
    c2, m2 = core.geo_to_cell(lat, lng, res, xp, with_margin=True)
    assert torch.equal(c, c2) and torch.equal(m, m2) and m.dtype == dtype
    assert torch.equal(K.geo_to_cell_plain(xy, res, with_margin=True)[1], m2)
    alt = H3.point_to_cell_alt(xy, res)
    assert torch.equal(alt, core.geo_to_cell(lat, lng, res, xp, alt=True))
    assert K.geo_to_cell_kernel.launches == launches


@pytest.mark.parametrize("variant", ["cells", "margin", "alt"])
def test_plain_lane_counts_points_without_a_host_read(variant, monkeypatch):
    xy = torch.as_tensor(P.nyc(2500, 7), dtype=torch.float32)
    call = {"cells": H3.point_to_cell, "margin": H3.point_to_cell_margin,
            "alt": H3.point_to_cell_alt}[variant]
    call(xy, 9)  # warm: tables on the device, CPU vector math set up
    before = _counts()

    def refuse(*a, **k):
        raise AssertionError("the cell assignment read a value back")

    for name in ("item", "tolist", "numpy", "__int__", "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    call(xy, 9)
    call(xy.reshape(50, 50, 2), 9)
    monkeypatch.undo()
    after = _counts()
    assert after[("plain", variant)] == before[("plain", variant)] + 5000
    assert {k: v for k, v in after.items() if k != ("plain", variant)} == {
        k: v for k, v in before.items() if k != ("plain", variant)}


def test_numpy_input_counts_nothing():
    before = _counts()
    H3.point_to_cell(P.nyc(100, 3), 9)
    H3.point_to_cell_margin(P.nyc(100, 3), 9)
    assert _counts() == before


def test_a_captured_count_runs_at_each_replay_and_not_at_capture(monkeypatch):
    """Under a CUDA graph capture `_build.on_each_run` defers a host-side
    count to the capture's record, and `count_replay` runs it once a
    replay beside the launches; the record still compares as its
    launches."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with _build.captured_launches() as record:
        _build.count_launch(K.geo_to_cell_kernel)
        _build.on_each_run(lambda: calls.append(1))
    monkeypatch.undo()
    assert calls == [] and record == {K.geo_to_cell_kernel: 1}
    launches = K.geo_to_cell_kernel.launches
    for _ in range(3):
        _build.count_replay(record)
    assert calls == [1, 1, 1] and K.geo_to_cell_kernel.launches == launches + 3
    _build.count_replay({K.geo_to_cell_kernel: 2})  # a plain dict has no actions
    assert K.geo_to_cell_kernel.launches == launches + 5


def test_launcher_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.geo_to_cell_kernel(torch.zeros((4, 2)), 9)


def test_cuda_call_without_a_built_library_raises_typed(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: without one no tensor reaches the kernel")

    def no_nvcc():
        raise KernelCompileError("nvcc not found")

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises((KernelCompileError, KernelLaunchError)):
        K.geo_to_cell_kernel(torch.zeros((4, 2), device="cuda"), 9)


def test_cell_libraries_name_the_kernel_on_the_card_only():
    assert H3.cell_kernel_libraries(torch.device("cuda")) == ["h3"]
    assert H3.cell_kernel_libraries("cuda:0") == ["h3"]
    assert H3.cell_kernel_libraries("cpu") == []
    assert BNGIndexSystem().cell_kernel_libraries("cuda") == []
    assert "h3" in _build.SOURCES and set(_build.SIGNATURES["h3"]) == {
        "mosaic_h3_cells_f32", "mosaic_h3_cells_f64"}


def test_scalars_are_the_plain_chains_python_floats():
    """The kernel's scalars are the plain chain's: deg2rad's factor equals
    torch's own, and y / SIN60 runs on the card as y * (1 / SIN60) in the
    tensor's dtype."""
    one = torch.ones(1, dtype=torch.float64)
    assert float(torch.deg2rad(one)) == K.DEG2RAD
    for dtype, inv in ((torch.float32, float(np.float32(1.0) / np.float32(hm.C.SIN60))),
                       (torch.float64, 1.0 / hm.C.SIN60)):
        s = list(K._scalars(dtype, 9))
        assert s[5] == inv and s[1] == s[7] == float(hm.C.SQRT7**9 / hm.C.RES0_U_GNOMONIC)
        assert s[6] == hm.DOT_FLOOR


class _NumpyTrig(hm.TorchNamespace):
    """The torch namespace with numpy's cos and sin: torch's CPU
    transcendentals may differ from numpy's by an ulp, which would hide
    what the arithmetic after them does."""

    @staticmethod
    def cos(t):
        return torch.from_numpy(np.cos(t.numpy()))

    @staticmethod
    def sin(t):
        return torch.from_numpy(np.sin(t.numpy()))


@pytest.mark.parametrize("res", [0, 7, 9, 15])
def test_projection_dots_add_in_numpys_order(res):
    """geo_to_hex2d's three-term dots are written out left to right, so
    from the same unit vectors the torch chain's f64 projection on the CPU
    equals numpy's bit for bit at the face edges and vertices, where the
    dots of neighbouring faces tie."""
    pts = np.concatenate([P.face_edges(500, res), P.vertices(100, res)])
    lat, lng = np.radians(pts[:, 1]), np.radians(pts[:, 0])
    face, _ = hm.nearest_face(lat, lng, np)
    f_np, x_np, y_np = hm.geo_to_hex2d(lat, lng, res, face=face, xp=np)
    xp = _NumpyTrig("cpu")
    f_t, x_t, y_t = hm.geo_to_hex2d(torch.as_tensor(lat), torch.as_tensor(lng), res,
                                    face=torch.as_tensor(face), xp=xp)
    np.testing.assert_array_equal(f_t.numpy(), f_np)
    assert np.array_equal(x_t.numpy().view(np.int64), x_np.view(np.int64))
    assert np.array_equal(y_t.numpy().view(np.int64), y_np.view(np.int64))
    v = np.random.default_rng(res).standard_normal((10_000, 2, 3)) * [1.0, 1e-3, 1e3]
    assert np.array_equal(hm._dot3(v[:, 0], v[:, 1]), np.sum(v[:, 0] * v[:, 1], axis=-1))
