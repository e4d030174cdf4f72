"""The H3 cell kernel of `mosaic_tpu_torch/kernels/csrc/h3.cu` against its
plain torch version, on the card.

The kernel has no CPU mode, so every test here is marked ``gpu`` and skips
without CUDA. The file imports neither JAX nor the JAX package, so it runs
on a machine that has PyTorch, the CUDA toolkit and one card:

    python -m pytest --noconftest -m gpu tests/test_torch_h3_kernel_gpu.py

The bar is bit equality with the plain version (`kernels/h3.py
geo_to_cell_plain`, the eager torch chain) on the same card: cells
exactly, margins through an integer view (``torch.equal`` takes -0.0 for
+0.0 and never equals a NaN), in float32 and float64, at every resolution,
for globe-uniform points, the NYC box, points within 1e-9 degrees of face
edges and icosahedron vertices, the 12 pentagons' neighbourhoods, the
poles and the antimeridian, non-finite rows, and the benchmark's own
uniform and curbside points; through strided and column-major inputs,
inside a CUDA graph, and with no host sync once warm. The points counter
``h3.cells_points`` counts what the card assigned, replays included.
"""

import pytest
import torch

import torch_h3_points as P
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.kernels import _build
from mosaic_tpu_torch.kernels import h3 as K
from mosaic_tpu_torch.obs import metrics

pytestmark = pytest.mark.gpu

H3 = H3IndexSystem()
RESOLUTIONS = list(range(16))
DTYPES = [torch.float32, torch.float64]
#: globe-uniform points of the widest case
N_GLOBE = 16 * 2**20


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _assert_same(xy: torch.Tensor, res: int) -> None:
    """Kernel and plain version give the same cells alone, and the same
    cells and margin bits together."""
    got = K.geo_to_cell_kernel(xy, res)
    want = K.geo_to_cell_plain(xy, res)
    assert got.dtype == torch.int64 and got.shape == want.shape
    bad = (got != want).reshape(-1).nonzero()[:, 0]
    assert bad.numel() == 0, (
        f"{bad.numel()} of {got.numel()} cells differ at res {res}; first rows "
        f"{xy.reshape(-1, 2)[bad[:4]].tolist()}"
    )
    got_c, got_m = K.geo_to_cell_kernel(xy, res, with_margin=True)
    want_c, want_m = K.geo_to_cell_plain(xy, res, with_margin=True)
    assert torch.equal(got_c, want_c) and torch.equal(got_c, got)
    assert got_m.dtype == xy.dtype and got_m.shape == want_m.shape
    bad = (_bits(got_m) != _bits(want_m)).any(dim=-1).reshape(-1).nonzero()[:, 0]
    assert bad.numel() == 0, (
        f"{bad.numel()} margin rows differ at res {res}; first rows "
        f"{xy.reshape(-1, 2)[bad[:4]].tolist()}"
    )


def _bench_rings(dev, seed: int = 3_000_000_019, n: int = 4_000_000) -> dict:
    """The benchmark's uniform and curbside points from one seed, made as
    its harness makes them (float64, on the card)."""
    import json
    import os

    from geobench import points, polygons

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = json.load(open(os.path.join(root, "geobench", "configs", "taxi_zones_r9.json")))
    polys = polygons.make(cfg["polygons"])
    out = {}
    for traffic in ("stream_pickups", "stream_curbside"):
        spec = json.load(open(os.path.join(root, "geobench", "traffic", f"{traffic}.json")))
        gen = points.generator(seed, dev)
        out[traffic] = points.make(spec["points"], cfg, polys, n, gen, dev)
    return out


INPUTS = ["nyc", "face_edges", "vertices", "pentagons", "extremes", "non_finite"]


@pytest.fixture(scope="module")
def inputs(cuda):
    arrays = {
        "nyc": P.nyc(1_000_000, 5),
        "face_edges": P.face_edges(),
        "vertices": P.vertices(),
        "pentagons": P.pentagons(),
        "extremes": P.extremes(),
        "non_finite": P.non_finite(),
    }
    return {k: torch.as_tensor(v, device=cuda) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def globe(cuda):
    return torch.as_tensor(P.globe(N_GLOBE, 1), device=cuda)


@pytest.fixture(scope="module")
def rings(cuda):
    return _bench_rings(cuda)


@pytest.mark.parametrize("res", RESOLUTIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_globe_uniform_cells_equal_plain(globe, dtype, res):
    _assert_same(globe.to(dtype), res)


@pytest.mark.parametrize("res", RESOLUTIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", INPUTS)
def test_cells_equal_plain(inputs, case, dtype, res):
    _assert_same(inputs[case].to(dtype), res)


@pytest.mark.parametrize("res", RESOLUTIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("traffic", ["stream_pickups", "stream_curbside"])
def test_benchmark_points_equal_plain(rings, traffic, dtype, res):
    _assert_same(rings[traffic].to(dtype), res)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_strided_inputs_read_in_place(cuda, dtype):
    """A ring slot, a row-strided view and a column-major array give the
    cells and margins of their contiguous copies, and of the plain
    version."""
    base = torch.as_tensor(P.nyc(300_000, 21), device=cuda).to(dtype)
    ring = base.reshape(3, 100_000, 2)
    col_major = torch.empty((2, base.shape[0]), dtype=dtype, device=cuda).T
    col_major.copy_(base)
    assert col_major.stride() == (1, base.shape[0])
    wide = torch.zeros((base.shape[0], 5), dtype=dtype, device=cuda)
    wide[:, 1], wide[:, 3] = base[:, 0], base[:, 1]
    views = [ring[1], base[::3], col_major, wide[:, 1::2], base.reshape(600, 500, 2)]
    for v in views:
        _assert_same(v, 9)
        c, m = K.geo_to_cell_kernel(v, 9, with_margin=True)
        c2, m2 = K.geo_to_cell_kernel(v.contiguous(), 9, with_margin=True)
        assert torch.equal(c, c2) and torch.equal(_bits(m), _bits(m2))
        assert c.shape == v.shape[:-1] and m.shape == v.shape


def test_graph_capture_and_replay(cuda):
    """Captured into a CUDA graph, the launch replays on new inputs and
    counts once a replay."""
    src = torch.as_tensor(P.nyc(200_000, 31), device=cuda, dtype=torch.float32)
    static = src.clone()
    K.geo_to_cell_kernel(static, 9, with_margin=True)  # warm: library and tables
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with _build.captured_launches() as record, torch.cuda.graph(g):
        cells, margin = K.geo_to_cell_kernel(static, 9, with_margin=True)
    assert record == {K.geo_to_cell_kernel: 1}
    before = K.geo_to_cell_kernel.launches
    for seed in (32, 33):
        static.copy_(torch.as_tensor(P.nyc(200_000, seed), device=cuda))
        g.replay()
        _build.count_replay(record)
        want_c, want_m = K.geo_to_cell_plain(static, 9, with_margin=True)
        torch.cuda.synchronize()
        assert torch.equal(cells, want_c) and torch.equal(_bits(margin), _bits(want_m))
    assert K.geo_to_cell_kernel.launches == before + 2


def test_warm_call_makes_no_host_sync_and_copies_no_table(cuda, monkeypatch):
    xy = torch.as_tensor(P.nyc(100_000, 41), device=cuda)
    for dtype in DTYPES:
        H3.point_to_cell_margin(xy.to(dtype), 9)
    torch.cuda.synchronize()

    def refuse(*a, **k):
        raise AssertionError("a constant table was copied to the device again")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for dtype in DTYPES:
            pts = xy.to(dtype)
            H3.point_to_cell(pts, 9)
            H3.point_to_cell_margin(pts, 9)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_index_system_routes_tensors_to_the_kernel(cuda):
    """point_to_cell and point_to_cell_margin on the card launch the
    kernel and count their points in ``h3.cells_points{lane="kernel"}``;
    the alt variant stays on the plain chain."""
    xy = torch.as_tensor(P.nyc(50_000, 51), device=cuda, dtype=torch.float32)
    c = metrics.counter("h3.cells_points")
    k0 = c.value(lane="kernel", variant="cells")
    m0 = c.value(lane="kernel", variant="margin")
    a0 = c.value(lane="plain", variant="alt")
    launches = K.geo_to_cell_kernel.launches
    cells = H3.point_to_cell(xy, 9)
    cm, mm = H3.point_to_cell_margin(xy, 9)
    alt = H3.point_to_cell_alt(xy, 9)
    assert K.geo_to_cell_kernel.launches == launches + 2
    assert c.value(lane="kernel", variant="cells") == k0 + 50_000
    assert c.value(lane="kernel", variant="margin") == m0 + 50_000
    assert c.value(lane="plain", variant="alt") == a0 + 50_000
    assert torch.equal(cells, K.geo_to_cell_plain(xy, 9))
    assert torch.equal(cm, cells)
    assert torch.equal(alt, K.geo_to_cell_plain(xy, 9, alt=True))
    assert mm.dtype == torch.float32 and mm.shape == (50_000, 2)


def test_points_count_once_a_replay_and_not_for_a_refused_call(cuda):
    """``h3.cells_points`` counts what the card assigned: a call captured
    into a CUDA graph adds its points at each replay and none at the
    capture, and a call the kernel refuses adds none."""
    c = metrics.counter("h3.cells_points")
    static = torch.as_tensor(P.nyc(20_000, 61), device=cuda, dtype=torch.float32)
    H3.point_to_cell(static, 9)  # warm: library and tables
    torch.cuda.synchronize()
    k0 = c.value(lane="kernel", variant="cells")
    g = torch.cuda.CUDAGraph()
    with _build.captured_launches() as record, torch.cuda.graph(g):
        cells = H3.point_to_cell(static, 9)
    assert record == {K.geo_to_cell_kernel: 1}
    assert c.value(lane="kernel", variant="cells") == k0
    for seed in (62, 63):
        static.copy_(torch.as_tensor(P.nyc(20_000, seed), device=cuda))
        g.replay()
        _build.count_replay(record)
        assert torch.equal(cells, K.geo_to_cell_plain(static, 9))
    assert c.value(lane="kernel", variant="cells") == k0 + 40_000
    with pytest.raises(ValueError, match="float32 or float64"):
        H3.point_to_cell(static.to(torch.float16), 9)
    assert c.value(lane="kernel", variant="cells") == k0 + 40_000


def test_refuses_what_the_kernel_does_not_take(cuda):
    xy = torch.zeros((4, 2), device=cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.geo_to_cell_kernel(xy.cpu(), 9)
    with pytest.raises(ValueError, match="float32 or float64"):
        K.geo_to_cell_kernel(xy.to(torch.float16), 9)
    with pytest.raises(ValueError, match="resolution"):
        K.geo_to_cell_kernel(xy, 16)
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        K.geo_to_cell_kernel(torch.zeros((4, 3), device=cuda), 9)
    empty = K.geo_to_cell_kernel(torch.zeros((0, 2), device=cuda), 9)
    assert empty.shape == (0,) and empty.dtype == torch.int64
