"""The CUDA kernels of `mosaic_tpu_torch/kernels/csrc/pip.cu` and
`csrc/zonal.cu` against their plain torch versions, on the card.

The kernels have no CPU mode, so every test here is marked ``gpu`` and
skips without CUDA. The file imports neither JAX nor the JAX package (the
CPU tests hold the plain versions to the reference), so it runs on a
machine that has PyTorch, the CUDA toolkit and one card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX.) The bar for the pip
kernels is bit equality with the plain version (tolerance 0): both
evaluate every f32 operation with round-to-nearest and no fused
multiply-add. `zonal_tiled` sums in another order than its plain version
(both in f64, rounded once to f32), so count, min and max must be equal,
and the sum too on integer-valued data; on float data the sum is held to
``rtol=1e-6`` of the segment's sum of |v|; two calls must give the same
bits. The fold lane (`zonal_seq_fold`, f64 and f32) must equal the CPU
lane's bit patterns — a sequential loop in pixel order, ties and NaN
payloads included — on integer, float, near-2**52 and special-valued
runs; bits are compared through an integer view, as ``torch.equal``
takes -0.0 for +0.0.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu_torch.core.geometry.device import pack_to_device
from mosaic_tpu_torch.datasets import synthetic_zones
from mosaic_tpu_torch.kernels import pip as TP
from mosaic_tpu_torch.kernels import zonal as TZ
from torch_heavy_layouts import LAYOUTS, heavy_layout

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
@pytest.mark.parametrize("case", [1, 129, 20_000] + sorted(LAYOUTS))
def test_pip_heavy_kernel_equals_plain(cuda, case, banded):
    """An int ``case`` is a batch of that many points on random rows with
    pad rows at the tail; a named one is a skewed-row layout of
    `torch_heavy_layouts` (one crowded row, interleaved pads, H >> K,
    reversed rows, degenerate edges, the band's clamp at 0 and 1), the
    same inputs the CPU tests hold against the Pallas kernel."""
    if isinstance(case, int):
        arrays, band = _heavy_inputs(case), 1e-3
    else:
        *arrays, band = heavy_layout(case)
        arrays[4] = arrays[4].view(np.int32)  # uint32 slot bits, int32 tensor
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    K = args[0].shape[0]
    eps2 = torch.tensor(band, dtype=torch.float32, device=cuda) if banded else None
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


# ------------------------------------------------------------------ zonal


ZONAL_SUM_RTOL = 1e-6


def _zonal_inputs(n, k, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:
        vals = rng.integers(0, 100, n).astype(np.float32)
    else:
        vals = rng.uniform(-100, 100, n).astype(np.float32)
    seg = rng.integers(-1, k, n).astype(np.int32)
    return vals, seg


def _bits(t):
    """The bit patterns of a float tensor, on the CPU (``torch.equal``
    takes -0.0 for +0.0)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g) if g.is_floating_point() else g.cpu(),
                           _bits(w) if w.is_floating_point() else w.cpu())


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "float"])
@pytest.mark.parametrize("k", [1, 127, 129, 256, 1000])
@pytest.mark.parametrize("n", [1, 2047, 2049, 20_001])
def test_zonal_tiled_kernel_equals_plain(cuda, n, k, integer):
    """Pixel counts off the chunk, segment counts off the 128-segment
    block (1000 spans eight); two calls give the same bits."""
    vals, seg = _zonal_inputs(n, k, integer, seed=n * 1000 + k)
    v, s = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    before = TZ.zonal_tiled.launches
    got = TZ.zonal_tiled(v, s, k)
    again = TZ.zonal_tiled(v, s, k)
    want = TZ.zonal_tiled_plain(v, s, k)
    torch.cuda.synchronize()
    assert TZ.zonal_tiled.launches == before + 2
    assert [g.dtype for g in got] == [torch.int32] + [torch.float32] * 3
    _same_bits(again, got)
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i])
    if integer:
        assert torch.equal(got[1], want[1])
    else:
        abs_sum = torch.zeros(k, dtype=torch.float64, device=cuda)
        live = s >= 0
        abs_sum.index_add_(0, s[live].long(), v[live].abs().double())
        err = (got[1].double() - want[1].double()).abs()
        assert bool((err <= ZONAL_SUM_RTOL * abs_sum).all())


@pytest.mark.parametrize("tiling", [dict(tile_n=8), dict(tile_n=4096, tile_s=384),
                                    dict(tile_s=1024)], ids=["tile_n8", "tile_s384", "tile_s1024"])
def test_zonal_tiled_kernel_explicit_tiling(cuda, tiling):
    """Explicit chunks and segment blocks wider than the kernel's
    256-segment pass give the plain version's count, min and max."""
    vals, seg = _zonal_inputs(30_000, 1000, True, seed=3)
    v, s = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    got = TZ.zonal_tiled(v, s, 1000, **tiling)
    want = TZ.zonal_tiled_plain(v, s, 1000)
    torch.cuda.synchronize()
    for i in range(4):
        assert torch.equal(got[i], want[i])


def test_zonal_tiled_kernel_long_runs(cuda):
    """Raster-like segments: four runs of 16,384 pixels each, float data.
    A sequential f32 sum over such a run drifts with the order by more
    than the tolerance; the f64 accumulation does not."""
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.uniform(0, 32000, 65_536).astype(np.float32)).to(cuda)
    s = (torch.arange(65_536, device=cuda) // 16_384).to(torch.int32)
    got = TZ.zonal_tiled(v, s, 4)
    want = TZ.zonal_tiled_plain(v, s, 4)
    torch.cuda.synchronize()
    _same_bits(TZ.zonal_tiled(v, s, 4), got)
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i])
    abs_sum = v.double().reshape(4, -1).sum(dim=1)
    err = (got[1].double() - want[1].double()).abs()
    assert bool((err <= ZONAL_SUM_RTOL * abs_sum).all())


def test_zonal_tiled_kernel_all_segments_dropped(cuda):
    v = torch.arange(5000, dtype=torch.float32, device=cuda)
    for fill in (-1, 300):  # -1, and ids past the last segment
        s = torch.full((5000,), fill, dtype=torch.int32, device=cuda)
        cnt, sm, mn, mx = TZ.zonal_tiled(v, s, 256)
        torch.cuda.synchronize()
        assert int(cnt.abs().sum()) == 0 and float(sm.abs().sum()) == 0.0
        assert bool((mn == 1e30).all()) and bool((mx == -1e30).all())


def test_zonal_tiled_kernel_empty_batch(cuda):
    """No pixels: no launch, the empty-segment sentinels."""
    before = TZ.zonal_tiled.launches
    cnt, sm, mn, mx = TZ.zonal_tiled(
        torch.zeros(0, device=cuda), torch.zeros(0, dtype=torch.int32, device=cuda), 5
    )
    assert TZ.zonal_tiled.launches == before
    assert cnt.shape == (5,) and cnt.dtype == torch.int32 and int(cnt.sum()) == 0
    assert bool((mn == 1e30).all()) and bool((mx == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, k", [(1, 1), (4096, 37), (200_000, 3), (65_536, 256)])
def test_zonal_fold_cuda_is_sequential(cuda, n, k, dtype):
    """The fold lane on the card: each segment summed in pixel order, so
    it equals the CPU lane (a sequential loop) bit for bit."""
    rng = np.random.default_rng(n + k)
    vals = rng.uniform(-50, 50, n)
    seg = rng.integers(-1, k, n).astype(np.int32)
    before = TZ.zonal_fold.launches
    got = TZ.zonal_fold(torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda),
                        k, acc_dtype=dtype)
    want = TZ.zonal_fold(torch.from_numpy(vals), torch.from_numpy(seg), k, acc_dtype=dtype)
    torch.cuda.synchronize()
    assert TZ.zonal_fold.launches == before + 1
    _same_bits(got, want)
    if dtype == torch.float64:
        s = np.zeros(k)
        for g_, v in zip(seg.tolist(), vals.tolist()):
            if g_ >= 0:
                s[g_] += v
        assert got[1].cpu().numpy().tobytes() == s.tobytes()


def _fold_case(case, rng):
    """(values f64, segment ids, S) of one zonal_fold case."""
    if case == "int_one_run_65536":  # one zone over a whole 256x256 tile
        return rng.integers(-32768, 32768, 65_536).astype(np.float64), np.zeros(65_536, np.int32), 1
    if case == "int16_S256":
        n = 65_536
        return (rng.integers(-32768, 32768, n).astype(np.float64),
                rng.integers(-1, 256, n).astype(np.int32), 256)
    if case == "uint16_S4096":
        n = 200_000
        return (rng.integers(0, 65536, n).astype(np.float64),
                rng.integers(-1, 4096, n).astype(np.int32), 4096)
    if case == "float_one_run_65536":
        return rng.uniform(0, 32000, 65_536), np.zeros(65_536, np.int32), 1
    if case == "float_S4096":
        n = 100_000
        return rng.normal(0, 1e3, n), rng.integers(-1, 4096, n).astype(np.int32), 4096
    if case == "near_2_52":  # integers whose sums round: the sequential branch
        n = 10_000
        v = float(2 ** 52) + rng.integers(-64, 64, n).astype(np.float64)
        v[::7] = rng.integers(-3, 4, v[::7].size)
        return v, rng.integers(0, 17, n).astype(np.int32), 17
    if case == "specials":
        n = 20_000
        pool = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.0, 3.0])
        v = rng.choice(pool, n, p=[0.3, 0.3, 0.02, 0.02, 0.02, 0.12, 0.12, 0.1])
        return v, rng.integers(-1, 256, n).astype(np.int32), 256
    if case == "zero_ties":  # the min and max of many runs are 0 of either sign
        n = 20_000
        v = rng.choice(np.array([0.0, -0.0, 1.0]), n)
        return v, rng.integers(0, 256, n).astype(np.int32), 256
    if case == "all_dropped":
        return rng.uniform(-1, 1, 5000), np.full(5000, -1, np.int32), 256
    raise ValueError(case)


FOLD_CASES = ["int_one_run_65536", "int16_S256", "uint16_S4096", "float_one_run_65536",
              "float_S4096", "near_2_52", "specials", "zero_ties", "all_dropped"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", FOLD_CASES)
def test_zonal_fold_cuda_equals_cpu_lane_bits(cuda, case, dtype):
    """Count, sum, min and max equal the CPU lane's bit patterns (-0.0,
    NaN payloads, infinities included), and two calls give the same bits.
    The cases take both of the kernel's branches: integer values are
    exact in any order, float values and integers near 2**52 are not."""
    vals, seg, k = _fold_case(case, np.random.default_rng(FOLD_CASES.index(case)))
    v_cpu = torch.from_numpy(vals).to(dtype)
    s_cpu = torch.from_numpy(seg)
    v, s = v_cpu.to(cuda), s_cpu.to(cuda)
    before = TZ.zonal_fold.launches
    got = TZ.zonal_fold(v, s, k)
    again = TZ.zonal_fold(v, s, k)
    want = TZ.zonal_fold(v_cpu, s_cpu, k)
    torch.cuda.synchronize()
    assert TZ.zonal_fold.launches == before + 2
    _same_bits(got, want)
    _same_bits(again, got)
    exact = TZ.exact_sum_ok(v_cpu, s_cpu, k)
    if case.startswith(("int", "uint")) and dtype == torch.float64:
        assert bool(exact.all())
    if case in ("float_one_run_65536", "near_2_52", "specials"):
        assert not bool(exact.all())


# ---- the exact join on the card


def test_recheck_join_on_card_equals_host_oracle(cuda):
    """`pip_join(probe="adaptive", recheck=True)` on the card launches the
    banded heavy kernel, is not degraded, and equals the recheck's f64
    oracle (`recheck_oracle`, `host_join` save at H3's cell-edge gap)
    exactly."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.runtime import telemetry
    from mosaic_tpu_torch.sql import join as TJ

    h3 = H3IndexSystem()
    zones = synthetic_zones(4, 4, bbox=BBOX, verts=256)
    ix = TJ.build_chip_index(tessellate(zones, h3, 9, keep_core_geoms=False), device=cuda)
    assert ix.num_heavy_cells > 0
    rng = np.random.default_rng(17)
    pts = rng.uniform(BBOX[:2], BBOX[2:], (50_000, 2))
    before = TP.pip_heavy_tiled.launches
    with telemetry.capture() as ev:
        got = TJ.pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive", recheck=True)
    assert TP.pip_heavy_tiled.launches > before
    assert not getattr(got, "degraded", False)
    kinds = {e["event"] for e in ev}
    assert "recheck_narrow" in kinds
    assert not kinds & {"transient_retry", "degraded", "retry_exhausted"}
    np.testing.assert_array_equal(got, TJ.recheck_oracle(pts, ix.host, h3, 9))


def test_recheck_oracle_on_card_equals_the_cpu(cuda):
    """The recheck's f64 oracle gives the CPU's bits on the card: one IEEE
    f64 operation a kernel, in the same order. Points on zone edges and a
    few 1e-10 degrees either side of cell ring edges included."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql import join as TJ

    h3 = H3IndexSystem()
    zones = synthetic_zones(4, 4, bbox=BBOX, verts=256)
    ix = TJ.build_chip_index(tessellate(zones, h3, 9, keep_core_geoms=False), device=cuda)
    rng = np.random.default_rng(19)
    flat = rng.uniform(BBOX[:2], BBOX[2:], (100_000, 2))
    xy = np.asarray(zones.xy)
    on_edges = xy[rng.integers(0, len(xy), 50_000)] + rng.normal(0, 1e-7, (50_000, 2))
    ring = np.asarray(h3.cell_boundary(ix.host.cells[:2000]))
    a, d = ring[:, :-1], np.diff(ring, axis=1)
    near_rings = np.concatenate([(a + 0.5 * d + t * d[..., ::-1] * [1, -1]).reshape(-1, 2)
                                 for t in (-1e-6, 1e-6)])
    pts = np.concatenate([flat, on_edges, near_rings])
    card = TJ.recheck_oracle(pts, ix.host, h3, 9, device=cuda)
    np.testing.assert_array_equal(card, TJ.recheck_oracle(pts, ix.host, h3, 9))
    assert (card >= 0).any()


@pytest.mark.parametrize("recheck", [False, True])
def test_join_on_card_raises_when_retries_exhausted(cuda, recheck):
    """Past the retry budget a join on the card raises `RetryExhausted`
    and records no degradation: its work never moves to the CPU."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.runtime import RetryExhausted, faults, telemetry
    from mosaic_tpu_torch.sql import join as TJ

    h3 = H3IndexSystem()
    zones = synthetic_zones(3, 3, bbox=BBOX)
    ix = TJ.build_chip_index(tessellate(zones, h3, 7, keep_core_geoms=False), device=cuda)
    pts = np.random.default_rng(5).uniform(BBOX[:2], BBOX[2:], (2_000, 2))
    with telemetry.capture() as ev:
        with faults.transient_errors(50, sites=("pip_join.device",)):
            with pytest.raises(RetryExhausted) as ei:
                TJ.pip_join(pts, None, h3, 7, chip_index=ix, recheck=recheck)
    assert ei.value.attempts >= 3
    kinds = [e["event"] for e in ev]
    assert "retry_exhausted" in kinds and "degraded" not in kinds


@pytest.mark.parametrize("res", [5, 9, 11])
def test_cuda_margins_cover_the_cards_disagreements(cuda, res):
    """The card's f32 cells (CUDA's trigonometry) differ from the f64 host
    cells only inside the cell band, with 2x headroom under
    CELL_MARGIN_K, and the runner-up cell covers every flagged one."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.sql.join import CELL_MARGIN_K
    from mosaic_tpu_torch.tools.calibrate_margins import global_points

    h3 = H3IndexSystem()
    pts = global_points(400_000, 3)
    eps = float(np.finfo(np.float32).eps)
    c64 = h3.point_to_cell(pts, res)
    f32 = torch.from_numpy(pts).to(cuda).float()
    c32, m = h3.point_to_cell_margin(f32, res)
    alt = h3.point_to_cell_alt(f32, res).cpu().numpy()
    c32, m = c32.cpu().numpy(), m.cpu().numpy()
    dis = c32 != c64
    if res >= 9:
        assert dis.any(), "no f32 disagreement on the card: no signal"
    if dis.any():
        assert m[dis, 0].max() / eps <= CELL_MARGIN_K / 2
    km = CELL_MARGIN_K * eps
    covered = ~dis | ((m[:, 0] < km) & ((alt == c64) | (m[:, 1] < km) | (alt == -1)))
    assert covered.all()


# ---- the custom grid's exact join, the stream and the durable raster scan


CUSTOM_CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
CUSTOM_BBOX = (-20.0, -20.0, 20.0, 20.0)


def _custom_indexes(cuda):
    """(custom grid, {"cpu": index, "cuda": index}) over 3x3 star zones of
    128 vertices at resolution 3, ``edge_cap=8``: heavy and convex cells,
    so the adaptive probe launches `pip_heavy_tiled`."""
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql import join as TJ

    grid = CustomIndexSystem(GridConf(*CUSTOM_CONF))
    table = tessellate(synthetic_zones(3, 3, bbox=CUSTOM_BBOX, verts=128), grid, 3,
                       keep_core_geoms=False)
    ixs = {d: TJ.build_chip_index(table, edge_cap=8, device=d) for d in ("cpu", cuda)}
    assert ixs[cuda].num_heavy_cells > 0
    return grid, {"cpu": ixs["cpu"], "cuda": ixs[cuda]}


def _stream_batches(n=3, size=20_000, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.uniform(CUSTOM_BBOX[:2], CUSTOM_BBOX[2:], (size, 2)) for _ in range(n)]


def test_custom_grid_recheck_default_cells_on_card_equals_host(cuda):
    """The custom grid has no cell margins: with default arguments the
    exact join computes its cells in f64 on the card too, and equals the
    f64 host oracle on near-edge points."""
    from mosaic_tpu_torch.sql import join as TJ

    grid, ixs = _custom_indexes(cuda)
    host = ixs["cuda"].host
    rng = np.random.default_rng(3)
    edges = host.cell_edges[host.cell_ebits != 0][:4_000]
    t = rng.uniform(0, 1, (len(edges), 1))
    near = edges[:, :2] + t * (edges[:, 2:] - edges[:, :2]) + host.shift
    near = near + rng.normal(0, 1e-6, near.shape)
    want = TJ.host_join(near, host, grid, 3)
    got = TJ.pip_join(near, None, grid, 3, chip_index=ixs["cuda"], recheck=True,
                      probe="adaptive")
    np.testing.assert_array_equal(got, want)


def test_stream_on_card_equals_cpu(cuda):
    """A small adaptive `StreamJoin` on the card launches `pip_heavy_tiled`
    every batch and equals the same stream on the CPU, rows and stats."""
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

    grid, ixs = _custom_indexes(cuda)
    b = _stream_batches()
    res = {}
    for d in ("cpu", "cuda"):
        sj = StreamJoin(ixs[d], grid, 3, probe="adaptive")
        ring = ring_from_host(b, device=d)
        before = TP.pip_heavy_tiled.launches
        res[d] = (sj.run(ring, 5, collect=True), sj.run_batched(ring, 5))
        launched = TP.pip_heavy_tiled.launches - before
        assert launched == (10 if d == "cuda" else 0)
    (gr, gb), (cr, cb) = res["cuda"], res["cpu"]
    np.testing.assert_array_equal(gr.outs, cr.outs)
    np.testing.assert_array_equal(gb.outs, gr.outs)
    stats = [(r.checksum, r.matches, r.overflow) for r in (gr, gb, cr, cb)]
    assert len(set(stats)) == 1 and gr.matches > 0 and gr.overflow == 0


def test_h3_stream_loop_on_card_makes_no_host_sync(cuda):
    """Warm, the H3 stream loop queues its batches without a host sync,
    pentagon rows included (torch's sync debug mode raises on any it
    sees), and its stats equal the per-batch path's."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql import join as TJ
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host
    from mosaic_tpu_torch.tools.calibrate_margins import global_points

    h3 = H3IndexSystem()
    zones = synthetic_zones(3, 3, bbox=BBOX, verts=128)
    ix = TJ.build_chip_index(tessellate(zones, h3, 9, keep_core_geoms=False),
                             edge_cap=8, device=cuda)
    rng = np.random.default_rng(23)
    batches = [rng.uniform(BBOX[:2], BBOX[2:], (20_000, 2)) for _ in range(2)]
    batches.append(global_points(20_000, 5))
    ring = ring_from_host(batches, device=cuda)
    sj = StreamJoin(ix, h3, 9, probe="adaptive")
    want = sj.run_batched(ring, 5)
    sj.run(ring, 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acc, _ = sj._loop(ring, ix, 5, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = sj.run(ring, 5)
    assert (got.checksum, got.matches, got.overflow) == (
        want.checksum, want.matches, want.overflow)
    assert got.matches > 0 and got.overflow == 0


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_durable_stream_killed_and_resumed_on_card_equals_run(cuda, tmp_path, pipeline):
    from mosaic_tpu_torch.runtime import RetryPolicy, checkpoint, faults
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

    grid, ixs = _custom_indexes(cuda)
    sj = StreamJoin(ixs["cuda"], grid, 3, probe="adaptive")
    ring = ring_from_host(_stream_batches(), device=cuda)
    clean = sj.run(ring, 7)
    fast = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)
    d = str(tmp_path)
    with faults.inject(fail_first=99, skip_first=2, sites=("stream.scan_step",),
                       exc_factory=lambda s: RuntimeError("simulated device loss")):
        with pytest.raises(RuntimeError, match="simulated device loss"):
            sj.run_durable(ring, 7, run_dir=d, snapshot_every=2, retry_policy=fast,
                           pipeline=pipeline)
    assert checkpoint.list_snapshots(d) == [2, 4]
    r = sj.resume(d, ring, retry_policy=fast, pipeline=pipeline)
    assert r.metrics["resumed_from"] == 4 and not r.metrics["degraded"]
    assert (r.checksum, r.matches, r.overflow) == (clean.checksum, clean.matches,
                                                   clean.overflow)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_stream_on_card_raises_when_retries_exhausted(cuda, tmp_path, pipeline):
    """Past the retry budget a stream segment on the card raises
    `RetryExhausted` and records no degradation: no work moves to the
    CPU."""
    from mosaic_tpu_torch.runtime import RetryExhausted, RetryPolicy, faults, telemetry
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

    grid, ixs = _custom_indexes(cuda)
    sj = StreamJoin(ixs["cuda"], grid, 3, probe="adaptive")
    ring = ring_from_host(_stream_batches(n=2, size=2_000), device=cuda)
    fast = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)
    with telemetry.capture() as ev:
        with faults.transient_errors(50, sites=("stream.scan_step",)):
            with pytest.raises(RetryExhausted):
                sj.run_durable(ring, 4, run_dir=str(tmp_path), snapshot_every=2,
                               retry_policy=fast, pipeline=pipeline)
    kinds = [e["event"] for e in ev]
    assert "retry_exhausted" in kinds and "degraded" not in kinds


def _custom_raster(integer: bool):
    from mosaic_tpu_torch.raster import Raster

    rng = np.random.default_rng(41)
    h, w = 300, 330
    data = (rng.integers(0, 100, (1, h, w)).astype(np.float64) if integer
            else rng.uniform(0, 100, (1, h, w)))
    data[0][rng.random((h, w)) < 0.1] = -9.0
    # 0.125-degree pixels over the zones' box, centers off the cell edges
    return Raster(data=data, gt=(-20.3, 0.125, 0.0, 19.7, 0.0, -0.125), srid=0, nodata=-9.0)


@pytest.mark.parametrize("lane", ["fold", "tiled"])
def test_raster_scan_on_card_equals_cpu(cuda, tmp_path, lane):
    """`RasterStream.scan` on the card equals the CPU's bit for bit (the
    tiled lane on integer-valued data, where its f32 sums are exact), and
    a scan killed after 3 tiles and resumed on the card equals it too."""
    from mosaic_tpu_torch.runtime import faults
    from mosaic_tpu_torch.sql import RasterStream

    grid, ixs = _custom_indexes(cuda)
    r = _custom_raster(integer=lane == "tiled")
    out = {d: RasterStream(ixs[d], grid, 3, lane=lane).scan(r, tile=(64, 64))
           for d in ("cpu", "cuda")}
    g, c = out["cuda"].stats, out["cpu"].stats
    assert g.keys.size > 0
    for a, b in ((g.keys, c.keys), (g.count, c.count)):
        np.testing.assert_array_equal(a, b)
    for a, b in ((g.sum, c.sum), (g.min, c.min), (g.max, c.max)):
        np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))
    st = RasterStream(ixs["cuda"], grid, 3, lane=lane)
    d = str(tmp_path)
    with faults.inject(fail_first=99, skip_first=3, sites=("raster.zonal",),
                       exc_factory=lambda s: RuntimeError("kill")):
        with pytest.raises(RuntimeError):
            st.scan(r, tile=(64, 64), run_dir=d, snapshot_every=1)
    res = st.resume(d, r).stats
    assert res.keys.tolist() == g.keys.tolist()
    np.testing.assert_array_equal(res.sum.view(np.int64), g.sum.view(np.int64))


def test_raster_scan_on_card_raises_when_retries_exhausted(cuda):
    from mosaic_tpu_torch.runtime import RetryExhausted, RetryPolicy, faults, telemetry
    from mosaic_tpu_torch.sql import RasterStream

    grid, ixs = _custom_indexes(cuda)
    st = RasterStream(ixs["cuda"], grid, 3)
    with telemetry.capture() as ev:
        with faults.transient_errors(50, sites=("raster.zonal",)):
            with pytest.raises(RetryExhausted):
                st.scan(_custom_raster(True), tile=(64, 64),
                        retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                                 jitter=0.0))
    assert "degraded" not in [e["event"] for e in ev]


# ---- serving on the card


def _serve_index(cuda):
    """(H3, index) of 4x4 star zones of 256 vertices at resolution 9 on
    the card: heavy cells, so the adaptive probe launches
    `pip_heavy_tiled`."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql import join as TJ

    h3 = H3IndexSystem()
    zones = synthetic_zones(4, 4, bbox=BBOX, verts=256)
    ix = TJ.build_chip_index(tessellate(zones, h3, 9, keep_core_geoms=False), device=cuda)
    assert ix.num_heavy_cells > 0
    return h3, ix


def _requests(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(BBOX[:2], BBOX[2:], (int(n), 2)) for n in sizes]


def _pip_join_split(reqs, h3, ix):
    """The port's `pip_join(probe="scatter", recheck=False)` of the
    concatenated requests, split per request (the join is pointwise)."""
    from mosaic_tpu_torch.sql import join as TJ

    cat = np.concatenate(reqs)
    want = TJ.pip_join(cat, None, h3, 9, chip_index=ix, probe="scatter", recheck=False)
    return np.split(want, np.cumsum([len(r) for r in reqs])[:-1])


@pytest.mark.parametrize("probe", ["adaptive", "scatter"])
def test_served_batches_on_card_equal_pip_join(cuda, probe):
    """Co-batched requests on the card equal `pip_join` bit for bit under
    both probes; the adaptive engine launches `pip_heavy_tiled`; a warm
    engine makes no nvcc build and no cold compile over its lifetime."""
    from mosaic_tpu_torch.dispatch import backend_compiles
    from mosaic_tpu_torch.serve import BucketLadder, ServeEngine

    h3, ix = _serve_index(cuda)
    reqs = _requests(31, np.random.default_rng(30).integers(1, 1024, 60))
    want = _pip_join_split(reqs, h3, ix)
    with ServeEngine(ix, h3, 9, probe=probe, ladder=BucketLadder(64, 4096),
                     bounds=BBOX, max_wait_s=0.02) as eng:
        info = eng.warmup()
        assert info["signatures"] == len(eng.ladder.buckets)
        c0, l0 = backend_compiles(), TP.pip_heavy_tiled.launches
        futs = [eng.submit(r, deadline_s=30.0) for r in reqs]
        got = [f.result(timeout=60) for f in futs]
        m = eng.metrics()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert m["cold_compiles"] == 0 and m["batches"] < len(reqs)
    assert m["degraded"] == 0 and m["shed"] == 0
    assert backend_compiles() == c0
    launched = TP.pip_heavy_tiled.launches - l0
    assert launched > 0 if probe == "adaptive" else launched == 0


def test_serve_dispatch_on_card_is_free_of_host_syncs(cuda):
    """At full-bucket caps, a warm dispatch's cells and probe (the staged
    points already on the card) make no host sync on any rung."""
    from mosaic_tpu_torch.dispatch import BucketLadder, DispatchCore

    h3, ix = _serve_index(cuda)
    core = DispatchCore(ix, h3, 9, probe="adaptive", ladder=BucketLadder(64, 1024))
    core.warmup()
    for b in core.ladder.buckets:
        (pts,) = _requests(b, [b])
        staged = core.stage(pts)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = core.probe_staged(*staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        np.testing.assert_array_equal(out.cpu().numpy(), core.execute_padded(pts))


def test_serve_dispatch_on_card_replays_its_rungs_graph(cuda):
    """Every warmed rung holds a captured graph; a replay equals the eager
    probe bit for bit and counts the heavy kernel's launches as the eager
    probe does; the rung's graph holds the cell kernel's launch too."""
    from mosaic_tpu_torch.dispatch import BucketLadder, DispatchCore
    from mosaic_tpu_torch.kernels import h3 as KH

    h3, ix = _serve_index(cuda)
    core = DispatchCore(ix, h3, 9, probe="adaptive", ladder=BucketLadder(64, 1024))
    core.warmup()
    assert sorted(core._graphs) == list(core.ladder.buckets)
    for b in core.ladder.buckets:
        (pts,) = _requests(b + 1, [b])
        l0 = TP.pip_heavy_tiled.launches
        eager = core.probe_staged(*core.stage(pts)).cpu().numpy()
        l1 = TP.pip_heavy_tiled.launches
        np.testing.assert_array_equal(core.execute_padded(pts), eager)
        assert TP.pip_heavy_tiled.launches - l1 == l1 - l0 == 1
        assert core._graphs[b]["launches"] == {TP.pip_heavy_tiled: 1, KH.geo_to_cell_kernel: 1}


def test_graph_capture_counts_launches_at_each_replay(cuda):
    """A wrapper captured into a CUDA graph counts nothing while it is
    captured and, at each replay, what its eager call counts; the replay
    gives the eager call's bits."""
    from mosaic_tpu_torch.kernels import _build

    heavy = [torch.as_tensor(a, device=cuda) for a in _heavy_inputs(4_000)]
    zones = synthetic_zones(4, 4, bbox=BBOX, verts=40)
    planes, n_real = TP.edge_planes(
        pack_to_device(zones, dtype=torch.float32, recenter=True, device=cuda))
    pts = torch.as_tensor(np.random.default_rng(5).uniform(-0.05, 0.05, (3_000, 2))
                          .astype(np.float32), device=cuda)
    wrappers = (TP.pip_heavy_tiled, TP.pip_zone)

    def calls():
        best, _ = TP.pip_heavy_tiled(*heavy, eps2=None)
        return best, TP.pip_zone(pts, planes, n_real)

    def counts():
        return [w.launches for w in wrappers]

    c0 = counts()
    eager = calls()
    c1 = counts()
    assert [b - a for a, b in zip(c0, c1)] == [1, 1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    c2 = counts()
    graph = torch.cuda.CUDAGraph()
    with _build.captured_launches() as record, torch.cuda.graph(graph):
        out = calls()
    assert counts() == c2
    assert record == {TP.pip_heavy_tiled: 1, TP.pip_zone: 1}
    for rep in (1, 2):
        graph.replay()
        _build.count_replay(record)
        assert [b - a for a, b in zip(c2, counts())] == [rep, rep]
    torch.cuda.synchronize()
    assert all(torch.equal(g, e) for g, e in zip(out, eager))


def test_serve_on_card_raises_when_retries_exhausted(cuda):
    """Past the retry budget a dispatch on the card fails its requests
    with `RetryExhausted`; nothing degrades to the CPU."""
    from mosaic_tpu_torch.runtime import RetryExhausted, faults, telemetry
    from mosaic_tpu_torch.serve import BucketLadder, ServeEngine

    h3, ix = _serve_index(cuda)
    with ServeEngine(ix, h3, 9, probe="adaptive", ladder=BucketLadder(64, 256),
                     bounds=BBOX) as eng:
        eng.warmup()
        with telemetry.capture() as ev:
            with faults.transient_errors(50, sites=("serve.dispatch",)):
                fut = eng.submit(_requests(5, [100])[0], deadline_s=30.0)
                with pytest.raises(RetryExhausted):
                    fut.result(timeout=60)
        m = eng.metrics()
    kinds = [e["event"] for e in ev]
    assert "retry_exhausted" in kinds and "degraded" not in kinds
    assert m["failed"] == 1 and m["degraded"] == 0


def test_hot_swap_frees_the_replaced_cores_graphs_on_card(cuda):
    """A hot_swap frees the replaced core's rung graphs at once (no batch
    is in flight), not at a later garbage collection: the old core holds
    no graph, and `memory_allocated` is back within one rung's pool of its
    level before the swap (the new core's graphs replace the old ones
    instead of adding to them). Served answers still equal `pip_join`."""
    import gc

    from mosaic_tpu_torch.dispatch import DispatchCore
    from mosaic_tpu_torch.serve import BucketLadder, ServeEngine

    h3, ix = _serve_index(cuda)
    # one rung's pool: what a core's top rung holds once captured
    top = DispatchCore(ix, h3, 9, probe="adaptive", ladder=BucketLadder(1024, 1024))
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    top.warmup()
    torch.cuda.synchronize()
    rung = torch.cuda.memory_allocated() - m0
    top.release_graphs()
    del top
    assert rung > 0
    reqs = _requests(43, [700, 33, 1000])
    want = _pip_join_split(reqs, h3, ix)
    with ServeEngine(ix, h3, 9, probe="adaptive", ladder=BucketLadder(64, 1024),
                     bounds=BBOX) as eng:
        eng.warmup()
        gc_was_enabled = gc.isenabled()
        gc.disable()  # nothing but the swap may free the old graphs
        try:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            old = eng.core
            assert sorted(old._graphs) == list(eng.ladder.buckets)
            eng.hot_swap()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
        finally:
            if gc_was_enabled:
                gc.enable()
        assert old._graphs == {} and eng.core is not old
        assert sorted(eng.core._graphs) == list(eng.ladder.buckets)
        assert after - before <= rung, (before, after, rung)
        for r, w in zip(reqs, want):
            np.testing.assert_array_equal(eng.join(r, deadline_s=30.0), w)
        assert eng.metrics()["cold_compiles"] == 0

def test_two_tenant_engines_warming_at_once_agree_with_pip_join(cuda):
    """Two engines warm on two threads at once with H3's device constant
    tables emptied first, so both fill them concurrently; both then equal
    `pip_join` bit for bit."""
    import threading

    from mosaic_tpu_torch.core.index.h3 import hexmath
    from mosaic_tpu_torch.serve import BucketLadder, ServeEngine

    h3, ix = _serve_index(cuda)
    reqs = _requests(41, [700, 33, 1000])
    want = _pip_join_split(reqs, h3, ix)
    hexmath._DEVICE_CONSTS.clear()
    engines = [ServeEngine(ix, h3, 9, probe="adaptive", ladder=BucketLadder(64, 1024),
                           bounds=BBOX) for _ in range(2)]
    barrier, errors = threading.Barrier(2), []

    def warm(eng):
        try:
            barrier.wait()
            eng.warmup()
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=warm, args=(e,)) for e in engines]  # lint: thread-context-adoption-ok (concurrent warmups; errors re-checked on the caller thread)
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert not errors, errors
        for eng in engines:
            for r, w in zip(reqs, want):
                np.testing.assert_array_equal(eng.join(r, deadline_s=30.0), w)
    finally:
        for eng in engines:
            eng.close()


# ---- expressions and the overlay join on the card


def _expr_raster():
    """Three NaN-speckled bands over the custom indexes' zones (the
    `_custom_raster` box and pixels)."""
    from mosaic_tpu_torch.raster import Raster

    rng = np.random.default_rng(43)
    data = rng.uniform(1.0, 100.0, (3, 300, 330))
    for b in range(3):
        data[b][rng.random((300, 330)) < 0.08] = np.nan
    return Raster(data=data, gt=(-20.3, 0.125, 0.0, 19.7, 0.0, -0.125), srid=0,
                  nodata=float("nan"))


def _same_result(a, b):
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.count, b.count)
    for x, y in ((a.sum, b.sum), (a.min, b.min), (a.max, b.max)):
        np.testing.assert_array_equal(x.view(np.int64), y.view(np.int64))


@pytest.mark.parametrize("by", ["zones", "grid"])
def test_fused_map_on_card_equals_cpu_and_oracle(cuda, by):
    """A fused expression fold on the card (probe through
    `pip_heavy_tiled`, the f64 fold through `zonal_seq_fold`) equals the
    CPU's plain path and the f64 host oracle bit for bit."""
    from mosaic_tpu_torch import expr as E
    from mosaic_tpu_torch.raster import ZonalEngine

    grid, ixs = _custom_indexes(cuda)
    r = _expr_raster()
    tree = E.ndvi(nir=2, red=1).mask_where(E.band(3) < 80.0).zonal(by=by)
    TP.pip_heavy_tiled.launches = TZ.zonal_fold.launches = 0
    got = ZonalEngine(grid, 3, chip_index=ixs["cuda"], device=cuda).map(tree, r, tile=(64, 64))
    assert TZ.zonal_fold.launches > 0
    assert by == "grid" or TP.pip_heavy_tiled.launches > 0
    cpu = ZonalEngine(grid, 3, chip_index=ixs["cpu"], device="cpu").map(tree, r, tile=(64, 64))
    oracle = E.host_expr_zonal_oracle(
        r, tree, index_system=grid, resolution=3,
        chip_index=ixs["cpu"] if by == "zones" else None, tile=(64, 64),
    )
    assert got.keys.size > 0
    _same_result(got, cpu)
    _same_result(got, oracle)


def test_expr_scan_and_join_on_card_equal_cpu(cuda, tmp_path):
    from mosaic_tpu_torch import expr as E
    from mosaic_tpu_torch.raster import ZonalEngine
    from mosaic_tpu_torch.runtime import faults
    from mosaic_tpu_torch.sql import RasterStream

    grid, ixs = _custom_indexes(cuda)
    r = _expr_raster()
    tree = E.norm_diff(E.band(2), E.band(1)).zonal(by="zones")
    st = RasterStream(ixs["cuda"], grid, 3)
    scan = st.scan(r, expr=tree, tile=(64, 64)).stats
    _same_result(scan, ZonalEngine(grid, 3, chip_index=ixs["cpu"], device="cpu").map(
        tree, r, tile=(64, 64)))
    d = str(tmp_path)
    with faults.inject(fail_first=99, skip_first=3, sites=("raster.zonal",),
                       exc_factory=lambda s: RuntimeError("kill")):
        with pytest.raises(RuntimeError):
            st.scan(r, expr=tree, tile=(64, 64), run_dir=d, snapshot_every=1)
    _same_result(st.resume(d, r, expr=tree).stats, scan)
    j = E.ndvi().join()
    got = ZonalEngine(grid, 3, chip_index=ixs["cuda"], device=cuda).map(j, r, tile=(64, 64))
    want = ZonalEngine(grid, 3, chip_index=ixs["cpu"], device="cpu").map(j, r, tile=(64, 64))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].tobytes() == want[1].tobytes()


def test_expr_on_card_raises_when_retries_exhausted(cuda):
    """Past the retry budget a fused tile on the card raises
    `RetryExhausted`; no tile is answered by the host oracle."""
    from mosaic_tpu_torch import expr as E
    from mosaic_tpu_torch.raster import ZonalEngine
    from mosaic_tpu_torch.runtime import RetryExhausted, RetryPolicy, faults, telemetry

    grid, ixs = _custom_indexes(cuda)
    eng = ZonalEngine(grid, 3, chip_index=ixs["cuda"], device=cuda)
    with telemetry.capture() as ev:
        with faults.transient_errors(50, sites=("expr.map",)):
            with pytest.raises(RetryExhausted):
                eng.map(E.ndvi().zonal(by="zones"), _expr_raster(), tile=(64, 64),
                        retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                                 jitter=0.0))
    assert "degraded" not in [e["event"] for e in ev]


def _square_cols(n, offset):
    from mosaic_tpu_torch.core.types import GeometryType, PackedGeometry

    j, i = np.divmod(np.arange(n * n), n)
    x, y = offset[0] + i * 2.9, offset[1] + j * 2.9
    s = 2.4 if offset[0] else 2.7
    xy = np.stack([np.stack([x, y], -1), np.stack([x + s, y], -1),
                   np.stack([x + s, y + s], -1), np.stack([x, y + s], -1)],
                  axis=1).reshape(-1, 2)
    k = np.arange(n * n + 1)
    return PackedGeometry(xy=xy, ring_offsets=4 * k, part_offsets=k, geom_offsets=k,
                          geom_type=np.full(n * n, int(GeometryType.POLYGON)),
                          srid=np.zeros(n * n, np.int32))


@pytest.mark.parametrize("pair_cap", [None, 5])
def test_overlay_measures_on_card_equals_host_lane(cuda, pair_cap):
    """The overlay device lane on the card (clip, fold through
    `zonal_seq_fold`, pair tree) equals the f64 host lane bit for bit,
    the OVERFLOW row included, and degrades nowhere."""
    from mosaic_tpu_torch import expr as E
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.sql import overlay as OV

    grid = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
    left, right = _square_cols(5, (0.0, 0.0)), _square_cols(5, (0.9, 0.6))
    TZ.zonal_fold.launches = 0
    dev = OV.overlay_measures(left, right, grid, 3, E.overlap_fraction(),
                              pair_cap=pair_cap, device=cuda)
    assert dev.lane == "device" and not dev.degraded
    assert TZ.zonal_fold.launches == 1
    host = OV.overlay_measures(left, right, grid, 3, E.overlap_fraction(),
                               pair_cap=pair_cap, device=cuda, lane="host")
    for f in ("pairs", "value", "valid", "area", "sure"):
        a, b = np.asarray(getattr(dev, f)), np.asarray(getattr(host, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert dev.overflow == host.overflow and (pair_cap is None) == (dev.overflow == 0)


def test_intersects_join_device_predicate_on_card_equals_oracle(cuda):
    """By default `intersects_join` refines the border pairs on the card,
    in f64, and returns the CPU path's pairs; the batched predicate on
    the card answers as the host oracle, row for row."""
    from mosaic_tpu_torch.core.geometry.oracle import pair_intersects
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.sql import overlay as OV

    grid = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
    left, right = _square_cols(5, (0.0, 0.0)), _square_cols(5, (0.9, 0.6))
    got = OV.intersects_join(left, right, grid, 3)
    np.testing.assert_array_equal(got, OV.intersects_join(left, right, grid, 3,
                                                          device="cpu"))
    assert got.shape[0] > 0
    np.testing.assert_array_equal(OV._device_pair_intersects(left, right, cuda),
                                  pair_intersects(left, right))


# ------------------------------------------------------------------- KNN


def _knn_problem(device, n=600, seed=19):
    """``n`` squares over ``BBOX`` (sides 0.5-1.5 H3 res-9 cell widths),
    the KNN index on ``device`` and on the CPU, and H3."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.types import GeometryType, PackedGeometry
    from mosaic_tpu_torch.knn import build_knn_index

    h3 = H3IndexSystem()
    rng = np.random.default_rng(seed)
    w = float(np.sqrt(h3.cell_area_approx(9)))
    cx, cy = rng.uniform(BBOX[0], BBOX[2], n), rng.uniform(BBOX[1], BBOX[3], n)
    s = rng.uniform(0.5, 1.5, n) * w
    xy = np.stack([np.stack([cx, cy], -1), np.stack([cx + s, cy], -1),
                   np.stack([cx + s, cy + s], -1), np.stack([cx, cy + s], -1)],
                  axis=1).reshape(-1, 2)
    k = np.arange(n + 1, dtype=np.int64)
    cand = PackedGeometry(xy=xy, ring_offsets=4 * k, part_offsets=k, geom_offsets=k,
                          geom_type=np.full(n, int(GeometryType.POLYGON), np.uint8),
                          srid=np.full(n, 4326, np.int32))
    kx = build_knn_index(cand, h3, 9, device=device)
    return h3, cand, kx, kx.to("cpu")


def _f64_bits(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64)).view(np.int64)


@pytest.mark.parametrize("lane", ["ring", "voronoi"])
def test_knn_lanes_on_card_equal_cpu_and_oracle(cuda, lane):
    """Both lanes on the card answer the CPU frontend's bits and the f64
    brute-force oracle's: ids and distance bits (the pair program is f64
    on the card, where IEEE sqrt and divide are exact)."""
    from mosaic_tpu_torch.knn import KNNFrontend, brute_force_knn

    _, _, kx, kx_cpu = _knn_problem(cuda)
    q = np.random.default_rng(3).uniform(BBOX[:2], BBOX[2:], (40, 2))
    fe = KNNFrontend(kx, lane=lane)
    assert fe.warmup()["backend_compiles"] == 0
    out, _ = fe.dispatch(q, 4)
    cpu, _ = KNNFrontend(kx_cpu, lane=lane).dispatch(q, 4)
    np.testing.assert_array_equal(_f64_bits(out), _f64_bits(cpu))
    ids, dist = brute_force_knn(q, kx, 4)
    np.testing.assert_array_equal(out[:, 4:].astype(np.int64), ids)
    np.testing.assert_array_equal(_f64_bits(out[:, :4]), _f64_bits(dist))
    assert fe.cold_compiles == 0


def test_knn_pair_program_on_card_equals_cpu(cuda):
    """The shared pair program on the card, point x polygon and polygon x
    polygon, equals the CPU's bits."""
    from mosaic_tpu_torch.functions import geometry as G
    from mosaic_tpu_torch.knn.frontend import _point_pair_prog

    _, cand, kx, kx_cpu = _knn_problem(cuda, n=200)
    rng = np.random.default_rng(5)
    qxy = torch.from_numpy(rng.uniform(-0.05, 0.05, (3000, 2)))
    rows = torch.from_numpy(rng.integers(0, 200, 3000))
    prog = _point_pair_prog()
    got = prog(kx.dc, qxy.to(cuda), rows.to(cuda)).cpu().numpy()
    want = prog(kx_cpu.dc, qxy, rows).numpy()
    np.testing.assert_array_equal(_f64_bits(got), _f64_bits(want))
    a, b = cand.take(np.arange(100)), cand.take(np.arange(100, 200))
    da, db = G._pair_pack(a, b, device=cuda)
    ca, cb = G._pair_pack(a, b, device="cpu")
    np.testing.assert_array_equal(
        _f64_bits(G._vmap_pair(G._distance_dense, da, db).cpu()),
        _f64_bits(G._vmap_pair(G._distance_dense, ca, cb)))


def test_knn_on_card_raises_when_retries_exhausted(cuda):
    """Past the retry budget a KNN batch on the card raises
    `RetryExhausted`, served or direct; nothing degrades to the CPU."""
    from mosaic_tpu_torch.knn import KNNFrontend
    from mosaic_tpu_torch.runtime import RetryExhausted, faults, telemetry
    from mosaic_tpu_torch.serve import BucketLadder, ServeEngine

    h3, ix = _serve_index(cuda)
    _, _, kx, _ = _knn_problem(cuda)
    q = np.random.default_rng(4).uniform(BBOX[:2], BBOX[2:], (5, 2))
    fe = KNNFrontend(kx)
    with telemetry.capture() as ev, faults.transient_errors(50, sites=("knn.distance",)):
        with pytest.raises(RetryExhausted):
            fe.dispatch(q, 3)
        with ServeEngine(ix, h3, 9, ladder=BucketLadder(64, 256), bounds=BBOX,
                         knn=fe) as eng:
            with pytest.raises(RetryExhausted):
                eng.submit_knn(q, 3, deadline_s=30.0).result(timeout=60)
            assert eng.metrics()["degraded"] == 0
    assert "degraded" not in [e["event"] for e in ev]


def test_spatial_knn_on_card_equals_cpu(cuda):
    from mosaic_tpu_torch.models import SpatialKNN
    from mosaic_tpu_torch.core.types import GeometryType, PackedGeometry

    h3, cand, _, _ = _knn_problem(cuda, n=300)
    pts = np.random.default_rng(6).uniform(BBOX[:2], BBOX[2:], (30, 2))
    k = np.arange(31, dtype=np.int64)
    land = PackedGeometry(xy=pts, ring_offsets=k, part_offsets=k, geom_offsets=k,
                          geom_type=np.full(30, int(GeometryType.POINT), np.uint8),
                          srid=np.full(30, 4326, np.int32))
    kw = dict(k_neighbours=3, max_iterations=64, early_stop_iterations=100,
              approximate=False)
    got = SpatialKNN(h3, 9, device=cuda, **kw).transform(land, cand)
    want = SpatialKNN(h3, 9, device="cpu", **kw).transform(land, cand)
    for f in ("landmark_id", "candidate_id", "rank"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(_f64_bits(got.distance), _f64_bits(want.distance))
    assert not got.metrics["degraded"]


# ---- tuning profiles on the card


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "float"])
def test_zonal_tiled_at_a_128_tile_equals_plain(cuda, integer):
    """`zonal_tiled` at the 128x128 tile a sparse raster's profile
    recommends (16,384 pixels, 256 zones) equals its plain version."""
    vals, seg = _zonal_inputs(128 * 128, 256, integer, seed=128)
    v, s = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    got, want = TZ.zonal_tiled(v, s, 256), TZ.zonal_tiled_plain(v, s, 256)
    for i in (0, 2, 3):
        assert torch.equal(got[i], want[i])
    if integer:
        assert torch.equal(got[1], want[1])
    else:
        abs_sum = torch.zeros(256, dtype=torch.float64, device=cuda)
        live = s >= 0
        abs_sum.index_add_(0, s[live].long(), v[live].abs().double())
        assert bool(((got[1].double() - want[1].double()).abs()
                     <= ZONAL_SUM_RTOL * abs_sum).all())


def test_profiled_128_tile_zones_on_card_equal_cpu(cuda):
    """A `ZonalEngine` whose profile asks for the tiled lane at 128x128
    launches `zonal_tiled` and `pip_heavy_tiled` at that tile and equals
    the CPU engine's zones bit for bit on integer-valued data."""
    from mosaic_tpu_torch.raster import ZonalEngine
    from mosaic_tpu_torch.tune import TuningProfile

    grid, ixs = _custom_indexes(cuda)
    r = _custom_raster(integer=True)
    prof = TuningProfile(zonal_lane="tiled", raster_tile=(128, 128))
    z0, h0 = TZ.zonal_tiled.launches, TP.pip_heavy_tiled.launches
    got = ZonalEngine(grid, 3, chip_index=ixs["cuda"], profile=prof).zones(r)
    assert TZ.zonal_tiled.launches > z0 and TP.pip_heavy_tiled.launches > h0
    want = ZonalEngine(grid, 3, chip_index=ixs["cpu"], profile=prof, device="cpu").zones(r)
    assert got.keys.size > 0
    for f in ("keys", "count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("sum", "min", "max"):
        np.testing.assert_array_equal(getattr(got, f).view(np.int64),
                                      getattr(want, f).view(np.int64))


def test_profiled_engine_with_a_65536_rung_equals_pip_join(cuda):
    """A `ServeEngine(profile=)` whose ladder reaches 65,536 captures every
    rung, serves a request on the top rung and small ones co-batched,
    each equal to `pip_join`; a reprofiled swap keeps the resolution
    passed and frees the replaced core's graphs."""
    from mosaic_tpu_torch.dispatch import backend_compiles
    from mosaic_tpu_torch.serve import ServeEngine
    from mosaic_tpu_torch.tune import TuningProfile

    h3, ix = _serve_index(cuda)
    prof = TuningProfile(probe="adaptive", bucket_min=4096, bucket_max=65536)
    reqs = _requests(33, [50_000] + list(np.random.default_rng(32).integers(1, 1024, 30)))
    want = _pip_join_split(reqs, h3, ix)
    with ServeEngine(ix, h3, 9, profile=prof, bounds=BBOX, max_wait_s=0.02) as eng:
        assert eng.ladder.buckets == (4096, 8192, 16384, 32768, 65536)
        eng.warmup()
        c0, l0 = backend_compiles(), TP.pip_heavy_tiled.launches
        got = [eng.submit(r, deadline_s=30.0).result(timeout=60) for r in reqs[:1]]
        futs = [eng.submit(r, deadline_s=30.0) for r in reqs[1:]]
        got += [f.result(timeout=60) for f in futs]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert eng.metrics()["cold_compiles"] == 0 and backend_compiles() == c0
        assert TP.pip_heavy_tiled.launches > l0
        old = eng.core
        eng.hot_swap(ix, profile=TuningProfile(resolution=8, bucket_min=256,
                                               bucket_max=1024), resolution=9)
        assert eng.resolution == 9 and eng.ladder.buckets == (256, 512, 1024)
        assert not old._graphs
        np.testing.assert_array_equal(
            eng.submit(reqs[1], deadline_s=30.0).result(timeout=60), want[1])


# ---- the data-parallel placement on the card


def test_meshed_join_on_card_launches_once_a_shard(cuda):
    """A 4-shard logical mesh on one card (``devices=[cuda] * 4``) gives
    `pip_join(mesh=)` the single-device join's rows, and each dispatch
    launches `pip_heavy_tiled` once a shard: 4 launches for one bucket;
    a meshed engine holds one graph per (rung, shard) and frees them all
    on ``close()``."""
    from mosaic_tpu_torch.dispatch import BucketLadder, data_mesh
    from mosaic_tpu_torch.serve import ServeEngine
    from mosaic_tpu_torch.sql import join as TJ

    h3, ix = _serve_index(cuda)
    mesh = data_mesh(devices=[torch.device("cuda", torch.cuda.current_device())] * 4)
    (pts,) = _requests(41, [5000])
    want = TJ.pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive")
    before = TP.pip_heavy_tiled.launches
    got = TJ.pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive", mesh=mesh)
    assert TP.pip_heavy_tiled.launches - before == 4
    np.testing.assert_array_equal(got, want)
    with ServeEngine(ix, h3, 9, probe="adaptive", ladder=BucketLadder(64, 1024),
                     bounds=BBOX, max_wait_s=0.0, mesh=mesh) as eng:
        eng.warmup()
        assert sorted(eng.core._graphs) == [
            (b, s) for b in eng.ladder.buckets for s in range(4)
        ]
        np.testing.assert_array_equal(eng.join(pts[:1000], deadline_s=30.0), want[:1000])
        core = eng.core
    assert core._graphs == {}


# ------------------------------------------------------ the function surface
def _surface_zones():
    return synthetic_zones(4, 4, bbox=BBOX, verts=64)


def test_rastertogridavg_on_card_equals_cpu_bit_for_bit(cuda):
    """`rst_rastertogrid*` folds through `zonal_seq_fold` on the card: every
    cell's value equals the CPU lane's bits."""
    from mosaic_tpu_torch import functions as F
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.datasets import synthetic_raster

    r = synthetic_raster(300, 260, seed=4)
    r.data[0, :7, :9] = r.nodata
    h3 = H3IndexSystem()
    for name in ("avg", "min", "max", "count"):
        fn = getattr(F, f"rst_rastertogrid{name}")
        before = TZ.zonal_fold.launches
        got = fn([r], 9, index=h3)
        assert TZ.zonal_fold.launches > before
        want = fn([r], 9, index=h3, device="cpu")
        assert [list(b) for b in got[0]] == [list(b) for b in want[0]]
        for gb, wb in zip(got[0], want[0]):
            assert {k: float(v).hex() for k, v in gb.items()} == {
                k: float(v).hex() for k, v in wb.items()}, name


def test_surface_measures_and_pairs_on_card_equal_cpu(cuda):
    """Device measures on the card within 1e-12 of the CPU (sum order);
    the f64 pair programs equal the CPU bit for bit."""
    from mosaic_tpu_torch import functions as F

    zones = _surface_zones()
    for name in ("st_area", "st_length", "st_xmin", "st_ymax"):
        fn = getattr(F, name)
        np.testing.assert_allclose(fn(zones), fn(zones, device="cpu"), rtol=1e-12)
    shifted = F.st_translate(zones, 0.004, 0.003)
    for name in ("st_contains", "st_intersects", "st_distance"):
        fn = getattr(F, name)
        got, want = fn(zones, shifted), fn(zones, shifted, device="cpu")
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name


def test_grid_longlatascellid_answers_on_card(cuda):
    from mosaic_tpu_torch import functions as F
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem

    rng = np.random.default_rng(5)
    lon, lat = rng.uniform(-74, -73.9, 5000), rng.uniform(40.7, 40.8, 5000)
    h3 = H3IndexSystem()
    got = F.grid_longlatascellid(lon, lat, 9, index=h3)
    assert got.device.type == "cuda" and got.dtype == torch.int64
    want = h3.point_to_cell(torch.from_numpy(np.stack([lon, lat], -1)).to(cuda), 9)
    assert torch.equal(got, want)


#: the reference's device bands of the CRS lane (tests/test_crs_affine.py,
#: tests/test_crs_proj.py): forward in projected units, inverse in degrees
CRS_BANDS = {32618: (1e-6, 1e-6), 27700: (1e-5, 1e-6), 3857: (1e-6, 1e-6),
             3067: (1e-6, 1e-6), 5880: (1e-6, 1e-5), 2154: (1e-6, 1e-6),
             3035: (1e-6, 1e-6), 3413: (1e-6, 1e-6)}


@pytest.mark.parametrize("srid", sorted(CRS_BANDS))
def test_crs_torch_lane_on_card_holds_the_numpy_band_without_host_sync(cuda, srid):
    """`from_wgs84`/`to_wgs84` with ``xp=crs.TORCH`` on f64 CUDA tensors:
    within the reference's bands of the numpy lane, the same non-finite
    rows, and no host synchronisation (sync debug mode "error")."""
    from mosaic_tpu_torch.core import crs

    x0, y0, x1, y1 = crs.crs_bounds(srid, reprojected=False)
    rng = np.random.default_rng(srid)
    ll = np.stack([rng.uniform(x0, x1, 4096), rng.uniform(y0, min(y1, 89.5), 4096)], -1)
    ll_t = torch.from_numpy(ll).to(cuda)
    en_np = crs.from_wgs84(ll, srid)
    en_np_t = torch.from_numpy(en_np).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        en_t = crs.from_wgs84(ll_t, srid, crs.TORCH)
        inv_t = crs.to_wgs84(en_np_t, srid, crs.TORCH)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert en_t.device.type == "cuda" and en_t.dtype == torch.float64
    fb, ib = CRS_BANDS[srid]
    for got, want, band in ((en_t, en_np, fb), (inv_t, crs.to_wgs84(en_np, srid), ib)):
        got = got.cpu().numpy()
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        assert np.abs(np.where(fin, got - want, 0.0)).max() <= band


def test_raster_to_grid_on_card_equals_cpu(cuda, tmp_path):
    """`readers.raster_to_grid` of a UTM 18N GeoTIFF (retiled, pixel
    centres reprojected on the host) on the card equals ``device="cpu"``
    bit for bit, for every combiner, and launches `zonal_seq_fold`."""
    from mosaic_tpu_torch import readers
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.datasets import synthetic_raster
    from mosaic_tpu_torch.raster import Raster, write_geotiff

    r = synthetic_raster(300, 260, seed=6)
    path = str(tmp_path / "utm.tif")
    write_geotiff(path, Raster(data=r.data, gt=(575000.0, 30.0, 0.0, 4520000.0, 0.0, -30.0),
                               srid=32618, nodata=r.nodata))
    h3 = H3IndexSystem()
    for comb in ("avg", "min", "max", "median", "count"):
        before = TZ.zonal_fold.launches
        got = readers.raster_to_grid(path, 9, comb, index=h3, tile_size=128)
        if comb != "median":
            assert TZ.zonal_fold.launches > before
        want = readers.raster_to_grid(path, 9, comb, index=h3, tile_size=128, device="cpu")
        assert {k: float(v).hex() for k, v in got[1].items()} == {
            k: float(v).hex() for k, v in want[1].items()}, comb
        assert len(got[1]) > 10


def test_benchmark_waits_for_the_card(cuda):
    """`utils.benchmark` synchronises the device of every CUDA tensor in a
    trial's result, nested in a tuple, a list, a dict, a dataclass or a
    ``.metrics`` holder: each trial's host time covers the kernel the
    trial launched (a ~10 ms `torch.cuda._sleep`), which a host clock
    without the wait would not."""
    import dataclasses

    from mosaic_tpu_torch import utils as U

    @dataclasses.dataclass
    class Box:
        t: object

    class Holder:
        def __init__(self, t):
            self.metrics = {"t": t}

    wraps = (lambda t: t, lambda t: (1, t), lambda t: [{"a": t}], Box, Holder)
    for wrap in wraps:
        ev = []

        def fn():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            torch.cuda._sleep(20_000_000)
            x = torch.ones(4, device=cuda)
            e.record()
            ev.append((s, e))
            return wrap(x)

        stats = U.benchmark(fn, trials=3, warmup=1)
        torch.cuda.synchronize()
        device_ms = sorted(s.elapsed_time(e) for s, e in ev[1:])
        assert device_ms[0] > 1.0
        assert stats["median_s"] * 1e3 >= device_ms[1], wrap


def test_device_trace_names_the_heavy_kernel(cuda, tmp_path):
    """`utils.device_trace` (the card by default) writes a Chrome trace
    under its directory that names the heavy kernel a traced adaptive
    join launched, and the region `utils.annotate` marked."""
    from mosaic_tpu_torch import utils as U
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql import join as TJ

    h3 = H3IndexSystem()
    zones = synthetic_zones(4, 4, bbox=BBOX, verts=256)
    ix = TJ.build_chip_index(tessellate(zones, h3, 9, keep_core_geoms=False), device=cuda)
    pts = np.random.default_rng(5).uniform(BBOX[:2], BBOX[2:], (50_000, 2))
    TJ.pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive")  # warm
    before = TP.pip_heavy_tiled.launches
    with U.device_trace(str(tmp_path)) as prof:
        with U.annotate("mosaic.traced_join"):
            got = TJ.pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive")
    assert TP.pip_heavy_tiled.launches == before + 1
    assert prof.trace_path.startswith(str(tmp_path))
    with open(prof.trace_path) as f:
        text = f.read()
    assert "pip_heavy_kernel" in text and "mosaic.traced_join" in text
    np.testing.assert_array_equal(
        got, TJ.pip_join(pts, None, h3, 9, chip_index=ix, probe="scatter"))


def test_chaos_sweep_on_card_holds_every_site(cuda):
    """The chaos sweep on the card: every registered fault site holds its
    contract with the CPU's outcome (`docs/TORCH_ARCHITECTURE.md`), and
    none degrades — past the budget the card raises."""
    from mosaic_tpu_torch.tools import chaos_sweep as CS

    line, rc = CS.run_sweep(device="cuda")
    detail = line["detail"]
    assert rc == 0, detail
    assert line["value"] == detail["registered"] == 25
    assert not detail["failures"] and not detail["missing_drivers"]
    got = {site: r["outcome"] for site, r in detail["outcomes"].items()}
    typed = {"epoch.apply", "epoch.compact", "epoch.publish", "raster.decode",
             "raster.zonal", "router.admit", "router.evict", "router.swap",
             "serve.admit", "serve.batch", "stream.prefetch"}
    want = {site: "typed" if site in typed else "identical" for site in got}
    want["stream.admit"] = "contained"
    assert got == want


def test_binary_transformer_checkpoints_card_state(cuda, tmp_path):
    """A `BinaryTransformer` over a `ChipIndex` on the card: its state of
    CUDA tensors is checkpointed through the host each step, and the final
    counts equal one join's."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.models import BinaryTransformer, CheckpointManager
    from mosaic_tpu_torch.sql import join as TJ

    h3 = H3IndexSystem()
    zones = synthetic_zones(3, 3, bbox=BBOX)
    ix = TJ.build_chip_index(tessellate(zones, h3, 7), device=cuda)
    pts = np.random.default_rng(6).uniform(BBOX[:2], BBOX[2:], (3_000, 2))

    def step(left, right, i):
        ids = TJ.pip_join(pts[(i - 1) * 1_000:i * 1_000], None, h3, 7, chip_index=right)
        return {"counts": left["counts"] + torch.bincount(
            torch.as_tensor(ids, device=cuda).long() + 1, minlength=10)}

    ck = CheckpointManager(str(tmp_path / "ck"))
    bt = BinaryTransformer(step, should_stop=lambda p, c: False, max_iterations=3,
                           right=ix, checkpoint=ck)
    out = bt.transform({"counts": torch.zeros(10, dtype=torch.int64, device=cuda)})
    want = torch.bincount(torch.as_tensor(
        TJ.pip_join(pts, None, h3, 7, chip_index=ix), device=cuda).long() + 1, minlength=10)
    assert out["counts"].device.type == cuda.type and torch.equal(out["counts"], want)
    loaded = ck.load()
    assert loaded["iteration"].tolist() == [1, 2, 3]
    assert np.array_equal(loaded["counts"][-10:], want.cpu().numpy())


def test_last_gap_helpers_stay_on_the_card(cuda):
    """`vert_mask`, `ring_mask`, H3's `resolution`/`base_cell`,
    `select_rows` and `cell_to_owned_fijk` answer on the card with the
    CPU's values."""
    from mosaic_tpu_torch.core.index import H3
    from mosaic_tpu_torch.core.index.h3 import core as HC
    from mosaic_tpu_torch.core.index.h3 import hexmath as HM

    col = synthetic_zones(2, 2, bbox=BBOX)
    g, c = pack_to_device(col, device=cuda), pack_to_device(col, device="cpu")
    for name in ("vert_mask", "ring_mask"):
        m = getattr(g, name)
        assert m.device.type == cuda.type and torch.equal(m.cpu(), getattr(c, name))
    pts = np.random.default_rng(7).uniform(BBOX[:2], BBOX[2:], (4_096, 2))
    cells = np.concatenate([H3.point_to_cell(pts[r::16], r) for r in range(16)])
    xp = HM.TorchNamespace(cuda)
    t = torch.as_tensor(cells, device=cuda)
    for fn in ("resolution", "base_cell"):
        got = getattr(HC, fn)(t, xp)
        assert got.device.type == cuda.type
        assert np.array_equal(got.cpu().numpy(), getattr(HC, fn)(cells))
    fijk = HC.cell_to_owned_fijk(t, xp)
    for a, b in zip(fijk, HC.cell_to_owned_fijk(cells)):
        assert a.device.type == cuda.type and np.array_equal(a.cpu().numpy(), b)
    table = np.random.default_rng(8).random((20, 3))
    idx = torch.as_tensor(cells % 20, device=cuda)
    rows = HM.select_rows(idx, table, 20, xp)
    assert rows.device.type == cuda.type
    assert np.array_equal(rows.cpu().numpy(), table[cells % 20])


def test_retry_attempts_knob_on_the_card(cuda, monkeypatch):
    """``MOSAIC_RETRY_ATTEMPTS=1``: one transient fault exhausts the join
    on the card after one attempt; ``=2``: it answers the clean bits."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.runtime import RetryExhausted, faults, telemetry
    from mosaic_tpu_torch.sql import join as TJ

    h3 = H3IndexSystem()
    ix = TJ.build_chip_index(tessellate(synthetic_zones(3, 3, bbox=BBOX), h3, 7), device=cuda)
    pts = np.random.default_rng(9).uniform(BBOX[:2], BBOX[2:], (2_000, 2))
    clean = TJ.pip_join(pts, None, h3, 7, chip_index=ix)
    monkeypatch.setenv("MOSAIC_RETRY_ATTEMPTS", "1")
    with telemetry.capture() as ev, faults.transient_errors(1, sites=("pip_join.device",)):
        with pytest.raises(RetryExhausted) as ei:
            TJ.pip_join(pts, None, h3, 7, chip_index=ix)
    assert ei.value.attempts == 1 and "degraded" not in [e["event"] for e in ev]
    monkeypatch.setenv("MOSAIC_RETRY_ATTEMPTS", "2")
    with faults.transient_errors(1, sites=("pip_join.device",)):
        again = TJ.pip_join(pts, None, h3, 7, chip_index=ix)
    assert np.array_equal(again, clean)
