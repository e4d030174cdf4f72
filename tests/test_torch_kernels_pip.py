"""The port's PIP kernels (`mosaic_tpu_torch/kernels/pip.py`) against the
JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper runs its plain torch version, which repeats the
CUDA kernel's arithmetic op for op; the bar is exact equality (tolerance
zero) with the reference kernel on the same numpy inputs. The kernels
themselves are held against the plain versions on the card
(`tests/test_torch_kernels_gpu.py`, skipped without CUDA, and
`chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.geometry.device import pack_to_device as ref_pack
from mosaic_tpu.kernels import pip as RP
from mosaic_tpu_torch.core.geometry.device import pack_to_device
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.kernels import pip as TP

import fixtures as fx
from torch_heavy_layouts import LAYOUTS, heavy_layout


def _port_col(col):
    """The reference PackedGeometry as the port's (same CSR arrays)."""
    return PackedGeometry(
        xy=col.xy, ring_offsets=col.ring_offsets, part_offsets=col.part_offsets,
        geom_offsets=col.geom_offsets, geom_type=col.geom_type, srid=col.srid,
    )


def _heavy_inputs(seed=9, H=3, E2=24, M2=4, K=300):
    """Random short edges with slot bits — the reference test's inputs."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (H, E2, 2))
    b = a + rng.uniform(-0.5, 0.5, (H, E2, 2))
    edges = np.concatenate([a, b], axis=2).astype(np.float32)
    slot = rng.integers(0, M2, (H, E2))
    bits = (np.uint32(1) << slot.astype(np.uint32)).astype(np.uint32)
    geom = rng.integers(0, 50, (H, M2)).astype(np.int32)
    geom[0, 1] = -1  # an empty slot must never win
    px = rng.uniform(-1, 1, K).astype(np.float32)
    py = rng.uniform(-1, 1, K).astype(np.float32)
    rows = rng.integers(0, H, K).astype(np.int32)
    rows[-7:] = -1  # pad rows
    return px, py, rows, edges, bits, geom


def _port_heavy(px, py, rows, edges, bits, geom, eps2=None, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return TP.pip_heavy_tiled(
        t(px), t(py), t(rows.astype(np.int32)), t(edges),
        t(bits.astype(np.uint32).view(np.int32)), t(geom),
        eps2=None if eps2 is None else torch.tensor(eps2, device=device),
    )


# ------------------------------------------------------------ heavy kernel


#: per seed, the heavy-table shape; seed 33 fills all 32 slots of a row,
#: so bit 31 (the sign bit of the port's int32 slot bits) is set
_HEAVY_SHAPES = {9: {}, 21: {}, 33: dict(H=4, E2=64, M2=32, K=600)}


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("case", sorted(_HEAVY_SHAPES) + sorted(LAYOUTS))
def test_pip_heavy_plain_equals_reference_kernel(banded, case):
    """Tolerance 0: best and the band mask equal the Pallas kernel's, on
    random rows (an int ``case`` is a seed) and on the skewed-row layouts
    that the card's test feeds the CUDA kernel (`torch_heavy_layouts`)."""
    if isinstance(case, int):
        px, py, rows, edges, bits, geom = _heavy_inputs(case, **_HEAVY_SHAPES[case])
        band = np.float32(1e-3)
    else:
        px, py, rows, edges, bits, geom, band = heavy_layout(case)
    if geom.shape[1] == 32:
        assert (bits == np.uint32(1 << 31)).any()
    eps2 = band if banded else None
    want_b, want_n = RP.pip_heavy_tiled(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(rows),
        jnp.asarray(edges), jnp.asarray(bits), jnp.asarray(geom),
        eps2=None if eps2 is None else jnp.asarray(eps2), interpret=True,
    )
    got_b, got_n = _port_heavy(px, py, rows, edges, bits, geom, eps2)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    if banded:
        assert np.asarray(want_n).any()
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    else:
        assert got_n is None and want_n is None


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_heavy_layouts_reach_their_cases(case):
    """Each skewed-row layout holds what it is named for, in f32 as the
    kernel computes it: a row with many times the points of a work item
    (32), interleaved pads, more rows than points, descending rows,
    ay == by and dd == 0 edges (dd == 0 with a positive projection
    numerator among them), projections that clamp at exactly 0 and 1
    inside and outside the band, rows whose edges past the kernel's first
    and second staged chunks (512 edges each) change results, and rows
    past the table's end."""
    px, py, rows, edges, bits, geom, eps2 = heavy_layout(case)
    live = (rows >= 0) & (rows < edges.shape[0])
    r = rows[live]
    ax, ay, bx, by = np.moveaxis(edges[r], -1, 0)
    real = bits[r] != 0
    ex, ey = bx - ax, by - ay
    qx, qy = px[live][:, None] - ax, py[live][:, None] - ay
    dd = ex * ex + ey * ey
    dot = qx * ex + qy * ey
    if case == "one_row":
        assert (np.bincount(r) > 128 * 8).any()
    elif case == "pads_interleaved":
        assert (~live[: len(rows) // 2]).any() and live[-100:].any()
    elif case == "sparse_rows":
        assert edges.shape[0] > len(rows) and np.unique(r).size == r.size
    elif case == "reverse_rows":
        assert (np.diff(rows) <= 0).all() and np.unique(rows).size > 1
    elif case == "degenerate":
        assert ((ay == by) & real).any() and ((dd == 0) & (dot > 0) & real).any()
        assert ((dd == 0) & (dot == 0) & real).any()
    elif case == "wide_rows":
        assert edges.shape[1] > 2 * 512 and edges.shape[1] % 512
        pyl, pxl = py[live][:, None], px[live][:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            xc = ax + (pyl - ay) * (bx - ax) / np.where(by == ay, 1, by - ay)
        vals = np.where(((ay > pyl) != (by > pyl)) & (pxl < xc), bits[r], 0)
        t = np.clip(dot / np.where(dd == 0, 1, dd), 0, 1)
        near = ((qx - t * ex) ** 2 + (qy - t * ey) ** 2 <= eps2) & real
        for e0 in (512, 1024):
            assert (np.bitwise_xor.reduce(vals[:, e0:], axis=1) != 0).any()
            assert (near[:, e0:].any(axis=1) & ~near[:, :e0].any(axis=1)).any()
    elif case == "rows_past_table":
        past = rows >= edges.shape[0]
        assert past[: len(rows) // 2].any() and (rows == 2**31 - 1).any()
        assert (rows == edges.shape[0]).any() and live.any()
    else:
        t = np.clip(dot / np.where(dd == 0, 1, dd), 0, 1)
        dist = (qx - t * ex) ** 2 + (qy - t * ey) ** 2
        for edge in (dot == 0, (dot == dd) & (dd > 0)):
            assert (edge & real & (dist <= eps2)).any()
            assert (edge & real & (dist > eps2)).any()


def test_pip_heavy_matches_ray_parity_reference():
    """The port's kernel wrapper equals its own `_ray_parity` + slot-min
    merge row for row (the reference test `test_pip_heavy_tiled_matches_
    ray_parity_reference`, ported): parity, band, int32-max sentinel."""
    from mosaic_tpu_torch.sql import join as TJ

    px, py, rows, edges, bits, geom = _heavy_inputs()
    eps2 = np.float32(1e-8)
    best, near = _port_heavy(px, py, rows, edges, bits, geom, eps2)
    r = np.maximum(rows, 0)
    par, ref_near = TJ._ray_parity(
        torch.as_tensor(px), torch.as_tensor(py), torch.as_tensor(edges[r]),
        torch.as_tensor(bits[r].view(np.int32)), eps2=torch.tensor(eps2),
    )
    par = par.numpy()
    g = geom[r]
    inside = ((par[:, None] >> np.arange(g.shape[1])) & 1).astype(bool) & (g >= 0)
    sent = np.iinfo(np.int32).max
    ref = np.where(inside, g, sent).min(axis=1)
    ref[rows < 0] = sent
    np.testing.assert_array_equal(best.numpy(), ref)
    np.testing.assert_array_equal(near.numpy(), ref_near.numpy() & (rows >= 0))


def test_pip_heavy_rejects_f64_tables():
    z = torch.zeros(1, dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        TP.pip_heavy_tiled(
            z, z, torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 8, 4), dtype=torch.float64),
            torch.zeros((1, 8), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32),
        )


@pytest.mark.parametrize("kw", [{"tile_g": 100}, {"tile_e": 12}, {"tile_n": 20}])
def test_pip_heavy_rejects_untiled_tiles(kw):
    z = torch.zeros(16, dtype=torch.float32)
    with pytest.raises(TP.TilingError):
        TP.pip_heavy_tiled(
            z, z, torch.zeros(16, dtype=torch.int32),
            torch.zeros((1, 8, 4), dtype=torch.float32),
            torch.zeros((1, 8), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32), **kw,
        )


# -------------------------------------------------------------- zone kernel


@pytest.fixture(scope="module")
def polys():
    return wkt.from_wkt(fx.POLY_WKT + fx.MULTIPOLY_WKT)


@pytest.mark.parametrize(
    "n, seed, g_pad", [(777, 4, 128), (100, 5, 128), (512, 6, 256)],
    ids=["matches_reference", "unaligned_n", "multiblock_g"],
)
def test_pip_zone_plain_equals_reference(polys, n, seed, g_pad):
    """The reference's three `test_pallas_pip_*` cases (f64, tile_e=8):
    the port's pip_zone equals the Pallas kernel in interpret mode, the
    reference's `pip_zone_reference` and the port's own — tolerance 0."""
    pts = fx.random_points(n, bbox=(-1, -2, 11, 11), seed=seed)
    rdev = ref_pack(polys, dtype=jnp.float64)
    rplanes, n_g = RP.edge_planes(rdev, g_pad=g_pad)
    want = np.asarray(RP.pip_zone(
        jnp.asarray(pts), rplanes, n_g, tile_n=1024, tile_e=8, interpret=True
    ))
    want_ref = np.asarray(RP.pip_zone_reference(jnp.asarray(pts), rdev))
    tdev = pack_to_device(_port_col(polys), dtype=torch.float64, device="cpu")
    planes, tn_g = TP.edge_planes(tdev, g_pad=g_pad)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(rplanes))
    assert tn_g == n_g
    got = TP.pip_zone(torch.as_tensor(pts), planes, tn_g, tile_e=8).numpy()
    got_ref = TP.pip_zone_reference(torch.as_tensor(pts), tdev).numpy()
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got_ref, want_ref)


def test_pip_zone_plain_equals_reference_f32_zones():
    """The slice's configuration in small: f32, recentred synthetic zones
    with 256 vertices, points near the zone edges included — the port's
    plain version equals the Pallas kernel bit for bit (tolerance 0)."""
    from mosaic_tpu.datasets import synthetic_zones as ref_zones
    from mosaic_tpu_torch.datasets import synthetic_zones

    bbox = (-74.0, 40.7, -73.9, 40.786)
    rcol = ref_zones(2, 2, bbox=bbox, verts=256)
    rdev = ref_pack(rcol, dtype=jnp.float32, recenter=True)
    rplanes, n_g = RP.edge_planes(rdev)
    tdev = pack_to_device(
        synthetic_zones(2, 2, bbox=bbox, verts=256), dtype=torch.float32,
        recenter=True, device="cpu",
    )
    planes, _ = TP.edge_planes(tdev)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(rplanes))
    rng = np.random.default_rng(1)
    shift = np.asarray(rdev.shift)
    pts = rng.uniform(bbox[:2], bbox[2:], (3000, 2)) - shift
    # points within a few ulps of real edges: the rounding-sensitive band
    ring = rcol.xy[:256] - shift
    mid = 0.5 * (ring + np.roll(ring, -1, axis=0))
    pts = np.concatenate([pts, mid + 1e-7, mid - 1e-7]).astype(np.float32)
    want = np.asarray(RP.pip_zone(jnp.asarray(pts), rplanes, n_g, interpret=True))
    got = TP.pip_zone(torch.as_tensor(pts), planes, n_g).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


def test_pip_zone_rejects_unaligned_tile_n(polys):
    tdev = pack_to_device(_port_col(polys), dtype=torch.float32, device="cpu")
    planes, n_g = TP.edge_planes(tdev)
    with pytest.raises(ValueError, match="multiple of 8"):
        TP.pip_zone(torch.zeros((4, 2)), planes, n_g, tile_n=12)


# ------------------------------------------------------- tiling validation


def test_pad_to_refuses_to_shrink():
    with pytest.raises(TP.TilingError, match="cannot shrink"):
        TP._pad_to(torch.zeros((4, 4)), 2, axis=0)


@pytest.mark.parametrize(
    "kw", [{"g_pad": 100}, {"g_pad": 0}, {"e_pad": 12}, {"e_pad": 0}]
)
def test_edge_planes_rejects_untiled_pads(kw):
    col = wkt.from_wkt(["POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))"])
    dev = pack_to_device(_port_col(col), recenter=True, device="cpu")
    with pytest.raises(TP.TilingError, match="multiple"):
        TP.edge_planes(dev, **kw)


def test_plain_path_only_for_cpu_tensors(monkeypatch):
    """A CPU tensor takes the plain version and counts no launch."""
    px, py, rows, edges, bits, geom = _heavy_inputs()
    before = (TP.pip_heavy_tiled.launches, TP.pip_zone.launches)
    _port_heavy(px, py, rows, edges, bits, geom)
    assert (TP.pip_heavy_tiled.launches, TP.pip_zone.launches) == before


@pytest.mark.parametrize("capturing", [False, True], ids=["eager", "captured"])
def test_launch_counted_eagerly_or_at_each_replay(monkeypatch, capturing):
    """An eager launch counts at once; a launch captured into a CUDA graph
    counts nothing until each replay (`_build.count_replay`), for any
    counted wrapper."""
    from mosaic_tpu_torch.kernels import _build

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    before = (TP.pip_heavy_tiled.launches, TP.pip_zone.launches)
    with _build.captured_launches() as record:
        _build.count_launch(TP.pip_heavy_tiled)
        _build.count_launch(TP.pip_zone)
        _build.count_launch(TP.pip_zone)
    added = (TP.pip_heavy_tiled.launches - before[0], TP.pip_zone.launches - before[1])
    if not capturing:
        assert added == (1, 2) and record == {}
        return
    assert added == (0, 0) and record == {TP.pip_heavy_tiled: 1, TP.pip_zone: 2}
    for rep in (1, 2):
        _build.count_replay(record)
        assert (TP.pip_heavy_tiled.launches - before[0],
                TP.pip_zone.launches - before[1]) == (rep, 2 * rep)
    TP.pip_heavy_tiled.launches, TP.pip_zone.launches = before
