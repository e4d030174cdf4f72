"""The epsilon-band recheck of the port against the JAX package.

Mirrors `tests/test_recheck.py` on the port (`device="cpu"`): the
cell-rounding margin flags every f32/f64 cell disagreement of the port's
own torch f32 path with 2x headroom under `CELL_MARGIN_K`, the runner-up
cell covers the flagged points, and `pip_join(recheck=True,
cell_dtype=float32)` equals both `host_join` and the reference's
`pip_join(recheck=True, cell_dtype=jnp.float32)` exactly (tolerance 0 on
the ids) — H3 with both probes, the custom grid under the adaptive
probe, and BNG (the `host_all` branch).

Band sizes may differ from the reference's: torch's f32 trigonometry is
not XLA's, so the two margins of one point differ by up to a few eps
(`test_f32_margins_within_drift_of_reference` measures it). The slack
allowed for a band count is the number of points whose margin, in either
package, lies within that measured drift of the band's threshold.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import BNG as RefBNG
from mosaic_tpu.core.index import H3 as RefH3
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefGridConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.runtime import telemetry as ref_telemetry
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch import context as TC
from mosaic_tpu_torch.core.index import BNG, CustomIndexSystem, GridConf, H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.sql import join as TJ
from mosaic_tpu_torch.tools.calibrate_margins import (
    global_points,
    measure_cell_drift,
    measure_edge_drift,
)

EPS32 = float(np.finfo(np.float32).eps)
H3 = H3IndexSystem()
NYC = [
    "POLYGON ((-74.02 40.70, -73.96 40.70, -73.96 40.76, "
    "-74.02 40.76, -74.02 40.70))",
    "POLYGON ((-73.96 40.70, -73.90 40.70, -73.90 40.76, "
    "-73.96 40.76, -73.96 40.70))",
    "POLYGON ((-74.00 40.77, -73.92 40.77, -73.92 40.80, "
    "-74.00 40.80, -74.00 40.77), (-73.97 40.78, -73.97 40.79, "
    "-73.95 40.79, -73.95 40.78, -73.97 40.78))",
]


def port_geometry(col) -> PackedGeometry:
    """The port's geometry column with the reference column's arrays."""
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def nyc_points(n, seed):
    rng = np.random.default_rng(seed)
    return np.column_stack(
        [rng.uniform(-74.05, -73.87, n), rng.uniform(40.68, 40.82, n)]
    )


@pytest.fixture(scope="module")
def nyc():
    """{res: (reference index, port index)} over the NYC zones."""
    col = wkt.from_wkt(NYC)
    out = {}
    for res in (8, 9):
        ref = RJ.build_chip_index(ref_tessellate(col, RefH3, res, keep_core_geoms=False))
        port = TJ.build_chip_index(
            tessellate(port_geometry(col), H3, res, keep_core_geoms=False),
            device="cpu",
        )
        out[res] = (ref, port)
    return out


def port_recheck(pts, port, res, **kw):
    return TJ.pip_join(pts, None, H3, res, chip_index=port, recheck=True,
                       cell_dtype=torch.float32, device="cpu", **kw)


def ref_recheck(pts, ref, res, **kw):
    return np.asarray(RJ.pip_join(pts, None, RefH3, res, chip_index=ref, recheck=True,
                                  cell_dtype=jnp.float32, **kw))


# ------------------------------------------------ margins and alternates


def test_margin_covers_all_f32_disagreements():
    """Every point whose port f32 cell differs from the f64 cell sits
    inside the band, with >= 2x headroom below CELL_MARGIN_K."""
    pts = global_points(150_000, 3)
    c64 = H3.point_to_cell(pts, 9)
    c32, m = H3.point_to_cell_margin(torch.from_numpy(pts).float(), 9)
    c32, m = c32.numpy(), m.numpy()
    dis = c32 != c64
    assert dis.any(), "sanity: f32 must disagree somewhere at res 9"
    worst = m[dis, 0].max() / EPS32
    assert worst <= TJ.CELL_MARGIN_K / 2, (
        f"disagreeing point at margin {worst:.2f}·eps — above the "
        f"calibrated headroom ({TJ.CELL_MARGIN_K}/2)"
    )
    band = (m[:, 0] < TJ.CELL_MARGIN_K * EPS32).mean()
    assert band < 0.08, f"cell band too wide: {band:.3f}"


def test_alt_cell_covers_flagged_points():
    """For flagged points the true f64 cell is the primary or the runner-
    up — except near cell corners or where no valid alternate exists."""
    pts = global_points(150_000, 11)
    c64 = H3.point_to_cell(pts, 9)
    f32 = torch.from_numpy(pts).float()
    c32, m = H3.point_to_cell_margin(f32, 9)
    alt = H3.point_to_cell_alt(f32, 9).numpy()
    c32, m = c32.numpy(), m.numpy()
    km = TJ.CELL_MARGIN_K * EPS32
    flagged, vertex = m[:, 0] < km, m[:, 1] < km
    dis = c32 != c64
    covered = ~dis | (flagged & ((alt == c64) | vertex | (alt == -1)))
    assert covered.all(), pts[~covered][:3]
    esc = (flagged & (vertex | (alt == -1))).mean()
    assert esc < 0.005, f"direct-host escalation too wide: {esc:.4f}"


def test_alt_cell_is_a_neighbor():
    """The runner-up is a distinct cell, and (away from face-overage
    geometry) an edge-sharing neighbour."""
    pts = global_points(4_000, 5)
    f32 = torch.from_numpy(pts).float()
    c32 = H3.point_to_cell(f32, 7).numpy()
    alt = H3.point_to_cell_alt(f32, 7).numpy()
    ok = alt >= 0
    assert (alt[ok] != c32[ok]).all()
    nb = H3.neighbors(c32[ok])
    assert (nb == alt[ok, None]).any(axis=1).mean() > 0.999


@pytest.mark.parametrize("res", [5, 9, 11])
def test_f64_margins_and_alternates_equal_reference(res):
    """On the f64 path the host margins equal the reference's bit for bit
    and the torch margins within ~1e-16 (torch's and XLA's f64 trig);
    cells and alternates are equal."""
    pts = global_points(20_000, res)
    want_c, want_m = RefH3.point_to_cell_margin(pts, res)
    got_c, got_m = H3.point_to_cell_margin(pts, res)
    np.testing.assert_array_equal(got_c, np.asarray(want_c))
    np.testing.assert_array_equal(got_m, np.asarray(want_m))
    np.testing.assert_array_equal(H3.point_to_cell_alt(pts, res),
                                  np.asarray(RefH3.point_to_cell_alt(pts, res)))
    dev_c, dev_m = H3.point_to_cell_margin(torch.from_numpy(pts), res)
    ref_c, ref_m = RefH3.point_to_cell_margin(jnp.asarray(pts), res)
    np.testing.assert_array_equal(dev_c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(dev_m.numpy(), np.asarray(ref_m), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(
        H3.point_to_cell_alt(torch.from_numpy(pts), res).numpy(),
        np.asarray(RefH3.point_to_cell_alt(jnp.asarray(pts), res)),
    )


def test_f32_margins_within_drift_of_reference():
    """The f32 margins of the two packages differ by the trig drift only:
    a few eps, never more than the band's own headroom."""
    pts = global_points(40_000, 21)
    _, got = H3.point_to_cell_margin(torch.from_numpy(pts).float(), 9)
    _, want = RefH3.point_to_cell_margin(jnp.asarray(pts, jnp.float32), 9)
    drift = np.abs(got.numpy() - np.asarray(want)).max() / EPS32
    assert drift <= TJ.CELL_MARGIN_K / 2, drift


def test_port_drift_keeps_two_x_headroom():
    """The port's own calibration sweep (cells at res 9 and 11, the edge
    band over 144 zones) stays under half of both constants on the CPU."""
    for res in (9, 11):
        r = measure_cell_drift(H3, global_points(40_000, 21), res, device="cpu")
        assert r["n_disagreements"] > 0
        assert 2 * r["max_observed_k"] <= TJ.CELL_MARGIN_K, r
    from mosaic_tpu_torch.datasets import synthetic_zones

    bbox = (-74.05, 40.60, -73.85, 40.85)
    zones = synthetic_zones(12, 12, bbox=bbox, seed=3)
    pts = np.random.default_rng(103).uniform(bbox[:2], bbox[2:], (20_000, 2))
    r = measure_edge_drift(zones, H3, 9, pts, seed=3, device="cpu")
    assert r["n_disagreements"] > 0, "no edge drift measured: no signal"
    assert 2 * r["max_observed_k"] <= TJ.EDGE_BAND_K, r


def test_bng_margin_flags_boundary_points():
    cells, m = BNG.point_to_cell_margin(
        np.array([[100000.0, 200000.0], [123456.7, 254321.9]]), 4
    )
    assert m.shape == (2, 2)
    assert m[0, 0] < 1e-12  # ON a binning boundary: zero margin
    assert m[1, 0] > 1e-6


# ------------------------------------------------------ the exact join


@pytest.mark.parametrize("probe", ["scatter", "adaptive"])
def test_pip_join_recheck_equals_host_and_reference(nyc, probe):
    """f32 cells + f32 probe + recheck == the exact f64 host join ==
    the reference's recheck join, row for row."""
    ref, port = nyc[9]
    pts = nyc_points(30_000, 2)
    got = port_recheck(pts, port, 9, probe=probe)
    np.testing.assert_array_equal(got, TJ.host_join(pts, port.host, H3, 9))
    np.testing.assert_array_equal(got, ref_recheck(pts, ref, 9, probe=probe))


def test_pip_join_recheck_batched_equals_host(nyc):
    _, port = nyc[9]
    pts = nyc_points(10_000, 12)
    got = port_recheck(pts, port, 9, batch_size=3_000, probe="adaptive")
    np.testing.assert_array_equal(got, TJ.host_join(pts, port.host, H3, 9))


def test_pip_join_recheck_off_still_close(nyc):
    """Without the recheck the f32 path differs only inside the band."""
    _, port = nyc[9]
    pts = nyc_points(30_000, 4)
    got = TJ.pip_join(pts, None, H3, 9, chip_index=port, recheck=False,
                      cell_dtype=torch.float32, device="cpu")
    assert (got != TJ.host_join(pts, port.host, H3, 9)).mean() < 0.005


def test_recheck_config_flag_routes_default(nyc, monkeypatch):
    _, port = nyc[8]
    pts = nyc_points(5_000, 6)
    want = TJ.host_join(pts, port.host, H3, 8)
    cfg = TC.current_config()
    assert cfg.exact_recheck is False
    monkeypatch.setattr(
        TJ, "current_config",
        lambda: dataclasses.replace(cfg, exact_recheck=True),
    )
    with telemetry.capture() as ev:
        got = TJ.pip_join(pts, None, H3, 8, chip_index=port, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert [e for e in ev if e["event"] == "recheck_narrow"]


def test_config_context_build_and_reset():
    try:
        TC.MosaicContext.build(exact_recheck=True)
        assert TC.current_config().exact_recheck is True
    finally:
        TC.MosaicContext.reset()
    assert TC.current_config() == TC.MosaicConfig(exact_recheck=False)


def test_host_companion_round_trip(nyc):
    """HostRecheck survives an npz round trip, and the reference reads
    the port's arrays (and back) field for field."""
    ref, port = nyc[8]
    buf = io.BytesIO()
    np.savez(buf, **port.host.save_arrays())
    buf.seek(0)
    back = TJ.HostRecheck.from_arrays(np.load(buf))
    assert back.coord_scale == port.host.coord_scale
    np.testing.assert_array_equal(back.cells, port.host.cells)
    np.testing.assert_array_equal(back.cell_edges, port.host.cell_edges)
    theirs = ref.host.save_arrays()
    for k, v in port.host.save_arrays().items():
        np.testing.assert_array_equal(v, np.asarray(theirs[k]), err_msg=k)


def test_recheck_requires_host_companion(nyc):
    _, port = nyc[8]
    stripped = dataclasses.replace(port)  # fresh instance without .host
    assert getattr(stripped, "host", None) is None
    with pytest.raises(ValueError, match="host companion"):
        port_recheck(nyc_points(100, 1), stripped, 8)


def test_recheck_runs_one_narrow_compacted_rejoin(nyc):
    """ONE band-compacted narrow re-join a batch: exactly one
    `recheck_narrow` event, its cap strictly below the batch width, its
    caps sized to the band, the result equal to f64; and its band within
    the drift slack of the reference's band (ties equal here)."""
    ref, port = nyc[9]
    pts = nyc_points(30_000, 13)
    with telemetry.capture() as events:
        got = port_recheck(pts, port, 9)
    np.testing.assert_array_equal(got, TJ.host_join(pts, port.host, H3, 9))
    narrow = [e for e in events if e["event"] == "recheck_narrow"]
    assert len(narrow) == 1, narrow
    e = narrow[0]
    assert e["mode"] == "alt_rejoin"
    assert 0 < e["band"] <= e["cap"] < e["n"] == pts.shape[0]
    assert e["caps"][0] <= e["cap"]
    assert e["ties"] >= 0 and e["seconds"] >= 0
    with ref_telemetry.capture() as rev:
        ref_recheck(pts, ref, 9)
    (r,) = [x for x in rev if x["event"] == "recheck_narrow"]
    km = TJ.CELL_MARGIN_K * EPS32
    assert abs(e["band"] - r["band"]) <= _band_slack(pts, km)


def _band_slack(pts, km):
    """Points whose f32 first margin, in either package, lies within the
    measured drift between the packages of the threshold ``km``."""
    _, got = H3.point_to_cell_margin(torch.from_numpy(pts).float(), 9)
    _, want = RefH3.point_to_cell_margin(jnp.asarray(pts, jnp.float32), 9)
    got, want = got.numpy()[:, 0], np.asarray(want)[:, 0]
    d = np.abs(got - want).max()
    return int(((np.abs(got - km) <= d) | (np.abs(want - km) <= d)).sum())


def test_recheck_narrow_respects_margin_override(nyc):
    """``cell_margin_k=0`` flags exactly the points whose first f32
    margin is negative (the tie-fix's documented case, not clamped); the
    port's and the reference's counts at 0 agree within the drift slack;
    a wider band flags more than the default. The answer stays exact at
    the default and the wider band."""
    ref, port = nyc[9]
    pts = nyc_points(8_000, 8)
    _, m = H3.point_to_cell_margin(torch.from_numpy(pts).float(), 9)
    negative = int((m.numpy()[:, 0] < 0).sum())
    bands = {}
    for k in (0.0, None, 4 * TJ.CELL_MARGIN_K):
        with telemetry.capture() as ev:
            got = port_recheck(pts, port, 9, cell_margin_k=k)
        narrow = [e["band"] for e in ev if e["event"] == "recheck_narrow"]
        assert len(narrow) <= 1
        bands[k] = narrow[0] if narrow else 0
        if k != 0.0:
            np.testing.assert_array_equal(got, TJ.host_join(pts, port.host, H3, 9))
    assert bands[0.0] == negative
    with ref_telemetry.capture() as rev:
        ref_recheck(pts, ref, 9, cell_margin_k=0.0)
    ref_band = sum(e["band"] for e in rev if e["event"] == "recheck_narrow")
    _, rm = RefH3.point_to_cell_margin(jnp.asarray(pts, jnp.float32), 9)
    assert ref_band == int((np.asarray(rm)[:, 0] < 0).sum())
    assert abs(bands[0.0] - ref_band) <= _band_slack(pts, 0.0)
    assert bands[4 * TJ.CELL_MARGIN_K] > bands[None] > bands[0.0]


# ---------------------------------------------- other index systems

CUSTOM_CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)


def _star_wkt(cx=25.0, cy=-14.0, n=240):
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    r = np.where(np.arange(n) % 2 == 0, 4.0, 2.0)
    x, y = cx + r * np.cos(th), cy + r * np.sin(th)
    ring = ", ".join(f"{a:.6f} {b:.6f}" for a, b in zip(x, y))
    return f"POLYGON (({ring}, {x[0]:.6f} {y[0]:.6f}))"


CUSTOM_ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1), "
    "(5 5, 5 8, 8 8, 8 5, 5 5))",
    "POLYGON ((20 0, 30 0, 30 10, 25 4, 20 10, 20 0))",
    "MULTIPOLYGON (((-20 -20, -12 -20, -12 -12, -20 -12, -20 -20)), "
    "((-8 -8, -2 -8, -2 -2, -8 -2, -8 -8)))",
    "POLYGON ((-24 5, -14 5, -14 15, -24 15, -24 5))",
    _star_wkt(),
]


def test_custom_grid_adaptive_recheck_equals_host_and_reference():
    """The custom grid has no margins: only the edge band goes to the
    host, so its cells must be exact — f64, as the reference's test gets
    them from its f64 input. Mirrors `tests/test_probe_adaptive.py`'s
    adaptive recheck on its mixed batch and a near-edge batch."""
    col = wkt.from_wkt(CUSTOM_ZONES)
    rsys, psys = RefCustom(RefGridConf(*CUSTOM_CONF)), CustomIndexSystem(GridConf(*CUSTOM_CONF))
    ref = RJ.build_chip_index(ref_tessellate(col, rsys, 3, keep_core_geoms=False), edge_cap=8)
    port = TJ.build_chip_index(
        tessellate(port_geometry(col), psys, 3, keep_core_geoms=False),
        edge_cap=8, device="cpu",
    )
    assert port.num_heavy_cells > 0 and port.num_convex_cells > 0
    rng = np.random.default_rng(3)
    mixed = rng.uniform((-25, -25), (35, 20), (4_000, 2))
    edges = port.host.cell_edges[port.host.cell_ebits != 0][:400]
    t = rng.uniform(0, 1, (len(edges), 1))
    near = edges[:, :2] + t * (edges[:, 2:] - edges[:, :2]) + port.host.shift
    near = near + rng.normal(0, 1e-6, near.shape)
    for pts in (mixed, near):
        want = TJ.host_join(pts, port.host, psys, 3)
        got = TJ.pip_join(pts, None, psys, 3, chip_index=port, recheck=True,
                          probe="adaptive", cell_dtype=torch.float64, device="cpu")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(RJ.pip_join(
            pts, None, rsys, 3, chip_index=ref, recheck=True, probe="adaptive")))


def test_pip_join_recheck_bng_no_alt_fallback():
    """BNG has margins but no alternate rounding: the whole flagged band
    escalates to the host oracle (`host_all`) — still exactly equal to
    f64, and to the reference."""
    col = wkt.from_wkt([
        "POLYGON ((400000 200000, 440000 200000, 440000 240000, "
        "400000 240000, 400000 200000))",
        "POLYGON ((440000 200000, 480000 200000, 480000 240000, "
        "440000 240000, 440000 200000))",
    ])
    ref = RJ.build_chip_index(ref_tessellate(col, RefBNG, 3, keep_core_geoms=False))
    port = TJ.build_chip_index(
        tessellate(port_geometry(col), BNG, 3, keep_core_geoms=False), device="cpu"
    )
    rng = np.random.default_rng(4)
    pts = np.column_stack(
        [rng.uniform(395000, 485000, 20000), rng.uniform(195000, 245000, 20000)]
    )
    with telemetry.capture() as ev:
        got = TJ.pip_join(pts, None, BNG, 3, chip_index=port, recheck=True,
                          cell_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got, TJ.host_join(pts, port.host, BNG, 3))
    np.testing.assert_array_equal(got, np.asarray(RJ.pip_join(
        pts, None, RefBNG, 3, chip_index=ref, recheck=True, cell_dtype=jnp.float32)))
    (e,) = [x for x in ev if x["event"] == "recheck_narrow"]
    assert e["mode"] == "host_all" and e["ties"] == e["band"] > 0


@pytest.fixture(scope="module")
def custom_star():
    """(reference system, port system, reference index, port index) over
    `CUSTOM_ZONES` at resolution 3 with ``edge_cap=8`` (heavy and convex
    cells present), and the mixed and near-edge batches of
    `test_custom_grid_adaptive_recheck_equals_host_and_reference`."""
    col = wkt.from_wkt(CUSTOM_ZONES)
    rsys, psys = RefCustom(RefGridConf(*CUSTOM_CONF)), CustomIndexSystem(GridConf(*CUSTOM_CONF))
    ref = RJ.build_chip_index(ref_tessellate(col, rsys, 3, keep_core_geoms=False), edge_cap=8)
    port = TJ.build_chip_index(
        tessellate(port_geometry(col), psys, 3, keep_core_geoms=False),
        edge_cap=8, device="cpu",
    )
    rng = np.random.default_rng(3)
    mixed = rng.uniform((-25, -25), (35, 20), (4_000, 2))
    edges = port.host.cell_edges[port.host.cell_ebits != 0][:400]
    t = rng.uniform(0, 1, (len(edges), 1))
    near = edges[:, :2] + t * (edges[:, 2:] - edges[:, :2]) + port.host.shift
    near = near + rng.normal(0, 1e-6, near.shape)
    return rsys, psys, ref, port, {"mixed": mixed, "near_edge": near}


@pytest.mark.parametrize("batch", ["mixed", "near_edge"])
@pytest.mark.parametrize("probe", ["adaptive", "scatter"])
def test_custom_grid_recheck_default_cell_dtype_is_exact(custom_star, batch, probe):
    """With default arguments the exact join on the custom grid (no cell
    margins) computes its cells in f64, so it equals `host_join` and the
    reference exactly. Rows 233, 277 and 297 of the near-edge batch lie
    within an f32 ulp of a cell boundary: f32 cells put them one column
    off, and without margins no recheck would correct them."""
    rsys, psys, ref, port, batches = custom_star
    assert not TJ.has_cell_margins(psys) and TJ.has_cell_margins(H3)
    pts = batches[batch]
    want = TJ.host_join(pts, port.host, psys, 3)
    got = TJ.pip_join(pts, None, psys, 3, chip_index=port, recheck=True,
                      probe=probe, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(RJ.pip_join(
        pts, None, rsys, 3, chip_index=ref, recheck=True, probe=probe)))
    if batch == "near_edge":
        np.testing.assert_array_equal(got[[233, 277, 297]], [1, 1, 1])
        f32 = TJ.pip_join(pts, None, psys, 3, chip_index=port, recheck=True,
                          probe=probe, cell_dtype=torch.float32, device="cpu")
        assert (f32[[233, 277, 297]] == -1).all()  # the fault the default avoids
