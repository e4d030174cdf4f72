"""The port's device measures and predicates (`core/geometry/measures.py`,
`predicates.py`), its host oracle (`oracle.py`) and its two native engines
(`hostops.py`, `second.py`) against the reference's, on the CPU.

- Device measures (float64, ``device="cpu"``) within ``rtol=1e-9,
  atol=1e-9`` of the reference's device measures and of the f64 oracle
  (the reference's own band, `tests/test_measures.py:26-27`): torch's
  sums over the vertex axis do not add in XLA's order. Vertex counts,
  booleans and NaN placement are exact.
- The oracle and the native engines are the same numpy expressions and
  the same `native/build/libmosaicgeom.so` in both packages: their f64
  outputs are equal bit for bit.
"""

import numpy as np
import pytest
import torch

import fixtures as fx
from mosaic_tpu.core.geometry import hostops as RH
from mosaic_tpu.core.geometry import measures as RM
from mosaic_tpu.core.geometry import oracle as RO
from mosaic_tpu.core.geometry import predicates as RP
from mosaic_tpu.core.geometry import second as RS
from mosaic_tpu.core.geometry import wkt as RW
from mosaic_tpu.core.geometry.device import pack_to_device as ref_pack
from mosaic_tpu_torch.core.geometry import hostops as TH
from mosaic_tpu_torch.core.geometry import measures as TM
from mosaic_tpu_torch.core.geometry import oracle as TO
from mosaic_tpu_torch.core.geometry import predicates as TP
from mosaic_tpu_torch.core.geometry import second as TS
from mosaic_tpu_torch.core.geometry import wkt as TW
from mosaic_tpu_torch.core.geometry.device import is_point_like, pack_to_device
from mosaic_tpu_torch.functions import geometry as TF

RTOL = ATOL = 1e-9
EXTRA = [
    "POLYGON ((0 0, 0 4, 4 4, 4 0, 0 0))",  # clockwise shell
    "POLYGON ((0 0, 2 0, 4 0, 0 0))",  # zero area: the vertex mean
    "POLYGON EMPTY",
    "LINESTRING EMPTY",
    "POLYGON ((-73.99 40.72, -73.95 40.71, -73.93 40.75, -73.97 40.77, -73.99 40.72), "
    "(-73.975 40.73, -73.96 40.73, -73.96 40.745, -73.975 40.73))",
]
WKTS = fx.ALL_WKT + EXTRA
POLYS = fx.POLY_WKT + fx.MULTIPOLY_WKT + EXTRA[:2] + EXTRA[4:]


def _random_polys(seed=4, n=24):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x0, y0 = rng.uniform(-20, 20, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
        r = rng.uniform(1.0, 3.0, 9)
        ring = [(x0 + a * np.cos(t), y0 + a * np.sin(t)) for t, a in zip(ang, r)]
        out.append("POLYGON ((" + ", ".join(f"{float(x)!r} {float(y)!r}"
                                            for x, y in ring + ring[:1]) + "))")
    return out


@pytest.fixture(scope="module")
def cols():
    wkts = WKTS + _random_polys()
    return RW.from_wkt(wkts), TW.from_wkt(wkts)


@pytest.fixture(scope="module")
def devs(cols):
    import jax.numpy as jnp

    ref, port = cols
    return (ref_pack(ref, dtype=jnp.float64, recenter=True),
            pack_to_device(port, dtype=torch.float64, recenter=True, device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("fn", ["signed_ring_areas", "area", "length", "centroid",
                                "bounds", "xmin", "ymin", "xmax", "ymax", "point_xy"])
def test_device_measures_within_band_of_reference(devs, fn):
    rd, td = devs
    got, want = _np(getattr(TM, fn)(td)), _np(getattr(RM, fn)(rd))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


def test_num_points_and_type_masks_equal_reference(devs):
    rd, td = devs
    assert np.array_equal(_np(TM.num_points(td)), _np(RM.num_points(rd)))
    from mosaic_tpu.core.geometry.device import is_point_like as ref_ipl

    assert np.array_equal(_np(is_point_like(td.geom_type)), _np(ref_ipl(rd.geom_type)))


@pytest.mark.parametrize("name", ["st_area", "st_length", "st_xmin", "st_xmax",
                                  "st_ymin", "st_ymax", "st_centroid3D"])
def test_device_backend_within_band_of_oracle_and_native_equals_reference(cols, name):
    """The function surface: device (CPU) within the f64 band of the
    oracle; the oracle and native backends equal the reference's bit for
    bit."""
    from mosaic_tpu.functions import geometry as RF

    ref, port = cols
    fn, rfn = getattr(TF, name), getattr(RF, name)
    dev = np.asarray(fn(port, backend="device", device="cpu"), dtype=np.float64)
    orc = np.asarray(fn(port, backend="oracle"), dtype=np.float64)
    want = np.asarray(rfn(ref, backend="device"), dtype=np.float64)
    np.testing.assert_allclose(dev, want, rtol=RTOL, atol=ATOL, equal_nan=True)
    # an EMPTY row's centroid is the vertex mean of nothing: NaN on the
    # oracle, the shift on the device, in both packages
    some = port.vertices_per_geom() > 0
    np.testing.assert_allclose(dev[some], orc[some], rtol=RTOL, atol=ATOL, equal_nan=True)
    for b in ("oracle", "native"):
        got = np.asarray(fn(port, backend=b), dtype=np.float64)
        want = np.asarray(rfn(ref, backend=b), dtype=np.float64)
        assert got.tobytes() == want.tobytes(), b


def test_oracle_equals_reference_bit_for_bit(cols):
    ref, port = cols
    for fn in ("area", "length", "centroid", "bounds"):
        assert _np(getattr(TO, fn)(port)).tobytes() == _np(getattr(RO, fn)(ref)).tobytes(), fn
    pts = np.random.default_rng(2).uniform(-5, 12, (40, 2))
    for g in range(len(fx.ALL_WKT)):
        assert np.array_equal(TO.contains_points(port, g, pts),
                              RO.contains_points(ref, g, pts))
        assert TO.point_in_polygon(port, g, pts[0]) == RO.point_in_polygon(ref, g, pts[0])


def test_native_engines_equal_reference_bit_for_bit(cols):
    ref, port = cols
    for fn in ("area", "length", "centroid", "bounds"):
        assert _np(getattr(TS, fn)(port)).tobytes() == _np(getattr(RS, fn)(ref)).tobytes(), fn
    polys = RW.from_wkt(POLYS), TW.from_wkt(POLYS)
    from mosaic_tpu.core.geometry import affine as RA
    from mosaic_tpu_torch.core.geometry import affine as TA

    rb, tb = RA.translate(polys[0], 0.7, 0.4), TA.translate(polys[1], 0.7, 0.4)
    for op in ("intersection", "union", "difference", "sym_difference"):
        for R, T in ((RH, TH), (RS, TS)):
            want, got = getattr(R, op)(polys[0], rb), getattr(T, op)(polys[1], tb)
            assert got.xy.tobytes() == want.xy.tobytes(), (T.__name__, op)
            assert np.array_equal(got.ring_offsets, want.ring_offsets)
            assert np.array_equal(got.geom_type, want.geom_type)
    for op, args in (("buffer", (0.3,)), ("convex_hull", ()), ("simplify", (0.5,)),
                     ("unary_union", ()), ("union_all", ())):
        want, got = getattr(RH, op)(polys[0], *args), getattr(TH, op)(polys[1], *args)
        assert got.xy.tobytes() == want.xy.tobytes(), op
        assert np.array_equal(got.geom_offsets, want.geom_offsets), op


def test_new_device_predicates_equal_reference():
    import jax.numpy as jnp

    wkts = fx.POLY_WKT + fx.MULTIPOLY_WKT + fx.LINE_WKT[:1]
    ref, port = RW.from_wkt(wkts), TW.from_wkt(wkts)
    rd = ref_pack(ref, dtype=jnp.float64)
    td = pack_to_device(port, dtype=torch.float64, device="cpu")
    pts = np.random.default_rng(9).uniform(-2, 11, (64, 2))
    rp, tp = jnp.asarray(pts), torch.from_numpy(pts)
    assert np.array_equal(_np(TP.contains_xy_bbox(tp, td)), _np(RP.contains_xy_bbox(rp, rd)))
    idx = np.arange(64) % len(wkts)
    assert np.array_equal(
        _np(TP.contains_xy_gather(tp, torch.from_numpy(idx), td)),
        _np(RP.contains_xy_gather(rp, jnp.asarray(idx), rd)))
    got, want = _np(TP.points_min_dist(tp, td)), _np(RP.points_min_dist(rp, rd))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got == 0, want == 0)
