"""The port's geometry codecs (`core/geometry/{wkt,wkb,geojson,collection,
affine}.py`) against the reference's, on the CPU.

Both packages' codecs are host numpy, so every comparison is exact: the
WKT strings, WKB bytes, hex strings and GeoJSON text are equal, and each
package reads the other's output into the same columns (xy, z, offsets,
types, SRIDs), over `tests/fixtures.py`'s `ALL_WKT`, the
GeometryCollection fixture of `tests/test_function_matrix.py`, Z inputs,
EMPTY inputs and a seeded random column. `PackedGeometry.to_padded`,
which the port computes for the whole column at once, is held to the
reference's per-ring loop bit for bit.
"""

import json

import numpy as np
import pytest

from fixtures import ALL_WKT
from mosaic_tpu.core.geometry import affine as RA
from mosaic_tpu.core.geometry import geojson as RG
from mosaic_tpu.core.geometry import wkb as RB
from mosaic_tpu.core.geometry import wkt as RW
from mosaic_tpu_torch import convert
from mosaic_tpu_torch.core.geometry import affine as TA
from mosaic_tpu_torch.core.geometry import geojson as TG
from mosaic_tpu_torch.core.geometry import wkb as TB
from mosaic_tpu_torch.core.geometry import wkt as TW
from mosaic_tpu_torch.core.types import GeometryType, PackedGeometry

COLLECTION = [
    "GEOMETRYCOLLECTION (POINT (-73.98 40.73), "
    "POLYGON ((-74.02 40.70, -73.96 40.70, -73.96 40.76, -74.02 40.76, "
    "-74.02 40.70)), LINESTRING (-74.0 40.7, -73.9 40.8))",
    "GEOMETRYCOLLECTION (LINESTRING (0 0, 1 1), MULTIPOLYGON (((0 0, 1 0, 1 1, 0 0))))",
    "GEOMETRYCOLLECTION (POINT (1 1))",
]
Z = [
    "POINT Z (1 2 3)",
    "LINESTRING Z (0 0 1, 2 0 5, 3 1 0)",
    "POLYGON Z ((0 0 1, 4 0 2, 4 4 3, 0 4 4, 0 0 1))",
    "MULTIPOINT Z ((1 1 1), (2 2 0))",
]
EMPTY = [
    "POINT EMPTY", "LINESTRING EMPTY", "POLYGON EMPTY", "MULTIPOINT EMPTY",
    "MULTILINESTRING EMPTY", "MULTIPOLYGON EMPTY", "GEOMETRYCOLLECTION EMPTY",
]
CASES = {"all_wkt": ALL_WKT, "collection": COLLECTION, "z": Z, "empty": EMPTY,
         "mixed": ALL_WKT[:3] + EMPTY[:3] + Z[:2] + COLLECTION[:1]}

FIELDS = ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid")


def same_column(a, b):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f  # bit for bit
    assert (a.z is None) == (b.z is None)
    if a.z is not None:
        assert np.asarray(a.z).tobytes() == np.asarray(b.z).tobytes()
        assert np.array_equal(a.geom_has_z, b.geom_has_z)


def random_column(seed=3, n=40):
    """Polygons with holes, lines and points from a seed, awkward f64
    coordinates included (the WKT writer prints repr)."""
    rng = np.random.default_rng(seed)
    wkts = []
    for i in range(n):
        x0, y0 = float(rng.uniform(-180, 180)), float(rng.uniform(-80, 80))
        k = i % 3
        if k == 0:
            ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
            r = rng.uniform(0.5, 1.0, 7)
            shell = [(float(x0 + ri * np.cos(a)), float(y0 + ri * np.sin(a)))
                     for a, ri in zip(ang, r)]
            hole = [(float(x0 + 0.1 * np.cos(a)), float(y0 + 0.1 * np.sin(a)))
                    for a in ang[::-1][:4]]
            ring = ", ".join(f"{x!r} {y!r}" for x, y in shell + shell[:1])
            h = ", ".join(f"{x!r} {y!r}" for x, y in hole + hole[:1])
            wkts.append(f"POLYGON (({ring}), ({h}))")
        elif k == 1:
            pts = (rng.uniform(-1, 1, (5, 2)) + (x0, y0)).tolist()
            wkts.append("LINESTRING (" + ", ".join(f"{x!r} {y!r}" for x, y in pts) + ")")
        else:
            wkts.append(f"POINT ({x0!r} {y0!r})")
    return wkts


@pytest.mark.parametrize("case", sorted(CASES) + ["random"])
def test_wkt_round_trip_equals_reference(case):
    wkts = random_column() if case == "random" else CASES[case]
    ref, port = RW.from_wkt(wkts), TW.from_wkt(wkts)
    same_column(port, ref)
    assert TW.to_wkt(port) == RW.to_wkt(ref)
    # each package reads the other's output
    same_column(TW.from_wkt(RW.to_wkt(ref)), RW.from_wkt(TW.to_wkt(port)))
    if case == "random":  # repr printing: the round trip is exact
        same_column(TW.from_wkt(TW.to_wkt(port)), port)


def outcome(fn, *args, **kw):
    """``fn(*args, **kw)``, or the type and text of what it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # lint: broad-except-ok (the outcome is compared)
        return (type(e).__name__, str(e))


def test_wkb_of_empty_geometries_behaves_as_reference():
    """Geometry by geometry: the same bytes, or the same error (the
    reference's WKB writer has no EMPTY form for some types)."""
    for w in EMPTY:
        ref, port = RW.from_wkt([w]), TW.from_wkt([w])
        got, want = outcome(TB.to_wkb, port), outcome(RB.to_wkb, ref)
        assert got == want, w
        if isinstance(want, list):
            same_column(TB.from_wkb(want), RB.from_wkb(got))


@pytest.mark.parametrize("case", sorted(set(CASES) - {"empty", "mixed"}) + ["random"])
def test_wkb_and_hex_equal_reference(case):
    wkts = random_column() if case == "random" else CASES[case]
    ref, port = RW.from_wkt(wkts), TW.from_wkt(wkts)
    blobs, rblobs = TB.to_wkb(port), RB.to_wkb(ref)
    assert blobs == rblobs
    assert TB.to_hex(port) == RB.to_hex(ref)
    same_column(TB.from_wkb(rblobs), RB.from_wkb(blobs))
    same_column(TB.from_hex(RB.to_hex(ref)), RB.from_hex(TB.to_hex(port)))
    same_column(TB.from_wkb(blobs), RB.from_wkb(rblobs))


def test_wkb_reads_big_endian_and_ewkb_srid_as_reference():
    # big-endian POINT (1 2), and an EWKB POINT with SRID 3857
    be = bytes.fromhex("00000000013ff00000000000004000000000000000")
    ewkb = bytes.fromhex("0101000020110f0000000000000000f03f0000000000000040")
    for blob in (be, ewkb):
        same_column(TB.from_wkb([blob]), RB.from_wkb([blob]))


@pytest.mark.parametrize("case", sorted(CASES) + ["random"])
def test_geojson_equals_reference(case):
    wkts = random_column() if case == "random" else CASES[case]
    ref, port = RW.from_wkt(wkts), TW.from_wkt(wkts)
    docs, rdocs = TG.to_geojson(port), RG.to_geojson(ref)
    assert docs == rdocs
    assert TG.to_geojson_obj(port) == RG.to_geojson_obj(ref)
    same_column(TG.from_geojson(rdocs), RG.from_geojson(docs))
    same_column(TG.from_geojson([json.loads(d) for d in rdocs]),
                RG.from_geojson([json.loads(d) for d in docs]))


def test_geojson_crs_member_and_feature_collection_equal_reference(tmp_path):
    fc = {
        "type": "FeatureCollection",
        "features": [
            {"type": "Feature", "properties": {"id": 1, "name": "a"},
             "geometry": {"type": "Polygon",
                          "coordinates": [[[0, 0], [4, 0], [4, 4], [0, 0]]]}},
            {"type": "Feature", "properties": {"id": 2},
             "geometry": {"type": "Point", "coordinates": [1.5, 2.5]}},
            {"type": "Feature", "properties": {"id": 3}, "geometry": None},
        ],
    }
    got, props = TG.read_feature_collection(fc)
    want, rprops = RG.read_feature_collection(fc)
    same_column(got, want)
    assert props == rprops
    path = tmp_path / "fc.geojson"
    path.write_text(json.dumps(fc))
    same_column(TG.read_feature_collection(str(path))[0], want)
    doc = {"type": "Point", "coordinates": [500000.0, 4649776.0],
           "crs": {"type": "name", "properties": {"name": "EPSG:32618"}}}
    same_column(TG.from_geojson([doc]), RG.from_geojson([doc]))
    assert int(TG.from_geojson([doc]).srid[0]) == 32618


def test_collection_keeps_the_first_polygonal_member():
    col = TW.from_wkt(COLLECTION)
    assert [col.geometry_type(g) for g in range(len(col))] == [
        GeometryType.POLYGON, GeometryType.MULTIPOLYGON, GeometryType.POLYGON]
    assert col.vertices_per_geom()[2] == 0  # no polygonal member: EMPTY


def test_affine_and_transform_srid_equal_reference():
    """The affine transforms and a reprojection to another SRID (host
    numpy CRS arithmetic in both packages) equal the reference bit for
    bit, mixed-SRID columns included."""
    wkts = random_column(seed=5)
    ref, port = RW.from_wkt(wkts), TW.from_wkt(wkts)
    same_column(TA.translate(port, 1.5, -2.25), RA.translate(ref, 1.5, -2.25))
    same_column(TA.scale(port, 2.0, 0.5), RA.scale(ref, 2.0, 0.5))
    same_column(TA.rotate(port, 0.3), RA.rotate(ref, 0.3))
    same_column(TA.set_srid(port, 3857), RA.set_srid(ref, 3857))
    same_column(TA.transform_srid(port, 4326), RA.transform_srid(ref, 4326))
    merc = TA.transform_srid(port, 3857)
    same_column(merc, RA.transform_srid(ref, 3857))
    assert not np.array_equal(merc.xy, port.xy)
    mixed_t, mixed_r = TA.set_srid(port, 4326), RA.set_srid(ref, 4326)
    mixed_t.srid[::2] = 3857
    mixed_r.srid[::2] = 3857
    same_column(TA.transform_srid(mixed_t, 27700), RA.transform_srid(mixed_r, 27700))


def test_types_completions_equal_reference():
    from mosaic_tpu.core import types as RT
    from mosaic_tpu_torch.core import types as TT

    for name in ("POINT", "linestring", " MultiPolygon ", "GEOMETRYCOLLECTION"):
        assert int(TT.GeometryType.from_name(name)) == int(RT.GeometryType.from_name(name))
        assert TT.GeometryType.from_name(name).wkt_name == RT.GeometryType.from_name(name).wkt_name
    wkts = ALL_WKT + Z
    ref, port = RW.from_wkt(wkts), TW.from_wkt(wkts)
    assert port.num_geometries == ref.num_geometries
    assert port.num_parts == ref.num_parts
    for f in ("rings_per_geom", "vertices_per_geom"):
        assert np.array_equal(getattr(port, f)(), getattr(ref, f)())
    assert port.to_padded().max_rings == ref.to_padded().max_rings
    xy = np.random.default_rng(1).uniform(-10, 10, (9, 2))
    same_column(PackedGeometry.from_points(xy, srid=27700),
                RT.PackedGeometry.from_points(xy, srid=27700))
    ring = np.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
    z = np.asarray([1.0, 2.0, 3.0])
    for fn in ("close_ring", "open_ring"):
        a, az = getattr(TT, fn)(ring if fn == "close_ring" else TT.close_ring(ring, z)[0], z
                                if fn == "close_ring" else TT.close_ring(ring, z)[1])
        b, bz = getattr(RT, fn)(ring if fn == "close_ring" else RT.close_ring(ring, z)[0], z
                                if fn == "close_ring" else RT.close_ring(ring, z)[1])
        assert np.array_equal(a, b) and np.array_equal(az, bz)


def test_zones_round_trip_bit_for_bit():
    """The smoke's zone shape at a small size: every codec returns the
    column it was given, bit for bit."""
    from mosaic_tpu.datasets import synthetic_zones as ref_zones

    col = convert.geometry_from_reference(ref_zones(3, 3, verts=64))
    same_column(TW.from_wkt(TW.to_wkt(col)), col)
    same_column(TB.from_wkb(TB.to_wkb(col)), col)
    same_column(TB.from_hex(TB.to_hex(col)), col)
    same_column(TG.from_geojson(TG.to_geojson(col)), col)


@pytest.mark.parametrize("case", sorted(CASES) + ["random", "degenerate"])
@pytest.mark.parametrize("kw", [{}, {"dtype": np.float64}, {"close_rings": False},
                                {"max_rings": 1}, {"max_verts": 4}])
def test_to_padded_equals_reference_loop(case, kw):
    """The port's array-at-once `to_padded` against the reference's
    per-ring loop: the same padded arrays bit for bit (ring orientation
    included), or the same error."""
    wkts = {"random": random_column(n=60),
            "degenerate": ["POLYGON ((0 0, 2 0, 4 0, 0 0))",
                           "POLYGON ((0 0, 1e-300 0, 0 1e-300, 0 0))",
                           "POLYGON ((0 0, 0 4, 4 4, 4 0, 0 0), (1 1, 2 1, 2 2, 1 1))",
                           "MULTIPOLYGON (((0 0, 0 1, 1 1, 0 0)), ((5 5, 6 5, 6 6, 5 5),"
                           " (5.1 5.1, 5.2 5.1, 5.2 5.2, 5.1 5.1)))"]}.get(case)
    wkts = wkts if wkts is not None else CASES[case]
    got, want = outcome(TW.from_wkt(wkts).to_padded, **kw), outcome(
        RW.from_wkt(wkts).to_padded, **kw)
    if isinstance(want, tuple):
        assert got == want
        return
    for f in ("verts", "ring_len", "ring_is_hole", "n_rings", "geom_type", "srid"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert got.rings_closed == want.rings_closed
