"""The port's function surface (`mosaic_tpu_torch/functions`, `context.py`)
against the reference's, on the CPU.

Every spec of the reference's `tests/test_function_matrix.py` (`_geom_specs`,
`_grid_specs` on H3, BNG and CUSTOM, `_format_specs`, `_raster_specs`,
`_agg_specs`) runs here on both packages over the same numpy inputs, and
the results are compared directly, not through goldens:
- integers, booleans, strings, bytes and every host path (codecs, the
  host C++ engines, the oracle, grid cells and chips, the raster
  metadata) exactly;
- float results that pass through a device measure or pair program
  (``DEVICE_TOL`` names) to ``rtol=1e-9, atol=1e-12``, the reference's f64
  band (`tests/test_measures.py:26-27`): torch's sums do not add in
  XLA's order;
- ``rst_rastertogrid*`` exactly: the fold's sums are sequential in pixel
  order in both packages, on integer-valued pixels.
The port's device paths run with ``device="cpu"``. The CRS-bound names
(reprojection to another SRID, the validity envelopes) equal the
reference's bit for bit: both run the same numpy CRS arithmetic on the
host.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mosaic_tpu
from mosaic_tpu import expr as RE
from mosaic_tpu import functions as RF
from mosaic_tpu.core.geometry import wkt as RW
from mosaic_tpu.core.index import BNG as RBNG
from mosaic_tpu.core.index import H3 as RH3
from mosaic_tpu.core.index import CustomIndexSystem as RCustom
from mosaic_tpu.core.index import GridConf as RConf
from mosaic_tpu.raster import Raster as RRaster
from mosaic_tpu_torch import context as TC
from mosaic_tpu_torch import convert
from mosaic_tpu_torch import expr as TE
from mosaic_tpu_torch import functions as TF
from mosaic_tpu_torch.core.geometry import wkt as TW
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.bng import BNGIndexSystem
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.raster import Raster as TRaster

CPU = "cpu"
#: specs whose floats pass a device reduction (torch's order, not XLA's)
DEVICE_TOL = {
    "st_area", "st_length", "st_perimeter", "st_centroid", "st_centroid2D",
    "st_centroid2d", "st_centroid3D", "st_centroid3d", "st_xmin", "st_xmax",
    "st_ymin", "st_ymax", "st_buffer", "st_bufferloop", "st_convexhull",
    "st_intersection", "st_union", "st_difference", "st_symdifference",
    "st_unaryunion", "st_rotate", "st_scale", "st_translate", "st_distance",
    "st_makepolygon", "st_polygon", "st_union_agg", "try_sql",
    "try_sql_columnar", "st_intersection_aggregate", "st_transform",
    "st_updatesrid",
}
RTOL, ATOL = 1e-9, 1e-12
#: the names that reach the CRS modules
CRS_BOUND = ("st_transform", "st_updatesrid", "st_hasvalidcoordinates")

#: the side of the BNG plane the shapes are scaled into: the reference's
#: matrix uses 400 km, a tenth keeps its res-3 (1 km) tessellations small
BNG_SIDE = 40_000.0

SHAPES = [
    "POLYGON ((-74.02 40.70, -73.96 40.70, -73.96 40.76, -74.02 40.76, -74.02 40.70))",
    "POLYGON ((-73.96 40.70, -73.90 40.70, -73.90 40.76, -73.96 40.76, -73.96 40.70))",
    "POLYGON ((-73.99 40.72, -73.95 40.71, -73.93 40.75, -73.97 40.77, -73.99 40.72), "
    "(-73.975 40.73, -73.96 40.73, -73.96 40.745, -73.975 40.73))",
    "MULTIPOLYGON (((-73.92 40.78, -73.91 40.78, -73.91 40.79, -73.92 40.78)), "
    "((-73.89 40.70, -73.88 40.70, -73.88 40.72, -73.89 40.72, -73.89 40.70)))",
]


class Pkg:
    """One package's namespace, as the reference's spec lambdas read it."""

    def __init__(self, F, W, E, Raster, grids, dev):
        self.F, self.W, self.E, self.Raster, self.grids = F, W, E, Raster, grids
        self.dev = dev  # {"device": "cpu"} for the port, {} for the reference

    def env(self):
        """The reference's `env` fixture (its fallback shapes, plus a holed
        polygon and a multipolygon), built from the same numbers, the BNG
        plane 40 km a side."""
        F, W = self.F, self.W
        nyc = W.from_wkt(SHAPES)
        rng = np.random.default_rng(7)
        b = nyc.bounds()
        bbox = (float(np.nanmin(b[:, 0])), float(np.nanmin(b[:, 1])),
                float(np.nanmax(b[:, 2])), float(np.nanmax(b[:, 3])))
        pts = np.column_stack(
            [rng.uniform(bbox[0], bbox[2], 200), rng.uniform(bbox[1], bbox[3], 200)]
        )
        t = F.st_translate(nyc, -bbox[0], -bbox[1])
        bng_geom = F.st_scale(t, BNG_SIDE / (bbox[2] - bbox[0]), BNG_SIDE / (bbox[3] - bbox[1]))
        bng_pts = np.column_stack([
            (pts[:, 0] - bbox[0]) * BNG_SIDE / (bbox[2] - bbox[0]),
            (pts[:, 1] - bbox[1]) * BNG_SIDE / (bbox[3] - bbox[1]),
        ])
        data = np.arange(2 * 10 * 12, dtype=np.float32).reshape(2, 10, 12)
        data[:, :2, :2] = -9.0
        return {
            "H3": dict(geom=nyc, pts=pts), "CUSTOM": dict(geom=nyc, pts=pts),
            "BNG": dict(geom=bng_geom, pts=bng_pts),
            "raster": self.Raster(data=data, gt=(bbox[0], 0.01, 0.0, bbox[3], 0.0, -0.01),
                                  srid=4326, nodata=-9.0),
        }


def _ref_pkg():
    custom = RCustom(RConf(-180, 180, -90, 90, 2, 360, 180))
    return Pkg(RF, RW, RE, RRaster,
               {"H3": (RH3, 8), "BNG": (RBNG, 3), "CUSTOM": (custom, 3)}, {})


def _port_pkg():
    custom = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 360, 180))
    return Pkg(TF, TW, TE, TRaster,
               {"H3": (H3IndexSystem(), 8), "BNG": (BNGIndexSystem(), 3),
                "CUSTOM": (custom, 3)}, {"device": CPU})


def geom_specs(P, e):
    F, W, d = P.F, P.W, P.dev
    g = e["H3"]["geom"]
    g2 = F.st_translate(g, 0.01, 0.01)
    pts = e["H3"]["pts"]
    pt_col = F.st_point(pts[:8, 0], pts[:8, 1])
    return {
        "st_area": lambda: F.st_area(g, **d),
        "st_length": lambda: F.st_length(g, **d),
        "st_perimeter": lambda: F.st_perimeter(g, **d),
        "st_centroid": lambda: F.st_centroid(g, **d),
        "st_centroid2D": lambda: F.st_centroid2D(g, **d),
        "st_centroid2d": lambda: F.st_centroid2d(g, **d),
        "st_centroid3D": lambda: F.st_centroid3D(
            W.from_wkt(["POINT Z (1 2 3)", "LINESTRING Z (0 0 1, 2 0 5)"]), **d),
        "st_centroid3d": lambda: F.st_centroid3d(g, **d),
        "st_envelope": lambda: F.st_envelope(g),
        "st_buffer": lambda: F.st_area(F.st_buffer(g.slice(0, 2), 0.005), **d),
        "st_bufferloop": lambda: F.st_area(
            F.st_bufferloop(g.slice(0, 2), 0.002, 0.005), **d),
        "st_convexhull": lambda: F.st_area(F.st_convexhull(g), **d),
        "st_simplify": lambda: F.st_numpoints(F.st_simplify(g, 0.001)),
        "st_intersection": lambda: F.st_area(F.st_intersection(g, g2), **d),
        "st_union": lambda: F.st_area(F.st_union(g.slice(0, 2), g2.slice(0, 2)), **d),
        "st_difference": lambda: F.st_area(F.st_difference(g, g2), **d),
        "st_symdifference": lambda: F.st_area(
            F.st_symdifference(g.slice(0, 2), g2.slice(0, 2)), **d),
        "st_unaryunion": lambda: F.st_area(F.st_unaryunion(g), **d),
        "st_dump": lambda: F.st_dump(g),
        "flatten_polygons": lambda: F.flatten_polygons(g),
        "st_contains": lambda: F.st_contains(g, F.st_centroid(g, **d), **d),
        "st_intersects": lambda: F.st_intersects(g, g2, **d),
        "st_distance": lambda: F.st_distance(g.slice(0, 2), g2.slice(0, 2), **d),
        "st_geometrytype": lambda: F.st_geometrytype(g),
        "st_isvalid": lambda: F.st_isvalid(g),
        "st_numpoints": lambda: F.st_numpoints(g),
        "st_x": lambda: F.st_x(pt_col),
        "st_y": lambda: F.st_y(pt_col),
        "st_xmin": lambda: F.st_xmin(g, **d),
        "st_xmax": lambda: F.st_xmax(g, **d),
        "st_ymin": lambda: F.st_ymin(g, **d),
        "st_ymax": lambda: F.st_ymax(g, **d),
        "st_zmin": lambda: F.st_zmin(W.from_wkt(["POINT Z (1 2 3)"])),
        "st_zmax": lambda: F.st_zmax(W.from_wkt(["POINT Z (1 2 3)"])),
        "st_rotate": lambda: F.st_centroid(F.st_rotate(g, 0.5), **d),
        "st_scale": lambda: F.st_area(F.st_scale(g, 2.0, 3.0), **d),
        "st_translate": lambda: F.st_centroid(F.st_translate(g, 1.0, 2.0), **d),
        "st_srid": lambda: F.st_srid(g),
        "st_setsrid": lambda: F.st_srid(F.st_setsrid(g, 3857)),
        # the CRS-bound names on equal SRIDs (other SRIDs: CRS_BOUND below)
        "st_transform": lambda: F.st_centroid(
            F.st_transform(F.st_setsrid(g, 4326), 4326), **d),
        "st_updatesrid": lambda: F.st_centroid(F.st_updatesrid(g, 3857, 3857), **d),
        "st_hasvalidcoordinates": lambda: F.st_hasvalidcoordinates(
            g, "EPSG:4326"),
    }


def format_specs(P, e):
    F, W, d = P.F, P.W, P.dev
    g = e["H3"]["geom"].slice(0, 3)
    simple = W.from_wkt(
        ["POLYGON ((1 1, 4 1, 4 4, 1 4, 1 1))", "POINT (2 3)", "LINESTRING (0 0, 2 2)"]
    )
    pts = e["H3"]["pts"]
    return {
        "convert_to": lambda: F.convert_to(simple, "wkt"),
        "convert_to_wkt": lambda: F.convert_to_wkt(simple),
        "convert_to_wkb": lambda: F.convert_to_wkb(simple),
        "convert_to_hex": lambda: F.convert_to_hex(simple),
        "convert_to_geojson": lambda: F.convert_to_geojson(simple),
        "convert_to_coords": lambda: F.convert_to_coords(simple),
        "as_hex": lambda: F.as_hex(simple),
        "as_json": lambda: F.as_json(simple),
        "st_astext": lambda: F.st_astext(simple),
        "st_aswkt": lambda: F.st_aswkt(simple),
        "st_asbinary": lambda: F.st_asbinary(simple),
        "st_aswkb": lambda: F.st_aswkb(simple),
        "st_asgeojson": lambda: F.st_asgeojson(simple),
        "st_geomfromwkt": lambda: F.st_geomfromwkt(F.st_aswkt(g)),
        "st_geomfromwkb": lambda: F.st_geomfromwkb(F.st_aswkb(g)),
        "st_geomfromgeojson": lambda: F.st_geomfromgeojson(F.st_asgeojson(g)),
        "st_point": lambda: F.st_point(pts[:5, 0], pts[:5, 1]),
        "st_makeline": lambda: F.st_makeline([pts[:4], pts[4:9]]),
        "st_makepolygon": lambda: F.st_area(F.st_makepolygon(
            W.from_wkt(["LINESTRING (0 0, 4 0, 4 4, 0 4, 0 0)"])), **d),
        "st_polygon": lambda: F.st_area(F.st_polygon(
            W.from_wkt(["LINESTRING (0 0, 4 0, 4 4, 0 4, 0 0)"])), **d),
        "st_union_agg": lambda: F.st_area(
            F.st_union_agg(simple.slice(0, 1), groups=np.asarray([0])), **d),
        "try_sql": lambda: F.try_sql(
            lambda w: float(F.st_area(W.from_wkt([w]), **d)[0]), F.st_aswkt(simple)),
        "try_sql_columnar": lambda: F.try_sql_columnar(
            lambda ws: [float(a) for a in F.st_area(W.from_wkt(list(ws)), **d)],
            F.st_aswkt(simple)),
    }


def grid_specs(P, e, grid_name):
    F, d = P.F, P.dev
    idx, res = P.grids[grid_name]
    g = e[grid_name]["geom"]
    pts = e[grid_name]["pts"]
    cells = F.grid_pointascellid(F.st_point(pts[:, 0], pts[:, 1]), res, index=idx)
    c8 = np.asarray(cells)[:8]
    return {
        "grid_longlatascellid": lambda: F.grid_longlatascellid(
            pts[:, 0], pts[:, 1], res, index=idx, **d),
        "grid_pointascellid": lambda: cells,
        "grid_polyfill": lambda: F.grid_polyfill(g, res, index=idx),
        "grid_tessellate": lambda: F.grid_tessellate(g, res, index=idx),
        "grid_tessellateexplode": lambda: F.grid_tessellateexplode(g, res, index=idx),
        "grid_boundary": lambda: F.grid_boundary(c8[:2], index=idx),
        "grid_boundaryaswkb": lambda: F.grid_boundaryaswkb(c8[:2], index=idx),
        "polyfill": lambda: F.polyfill(g, res, index=idx),
        "mosaicfill": lambda: F.mosaicfill(g, res, index=idx),
        "mosaic_explode": lambda: F.mosaic_explode(g, res, index=idx),
        "grid_tessellateaslong": lambda: F.grid_tessellateaslong(g, res, index=idx),
        "point_index_geom": lambda: F.point_index_geom(
            F.st_point(pts[:, 0], pts[:, 1]), res, index=idx),
        "point_index_lonlat": lambda: F.point_index_lonlat(
            pts[:, 0], pts[:, 1], res, index=idx, **d),
        "index_geometry": lambda: F.index_geometry(c8[:2], index=idx),
        "grid_cellkring": lambda: F.grid_cellkring(c8, 2, index=idx),
        "grid_cellkloop": lambda: F.grid_cellkloop(c8, 2, index=idx),
        "grid_cellkringexplode": lambda: F.grid_cellkringexplode(c8[:3], 1, index=idx),
        "grid_cellkloopexplode": lambda: F.grid_cellkloopexplode(c8[:3], 1, index=idx),
        "grid_geometrykring": lambda: F.grid_geometrykring(g.slice(0, 2), res, 1, index=idx),
        "grid_geometrykloop": lambda: F.grid_geometrykloop(g.slice(0, 2), res, 1, index=idx),
        "grid_geometrykringexplode": lambda: F.grid_geometrykringexplode(
            g.slice(0, 2), res, 1, index=idx),
        "grid_geometrykloopexplode": lambda: F.grid_geometrykloopexplode(
            g.slice(0, 2), res, 1, index=idx),
        "grid_distance": lambda: F.grid_distance(c8, c8[::-1].copy(), index=idx),
        "grid_cell_center": lambda: F.grid_cell_center(c8, index=idx),
        "grid_format_cellid": lambda: F.grid_format_cellid(c8[:4], index=idx),
        "grid_parse_cellid": lambda: F.grid_parse_cellid(
            F.grid_format_cellid(c8[:4], index=idx), index=idx),
        "grid_resolution": lambda: F.grid_resolution(c8, index=idx),
        "grid_is_valid_cellid": lambda: F.grid_is_valid_cellid(c8, index=idx),
    }


def raster_specs(P, e):
    F, E, d = P.F, P.E, P.dev
    r = e["raster"]
    col = [r]
    x, y = float(r.gt[0]) + 0.03, float(r.gt[3]) - 0.03
    return {
        "rst_metadata": lambda: F.rst_metadata(col),
        "rst_bandmetadata": lambda: F.rst_bandmetadata(col, 1),
        "rst_georeference": lambda: F.rst_georeference(col),
        "rst_height": lambda: F.rst_height(col),
        "rst_width": lambda: F.rst_width(col),
        "rst_numbands": lambda: F.rst_numbands(col),
        "rst_srid": lambda: F.rst_srid(col),
        "rst_memsize": lambda: F.rst_memsize(col),
        "rst_isempty": lambda: F.rst_isempty(col),
        "rst_subdatasets": lambda: F.rst_subdatasets(col),
        "rst_summary": lambda: F.rst_summary(col),
        "rst_scalex": lambda: F.rst_scalex(col),
        "rst_scaley": lambda: F.rst_scaley(col),
        "rst_skewx": lambda: F.rst_skewx(col),
        "rst_skewy": lambda: F.rst_skewy(col),
        "rst_upperleftx": lambda: F.rst_upperleftx(col),
        "rst_upperlefty": lambda: F.rst_upperlefty(col),
        "rst_pixelwidth": lambda: F.rst_pixelwidth(col),
        "rst_pixelheight": lambda: F.rst_pixelheight(col),
        "rst_mapbands": lambda: F.rst_mapbands(
            col, E.band(1).mask_where(E.band(2) > 0.0), **d),
        "rst_ndvi": lambda: F.rst_ndvi(col, **d),
        "rst_rotation": lambda: F.rst_rotation(col),
        "rst_rastertoworldcoord": lambda: F.rst_rastertoworldcoord(col, 2, 3),
        "rst_rastertoworldcoordx": lambda: F.rst_rastertoworldcoordx(col, 2, 3),
        "rst_rastertoworldcoordy": lambda: F.rst_rastertoworldcoordy(col, 2, 3),
        "rst_worldtorastercoord": lambda: F.rst_worldtorastercoord(col, x, y),
        "rst_worldtorastercoordx": lambda: F.rst_worldtorastercoordx(col, x, y),
        "rst_worldtorastercoordy": lambda: F.rst_worldtorastercoordy(col, x, y),
        "rst_retile": lambda: F.rst_retile(col, 6, 5),
        "rst_rastertogridavg": lambda: F.rst_rastertogridavg(col, 5, index=P.grids["H3"][0], **d),
        "rst_rastertogridmin": lambda: F.rst_rastertogridmin(col, 5, index=P.grids["H3"][0], **d),
        "rst_rastertogridmax": lambda: F.rst_rastertogridmax(col, 5, index=P.grids["H3"][0], **d),
        "rst_rastertogridmedian": lambda: F.rst_rastertogridmedian(
            col, 5, index=P.grids["H3"][0], **d),
        "rst_rastertogridcount": lambda: F.rst_rastertogridcount(
            col, 5, index=P.grids["H3"][0], **d),
    }


def agg_specs(P, e):
    F, d = P.F, P.dev
    idx, res = P.grids["CUSTOM"]
    g = e["H3"]["geom"].slice(0, 2)
    ta = F.grid_tessellate(g, res, index=idx)
    tb = F.grid_tessellate(F.st_translate(g, 0.005, 0.005), res, index=idx)
    common = np.intersect1d(ta.cell_id, tb.cell_id)[:4]
    ia = [int(np.nonzero(ta.cell_id == c)[0][0]) for c in common]
    ib = [int(np.nonzero(tb.cell_id == c)[0][0]) for c in common]
    a_chips, b_chips = ta.chips.take(ia), tb.chips.take(ib)
    a_core, b_core = ta.is_core[ia], tb.is_core[ib]
    groups = np.zeros(len(common), dtype=np.int64)
    return {
        "st_intersection_aggregate": lambda: F.st_area(F.st_intersection_aggregate(
            idx, common, a_core, b_core, a_chips, b_chips, groups=groups), **d),
        "st_intersects_aggregate": lambda: F.st_intersects_aggregate(
            common, a_core, b_core, a_chips, b_chips, groups=groups),
        "st_intersection_area": lambda: F.st_intersection_area(
            g, F.st_translate(g, 0.005, 0.005), idx, res, **d),
        "st_overlap_fraction": lambda: F.st_overlap_fraction(
            g, F.st_translate(g, 0.005, 0.005), idx, res, **d),
    }


# ------------------------------------------------------------- comparison
def norm(x):
    """Either package's result as plain numpy / python values."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if hasattr(x, "ring_offsets") and hasattr(x, "geom_offsets"):  # PackedGeometry
        out = {f: np.asarray(getattr(x, f)) for f in (
            "xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid")}
        out["z"] = None if x.z is None else np.asarray(x.z)
        return out
    if hasattr(x, "gt") and hasattr(x, "data") and hasattr(x, "nodata"):  # Raster
        return {"data": np.asarray(x.data), "gt": tuple(x.gt), "srid": x.srid,
                "nodata": x.nodata}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: norm(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name not in ("lane", "timings")}
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, (str, bytes, bytearray, int, float, bool, type(None))):
        return x
    return np.asarray(x)


def assert_same(got, want, tol, path="result"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_same(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, tol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        if want.dtype.kind == "f" and tol:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=path)
        elif want.dtype.kind == "f":
            assert np.array_equal(got, want, equal_nan=True), (path, got, want)
        else:
            assert np.array_equal(got, want), (path, got, want)
    elif isinstance(want, float) and tol:
        assert got == pytest.approx(want, rel=RTOL, abs=ATOL, nan_ok=True), path
    elif isinstance(want, float) and want != want:
        assert got != got, path
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def pkgs():
    ref, port = _ref_pkg(), _port_pkg()
    return ref, ref.env(), port, port.env()


def _run_pair(pkgs, builder, name, *args):
    ref, renv, port, penv = pkgs
    want = builder(ref, renv, *args)[name]
    got = builder(port, penv, *args)[name]
    if want is None:
        return
    assert_same(norm(got()), norm(want()), name in DEVICE_TOL, name)


@pytest.mark.parametrize("name", sorted(geom_specs(_ref_pkg(), _ref_pkg().env())))
def test_geometry_specs_equal_reference(pkgs, name):
    _run_pair(pkgs, geom_specs, name)


@pytest.mark.parametrize("name", sorted(format_specs(_ref_pkg(), _ref_pkg().env())))
def test_format_specs_equal_reference(pkgs, name):
    _run_pair(pkgs, format_specs, name)


@pytest.mark.parametrize("grid", ["H3", "BNG", "CUSTOM"])
def test_grid_specs_equal_reference(pkgs, grid):
    ref, renv, port, penv = pkgs
    want = grid_specs(ref, renv, grid)
    got = grid_specs(port, penv, grid)
    assert set(got) == set(want)
    for name in sorted(want):
        assert_same(norm(got[name]()), norm(want[name]()), False, f"{grid}/{name}")


@pytest.mark.parametrize("name", sorted(raster_specs(_ref_pkg(), _ref_pkg().env())))
def test_raster_specs_equal_reference(pkgs, name):
    _run_pair(pkgs, raster_specs, name)


@pytest.mark.parametrize("name", ["st_intersection_aggregate", "st_intersects_aggregate",
                                  "st_intersection_area", "st_overlap_fraction"])
def test_aggregate_specs_equal_reference(pkgs, name):
    _run_pair(pkgs, agg_specs, name)


def test_register_has_exactly_the_reference_names(pkgs):
    ref, renv, port, penv = pkgs
    ctx = TC.MosaicContext.build("H3")
    try:
        names = list(ctx.register())
        assert names == list(mosaic_tpu.MosaicContext.build("H3").register())
        assert list(ctx.register("mos_")) == [f"mos_{n}" for n in names]
        assert sorted(vars(ctx.functions)) == sorted(names)
        specs = {**geom_specs(port, penv), **format_specs(port, penv),
                 **grid_specs(port, penv, "H3"), **raster_specs(port, penv),
                 **agg_specs(port, penv)}
        assert set(names) == set(specs)
        assert ctx.index_system.name == "H3"
    finally:
        TC.MosaicContext.reset()
        mosaic_tpu.MosaicContext.reset()


@pytest.mark.parametrize("name", CRS_BOUND)
def test_crs_bound_names_equal_reference(pkgs, name):
    """Each CRS-bound name, to another SRID, equals the reference's bit
    for bit (host numpy CRS arithmetic in both packages)."""
    ref, renv, port, penv = pkgs

    def calls(P, e):
        F, g = P.F, e["H3"]["geom"]
        return {
            "st_transform": lambda: F.st_transform(F.st_setsrid(g, 4326), 32618),
            "st_updatesrid": lambda: F.st_updatesrid(g, 4326, 3857),
            "st_hasvalidcoordinates": lambda: [
                F.st_hasvalidcoordinates(g, "EPSG:4326"),
                F.st_hasvalidcoordinates(
                    F.st_transform(F.st_setsrid(g, 4326), 32618), "EPSG:32618",
                    "reprojected_bounds"),
                F.st_hasvalidcoordinates(g, "EPSG:27700"),
            ],
        }[name]

    got, want = calls(port, penv)(), calls(ref, renv)()
    if name == "st_hasvalidcoordinates":
        assert_same(norm(got), norm(want), False, name)
        assert np.asarray(want[0]).all() and not np.asarray(want[2]).any()
        return
    assert np.array_equal(np.asarray(got.srid), np.asarray(want.srid))
    assert got.xy.tobytes() == want.xy.tobytes()
    assert not np.array_equal(got.xy, penv["H3"]["geom"].xy)


def test_raster_in_another_crs_and_raster_paths_equal_reference(pkgs, tmp_path):
    """A raster whose SRID is not the index's is reprojected on the host
    and folds as the reference's does; a raster path is read through the
    native GeoTIFF decoder in both packages."""
    ref, renv, port, penv = pkgs
    r = penv["raster"]
    # Web Mercator metres over NYC, so the pixels land on real cells
    gt = (-8238000.0, 150.0, 0.0, 4980000.0, 0.0, -150.0)
    other = TRaster(data=r.data, gt=gt, srid=3857, nodata=r.nodata)
    rother = RRaster(data=r.data, gt=gt, srid=3857, nodata=r.nodata)
    got = port.F.rst_rastertogridavg([other], 7, index=H3IndexSystem(), device=CPU)
    want = ref.F.rst_rastertogridavg([rother], 7, index=RH3)
    assert_same(norm(got), norm(want), False, "rst_rastertogridavg")
    assert got[0][0]
    path = str(tmp_path / "x.tif")
    from mosaic_tpu_torch.raster import write_geotiff

    write_geotiff(path, other)  # the port writes, both packages read
    assert port.F.rst_height(path) == ref.F.rst_height(path) == [r.height]
    assert port.F.rst_srid(path) == ref.F.rst_srid(path) == [3857]


def test_context_builds_each_index_system_and_validates():
    for spec, name in (("H3", "H3"), ("bng", "BNG"),
                       ("CUSTOM(-180,180,-90,90,2,360,180)", "CUSTOM")):
        ctx = TC.MosaicContext.build(spec)
        ref = mosaic_tpu.MosaicContext.build(spec)
        assert ctx.index_system.name.startswith(name)
        assert ctx.config.index_system == ref.config.index_system
        assert dataclasses.asdict(ctx.config) == dataclasses.asdict(ref.config)
    with pytest.raises(ValueError, match="unknown index system"):
        TC.index_system_factory("S2")
    with pytest.raises(ValueError, match="geometry_backend"):
        TC.MosaicConfig(geometry_backend="jts")
    with pytest.raises(ValueError, match="cell_id_type"):
        TC.MosaicConfig(cell_id_type="int")
    ctx = TC.MosaicContext.build("H3", geometry_backend="oracle", exact_recheck=True)
    assert TC.current_config().exact_recheck and TC.current_context() is ctx
    TC.MosaicContext.reset()
    mosaic_tpu.MosaicContext.reset()
    assert TC.current_config() == TC.MosaicConfig()


def test_backends_follow_the_context(pkgs):
    """With no ``backend=``, measures take the context's
    geometry_backend; ``device`` without a card raises."""
    _, _, port, penv = pkgs
    g = penv["H3"]["geom"]
    TC.MosaicContext.build("H3", geometry_backend="oracle")
    try:
        assert np.array_equal(port.F.st_area(g), port.F.st_area(g, backend="oracle"))
    finally:
        TC.MosaicContext.reset()


def test_converters_carry_reference_columns_and_rasters(pkgs):
    ref, renv, _, _ = pkgs
    col = RW.from_wkt(SHAPES + ["POINT Z (1 2 3)"])
    got = convert.geometry_from_reference(col)
    assert_same(norm(got), norm(col), False)
    r = convert.raster_from_reference(renv["raster"])
    assert isinstance(r, TRaster)
    assert_same(norm(r), norm(renv["raster"]), False)


def test_device_backend_raises_without_a_card(pkgs, monkeypatch):
    """Under ``geometry_backend="device"`` with no card the measures,
    pair programs, cells and folds raise: nothing falls back to the CPU
    or to the oracle."""
    from mosaic_tpu_torch import DeviceUnavailable

    _, _, port, penv = pkgs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    F, g = port.F, penv["H3"]["geom"]
    pts = penv["H3"]["pts"]
    TC.MosaicContext.build("H3", geometry_backend="device")
    try:
        for call in (lambda: F.st_area(g), lambda: F.st_centroid(g),
                     lambda: F.st_xmin(g), lambda: F.st_intersects(g, g),
                     lambda: F.grid_longlatascellid(pts[:, 0], pts[:, 1], 8),
                     lambda: F.rst_rastertogridavg([penv["raster"]], 5)):
            with pytest.raises(DeviceUnavailable):
                call()
        assert F.st_area(g, backend="oracle").shape == (len(g),)
    finally:
        TC.MosaicContext.reset()
