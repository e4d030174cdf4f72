"""ST_ geometry functions — the DSL surface over the device compute core.

Port of ``mosaic_tpu/functions/geometry.py``. Numeric measures and
predicates run on the device (`core/geometry/measures.py`,
`core/geometry/predicates.py`, float64, on the card unless the caller
passes ``device="cpu"``), on the float64 host oracle, or on the
independent C++ second engine, selected by the ``backend`` argument or
the active context's ``geometry_backend``; boolean ops, buffers and hulls
run on the host C++ engine (`native/src/martinez.cpp`). There is no
fallback: a device call with no card raises
:class:`~mosaic_tpu_torch.DeviceUnavailable`.

The row-pair programs (:func:`_pair_pack`, :func:`_vmap_pair`,
:func:`_contains_dense`, :func:`_distance_dense`) are shared with KNN
and the overlay's sharded predicate. The reference maps its dense
functions over pairs with ``jax.vmap``; here the dense functions of
`core/geometry/predicates.py` take a leading pair axis, so
:func:`_vmap_pair` is one batch of eager torch ops, and the function
surface runs it on chunks of the pair axis (:func:`_pair_chunks`) so
that tens of thousands of pairs of many-vertex polygons fit in memory;
each pair's answer is its own, whatever the chunk.

Geometry-returning functions serialize results back into the input's
format (WKT in -> WKT out), matching `VectorExpression.serialise`.
Reprojection and ``st_hasvalidcoordinates`` go through the port's CRS
modules (``core/crs*.py``) on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import crs as _crs
from ..core.geometry import affine as _affine
from ..core.geometry import hostops as _host
from ..core.geometry import measures as _meas
from ..core.geometry import oracle as _oracle
from ..core.geometry import predicates as _pred
from ..core.geometry import second as _second
from ..core.geometry.device import DeviceGeometry, pack_to_device, take_rows
from ..core.types import GeometryBuilder, GeometryType, PackedGeometry
from ._coerce import coerce, like_input, to_packed

__all__ = [
    "st_area", "st_length", "st_perimeter", "st_centroid", "st_centroid2D",
    "st_centroid2d", "st_centroid3D", "st_centroid3d", "st_envelope",
    "st_buffer", "st_bufferloop", "st_convexhull", "st_simplify",
    "st_intersection", "st_intersection_area", "st_overlap_fraction",
    "st_union", "st_difference", "st_symdifference",
    "st_unaryunion", "st_dump", "flatten_polygons", "st_contains",
    "st_intersects", "st_distance", "st_geometrytype", "st_isvalid",
    "st_numpoints", "st_x", "st_y", "st_xmin", "st_xmax", "st_ymin",
    "st_ymax", "st_zmin", "st_zmax", "st_rotate", "st_scale", "st_translate",
    "st_srid", "st_setsrid", "st_transform", "st_updatesrid",
    "st_hasvalidcoordinates",
]

#: the device dtype of the measures and pair programs (the reference's
#: under ``jax_enable_x64``)
DEVICE_DTYPE = torch.float64
#: most elements one pair chunk's largest intermediate may hold
PAIR_CHUNK_ELEMENTS = 1 << 24


def _resolve_backend(backend: str | None) -> str:
    if backend is not None:
        return backend
    from ..context import current_config

    return current_config().geometry_backend


def _dev(col: PackedGeometry, device=None) -> DeviceGeometry:
    return pack_to_device(col, dtype=DEVICE_DTYPE, recenter=True, device=device)


def _host_f64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _shift(dg: DeviceGeometry) -> np.ndarray:
    return dg.shift.cpu().numpy().astype(np.float64)


# ----------------------------------------------------------------- measures


def st_area(geom, backend: str | None = None, device=None) -> np.ndarray:
    """Planar area per row (reference: ST_Area.scala:20-55)."""
    col = to_packed(geom)
    b = _resolve_backend(backend)
    if b == "oracle":
        return _oracle.area(col)
    if b == "native":
        return _second.area(col)
    return _host_f64(_meas.area(_dev(col, device)))


def st_length(geom, backend: str | None = None, device=None) -> np.ndarray:
    """Length / perimeter per row (reference: ST_Length == ST_Perimeter)."""
    col = to_packed(geom)
    b = _resolve_backend(backend)
    if b == "oracle":
        return _oracle.length(col)
    if b == "native":
        return _second.length(col)
    return _host_f64(_meas.length(_dev(col, device)))


st_perimeter = st_length


def _centroid_xy(col: PackedGeometry, backend: str | None, device=None) -> np.ndarray:
    """(N, 2) centroid coordinates — the one copy of the three-engine
    dispatch every centroid-flavoured function routes through."""
    b = _resolve_backend(backend)
    if b == "oracle":
        return _oracle.centroid(col)
    if b == "native":
        return _second.centroid(col)
    dg = _dev(col, device)
    return _host_f64(_meas.centroid(dg)) + _shift(dg)


def st_centroid(geom, backend: str | None = None, device=None):
    """Centroid as a POINT column, serialized like the input."""
    col, fmt = coerce(geom)
    cxy = _centroid_xy(col, backend, device)
    b = GeometryBuilder()
    for g in range(len(col)):
        b.add_geometry(GeometryType.POINT, [[cxy[g : g + 1]]], int(col.srid[g]))
    return like_input(b.build(), fmt)


# the reference registers st_centroid2D as an exact alias of st_centroid:
# geometry in, POINT geometry out
st_centroid2D = st_centroid
st_centroid2d = st_centroid


def st_centroid3D(geom, backend: str | None = None, device=None) -> np.ndarray:
    """(N, 3) centroid x/y/z: x/y the area-weighted centroid (as
    st_centroid), z the mean vertex z per row, NaN without Z."""
    col = to_packed(geom)
    xy = _centroid_xy(col, backend, device)
    z = np.full(len(col), np.nan)
    if col.z is not None:
        for g in range(len(col)):
            if col.has_z(g):
                zz = col.z[col.geom_vertex_slice(g)]
                if zz.size:
                    z[g] = float(zz.mean())
    return np.concatenate([xy, z[:, None]], axis=1)


def st_centroid3d(geom, backend: str | None = None, device=None) -> np.ndarray:
    return st_centroid3D(geom, backend, device)


def _bounds(col: PackedGeometry, backend: str | None, device=None) -> np.ndarray:
    b = _resolve_backend(backend)
    if b == "oracle":
        return col.bounds()
    if b == "native":
        return _second.bounds(col)
    dg = _dev(col, device)
    s = _shift(dg)
    return _host_f64(_meas.bounds(dg)) + np.concatenate([s, s])


def st_xmin(geom, backend: str | None = None, device=None) -> np.ndarray:
    return _bounds(to_packed(geom), backend, device)[:, 0]


def st_ymin(geom, backend: str | None = None, device=None) -> np.ndarray:
    return _bounds(to_packed(geom), backend, device)[:, 1]


def st_xmax(geom, backend: str | None = None, device=None) -> np.ndarray:
    return _bounds(to_packed(geom), backend, device)[:, 2]


def st_ymax(geom, backend: str | None = None, device=None) -> np.ndarray:
    return _bounds(to_packed(geom), backend, device)[:, 3]


def _z_minmax(col: PackedGeometry, want_max: bool) -> np.ndarray:
    out = np.full(len(col), np.nan)
    if col.z is None:
        return out
    for g in range(len(col)):
        if not col.has_z(g):
            continue
        sl = col.geom_vertex_slice(g)
        zz = col.z[sl]
        if zz.size:
            out[g] = zz.max() if want_max else zz.min()
    return out


def st_zmin(geom) -> np.ndarray:
    return _z_minmax(to_packed(geom), want_max=False)


def st_zmax(geom) -> np.ndarray:
    return _z_minmax(to_packed(geom), want_max=True)


def st_envelope(geom):
    """Bounding-box polygon per row (reference: ST_Envelope)."""
    col, fmt = coerce(geom)
    bb = col.bounds()
    b = GeometryBuilder()
    for g in range(len(col)):
        x0, y0, x1, y1 = bb[g]
        srid = int(col.srid[g])
        if np.isnan(x0):
            b.add_geometry(GeometryType.POLYGON, [[np.zeros((0, 2))]], srid)
        else:
            ring = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
            b.add_geometry(GeometryType.POLYGON, [[ring]], srid)
    return like_input(b.build(), fmt)


def st_numpoints(geom) -> np.ndarray:
    """Vertex count incl. polygon ring closing vertices (JTS getNumPoints)."""
    col = to_packed(geom)
    counts = col.vertices_per_geom().astype(np.int64)
    rings = col.rings_per_geom()
    poly = np.array(
        [col.geometry_type(g).base == GeometryType.POLYGON for g in range(len(col))]
    )
    counts[poly] += rings[poly]
    return counts


def st_x(geom) -> np.ndarray:
    """X of POINT rows (reference: ST_X)."""
    return _point_coord(to_packed(geom), 0)


def st_y(geom) -> np.ndarray:
    return _point_coord(to_packed(geom), 1)


def _point_coord(col: PackedGeometry, axis: int) -> np.ndarray:
    out = np.full(len(col), np.nan)
    for g in range(len(col)):
        pts = col.geom_xy(g)
        if pts.shape[0]:
            out[g] = pts[0, axis]
    return out


def st_geometrytype(geom) -> list[str]:
    """WKT type name per row (reference: ST_GeometryType)."""
    col = to_packed(geom)
    return [col.geometry_type(g).wkt_name for g in range(len(col))]


def st_isvalid(geom) -> np.ndarray:
    """Structural validity: finite coordinates, polygon rings with >= 3
    vertices and nonzero area (the reference's structural level of JTS
    IsValidOp)."""
    col = to_packed(geom)
    out = np.ones(len(col), dtype=bool)
    from ..core.types import ring_signed_area

    for g in range(len(col)):
        xy = col.geom_xy(g)
        if not np.isfinite(xy).all():
            out[g] = False
            continue
        if col.geometry_type(g).base == GeometryType.POLYGON:
            for p in col.geom_parts(g):
                for r in col.part_rings(p):
                    ring = col.ring_xy(r)
                    if ring.shape[0] < 3 or ring_signed_area(ring) == 0.0:
                        out[g] = False
    return out


# --------------------------------------------------------------- predicates


def _pair_pack(a: PackedGeometry, b: PackedGeometry, device=None):
    """Pack two columns with one shared shift (the midpoint of their
    joint finite bounds) so coordinates line up."""
    allb = np.concatenate([a.bounds(), b.bounds()], axis=0)
    finite = allb[np.isfinite(allb[:, 0])]
    if finite.size:
        shift = (finite[:, :2].min(axis=0) + finite[:, 2:].max(axis=0)) / 2.0
    else:
        shift = np.zeros(2)
    da = pack_to_device(_affine.translate(a, -shift[0], -shift[1]), dtype=DEVICE_DTYPE,
                        device=device)
    db = pack_to_device(_affine.translate(b, -shift[0], -shift[1]), dtype=DEVICE_DTYPE,
                        device=device)
    return da, db


def _one(g: DeviceGeometry) -> DeviceGeometry:
    """A column of P rows as P one-row columns (a G axis of 1)."""
    return DeviceGeometry(
        verts=g.verts[:, None], ring_len=g.ring_len[:, None],
        ring_is_hole=g.ring_is_hole[:, None], n_rings=g.n_rings[:, None],
        geom_type=g.geom_type[:, None], shift=g.shift,
    )


def _vmap_pair(dense_fn, da: DeviceGeometry, db: DeviceGeometry) -> torch.Tensor:
    """(P,) ``dense_fn`` of each aligned row pair ``(da[p], db[p])``."""
    return dense_fn(_one(da), _one(db))[:, 0, 0]


def _contains_dense(a, b) -> torch.Tensor:
    """(*P, Ga, Gb) b fully inside a: every real vertex of b inside a and
    no boundary crossing (a shared boundary counts as not contained)."""
    Ga, Gb = a.verts.shape[-4], b.verts.shape[-4]
    pts = _pred._flat(b.verts, 1)  # (*P, Gb, V*, 2)
    vm = _pred._flat(_pred.vert_mask(b), 0)  # (*P, Gb, V*)
    lead = pts.shape[:-3]
    inside = _pred.contains_xy(pts.reshape(*lead, -1, 2), a)  # (*P, Gb*V*, Ga)
    inside = inside.reshape(*lead, Gb, -1, Ga)
    in_a = (inside | ~vm[..., None]).all(dim=-2) & vm.any(dim=-1)[..., None]
    cross = _pred.edges_intersect(a, b)  # (*P, Ga, Gb)
    return in_a.transpose(-1, -2) & ~cross


def _distance_dense(a, b) -> torch.Tensor:
    """(*P, Ga, Gb) euclidean distance, 0 when touching, crossing or
    nested."""
    d = _pred.min_distance(a, b)
    cont = _contains_dense(a, b) | _contains_dense(b, a).transpose(-1, -2)
    return torch.where(cont, torch.zeros_like(d), d)


def _pair_chunks(da: DeviceGeometry, db: DeviceGeometry):
    """Row slices of the pair axis, each small enough that its largest
    intermediate (vertices of a × edges of b, and the reverse) holds at
    most :data:`PAIR_CHUNK_ELEMENTS`."""
    P = len(da)
    per_pair = max(1, da.verts.shape[1] * da.verts.shape[2]) * max(
        1, db.verts.shape[1] * db.verts.shape[2]
    )
    step = max(1, PAIR_CHUNK_ELEMENTS // per_pair)
    return [slice(i, min(i + step, P)) for i in range(0, P, step)]


def _pair_run(dense_fn, a: PackedGeometry, b: PackedGeometry, device, dtype):
    """(P,) ``dense_fn`` of each aligned row pair of ``a`` and ``b`` on the
    device, chunk by chunk over the pair axis, as numpy."""
    da, db = _pair_pack(a, b, device=device)
    if not len(da):
        return np.zeros(0, dtype)
    out = [
        _vmap_pair(dense_fn, take_rows(da, sl), take_rows(db, sl))
        for sl in _pair_chunks(da, db)
    ]
    return torch.cat(out).cpu().numpy().astype(dtype)


def st_contains(geom_a, geom_b, backend: str | None = None, device=None) -> np.ndarray:
    """Row-wise a contains b (reference: ST_Contains / the PIP join
    predicate, `core/geometry/MosaicGeometryJTS.scala:101`)."""
    a, b = to_packed(geom_a), to_packed(geom_b)
    if _resolve_backend(backend) in ("oracle", "native"):
        return _oracle.pair_contains(a, b)
    return _pair_run(_contains_dense, a, b, device, bool)


def st_intersects(geom_a, geom_b, backend: str | None = None, device=None) -> np.ndarray:
    """Row-wise intersects (reference: ST_Intersects)."""
    a, b = to_packed(geom_a), to_packed(geom_b)
    if _resolve_backend(backend) in ("oracle", "native"):
        return _oracle.pair_intersects(a, b)
    return _pair_run(_pred.intersects, a, b, device, bool)


def st_distance(geom_a, geom_b, backend: str | None = None, device=None) -> np.ndarray:
    """Row-wise euclidean distance, 0 when touching/overlapping/nested."""
    a, b = to_packed(geom_a), to_packed(geom_b)
    if _resolve_backend(backend) in ("oracle", "native"):
        return _oracle.pair_distance(a, b)
    return _pair_run(_distance_dense, a, b, device, np.float64)


# ----------------------------------------------- host C++ geometry engine


def st_buffer(geom, distance: float, quad_segs: int = 8):
    """Round-join buffer (reference: ST_Buffer -> JTS buffer)."""
    col, fmt = coerce(geom)
    return like_input(_host.buffer(col, float(distance), quad_segs), fmt)


def st_bufferloop(geom, inner: float, outer: float):
    """Ring between two buffer radii (reference: ST_BufferLoop)."""
    col, fmt = coerce(geom)
    ring = _host.difference(
        _host.buffer(col, float(outer)), _host.buffer(col, float(inner))
    )
    return like_input(ring, fmt)


def st_convexhull(geom):
    col, fmt = coerce(geom)
    return like_input(_host.convex_hull(col), fmt)


def st_simplify(geom, tolerance: float):
    col, fmt = coerce(geom)
    return like_input(_host.simplify(col, float(tolerance)), fmt)


def _clipper(backend: str | None):
    """Boolean-op engine for a backend name: the Martinez sweep by
    default, the independent C++ edge-classification clipper under
    ``native`` (the reference's JTS-vs-ESRI dual-engine choice)."""
    if _resolve_backend(backend) == "native":
        return _second
    return _host


def st_intersection(geom_a, geom_b, backend: str | None = None):
    """Row-wise boolean intersection (reference: ST_Intersection)."""
    a, fmt = coerce(geom_a)
    return like_input(_clipper(backend).intersection(a, to_packed(geom_b)), fmt)


def st_intersection_area(geom_a, geom_b, index_system, resolution, **kw):
    """Fused overlay join: per intersecting (left, right) geometry pair,
    the exact intersection AREA — `sql.overlay.overlay_measures` with the
    raw `expr.ast.overlap_area` tree. Keyword options (``prep=``,
    ``pair_cap=``, ``mesh=``, ``lane=``, ``device=``) pass through;
    returns `sql.overlay.OverlayMeasures`."""
    from ..sql.overlay import overlay_measures

    return overlay_measures(
        to_packed(geom_a), to_packed(geom_b), index_system, resolution, **kw,
    )


def st_overlap_fraction(geom_a, geom_b, index_system, resolution, **kw):
    """Fused overlay join: per intersecting pair, the fraction of the
    LEFT geometry covered by the right one (``overlap_area /
    left_area``); shared-edge touches report exactly 0.0. Keyword options
    pass through as in :func:`st_intersection_area`."""
    from ..expr.ast import overlap_fraction
    from ..sql.overlay import overlay_measures

    return overlay_measures(
        to_packed(geom_a), to_packed(geom_b), index_system, resolution,
        overlap_fraction(), **kw,
    )


def st_union(geom_a, geom_b, backend: str | None = None):
    a, fmt = coerce(geom_a)
    return like_input(_clipper(backend).union(a, to_packed(geom_b)), fmt)


def st_difference(geom_a, geom_b, backend: str | None = None):
    a, fmt = coerce(geom_a)
    return like_input(_clipper(backend).difference(a, to_packed(geom_b)), fmt)


def st_symdifference(geom_a, geom_b, backend: str | None = None):
    a, fmt = coerce(geom_a)
    return like_input(
        _clipper(backend).sym_difference(a, to_packed(geom_b)), fmt
    )


def st_unaryunion(geom):
    col, fmt = coerce(geom)
    return like_input(_host.unary_union(col), fmt)


def st_dump(geom):
    """Explode multi-geometries into single parts (reference: ST_Dump /
    FlattenPolygons). Returns (row_ids, parts serialized like input)."""
    col, fmt = coerce(geom)
    b = GeometryBuilder()
    rows = []
    for g in range(len(col)):
        gt = col.geometry_type(g)
        srid = int(col.srid[g])
        for p in col.geom_parts(g):
            rings = [col.ring_xy(r) for r in col.part_rings(p)]
            b.add_geometry(gt.base, [rings], srid)
            rows.append(g)
    return np.asarray(rows, dtype=np.int64), like_input(b.build(), fmt)


flatten_polygons = st_dump


# ------------------------------------------------------------ affine / CRS


def st_rotate(geom, theta):
    col, fmt = coerce(geom)
    return like_input(_affine.rotate(col, theta), fmt)


def st_scale(geom, sx, sy):
    col, fmt = coerce(geom)
    return like_input(_affine.scale(col, sx, sy), fmt)


def st_translate(geom, dx, dy):
    col, fmt = coerce(geom)
    return like_input(_affine.translate(col, dx, dy), fmt)


def st_srid(geom) -> np.ndarray:
    return to_packed(geom).srid.copy()


def st_setsrid(geom, srid: int):
    col, fmt = coerce(geom)
    return like_input(_affine.set_srid(col, int(srid)), fmt)


def st_transform(geom, to_srid: int):
    """Reproject to ``to_srid`` (reference: ST_Transform via proj4j)."""
    col, fmt = coerce(geom)
    return like_input(_affine.transform_srid(col, int(to_srid)), fmt)


def st_updatesrid(geom, from_srid: int, to_srid: int):
    """Relabel then reproject (reference: ST_UpdateSRID)."""
    col, fmt = coerce(geom)
    col = _affine.set_srid(col, int(from_srid))
    return like_input(_affine.transform_srid(col, int(to_srid)), fmt)


def st_hasvalidcoordinates(geom, crs_code, which: str = "bounds") -> np.ndarray:
    """All vertices inside the CRS validity envelope (reference:
    ST_HasValidCoordinates + CRSBoundsProvider, `core/crs/`)."""
    col = to_packed(geom)
    srid = _crs.parse_crs_code(crs_code)
    x0, y0, x1, y1 = _crs.crs_bounds(srid, reprojected=(which != "bounds"))
    out = np.zeros(len(col), dtype=bool)
    for g in range(len(col)):
        xy = col.geom_xy(g)
        if not xy.shape[0]:
            continue
        out[g] = bool(
            (xy[:, 0] >= x0).all()
            and (xy[:, 0] <= x1).all()
            and (xy[:, 1] >= y0).all()
            and (xy[:, 1] <= y1).all()
        )
    return out
