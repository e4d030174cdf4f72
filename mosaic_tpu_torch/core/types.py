"""Core geometry container types (host numpy; a copy of
``mosaic_tpu/core/types.py`` kept in the port so that it never imports
the JAX package).

The reference engine represents geometries as per-row JVM objects
(`core/types/model/InternalGeometry.scala:25-118` holds boundary/hole coord
arrays per geometry; `core/types/InternalGeometryType.scala:10-26` is the Spark
struct). An accelerator engine instead keeps *columns of geometries* as
packed, padded numeric arrays so that whole-column operations run as a few
array operations on the device.

Two forms are provided:

``PackedGeometry``
    Host-resident CSR (compressed sparse row) ragged representation in float64.
    Three offset levels: geometry -> polygon/part -> ring -> vertex. This is
    the lossless "source of truth" produced by the WKT/WKB/GeoJSON codecs.

``PaddedGeometry``
    Device-friendly rectangular representation ``verts[G, R, V, 2]`` with ring
    lengths and validity masks, produced by :meth:`PackedGeometry.to_padded`.
    Shell rings are CCW-oriented and holes CW at pack time so that signed
    shoelace sums give correct areas and even-odd crossing tests handle holes
    for free.

Geometry type ids follow WKB numbering (reference analog:
`core/types/model/GeometryTypeEnum.scala`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Sequence

import numpy as np


class GeometryType(enum.IntEnum):
    """WKB geometry type ids (reference: GeometryTypeEnum.scala)."""

    POINT = 1
    LINESTRING = 2
    POLYGON = 3
    MULTIPOINT = 4
    MULTILINESTRING = 5
    MULTIPOLYGON = 6
    GEOMETRYCOLLECTION = 7

    @property
    def is_multi(self) -> bool:
        return self in (
            GeometryType.MULTIPOINT,
            GeometryType.MULTILINESTRING,
            GeometryType.MULTIPOLYGON,
            GeometryType.GEOMETRYCOLLECTION,
        )

    @property
    def base(self) -> "GeometryType":
        """POINT for MULTIPOINT etc."""
        if self == GeometryType.GEOMETRYCOLLECTION:
            return self
        if self.is_multi:
            return GeometryType(self.value - 3)
        return self


def _as_offsets(a: Iterable[int]) -> np.ndarray:
    arr = np.asarray(list(a) if not isinstance(a, np.ndarray) else a, dtype=np.int64)
    if arr.ndim != 1 or arr.size < 1:
        raise ValueError("offsets must be a 1-D array with at least one element")
    return arr


def ring_signed_area(xy: np.ndarray) -> float:
    """Signed shoelace area of one ring (host helper)."""
    x, y = xy[:, 0], xy[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


@dataclasses.dataclass
class PackedGeometry:
    """A column of geometries as CSR ragged arrays (host, float64).

    Hierarchy: geometry[g] owns parts ``geom_offsets[g]:geom_offsets[g+1]``;
    part (a polygon for (MULTI)POLYGON, a linestring for (MULTI)LINESTRING,
    a single point for (MULTI)POINT) owns rings
    ``part_offsets[p]:part_offsets[p+1]``; ring owns vertices
    ``ring_offsets[r]:ring_offsets[r+1]`` in ``xy``.

    For non-polygonal geometries each part has exactly one "ring" (the vertex
    run). Polygon rings: first ring of a part is the shell, the rest holes.

    Rings are stored closed-form *without* the repeated closing vertex.
    """

    xy: np.ndarray  # (V, 2) float64
    ring_offsets: np.ndarray  # (R+1,) int64 -> xy rows
    part_offsets: np.ndarray  # (P+1,) int64 -> rings
    geom_offsets: np.ndarray  # (G+1,) int64 -> parts
    geom_type: np.ndarray  # (G,) uint8 GeometryType values
    srid: np.ndarray  # (G,) int32
    z: np.ndarray | None = None  # (V,) float64 or None
    geom_has_z: np.ndarray | None = None  # (G,) bool; z=0.0 is a real value

    def __post_init__(self):
        self.xy = np.ascontiguousarray(np.asarray(self.xy, dtype=np.float64).reshape(-1, 2))
        self.ring_offsets = _as_offsets(self.ring_offsets)
        self.part_offsets = _as_offsets(self.part_offsets)
        self.geom_offsets = _as_offsets(self.geom_offsets)
        self.geom_type = np.asarray(self.geom_type, dtype=np.uint8)
        self.srid = np.asarray(self.srid, dtype=np.int32)
        if self.srid.shape != self.geom_type.shape:
            raise ValueError("srid and geom_type must have the same length")
        if self.geom_has_z is None:
            self.geom_has_z = (
                np.ones(len(self.geom_type), dtype=bool)
                if self.z is not None
                else np.zeros(len(self.geom_type), dtype=bool)
            )
        else:
            self.geom_has_z = np.asarray(self.geom_has_z, dtype=bool)

    def has_z(self, g: int) -> bool:
        return self.z is not None and bool(self.geom_has_z[g])

    # ------------------------------------------------------------------ sizes
    def __len__(self) -> int:
        return int(self.geom_type.shape[0])

    @property
    def num_rings(self) -> int:
        return int(self.ring_offsets.shape[0] - 1)

    @property
    def num_vertices(self) -> int:
        return int(self.xy.shape[0])

    # ------------------------------------------------------------- accessors
    def geom_parts(self, g: int) -> range:
        return range(int(self.geom_offsets[g]), int(self.geom_offsets[g + 1]))

    def part_rings(self, p: int) -> range:
        return range(int(self.part_offsets[p]), int(self.part_offsets[p + 1]))

    def ring_xy(self, r: int) -> np.ndarray:
        return self.xy[int(self.ring_offsets[r]) : int(self.ring_offsets[r + 1])]

    def ring_z(self, r: int) -> np.ndarray | None:
        if self.z is None:
            return None
        return self.z[int(self.ring_offsets[r]) : int(self.ring_offsets[r + 1])]

    def geom_vertex_slice(self, g: int) -> slice:
        p0, p1 = int(self.geom_offsets[g]), int(self.geom_offsets[g + 1])
        r0, r1 = int(self.part_offsets[p0]), int(self.part_offsets[p1])
        v0 = int(self.ring_offsets[r0])
        v1 = int(self.ring_offsets[r1])
        return slice(v0, v1)

    def geom_xy(self, g: int) -> np.ndarray:
        return self.xy[self.geom_vertex_slice(g)]

    def geometry_type(self, g: int) -> GeometryType:
        return GeometryType(int(self.geom_type[g]))

    # ------------------------------------------------------------------ bbox
    def bounds(self) -> np.ndarray:
        """(G, 4) [xmin, ymin, xmax, ymax] per geometry (NaN for empties).

        Vertices are CSR-contiguous per geometry, so the per-geometry
        min/max is one ``reduceat`` over the shared vertex buffer."""
        G = len(self)
        out = np.full((G, 4), np.nan)
        if G == 0 or self.xy.shape[0] == 0:
            return out
        vert_bounds = self.ring_offsets[self.part_offsets[self.geom_offsets]]
        starts, ends = vert_bounds[:-1], vert_bounds[1:]
        nonempty = ends > starts
        if not nonempty.any():
            return out
        # reduceat over nonempty starts only: empties hold no vertices, so
        # each nonempty segment runs exactly to the next nonempty start (or
        # the buffer end), never truncating its own vertices
        idx_ne = np.nonzero(nonempty)[0]
        starts_ne = starts[idx_ne]
        mins = np.minimum.reduceat(self.xy, starts_ne, axis=0)
        maxs = np.maximum.reduceat(self.xy, starts_ne, axis=0)
        out[idx_ne, 0:2] = mins
        out[idx_ne, 2:4] = maxs
        return out

    # ------------------------------------------------------------- selection
    def take(self, indices: Sequence[int]) -> "PackedGeometry":
        """Gather a subset/ordering of geometries into a new PackedGeometry."""
        builder = GeometryBuilder()
        for g in indices:
            builder.append_from(self, int(g))
        return builder.build()

    def slice(self, start: int, stop: int) -> "PackedGeometry":
        """Python-slice semantics: out-of-range bounds clamp instead of
        raising (``col.slice(0, 6)`` of a 2-geometry column is the whole
        column, exactly like ``seq[0:6]``)."""
        n = len(self)
        start = max(0, min(start + n if start < 0 else start, n))
        stop = max(start, min(stop + n if stop < 0 else stop, n))
        return self.take(range(start, stop))

    @classmethod
    def empty(cls) -> "PackedGeometry":
        return cls(
            xy=np.zeros((0, 2)),
            ring_offsets=np.zeros(1, np.int64),
            part_offsets=np.zeros(1, np.int64),
            geom_offsets=np.zeros(1, np.int64),
            geom_type=np.zeros(0, np.uint8),
            srid=np.zeros(0, np.int32),
        )

    def concat(self, other: "PackedGeometry") -> "PackedGeometry":
        return concat_packed([self, other])

    # ------------------------------------------------------------ conversion
    def to_padded(
        self,
        max_rings: int | None = None,
        max_verts: int | None = None,
        dtype=np.float32,
        close_rings: bool = True,
    ) -> "PaddedGeometry":
        """Rectangularize to ``[G, R, V, 2]`` with masks for device kernels.

        Shells are re-oriented CCW and holes CW. ``close_rings`` repeats the
        first vertex at the end of each ring (edge iteration then needs no
        wraparound index math on device).
        """
        G = len(self)
        ring_counts = np.zeros(G, dtype=np.int64)
        for g in range(G):
            n = 0
            for p in self.geom_parts(g):
                n += len(self.part_rings(p))
            ring_counts[g] = n
        R = int(max_rings if max_rings is not None else (ring_counts.max() if G else 1))
        R = max(R, 1)
        extra = 1 if close_rings else 0
        ring_len_max = 0
        for r in range(self.num_rings):
            ring_len_max = max(ring_len_max, int(self.ring_offsets[r + 1] - self.ring_offsets[r]))
        V = int(max_verts if max_verts is not None else ring_len_max + extra)
        V = max(V, 1)

        verts = np.zeros((G, R, V, 2), dtype=dtype)
        ring_len = np.zeros((G, R), dtype=np.int32)
        ring_hole = np.zeros((G, R), dtype=bool)
        n_rings = np.zeros((G,), dtype=np.int32)
        for g in range(G):
            ri = 0
            gt = self.geometry_type(g).base
            for p in self.geom_parts(g):
                for k, r in enumerate(self.part_rings(p)):
                    if ri >= R:
                        raise ValueError(f"geometry {g} exceeds max_rings={R}")
                    pts = self.ring_xy(r)
                    is_hole = gt == GeometryType.POLYGON and k > 0
                    if gt == GeometryType.POLYGON and pts.shape[0] >= 3:
                        sa = ring_signed_area(pts)
                        if (sa < 0) != is_hole:
                            pts = pts[::-1]
                    n = pts.shape[0]
                    stored = n + (extra if (close_rings and gt == GeometryType.POLYGON and n) else 0)
                    if stored > V:
                        raise ValueError(
                            f"geometry {g} ring of {n} vertices exceeds max_verts={V}"
                        )
                    verts[g, ri, :n] = pts
                    if close_rings and gt == GeometryType.POLYGON and n:
                        verts[g, ri, n] = pts[0]
                    ring_len[g, ri] = n
                    ring_hole[g, ri] = is_hole
                    ri += 1
            n_rings[g] = ri
        return PaddedGeometry(
            verts=verts,
            ring_len=ring_len,
            ring_is_hole=ring_hole,
            n_rings=n_rings,
            geom_type=self.geom_type.copy(),
            srid=self.srid.copy(),
            rings_closed=close_rings,
        )


def concat_packed(columns: Sequence[PackedGeometry]) -> PackedGeometry:
    """One column holding ``columns`` end to end, offsets rebased; empty
    columns drop out, and a missing z lane reads as zeros."""
    cols = [c for c in columns if len(c)]
    if not cols:
        return PackedGeometry.empty()
    xy = np.concatenate([c.xy for c in cols])
    has_z = any(c.z is not None for c in cols)
    z = (
        np.concatenate(
            [c.z if c.z is not None else np.zeros(c.num_vertices) for c in cols]
        )
        if has_z
        else None
    )
    ring_offsets = [cols[0].ring_offsets]
    part_offsets = [cols[0].part_offsets]
    geom_offsets = [cols[0].geom_offsets]
    for c in cols[1:]:
        ring_offsets.append(c.ring_offsets[1:] + ring_offsets[-1][-1])
        part_offsets.append(c.part_offsets[1:] + part_offsets[-1][-1])
        geom_offsets.append(c.geom_offsets[1:] + geom_offsets[-1][-1])
    return PackedGeometry(
        xy=xy,
        ring_offsets=np.concatenate(ring_offsets),
        part_offsets=np.concatenate(part_offsets),
        geom_offsets=np.concatenate(geom_offsets),
        geom_type=np.concatenate([c.geom_type for c in cols]),
        srid=np.concatenate([c.srid for c in cols]),
        z=z,
        geom_has_z=np.concatenate([c.geom_has_z for c in cols]),
    )


@dataclasses.dataclass
class PaddedGeometry:
    """Rectangular device form: ``verts[G, R, V, 2]`` + masks.

    ``ring_len[g, r]`` is the vertex count *excluding* any closing vertex.
    ``rings_closed`` records whether polygon rings carry the repeated first
    vertex at index ``ring_len`` (so edges are ``verts[:, :, i] ->
    verts[:, :, i+1]`` for ``i < ring_len``).
    """

    verts: np.ndarray  # (G, R, V, 2)
    ring_len: np.ndarray  # (G, R) int32
    ring_is_hole: np.ndarray  # (G, R) bool
    n_rings: np.ndarray  # (G,) int32
    geom_type: np.ndarray  # (G,) uint8
    srid: np.ndarray  # (G,) int32
    rings_closed: bool = True

    def __len__(self) -> int:
        return int(self.geom_type.shape[0])

    @property
    def max_verts(self) -> int:
        return int(self.verts.shape[2])

    def vert_mask(self) -> np.ndarray:
        """(G, R, V) bool — True for real (non-pad, non-closing) vertices."""
        idx = np.arange(self.max_verts)[None, None, :]
        return idx < self.ring_len[:, :, None]


class GeometryBuilder:
    """Incremental builder for PackedGeometry (host side, append-only)."""

    def __init__(self):
        self._xy: list[np.ndarray] = []
        self._z: list[np.ndarray] = []
        self._has_z = False
        self._cur_geom_has_z = False
        self._geom_has_z: list[bool] = []
        self._ring_offsets = [0]
        self._part_offsets = [0]
        self._geom_offsets = [0]
        self._geom_type: list[int] = []
        self._srid: list[int] = []

    def add_ring(self, xy: np.ndarray, z: np.ndarray | None = None) -> None:
        xy = np.asarray(xy, dtype=np.float64).reshape(-1, 2)
        self._xy.append(xy)
        if z is not None:
            self._has_z = True
            self._cur_geom_has_z = True
            self._z.append(np.asarray(z, dtype=np.float64).reshape(-1))
        else:
            self._z.append(np.zeros(xy.shape[0]))
        self._ring_offsets.append(self._ring_offsets[-1] + xy.shape[0])

    def end_part(self) -> None:
        self._part_offsets.append(len(self._ring_offsets) - 1)

    def end_geom(self, geom_type: GeometryType, srid: int = 0) -> None:
        self._geom_offsets.append(len(self._part_offsets) - 1)
        self._geom_type.append(int(geom_type))
        self._srid.append(int(srid))
        self._geom_has_z.append(self._cur_geom_has_z)
        self._cur_geom_has_z = False

    def append_from(self, src: PackedGeometry, g: int) -> None:
        src_z = src.has_z(g)
        for p in src.geom_parts(g):
            for r in src.part_rings(p):
                self.add_ring(src.ring_xy(r), src.ring_z(r) if src_z else None)
            self.end_part()
        self.end_geom(src.geometry_type(g), int(src.srid[g]))

    def add_geometry(
        self,
        geom_type: GeometryType,
        parts: Sequence[Sequence[np.ndarray]],
        srid: int = 0,
    ) -> None:
        """parts = [[ring, ...], ...]; for lines/points one ring per part."""
        for rings in parts:
            for ring in rings:
                self.add_ring(ring)
            self.end_part()
        self.end_geom(geom_type, srid)

    def build(self) -> PackedGeometry:
        xy = (
            np.concatenate(self._xy)
            if self._xy
            else np.zeros((0, 2), dtype=np.float64)
        )
        z = np.concatenate(self._z) if (self._z and self._has_z) else None
        return PackedGeometry(
            xy=xy,
            ring_offsets=np.asarray(self._ring_offsets, np.int64),
            part_offsets=np.asarray(self._part_offsets, np.int64),
            geom_offsets=np.asarray(self._geom_offsets, np.int64),
            geom_type=np.asarray(self._geom_type, np.uint8),
            srid=np.asarray(self._srid, np.int32),
            z=z,
            geom_has_z=np.asarray(self._geom_has_z, dtype=bool),
        )
