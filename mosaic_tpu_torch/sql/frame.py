"""MosaicFrame: a geometry-aware columnar table.

Port of ``mosaic_tpu/sql/frame.py``. Reference analog:
`sql/MosaicFrame.scala:15-374` — a DataFrame subclass that carries
geometry-column roles, the chosen index resolution, and exploded-or-array
indexing state in column metadata, plus `Prettifier`
(`sql/Prettifier.scala:14-18`). Here the table is a plain dict of numpy
columns + a PackedGeometry, and the index state is explicit fields.

The joins run on the card unless the caller passes ``device="cpu"``:
:meth:`MosaicFrame.point_in_polygon_join` over `sql/join.py pip_join`
(the hand-written ``pip_heavy_tiled`` kernel under ``probe="adaptive"``
and in the exact join's band), :meth:`MosaicFrame.intersects_join` over
`sql/overlay.py intersects_join`. Prebuilt chip tables
(:meth:`MosaicFrame.set_index_resolution`) are reused by both joins when
their resolution and index system match, as the reference's overlay join
reuses them; the point join's chip index is built from them once per
device (a chip index blanks core chips' geometry, so the table's
``keep_core_geoms`` does not change it, and the answer is the one
``pip_join`` gives from the polygons).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # string annotations only
    from ..core.tessellate import ChipTable  # noqa: F401

from ..core.types import PackedGeometry
from ..functions._coerce import to_packed


def _context_index(index):
    if index is not None:
        return index
    from ..context import current_context

    return current_context().index_system


@dataclasses.dataclass
class MosaicFrame:
    """Geometry column + attributes + grid-index bookkeeping."""

    geometry: PackedGeometry
    columns: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    resolution: "int | None" = None
    chips: "ChipTable | None" = None  # set by set_index_resolution
    chips_index: "str | None" = None  # index-system name the chips used
    #: the point join's chip index built from ``chips``, by device
    _chip_indexes: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    # ------------------------------------------------------------ builders
    @classmethod
    def from_table(cls, table) -> "MosaicFrame":
        """From a table with ``.geometry`` and ``.columns`` (the
        reference's readers.VectorTable)."""
        return cls(geometry=table.geometry, columns=dict(table.columns))

    @classmethod
    def from_geometry(cls, geom, **columns) -> "MosaicFrame":
        return cls(
            geometry=to_packed(geom),
            columns={k: np.asarray(v) for k, v in columns.items()},
        )

    def __len__(self) -> int:
        return len(self.geometry)

    # ------------------------------------------------------------ indexing
    def get_optimal_resolution(self, index=None, **kwargs) -> int:
        from .analyzer import MosaicAnalyzer

        return MosaicAnalyzer(_context_index(index)).get_optimal_resolution(
            self.geometry, **kwargs
        )

    def set_index_resolution(
        self, resolution: int, index=None, keep_core_geoms: bool = False
    ) -> "MosaicFrame":
        """Tessellate the geometry column and attach the chip table
        (reference: `setIndexResolution` + `applyIndex`)."""
        from ..functions.grid import grid_tessellate

        chips = grid_tessellate(
            self.geometry, resolution, keep_core_geoms=keep_core_geoms,
            index=index,
        )
        index = _context_index(index)
        return dataclasses.replace(
            self,
            resolution=resolution,
            chips=chips,
            chips_index=getattr(index, "name", str(index)),
        )

    def _reusable_chips(self, index, res):
        """This frame's chip table when it was built at ``res`` on
        ``index``'s system, else None (joining BNG cell ids against H3 ids
        would silently fail)."""
        iname = getattr(index, "name", str(index))
        if self.resolution == res and self.chips_index == iname:
            return self.chips
        return None

    # --------------------------------------------------------------- joins
    def point_in_polygon_join(
        self, points: "MosaicFrame", index=None, resolution: "int | None" = None,
        device=None,
    ) -> dict[str, np.ndarray]:
        """Managed PIP join: this frame = polygons, other = points
        (reference: `PointInPolygonJoin.join:15-37`). Returns the joined
        column dict (point columns + matched polygon row + polygon columns).
        """
        from .. import resolve_device
        from .join import build_chip_index, pip_join

        index = _context_index(index)
        res = resolution if resolution is not None else self.resolution
        if res is None:
            res = self.get_optimal_resolution(index)
        pts = np.stack(
            [
                _point_coords(points.geometry, 0),
                _point_coords(points.geometry, 1),
            ],
            axis=-1,
        )
        chips = self._reusable_chips(index, res)
        if chips is None:
            match = pip_join(pts, self.geometry, index, res, device=device)
        else:
            dev = resolve_device(device)
            ci = self._chip_indexes.get(str(dev))
            if ci is None:
                ci = self._chip_indexes[str(dev)] = build_chip_index(chips, device=dev)
            match = pip_join(pts, None, index, res, chip_index=ci, device=dev)
        out = {k: v.copy() for k, v in points.columns.items()}
        out["polygon_row"] = match
        ok = match >= 0
        safe = np.maximum(match, 0)
        for k, v in self.columns.items():
            col = np.asarray(v)[safe]
            if col.dtype.kind in "fiu":  # numeric -> NaN mask
                col = np.where(ok, col.astype(np.float64), np.nan)
            else:  # strings/objects -> None mask
                col = np.where(ok, col.astype(object), None)
            out[f"polygon_{k}"] = col
        return out

    def intersects_join(
        self,
        other: "MosaicFrame",
        index=None,
        resolution: "int | None" = None,
        device=None,
    ) -> np.ndarray:
        """Polygon-polygon ST_Intersects overlay join (reference: the BNG
        overlay workload). Returns distinct (this_row, other_row) pairs.
        Prebuilt chip tables (`set_index_resolution`) on either frame are
        reused."""
        from .overlay import intersects_join as _ov

        index = _context_index(index)
        res = resolution if resolution is not None else self.resolution
        if res is None:
            res = self.get_optimal_resolution(index)
        return _ov(
            self.geometry,
            other.geometry,
            index,
            res,
            left_chips=self._reusable_chips(index, res),
            right_chips=other._reusable_chips(index, res),
            device=device,
        )

    # ------------------------------------------------------------- display
    def prettified(self, n: int = 10) -> str:
        """Reference: `Prettifier.prettified` — compact preview."""
        from ..core.geometry.wkt import to_wkt

        rows = min(n, len(self))
        idx = list(range(rows))
        wkts = to_wkt(self.geometry.take(idx))
        lines = []
        header = ["geometry"] + list(self.columns)
        lines.append(" | ".join(header))
        for i in idx:
            w = wkts[i] if len(wkts[i]) < 60 else wkts[i][:57] + "..."
            vals = [w] + [str(self.columns[k][i]) for k in self.columns]
            lines.append(" | ".join(vals))
        return "\n".join(lines)


def _point_coords(col: PackedGeometry, axis: int) -> np.ndarray:
    """(G,) coordinate ``axis`` of each geometry's first vertex, NaN for
    an empty geometry (the reference's loop over ``geom_xy(g)[0]``, as
    one gather)."""
    first = col.ring_offsets[col.part_offsets[col.geom_offsets[:-1]]]
    has = col.vertices_per_geom() > 0
    out = np.full(len(col), np.nan)
    out[has] = col.xy[first[has], axis]
    return out
