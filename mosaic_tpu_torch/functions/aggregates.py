"""Spatial aggregates + grouped combiners.

Port of ``mosaic_tpu/functions/aggregates.py`` (host numpy, as in the reference).

Reference analog: `ST_IntersectionAggregate` / `ST_IntersectsAggregate` /
`ST_UnionAgg` (`expressions/geometry/ST_IntersectionAggregate.scala:12-91`).
The reference implements them as Catalyst TypedImperativeAggregates with WKB
accumulators merged across shuffle partitions; here groups are explicit id
arrays and the merge is one host C++ union per group, so a whole grouped
aggregation is a single columnar call.
"""

from __future__ import annotations

import numpy as np

from ..core.geometry import hostops as _host
from ..core.index.base import IndexSystem
from ..core.types import GeometryBuilder, PackedGeometry
from ._coerce import to_packed

__all__ = [
    "st_union_agg",
    "st_intersection_aggregate",
    "st_intersects_aggregate",
]


def _group_ids(groups, n: int) -> tuple[np.ndarray, np.ndarray]:
    if groups is None:
        return np.zeros(n, dtype=np.int64), np.zeros(1, dtype=np.int64)
    g = np.asarray(groups, dtype=np.int64)
    return g, np.unique(g)


def st_union_agg(geom, groups=None) -> PackedGeometry:
    """Union of all rows (optionally per group id) — reference: ST_UnionAgg.

    Returns one geometry per distinct group, ordered by group id.
    """
    col = to_packed(geom)
    g, uniq = _group_ids(groups, len(col))
    b = GeometryBuilder()
    for gid in uniq:
        rows = np.nonzero(g == gid)[0]
        merged = _host.union_all(col.take(rows))
        b.append_from(merged, 0)
    return b.build()


def _chip_pair_geoms(
    index: IndexSystem,
    cells: np.ndarray,
    a_core: np.ndarray,
    b_core: np.ndarray,
    a_chips: PackedGeometry,
    b_chips: PackedGeometry,
) -> PackedGeometry:
    """Per joined chip row: the geometry the reference's update() adds
    (`ST_IntersectionAggregate.scala:40-63`): core∩core -> whole cell,
    core∩border -> the border chip, border∩border -> exact intersection."""
    n = cells.shape[0]
    out = GeometryBuilder()
    both_border = ~a_core & ~b_core
    if both_border.any():
        rows = np.nonzero(both_border)[0]
        inter = _host.intersection(a_chips.take(rows), b_chips.take(rows))
    else:
        rows, inter = np.zeros(0, np.int64), None
    inter_pos = {int(r): i for i, r in enumerate(rows)}
    # one batched boundary call for all distinct core∩core cells
    # (grid_boundary also drops the padded repeats of the final boundary
    # vertex — duplicate vertices break the sweep line)
    cc = np.unique(cells[a_core & b_core])
    if cc.size:
        from .grid import grid_boundary

        cc_geoms = grid_boundary(cc, fmt="packed", index=index)
        cell_pos = {int(c): i for i, c in enumerate(cc)}
    for i in range(n):
        if a_core[i] and b_core[i]:
            out.append_from(cc_geoms, cell_pos[int(cells[i])])
        elif a_core[i]:
            out.append_from(b_chips, i)
        elif b_core[i]:
            out.append_from(a_chips, i)
        else:
            out.append_from(inter, inter_pos[i])
    return out.build()


def st_intersection_aggregate(
    index: IndexSystem,
    cells,
    a_is_core,
    b_is_core,
    a_chips,
    b_chips,
    groups=None,
) -> PackedGeometry:
    """Grouped polygon-intersection area aggregate over joined chip rows.

    Inputs are the columns of an equi-join of two tessellations on cell id
    (the reference's `ST_IntersectionAggregate` consumes the same two chip
    structs per row). Per row the contribution geometry follows the
    core/border matrix; per group the contributions are unioned (the
    reference's merge step `ST_IntersectionAggregate.scala:65-72`).
    """
    cells = np.asarray(cells, dtype=np.int64)
    a_core = np.asarray(a_is_core, dtype=bool)
    b_core = np.asarray(b_is_core, dtype=bool)
    pieces = _chip_pair_geoms(
        index, cells, a_core, b_core, to_packed(a_chips), to_packed(b_chips)
    )
    return st_union_agg(pieces, groups)


def st_intersects_aggregate(
    cells, a_is_core, b_is_core, a_chips, b_chips, groups=None
) -> np.ndarray:
    """Per-group boolean: do the two tessellated geometries intersect?
    (reference: ST_IntersectsAggregate — true if any joined chip pair hits).

    A shared cell with a core chip on either side intersects by
    construction; border/border pairs run the exact predicate.
    """
    from .geometry import st_intersects

    cells = np.asarray(cells, dtype=np.int64)
    a_core = np.asarray(a_is_core, dtype=bool)
    b_core = np.asarray(b_is_core, dtype=bool)
    n = cells.shape[0]
    hit = a_core | b_core
    both = ~hit
    if both.any():
        rows = np.nonzero(both)[0]
        a_col, b_col = to_packed(a_chips), to_packed(b_chips)
        hit[rows] = st_intersects(
            a_col.take(rows), b_col.take(rows), backend="oracle"
        )
    g, uniq = _group_ids(groups, n)
    out = np.zeros(uniq.shape[0], dtype=bool)
    for i, gid in enumerate(uniq):
        out[i] = bool(hit[g == gid].any())
    return out
