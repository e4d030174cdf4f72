"""Spatial predicates over device geometry columns (torch).

Port of ``mosaic_tpu/core/geometry/predicates.py``: the even-odd
crossing test (:func:`contains_xy`, with a bbox prefilter
:func:`contains_xy_bbox`, and :func:`contains_xy_gather` of each point
against its own polygon), the type-aware boundary edges, segment
intersection, the three-term minimum boundary distance, the point to
boundary distance :func:`points_min_dist` and :func:`intersects`.

Every function here takes geometries whose tensors may carry a leading
batch prefix (``verts`` of shape ``(*P, G, R, V, 2)``, the other fields
``(*P, G, ...)``), the same prefix on both sides; the reference's dense
``(Ga, Gb)`` result becomes ``(*P, Ga, Gb)``. With no prefix they are the
reference's functions; with a prefix of P row pairs and G = 1 they are
its ``jax.vmap`` over pairs (`functions/geometry._vmap_pair`), as one
batch of eager torch ops.

The arithmetic is the reference's, operation for operation: each
two-term sum is written out (``x[..., 0] + x[..., 1]``) and every
product and quotient is its own op, so in float64 the values are the
reference's bits on any device (IEEE add, multiply, divide and sqrt are
exact-rounded, and separate eager ops are never fused into an FMA). The
one exception is torch's CPU ``sqrt``, which is not correctly rounded
(some doubles come out one ulp off): :func:`_sqrt` takes a CPU tensor's
root through numpy, whose ``sqrt`` is, as CUDA's is on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import GeometryType

_BIG = 1e30


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root on any device (see module doc)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _sum2(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jnp.sum(x, axis=-1)`` over a last axis of 2."""
    return x[..., 0] + x[..., 1]


def _is_polygonal(gt):
    return (gt == GeometryType.POLYGON) | (gt == GeometryType.MULTIPOLYGON)


def _is_linear(gt):
    return (gt == GeometryType.LINESTRING) | (gt == GeometryType.MULTILINESTRING)


def _edges(geoms):
    """(a, b, poly_mask, type_mask): edges ``(*P, G, R, V-1, 2)`` and their
    closed-ring and type-aware masks (`core/geometry/device.edges`)."""
    v = geoms.verts
    a = v[..., :-1, :]
    b = v[..., 1:, :]
    idx = torch.arange(v.shape[-2] - 1, device=v.device)
    rl = geoms.ring_len[..., None]
    poly_mask = idx < rl
    line_mask = idx < (rl - 1)
    gt = geoms.geom_type[..., None, None]
    type_mask = torch.where(
        _is_polygonal(gt), poly_mask, line_mask & _is_linear(gt)
    )
    return a, b, poly_mask, type_mask


def _flat(x: torch.Tensor, tail: int) -> torch.Tensor:
    """Merge the ring and vertex/edge axes: ``(*P, G, R, E, *t)`` ->
    ``(*P, G, R*E, *t)`` with ``tail`` trailing axes kept."""
    lead = x.shape[: x.dim() - 2 - tail]
    return x.reshape(*lead, -1, *x.shape[x.dim() - tail :])


def vert_mask(geoms) -> torch.Tensor:
    """(*P, G, R, V) True for real vertices (excludes closing + pad)."""
    idx = torch.arange(geoms.verts.shape[-2], device=geoms.verts.device)
    return idx < geoms.ring_len[..., None]


def _poly_edges(polys):
    """Edges with the closed-ring mask, polygons only: a POINT's single
    vertex ring would otherwise add a phantom edge to the zero pad."""
    a, b, poly_mask, _ = _edges(polys)
    return a, b, poly_mask & _is_polygonal(polys.geom_type)[..., None, None]


def _boundary_edges(geoms):
    """Edges with the type-aware mask (closed for polygons, open for
    lines, none for points)."""
    a, b, _, type_mask = _edges(geoms)
    return a, b, type_mask


def crossing_number(points: torch.Tensor, polys) -> torch.Tensor:
    """(*P, N, G) int32 ray-crossing counts of points ``(*P, N, 2)``
    against every polygon (all rings; holes flip parity)."""
    a, b, mask = _poly_edges(polys)  # (*P, G, R, E, 2)
    px = points[..., 0][..., :, None, None, None]  # (*P, N, 1, 1, 1)
    py = points[..., 1][..., :, None, None, None]
    a, b, mask = a.unsqueeze(-5), b.unsqueeze(-5), mask.unsqueeze(-4)
    ay, by = a[..., 1], b[..., 1]
    ax, bx = a[..., 0], b[..., 0]
    straddle = (ay > py) != (by > py)
    denom = by - ay
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    xcross = ax + (py - ay) * (bx - ax) / denom
    hit = straddle & (px < xcross) & mask
    return hit.sum(dim=(-2, -1), dtype=torch.int32)


def contains_xy(points: torch.Tensor, polys) -> torch.Tensor:
    """(*P, N, G) bool point-in-polygon, even-odd rule."""
    return (crossing_number(points, polys) & 1) == 1


def contains_xy_bbox(points: torch.Tensor, polys) -> torch.Tensor:
    """(N, G) :func:`contains_xy` with a bbox prefilter (cheap reject
    before the edges)."""
    from .measures import bounds

    bb = bounds(polys)  # (G, 4)
    px, py = points[:, 0][:, None], points[:, 1][:, None]
    in_bb = (px >= bb[None, :, 0]) & (py >= bb[None, :, 1]) & (
        px <= bb[None, :, 2]
    ) & (py <= bb[None, :, 3])
    return in_bb & contains_xy(points, polys)


def contains_xy_gather(points: torch.Tensor, poly_idx: torch.Tensor, polys) -> torch.Tensor:
    """(N,) bool: each point tested against its own polygon
    ``poly_idx[i]`` (the shape after a cell join: one candidate chip a
    point)."""
    a, b, mask = _poly_edges(polys)  # (G, R, E, 2)
    ga, gb, gm = a[poly_idx], b[poly_idx], mask[poly_idx]  # (N, R, E, ...)
    px = points[:, 0][:, None, None]
    py = points[:, 1][:, None, None]
    ay, by = ga[..., 1], gb[..., 1]
    ax, bx = ga[..., 0], gb[..., 0]
    straddle = (ay > py) != (by > py)
    denom = by - ay
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    xcross = ax + (py - ay) * (bx - ax) / denom
    hit = straddle & (px < xcross) & gm
    return (hit.sum(dim=(-2, -1), dtype=torch.int32) & 1) == 1


def _seg_seg_intersect(p1, p2, q1, q2):
    """Proper + touching segment intersection by orientation tests; all
    args broadcast over (..., 2), the result is (...,) bool."""

    def cross(o, a, b):
        return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
            a[..., 1] - o[..., 1]
        ) * (b[..., 0] - o[..., 0])

    d1 = cross(q1, q2, p1)
    d2 = cross(q1, q2, p2)
    d3 = cross(p1, p2, q1)
    d4 = cross(p1, p2, q2)
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))

    def on_seg(a, b, c, d):
        # collinear c on segment ab
        return (
            (d == 0)
            & (torch.minimum(a[..., 0], b[..., 0]) <= c[..., 0])
            & (c[..., 0] <= torch.maximum(a[..., 0], b[..., 0]))
            & (torch.minimum(a[..., 1], b[..., 1]) <= c[..., 1])
            & (c[..., 1] <= torch.maximum(a[..., 1], b[..., 1]))
        )

    touch = (
        on_seg(q1, q2, p1, d1)
        | on_seg(q1, q2, p2, d2)
        | on_seg(p1, p2, q1, d3)
        | on_seg(p1, p2, q2, d4)
    )
    return proper | touch


def _point_seg_dist2(p, a, b):
    """Squared distance from points p (..., 2) to segments (a, b)."""
    ab = b - a
    ap = p - a
    denom = _sum2(ab * ab)
    t = _sum2(ap * ab) / torch.where(denom == 0, torch.ones_like(denom), denom)
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    d = p - proj
    return _sum2(d * d)


def _flat_edges(g):
    a1, a2, am = _boundary_edges(g)
    return _flat(a1, 1), _flat(a2, 1), _flat(am, 0)


def edges_intersect(ga, gb) -> torch.Tensor:
    """(*P, Ga, Gb) bool — any boundary edge of a crosses any edge of b."""
    a1, a2, am = _flat_edges(ga)  # (*P, A, Ea, 2)
    b1, b2, bm = _flat_edges(gb)  # (*P, B, Eb, 2)

    def left(x):  # (*P, A, Ea, 2) -> (*P, A, 1, Ea, 1, 2)
        return x[..., :, None, :, None, :]

    def right(x):  # (*P, B, Eb, 2) -> (*P, 1, B, 1, Eb, 2)
        return x[..., None, :, None, :, :]

    hit = _seg_seg_intersect(left(a1), left(a2), right(b1), right(b2))
    m = am[..., :, None, :, None] & bm[..., None, :, None, :]
    return (hit & m).any(dim=-1).any(dim=-1)


def min_distance(ga, gb) -> torch.Tensor:
    """(*P, Ga, Gb) minimum boundary distance (0 where boundaries cross).
    Three masked terms so degenerate geometries work:
    vertex(a)->segment(b), vertex(b)->segment(a) and vertex(a)->vertex(b)
    (the only one left for POINT x POINT)."""
    a1, a2, am = _flat_edges(ga)
    b1, b2, bm = _flat_edges(gb)
    va, vam = _flat(ga.verts, 1), _flat(vert_mask(ga), 0)  # (*P, A, Va, 2)
    vb, vbm = _flat(gb.verts, 1), _flat(vert_mask(gb), 0)
    big = torch.full((), _BIG, dtype=va.dtype, device=va.device)

    # vertex-of-a to segment-of-b: (*P, A, B, Va, Eb)
    d_ab = _point_seg_dist2(
        va[..., :, None, :, None, :],
        b1[..., None, :, None, :, :],
        b2[..., None, :, None, :, :],
    )
    d_ab = torch.where(vam[..., :, None, :, None] & bm[..., None, :, None, :], d_ab, big)
    # vertex-of-b to segment-of-a: (*P, A, B, Vb, Ea)
    d_ba = _point_seg_dist2(
        vb[..., None, :, :, None, :],
        a1[..., :, None, None, :, :],
        a2[..., :, None, None, :, :],
    )
    d_ba = torch.where(vbm[..., None, :, :, None] & am[..., :, None, None, :], d_ba, big)
    # vertex-of-a to vertex-of-b: (*P, A, B, Va, Vb)
    dd = va[..., :, None, :, None, :] - vb[..., None, :, None, :, :]
    dv = _sum2(dd * dd)
    dv = torch.where(vam[..., :, None, :, None] & vbm[..., None, :, None, :], dv, big)

    def amin(x):
        return x.amin(dim=(-2, -1)) if x.shape[-1] and x.shape[-2] else torch.full(
            x.shape[:-2], _BIG, dtype=x.dtype, device=x.device
        )

    d2 = torch.minimum(torch.minimum(amin(d_ab), amin(d_ba)), amin(dv))
    crossed = edges_intersect(ga, gb)
    return torch.where(crossed, torch.zeros_like(d2), _sqrt(d2))


def points_min_dist(points: torch.Tensor, polys) -> torch.Tensor:
    """(N, G) distance from each point to each geometry's boundary (0
    inside polygons)."""
    a, b, mask = _boundary_edges(polys)
    af, bf, mf = _flat(a, 1), _flat(b, 1), _flat(mask, 0)  # (G, E*, ...)
    d2 = _point_seg_dist2(points[:, None, None, :], af[None], bf[None])
    d2 = torch.where(mf[None], d2, torch.full((), _BIG, dtype=d2.dtype, device=d2.device))
    d2 = d2.amin(dim=-1) if d2.shape[-1] else torch.full(
        d2.shape[:-1], _BIG, dtype=d2.dtype, device=d2.device)
    inside = contains_xy(points, polys)
    return torch.where(inside, torch.zeros_like(d2), _sqrt(d2))


def intersects(ga, gb) -> torch.Tensor:
    """(*P, Ga, Gb) bool polygon/polygon intersects: edges cross, or any
    real vertex of one lies inside the other (covers containment, and
    multi-part geometries whose non-first part is the nested one)."""
    cross = edges_intersect(ga, gb)
    va, vam = _flat(ga.verts, 1), _flat(vert_mask(ga), 0)  # (*P, A, V, 2)
    vb, vbm = _flat(gb.verts, 1), _flat(vert_mask(gb), 0)

    def any_in(pts, pm, polys):
        # (*P, N, V, 2), (*P, N, V) against polys (*P, M) -> (*P, N, M)
        lead = pts.shape[:-3]
        n = pts.shape[-3]
        inside = contains_xy(pts.reshape(*lead, -1, 2), polys)  # (*P, N*V, M)
        inside = inside.reshape(*lead, n, -1, inside.shape[-1])
        return (inside & pm[..., None]).any(dim=-2)

    a_in_b = any_in(va, vam, gb)  # (*P, Ga, Gb)
    b_in_a = any_in(vb, vbm, ga).transpose(-1, -2)  # (*P, Ga, Gb)
    nonempty = vam.any(dim=-1)[..., :, None] & vbm.any(dim=-1)[..., None, :]
    return (cross | a_in_b | b_in_a) & nonempty
