"""Measure ops over :class:`DeviceGeometry` columns (torch).

Port of ``mosaic_tpu/core/geometry/measures.py``: area, length,
centroid, bounds and vertex counts of a whole column, each one batch of
eager torch ops on the column's device (the reference's are one jitted
XLA program each). The ops follow the reference's expression for
expression; a sum over the vertex or ring axis adds in torch's order,
not XLA's, so in float64 a value may differ from the reference's in its
last bits (the function surface holds them to the reference's 1e-9
band).
"""

from __future__ import annotations

import torch

from .device import DeviceGeometry, edges, is_linear, is_polygonal
from .predicates import _sqrt, _sum2, vert_mask

_BIG = 1e30


def _edge_terms(geoms: DeviceGeometry):
    """Edge endpoints + closed/open masks (see device.edges)."""
    p, q, poly_mask, line_mask, _ = edges(geoms)
    return p, q, poly_mask, line_mask


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _where0(mask, x):
    return torch.where(mask, x, _zero(x))


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    """``x`` with zeros replaced by one (a safe divisor)."""
    return torch.where(x == 0, torch.ones_like(x), x)


def signed_ring_areas(geoms: DeviceGeometry) -> torch.Tensor:
    """(G, R) signed shoelace area per ring (CCW positive)."""
    p, q, poly_mask, _ = _edge_terms(geoms)
    cross = p[..., 0] * q[..., 1] - q[..., 0] * p[..., 1]
    return 0.5 * _where0(poly_mask, cross).sum(dim=-1)


def area(geoms: DeviceGeometry) -> torch.Tensor:
    """(G,) polygon area (shells CCW, holes CW: a plain signed sum); 0
    for non-polygonal geometries (JTS getArea semantics)."""
    total = signed_ring_areas(geoms).sum(dim=-1)
    return _where0(is_polygonal(geoms.geom_type), total)


def _seg_len(p, q):
    d = q - p
    return _sqrt(_sum2(d * d))


def _ring_lengths(geoms: DeviceGeometry):
    p, q, poly_mask, line_mask = _edge_terms(geoms)
    seg = _seg_len(p, q)
    return _where0(poly_mask, seg).sum(dim=-1), _where0(line_mask, seg).sum(dim=-1)


def length(geoms: DeviceGeometry) -> torch.Tensor:
    """(G,) perimeter for polygons, length for lines, 0 for points
    (ST_Length and ST_Perimeter both call ``geometry.getLength``)."""
    closed, open_ = _ring_lengths(geoms)
    gt = geoms.geom_type
    line = _where0(is_linear(gt), open_.sum(dim=-1))
    return torch.where(is_polygonal(gt), closed.sum(dim=-1), line)


def centroid(geoms: DeviceGeometry) -> torch.Tensor:
    """(G, 2) centroid. Polygons: area-weighted; lines: length-weighted;
    points: vertex mean. Degenerate (zero-area) polygons fall back to the
    vertex mean, as the host oracle does."""
    p, q, poly_mask, line_mask = _edge_terms(geoms)
    cross = p[..., 0] * q[..., 1] - q[..., 0] * p[..., 1]
    cw = _where0(poly_mask, cross)
    cx = ((p[..., 0] + q[..., 0]) * cw).sum(dim=(-2, -1))
    cy = ((p[..., 1] + q[..., 1]) * cw).sum(dim=(-2, -1))
    a6 = 6.0 * (0.5 * cw.sum(dim=-1)).sum(dim=-1)
    poly_c = torch.stack([cx, cy], dim=-1) / _nonzero(a6)[..., None]

    seg_l = _where0(line_mask, _seg_len(p, q))
    mid = 0.5 * (p + q)
    tot_l = seg_l.sum(dim=(-2, -1))
    line_c = (mid * seg_l[..., None]).sum(dim=(-3, -2)) / _nonzero(tot_l)[..., None]

    vm = vert_mask(geoms)
    cnt = vm.sum(dim=(-2, -1))
    pt_c = _where0(vm[..., None], geoms.verts).sum(dim=(-3, -2)) / _nonzero(cnt)[
        ..., None
    ].to(geoms.verts.dtype)

    poly_c = torch.where((a6 == 0)[:, None], pt_c, poly_c)
    gt = geoms.geom_type
    return torch.where(
        is_polygonal(gt)[:, None],
        poly_c,
        torch.where(is_linear(gt)[:, None], line_c, pt_c),
    )


def bounds(geoms: DeviceGeometry) -> torch.Tensor:
    """(G, 4) [xmin, ymin, xmax, ymax]; NaN for empty geometries (the host
    ``PackedGeometry.bounds`` oracle's rule)."""
    vm = vert_mask(geoms)[..., None]
    v = geoms.verts
    big = torch.full((), _BIG, dtype=v.dtype, device=v.device)
    vmin = torch.where(vm, v, big).amin(dim=(-3, -2))
    vmax = torch.where(vm, v, -big).amax(dim=(-3, -2))
    out = torch.cat([vmin, vmax], dim=-1)
    empty = ~vm.any(dim=-1).any(dim=-1).any(dim=-1)
    return torch.where(empty[:, None], torch.full((), float("nan"), dtype=v.dtype,
                                                  device=v.device), out)


def xmin(geoms: DeviceGeometry) -> torch.Tensor:
    return bounds(geoms)[:, 0]


def ymin(geoms: DeviceGeometry) -> torch.Tensor:
    return bounds(geoms)[:, 1]


def xmax(geoms: DeviceGeometry) -> torch.Tensor:
    return bounds(geoms)[:, 2]


def ymax(geoms: DeviceGeometry) -> torch.Tensor:
    return bounds(geoms)[:, 3]


def num_points(geoms: DeviceGeometry) -> torch.Tensor:
    """(G,) int32 vertex count (closing vertices counted for polygon rings,
    JTS getNumPoints on closed rings)."""
    closing = (geoms.ring_len > 0) & is_polygonal(geoms.geom_type)[:, None]
    return (geoms.ring_len + closing.to(torch.int32)).sum(dim=-1, dtype=torch.int32)


def point_xy(geoms: DeviceGeometry) -> torch.Tensor:
    """(G, 2) the coordinate of POINT geometries (first vertex otherwise)."""
    return geoms.verts[:, 0, 0, :]
