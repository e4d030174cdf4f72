"""Row-pair geometry programs on the device (torch).

Port of the part of ``mosaic_tpu/functions/geometry.py`` that KNN and
the sharded overlay predicate run: :func:`_pair_pack` (two columns on
one shared f64 shift), :func:`_vmap_pair` (a dense ``(Ga, Gb)``
predicate evaluated on aligned row pairs), :func:`_contains_dense` and
:func:`_distance_dense`; and the two fused overlay frontends,
:func:`st_intersection_area` and :func:`st_overlap_fraction`, whose
keyword options (``prep=``, ``pair_cap=``, ``mesh=``, ``lane=``,
``device=``) pass through to `sql.overlay.overlay_measures`. The
reference maps its dense functions over pairs with ``jax.vmap``; here
the dense functions of `core/geometry/predicates.py` take a leading pair
axis, so :func:`_vmap_pair` is one batch of eager torch ops.

The device dtype is float64, the reference's under ``jax_enable_x64``:
the KNN answers are held bit for bit against the f64 host oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.geometry import predicates as _pred
from ..core.geometry.device import DeviceGeometry, pack_to_device
from ..core.types import PackedGeometry

#: the device dtype of pair programs
DEVICE_DTYPE = torch.float64


def _translate(col: PackedGeometry, dx: float, dy: float) -> PackedGeometry:
    """The column moved by (dx, dy), the reference's ``affine.translate``
    (``xy += d``)."""
    xy = col.xy.copy()
    xy[:, 0] += dx
    xy[:, 1] += dy
    return PackedGeometry(
        xy=xy, ring_offsets=col.ring_offsets, part_offsets=col.part_offsets,
        geom_offsets=col.geom_offsets, geom_type=col.geom_type, srid=col.srid,
        z=col.z, geom_has_z=col.geom_has_z,
    )


def _pair_pack(a: PackedGeometry, b: PackedGeometry, device=None):
    """Pack two columns with one shared shift (the midpoint of their
    joint finite bounds) so coordinates line up."""
    allb = np.concatenate([a.bounds(), b.bounds()], axis=0)
    finite = allb[np.isfinite(allb[:, 0])]
    if finite.size:
        shift = (finite[:, :2].min(axis=0) + finite[:, 2:].max(axis=0)) / 2.0
    else:
        shift = np.zeros(2)
    da = pack_to_device(_translate(a, -shift[0], -shift[1]), dtype=DEVICE_DTYPE,
                        device=device)
    db = pack_to_device(_translate(b, -shift[0], -shift[1]), dtype=DEVICE_DTYPE,
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


def st_intersection_area(geom_a, geom_b, index_system, resolution, **kw):
    """Fused overlay join: per intersecting (left, right) geometry pair,
    the exact intersection AREA — `sql.overlay.overlay_measures` with the
    raw `expr.ast.overlap_area` tree. Keyword options (``prep=``,
    ``pair_cap=``, ``mesh=``, ``lane=``, ``device=``) pass through;
    returns `sql.overlay.OverlayMeasures`."""
    from ..sql.overlay import overlay_measures
    from ._coerce import to_packed

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
    from ._coerce import to_packed

    return overlay_measures(
        to_packed(geom_a), to_packed(geom_b), index_system, resolution,
        overlap_fraction(), **kw,
    )
