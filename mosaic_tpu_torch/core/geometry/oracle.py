"""Host (numpy, float64) oracle helpers of geometry ops.

Port of the part of ``mosaic_tpu/core/geometry/oracle.py`` that the
port's callers use: the ring walk :func:`_rings`, which
`runtime/quarantine.py degenerate_zone_mask` reads. The measures and
predicates of that module come with ROADMAP queue 1 item 14.
"""

from __future__ import annotations

from ..types import PackedGeometry


def _rings(col: PackedGeometry, g: int):
    """Yield ``(k, (V, 2) xy)`` for every ring of geometry ``g``: ``k`` is
    the ring's index within its part (0 = outer ring)."""
    for p in col.geom_parts(g):
        for k, r in enumerate(col.part_rings(p)):
            yield k, col.ring_xy(r)
