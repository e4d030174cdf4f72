"""Pre-admission input validation: poisoned rows go to quarantine, not
into the device fold.

Port of ``mosaic_tpu/runtime/quarantine.py``: host numpy throughout, the
same reasons, report and park-point search.

Long-running million-user streams always contain garbage — NaN/Inf
coordinates from upstream parsers, points outside the CRS's valid
domain, degenerate or self-intersecting polygons. Any of these inside
the streaming loop silently corrupts the (checksum, matches,
overflow) fold (NaN comparisons are all-false, so a NaN point "misses"
today — until a kernel change turns it into a poisoned parity). The
adaptive-joins lesson (PAPERS.md): treat bad inputs as a first-class
*output lane*, not a crash.

Point-side: :func:`scrub_points` flags, per batch, rows that are
non-finite or outside the declared CRS bounds. Admission
(``StreamJoin.admit``) replaces flagged rows with the stream's *park
point* — a coordinate proven at admission time to hit no indexed cell,
so a parked row returns -1 and contributes exactly zero to every fold
statistic (the checksum term ``x ^ (x >> 16)`` of -1 is 0; -1 is
neither a match nor an overflow). Admitted rows are never touched —
the bit-identity contract in tests/test_torch_stream_faults.py.

Zone-side: :func:`degenerate_zone_mask` asks the existing f64 host
oracle machinery (ring extraction + signed area) which polygons are
degenerate (non-finite vertices, < 3-vertex rings, ~zero area) or
self-intersecting (exact segment-pair test per ring) — callers drop or
quarantine those before tessellation ever sees them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import telemetry

#: validation flag names, in priority order (a row gets ONE reason: the
#: first that applies)
REASONS = ("nonfinite", "out_of_bounds")


@dataclasses.dataclass
class QuarantineReport:
    """Everything the stream knows about rows it refused to admit.

    ``rows`` holds (batch, row) coordinates of every quarantined row;
    ``buffer`` the raw offending values (for offline triage — the
    device never sees them); ``reasons`` the per-reason counts.
    """

    n_scanned: int = 0
    n_quarantined: int = 0
    reasons: dict = dataclasses.field(
        default_factory=lambda: {r: 0 for r in REASONS}
    )
    rows: list = dataclasses.field(default_factory=list)
    buffer: np.ndarray | None = None

    def merge_batch(
        self, batch_index: int, raw: np.ndarray, bad: np.ndarray,
        reasons: dict,
    ) -> None:
        self.n_scanned += int(raw.shape[0])
        nq = int(bad.sum())
        if not nq:
            return
        self.n_quarantined += nq
        for k, v in reasons.items():
            self.reasons[k] = self.reasons.get(k, 0) + int(v)
        idx = np.nonzero(bad)[0]
        self.rows.extend((int(batch_index), int(r)) for r in idx)
        chunk = np.array(raw[idx], dtype=np.float64, copy=True)
        self.buffer = (
            chunk
            if self.buffer is None
            else np.concatenate([self.buffer, chunk])
        )

    def metrics(self) -> dict:
        return {
            "quarantined": self.n_quarantined,
            "quarantine_scanned": self.n_scanned,
            "quarantine_reasons": {
                k: v for k, v in self.reasons.items() if v
            },
        }


def scrub_points(
    batch: np.ndarray, bounds: tuple | None = None
) -> tuple[np.ndarray, dict]:
    """(bad_mask (N,), per-reason counts) for one (N, 2) point batch.

    ``bounds`` is (xmin, ymin, xmax, ymax) — the CRS/domain box; rows
    outside it are quarantined (None skips the bounds check). The input
    is never mutated.
    """
    pts = np.asarray(batch, dtype=np.float64)
    nonfinite = ~np.isfinite(pts).all(axis=1)
    bad = nonfinite.copy()
    reasons = {"nonfinite": int(nonfinite.sum())}
    if bounds is not None:
        xmin, ymin, xmax, ymax = (float(b) for b in bounds)
        with np.errstate(invalid="ignore"):
            oob = ~bad & (
                (pts[:, 0] < xmin) | (pts[:, 0] > xmax)
                | (pts[:, 1] < ymin) | (pts[:, 1] > ymax)
            )
        reasons["out_of_bounds"] = int(oob.sum())
        bad |= oob
    return bad, reasons


def _ring_self_intersects(xy: np.ndarray) -> bool:
    """Exact host test: does closed ring ``xy`` (first vertex NOT
    repeated) properly self-intersect? Adjacent edges share an endpoint
    by construction and are excluded; everything else is the standard
    orientation/straddle test, f64."""
    n = xy.shape[0]
    if n < 4:  # a triangle cannot properly self-intersect
        return False
    a = xy
    b = np.roll(xy, -1, axis=0)  # edge i: a[i] -> b[i]
    i, j = np.triu_indices(n, k=2)
    # edge (n-1, 0) is adjacent to edge 0: drop that pair
    keep = ~((i == 0) & (j == n - 1))
    i, j = i[keep], j[keep]

    def orient(p, q, r):
        return (q[:, 0] - p[:, 0]) * (r[:, 1] - p[:, 1]) - (
            q[:, 1] - p[:, 1]
        ) * (r[:, 0] - p[:, 0])

    p1, q1 = a[i], b[i]
    p2, q2 = a[j], b[j]
    d1 = orient(p1, q1, p2)
    d2 = orient(p1, q1, q2)
    d3 = orient(p2, q2, p1)
    d4 = orient(p2, q2, q1)
    proper = (
        (np.sign(d1) * np.sign(d2) < 0) & (np.sign(d3) * np.sign(d4) < 0)
    )
    return bool(proper.any())


def degenerate_zone_mask(
    col, *, min_area: float = 0.0, check_self_intersection: bool = True
) -> tuple[np.ndarray, dict]:
    """(mask (G,), reasons) — True per polygon the host oracle rejects.

    Uses the oracle's own ring walk (`core/geometry/oracle._rings`) and
    `ring_signed_area`: a zone is degenerate when any vertex is
    non-finite, its outer area is <= ``min_area``, a ring has fewer
    than 3 vertices, or (``check_self_intersection``) any ring properly
    self-intersects. Non-polygonal rows pass (they are someone else's
    contract to validate).
    """
    from ..core.geometry.oracle import _rings
    from ..core.types import GeometryType, ring_signed_area

    g_n = len(col)
    mask = np.zeros(g_n, dtype=bool)
    reasons = {
        "nonfinite": 0, "tiny_area": 0, "short_ring": 0,
        "self_intersecting": 0,
    }
    for g in range(g_n):
        if col.geometry_type(g).base != GeometryType.POLYGON:
            continue
        tot = 0.0
        why = None
        for k, xy in _rings(col, g):
            if not np.isfinite(xy).all():
                why = "nonfinite"
                break
            if xy.shape[0] < 3:
                why = "short_ring"
                break
            if k == 0:
                tot += abs(ring_signed_area(xy))
            if check_self_intersection and _ring_self_intersects(xy):
                why = "self_intersecting"
                break
        if why is None and tot <= min_area:
            why = "tiny_area"
        if why is not None:
            mask[g] = True
            reasons[why] += 1
    if mask.any():
        telemetry.record(
            "zones_quarantined", n=int(mask.sum()),
            of=g_n, reasons={k: v for k, v in reasons.items() if v},
        )
    return mask, reasons


def find_park_point(
    assign, index_cells: np.ndarray, bounds: tuple
) -> np.ndarray:
    """A finite (2,) point whose assigned cell is NOT in the index —
    the guaranteed-miss filler quarantined rows are parked on (a parked
    row returns -1 and adds zero to every fold statistic).

    ``assign`` maps an (N, 2) array to (N,) cell ids (the stream's own
    assign, returning numpy); candidates walk outward from the bounds
    corners until one lands in an unindexed cell.
    """
    xmin, ymin, xmax, ymax = (float(b) for b in bounds)
    w, h = max(xmax - xmin, 1.0), max(ymax - ymin, 1.0)
    cand = []
    for m in (0.25, 0.5, 1.0, 2.0, 4.0, 8.0):
        cand += [
            (xmax + m * w, ymax + m * h),
            (xmin - m * w, ymin - m * h),
            (xmax + m * w, ymin - m * h),
            (xmin - m * w, ymax + m * h),
        ]
    cand = np.asarray(cand, dtype=np.float64)
    # the one device round-trip in the quarantine path — timed so park
    # searches show up in trails (and attach to the admitting span)
    with telemetry.timed(
        "quarantine_stage", stage="park_search", candidates=len(cand),
    ):
        cells = np.asarray(assign(cand))
    indexed = np.isin(cells, np.asarray(index_cells))
    ok = np.nonzero(~indexed & np.isfinite(cand).all(axis=1))[0]
    if ok.size == 0:
        raise ValueError(
            "quarantine: no park point found — every candidate cell "
            "around the bounds is indexed; pass an explicit park="
        )
    return cand[ok[0]]
