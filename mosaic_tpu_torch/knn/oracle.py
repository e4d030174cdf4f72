"""Brute-force f64 host oracle for served KNN — bit-identical to the
device path by construction.

Port of ``mosaic_tpu/knn/oracle.py`` (host numpy, unchanged). The device
program evaluates `functions.geometry._distance_dense` on the
shifted candidate column: three masked squared-distance terms
(vertex→segment both ways, vertex→vertex), ONE ``sqrt`` at the end, and
a containment override to 0 via even-odd ray crossing
(`core/geometry/predicates.py`). This module mirrors those exact
expressions in numpy f64 over the :class:`~mosaic_tpu_torch.knn.index.
HostCandidates` twin — same shifted frame, same operation order — the
`sql.join.HostRecheck` idiom that lets serve tests assert
``assert_array_equal`` (not allclose) against the oracle.

A query is a POINT column row on device: its ring contributes no edges
(`device.edges` type mask), so only the vertex(query)→segment(candidate)
and vertex→vertex terms are live, and containment reduces to the parity
test of the query point against the candidate's closed polygon rings.
"""

from __future__ import annotations

import numpy as np

_BIG = 1e30


def _point_seg_dist2(p: np.ndarray, a: np.ndarray, b: np.ndarray):
    """numpy twin of `predicates._point_seg_dist2` (squared distance
    from point ``p`` (2,) to segments (a, b) (E, 2))."""
    ab = b - a
    ap = p - a
    denom = np.sum(ab * ab, axis=-1)
    t = np.sum(ap * ab, axis=-1) / np.where(denom == 0, 1.0, denom)
    t = np.clip(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    d = p - proj
    return np.sum(d * d, axis=-1)


def _contains(p: np.ndarray, poly_edges) -> bool:
    """numpy twin of `predicates.crossing_number` parity (even-odd)."""
    if poly_edges is None:
        return False
    a, b = poly_edges
    if not a.shape[0]:
        return False
    px, py = p[0], p[1]
    ay, by = a[:, 1], b[:, 1]
    ax, bx = a[:, 0], b[:, 0]
    straddle = (ay > py) != (by > py)
    denom = by - ay
    denom = np.where(denom == 0, 1.0, denom)
    xcross = ax + (py - ay) * (bx - ax) / denom
    hit = straddle & (px < xcross)
    return (int(hit.sum()) & 1) == 1


def host_distance(qs: np.ndarray, host, g: int) -> float:
    """Exact f64 distance from ONE shifted query point to candidate
    ``g`` — the same value (same bits) the device pair program
    computes."""
    ea, eb = host.edges[g]
    if ea.shape[0]:
        d_ab = float(np.min(_point_seg_dist2(qs, ea, eb)))
    else:
        d_ab = _BIG
    v = host.verts[g]
    if v.shape[0]:
        dv = float(np.min(np.sum((qs - v) ** 2, axis=-1)))
    else:
        dv = _BIG
    d = np.sqrt(min(d_ab, dv))
    if _contains(qs, host.poly_edges[g]):
        return 0.0
    return float(d)


def host_pair_distances(
    qs: np.ndarray, kx, qi: np.ndarray, ci: np.ndarray
) -> np.ndarray:
    """(P,) exact f64 distances for (query, candidate) pairs —
    ``qs`` are SHIFTED query coordinates (``raw - kx.shift``). The
    frontend's degradation fallback and the walk-bound evaluator."""
    out = np.empty(qi.shape[0], dtype=np.float64)
    for p in range(qi.shape[0]):
        out[p] = host_distance(qs[qi[p]], kx.host, int(ci[p]))
    return out


def _segment_min(values: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per segment (consecutive runs of ``counts``) the min of
    ``values``, ``_BIG`` for an empty segment."""
    out = np.full(counts.shape[0], _BIG)
    nz = counts > 0
    if values.size:
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        out[nz] = np.minimum.reduceat(values, starts[nz])
    return out


def _flat_twin(host):
    """Every candidate's edges, vertices and polygon edges concatenated
    in candidate order, with per-candidate counts (cached on ``host``)."""
    flat = getattr(host, "_flat", None)
    if flat is None:
        def cat(parts, width=2):
            return np.concatenate(parts) if parts else np.zeros((0, width))

        poly = [pe if pe is not None else (np.zeros((0, 2)), np.zeros((0, 2)))
                for pe in host.poly_edges]
        flat = {
            "ea": cat([e[0] for e in host.edges]), "eb": cat([e[1] for e in host.edges]),
            "ne": np.asarray([e[0].shape[0] for e in host.edges], dtype=np.int64),
            "v": cat(host.verts),
            "nv": np.asarray([v.shape[0] for v in host.verts], dtype=np.int64),
            "pa": cat([e[0] for e in poly]), "pb": cat([e[1] for e in poly]),
            "np": np.asarray([e[0].shape[0] for e in poly], dtype=np.int64),
        }
        host._flat = flat
    return flat


def _all_distances(qs: np.ndarray, host) -> np.ndarray:
    """(m,) exact distances from one shifted query to every candidate:
    :func:`host_distance` of each, its elementwise expressions evaluated
    over all candidates' edges at once (the same bits: each element is
    the same IEEE operations, and the minima are exact)."""
    f = _flat_twin(host)
    d_ab = _segment_min(_point_seg_dist2(qs, f["ea"], f["eb"]), f["ne"])
    dv = _segment_min(np.sum((qs - f["v"]) ** 2, axis=-1), f["nv"])
    d = np.sqrt(np.minimum(d_ab, dv))
    # even-odd parity against each candidate's closed polygon rings
    a, b = f["pa"], f["pb"]
    px, py = qs[0], qs[1]
    ay, by = a[:, 1], b[:, 1]
    ax, bx = a[:, 0], b[:, 0]
    straddle = (ay > py) != (by > py)
    denom = by - ay
    denom = np.where(denom == 0, 1.0, denom)
    xcross = ax + (py - ay) * (bx - ax) / denom
    hit = (straddle & (px < xcross)).astype(np.int64)
    counts = f["np"]
    hits = np.zeros(counts.shape[0], dtype=np.int64)
    nz = counts > 0
    if hit.size:
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        hits[nz] = np.add.reduceat(hit, starts[nz])
    return np.where((hits & 1) == 1, 0.0, d)


def brute_force_knn(queries: np.ndarray, kx, k: int):
    """Exhaustive exact top-k over ALL candidates per query.

    Returns ``(ids (n, k) int64, dist (n, k) f64)`` ranked by
    ``(distance, candidate_id)`` lexicographically — the tie rule the
    served merge uses, so on tie-free data this equals batch
    `SpatialKNN` bit-for-bit. Unfilled slots (k > candidates) hold
    ``-1`` / ``inf``. The reference loops :func:`host_distance` over the
    candidates; here one query's distances to all of them are one
    vectorized pass (:func:`_all_distances`, the same values).
    """
    q = np.asarray(queries, dtype=np.float64)
    n, m = q.shape[0], kx.n
    qs = q - kx.shift
    ids = np.full((n, k), -1, dtype=np.int64)
    dist = np.full((n, k), np.inf)
    kk = min(k, m)
    for i in range(n):
        d = _all_distances(qs[i], kx.host)
        order = np.lexsort((np.arange(m), d))[:kk]
        ids[i, :kk] = order
        dist[i, :kk] = d[order]
    return ids, dist
