"""Polygon-polygon overlay join: device candidates + fused overlap measures.

Port of ``mosaic_tpu/sql/overlay.py``. Reference analog: the BNG overlay
workload (`notebooks/examples/python/BritishNationalGrid.py`) — both
polygon tables are tessellated into grid chips, the equi-join on cell id
produces candidate pairs, and the exact work runs only on pairs whose
chips are both border chips (a core chip covers its whole cell, so any
other geometry touching that cell intersects it by construction).

Two lanes share one contract:

- **Device lane** (:func:`overlay_measures`): both chip tables are sorted
  by int64 cell id once (:func:`prepare_overlay`, amortized like the chip
  index build), candidate generation runs on the device as a sorted
  segment equi-join (`kernels.overlay.pair_count` / `emit_pairs`) against
  a static pair bucket, and the overlap measures — per-pair intersection
  area via batched Sutherland–Hodgman clip, folded per geometry pair by
  the fold lane (on the card the ``zonal_seq_fold`` CUDA kernel), with an
  `expr/` pair tree evaluated over the folded tables — run as ONE fused
  program per ``(tree-hash, buckets, index)`` signature, under
  ``guarded_call`` (watchdog, transient retry) and the expression
  compiler's warmup tripwire. Near-degenerate clip areas (inside the
  ``EDGE_BAND_K·eps(acc)·scale²`` band), non-convex windows,
  multi-ring/over-pad chips and spills are re-answered by the f64 host
  lane per WHOLE geometry pair.
- **Host lane** (`expr.host_oracle.host_overlay_measures`): the numpy twin
  of the same kernels (``xp=np``) — the pure-f64 oracle the device lane
  must match bit for bit, and, on the CPU, the degradation target when
  the device path fails.

What differs from the reference: the accelerated dtype is always f64
(the reference folds in f32 without x64, i.e. on its TPU; the card
computes f64 natively), so the device lane equals the host lane bit for
bit on the card as on the CPU. Past the retry budget (or on any device
error) only a call on the CPU degrades to the host lane; on the card the
error propagates. ``mesh=`` (or the ``MOSAIC_MESH`` knob) shards the
per-pair stage over a `parallel.mesh.Mesh` and gathers its outputs
before the f64 fold (`expr.compile.overlay_program`), so the measures are
the single-device bits. :func:`intersects_join` has no ``backend=``: its exact f64
predicate runs batched on the entry point's device (the reference's
default is its host oracle; its device predicate is f32).

Caps are full-bucket and structural: when the candidate count exceeds
``pair_cap`` (or the top pair bucket), the emission truncates and the
result carries an OVERFLOW(-2) pair row — never a silent wrong answer,
never an escalation.

The boolean `ST_Intersects` join (:func:`intersects_join`) keeps its host
columnar candidate generator, deduplicated by geometry pair
(core-beats-border precedence) so a pair sharing N cells is emitted once,
and refines the undecided pairs with the exact f64 predicate, batched on
the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..core.geometry.oracle import pair_intersects
from ..core.index.base import IndexSystem
from ..core.tessellate import ChipTable, _dedupe_boundaries_batch, tessellate
from ..core.types import GeometryType, PackedGeometry
from ..dispatch import core as _dispatch
from ..dispatch.bucket import BucketLadder
from ..kernels import overlay as _k
from ..obs import trace as _trace
from ..runtime import telemetry as _telemetry
from ..runtime.errors import DegradedResult
from .join import EDGE_BAND_K, OVERFLOW

__all__ = [
    "MAX_CHIP_VERTS",
    "OverlayMeasures",
    "OverlayPrep",
    "OverlaySide",
    "candidate_pairs",
    "chip_candidate_rows",
    "intersects_join",
    "overlay_join",
    "overlay_measures",
    "pair_glue",
    "pair_plan",
    "prepare_overlay",
    "warmup_overlay",
]

#: vertex pad ceiling for device-clippable chips — a border chip whose
#: outer ring needs more vertices is routed to the f64 host lane (the
#: pad enters the program signature, so it must stay small and stable)
MAX_CHIP_VERTS = 32

#: candidate-pair bucket ladder: min 8 so tiny caps exercise OVERFLOW
#: semantics without a dedicated program population, top bucket 4M pairs
PAIR_LADDER = BucketLadder(min_bucket=8, max_bucket=1 << 22)

#: sorted side-table ladder (chip rows) and geometry-pair segment ladder
TABLE_LADDER = BucketLadder(min_bucket=64, max_bucket=1 << 21)
SEG_LADDER = BucketLadder(min_bucket=64, max_bucket=1 << 21)

#: the accelerated fold dtype: f64 on every device the port runs on
ACC_NAME = "float64"

#: the tessellation clipper's on-edge tolerance (`core.tessellate._EPS`),
#: which the exact intersects predicate reads
_SEG_EPS = 1e-12


def pair_plan(total: int, pair_cap: int | None = None):
    """``(Pb, emit_limit, overflow)`` for a candidate count — full-bucket
    cap semantics: emission truncates at ``min(total, pair_cap, top
    bucket)`` and the remainder is booked as structural OVERFLOW."""
    total = int(total)
    cap = PAIR_LADDER.max_bucket if pair_cap is None else int(pair_cap)
    emit_limit = min(total, cap, PAIR_LADDER.max_bucket)
    Pb = PAIR_LADDER.bucket_for(max(emit_limit, 1))
    return Pb, emit_limit, total - emit_limit


# ------------------------------------------------ host candidate columns


def _group_spans(cells_sorted: np.ndarray):
    """(uniq, start, stop) run-length spans of a sorted int64 array."""
    if not cells_sorted.shape[0]:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
        )
    change = np.nonzero(np.diff(cells_sorted))[0] + 1
    start = np.concatenate([[0], change])
    stop = np.concatenate([change, [cells_sorted.shape[0]]])
    return cells_sorted[start], start, stop


def chip_candidate_rows(
    left: ChipTable, right: ChipTable
) -> tuple[np.ndarray, np.ndarray]:
    """Raw chip-row candidate pairs sharing a cell (host columnar set
    algebra). A geometry pair sharing N cells appears N times here — the
    per-shared-cell stream the area fold consumes; use
    :func:`candidate_pairs` for the deduplicated geometry-pair view."""
    lc = np.asarray(left.cell_id)
    rc = np.asarray(right.cell_id)
    lo = np.argsort(lc, kind="stable")
    ro = np.argsort(rc, kind="stable")
    lu, ls, le_ = _group_spans(lc[lo])
    ru, rs, re_ = _group_spans(rc[ro])
    common, li, ri = np.intersect1d(lu, ru, return_indices=True)
    if not common.shape[0]:
        z = np.zeros(0, np.int64)
        return z, z
    # vectorized per-cell cross join: left rows repeat by the right
    # group size, right rows tile within each (cell, left-row) block
    ln = le_[li] - ls[li]  # left group size per common cell
    rn = re_[ri] - rs[ri]  # right group size per common cell
    pair_n = ln * rn
    cell_of = np.repeat(np.arange(common.shape[0]), pair_n)
    off = np.concatenate([[0], np.cumsum(pair_n)])[:-1]
    k = np.arange(int(pair_n.sum())) - off[cell_of]  # rank within cell
    lrows = lo[ls[li][cell_of] + k // rn[cell_of]]
    rrows = ro[rs[ri][cell_of] + k % rn[cell_of]]
    return lrows, rrows


def _dedup_pairs(left: ChipTable, right: ChipTable,
                 lrows: np.ndarray, rrows: np.ndarray):
    """Chip-row candidates → unique geometry pairs with core-beats-border
    precedence: ``sure[p]`` is True when ANY shared cell of pair ``p``
    has a core chip on either side (intersection certain there, no
    predicate needed anywhere for the pair)."""
    lgeom = np.asarray(left.geom_id)[lrows]
    rgeom = np.asarray(right.geom_id)[rrows]
    either = (
        np.asarray(left.is_core)[lrows] | np.asarray(right.is_core)[rrows]
    )
    uniq, pair_id = np.unique(
        np.stack([lgeom, rgeom], axis=-1), axis=0, return_inverse=True
    )
    sure = np.zeros(uniq.shape[0], bool)
    np.logical_or.at(sure, pair_id, either)
    return uniq, pair_id, either, sure


def _candidate_stats(span, sure: np.ndarray) -> None:
    """Record the profileable candidate statistics (deduplicated
    geometry-pair counts) on the span and the telemetry stream."""
    n = int(sure.shape[0])
    sure_fraction = float(sure.sum()) / max(1, n)
    stats = {
        "candidates": n,
        "sure_fraction": round(sure_fraction, 6),
        "border_fraction": round(1.0 - sure_fraction, 6),
    }
    span.set(**stats)
    _telemetry.record("overlay_candidates", **stats)


def candidate_pairs(
    left: ChipTable, right: ChipTable
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deduplicated geometry-pair candidates sharing at least one cell.

    Returns ``(lgeom, rgeom, sure)`` — one row per (left geometry, right
    geometry) pair regardless of how many cells the pair shares, with
    ``sure`` True where some shared cell has a core chip on either side
    (core beats border: the pair is accepted without a predicate).

    Emits an ``overlay.candidates`` span (and matching
    ``overlay_candidates`` telemetry) with the candidate count, the
    sure-fraction (pairs accepted without a predicate), and the
    border-pair fraction (pairs that will pay exact work) — the
    statistics that make overlay workloads profileable like the point
    frontends.
    """
    with _trace.span(
        "overlay.candidates",
        left_chips=int(np.asarray(left.cell_id).shape[0]),
        right_chips=int(np.asarray(right.cell_id).shape[0]),
    ) as span:
        lrows, rrows = chip_candidate_rows(left, right)
        if not lrows.shape[0]:
            _candidate_stats(span, np.zeros(0, bool))
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, bool)
        uniq, _, _, sure = _dedup_pairs(left, right, lrows, rrows)
        _candidate_stats(span, sure)
        return uniq[:, 0], uniq[:, 1], sure


def _pad(rows: list, width: int):
    """(G, width, 2) f64 and (G, width) bool from per-row (n, 2) arrays."""
    out = np.zeros((len(rows), max(width, 1), 2), np.float64)
    mask = np.zeros((len(rows), max(width, 1)), bool)
    for g, r in enumerate(rows):
        out[g, : r.shape[0]] = r
        mask[g, : r.shape[0]] = True
    return out, mask


def _cross(o, d, p):
    """cross(d, p - o) for every (edge, point) pair of each row: o, d
    (G, E, 2), p (G, F, 2) → (G, E, F) — `core.tessellate._segments_cross`'s
    ``cross``, op for op."""
    return d[:, :, None, 0] * (p[:, None, :, 1] - o[:, :, None, 1]) - d[
        :, :, None, 1
    ] * (p[:, None, :, 0] - o[:, :, None, 0])


def _on_seg(o, d, p, c):
    lo = torch.minimum(o, o + d)
    hi = torch.maximum(o, o + d)
    inside = (
        (p[:, None, :, 0] >= lo[:, :, None, 0] - _SEG_EPS)
        & (p[:, None, :, 0] <= hi[:, :, None, 0] + _SEG_EPS)
        & (p[:, None, :, 1] >= lo[:, :, None, 1] - _SEG_EPS)
        & (p[:, None, :, 1] <= hi[:, :, None, 1] + _SEG_EPS)
    )
    return (torch.abs(c) <= _SEG_EPS) & inside


def _segments_touch(a0, a1, am, b0, b1, bm):
    """(G,) any edge of a crossing or touching any edge of b, each row —
    `_segments_cross` batched over rows and masked to the real edges."""
    da, db = a1 - a0, b1 - b0
    d1, d2 = _cross(a0, da, b0), _cross(a0, da, b1)
    d3, d4 = _cross(b0, db, a0), _cross(b0, db, a1)  # (G, F, E)
    t3, t4 = d3.transpose(1, 2), d4.transpose(1, 2)
    e = _SEG_EPS
    proper = ((d1 > e) != (d2 > e)) & ((t3 > e) != (t4 > e)) & (
        (d1 < -e) != (d2 < -e)) & ((t3 < -e) != (t4 < -e))
    touch = (_on_seg(a0, da, b0, d1) | _on_seg(a0, da, b1, d2)
             | _on_seg(b0, db, a0, d3).transpose(1, 2)
             | _on_seg(b0, db, a1, d4).transpose(1, 2))
    hit = (proper | touch) & am[:, :, None] & bm[:, None, :]
    return hit.flatten(1).any(dim=1)


def _even_odd_any(pts, pm, e0, e1, em):
    """(G,) any real point of a row inside the row's even-odd edge soup —
    `core.tessellate._even_odd_edges`, op for op."""
    px, py = pts[:, :, None, 0], pts[:, :, None, 1]
    ay, by = e0[:, None, :, 1], e1[:, None, :, 1]
    straddle = (ay > py) != (by > py)
    denom = by - ay
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    xc = e0[:, None, :, 0] + (py - ay) * (e1[:, None, :, 0] - e0[:, None, :, 0]) / denom
    n = (straddle & (px < xc) & em[:, None, :]).sum(dim=2)
    return (((n & 1) == 1) & pm).any(dim=1)


def _device_pair_intersects(a: PackedGeometry, b: PackedGeometry, dev) -> np.ndarray:
    """(G,) bool row-wise intersects on ``dev`` in f64: the exact
    predicate of `core.geometry.oracle.pair_intersects` (any boundary
    crossing or touch, else any vertex of one inside the other polygon),
    batched over rows with every edge pair of a row at once, in chunks of
    bounded size. The same IEEE f64 ops in the same order, so it answers
    as the oracle does."""
    from ..core.geometry.oracle import _edges_of, _rings_of

    G = len(a)
    cols = {k: [] for k in ("a0", "a1", "b0", "b1", "pa", "pb",
                            "ia0", "ia1", "ib0", "ib1")}
    poly_a = np.zeros(G, bool)
    poly_b = np.zeros(G, bool)
    for g in range(G):
        ra, rb = _rings_of(a, g), _rings_of(b, g)
        poly_a[g] = a.geometry_type(g).base == GeometryType.POLYGON
        poly_b[g] = b.geometry_type(g).base == GeometryType.POLYGON
        for k, (e0, e1) in (("a", _edges_of(ra, bool(poly_a[g]))),
                            ("b", _edges_of(rb, bool(poly_b[g])))):
            cols[k + "0"].append(e0)
            cols[k + "1"].append(e1)
        cols["pa"].append(a.geom_xy(g))
        cols["pb"].append(b.geom_xy(g))
        for k, rings in (("ia", ra), ("ib", rb)):
            closed = [r for r in rings if r.shape[0] >= 3]
            cols[k + "0"].append(np.concatenate(closed) if closed else np.zeros((0, 2)))
            cols[k + "1"].append(np.concatenate([np.roll(r, -1, axis=0) for r in closed])
                                 if closed else np.zeros((0, 2)))
    width = {k: max((r.shape[0] for r in v), default=0) for k, v in cols.items()}
    out = np.zeros(G, bool)
    per_row = max(1, max(width["a0"], 1) * max(width["b0"], 1)
                  + max(width["pb"], 1) * max(width["ia0"], 1)
                  + max(width["pa"], 1) * max(width["ib0"], 1))
    step = max(1, (1 << 22) // per_row)
    for s0 in range(0, G, step):
        sl = slice(s0, min(G, s0 + step))
        t = {}
        for k, v in cols.items():
            arr, m = _pad(v[sl], width[k])
            t[k] = torch.from_numpy(arr).to(dev)
            t[k + "m"] = torch.from_numpy(m).to(dev)
        crossed = _segments_touch(t["a0"], t["a1"], t["a0m"], t["b0"], t["b1"], t["b0m"])
        in_a = _even_odd_any(t["pb"], t["pbm"], t["ia0"], t["ia1"], t["ia0m"])
        in_b = _even_odd_any(t["pa"], t["pam"], t["ib0"], t["ib1"], t["ib0m"])
        pa_ok = torch.from_numpy(poly_a[sl]).to(dev)
        pb_ok = torch.from_numpy(poly_b[sl]).to(dev)
        some = t["pam"].any(dim=1) & t["pbm"].any(dim=1)
        hit = some & (crossed | (pa_ok & in_a) | (pb_ok & in_b))
        out[sl] = hit.cpu().numpy()
    return out


def intersects_join(
    left: PackedGeometry,
    right: PackedGeometry,
    index_system: IndexSystem,
    resolution: int,
    left_chips: ChipTable | None = None,
    right_chips: ChipTable | None = None,
    backend: str = "device",
    device=None,
) -> np.ndarray:
    """(P, 2) int64 — distinct (left_row, right_row) pairs that intersect.

    Both sides tessellate at ``resolution`` (pass prebuilt chip tables to
    amortize); pairs sharing a cell where either chip is core are accepted
    without a predicate, the rest run one row-wise exact intersects over
    the border-chip geometry pairs (chips are clipped to their cell, so
    chip-level intersection within a shared cell is exact for the
    geometry-level predicate) under ``guarded_call`` at the
    ``overlay.predicate`` site.

    ``backend="device"`` (the default; the reference's is ``"oracle"``)
    batches the predicate on ``device`` (the card unless ``device="cpu"``)
    in f64; it answers as the host oracle
    `core.geometry.oracle.pair_intersects` does. Past the retry budget a
    call on the CPU degrades to that oracle (the result is a flagged
    ``DegradedResult``); on the card it raises. ``backend="oracle"`` (or
    ``"native"``, as in the reference) runs that f64 host oracle itself,
    with no fallback. Any other value raises ``ValueError``.

    Known degenerate case (cell-equality joins generally, including the
    reference's): a pair whose intersection has zero area and lies
    EXACTLY on a cell boundary of an axis-aligned grid (BNG/CUSTOM) can
    tessellate into disjoint cell sets and produce no candidate.
    """
    if backend not in ("device", "oracle", "native"):
        raise ValueError(
            f"backend must be 'device', 'oracle' or 'native', got {backend!r}"
        )
    dev = resolve_device(device) if backend == "device" else None
    lt = (
        left_chips
        if left_chips is not None
        else tessellate(left, index_system, resolution)
    )
    rt = (
        right_chips
        if right_chips is not None
        else tessellate(right, index_system, resolution)
    )
    with _trace.span(
        "overlay.candidates",
        left_chips=int(np.asarray(lt.cell_id).shape[0]),
        right_chips=int(np.asarray(rt.cell_id).shape[0]),
    ) as span:
        lrows, rrows = chip_candidate_rows(lt, rt)
        if not lrows.shape[0]:
            _candidate_stats(span, np.zeros(0, bool))
            return np.zeros((0, 2), np.int64)
        uniq_pairs, pair_id, either, psure = _dedup_pairs(
            lt, rt, lrows, rrows
        )
        _candidate_stats(span, psure)
    hit = either.copy()
    # a geometry pair already accepted via a core chip in ANY shared cell
    # needs no predicate for its remaining border-border candidates
    need = np.nonzero(~either & ~psure[pair_id])[0]
    degraded: DegradedResult | None = None
    if need.shape[0]:
        # every undecided candidate chip pair is evaluated: a geometry
        # pair intersects iff ANY of its shared-cell chip pairs does
        a = lt.chips.take(lrows[need])
        b = rt.chips.take(rrows[need])
        if dev is None:
            res = _dispatch.guarded_call("overlay.predicate", pair_intersects, a, b)
        else:
            res = _dispatch.guarded_call(
                "overlay.predicate", _device_pair_intersects, a, b, dev,
                fallback=(lambda: pair_intersects(a, b)) if dev.type == "cpu" else None,
            )
        if isinstance(res, DegradedResult):
            degraded = res
        hit[need] = np.asarray(res)
    pairs = uniq_pairs[np.unique(pair_id[hit])]
    if degraded is not None:
        return DegradedResult.wrap(
            pairs, reason=degraded.reason, attempts=degraded.attempts,
        )
    return pairs


#: the managed overlay entry point under its workload name (the BNG
#: overlay notebook's join) — same callable, resilience included
overlay_join = intersects_join


# ------------------------------------------------------- device-lane prep


@dataclass(frozen=True)
class OverlaySide:
    """One cell-sorted, bucket-padded side table of an overlay prep.

    All per-row arrays are in sorted-by-cell order, padded to ``bucket``
    rows (pad cells carry a per-side sentinel that sorts above every
    real cell and can never equi-join the other side's sentinel).
    ``rows`` maps sorted row → original chip row for the host override
    lane; ``geom_area`` is indexed by ORIGINAL geometry id.
    """

    table: ChipTable
    n: int
    bucket: int
    cells: np.ndarray      # (Lb,) i64 sorted ascending, sentinel tail
    geom: np.ndarray       # (Lb,) i64 geometry id, -1 pad
    core: np.ndarray       # (Lb,) bool
    ok_subj: np.ndarray    # (Lb,) bool device-clippable as clip SUBJECT
    ok_win: np.ndarray     # (Lb,) bool device-clippable as clip WINDOW
    verts: np.ndarray      # (Lb, V, 2) f64 shifted CCW open rings
    vlen: np.ndarray       # (Lb,) i32 left-packed vertex counts
    chip_area: np.ndarray  # (Lb,) f64 |chip| (core rows: the cell area)
    cell_area: np.ndarray  # (Lb,) f64 area of the row's cell
    rows: np.ndarray       # (n,) i64 sorted row -> original chip row
    geom_area: np.ndarray  # (G,) f64 |geometry| (shifted frame)


@dataclass(frozen=True)
class OverlayPrep:
    """Amortized overlay prep: both sorted side tables plus the shared
    coordinate frame (``shift``/``scale``), the accelerated fold dtype,
    the epsilon-band threshold in area units, the vertex pad — every
    static piece of the fused program's signature — and the device the
    lane runs on, with the side tables' device copies (made once)."""

    left: OverlaySide
    right: OverlaySide
    shift: np.ndarray
    scale: float
    index_system: IndexSystem
    resolution: int
    acc_name: str
    band: float
    vpad: int
    device: torch.device = torch.device("cpu")
    tensors: dict = field(default_factory=dict, compare=False, repr=False)


def _csr_geom_areas(col: PackedGeometry, shift: np.ndarray) -> np.ndarray:
    """(G,) f64 polygon areas (|shells| − |holes|), vectorized over the
    CSR offsets — the columnar twin of `core.geometry.oracle.area`
    (shell = first ring of its part, open rings, wraparound shoelace).
    Non-polygon rows report 0.0; coordinates are shifted first so the
    table is computed in the same frame the clip kernels run in."""
    G = len(col)
    out = np.zeros(G, np.float64)
    nv = int(np.asarray(col.xy).shape[0])
    if not G or not nv:
        return out
    x = np.asarray(col.xy[:, 0], np.float64) - float(shift[0])
    y = np.asarray(col.xy[:, 1], np.float64) - float(shift[1])
    ro = np.asarray(col.ring_offsets, np.int64)
    po = np.asarray(col.part_offsets, np.int64)
    go = np.asarray(col.geom_offsets, np.int64)
    R = ro.shape[0] - 1
    ring_of = np.repeat(np.arange(R), np.diff(ro))
    nxt = np.arange(nv) + 1
    nxt = np.where(nxt == ro[1:][ring_of], ro[:-1][ring_of], nxt)
    ring_area = np.zeros(R, np.float64)
    np.add.at(ring_area, ring_of, x * y[nxt] - x[nxt] * y)
    ring_area *= 0.5
    part_of_ring = np.repeat(np.arange(po.shape[0] - 1), np.diff(po))
    is_shell = np.arange(R) == po[:-1][part_of_ring]
    signed = np.where(is_shell, np.abs(ring_area), -np.abs(ring_area))
    geom_of_part = np.repeat(np.arange(G), np.diff(go))
    np.add.at(out, geom_of_part[part_of_ring], signed)
    gt = np.asarray(col.geom_type, np.int64)
    base = np.where(gt > 3, gt - 3, gt)
    return np.where(base == int(GeometryType.POLYGON), out, 0.0)


def _masked_shoelace(verts: np.ndarray, vlen: np.ndarray) -> np.ndarray:
    """(N,) f64 signed shoelace areas of left-packed open rings."""
    x, y = verts[:, :, 0], verts[:, :, 1]
    j = np.arange(verts.shape[1])[None, :]
    nxt = np.where(j + 1 < vlen[:, None], j + 1, 0)
    xn = np.take_along_axis(x, nxt, axis=1)
    yn = np.take_along_axis(y, nxt, axis=1)
    contrib = np.where(j < vlen[:, None], x * yn - xn * y, 0.0)
    return 0.5 * contrib.sum(axis=1)


def _chip_analysis(table: ChipTable):
    """Per-chip-row CSR facts: ``(simple, r0s, r0l)`` — device-clippable
    shape class (single-part single-ring polygon with a stored geometry)
    plus its outer ring span."""
    ch = table.chips
    C = len(ch)
    if not C:
        z = np.zeros(0, np.int64)
        return np.zeros(0, bool), z, z
    has = np.asarray(table.has_geom, bool)
    go = np.asarray(ch.geom_offsets, np.int64)
    po = np.asarray(ch.part_offsets, np.int64)
    ro = np.asarray(ch.ring_offsets, np.int64)
    gt = np.asarray(ch.geom_type, np.int64)
    nparts = np.diff(go)
    nrings = po[go[1:]] - po[go[:-1]]
    fr = np.minimum(po[go[:-1]], max(ro.shape[0] - 2, 0))
    r0s = ro[fr]
    r0l = ro[fr + 1] - r0s
    base = np.where(gt > 3, gt - 3, gt)
    simple = (
        has
        & (base == int(GeometryType.POLYGON))
        & (nparts == 1)
        & (nrings == 1)
        & (r0l >= 3)
    )
    return simple, r0s, r0l


def _side_verts(table: ChipTable, simple, r0s, r0l, V: int,
                shift: np.ndarray, scale: float):
    """(eligible, ok_win, verts, vlen) in original chip-row order —
    left-packed CCW shifted outer rings padded by repeating the last
    vertex, plus the convex-window eligibility flag."""
    C = len(table.chips)
    if not C:
        return (
            np.zeros(0, bool), np.zeros(0, bool),
            np.zeros((0, V, 2), np.float64), np.zeros(0, np.int32),
        )
    eligible = simple & (r0l <= V)
    xy = np.asarray(table.chips.xy, np.float64)
    safe_len = np.maximum(r0l, 1)
    idx = r0s[:, None] + np.minimum(np.arange(V)[None, :],
                                    safe_len[:, None] - 1)
    idx = np.clip(idx, 0, max(xy.shape[0] - 1, 0))
    verts = xy[idx]
    vlen = np.where(eligible, r0l, 0).astype(np.int32)
    # orient CCW (reverse the valid prefix where the ring is CW)
    sa = _masked_shoelace(verts, vlen)
    j = np.arange(V)[None, :]
    rev = np.where(j < vlen[:, None],
                   np.maximum(vlen[:, None] - 1 - j, 0), j)
    flipped = np.take_along_axis(verts, rev[:, :, None], axis=1)
    verts = np.where((sa < 0)[:, None, None], flipped, verts)
    verts = verts - np.asarray(shift, np.float64)[None, None, :]
    # convex-window test on the oriented, shifted ring: every pair of
    # consecutive edges turns left (cross ≥ -tol), wraparound included
    nxt = np.where(j + 1 < vlen[:, None], j + 1, 0)
    nxy = np.take_along_axis(verts, nxt[:, :, None], axis=1)
    e = nxy - verts
    en = np.take_along_axis(e, nxt[:, :, None], axis=1)
    cross = e[:, :, 0] * en[:, :, 1] - e[:, :, 1] * en[:, :, 0]
    tol = _k.CLIP_EPS * scale * scale
    convex = np.all(
        np.where(j < vlen[:, None], cross, 0.0) >= -tol, axis=1
    )
    return eligible, eligible & convex, verts, vlen


def prepare_overlay(
    left_chips: ChipTable,
    right_chips: ChipTable,
    left: PackedGeometry,
    right: PackedGeometry,
    index_system: IndexSystem,
    resolution: int,
    *,
    device=None,
) -> OverlayPrep:
    """Build the amortized device-lane prep for an overlay table pair,
    for ``device`` (the card unless ``device="cpu"``).

    One host pass per table pair: sort both chip tables by cell id, pad
    to ladder buckets with per-side sentinels, precompute the f64 area
    tables (chip, cell, whole-geometry — all in a shared shifted frame
    centered on the data so the f32 lane keeps maximal mantissa), pack
    the device-clippable outer rings to the vertex pad, and derive the
    epsilon-band threshold. Everything here is reused across measures
    and caps — only the fused program varies per signature. The device
    copies of the side tables are made on first use and kept in the
    prep.
    """
    dev = resolve_device(device)
    with _trace.span(
        "overlay.prepare",
        left_chips=int(np.asarray(left_chips.cell_id).shape[0]),
        right_chips=int(np.asarray(right_chips.cell_id).shape[0]),
    ):
        lcells_raw = np.asarray(left_chips.cell_id, np.int64)
        rcells_raw = np.asarray(right_chips.cell_id, np.int64)
        ucells = np.unique(np.concatenate([lcells_raw, rcells_raw]))
        if ucells.shape[0]:
            bnds = np.asarray(
                index_system.cell_boundary(ucells), np.float64
            )
        else:
            bnds = np.zeros((0, 4, 2), np.float64)
        lxy = np.asarray(left_chips.chips.xy, np.float64).reshape(-1, 2)
        rxy = np.asarray(right_chips.chips.xy, np.float64).reshape(-1, 2)
        allxy = np.concatenate([lxy, rxy, bnds.reshape(-1, 2)], axis=0)
        if allxy.shape[0]:
            lo, hi = allxy.min(axis=0), allxy.max(axis=0)
            shift = 0.5 * (lo + hi)
            scale = float(max(1.0, float(np.max(np.abs(allxy - shift)))))
        else:
            shift = np.zeros(2, np.float64)
            scale = 1.0
        cell_polys, klen = _dedupe_boundaries_batch(bnds)
        ucell_area = np.abs(_masked_shoelace(
            cell_polys - shift[None, None, :], klen.astype(np.int64)
        ))

        lsimple, lr0s, lr0l = _chip_analysis(left_chips)
        rsimple, rr0s, rr0l = _chip_analysis(right_chips)

        def _border_max(table, simple, r0l):
            m = simple & ~np.asarray(table.is_core, bool)
            return int(r0l[m].max()) if m.any() else 0

        V = int(min(MAX_CHIP_VERTS, max(
            4,
            _border_max(left_chips, lsimple, lr0l),
            _border_max(right_chips, rsimple, rr0l),
        )))

        acc = ACC_NAME
        band = (
            EDGE_BAND_K * float(np.finfo(np.dtype(acc)).eps)
            * scale * scale
        )

        def _side(table, col, cells_raw, simple, r0s, r0l, pad_cell):
            n = int(cells_raw.shape[0])
            order = np.argsort(cells_raw, kind="stable")
            Lb = TABLE_LADDER.bucket_for(max(n, 1))
            elig, ok_win, verts, vlen = _side_verts(
                table, simple, r0s, r0l, V, shift, scale
            )
            chip_area = _csr_geom_areas(table.chips, shift)
            pos = np.searchsorted(ucells, cells_raw)
            row_cell_area = (
                ucell_area[pos] if n else np.zeros(0, np.float64)
            )
            core = np.asarray(table.is_core, bool)
            # a core chip covers its cell exactly — use the cell table so
            # the core branches and the area tables agree bit-for-bit
            chip_area = np.where(core, row_cell_area, chip_area)

            def pad(a, fill=0):
                out = np.full((Lb,) + a.shape[1:], fill, a.dtype)
                out[:n] = a[order]
                return out

            return OverlaySide(
                table=table,
                n=n,
                bucket=Lb,
                cells=pad(cells_raw, pad_cell),
                geom=pad(np.asarray(table.geom_id, np.int64), -1),
                core=pad(core),
                ok_subj=pad(elig),
                ok_win=pad(ok_win),
                verts=pad(verts),
                vlen=pad(vlen),
                chip_area=pad(chip_area),
                cell_area=pad(row_cell_area),
                rows=order.astype(np.int64),
                geom_area=_csr_geom_areas(col, shift),
            )

        return OverlayPrep(
            left=_side(left_chips, left, lcells_raw, lsimple, lr0s,
                       lr0l, _k.LEFT_PAD_CELL),
            right=_side(right_chips, right, rcells_raw, rsimple, rr0s,
                        rr0l, _k.RIGHT_PAD_CELL),
            shift=np.asarray(shift, np.float64),
            scale=scale,
            index_system=index_system,
            resolution=resolution,
            acc_name=acc,
            band=float(band),
            vpad=V,
            device=dev,
        )


def pair_glue(prep: OverlayPrep, li, ri, valid):
    """Candidate stream → geometry-pair segments (host glue, shared by
    the device lane and its numpy twin so both see identical segment
    ids): ``(uniq (U, 2) i64, seg (Pb,) i32 with -1 for dead slots,
    sure (U,), Sb, seg_larea (Sb,) f64, seg_rarea (Sb,) f64)``."""
    L, R = prep.left, prep.right
    li = np.asarray(li)
    ri = np.asarray(ri)
    valid = np.asarray(valid, bool)
    lg = L.geom[li]
    rg = R.geom[ri]
    valid = valid & (lg >= 0) & (rg >= 0)
    seg = np.full(li.shape[0], -1, np.int32)
    if valid.any():
        uniq, inv = np.unique(
            np.stack([lg[valid], rg[valid]], axis=-1),
            axis=0, return_inverse=True,
        )
        seg[valid] = inv.astype(np.int32)
    else:
        uniq = np.zeros((0, 2), np.int64)
    U = uniq.shape[0]
    sure = np.zeros(U, bool)
    either = L.core[li] | R.core[ri]
    if valid.any():
        np.logical_or.at(sure, seg[valid], either[valid])
    Sb = SEG_LADDER.bucket_for(max(U, 1))
    seg_larea = np.zeros(Sb, np.float64)
    seg_rarea = np.zeros(Sb, np.float64)
    if U:
        seg_larea[:U] = L.geom_area[uniq[:, 0]]
        seg_rarea[:U] = R.geom_area[uniq[:, 1]]
    return uniq, seg, sure, Sb, seg_larea, seg_rarea




# --------------------------------------------------- device-lane programs


def _side_tensors(prep: OverlayPrep) -> dict:
    """The prep's side tables on its device, in the accelerated dtype —
    copied once per prep, then served from ``prep.tensors``."""
    t = prep.tensors
    if not t:
        dev = prep.device
        acc = np.dtype(prep.acc_name)

        def on(a, dtype=None):
            a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
            return torch.from_numpy(a).to(dev)

        for tag, s in (("l", prep.left), ("r", prep.right)):
            t[tag + "cells"] = on(s.cells)
            t[tag + "core"] = on(s.core)
            t[tag + "ok_subj"] = on(s.ok_subj)
            t[tag + "ok_win"] = on(s.ok_win)
            t[tag + "verts"] = on(s.verts, acc)
            t[tag + "vlen"] = on(s.vlen)
            t[tag + "chip_area"] = on(s.chip_area, acc)
            t[tag + "cell_area"] = on(s.cell_area, acc)
    return t


@dataclass(frozen=True)
class OverlayMeasures:
    """Fused overlay measure result — one row per unique geometry pair
    sharing at least one cell (plus, when the candidate stream was
    capped, a trailing ``(OVERFLOW, OVERFLOW)`` row with NaN measures:
    structural truncation, never a silent wrong answer).

    ``value`` is the evaluated pair tree (f64), ``valid`` its mask lane,
    ``area`` the folded intersection area, ``sure`` the core-chip
    certainty flag, ``host_overridden`` how many pairs the f64 host lane
    re-answered (epsilon band / shape class), and ``lane`` which lane
    produced the numbers (``degraded`` True when the device lane failed
    on the CPU and the host oracle answered instead)."""

    pairs: np.ndarray
    value: np.ndarray
    valid: np.ndarray
    area: np.ndarray
    sure: np.ndarray
    overflow: int
    lane: str
    host_overridden: int
    degraded: bool = False
    reason: str = ""


def _package(out: dict, lane: str, degraded: bool = False,
             reason: str = "") -> OverlayMeasures:
    """Lane output dict → :class:`OverlayMeasures`, appending the
    OVERFLOW(-2) row when the emission was capped."""
    pairs = out["pairs"]
    value = out["value"]
    vmask = out["valid"]
    area = out["area"]
    sure = out["sure"]
    overflow = int(out["overflow"])
    if overflow > 0:
        pairs = np.concatenate(
            [pairs, np.asarray([[OVERFLOW, OVERFLOW]], np.int64)]
        )
        value = np.concatenate([value, [np.nan]])
        area = np.concatenate([area, [np.nan]])
        vmask = np.concatenate([vmask, [False]])
        sure = np.concatenate([sure, [False]])
    return OverlayMeasures(
        pairs=pairs, value=value, valid=vmask, area=area, sure=sure,
        overflow=overflow, lane=lane,
        host_overridden=int(out["host_overridden"]),
        degraded=degraded, reason=reason,
    )


def _device_lane(prep: OverlayPrep, value, pair_cap, mesh) -> dict:
    """The device lane's output dict (the host lane's keys); ``mesh``
    shards its per-pair stage."""
    from ..expr import compile as _compile
    from ..expr.host_oracle import splice_override

    L, R = prep.left, prep.right
    T = _side_tensors(prep)
    with _trace.span(
        "overlay.device_candidates", left_chips=L.n, right_chips=R.n,
    ) as span:
        with _telemetry.timed("overlay_stage", stage="candidates"):

            def device_candidates():
                total = int(_k.pair_count(T["lcells"], T["rcells"], L.n))
                Pb, emit_limit, overflow = pair_plan(total, pair_cap)
                li, ri, valid = _k.emit_pairs(
                    T["lcells"], T["rcells"], L.n, emit_limit, Pb
                )
                return (
                    li, ri, valid, li.cpu().numpy(), ri.cpu().numpy(),
                    valid.cpu().numpy(), total, Pb, emit_limit, overflow,
                )

            (li_d, ri_d, valid_d, li, ri, valid, total, Pb, emit_limit,
             overflow) = _dispatch.guarded_call(
                "overlay.device_candidates", device_candidates
            )
            uniq, seg, sure, Sb, seg_l64, seg_r64 = pair_glue(
                prep, li, ri, valid
            )
        span.set(
            raw_candidates=total, emitted=emit_limit, overflow=overflow,
        )
        _candidate_stats(span, sure)

    with _trace.span(
        "overlay.measures", pairs=int(uniq.shape[0]), candidates=total,
        mesh=mesh is not None,
    ) as span:
        with _telemetry.timed("overlay_stage", stage="measures"):
            sig = _compile.overlay_signature_of(
                value, L.bucket, R.bucket, Pb, Sb, prep.vpad,
                prep.acc_name, prep.index_system, prep.resolution, mesh,
            )
            prog = _compile.overlay_program(
                value, L.bucket, R.bucket, Pb, Sb, prep.vpad,
                prep.acc_name, mesh,
            )
            acc = np.dtype(prep.acc_name)
            dev = prep.device

            def on(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            def measures():
                raw = _compile.run_tracked(
                    sig, prog,
                    li_d, ri_d, valid_d, on(seg),
                    T["lcore"], T["lok_subj"], T["lverts"], T["lvlen"],
                    T["lchip_area"], T["lcell_area"],
                    T["rcore"], T["rok_win"], T["rverts"], T["rvlen"],
                    T["rchip_area"],
                    on(seg_l64.astype(acc)), on(seg_r64.astype(acc)),
                    float(prep.band),
                )
                return tuple(x.cpu().numpy() for x in raw)

            val, vok, s, _cnt, host_needed = _dispatch.guarded_call(
                "overlay.measures", measures
            )
            val = val.astype(np.float64).copy()
            vok = vok.astype(bool).copy()
            area64 = s.astype(np.float64).copy()
            val, vok, area64, overridden = splice_override(
                prep, value, li, ri, valid, seg,
                host_needed, seg_l64, seg_r64, val, vok, area64,
            )
        span.set(host_overridden=overridden)
    U = uniq.shape[0]
    return {
        "pairs": uniq, "value": val[:U], "valid": vok[:U],
        "area": area64[:U], "sure": sure,
        "overflow": overflow, "host_overridden": overridden,
    }


def _prep_for(left, right, index_system, resolution, left_chips,
              right_chips, device) -> OverlayPrep:
    lt = (
        left_chips
        if left_chips is not None
        else tessellate(left, index_system, resolution)
    )
    rt = (
        right_chips
        if right_chips is not None
        else tessellate(right, index_system, resolution)
    )
    return prepare_overlay(
        lt, rt, left, right, index_system, resolution, device=device,
    )


def overlay_measures(
    left: PackedGeometry,
    right: PackedGeometry,
    index_system: IndexSystem,
    resolution: int,
    value=None,
    *,
    left_chips: ChipTable | None = None,
    right_chips: ChipTable | None = None,
    prep: OverlayPrep | None = None,
    pair_cap: int | None = None,
    mesh=None,
    lane: str = "device",
    device=None,
) -> OverlayMeasures:
    """Fused overlap measures per intersecting geometry pair.

    ``value`` is an `expr/` PAIR tree over :func:`expr.ast.overlap_area`
    / ``left_area`` / ``right_area`` (default: the raw intersection
    area). Candidate generation runs on the device as a sorted segment
    equi-join over the prep's cell columns, the measures as ONE fused
    program per ``(tree-hash, buckets, index, mesh)`` signature — warm it with
    :func:`warmup_overlay` before `expr.compile.freeze`. The device is
    the prep's (``device`` when the prep is built here: the card unless
    ``device="cpu"``).

    ``lane="host"`` routes to the pure-f64 numpy twin (the oracle). On
    the CPU the device lane degrades there (result flagged) when it fails
    past its retry budget; on the card the error propagates.
    ``pair_cap`` bounds the candidate emission — the excess is reported
    as an OVERFLOW(-2) row, never silently dropped. ``mesh`` (a device
    count, a `parallel.mesh.Mesh`, or None for the ``MOSAIC_MESH`` knob)
    shards the per-pair stage over the mesh's devices, the prep's kind.
    """
    from ..expr import ast as _ast
    from ..expr.host_oracle import host_overlay_measures

    value = _ast.overlap_area() if value is None else value
    _ast.validate_pair(value)
    if prep is None:
        prep = _prep_for(left, right, index_system, resolution,
                         left_chips, right_chips, device)
    mesh = _dispatch.resolve_mesh(mesh, device=prep.device)
    if lane == "host":
        out = host_overlay_measures(prep, value, pair_cap=pair_cap)
        return _package(out, lane="host")
    if lane != "device":
        raise ValueError(f"unknown overlay lane {lane!r}")
    try:
        return _package(
            _device_lane(prep, value, pair_cap, mesh), lane="device"
        )
    except Exception as e:  # lint: broad-except-ok (degradation seam: on the CPU the f64 host oracle answers instead and the result is flagged, as the reference's; on the card the error propagates)
        if prep.device.type != "cpu":
            raise
        _telemetry.record(
            "degraded", label="overlay.measures", error=repr(e)[:200]
        )
        out = host_overlay_measures(prep, value, pair_cap=pair_cap)
        return _package(
            out, lane="host", degraded=True,
            reason=f"overlay.measures: {e!r}"[:300],
        )


def warmup_overlay(
    left: PackedGeometry,
    right: PackedGeometry,
    index_system: IndexSystem,
    resolution: int,
    value=None,
    *,
    left_chips: ChipTable | None = None,
    right_chips: ChipTable | None = None,
    prep: OverlayPrep | None = None,
    pair_cap: int | None = None,
    mesh=None,
    device=None,
) -> OverlayPrep:
    """Execute the device overlay pipeline once so its signature joins
    the warm set (`expr.compile.freeze` afterwards arms the cold-compile
    tripwire), its side tables are on the device and the kernel library
    is bound; return the prep for amortized reuse."""
    if prep is None:
        prep = _prep_for(left, right, index_system, resolution,
                         left_chips, right_chips, device)
    overlay_measures(
        left, right, index_system, resolution, value,
        prep=prep, pair_cap=pair_cap, mesh=mesh,
    )
    return prep
