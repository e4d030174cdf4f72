"""SpatialKNN: exact / approximate K nearest neighbours, batch model.

Port of ``mosaic_tpu/models/knn.py`` (reference analog:
`models/knn/SpatialKNN.scala` + `GridRingNeighbours.scala`): iterative
grid-ring expansion — iteration 1 joins each landmark's cell cover
k-ring(1) against the tessellated candidate chips, iteration i>1 joins
only the k-loop(i) shell, so every candidate is inspected once;
per-iteration results append to a checkpoint; early stopping fires when
the unmatched count and the total match count are stable; in exact mode
rings widen until the grid-guaranteed radius covers each landmark's
current kth-neighbour distance.

The ring and cell bookkeeping stays on the host (sets of int64 cells);
every iteration's geometry distances are one padded device call (pairs
gathered from two float64 DeviceGeometry columns sharing one recenter
shift), on the card unless the model was built with ``device="cpu"``.

What differs from the reference: ``mesh=`` takes a `parallel.mesh.Mesh` (or a device
count) and shards each iteration's pair batch over it
(`parallel/dist_knn.py`), bit for bit the single-device distances; each
iteration's shells come from ONE batched ``k_ring``/``k_loop`` call over
every landmark's cover (rows do not depend on each other, so the cells
are the same); past the retry budget only a model on the CPU degrades to
the f64 host oracle, on the card the iteration raises
:class:`~mosaic_tpu_torch.runtime.errors.RetryExhausted`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core.index.base import IndexSystem
from ..core.tessellate import tessellate
from ..core.types import PackedGeometry
from ..dispatch import core as _dispatch
from ..runtime.errors import DegradedResult
from .core import CheckpointManager


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@_dispatch.bounded_cache("knn_pair_distance", 1)
def _pair_distance_prog():
    """The process-wide pairwise-distance program: gather both
    DeviceGeometry columns by row, evaluate `_distance_dense` per pair
    (eager torch ops on the columns' device). Registered in the dispatch
    cache registry so ``cache_stats()``/``clear_caches()`` govern it like
    every other program cache."""
    from ..core.geometry.device import take_rows
    from ..functions.geometry import _distance_dense, _vmap_pair

    def run(dls, dcs, lrows, crows):
        da = take_rows(dls, lrows)
        db = take_rows(dcs, crows)
        return _vmap_pair(_distance_dense, da, db)

    return run


class GridRingNeighbours:
    """One iteration's candidate generation + distance evaluation
    (reference: GridRingNeighbours.transform / leftTransform).

    With ``mesh`` set, each iteration's pair batch shards over the mesh's
    devices (`parallel/dist_knn.py`) — the reference's distributed
    join+distance step."""

    def __init__(self, index: IndexSystem, resolution: int, mesh=None):
        self.index = index
        self.resolution = resolution
        self.mesh = mesh

    # ------------------------------------------------------------ cells
    def ring_cells(self, cover: list[np.ndarray], iteration: int) -> list[np.ndarray]:
        """Iteration 1: k-ring(1) of the cover; i>1: k-loop(i) shell only
        (`GridRingNeighbours.leftTransform`: kring for i==1 else kloop).
        One batched call over every non-empty cover."""
        out = [seed for seed in cover]
        sizes = [seed.size for seed in cover]
        if not any(sizes):
            return out
        seeds = np.concatenate([np.asarray(s, dtype=np.int64) for s in cover])
        if iteration == 1:
            cells = np.asarray(self.index.k_ring(seeds, 1))
        else:
            cells = np.asarray(self.index.k_loop(seeds, iteration))
        start = 0
        for i, n in enumerate(sizes):
            if n:
                part = cells[start : start + n]
                out[i] = np.unique(part[part >= 0])
            start += n
        return out

    # --------------------------------------------------------- distances
    def pair_distances(self, dl, dc, li: np.ndarray, ci: np.ndarray) -> np.ndarray:
        """Batched geometry distance for (landmark, candidate) row pairs:
        the pair axis pads to a power of two, then `_distance_dense`
        runs pairwise on the columns' device."""
        P = li.shape[0]
        if P == 0:
            return np.zeros(0)
        if self.mesh is not None:
            from ..parallel.dist_knn import distributed_pair_distances

            return distributed_pair_distances(self.mesh, dl, dc, li, ci)
        Ppad = _pow2(P)
        lip = np.concatenate([li, np.zeros(Ppad - P, dtype=li.dtype)])
        cip = np.concatenate([ci, np.zeros(Ppad - P, dtype=ci.dtype)])
        dev = dl.verts.device
        with _dispatch._device_scope(dev):
            out = _pair_distance_prog()(
                dl, dc, torch.from_numpy(lip).to(dev), torch.from_numpy(cip).to(dev)
            )
            return out.to(torch.float64).cpu().numpy()[:P]


@dataclasses.dataclass
class KNNResult:
    """Flat match table (the reference's transformed DataFrame rows)."""

    landmark_id: np.ndarray  # (M,)
    candidate_id: np.ndarray  # (M,)
    distance: np.ndarray  # (M,)
    rank: np.ndarray  # (M,) 1-based neighbour rank per landmark
    metrics: dict


class SpatialKNN:
    """Reference: `SpatialKNN.transform` params (`SpatialKNNParams.scala`):
    kNeighbours, maxIterations, earlyStopIterations, distanceThreshold,
    approximate, checkpoint dir."""

    def __init__(
        self,
        index: "IndexSystem | None" = None,
        resolution: "int | None" = None,
        k_neighbours: int = 5,
        max_iterations: int = 10,
        early_stop_iterations: int = 3,
        distance_threshold: "float | None" = None,
        approximate: bool = True,
        checkpoint_dir: "str | None" = None,
        mesh=None,
        *,
        device=None,
    ):
        if index is None:
            from ..context import current_context

            index = current_context().index_system
        self.index = index
        self.resolution = resolution
        self.k = int(k_neighbours)
        self.max_iterations = int(max_iterations)
        self.early_stop = int(early_stop_iterations)
        self.distance_threshold = distance_threshold
        self.approximate = approximate
        self.checkpoint_dir = checkpoint_dir
        self.device = resolve_device(device)
        self.mesh = (
            None if mesh is None
            else _dispatch.resolve_mesh(mesh, device=self.device)
        )
        self.metrics: dict = {}
        self._ring_cache: dict = {}

    # ------------------------------------------------------------ helpers
    def _cover_cells(self, col, res: int) -> list[np.ndarray]:
        table = tessellate(col, self.index, res, keep_core_geoms=False)
        return [
            np.unique(table.cell_id[table.geom_id == g])
            for g in range(len(col))
        ]

    def _cell_width(self, res: int) -> float:
        # conservative per-ring growth of the guaranteed-covered radius:
        # one ring adds at least the cell in-diameter ~ sqrt(area)/1.5
        return float(np.sqrt(self.index.cell_area_approx(res)) / 1.5)

    # ----------------------------------------------------------- transform
    def transform(self, landmarks: PackedGeometry, candidates: PackedGeometry) -> KNNResult:
        land, cand = landmarks, candidates
        res = (
            self.index.resolution_arg(self.resolution)
            if self.resolution is not None
            else _default_resolution(self.index, cand)
        )
        L = len(land)

        # right side: chip cells -> candidate rows (tessellate once)
        ctable = tessellate(cand, self.index, res, keep_core_geoms=False)
        order = np.argsort(ctable.cell_id, kind="stable")
        ccells = ctable.cell_id[order]
        crows = ctable.geom_id[order].astype(np.int64)

        # left cover + shared-shift device columns for distance evaluation
        cover = self._cover_cells(land, res)
        from ..functions.geometry import _pair_pack

        dl, dc = _pair_pack(land, cand, device=self.device)
        ring = self._ring_cache.get(res)
        if ring is None or ring.mesh is not self.mesh:
            ring = GridRingNeighbours(self.index, res, mesh=self.mesh)
            self._ring_cache[res] = ring

        ckpt = (
            CheckpointManager(self.checkpoint_dir, overwrite=True)
            if self.checkpoint_dir
            else None
        )

        dist = np.full((L, self.k), np.inf)
        cid = np.full((L, self.k), -1, dtype=np.int64)
        seen: list[set] = [set() for _ in range(L)]
        stable_rounds = 0
        prev_unfinished = L
        prev_matches = 0
        w = self._cell_width(res)
        iterations = 0
        degraded = False

        def matched(i: int) -> int:
            return int((cid[i] >= 0).sum())

        for it in range(1, self.max_iterations + 1):
            iterations = it
            # guarantee radius after ring r: (r-1) rings fully covered
            need = np.array(
                [
                    matched(i) < self.k
                    or (
                        not self.approximate
                        and (it - 1) * w < dist[i, self.k - 1]
                    )
                    for i in range(L)
                ]
            )
            if not need.any():
                break
            shells = ring.ring_cells(
                [c if need[i] else np.zeros(0, np.int64) for i, c in enumerate(cover)],
                it,
            )
            li_list: list[int] = []
            ci_list: list[int] = []
            for i in range(L):
                cells = shells[i]
                if not cells.size:
                    continue
                lo = np.searchsorted(ccells, cells, side="left")
                hi = np.searchsorted(ccells, cells, side="right")
                rows: set = set()
                for a, b in zip(lo, hi):
                    rows.update(crows[a:b].tolist())
                rows -= seen[i]
                seen[i].update(rows)
                for rr in rows:
                    li_list.append(i)
                    ci_list.append(rr)
            li = np.asarray(li_list, dtype=np.int64)
            ci = np.asarray(ci_list, dtype=np.int64)
            d = _resilient_distances(ring, dl, dc, li, ci, land, cand)
            if isinstance(d, DegradedResult):
                degraded = True
                d = np.asarray(d)
            if self.distance_threshold is not None:
                keep = d <= self.distance_threshold
                li, ci, d = li[keep], ci[keep], d[keep]
            # merge into running top-k per landmark
            for i, c, dd in zip(li, ci, d):
                row_d = dist[i]
                if dd < row_d[-1]:
                    j = int(np.searchsorted(row_d, dd))
                    dist[i] = np.insert(row_d, j, dd)[: self.k]
                    cid[i] = np.insert(cid[i], j, c)[: self.k]
            if ckpt is not None:
                ckpt.append(
                    {"iteration": np.full(li.shape, it), "landmark": li,
                     "candidate": ci, "distance": d}
                )
            # early stopping (`earlyStoppingCheck`): unmatched count and
            # total match count both stable
            unfinished = int(sum(matched(i) < self.k for i in range(L)))
            total_matches = int((cid >= 0).sum())
            if unfinished == prev_unfinished and total_matches == prev_matches:
                stable_rounds += 1
                if stable_rounds >= self.early_stop:
                    break
            else:
                stable_rounds = 0
            prev_unfinished, prev_matches = unfinished, total_matches

        # flatten result
        li_out, ci_out, d_out, rank_out = [], [], [], []
        for i in range(L):
            for r in range(self.k):
                if cid[i, r] >= 0:
                    li_out.append(i)
                    ci_out.append(int(cid[i, r]))
                    d_out.append(float(dist[i, r]))
                    rank_out.append(r + 1)
        self.metrics = {
            "match_count": len(li_out),
            "iterations": iterations,
            "landmarks": L,
            "candidates": len(cand),
            "complete_landmarks": int(
                sum(matched(i) >= self.k for i in range(L))
            ),
            "max_kth_distance": float(
                np.nanmax(np.where(np.isinf(dist), np.nan, dist), initial=0.0)
            ),
            "resolution": res,
            "approximate": self.approximate,
            # True when any iteration's distances came from the f64 host
            # oracle after the device path failed past its retry budget
            "degraded": degraded,
        }
        if ckpt is not None:
            ckpt.write_meta(self.metrics)
        return KNNResult(
            landmark_id=np.asarray(li_out, dtype=np.int64),
            candidate_id=np.asarray(ci_out, dtype=np.int64),
            distance=np.asarray(d_out),
            rank=np.asarray(rank_out, dtype=np.int64),
            metrics=dict(self.metrics),
        )

    def get_metrics(self) -> dict:
        """Reference: `SpatialKNN.getMetrics` (MLflow loggables)."""
        return dict(self.metrics)


def _resilient_distances(ring, dl, dc, li, ci, land, cand):
    """Device pair distances with transient-failure retry. Past the
    budget a batch on the CPU degrades to the exact f64 oracle
    (`core/geometry/oracle.pair_distance`, flagged :class:`DegradedResult`
    and recorded in the metrics); on the card it raises
    :class:`RetryExhausted`."""
    if not li.size:
        return np.zeros(0)

    def device_eval():
        # the "knn.pair_distances" fault plan trips inside guarded_call
        return ring.pair_distances(dl, dc, li, ci)

    fallback = None
    if dl.verts.device.type == "cpu":
        from ..core.geometry.oracle import pair_distance

        def fallback():
            return np.asarray(
                pair_distance(land.take(li), cand.take(ci)), dtype=np.float64
            )

    return _dispatch.guarded_call(
        "knn.pair_distances", device_eval, fallback=fallback
    )


def _default_resolution(index, col) -> int:
    from ..sql.analyzer import MosaicAnalyzer

    return MosaicAnalyzer(index).get_optimal_resolution(col)
