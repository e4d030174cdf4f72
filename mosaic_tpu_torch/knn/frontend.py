"""Bucketed ring-expansion KNN frontend with a Voronoi convex lane.

Port of ``mosaic_tpu/knn/frontend.py``. A :class:`KNNFrontend` holds a
:class:`~mosaic_tpu_torch.knn.index.KNNIndex` resident and answers
queries with the serving discipline of `dispatch.DispatchCore`:

- **Shape discipline.** Cell assignment pads query rows to the row
  ladder, distance evaluation pads (query, candidate) pairs to the pair
  ladder; oversize pair sets chunk at the top rung, so the signature set
  is closed under any traffic. A pair batch is exact by construction:
  there is no candidate cap.
- **Signature accounting.** Signatures are ``("knn", kind, bucket,
  mesh, index fingerprint)``; :meth:`KNNFrontend.warmup` runs every rung
  and freezes the set, after which any new signature counts as a cold
  compile and fires ``on_cold_compile`` (the serve engine turns it into a
  ``serve_compile`` event). The port compiles nothing per shape: a rung's
  first run primes the caching allocator.
- **Failure domains.** ``knn.expand`` (ring/walk candidate generation),
  ``knn.distance`` (the device pair batch) and ``knn.scatter`` (top-k
  merge) run under `dispatch.guarded_call`: watchdog deadline, transient
  retry, fault-plan injection. Expand and scatter are pure functions
  whose results commit only after the guarded call returns, so retries
  are idempotent. Past the retry budget a frontend on the CPU answers
  the batch from the exact f64 host oracle (`knn.oracle`), flagged
  :class:`~mosaic_tpu_torch.runtime.errors.DegradedResult`; on the card
  it raises :class:`~mosaic_tpu_torch.runtime.errors.RetryExhausted` and
  no work moves to the CPU.

Lanes
-----
``ring`` is the exact iterative lane: grow k-ring(1) then k-loop(i)
shells per query (the batch model's loop, same stop rule: a query rests
once the grid-guaranteed radius ``(it-1)*cell_width`` covers its current
kth distance). ``voronoi`` collapses the loop: walk the Voronoi adjacency
of convex chip sites (`sql.join.VoronoiTables`) to a near-nearest site,
read ~k exact host distances to bound the kth neighbour, and dispatch
ONE ring cover of grid radius ``ceil(bound/w)+1`` — same pair program,
same rungs, same exact answer. Queries the walk cannot bound fall back
to the ring lane. The lane is the ``knn_lane`` tune knob.

What differs from the reference: the pair program is one closure of
eager torch ops in float64 (the reference's jitted program under
``jax_enable_x64``); the shells and covers of all queries come from one
batched call a ring instead of one call a query, and on H3 each query's
disk grows by one round a ring (:class:`_Rings`) where the reference
starts ``k_loop(k)`` over from the seed (a row does not depend on the
other rows, so the cells are the same); a ring lane degraded in more than one iteration (CPU only) keeps
its first ``DegradedResult`` where the reference's ``degraded or d``
tests an array's truth and raises. ``program_store=`` (or
``MOSAIC_PROGRAM_STORE``) keeps the reference's ``knn_cells`` and
``knn_pairs`` entries, one a rung, as JSON manifests of their statics:
the pair program is eager torch and launches no hand-written kernel, so
they name no kernel library; a meshed frontend refuses the store
(``program_store_refused``), as the reference's does. ``mesh=``
(a device count, a `parallel.mesh.Mesh`, or None for the ``MOSAIC_MESH``
knob) shards every pair batch over the mesh with the candidate column
replicated (:func:`_sharded_point_pairs`), bit for bit the single-device
distances; every pair rung must divide over it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..dispatch import (
    BucketLadder,
    backend_compiles,
    bounded_cache,
    cells_prog,
    guarded_call,
    mesh_key,
    resolve_mesh,
    resolve_program_store,
)
from ..dispatch import programs as _programs
from ..dispatch.core import _device_scope
from ..obs import trace as _trace
from ..runtime import telemetry as _telemetry
from ..runtime.errors import DegradedResult
from ..utils import get_logger
from .index import KNNIndex
from .oracle import host_pair_distances

logger = get_logger(__name__)

#: default pair ladder: 256 covers a handful of interactive queries'
#: first rings, 16k is one comfortable cover dispatch; bigger pair sets
#: chunk at the top rung (signature set stays closed)
DEFAULT_PAIR_LADDER = BucketLadder(min_bucket=256, max_bucket=16384)
#: default row ladder for query cell assignment
DEFAULT_ROW_LADDER = BucketLadder(min_bucket=64, max_bucket=4096)


@dataclasses.dataclass
class KNNAnswer:
    """Served neighbours (``-1``/``inf`` pad unfilled slots when the index
    holds fewer than k candidates). :meth:`KNNFrontend.query` returns one
    per row with (k,) arrays; the serve engine's ``submit_knn`` future
    resolves to one batched answer with (n, k) arrays."""

    ids: np.ndarray  # (..., k) int64 candidate rows, rank order
    distance: np.ndarray  # (..., k) f64
    degraded: bool = False
    reason: "str | None" = None


def decode_knn(out: np.ndarray, k: int):
    """Split the wire encoding ``[distances ‖ ids]`` (rows of width 2k,
    the shape KNN answers travel through the mixed-traffic batcher in)
    back into ``(ids int64, dist f64)``."""
    out = np.asarray(out, dtype=np.float64)
    dist = out[..., :k]
    ids = out[..., k : 2 * k].astype(np.int64)
    return ids, dist


# ------------------------------------------------------- device programs


def _point_column(qxy: torch.Tensor, shift: torch.Tensor):
    """A POINT DeviceGeometry column from (P, 2) coords: one vertex per
    ring in closed form (the vertex repeated at index ``ring_len``), the
    column `pack_to_device` builds for these points."""
    from ..core.geometry.device import DeviceGeometry
    from ..core.types import GeometryType

    n = qxy.shape[0]
    dev = qxy.device
    return DeviceGeometry(
        verts=qxy[:, None, None, :].expand(n, 1, 2, 2),
        ring_len=torch.ones((n, 1), dtype=torch.int32, device=dev),
        ring_is_hole=torch.zeros((n, 1), dtype=torch.bool, device=dev),
        n_rings=torch.ones((n,), dtype=torch.int32, device=dev),
        geom_type=torch.full((n,), int(GeometryType.POINT), dtype=torch.int32,
                             device=dev),
        shift=shift,
    )


@bounded_cache("knn_point_pairs", 1)
def _point_pair_prog():
    """The ONE (query point, candidate row) distance program all
    frontends share: `_distance_dense` of each pair, as eager torch ops
    on the candidate column's device. Lives in the dispatch cache
    registry (name ``knn_point_pairs``) so `cache_stats`/`clear_caches`
    cover it."""
    from ..core.geometry.device import take_rows
    from ..functions.geometry import _distance_dense, _vmap_pair

    def run(dcs, qxy, crows):
        dq = _point_column(qxy, dcs.shift)
        return _vmap_pair(_distance_dense, dq, take_rows(dcs, crows))

    return run


@bounded_cache("knn_point_pairs_sharded", 8)
def _sharded_point_pairs(mesh):
    """The meshed pair program: the candidate column replicated (placed
    once a distinct device), query coordinates and candidate rows sharded
    over the pair axis (the `parallel/dist_knn` layout — embarrassingly
    parallel, no collective)."""
    from ..parallel import mesh as _mesh

    def run(dcs, qxy, crows):
        return _mesh.run_sharded(
            lambda q, r, d: _point_pair_prog()(d, q, r), mesh,
            sharded=(qxy, crows), replicated=(dcs,),
        )

    return run


def _merge_topk(dist, cid, qi, ci, d, k):
    """Pure top-k merge: fold (query, candidate, distance) triples into
    the running (dist, cid) state, ranked lexicographically by
    ``(distance, candidate_id)`` — the oracle's tie rule, and equal to
    the batch model's insertion merge on tie-free data. Pairs are
    deduplicated upstream (``seen`` sets), so a candidate can never
    appear twice in one row."""
    dist = dist.copy()
    cid = cid.copy()
    for i in np.unique(qi):
        m = qi == i
        cd = np.concatenate([dist[i], d[m]])
        cc = np.concatenate([cid[i], ci[m]])
        take = np.lexsort((cc, cd))[:k]
        dist[i] = cd[take]
        cid[i] = cc[take]
    return dist, cid


def _shell_rows(cells: np.ndarray) -> list:
    """Per row of a (n, M) ``k_ring``/``k_loop`` result, its distinct
    valid cells."""
    return [np.unique(row[row >= 0]) for row in np.asarray(cells)]


def _ring_width(k: int) -> int:
    return 1 + 3 * k * (k + 1)


def _grow(system, disks: list) -> list:
    """One ring more of each disk (1-D ascending cells, untruncated):
    ONE batched ``disk_grow`` call over all of them."""
    width = max(d.size for d in disks)
    batch = np.full((len(disks), width), -1, dtype=np.int64)
    for r, d in enumerate(disks):
        batch[r, : d.size] = d
    return [row[row >= 0] for row in system.disk_grow(batch)]


class _Rings:
    """The k-rings and k-loops of each query's seed cell, ring by ring.

    A system with ``disk_grow`` (H3, whose rings are expanded
    geometrically) has each query's disk kept between calls and grown by
    one round per ring: radius k costs one round, where ``k_ring(k)``
    and ``k_loop(k)`` each start over from the seed (``k_loop(k)`` runs
    ``2k - 1`` rounds). The cells are ``k_ring``/``k_loop``'s, truncated
    as they truncate. Other systems (closed-form rings) are asked
    directly, one batched call. Growth is pure: :meth:`loops` returns the
    grown disks and :meth:`commit` keeps them, so a retried expand
    re-reads the same state."""

    def __init__(self, system, seeds: np.ndarray):
        self.system = system
        self.seeds = seeds
        self.grows = callable(getattr(system, "disk_grow", None))
        self.disks: dict = {}  # query -> (level, 1-D disk)

    def _level(self, i: int):
        return self.disks.get(i, (0, self.seeds[i : i + 1].copy()))

    def loops(self, active: list, it: int):
        """(per active query its shell at radius ``it`` — ``k_ring(1)``
        for ``it`` 1, else ``k_loop(it)`` —, the grown disks)."""
        sel = self.seeds[np.asarray(active, dtype=np.int64)]
        if not self.grows:
            if it == 1:
                return _shell_rows(self.system.k_ring(sel, 1)), {}
            return _shell_rows(self.system.k_loop(sel, it)), {}
        prev = [self._level(i) for i in active]
        if any(lv != it - 1 for lv, _ in prev):
            raise RuntimeError(f"KNN ring disks out of step at radius {it}")
        grown = _grow(self.system, [d for _, d in prev])
        shells = []
        for (_, inner), full in zip(prev, grown):
            full_t = full[: _ring_width(it)]
            if it == 1:
                shells.append(full_t)
                continue
            inner_t = inner[: _ring_width(it - 1)]
            shells.append(full_t[~np.isin(full_t, inner_t)][: 6 * it])
        return shells, {i: (it, d) for i, d in zip(active, grown)}

    def commit(self, grown: dict) -> None:
        self.disks.update(grown)

    def disks_of(self, idx: list, radii: list) -> list:
        """``k_ring(seed, r)`` cells of each query ``idx[j]`` at its own
        radius ``radii[j]``: every radius from one shared growth."""
        if not self.grows:
            out = [None] * len(idx)
            for r in sorted(set(radii)):
                pick = [j for j, rj in enumerate(radii) if rj == r]
                rows = self.system.k_ring(self.seeds[np.asarray([idx[j] for j in pick])], r)
                for j, cells in zip(pick, _shell_rows(rows)):
                    out[j] = cells
            return out
        out = [None] * len(idx)
        disks = [self.seeds[i : i + 1].copy() for i in idx]
        live = list(range(len(idx)))
        level = 0
        while live:
            for j in [j for j in live if radii[j] == level]:
                out[j] = disks[j][: _ring_width(level)]
            live = [j for j in live if radii[j] > level]
            if live:
                for j, d in zip(live, _grow(self.system, [disks[j] for j in live])):
                    disks[j] = d
            level += 1
        return out


class KNNFrontend:
    """Online KNN over a resident :class:`KNNIndex` (see module doc). Runs
    on the index's device."""

    def __init__(
        self,
        kx: KNNIndex,
        *,
        lane: str = "ring",
        pair_ladder: "BucketLadder | None" = None,
        row_ladder: "BucketLadder | None" = None,
        max_iterations: int = 64,
        mesh=None,
        program_store=None,
        on_cold_compile=None,
    ):
        if lane not in ("ring", "voronoi"):
            raise ValueError(f"unknown knn lane {lane!r}")
        if kx.n == 0:
            raise ValueError(
                "KNNFrontend needs a non-empty candidate index (warmup "
                "dispatches pair batches against candidate row 0)"
            )
        self.kx = kx
        self.lane = lane
        self.pair_ladder = pair_ladder or DEFAULT_PAIR_LADDER
        self.row_ladder = row_ladder or DEFAULT_ROW_LADDER
        self.max_iterations = int(max_iterations)
        self.device = kx.device
        self.mesh = resolve_mesh(mesh, device=self.device)
        if self.mesh is not None:
            for b in self.pair_ladder.buckets:
                if b % self.mesh.size:
                    raise ValueError(
                        f"pair bucket {b} does not divide over the "
                        f"{self.mesh.size}-device mesh"
                    )
        #: past the retry budget only a frontend on the CPU answers from
        #: the host oracle; on the card the batch raises RetryExhausted
        self._degrade_to_host = self.device.type == "cpu"
        self._dtype = kx.dc.verts.dtype
        self._signatures: set = set()
        self._warmed: "frozenset | None" = None
        self._cold_compiles = 0
        self._on_cold_compile = on_cold_compile
        # the program store mirrors DispatchCore's: explicit arg beats the
        # MOSAIC_PROGRAM_STORE knob; a meshed frontend refuses it
        self._programs = resolve_program_store(program_store)
        if self._programs is not None and self.mesh is not None:
            _telemetry.record(
                "program_store_refused", reason="mesh",
                devices=self.mesh.size,
            )
            self._programs = None
        self._aot: dict = {}  # (kind, bucket) -> manifest | None
        self.aot_stats = {"loaded": 0, "exported": 0, "fallback": 0}
        self.stats = {
            "queries": 0,
            "pairs": 0,
            "pairs_padded": 0,
            "iterations": 0,
            "degraded": 0,
            "lane_ring": 0,
            "lane_voronoi": 0,
            "voronoi_fallback": 0,
        }

    # ------------------------------------------------------- accounting

    @property
    def cold_compiles(self) -> int:
        """Signatures first seen AFTER :meth:`warmup` froze the set."""
        return self._cold_compiles

    def signature_count(self) -> int:
        return len(self._signatures)

    def freeze(self) -> None:
        self._warmed = frozenset(self._signatures)

    def _note(self, kind: str, bucket: int) -> bool:
        sig = (
            "knn", kind, int(bucket), mesh_key(self.mesh), self.kx.fingerprint,
        )
        if sig in self._signatures:
            return False
        self._signatures.add(sig)
        if self._warmed is not None:
            self._cold_compiles += 1
            if self._on_cold_compile is not None:
                self._on_cold_compile(bucket, len(self._signatures))
            else:
                _telemetry.record(
                    "knn_compile", kind=kind, bucket=bucket,
                    signatures=len(self._signatures),
                )
        return True

    # ----------------------------------------------------- AOT programs

    def _aot_program(self, kind: str, bucket: int):
        """The (kind, bucket) program's manifest, loaded from the store or
        exported; any failure other than the store's typed refusals
        records ``program_store_fallback``."""
        key = (kind, bucket)
        if key in self._aot:
            return self._aot[key]
        with _trace.span("knn.aot", kind=kind, bucket=bucket):
            try:
                doc = self._load_or_export(kind, bucket)
            except Exception as e:  # lint: broad-except-ok (the store is an optimization: ANY failure in it must leave the frontend serving, not take it down)
                _telemetry.record(
                    "program_store_fallback", bucket=bucket,
                    error=repr(e)[:200],
                )
                self.aot_stats["fallback"] += 1
                doc = None
        self._aot[key] = doc
        return doc

    def _load_or_export(self, kind: str, bucket: int):
        if kind == "cells":
            statics = {"bucket": bucket, "resolution": int(self.kx.resolution)}
        else:
            statics = {
                "bucket": bucket,
                "dtype": str(self._dtype).removeprefix("torch."),
            }
        return _programs.one_program(
            self._programs,
            _programs.program_key(self.kx.fingerprint, f"knn_{kind}", **statics),
            _programs.manifest(f"knn_{kind}", statics),
            {"kind": f"knn_{kind}", "bucket": bucket},
            self.aot_stats, None,
        )

    # ---------------------------------------------------- device entries

    def _cells_bucket(self, padded: np.ndarray) -> np.ndarray:
        """One full-bucket cell assignment on the index's device (f64
        coordinates, the shared `cells_prog` callable)."""
        b = padded.shape[0]
        self._note("cells", b)
        if self._programs is not None:
            self._aot_program("cells", b)
        fn = cells_prog(self.kx.index_system, self.kx.resolution, "cells")
        with _device_scope(self.device):
            dev = torch.from_numpy(np.ascontiguousarray(padded, dtype=np.float64))
            cells = fn(dev.to(self.device))
            return np.asarray(torch.as_tensor(cells).cpu().numpy(), dtype=np.int64)

    def _assign_cells(self, pts: np.ndarray) -> np.ndarray:
        """(n, 2) raw query coords -> (n,) int64 seed cells, chunked
        through the row ladder."""
        n = pts.shape[0]
        out = np.empty(n, dtype=np.int64)
        step = self.row_ladder.max_bucket
        for c0 in range(0, n, step):
            chunk = pts[c0 : c0 + step]
            m = chunk.shape[0]
            padded, _ = self.row_ladder.pad(chunk)
            out[c0 : c0 + m] = self._cells_bucket(padded)[:m]
        return out

    def _pair_bucket(self, qxy: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """One padded pair dispatch: (m, 2) shifted query coords x (m,)
        candidate rows -> (m,) f64 distances."""
        m = qxy.shape[0]
        b = self.pair_ladder.bucket_for(m)
        if b > m:
            # pad pairs repeat the first pair (inert, sliced off below)
            qxy = np.concatenate([qxy, np.broadcast_to(qxy[:1], (b - m, 2))])
            rows = np.concatenate([rows, np.broadcast_to(rows[:1], (b - m,))])
        self._note("pairs", b)
        self.stats["pairs"] += m
        self.stats["pairs_padded"] += b
        if self._programs is not None:
            self._aot_program("pairs", b)
        with _trace.span("knn.pairs", bucket=b, pairs=m), _device_scope(self.device):
            qdev = torch.from_numpy(np.ascontiguousarray(qxy, dtype=np.float64))
            rdev = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
            prog = (
                _point_pair_prog() if self.mesh is None
                else _sharded_point_pairs(self.mesh)
            )
            vals = prog(
                self.kx.dc, qdev.to(self.device, self._dtype), rdev.to(self.device)
            )
            out = vals.to(torch.float64).cpu().numpy()
        return out[:m]

    def _pair_values(self, qsd, qi, ci) -> np.ndarray:
        """All (query, candidate) pair distances, chunked at the top pair
        rung (an arbitrarily large cover never invents a new shape)."""
        total = qi.shape[0]
        out = np.empty(total, dtype=np.float64)
        step = self.pair_ladder.max_bucket
        for c0 in range(0, total, step):
            c1 = min(total, c0 + step)
            out[c0:c1] = self._pair_bucket(qsd[qi[c0:c1]], ci[c0:c1])
        return out

    def _distances(self, qs64, qsd, qi, ci, default_s):
        """The ``knn.distance`` failure domain: the device pair batch under
        watchdog + retry; past the budget a CPU frontend degrades to the
        exact f64 host oracle, a frontend on the card raises."""
        if not qi.size:
            return np.zeros(0)
        fallback = None
        if self._degrade_to_host:
            fallback = lambda: host_pair_distances(qs64, self.kx, qi, ci)  # noqa: E731
        return guarded_call(
            "knn.distance",
            lambda: self._pair_values(qsd, qi, ci),
            default_s=default_s,
            fallback=fallback,
        )

    # ------------------------------------------------------- ring lane

    def _ring_lane(self, pts, k, default_s):
        """Exact iterative lane — the batch model's loop
        (`models/knn.SpatialKNN.transform`) with serve discipline."""
        kx = self.kx
        n = pts.shape[0]
        qs64 = pts - kx.shift
        qsd = qs64
        dist = np.full((n, k), np.inf)
        cid = np.full((n, k), -1, dtype=np.int64)
        seen: list = [set() for _ in range(n)]
        rings = _Rings(kx.index_system, self._assign_cells(pts))
        w = kx.cell_width
        degraded = None
        for it in range(1, self.max_iterations + 1):
            # the batch model's rest criterion: a query rests once it
            # holds k matches AND the grid-guaranteed covered radius
            # (it-1)*w reaches its kth distance; candidate exhaustion
            # rests it early (no candidates remain)
            active = [
                i
                for i in range(n)
                if len(seen[i]) < kx.n
                and (
                    int((cid[i] >= 0).sum()) < k
                    or (it - 1) * w < dist[i, k - 1]
                )
            ]
            if not active:
                break
            self.stats["iterations"] += 1

            def expand():
                # pure: fresh (query, sorted candidate rows) pairs and the
                # grown disks; the ``seen`` and disk commits happen AFTER
                # the guarded call returns so a transient-fault retry
                # re-reads identical state
                shells, grown = rings.loops(active, it)
                found = []
                for i, cells in zip(active, shells):
                    rows = kx.candidate_rows(np.unique(cells))
                    fresh = sorted(set(rows.tolist()) - seen[i])
                    if fresh:
                        found.append((i, fresh))
                return found, grown

            with _telemetry.timed(
                "knn_stage", stage="expand", iteration=it,
                queries=len(active),
            ):
                found, grown = guarded_call("knn.expand", expand)
            rings.commit(grown)
            qi_l, ci_l = [], []
            for i, fresh in found:
                seen[i].update(fresh)
                qi_l.extend([i] * len(fresh))
                ci_l.extend(fresh)
            qi = np.asarray(qi_l, dtype=np.int64)
            ci = np.asarray(ci_l, dtype=np.int64)
            if not qi.size:
                continue
            with _telemetry.timed(
                "knn_stage", stage="distance", pairs=int(qi.size),
            ):
                d = self._distances(qs64, qsd, qi, ci, default_s)
            if isinstance(d, DegradedResult):
                # the first degraded batch names the answer's degradation
                # (``degraded or d`` would test an array's truth)
                degraded = d if degraded is None else degraded
                d = np.asarray(d)
            with _telemetry.timed(
                "knn_stage", stage="scatter", pairs=int(qi.size),
            ):
                dist, cid = guarded_call(
                    "knn.scatter",
                    lambda: _merge_topk(dist, cid, qi, ci, d, k),
                )
        return dist, cid, degraded

    # ---------------------------------------------------- voronoi lane

    def _walk_rows(self, qv: np.ndarray, k: int):
        """Greedy walk on the Voronoi adjacency to a locally nearest
        convex site, then breadth-first neighbour collection until k
        distinct candidate geoms are reachable. Returns (rows, ok)."""
        vt = self.kx.voronoi
        sites, adj = vt.sites, vt.adjacency
        cv = sites.shape[0]
        stride = max(1, cv // 64)
        probe = np.arange(0, cv, stride)
        d2 = np.sum((sites[probe] - qv) ** 2, axis=1)
        cur = int(probe[int(np.argmin(d2))])
        curd = float(np.sum((sites[cur] - qv) ** 2))
        while True:
            nbrs = adj[cur]
            nbrs = nbrs[nbrs >= 0]
            if not nbrs.size:
                break
            nd = np.sum((sites[nbrs] - qv) ** 2, axis=1)
            j = int(np.argmin(nd))
            if nd[j] < curd:
                cur, curd = int(nbrs[j]), float(nd[j])
            else:
                break
        rows = {int(vt.geom[cur])}
        seen_sites = {cur}
        frontier = [cur]
        while frontier and len(rows) < k:
            nxt = []
            for s in frontier:
                for t in adj[s]:
                    t = int(t)
                    if t < 0 or t in seen_sites:
                        continue
                    seen_sites.add(t)
                    nxt.append(t)
                    rows.add(int(vt.geom[t]))
            frontier = nxt
        return np.fromiter(sorted(rows), dtype=np.int64), len(rows) >= k

    def _voronoi_lane(self, pts, k, default_s):
        """One-shot exact lane: the walk's kth-distance bound collapses
        ring iteration into a single guaranteed cover dispatch (grid
        radius r satisfies (r-1)*w >= bound, the guarantee the iterative
        stop rule relies on — so the answer is the ring lane's answer, in
        one device round trip)."""
        kx = self.kx
        vt = kx.voronoi
        n = pts.shape[0]
        qs64 = pts - kx.shift
        qsd = qs64
        qv = pts - vt.shift
        w = kx.cell_width
        dist = np.full((n, k), np.inf)
        cid = np.full((n, k), -1, dtype=np.int64)
        degraded = None

        def expand():
            # pure: per-query cover pairs + the indices the walk could not
            # bound (they take the iterative lane below); every cover
            # radius comes from one shared ring-by-ring growth
            rings = _Rings(kx.index_system, self._assign_cells(pts))
            radius, fallback = {}, []
            for i in range(n):
                rows, ok = self._walk_rows(qv[i], k)
                if not ok:
                    fallback.append(i)
                    continue
                ds = host_pair_distances(
                    qs64, kx, np.full(rows.shape[0], i, np.int64), rows
                )
                bound = float(np.partition(ds, k - 1)[k - 1])
                r = int(np.ceil(bound / w)) + 1 if bound > 0 else 1
                if r > self.max_iterations:
                    fallback.append(i)
                    continue
                radius[i] = r
            idx = sorted(radius)
            covers = rings.disks_of(idx, [radius[i] for i in idx])
            pairs = [
                (i, np.sort(kx.candidate_rows(np.unique(cells))))
                for i, cells in zip(idx, covers)
            ]
            return pairs, fallback

        with _telemetry.timed(
            "knn_stage", stage="expand", lane="voronoi", queries=n,
        ):
            pairs, fallback = guarded_call("knn.expand", expand)
        self.stats["voronoi_fallback"] += len(fallback)
        qi = np.concatenate(
            [np.full(r.shape[0], i, np.int64) for i, r in pairs]
        ) if pairs else np.zeros(0, dtype=np.int64)
        ci = np.concatenate([r for _, r in pairs]) if pairs else np.zeros(
            0, dtype=np.int64
        )
        if qi.size:
            with _telemetry.timed(
                "knn_stage", stage="distance", lane="voronoi",
                pairs=int(qi.size),
            ):
                d = self._distances(qs64, qsd, qi, ci, default_s)
            if isinstance(d, DegradedResult):
                degraded = d
                d = np.asarray(d)
            with _telemetry.timed(
                "knn_stage", stage="scatter", lane="voronoi",
                pairs=int(qi.size),
            ):
                dist, cid = guarded_call(
                    "knn.scatter",
                    lambda: _merge_topk(dist, cid, qi, ci, d, k),
                )
        if fallback:
            sub = np.asarray(fallback, dtype=np.int64)
            fdist, fcid, fdeg = self._ring_lane(pts[sub], k, default_s)
            dist[sub] = fdist
            cid[sub] = fcid
            degraded = fdeg if degraded is None else degraded
        return dist, cid, degraded

    # --------------------------------------------------------- serving

    def dispatch(self, points: np.ndarray, k: int, default_s=None):
        """Answer a batch: (n, 2) raw query coords -> ((n, 2k) f64 wire
        rows ``[distances ‖ ids]``, pair occupancy). Degraded batches
        (CPU only) come back as :class:`DegradedResult` (values exact —
        the host oracle computed them)."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        pts = np.asarray(points, dtype=np.float64)
        n = pts.shape[0]
        if n == 0:
            return np.zeros((0, 2 * k)), 1.0
        p0, b0 = self.stats["pairs"], self.stats["pairs_padded"]
        lane = (
            "voronoi"
            if self.lane == "voronoi" and self.kx.voronoi is not None
            else "ring"
        )
        with _trace.span("knn.dispatch", rows=n, k=k, lane=lane):
            if lane == "voronoi":
                dist, cid, deg = self._voronoi_lane(pts, k, default_s)
            else:
                dist, cid, deg = self._ring_lane(pts, k, default_s)
        self.stats["queries"] += n
        self.stats[f"lane_{lane}"] += n
        out = np.empty((n, 2 * k))
        out[:, :k] = dist
        out[:, k:] = cid.astype(np.float64)
        padded = self.stats["pairs_padded"] - b0
        occupancy = (self.stats["pairs"] - p0) / padded if padded else 1.0
        if deg is not None:
            self.stats["degraded"] += n
            return (
                DegradedResult.wrap(out, reason=deg.reason, attempts=deg.attempts),
                occupancy,
            )
        return out, occupancy

    def query(self, points: np.ndarray, k: int) -> "list[KNNAnswer]":
        """Direct (engine-less) entry: one :class:`KNNAnswer` per row."""
        out, _ = self.dispatch(points, k)
        degraded = isinstance(out, DegradedResult)
        reason = out.reason if degraded else None
        ids, dist = decode_knn(np.asarray(out), k)
        return [
            KNNAnswer(ids=ids[i], distance=dist[i], degraded=degraded, reason=reason)
            for i in range(ids.shape[0])
        ]

    def warmup(self) -> dict:
        """Run every (kind, rung) pair once so serving only replays, then
        freeze the signature set — any later signature is a cold compile
        and fires ``on_cold_compile``. ``backend_compiles`` counts the
        nvcc builds started meanwhile (none: the pair program is torch)."""
        c0 = backend_compiles()
        with _trace.span("knn.warmup"):
            for b in self.row_ladder.buckets:
                with _telemetry.timed(
                    "knn_stage", stage="warmup", kind="cells", bucket=b,
                ):
                    self._cells_bucket(np.zeros((b, 2)))
            for b in self.pair_ladder.buckets:
                with _telemetry.timed(
                    "knn_stage", stage="warmup", kind="pairs", bucket=b,
                ):
                    self._pair_bucket(
                        np.zeros((b, 2)), np.zeros(b, dtype=np.int64),
                    )
        self.freeze()
        report = {
            "signatures": len(self._signatures),
            "row_buckets": len(self.row_ladder.buckets),
            "pair_buckets": len(self.pair_ladder.buckets),
            "backend_compiles": backend_compiles() - c0,
            "aot": dict(self.aot_stats),
        }
        _telemetry.record("knn_warmup", **report)
        return report

    def metrics(self) -> dict:
        return {
            "knn_queries": self.stats["queries"],
            "knn_pairs": self.stats["pairs"],
            "knn_pair_occupancy": (
                self.stats["pairs"] / self.stats["pairs_padded"]
                if self.stats["pairs_padded"]
                else None
            ),
            "knn_iterations": self.stats["iterations"],
            "knn_degraded": self.stats["degraded"],
            "knn_lane_ring": self.stats["lane_ring"],
            "knn_lane_voronoi": self.stats["lane_voronoi"],
            "knn_voronoi_fallback": self.stats["voronoi_fallback"],
            "knn_signatures": len(self._signatures),
            "knn_cold_compiles": self._cold_compiles,
            "knn_aot": dict(self.aot_stats),
        }
