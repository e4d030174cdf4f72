"""H3IndexSystem: the IndexSystem contract over the from-scratch H3 core.

Port of ``mosaic_tpu/core/index/h3/index.py``. ``point_to_cell`` is one
fused array program: numpy on the host (float64, the exact path that
tessellation and the host oracle use) and, for a tensor, the CUDA kernel
of `kernels/h3.py` on the card (the join's cell assignment, float32
there) or its plain torch chain on the CPU. Everything else — centers,
boundaries, neighbors, k-rings and loops, grid distance, polyfill
candidates — runs on the host in numpy,
as in the reference, and accepts tensors by moving them to the host.

Coordinates are (lng, lat) degrees in xy order, matching GeoJSON and the
rest of the framework.

Pentagon handling (host path): cell centers on the 12 pentagon base cells
are round-trip exact (`core._pentagon_unfold_repair`), pentagon boundaries
emit the 5 true vertices (`_pentagon_boundary`), and pentagon neighbor
stepping yields the 5 adjacent cells.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ....kernels import _build
from ....kernels import h3 as _h3_kernel
from ....obs import metrics as _metrics
from ..base import IndexSystem
from . import constants as C
from . import core
from . import hexmath as hm
from .tables import derive


def _cell_radius_rad(res: int) -> float:
    """Approximate hexagon circumradius in radians at a resolution."""
    return float(np.arctan(C.RES0_U_GNOMONIC / np.sqrt(3.0) / (C.SQRT7**res)))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class H3IndexSystem(IndexSystem):
    name = "H3"
    boundary_max_verts = 7  # 6 + closing vertex

    def resolutions(self) -> Sequence[int]:
        return list(range(C.MAX_RES + 1))

    def resolution_of(self, cells):
        """(N,) int32 resolution of each cell id (host numpy; a tensor
        comes back as a tensor on its device)."""
        if isinstance(cells, torch.Tensor):
            return ((cells.to(torch.int64) >> C.RES_OFFSET) & 0xF).to(torch.int32)
        cells = np.asarray(cells).astype(np.int64)
        return ((cells >> C.RES_OFFSET) & 0xF).astype(np.int32)

    def buffer_radius(self, resolution: int) -> float:
        return float(np.degrees(_cell_radius_rad(resolution)))

    def cell_area_approx(self, resolution: int) -> float:
        """Mean cell area in square degrees (CRS units of EPSG:4326)."""
        sphere_sq_deg = 4 * np.pi * (180 / np.pi) ** 2
        n_cells = 2 + 120 * (7**resolution)
        return float(sphere_sq_deg / n_cells)

    def is_valid(self, cells):
        """(N,) bool validity of each id (host numpy; a tensor comes back
        as a tensor on its device)."""
        out = core.is_valid_cell(np.asarray(_host(cells)), np)
        if isinstance(cells, torch.Tensor):
            return torch.as_tensor(out, device=cells.device)
        return out

    def is_pentagon(self, cells):
        """(N,) bool: the cell is one of the 12 pentagons of its
        resolution (host numpy)."""
        return np.asarray(
            core.is_pentagon_cell(np.asarray(_host(cells), dtype=np.int64), np),
            dtype=bool,
        )

    # ---------------------------------------------------------------- core
    def _geo(self, xy, resolution: int, with_margin: bool = False, alt: bool = False):
        """Cell assignment: numpy on the host for an array; for a tensor,
        the CUDA kernel on the card (`kernels/h3.py`), the plain torch
        chain off it and for the ``alt`` variant. Each tensor call adds
        its point count, read off the shape, to
        ``h3.cells_points{lane, variant}`` once it has queued its work; a
        call captured into a CUDA graph adds it at each replay."""
        if not isinstance(xy, torch.Tensor):
            xy = np.asarray(xy)
            lng = np.radians(xy[..., 0])
            lat = np.radians(xy[..., 1])
            return core.geo_to_cell(lat, lng, resolution, np, with_margin, alt)
        kernel = xy.device.type == "cuda" and not alt
        if kernel:
            out = _h3_kernel.geo_to_cell_kernel(xy, resolution, with_margin)
        else:
            out = _h3_kernel.geo_to_cell_plain(xy, resolution, with_margin, alt)
        n = xy.numel() // 2
        labels = {"lane": "kernel" if kernel else "plain",
                  "variant": "alt" if alt else "margin" if with_margin else "cells"}

        def count():
            _metrics.counter("h3.cells_points").inc(n, **labels)

        if xy.device.type == "cuda":
            _build.on_each_run(count)
        else:
            count()
        return out

    def cell_kernel_libraries(self, device) -> list[str]:
        """``["h3"]`` on the card, where a tensor's cells come from the
        kernel of `kernels/h3.py`; none on the CPU."""
        return ["h3"] if torch.device(device).type == "cuda" else []

    def point_to_cell(self, xy, resolution: int):
        """(N, 2) lng/lat degrees -> (N,) int64 cells: numpy for a numpy
        input, torch on the tensor's device (in its dtype) for a tensor."""
        return self._geo(xy, resolution)

    def point_to_cell_margin(self, xy, resolution: int):
        """Cells plus the (..., 2) relative margins of the finest-res hex
        rounding (nearest and second-nearest boundary; see
        `core._rel_margin`) — the epsilon-band input for the f64
        borderline recheck in `sql.join`."""
        return self._geo(xy, resolution, with_margin=True)

    def point_to_cell_alt(self, xy, resolution: int):
        """Runner-up cell of the finest-res rounding: for a point flagged
        borderline (small first margin, ample second), the true f64 cell
        is the primary or this one. -1 where no valid alternate exists
        (face-overage corner) — callers escalate those to the host path."""
        return self._geo(xy, resolution, alt=True)

    def cell_center(self, cells):
        if isinstance(cells, torch.Tensor):
            return torch.as_tensor(self.cell_center(_host(cells)))
        cells = np.asarray(cells)
        lat, lng = core.cell_to_geo(cells, np)
        return np.stack([np.degrees(lng), np.degrees(lat)], axis=-1)

    def cell_boundary(self, cells):
        if isinstance(cells, torch.Tensor):
            return torch.as_tensor(self.cell_boundary(_host(cells)))
        if np.ndim(cells) == 0:
            return self.cell_boundary(np.asarray(cells).reshape(1))[0]
        cells = np.asarray(cells)
        lats, lngs = core.cell_boundary(cells, np)
        # close the ring: repeat first vertex
        lats = np.concatenate([lats, lats[..., :1]], axis=-1)
        lngs = np.concatenate([lngs, lngs[..., :1]], axis=-1)
        out = np.stack([np.degrees(lngs), np.degrees(lats)], axis=-1)
        if out.ndim == 3:
            pent = np.asarray(core.is_pentagon_cell(cells, np), dtype=bool)
            if pent.any():
                out = out.copy()
                out[pent] = self._pentagon_boundary(cells[pent].reshape(-1))
        return out

    def _pentagon_boundary(self, cells: np.ndarray) -> np.ndarray:
        """(P,) pentagon cells -> (P, 7, 2) lng/lat deg: 5 TRUE vertices
        (each the spherical circumcenter of the cell center and two
        azimuth-adjacent neighbor centers — the point where three cells
        meet), closed and padded by repeating the first vertex.

        Reference behavior: the H3 C core emits 5 distinct vertices for
        pentagons (`core/index/H3IndexSystem.scala:93-100` closes the ring
        the same way)."""
        P = cells.shape[0]
        nb = self.neighbors(cells)  # (P, 6), -1 pads (pentagons have 5)
        ctr = self.cell_center(cells)  # (P, 2) lng/lat deg
        out = np.zeros((P, 7, 2))
        for p in range(P):
            ns = nb[p][nb[p] >= 0]
            nctr = self.cell_center(ns)  # (K, 2)
            clng, clat = np.radians(ctr[p, 0]), np.radians(ctr[p, 1])
            nlng, nlat = np.radians(nctr[:, 0]), np.radians(nctr[:, 1])
            az = np.arctan2(
                np.sin(nlng - clng) * np.cos(nlat),
                np.cos(clat) * np.sin(nlat)
                - np.sin(clat) * np.cos(nlat) * np.cos(nlng - clng),
            )
            # ascending compass bearing sweeps CW; reverse for CCW rings
            # (hexagon boundaries from the lattice path are CCW)
            order = np.argsort(az)[::-1]
            nlat, nlng = nlat[order], nlng[order]
            c3 = np.array(
                [np.cos(clat) * np.cos(clng), np.cos(clat) * np.sin(clng), np.sin(clat)]
            )
            n3 = np.stack(
                [np.cos(nlat) * np.cos(nlng), np.cos(nlat) * np.sin(nlng), np.sin(nlat)],
                -1,
            )  # (K, 3)
            K = n3.shape[0]
            verts = []
            for m in range(K):
                a, b = n3[m], n3[(m + 1) % K]
                v = np.cross(b - c3, a - c3)
                v /= max(np.linalg.norm(v), 1e-15)
                if np.dot(v, c3) < 0:
                    v = -v
                verts.append((np.arctan2(v[1], v[0]), np.arcsin(v[2])))
            ring = np.asarray(verts)  # (K, 2) lng/lat rad
            row = np.degrees(
                np.concatenate([ring, ring[:1], ring[:1]], axis=0)
            )[:7]
            out[p, : row.shape[0]] = row
            out[p, row.shape[0] :] = row[-1]
        return out

    # ----------------------------------------------------------- neighbors
    def neighbors_raw(self, cells) -> np.ndarray:
        """(N,) -> (N, 6) raw neighbor candidates — vectorized, MAY contain
        duplicates and the cell itself (pentagon distortion); no -1s.

        Table-free: steps from each cell center past each edge midpoint in
        the owning face's exact grid frame, then re-rounds — the geometric
        equivalent of the C library's h3NeighborRotations tables.
        """
        xp = np
        cells = np.asarray(cells, dtype=np.int64).reshape(-1)
        face, cx, cy, res_arr = core.cell_center_frame(cells, xp)
        N = len(cells)
        # all 6 directions in one flattened projection/round-trip
        ang = np.arange(6) * (np.pi / 3)
        nx = (cx[:, None] + np.cos(ang)[None, :]).reshape(-1)  # (N*6,)
        ny = (cy[:, None] + np.sin(ang)[None, :]).reshape(-1)
        face6 = np.repeat(face, 6)
        res6 = np.repeat(res_arr, 6)
        lat, lng = core._per_res_geo(face6, nx, ny, res6, xp)
        ncell = np.full(N * 6, -1, dtype=np.int64)
        for r in np.unique(res6):
            sel = res6 == r
            ncell[sel] = core.geo_to_cell(lat[sel], lng[sel], int(r), xp)
        out = ncell.reshape(N, 6)

        # pentagon-distorted rows: 6 lattice steps from a (repaired,
        # non-lattice-aligned) center can miss an adjacent cell — re-derive
        # those rows from a dense unit circle around the center. Applies to
        # pentagons, rows that stepped onto themselves (distortion), and
        # hexagons adjacent to a pentagon (their ring is distorted too).
        pent = np.asarray(core.is_pentagon_cell(cells, xp), dtype=bool)
        srt = np.sort(out, axis=1)
        has_dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        nb_pent = np.asarray(
            core.is_pentagon_cell(out.reshape(-1), xp), dtype=bool
        ).reshape(N, 6).any(1)
        # pentagon rows at res >= 1 are EXACT by construction (the center
        # child's neighbors are its parent's 5 other children, K deleted).
        # Sibling membership is checked for EVERY row (cheap cached isin),
        # not only when a pentagon is in the same batch — results must not
        # depend on batch composition.
        sib_flag = np.zeros(N, dtype=bool)
        for r in np.unique(res_arr):
            if int(r) < 1:
                continue
            rows = dict(self._pentagon_rows(int(r)))
            m = res_arr == r
            for p in np.nonzero(m & pent)[0]:
                sibs = rows.get(int(cells[p]))
                if sibs is not None:
                    row = np.full(6, -1, dtype=np.int64)
                    s = sorted(sibs)[:6]
                    row[: len(s)] = s
                    out[p] = row
            # hexagons that are pentagon siblings must list the pentagon
            all_sibs = set()
            for pc, ss in rows.items():
                all_sibs |= ss
            sib_flag |= m & np.isin(cells, np.asarray(sorted(all_sibs)))
        near_pent = (
            (pent & (res_arr == 0))
            | sib_flag
            | nb_pent
            | has_dup
            | (out == cells[:, None]).any(1)
        ) & ~(pent & (res_arr >= 1))  # sibling rows are exact: keep them
        flagged = np.nonzero(near_pent)[0]
        counts = {}
        for p in flagged:
            out[p], counts[p] = self._boundary_walk_neighbors(
                int(cells[p]), int(face[p]), cx[p], cy[p], int(res_arr[p])
            )
        # symmetry patch: a pentagon-sibling hexagon whose boundary only
        # grazes the pentagon in a wedge the ray walk straddled still must
        # list it
        for p in flagged:
            if pent[p]:
                continue
            r = int(res_arr[p])
            for pcell, prow in self._pentagon_rows(r):
                if int(cells[p]) in prow and pcell not in out[p]:
                    row = out[p]
                    free = np.nonzero(row < 0)[0]
                    if free.size:
                        row[free[0]] = pcell
                    else:
                        # drop the least ray-supported entry
                        cnt = counts.get(p, {})
                        weakest = min(
                            range(6), key=lambda m2: cnt.get(int(row[m2]), 0)
                        )
                        row[weakest] = pcell
        return out

    def _pentagon_rows(self, res: int):
        """[(pentagon cell id, set of its 5 neighbors)] at ``res`` (cached).

        res >= 1: exact by construction — the pentagon is the center child
        of a pentagon parent, so its neighbors are the parent's children at
        digits {2..6} (digit 1, the K axis, is deleted on pentagons).
        res 0: derived by the boundary walk over base cells."""
        cache = getattr(self, "_pent_row_cache", {})
        if res not in cache:
            t = derive()
            rows = []
            for bc in np.nonzero(t.is_pentagon)[0]:
                digits = np.full((1, C.MAX_RES), C.INVALID_DIGIT, np.int64)
                digits[:, :res] = 0
                pcell = int(hm.pack(np.asarray([bc]), digits, res, np)[0])
                if res >= 1:
                    sibs = set()
                    for d in (2, 3, 4, 5, 6):
                        dd = digits.copy()
                        dd[:, res - 1] = d
                        sibs.add(int(hm.pack(np.asarray([bc]), dd, res, np)[0]))
                    rows.append((pcell, sibs))
                else:
                    f, px, py, rr = core.cell_center_frame(
                        np.asarray([pcell], dtype=np.int64), np
                    )
                    row, _ = self._boundary_walk_neighbors(
                        pcell, int(f[0]), px[0], py[0], res
                    )
                    rows.append((pcell, set(int(v) for v in row if v >= 0)))
            cache[res] = rows
            self._pent_row_cache = cache
        return cache[res]

    @staticmethod
    def _boundary_walk_neighbors(cell, face, cx, cy, res, n_rays: int = 36):
        """Edge-sharing neighbors of one (distorted) cell by walking its
        region boundary: in each direction, bisect the largest t with
        geo_to_cell(center + t*dir) == cell, then step just beyond — the
        cell found there shares boundary with ours. Exact for the
        pentagon-distorted regions where fixed lattice steps mis-hit.
        Returns (row (6,) int64 -1-padded, {cell: ray count})."""
        ang = np.arange(n_rays) * (2 * np.pi / n_rays)
        dx, dy = np.cos(ang), np.sin(ang)

        def assign(t):
            la, lo = core._per_res_geo(
                np.full(n_rays, face), cx + t * dx, cy + t * dy,
                np.full(n_rays, res), np,
            )
            return core.geo_to_cell(la, lo, res, np)

        lo_t = np.zeros(n_rays)
        hi_t = np.full(n_rays, 2.5)
        # ensure hi is outside (region radius is ~<1.2 grid units)
        for _ in range(3):
            on_cell = assign(hi_t) == cell
            if not on_cell.any():
                break
            hi_t = np.where(on_cell, hi_t * 2, hi_t)
        for _ in range(20):
            mid = (lo_t + hi_t) / 2
            inside = assign(mid) == cell
            lo_t = np.where(inside, mid, lo_t)
            hi_t = np.where(inside, hi_t, mid)
        nb = assign(lo_t + (hi_t - lo_t) * 2 + 1e-6)
        uniq = [c for c in dict.fromkeys(nb.tolist()) if c != cell]
        expected = 5 if bool(core.is_pentagon_cell(np.asarray([cell]), np)[0]) else 6
        if len(uniq) < expected and n_rays < 288:
            return H3IndexSystem._boundary_walk_neighbors(
                cell, face, cx, cy, res, n_rays * 4
            )
        cnt = {}
        for c in nb.tolist():
            if c != cell:
                cnt[c] = cnt.get(c, 0) + 1
        row = np.full(6, -1, dtype=np.int64)
        row[: min(6, len(uniq))] = uniq[:6]
        return row, cnt

    def neighbors(self, cells) -> np.ndarray:
        """(N,) -> (N, 6) adjacent cells (edge-sharing), -1 pads for
        pentagons/duplicates (first occurrence kept, order preserved)."""
        cells = np.asarray(cells, dtype=np.int64).reshape(-1)
        out = self.neighbors_raw(cells)
        for m in range(6):
            dup = out[:, m] == cells
            if m:
                dup |= (out[:, m : m + 1] == out[:, :m]).any(axis=1)
            out[dup, m] = -1
        return out

    @staticmethod
    def _row_unique(a: np.ndarray, width: int | None = None) -> np.ndarray:
        """Per-row sorted unique of an int64 array; -1 entries dropped,
        result left-packed ascending and -1-padded to ``width`` columns."""
        big = np.iinfo(np.int64).max
        s = np.sort(np.where(a < 0, big, a), axis=1)
        dup = np.zeros_like(s, dtype=bool)
        dup[:, 1:] = s[:, 1:] == s[:, :-1]
        s[dup] = big
        s = np.sort(s, axis=1)
        used = int((s != big).sum(axis=1).max()) if s.size else 0
        w = max(width if width is not None else used, 1)
        if s.shape[1] < w:
            s = np.pad(s, ((0, 0), (0, w - s.shape[1])), constant_values=big)
        s = s[:, :w]
        return np.where(s == big, np.int64(-1), s)

    def k_ring(self, cells, k: int) -> np.ndarray:
        """(N,) -> (N, 1+3k(k+1)) filled disk, sorted ascending, -1 pads
        (host numpy). Level-wise expansion: each round takes the raw
        neighbours of the whole current disk in one batched call and
        row-uniques them; a row does not depend on the other rows."""
        cells = np.asarray(_host(cells), dtype=np.int64).reshape(-1)
        N = cells.shape[0]
        m_out = 1 + 3 * k * (k + 1)
        disk = cells[:, None].copy()
        if N == 0 or k == 0:
            return self._row_unique(disk, width=m_out)
        for _ in range(k):
            disk = self.disk_grow(disk)
        return self._row_unique(disk, width=m_out)

    def disk_grow(self, disk: np.ndarray) -> np.ndarray:
        """One round of :meth:`k_ring`'s expansion: (N, W) disks (column 0
        each row's center, -1 pads) -> the disks one ring wider, sorted
        and -1-padded (untruncated). ``_row_unique(disk, 1+3k(k+1))``
        after k rounds from ``cells[:, None]`` is ``k_ring(cells, k)``; a
        caller growing disks ring by ring (the KNN frontend) reads every
        radius from one round each instead of k rounds a radius. The
        center stays in column 0 only in the first round's input: later
        rounds substitute the row's smallest cell for pads, whose
        neighbours the disk holds already."""
        disk = np.asarray(disk, dtype=np.int64)
        N = disk.shape[0]
        # -1 pads would corrupt the geometric step: substitute a cell of
        # the row (its neighbors are already in the disk)
        safe = np.where(disk >= 0, disk, disk[:, :1])
        nb = self.neighbors_raw(safe.reshape(-1)).reshape(N, -1)
        return self._row_unique(np.concatenate([disk, nb], axis=1))

    def k_loop(self, cells, k: int) -> np.ndarray:
        """Hollow ring: k_ring(k) minus k_ring(k-1); sorted, -1 pads."""
        cells = np.asarray(_host(cells), dtype=np.int64).reshape(-1)
        full = self.k_ring(cells, k)
        if k == 0:
            return full
        inner = self.k_ring(cells, k - 1)
        m_out = 6 * k
        # membership test: both sides sorted per row; chunk the broadcast
        N = full.shape[0]
        keep = np.zeros_like(full, dtype=bool)
        chunk = max(1, int(2e7 // max(full.shape[1] * inner.shape[1], 1)))
        for s in range(0, N, chunk):
            sl = slice(s, s + chunk)
            keep[sl] = (full[sl] >= 0) & ~(
                full[sl][:, :, None] == inner[sl][:, None, :]
            ).any(axis=2)
        out = np.where(keep, full, np.int64(-1))
        return self._row_unique(out, width=m_out)

    def grid_distance(self, cells_a, cells_b) -> np.ndarray:
        """Hex grid distance via planar ijk on a common face projection
        (host numpy). Exact when both cells project onto one face; a pair
        spanning icosahedron faces gives -1, the reference's
        flagged-failure contract."""
        xp = np
        a = np.asarray(_host(cells_a), dtype=np.int64)
        b = np.asarray(_host(cells_b), dtype=np.int64)
        fa, xa_, ya_, res_a = core.cell_center_frame(a, xp)
        fb, xb0, yb0, res_b = core.cell_center_frame(b, xp)
        lat_b, lng_b = core._per_res_geo(fb, xb0, yb0, res_b, xp)
        res_arr = (a >> C.RES_OFFSET) & 0xF
        # project both on a's owning face: exact for same-face pairs, and
        # cross-face pairs are flagged -1 below anyway
        out = np.zeros(len(a), dtype=np.int64)
        for r in np.unique(res_arr):
            sel = res_arr == r
            xa, ya = xa_[sel], ya_[sel]
            _, xb, yb = hm.geo_to_hex2d(lat_b[sel], lng_b[sel], int(r), face=fa[sel])
            ia, ja = hm.hex2d_to_axial(xa, ya)
            ib, jb = hm.hex2d_to_axial(xb, yb)
            di = ia - ib
            dj = ja - jb
            # hex distance in the (i at 0deg, j at 120deg) basis where the
            # six unit steps are +-(1,0), +-(0,1), +-(1,1)
            out[sel] = np.maximum.reduce(
                [np.abs(di), np.abs(dj), np.abs(di - dj)]
            )
        return np.where(fa != fb, np.int64(-1), out)

    # ------------------------------------------------------------ polyfill
    def _bbox_sample_points(
        self, bounds: np.ndarray, resolution: int
    ) -> np.ndarray:
        """(M, 2) lng/lat sample lattice covering one bbox densely enough
        that every cell intersecting it is hit or is a neighbor of a hit."""
        rad = np.degrees(_cell_radius_rad(resolution))
        lat_mid = np.clip((bounds[1] + bounds[3]) / 2, -89.0, 89.0)
        step_lat = max(rad * 0.8, 1e-7)
        step_lng = max(rad * 0.8 / max(np.cos(np.radians(lat_mid)), 0.05), 1e-7)
        xs = np.arange(bounds[0] - step_lng, bounds[2] + 2 * step_lng, step_lng)
        ys = np.arange(bounds[1] - step_lat, bounds[3] + 2 * step_lat, step_lat)
        ys = ys[(ys >= -90) & (ys <= 90)]
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        return np.stack([gx.ravel(), gy.ravel()], axis=-1)

    def polyfill_candidates(self, bounds: np.ndarray, resolution: int) -> np.ndarray:
        """Sample-grid candidates covering a lng/lat bbox, plus a 1-ring."""
        pts = self._bbox_sample_points(np.asarray(bounds, dtype=np.float64), resolution)
        if pts.size == 0:
            return np.zeros(0, np.int64)
        cells = np.unique(self.point_to_cell(pts, resolution))
        nb = self.neighbors_raw(cells)
        return np.unique(np.concatenate([cells, nb.reshape(-1)]))

    def polyfill_candidates_batch(
        self, bounds: np.ndarray, resolution: int
    ) -> list[np.ndarray]:
        """Batched `polyfill_candidates` over (G, 4) bboxes in TWO fused
        array calls total (one point->cell, one neighbor step) instead of
        2G — the per-geometry overhead dominates tessellation otherwise."""
        bounds = np.asarray(bounds, dtype=np.float64).reshape(-1, 4)
        G = bounds.shape[0]
        pts_list = [self._bbox_sample_points(bounds[g], resolution) for g in range(G)]
        sizes = np.asarray([p.shape[0] for p in pts_list], dtype=np.int64)
        if sizes.sum() == 0:
            return [np.zeros(0, np.int64) for _ in range(G)]
        pts = np.concatenate([p for p in pts_list if p.size])
        gid = np.repeat(np.arange(G), sizes)
        cells = np.asarray(self.point_to_cell(pts, resolution))
        # unique (gid, cell) pairs, then ONE neighbor expansion for all
        pair = np.unique(np.stack([gid, cells], axis=1), axis=0)
        nb = self.neighbors_raw(pair[:, 1])  # (P, 6)
        all_gid = np.concatenate([pair[:, 0], np.repeat(pair[:, 0], 6)])
        all_cell = np.concatenate([pair[:, 1], nb.reshape(-1)])
        pair2 = np.unique(np.stack([all_gid, all_cell], axis=1), axis=0)
        split = np.searchsorted(pair2[:, 0], np.arange(G + 1))
        return [pair2[split[g] : split[g + 1], 1] for g in range(G)]

    # ------------------------------------------------------------- strings
    def format(self, cells: np.ndarray) -> list[str]:
        return ["%x" % int(c) for c in np.asarray(_host(cells))]

    def parse(self, strs: Sequence[str]) -> np.ndarray:
        return np.asarray([int(s, 16) for s in strs], dtype=np.int64)
