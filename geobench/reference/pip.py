"""Point in polygon, plainly: each point's answer is the smallest id among
the polygons that contain it, else -1 (the join's documented rule where
zones overlap). Containment is the even-odd rule over every ring of a
polygon, so holes need no special case.

Points are bucketed on a uniform grid over the polygons' extent; each grid
cell lists the polygons whose bounding box meets it. A point is tested
against the polygons of its cell that hold it in their box, all edges of
a polygon at once, in blocks of points. Runs on any torch device.

``dtype`` below float64 makes the control: the same rule computed in a
lower precision, after moving the origin to ``shift`` in float64 (as a
program in that precision would), so that only the arithmetic differs.
"""

from __future__ import annotations

import numpy as np
import torch

#: grid cells a side per square root of the polygon count
GRID_PER_ROOT = 2
#: elements of a block's (points, edges) arrays
BLOCK_ELEMENTS = 1 << 25


class Reference:
    """The tables of one polygon set, on ``device``."""

    def __init__(self, polys, device, dtype=torch.float64, shift=(0.0, 0.0)):
        edges, owner = polys.edges()
        n_g = len(polys)
        per = np.bincount(owner, minlength=n_g)
        e_max = max(int(per.max()), 1)
        # (G, E, 4) edges padded with flat ones (y1 == y2 never straddles)
        table = np.zeros((n_g, e_max, 4))
        slot = np.arange(len(owner)) - np.repeat(np.cumsum(per) - per, per)
        table[owner, slot] = edges
        table[:, :, [0, 2]] -= shift[0]
        table[:, :, [1, 3]] -= shift[1]
        box = polys.bounds()
        # the grid: cell -> polygons whose box meets it, ascending ids
        side = max(1, int(np.ceil(np.sqrt(n_g))) * GRID_PER_ROOT)
        lo = box[:, :2].min(0)
        span = np.maximum(box[:, 2:].max(0) - lo, 1e-12)
        c0 = np.clip(((box[:, :2] - lo) / span * side).astype(np.int64), 0, side - 1)
        c1 = np.clip(((box[:, 2:] - lo) / span * side).astype(np.int64), 0, side - 1)
        lists = [[] for _ in range(side * side)]
        for g in range(n_g):
            for cy in range(c0[g, 1], c1[g, 1] + 1):
                for cx in range(c0[g, 0], c1[g, 0] + 1):
                    lists[cy * side + cx].append(g)
        width = max(1, max(len(x) for x in lists))
        cand = np.full((side * side, width), -1, np.int64)
        for k, x in enumerate(lists):
            cand[k, :len(x)] = x
        self.device, self.dtype, self.side = device, dtype, side
        self.shift = torch.tensor(shift, dtype=torch.float64, device=device)
        self.lo = torch.tensor(lo, dtype=torch.float64, device=device)
        self.span = torch.tensor(span, dtype=torch.float64, device=device)
        self.box = torch.from_numpy(box).to(device)
        self.cand = torch.from_numpy(cand).to(device)
        self.edges = torch.from_numpy(table).to(device=device, dtype=dtype)
        self.e_max = e_max

    def answer(self, points) -> torch.Tensor:
        """(N,) int64 answers of (N, 2) float64 points (numpy or torch)."""
        pts = torch.as_tensor(points, dtype=torch.float64)
        n = pts.shape[0]
        out = torch.empty(n, dtype=torch.int64, device=self.device)
        block = max(1024, BLOCK_ELEMENTS // self.e_max)
        for s in range(0, n, block):
            out[s:s + block] = self._block(pts[s:s + block].to(self.device))
        return out

    def _block(self, p: torch.Tensor) -> torch.Tensor:
        side = self.side
        c = ((p - self.lo) / self.span * side).to(torch.int64).clamp(0, side - 1)
        cand = self.cand[c[:, 1] * side + c[:, 0]]  # (B, L)
        best = torch.full((p.shape[0],), -1, dtype=torch.int64, device=self.device)
        q = (p - self.shift).to(self.dtype)
        for k in range(cand.shape[1]):
            g = cand[:, k]
            b = self.box[g.clamp(min=0)]
            hit = ((g >= 0) & (best < 0) & (p[:, 0] >= b[:, 0]) & (p[:, 0] <= b[:, 2])
                   & (p[:, 1] >= b[:, 1]) & (p[:, 1] <= b[:, 3]))
            rows = hit.nonzero().squeeze(1)
            if rows.numel() == 0:
                continue
            inside = self._inside(q[rows], g[rows])
            best[rows[inside]] = g[rows[inside]]
        return best

    def _inside(self, q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Even-odd parity of each point against every edge of its polygon."""
        e = self.edges[g]  # (n, E, 4)
        x1, y1, x2, y2 = e.unbind(-1)
        px, py = q[:, 0:1], q[:, 1:2]
        straddle = (y1 > py) != (y2 > py)
        dy = torch.where(straddle, y2 - y1, torch.ones_like(y1))
        xcross = x1 + (py - y1) * (x2 - x1) / dy
        crossings = (straddle & (px < xcross)).sum(1)
        return (crossings % 2) == 1


def answers(polys, points, device, dtype=torch.float64, shift=(0.0, 0.0)) -> torch.Tensor:
    """(N,) int64: the smallest containing polygon id of each point, or -1."""
    return Reference(polys, device, dtype, shift).answer(points)


def extent_centre(polys) -> tuple[float, float]:
    """The centre of the polygons' extent: the origin a program in a low
    precision recentres on."""
    b = polys.bounds()
    return (float((b[:, 0].min() + b[:, 2].max()) / 2),
            float((b[:, 1].min() + b[:, 3].max()) / 2))


def control_answers(polys, points, device, dtype) -> torch.Tensor:
    """The control: the reference in ``dtype`` on recentred coordinates."""
    return answers(polys, points, device, dtype=dtype, shift=extent_centre(polys))
