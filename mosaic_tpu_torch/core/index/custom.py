"""Custom rectangular grid over any CRS, bit-packed cell ids.

Port of ``mosaic_tpu/core/index/custom.py``. A :class:`GridConf` gives
bounds, a per-level split factor and root cell sizes; cell ids pack the
resolution into the top 8 bits and the row-major cell position into the
low 56 bits.

``point_to_cell`` takes numpy on the host and torch on the tensor's
device, like the port's H3. Its f64 arithmetic is one subtraction, one
division and a floor per axis, each correctly rounded in both, so the
two paths and the reference give the same ids. Everything else runs on
the host in int64/f64 numpy, as the reference's jnp does on the CPU, and
accepts tensors by moving them to the host.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence

import numpy as np
import torch

from .base import IndexSystem

_POS_MASK = (1 << 56) - 1


@dataclasses.dataclass(frozen=True)
class GridConf:
    bound_x_min: float
    bound_x_max: float
    bound_y_min: float
    bound_y_max: float
    cell_splits: int
    root_cell_size_x: float
    root_cell_size_y: float

    ID_BITS = 56

    @property
    def span_x(self) -> float:
        return self.bound_x_max - self.bound_x_min

    @property
    def span_y(self) -> float:
        return self.bound_y_max - self.bound_y_min

    @property
    def root_cells_x(self) -> int:
        return int(math.ceil(self.span_x / self.root_cell_size_x))

    @property
    def root_cells_y(self) -> int:
        return int(math.ceil(self.span_y / self.root_cell_size_y))

    @property
    def max_resolution(self) -> int:
        bits_per_res = max(1, math.ceil(math.log2(self.cell_splits**2)))
        root_bits = math.ceil(
            math.log2(max(2, self.root_cells_x * self.root_cells_y))
        )
        return max(0, min(20, (self.ID_BITS - root_bits) // bits_per_res))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _like(out: np.ndarray, x):
    """``out`` as a tensor on ``x``'s device when ``x`` is a tensor."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(out, device=x.device)
    return out


class CustomIndexSystem(IndexSystem):
    boundary_max_verts = 5
    crs_srid = 0  # abstract grid: caller-defined CRS, no implicit transform

    def __init__(self, conf: GridConf):
        self.conf = conf
        self.name = (
            f"CUSTOM({conf.bound_x_min:g}, {conf.bound_x_max:g}, "
            f"{conf.bound_y_min:g}, {conf.bound_y_max:g}, {conf.cell_splits}, "
            f"{conf.root_cell_size_x:g}, {conf.root_cell_size_y:g})"
        )

    # ------------------------------------------------------------- helpers
    def cells_x(self, res: int) -> int:
        return self.conf.root_cells_x * self.conf.cell_splits**res

    def cells_y(self, res: int) -> int:
        return self.conf.root_cells_y * self.conf.cell_splits**res

    def cell_size(self, res: int) -> tuple[float, float]:
        f = float(self.conf.cell_splits**res)
        return self.conf.root_cell_size_x / f, self.conf.root_cell_size_y / f

    def resolutions(self) -> Sequence[int]:
        return list(range(0, self.conf.max_resolution + 1))

    def buffer_radius(self, resolution: int) -> float:
        w, h = self.cell_size(resolution)
        return math.hypot(w, h) / 2.0

    def cell_area_approx(self, resolution: int) -> float:
        w, h = self.cell_size(resolution)
        return w * h

    # ---------------------------------------------------------------- core
    def point_to_cell(self, xy, resolution: int):
        """(N, 2) coords -> (N,) int64 cells: numpy for a numpy input,
        torch on the tensor's device (in its dtype) for a tensor."""
        w, h = self.cell_size(resolution)
        nx = self.cells_x(resolution)
        ny = self.cells_y(resolution)
        tag = resolution << GridConf.ID_BITS
        if isinstance(xy, torch.Tensor):
            cx = torch.floor((xy[..., 0] - self.conf.bound_x_min) / w).long()
            cy = torch.floor((xy[..., 1] - self.conf.bound_y_min) / h).long()
            pos = torch.clamp(cy, 0, ny - 1) * nx + torch.clamp(cx, 0, nx - 1)
            return pos | tag
        xy = np.asarray(xy)
        cx = np.floor((xy[..., 0] - self.conf.bound_x_min) / w).astype(np.int64)
        cy = np.floor((xy[..., 1] - self.conf.bound_y_min) / h).astype(np.int64)
        pos = np.clip(cy, 0, ny - 1) * nx + np.clip(cx, 0, nx - 1)
        return np.int64(tag) | pos

    def resolution_of(self, cells):
        c = np.asarray(_host(cells), np.int64)
        return _like((c >> GridConf.ID_BITS).astype(np.int32), cells)

    def _decode_dyn(self, cells: np.ndarray):
        """Per-element x/y/width/height without a static resolution."""
        cells = np.asarray(cells, np.int64)
        res = (cells >> GridConf.ID_BITS).astype(np.int32)
        pos = cells & _POS_MASK
        x0 = np.zeros(cells.shape, np.float64)
        y0 = np.zeros(cells.shape, np.float64)
        w = np.zeros(cells.shape, np.float64)
        h = np.zeros(cells.shape, np.float64)
        for r in self.resolutions():
            nx = self.cells_x(r)
            wr, hr = self.cell_size(r)
            sel = res == r
            x0 = np.where(sel, self.conf.bound_x_min + (pos % nx) * wr, x0)
            y0 = np.where(sel, self.conf.bound_y_min + (pos // nx) * hr, y0)
            w = np.where(sel, wr, w)
            h = np.where(sel, hr, h)
        return x0, y0, w, h, res, pos

    def cell_center(self, cells):
        x0, y0, w, h, _, _ = self._decode_dyn(_host(cells))
        return _like(np.stack([x0 + w / 2, y0 + h / 2], axis=-1), cells)

    def cell_boundary(self, cells):
        x0, y0, w, h, _, _ = self._decode_dyn(_host(cells))
        ring = np.stack(
            [
                np.stack([x0, y0], -1),
                np.stack([x0 + w, y0], -1),
                np.stack([x0 + w, y0 + h], -1),
                np.stack([x0, y0 + h], -1),
                np.stack([x0, y0], -1),
            ],
            axis=-2,
        )
        return _like(ring, cells)

    def is_valid(self, cells):
        c = np.asarray(_host(cells), np.int64)
        res = (c >> GridConf.ID_BITS).astype(np.int32)
        pos = c & _POS_MASK
        ok = (res >= 0) & (res <= self.conf.max_resolution)
        limit = np.zeros(c.shape, np.int64)
        for r in self.resolutions():
            limit = np.where(res == r, self.cells_x(r) * self.cells_y(r), limit)
        return _like(ok & (pos >= 0) & (pos < limit), cells)

    # ------------------------------------------------------------ neighbors
    def _neighbors(self, cells, k: int, hollow: bool):
        c = np.asarray(_host(cells), np.int64)
        res = (c >> GridConf.ID_BITS).astype(np.int32)
        pos = c & _POS_MASK
        span = np.arange(-k, k + 1)
        dx, dy = np.meshgrid(span, span, indexing="ij")
        sel = (
            np.maximum(np.abs(dx), np.abs(dy)) == k
            if hollow
            else np.ones_like(dx, bool)
        )
        offs = np.stack([dx[sel], dy[sel]], axis=-1)  # (M, 2)
        out = np.full(c.shape + (offs.shape[0],), -1, dtype=np.int64)
        for r in self.resolutions():
            nx, ny = self.cells_x(r), self.cells_y(r)
            cx = (pos % nx)[..., None] + offs[None, :, 0]
            cy = (pos // nx)[..., None] + offs[None, :, 1]
            ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
            ids = np.int64(r << GridConf.ID_BITS) | (cy * nx + cx)
            out = np.where((res == r)[..., None] & ok, ids, out)
        return _like(out, cells)

    def k_ring(self, cells, k: int):
        return self._neighbors(cells, k, hollow=False)

    def k_loop(self, cells, k: int):
        return self._neighbors(cells, k, hollow=True)

    def grid_distance(self, cells_a, cells_b):
        xa, ya, wa, ha, _, _ = self._decode_dyn(_host(cells_a))
        xb, yb, wb, hb, _, _ = self._decode_dyn(_host(cells_b))
        w = np.maximum(wa, wb)
        h = np.maximum(ha, hb)
        # Chebyshev metric, consistent with the square k_ring/k_loop rings
        # (the reference's Manhattan distance contradicts its own kLoop)
        d = np.maximum(
            np.round(np.abs(xa - xb) / w), np.round(np.abs(ya - yb) / h)
        ).astype(np.int64)
        return _like(d, cells_a)

    # ------------------------------------------------------------- polyfill
    def polyfill_candidates(self, bounds: np.ndarray, resolution: int) -> np.ndarray:
        w, h = self.cell_size(resolution)
        c = self.conf
        x0 = max(c.bound_x_min, bounds[0])
        y0 = max(c.bound_y_min, bounds[1])
        x1 = min(c.bound_x_max, bounds[2])
        y1 = min(c.bound_y_max, bounds[3])
        if x1 <= x0 or y1 <= y0:
            return np.zeros(0, np.int64)
        i0 = int((x0 - c.bound_x_min) / w)
        i1 = int(np.ceil((x1 - c.bound_x_min) / w))
        j0 = int((y0 - c.bound_y_min) / h)
        j1 = int(np.ceil((y1 - c.bound_y_min) / h))
        xs = c.bound_x_min + (np.arange(i0, i1) + 0.5) * w
        ys = c.bound_y_min + (np.arange(j0, j1) + 0.5) * h
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        centers = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        if centers.size == 0:
            return np.zeros(0, np.int64)
        return self.point_to_cell(centers, resolution)

    # -------------------------------------------------------------- strings
    def format(self, cells) -> list[str]:
        return [str(int(c)) for c in _host(cells)]

    def parse(self, strs: Sequence[str]) -> np.ndarray:
        return np.asarray([int(s) for s in strs], dtype=np.int64)


_CUSTOM_RE = re.compile(
    r"CUSTOM\(\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)\s*,"
    r"\s*([-\d.eE+]+)\s*,\s*(\d+)\s*,\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)\s*\)"
)


def custom_from_name(name: str) -> CustomIndexSystem:
    """Parse 'CUSTOM(xmin,xmax,ymin,ymax,splits,sizeX,sizeY)'."""
    m = _CUSTOM_RE.match(name.strip())
    if not m:
        raise ValueError(f"not a CUSTOM index system spec: {name!r}")
    v = m.groups()
    return CustomIndexSystem(
        GridConf(
            float(v[0]), float(v[1]), float(v[2]), float(v[3]), int(v[4]),
            float(v[5]), float(v[6]),
        )
    )
