"""IndexSystem contract: pluggable grid indexes, batch-first.

Port of ``mosaic_tpu/core/index/base.py``. The contract is *columnar*:
every operation takes and returns arrays (numpy on the host, torch
tensors on a device). Cell IDs are always int64. H3, BNG and the custom
grid implement every abstract method, as in the reference.
"""

from __future__ import annotations

import abc
from typing import Sequence, Union

import torch

import numpy as np

Array = Union[np.ndarray, torch.Tensor]


class IndexSystem(abc.ABC):
    """Grid index systems map points/geometries <-> integer cell ids.

    Array methods accept numpy arrays or torch tensors unless documented
    host-only.
    """

    name: str = "?"
    #: number of vertices of a cell boundary polygon (4 for squares, up to 10
    #: for H3 cells with distortion vertices; boundaries are padded to this).
    boundary_max_verts: int = 4
    #: CRS the grid's coordinates live in (0 = abstract/unknown). H3 is
    #: WGS84 lon/lat; BNG is EPSG:27700 eastings/northings.
    crs_srid: int = 4326

    # ------------------------------------------------------------- metadata
    @abc.abstractmethod
    def resolutions(self) -> Sequence[int]: ...

    def min_resolution(self) -> int:
        return min(self.resolutions())

    def max_resolution(self) -> int:
        return max(self.resolutions())

    @abc.abstractmethod
    def resolution_of(self, cells: Array) -> Array:
        """(N,) int32 resolution of each cell id."""

    # ------------------------------------------------------------ core math
    @abc.abstractmethod
    def point_to_cell(self, xy: Array, resolution: int) -> Array:
        """(N, 2) coords -> (N,) int64 cell ids. """

    def point_to_cell_margin(self, xy: Array, resolution: int):
        """(N, 2) coords -> (cells, rel_margins | None).

        ``rel_margins`` is (N, 2): each point's distance to the nearest
        and second-nearest cell-assignment decision boundaries, divided by
        the coordinate noise scale — compare against k·eps(dtype) to flag
        points whose cell id may differ under higher precision, and whose
        neighborhood has a third candidate (both margins small = near a
        cell corner), for the `sql.join` epsilon-band recheck. Systems
        without a margin implementation return None: callers then skip
        the cell-band part of the recheck."""
        return self.point_to_cell(xy, resolution), None

    def point_to_cell_alt(self, xy: Array, resolution: int):
        """(N, 2) coords -> (N,) runner-up cell ids, or None when the
        system has no alternate-rounding implementation. For borderline
        points (first margin small, second ample) the exact-precision
        cell is the primary or this alternate; -1 entries mean no valid
        alternate (callers escalate those rows to the exact host path)."""
        return None

    def cell_kernel_libraries(self, device) -> list[str]:
        """The hand-written kernel libraries (`kernels/_build.py`) that
        ``point_to_cell`` and ``point_to_cell_margin`` launch for a tensor
        on ``device``; none unless a system says otherwise."""
        return []

    @abc.abstractmethod
    def cell_center(self, cells: Array) -> Array:
        """(N,) int64 -> (N, 2) cell center coordinates."""

    @abc.abstractmethod
    def cell_boundary(self, cells: Array) -> Array:
        """(N,) int64 -> (N, boundary_max_verts, 2) boundary polygons (CCW,
        padded by repeating the last vertex)."""

    @abc.abstractmethod
    def k_ring(self, cells: Array, k: int) -> Array:
        """(N,) -> (N, M) filled disk of radius k (cell itself included).
        M is static for the system/k; invalid slots are -1."""

    @abc.abstractmethod
    def k_loop(self, cells: Array, k: int) -> Array:
        """(N,) -> (N, M) hollow ring at exactly distance k; -1 pads."""

    @abc.abstractmethod
    def grid_distance(self, cells_a: Array, cells_b: Array) -> Array:
        """(N,),(N,) -> (N,) int64 grid distance, consistent with k_loop:
        grid_distance(c, n) == k for every n in k_loop(c, k)."""

    @abc.abstractmethod
    def buffer_radius(self, resolution: int) -> float:
        """Radius (in CRS units) that guarantees a cell containing any point
        of a geometry is reached by buffering the geometry by this much."""

    # ------------------------------------------------------------ polyfill
    @abc.abstractmethod
    def polyfill_candidates(
        self, bounds: np.ndarray, resolution: int
    ) -> np.ndarray:
        """Host: candidate cell ids (K,) covering a bbox [xmin,ymin,xmax,ymax].

        Polyfill = candidates whose *center* falls inside the geometry
        (centroid rule, matching the reference's H3 polyfill semantics and its
        BNG centroid-BFS). The center test runs on device via the PIP kernel.
        """

    def polyfill_candidates_batch(
        self, bounds: np.ndarray, resolution: int
    ) -> list[np.ndarray]:
        """Host: candidates per bbox row of ``bounds`` (G, 4). Default loops;
        systems with batch-friendly math override this to amortize the
        per-call overhead across a whole geometry column."""
        bounds = np.asarray(bounds, dtype=np.float64).reshape(-1, 4)
        return [
            np.asarray(self.polyfill_candidates(bounds[g], resolution))
            for g in range(bounds.shape[0])
        ]

    # ------------------------------------------------------------- strings
    @abc.abstractmethod
    def format(self, cells: np.ndarray) -> list[str]:
        """Host: int64 ids -> canonical string ids."""

    @abc.abstractmethod
    def parse(self, strs: Sequence[str]) -> np.ndarray:
        """Host: string ids -> int64 ids."""

    # ------------------------------------------------------------ validity
    @abc.abstractmethod
    def is_valid(self, cells: Array) -> Array:
        """(N,) -> (N,) bool."""

    # -------------------------------------------------------- conveniences
    def cell_area_approx(self, resolution: int) -> float:
        """Mean cell area in CRS units (used by the resolution analyzer)."""
        raise NotImplementedError

    def resolution_arg(self, res) -> int:
        """Parse user resolution input (int or string like '500m')."""
        if isinstance(res, (int, np.integer)):
            if int(res) not in set(self.resolutions()):
                raise ValueError(f"{self.name}: unsupported resolution {res}")
            return int(res)
        raise ValueError(f"{self.name}: unsupported resolution {res!r}")
