"""IndexSystem contract: pluggable grid indexes, batch-first.

Port of ``mosaic_tpu/core/index/base.py``. The contract is *columnar*:
every operation takes and returns arrays (numpy on the host, torch
tensors on a device). Cell IDs are always int64. This slice carries the
methods the point-in-polygon join and tessellation call; the reference's
neighbourhood, string and validity methods come with the slices that
use them.
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

    # ------------------------------------------------------------ core math
    @abc.abstractmethod
    def point_to_cell(self, xy: Array, resolution: int) -> Array:
        """(N, 2) coords -> (N,) int64 cell ids. """

    @abc.abstractmethod
    def cell_center(self, cells: Array) -> Array:
        """(N,) int64 -> (N, 2) cell center coordinates."""

    @abc.abstractmethod
    def cell_boundary(self, cells: Array) -> Array:
        """(N,) int64 -> (N, boundary_max_verts, 2) boundary polygons (CCW,
        padded by repeating the last vertex)."""

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

    # -------------------------------------------------------- conveniences
    def resolution_arg(self, res) -> int:
        """Parse user resolution input (int or string like '500m')."""
        if isinstance(res, (int, np.integer)):
            if int(res) not in set(self.resolutions()):
                raise ValueError(f"{self.name}: unsupported resolution {res}")
            return int(res)
        raise ValueError(f"{self.name}: unsupported resolution {res!r}")
