"""Mesh-sharded distance evaluation for the SpatialKNN ring step.

Port of ``mosaic_tpu/parallel/dist_knn.py``: an iteration's (landmark,
candidate) pair batch shards over every device of a
`parallel.mesh.Mesh`. The two geometry columns are replicated (placed
once a distinct device), the row indices shard over the pair axis, and
each device gathers its rows and evaluates the dense distance. No
collective is needed in the step; the top-k merge stays on the host in
`models/knn`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dispatch import core as _dispatch
from ..runtime import telemetry as _telemetry
from . import mesh as _mesh


@_dispatch.bounded_cache("knn_sharded_distance", 8)
def _sharded_distance_fn(mesh):
    """One sharded distance program per mesh — KNN calls it every ring
    iteration. Lives in the dispatch cache registry as
    ``knn_sharded_distance``."""
    from ..core.geometry.device import take_rows
    from ..functions.geometry import _distance_dense, _vmap_pair

    def step(lrows, crows, dls, dcs):
        return _vmap_pair(
            _distance_dense, take_rows(dls, lrows), take_rows(dcs, crows)
        )

    def run(dls, dcs, lrows, crows):
        return _mesh.run_sharded(
            step, mesh, sharded=(lrows, crows), replicated=(dls, dcs)
        )

    return run


def distributed_pair_distances(mesh, dl, dc, li: np.ndarray, ci: np.ndarray) -> np.ndarray:
    """(P,) f64 — distance(dl[li[p]], dc[ci[p]]), the pair axis sharded.

    Pads the pair axis with row 0 to a power-of-two multiple of the mesh
    size, so successive ring iterations share their shapes (the pad
    results are sliced off before returning — any valid row is filler).
    The columns must live on the mesh's kind of device.
    """
    n = int(li.shape[0])
    if n == 0:
        return np.zeros(0)
    npad = mesh.size
    while npad < n:
        npad <<= 1
    lip = np.concatenate([li, np.zeros(npad - n, dtype=li.dtype)])
    cip = np.concatenate([ci, np.zeros(npad - n, dtype=ci.dtype)])
    dev = mesh.first
    out = _sharded_distance_fn(mesh)(
        dl, dc, torch.from_numpy(lip).to(dev), torch.from_numpy(cip).to(dev)
    )
    return out.to(torch.float64).cpu().numpy()[:n]


def knn_cache_stats(emit: bool = True) -> dict:
    """The ``{"sharded_distance": {...}}`` view of the dispatch cache
    registry (`dispatch.cache_stats` is the full surface). Each live entry
    holds one per-mesh program and its mesh key; the cache is bounded
    (maxsize 8: eviction costs nothing but a rebuilt closure). Emits one
    ``knn_cache_stats`` event (``emit=False`` reads silently)."""
    stats = {"sharded_distance": _dispatch.cache_view("knn_sharded_distance")}
    if emit:
        _telemetry.record("knn_cache_stats", **stats)
    return stats


def clear_knn_caches() -> dict:
    """Drop every cached per-mesh distance program (through
    `dispatch.clear_caches`); returns the pre-clear
    :func:`knn_cache_stats`. Emits ``knn_caches_cleared``."""
    stats = knn_cache_stats(emit=False)
    _dispatch.clear_caches(names=("knn_sharded_distance",), emit=False)
    _telemetry.record("knn_caches_cleared", **stats)
    return stats
