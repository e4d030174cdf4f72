"""Mesh-sharded pairwise predicate evaluation for the overlay join.

Port of ``mosaic_tpu/parallel/dist_overlay.py``: the candidate pair axis
shards over every device of a `parallel.mesh.Mesh` and each device
evaluates its slice of the row-wise ``intersects`` batch. No collective
is needed (the pair axis is embarrassingly parallel; the reduction back
to geometry pairs stays on the host in `sql.overlay`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.geometry.device import DeviceGeometry
from . import mesh as _mesh


def geom_specs(sharded: bool) -> dict:
    """The per-field layout of a DeviceGeometry column under a mesh:
    every pair-axis field ``sharded`` (or replicated), the shared (2,)
    shift always replicated. One table for every mesh consumer of
    geometry columns (`dist_overlay`, `dist_knn`, the KNN frontend)."""
    return {
        f.name: sharded and f.name != "shift"
        for f in dataclasses.fields(DeviceGeometry)
    }


def shard_geometry(dg: DeviceGeometry, mesh) -> list:
    """One DeviceGeometry a device of ``mesh``, in shard order: the
    pair-axis fields split over every axis, the shift replicated."""
    specs = geom_specs(True)
    parts = {}
    for name, sharded in specs.items():
        x = getattr(dg, name)
        if sharded:
            parts[name] = _mesh.shard(x, mesh)
        else:
            placed = _mesh.replicas(x, mesh)
            parts[name] = [placed[str(d)] for d in mesh.device_list]
    return [
        DeviceGeometry(**{n: v[i] for n, v in parts.items()})
        for i in range(mesh.size)
    ]


def _pad_pair_axis(dg: DeviceGeometry, pad: int) -> DeviceGeometry:
    """Grow every pair-axis field by ``pad`` empty rows, by field name.

    The shared (2,) ``shift`` keeps its shape — it is not a pair column,
    even when the pair count happens to equal 2.
    """

    def grow(x):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

    return dataclasses.replace(
        dg,
        **{
            name: grow(getattr(dg, name))
            for name, sharded in geom_specs(True).items()
            if sharded
        },
    )


def distributed_pair_intersects(mesh, da: DeviceGeometry, db: DeviceGeometry) -> np.ndarray:
    """(N,) bool — row-wise intersects, the pair axis sharded over ``mesh``.

    ``da``/``db`` are `functions.geometry._pair_pack` columns with a
    shared shift; the row count is padded here to the mesh size (pad rows
    are empty geometries that never intersect).
    """
    from ..core.geometry.predicates import intersects as _dense
    from ..functions.geometry import _vmap_pair

    n = int(da.verts.shape[0])
    pad = (-n) % mesh.size
    if pad:
        da = _pad_pair_axis(da, pad)
        db = _pad_pair_axis(db, pad)
    sa, sb = shard_geometry(da, mesh), shard_geometry(db, mesh)
    outs = []
    for i, dev in enumerate(mesh.device_list):
        with _mesh.device_scope(dev):
            outs.append(_vmap_pair(_dense, sa[i], sb[i]))
    return _mesh.all_gather(outs, mesh.first).cpu().numpy()[:n]
