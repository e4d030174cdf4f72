"""Distribution layer: device meshes and sharded joins.

Port of ``mosaic_tpu/parallel``. The reference distributes with a
`jax.sharding.Mesh` and `shard_map`; the port keeps that single-controller
API with its own :class:`~mosaic_tpu_torch.parallel.mesh.Mesh` of torch
devices (`parallel/mesh.py`): one process, shard ``i`` launched on device
``i``. The point side shards over every device of the mesh, the polygon
chip index shards over one mesh axis and is all-gathered inside the step
(`dist_join.py`), and aggregates are summed over the shards. The pair
axes of the overlay predicate (`dist_overlay.py`) and of the KNN distance
batch (`dist_knn.py`) shard the same way. `dist_pip_join` is the managed
entry point with the resilience story of `pip_join`.

The join modules import `sql.join`, which imports the dispatch core,
which imports `parallel.mesh`: they load on first use of their names.
"""

from .mesh import Mesh

__all__ = [
    "Mesh",
    "dist_pip_join",
    "distributed_join_step",
    "make_mesh",
    "pad_index_for_shards",
]

_LAZY = ("dist_pip_join", "distributed_join_step", "make_mesh", "pad_index_for_shards")


def __getattr__(name):
    if name in _LAZY:
        from . import dist_join

        return getattr(dist_join, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
