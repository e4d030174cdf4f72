"""K-nearest neighbours as a service (port of ``mosaic_tpu/knn``).

The batch model (`mosaic_tpu_torch/models/knn.py`) answers KNN offline:
tessellate the candidates, grow k-rings per landmark, evaluate pair
distances in padded device batches. This package turns the same exact
algorithm into an online frontend with the serving discipline of the
point-in-polygon path:

- :func:`build_knn_index` — the resident index: candidate chips in a
  sorted-cell CSR, the shifted float64 device geometry column, a host f64
  twin (the brute-force oracle's data), and the chip index whose build
  attached the Voronoi adjacency of its convex chip sites.
- :class:`KNNFrontend` — bucketed ring expansion (``ring``) and the
  Voronoi one-dispatch cover (``voronoi``), fault sites ``knn.expand``,
  ``knn.distance`` and ``knn.scatter``; on the card exhausted retries
  raise, on the CPU they degrade to the oracle.
- :func:`brute_force_knn` — the f64 host oracle, equal to the device
  path bit for bit.

Serving lives in `mosaic_tpu_torch/serve`: ``ServeEngine(knn=...)``
co-batches KNN requests with point-in-polygon traffic under one
admission queue, deadline budget and shed taxonomy;
``ServeRouter.submit_knn`` fronts it per tenant.
"""

from .index import KNNIndex, build_knn_index
from .frontend import KNNAnswer, KNNFrontend, decode_knn
from .oracle import brute_force_knn, host_pair_distances

__all__ = [
    "KNNAnswer",
    "KNNFrontend",
    "KNNIndex",
    "brute_force_knn",
    "build_knn_index",
    "decode_knn",
    "host_pair_distances",
]
