"""Models & services of the port (``mosaic_tpu/models``): the batch KNN
model :class:`SpatialKNN`, the checkpoint primitive it appends to, and the
iteration skeletons :class:`IterativeTransformer` and
:class:`BinaryTransformer`."""

from .core import BinaryTransformer, CheckpointManager, IterativeTransformer
from .knn import GridRingNeighbours, KNNResult, SpatialKNN

__all__ = [
    "CheckpointManager",
    "IterativeTransformer",
    "BinaryTransformer",
    "GridRingNeighbours",
    "KNNResult",
    "SpatialKNN",
]
