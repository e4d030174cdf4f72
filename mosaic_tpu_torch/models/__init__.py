"""Spatial models of the port (``mosaic_tpu/models``): the batch KNN model
:class:`SpatialKNN` and the checkpoint primitive it appends to. The
other models and the iteration skeletons are not ported."""

from .core import CheckpointManager
from .knn import GridRingNeighbours, KNNResult, SpatialKNN

__all__ = ["CheckpointManager", "GridRingNeighbours", "KNNResult", "SpatialKNN"]
