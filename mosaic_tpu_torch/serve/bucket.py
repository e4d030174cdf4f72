"""Compatibility shim, as in the reference: the shape-bucketing contract
lives in `mosaic_tpu_torch.dispatch.bucket`, which every frontend
shares. Import from `mosaic_tpu_torch.dispatch` in new code."""

from ..dispatch.bucket import (  # noqa: F401
    DEFAULT_MAX_BUCKET,
    DEFAULT_MIN_BUCKET,
    BucketLadder,
    backend_compiles,
    dispatch_signature,
    mesh_key,
)

__all__ = [
    "BucketLadder",
    "DEFAULT_MAX_BUCKET",
    "DEFAULT_MIN_BUCKET",
    "backend_compiles",
    "dispatch_signature",
    "mesh_key",
]
