"""Shape bucketing: the bounded-signature contract of the dispatch core.

Port of ``mosaic_tpu/dispatch/bucket.py``. Every serving dispatch runs at
a shape drawn from a small fixed ladder: a request (or coalesced
micro-batch) of ``n`` rows is padded up to ``bucket_for(n)``, and
:meth:`DispatchCore.warmup` runs every rung before traffic arrives. The
raster tile planner snaps each requested tile axis onto the same ladder.

Pad rows duplicate the batch's first row: they flow through the probe
like any other point and are sliced off before scatter-back, so they can
never reach a caller. Caps sized at the full bucket make tier overflow
structurally impossible — a padded dispatch is exact by construction and
never escalates.

Compile accounting is two-layered, as in the reference:
:func:`dispatch_signature` is the deterministic key the core counts
(signatures after warmup == buckets touched), and
:func:`backend_compiles` reads a process-wide compiler counter. The port
compiles nothing per shape; its only compiler is ``nvcc``, which builds
the kernel libraries once per machine (`kernels/_build.py`, cached on
disk by a hash of source and flags), so :func:`backend_compiles` counts
the nvcc jobs this process started.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: default ladder bounds: 64 covers single interactive requests, 64k is
#: one comfortable device micro-batch (the batcher's max coalesced size
#: must not exceed the top bucket)
DEFAULT_MIN_BUCKET = 64
DEFAULT_MAX_BUCKET = 65536


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Geometric pad-to-bucket ladder (powers of ``growth`` from
    ``min_bucket`` to ``max_bucket`` inclusive)."""

    min_bucket: int = DEFAULT_MIN_BUCKET
    max_bucket: int = DEFAULT_MAX_BUCKET
    growth: int = 2

    def __post_init__(self):
        if self.min_bucket < 1 or self.max_bucket < self.min_bucket:
            raise ValueError(
                f"invalid ladder bounds [{self.min_bucket}, "
                f"{self.max_bucket}]"
            )
        if self.growth < 2:
            raise ValueError(f"growth must be >= 2, got {self.growth}")

    @property
    def buckets(self) -> tuple:
        out = []
        b = self.min_bucket
        while b < self.max_bucket:
            out.append(b)
            b *= self.growth
        out.append(self.max_bucket)
        return tuple(out)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= ``n`` (raises for n > max_bucket)."""
        if n > self.max_bucket:
            raise ValueError(
                f"request of {n} rows exceeds the top bucket "
                f"{self.max_bucket} — raise max_bucket or split upstream"
            )
        b = self.min_bucket
        while b < n:
            b *= self.growth
        return min(b, self.max_bucket)

    def pad(self, points: np.ndarray) -> tuple[np.ndarray, int]:
        """(padded (B, 2) f64 copy, original n). Pad rows repeat row 0
        (inert: results past ``n`` are sliced off before scatter-back)."""
        pts = np.asarray(points, dtype=np.float64)
        n = int(pts.shape[0])
        b = self.bucket_for(max(n, 1))
        if n == b:
            return pts, n
        out = np.empty((b, 2), dtype=np.float64)
        out[:n] = pts
        out[n:] = pts[0] if n else 0.0
        return out, n


def mesh_key(mesh) -> "tuple | None":
    """Deterministic identity of a placement for cache keys: axis names,
    axis sizes and the device strings in shard order. ``None`` stays
    ``None`` (single-device dispatch)."""
    if mesh is None:
        return None
    return mesh.key()


def dispatch_signature(
    bucket: int, index, *, writeback: str, lookup: str,
    found_cap: int | None, heavy_cap: int | None,
    probe: str = "scatter", convex_cap: int | None = None,
    mesh=None,
) -> tuple:
    """The deterministic key of one dispatch: every static argument of
    the probe plus the padded shape, the index identity and the
    placement. The core counts distinct signatures and treats one first
    seen after :meth:`DispatchCore.freeze` as a cold compile."""
    return (
        int(bucket), id(index), writeback, lookup, found_cap, heavy_cap,
        probe, convex_cap, mesh_key(mesh),
    )


def backend_compiles() -> int:
    """Process-wide count of nvcc builds (monotonic; diff two reads to
    scope a region). A process whose kernel libraries are already built
    on disk reads no new build after its first launch."""
    from ..kernels import _build

    return _build.nvcc_builds()
