"""Shape bucketing: the geometric pad-to-bucket ladder.

Port of ``BucketLadder`` from ``mosaic_tpu/dispatch/bucket.py``. The
raster tile planner snaps each requested tile axis onto it, so the set
of tile shapes is the ladder's square and not the integers. The rest of
the dispatch core (signatures, compile accounting, serving) comes with
the serving slice.
"""

from __future__ import annotations

import dataclasses

#: default ladder bounds: 64 covers single interactive requests, 64k is
#: one comfortable device micro-batch
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
