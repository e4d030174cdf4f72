"""The sliding window of the SLO monitor, the part the health monitor
reads.

Port of :class:`WindowRing` from ``mosaic_tpu/obs/slo.py``: a
monotonic-clock sliding window over two accumulators, time-bucketed so
memory is O(buckets) whatever the event rate. `obs/health.py` keeps one
per scope (good and bad event counts). The SLO registry, the burn-rate
monitor and the windowed histogram come with ROADMAP queue 1 item 13.
"""

from __future__ import annotations


class WindowRing:
    """Monotonic-clock sliding window over two accumulators (``a``/``b``
    — good/bad counts for ratios, value-sum/sample-count for rates),
    time-bucketed so memory is O(buckets) regardless of event rate.
    Resolution is ``window_s / n_buckets``; totals are exact at bucket
    granularity."""

    __slots__ = ("window_s", "width", "n", "_a", "_b", "_idx")

    def __init__(self, window_s: float, n_buckets: int = 64):
        self.window_s = float(window_s)
        self.n = int(n_buckets)
        self.width = self.window_s / self.n
        self._a = [0.0] * self.n
        self._b = [0.0] * self.n
        self._idx = [-1] * self.n  # absolute bucket index, -1 = empty

    def add(self, now: float, a: float = 0.0, b: float = 0.0) -> None:
        idx = int(now / self.width)
        slot = idx % self.n
        if self._idx[slot] != idx:
            self._idx[slot] = idx
            self._a[slot] = 0.0
            self._b[slot] = 0.0
        self._a[slot] += a
        self._b[slot] += b

    def totals(
        self, now: float, window_s: float | None = None
    ) -> tuple[float, float]:
        """``(sum_a, sum_b)`` over buckets within ``window_s`` of
        ``now`` (default: the full ring window)."""
        w = self.window_s if window_s is None else min(
            float(window_s), self.window_s
        )
        lo = int((now - w) / self.width)
        hi = int(now / self.width)
        ta = tb = 0.0
        for slot in range(self.n):
            idx = self._idx[slot]
            if lo < idx <= hi or idx == lo == hi:
                ta += self._a[slot]
                tb += self._b[slot]
        return ta, tb

    def reset(self) -> None:
        for slot in range(self.n):
            self._idx[slot] = -1
            self._a[slot] = 0.0
            self._b[slot] = 0.0
