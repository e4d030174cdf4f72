"""Online query serving: dynamic micro-batching over a resident index.

Port of ``mosaic_tpu/serve``. The request-facing path: many small
concurrent point-in-polygon and KNN queries coalesced into padded, shape-bucketed dispatches on the dispatch
core, with admission control in front and the runtime's resilience
(watchdog, retry, quarantine, fault injection) underneath.

    from mosaic_tpu_torch.serve import ServeEngine

    engine = ServeEngine(chip_index, h3, resolution=9, bounds=bbox)
    engine.warmup()                 # bind the kernels, run every bucket
    fut = engine.submit(points)     # -> concurrent.futures.Future
    rows = fut.result(timeout=1.0)  # (n,) int32, -1 = no polygon

The engine runs on its index's device: the card, or the CPU for an index
built with ``device="cpu"`` (the tests).

Component map: `bucket.py` (re-exports of the ladder and compile
accounting), `admission.py` (bounded queue, deadlines, poison parking,
typed ``Overloaded``), `batcher.py` (max-batch/max-wait coalescing with
per-request deadline shedding), `engine.py` (lifecycle + resilience
wiring), `router.py` (multi-tenant front door: per-tenant engines with
hard isolation, bounded residency with health- and occupancy-aware LRU
eviction, per-tenant shed accounting).
"""

from .admission import AdmissionController, Request
from .batcher import MicroBatcher
from .bucket import BucketLadder, backend_compiles, dispatch_signature
from .engine import ServeEngine
from .router import ServeRouter, resolve_max_resident

__all__ = [
    "AdmissionController",
    "BucketLadder",
    "MicroBatcher",
    "Request",
    "ServeEngine",
    "ServeRouter",
    "backend_compiles",
    "dispatch_signature",
    "resolve_max_resident",
]
