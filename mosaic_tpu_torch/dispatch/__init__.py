"""`mosaic_tpu_torch.dispatch` — the execution core of the port.

Port of ``mosaic_tpu/dispatch``: the bucket ladder and the dispatch
signature (`bucket.py`), the registry of bounded caches, ``guarded_call``
(the watchdog/retry/degradation composition every device call goes
through), :class:`DispatchCore` with warmup and freeze, the resident-core
cache :func:`core_for` (`core.py`), the pipelined execution core of the
durable stream and raster scan (`pipeline.py`), and the program store
(`programs.py`: the built kernel libraries and the per-rung program
manifests as durable artifacts, so a relaunch binds them without nvcc).
The data-parallel placement (`data_mesh`, `resolve_mesh`,
`sharded_pointwise`) lives in `core.py` over `parallel.mesh`.
"""

from .bucket import (
    DEFAULT_MAX_BUCKET,
    DEFAULT_MIN_BUCKET,
    BucketLadder,
    backend_compiles,
    dispatch_signature,
    mesh_key,
)
from .core import (
    DispatchCore,
    bounded_cache,
    cache_stats,
    cache_view,
    cells_prog,
    clear_caches,
    core_for,
    data_mesh,
    guarded_call,
    join_cache_view,
    register_cache,
    resolve_mesh,
    sharded_join_prog,
    sharded_pointwise,
    stream_programs,
)
from .pipeline import (
    DEFAULT_WINDOW,
    PipelineStats,
    SnapshotWriter,
    execute_pipeline,
    resolve_window,
)
from .programs import (
    ProgramFingerprintMismatch,
    ProgramStore,
    ProgramStoreCorrupt,
    backend_fingerprint,
    program_key,
    resolve_program_store,
)

__all__ = [
    "BucketLadder",
    "DEFAULT_MAX_BUCKET",
    "DEFAULT_MIN_BUCKET",
    "DEFAULT_WINDOW",
    "DispatchCore",
    "PipelineStats",
    "ProgramFingerprintMismatch",
    "ProgramStore",
    "ProgramStoreCorrupt",
    "SnapshotWriter",
    "backend_compiles",
    "backend_fingerprint",
    "bounded_cache",
    "cache_stats",
    "cache_view",
    "cells_prog",
    "clear_caches",
    "core_for",
    "data_mesh",
    "dispatch_signature",
    "execute_pipeline",
    "guarded_call",
    "join_cache_view",
    "mesh_key",
    "program_key",
    "register_cache",
    "resolve_mesh",
    "resolve_program_store",
    "resolve_window",
    "sharded_join_prog",
    "sharded_pointwise",
    "stream_programs",
]
