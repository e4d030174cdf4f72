"""Observability utilities: timing, device tracing, logging.

Port of ``mosaic_tpu/utils/__init__.py`` (reference analogs: the
test-only `time`/`benchmark` helpers of the Scala suite — median-of-trials
wall clock — and Spark's `Logging` trait). On the card, kernel launches
are asynchronous: `benchmark` synchronises the device of every CUDA
tensor in each trial's result before it stops the clock, as the
reference's ``block_until_ready`` walk does, and `device_trace` records
a ``torch.profiler`` trace whose Chrome export names every device
kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import time as _time

import torch

__all__ = ["get_logger", "timer", "benchmark", "device_trace", "annotate"]

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
_TRACE_SEQ = itertools.count()


def get_logger(name: str = "mosaic_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


@contextlib.contextmanager
def timer(label: str = "", logger: "logging.Logger | None" = None):
    """Wall-clock a block; yields a dict that gets ``seconds`` on exit."""
    out = {"label": label}
    t0 = _time.perf_counter()
    try:
        yield out
    finally:
        out["seconds"] = _time.perf_counter() - t0
        (logger or get_logger()).info("%s: %.4fs", label or "block", out["seconds"])


def _cuda_devices(obj, found: set, depth: int = 0) -> set:
    """The CUDA devices of every tensor in ``obj``: tensors, tuples,
    lists, dicts, dataclasses and ``.metrics`` holders, walked as the
    reference's tree map walks its pytrees."""
    if depth > 16:
        return found
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _cuda_devices(x, found, depth + 1)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, found, depth + 1)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name, None), found, depth + 1)
    if hasattr(obj, "metrics") and not isinstance(obj, type):
        m = getattr(obj, "metrics", None)
        if isinstance(m, dict):
            _cuda_devices(m, found, depth + 1)
    return found


def _sync(result):
    """Wait for the device work behind ``result``: every CUDA device a
    tensor of it lives on is synchronised."""
    for dev in _cuda_devices(result, set()):
        torch.cuda.synchronize(dev)
    return result


def benchmark(fn, *args, trials: int = 5, warmup: int = 1, **kwargs) -> dict:
    """Median/min/mean wall-clock of ``fn`` with device-sync per trial
    (reference: SparkSuite.benchmark, restart-per-trial)."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(trials):
        t0 = _time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(_time.perf_counter() - t0)
    times.sort()
    return {
        "trials": trials,
        "min_s": times[0],
        "median_s": times[len(times) // 2],
        "mean_s": sum(times) / len(times),
    }


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Capture a ``torch.profiler`` trace of the block and export it as
    Chrome trace-event JSON under ``log_dir`` (view it in Perfetto or
    ``chrome://tracing``); yields the profiler, whose ``trace_path`` is
    the file's path once the block ends. The card's kernels are traced by
    default; ``device="cpu"`` traces the host only."""
    from torch.profiler import ProfilerActivity, profile

    from .. import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json"
        )
        prof.export_chrome_trace(path)
        prof.trace_path = path


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
