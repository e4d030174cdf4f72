"""What a traced run records for the per-layer readers.

- ``spans``: the benchmark's own spans around calls into the program,
  each ``{"name", "seconds", "points", "clock"}``; ``clock`` is ``host``
  (perf_counter around a call that ends on the host) or ``device`` (CUDA
  events around the call).
- ``profile``: one ``torch.profiler`` window over a steady part of the
  run, read from its Chrome trace: the device's kernels, copies and
  memsets, and the host's spans and operators, on one clock.
- ``work``: what the kernels launched in the profiled window needed,
  counted by the harness (``roofline.py``), by kernel.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile

#: Chrome-trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the span that bounds the profiled window
WINDOW = "geobench.window"
#: entries of each breakdown list
TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Profile:
    """Intervals in microseconds on the trace's clock."""

    window: tuple[float, float]
    device: list  # (name, start, end)
    host_spans: list  # (name, start, end): the benchmark's spans
    host_ops: list  # (name, start, end): the host's operators

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device op ran."""
        w0, w1 = self.window
        busy, end = 0.0, w0
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, end), min(e, w1)
            if e > s:
                busy += e - s
                end = e
        return busy / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        w0, w1 = self.window
        out, end = [], w0
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if s > end:
                out.append((end, min(s, w1)))
            end = max(end, e)
            if end >= w1:
                break
        if end < w1:
            out.append((end, w1))
        return [g for g in out if g[1] > g[0]]

    def device_ops(self) -> list:
        """[[name, seconds], ...] of the device ops that took most time."""
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:NAME_CHARS], v] for n, v in sorted(by.items(), key=lambda x: -x[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[[what the host was doing, seconds], ...] of the longest gaps:
        the benchmark's innermost span open at the gap's start, and the
        host operator open then, if any."""
        out = []
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]:
            what = _innermost(self.host_spans, s) or "outside any span"
            op = _innermost(self.host_ops, s)
            out.append([f"{what} / {op}"[:NAME_CHARS] if op else what, (e - s) / 1e6])
        return out


def _innermost(intervals, t):
    best = None
    for n, s, e in intervals:
        if s <= t < e and (best is None or s >= best[1]):
            best = (n, s)
    return best[0] if best else None


def read_chrome_trace(path: str) -> Profile | None:
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    device, spans, ops, window = [], [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        iv = (name, s, s + float(ev["dur"]))
        if cat in DEVICE_CATS:
            device.append(iv)
        elif cat == "user_annotation":
            if name == WINDOW:
                window = (iv[1], iv[2])
            spans.append(iv)
        elif cat in ("cpu_op", "cuda_runtime"):
            ops.append(iv)
    if window is None:
        return None
    return Profile(window=window, device=device, host_spans=spans, host_ops=ops)


def profile(fn) -> Profile | None:
    """Run ``fn()`` under the profiler inside the ``geobench.window`` span
    and read the trace back; None where the trace has no window. The
    trace file lives in a temporary directory, removed here."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    d = tempfile.mkdtemp(prefix="geobench-trace-")
    try:
        with torch_profile(activities=acts) as prof:
            with record_function(WINDOW):
                fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return read_chrome_trace(path)
    finally:
        shutil.rmtree(d, ignore_errors=True)


@dataclasses.dataclass
class Trace:
    spans: list = dataclasses.field(default_factory=list)
    profile: Profile | None = None
    work: dict = dataclasses.field(default_factory=dict)

    def of(self, name: str, clock: str) -> list:
        return [s for s in self.spans if s["name"] == name and s["clock"] == clock]

    def kernel_seconds(self, frags) -> tuple[float, int]:
        """(device seconds, launches) of every op whose name holds one of
        ``frags`` in the profiled window; launches count the first."""
        if self.profile is None:
            return 0.0, 0
        sec, n = 0.0, 0
        for name, s, e in self.profile.device:
            if any(f in name for f in frags):
                sec += (e - s) / 1e6
                n += frags[0] in name
        return sec, n
