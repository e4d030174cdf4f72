"""Device-timeline reconstruction and stall attribution over trails.

Port of ``mosaic_tpu/obs/timeline.py``, with its class rules, container
keys and arithmetic. Spans record durations; this module recovers
intervals and turns one totally-ordered trail (``runtime/telemetry.py``
events, spans included) into an accountable timeline: where a window of
wall time went, classified into a small closed set of stall classes.

The timeline is the host's view: a span ends when its host code returns.
On the card a stream segment whose launches are queued without a host
sync ends when they are queued, not when the card has run them, so its
``device`` share is the host's time spent issuing device work, and the
card's own busy time comes from the profiler.

The interval model
------------------
Every event carrying a numeric ``seconds`` field is an interval:

- a span (``event="span"``) covers ``[start_mono, start_mono+seconds]``
  (``Span.end`` records its rounded ``time.monotonic`` start);
- a flat ``telemetry.timed`` stage covers ``[ts_mono - seconds,
  ts_mono]`` (timed records at block *end* with a monotonic stamp).

Both clocks are the same process-wide monotonic clock, so intervals
from different threads land on one shared time axis; ``seq`` breaks
ties for deterministic ordering.

Classification
--------------
:data:`CLASS_RULES` maps stage keys (``trace_report.stage_key``
convention: ``span.<name>``, ``<event>.<stage>``, bare event) onto the
closed class set ``{compile, transfer, queue_wait, host_callback,
device}``; anything uncovered inside the window is ``idle``. *Container*
keys (``span.stream.durable_run``, ``stream_stage.join_loop``, request
roots, bench wrappers) are explicitly excluded — they span their
children and would double-count the whole window as one class.

Attribution
-----------
:func:`attribute` flattens the classified intervals over a window with
a boundary sweep: at every instant exactly ONE class owns the time —
the highest-priority class with an active interval (``compile >
transfer > queue_wait > host_callback > device``), else ``idle``. The
result is a partition, so the per-class seconds sum to the window
EXACTLY (the stall_report acceptance bound is met by construction,
modulo float rounding). Priority encodes blame: a transfer running
under a device-compute span is the pipeline bubble the device span
merely contains.

Stdlib-only; imports nothing above ``runtime/telemetry.py`` (nothing at
all, in fact), so tools and tests can use it against raw trails.
"""

from __future__ import annotations

import fnmatch

#: flatten priority, highest first; ``idle`` is implicit (uncovered)
CLASS_PRIORITY = (
    "compile", "transfer", "queue_wait", "host_callback", "device",
)

#: ordered ``(class, key-pattern)`` rules — first fnmatch wins
CLASS_RULES: tuple = (
    # -- compile: cold-path signature builds and warmups
    ("compile", "span.dispatch.compile"),
    ("compile", "span.dispatch.warmup"),
    ("compile", "span.serve.warmup"),
    ("compile", "stream_stage.compile"),
    ("compile", "stream_stage.gen_compile"),
    ("compile", "dispatch_stage.warmup"),
    ("compile", "serve_stage.warmup"),
    ("compile", "serve_compile"),
    # -- transfer: H2D/D2H bytes on the wire (ring staging is the
    #    stream's H2D; snapshot cell pulls are a true D2H)
    ("transfer", "span.dispatch.transfer.h2d"),
    ("transfer", "span.dispatch.transfer.d2h"),
    ("transfer", "span.stream.ring_build"),
    ("transfer", "stream_stage.ring_build"),
    # -- queue_wait: admitted but not yet in a forming batch
    ("queue_wait", "serve_stage.queue_wait"),
    # -- host_callback: host-side work the device waits out
    #    (snapshot writes, admission scrubbing, quarantine probes);
    #    pipelined runs emit stream.snapshot from the writer thread —
    #    same class, but now its interval OVERLAPS device intervals
    #    instead of serializing after them (the flatten priority still
    #    books the overlap to the device's thief classes correctly)
    ("host_callback", "span.stream.snapshot"),
    ("host_callback", "span.raster.snapshot"),
    ("host_callback", "span.stream.admit"),
    ("host_callback", "span.serve.admit"),
    ("host_callback", "span.stream.pipeline.flush"),
    ("host_callback", "stream_stage.pipeline_flush"),
    ("host_callback", "quarantine_stage.*"),
    ("host_callback", "recheck_narrow"),
    # -- device: the useful work everything above steals from
    #    (the pipeline drain is the bounded window's one blocking pull:
    #    the wall it spends is device execution the host waits out)
    ("device", "span.stream.pipeline.drain"),
    ("device", "stream_stage.pipeline_drain"),
    ("device", "span.stream.segment"),
    ("device", "span.serve.dispatch"),
    ("device", "span.serve.batch"),
    ("device", "span.raster.zonal"),
    ("device", "span.raster.tile"),
    ("device", "span.raster.assign"),
    ("device", "span.join.pip"),
    ("device", "span.join.probe.*"),
    ("device", "serve_stage.dispatch"),
    ("device", "serve_stage.batch"),
    ("device", "stream_stage.gen_loop"),
    ("device", "probe_stage.*"),
    ("device", "raster_stage.*"),
    ("device", "multichip_stage.*"),
)

#: container keys spanning their own children — never classified
#: (classifying one would attribute the whole window to a single class)
CONTAINER_KEYS = frozenset({
    "span.stream.durable_run",
    "span.stream.run",
    "span.serve.request",
    "span.raster.scan",
    "stream_stage.durable_loop",
    "stream_stage.join_loop",
    "stream_stage.single_batch",
    "raster_stage.scan",
    "span.stream_bench",
    "span.raster_bench",
    "span.multichip_bench",
    "span.probe_smoke",
})


def event_key(e: dict) -> str | None:
    """The stage key of one event — the `tools/trace_report.py`
    convention, restated here so the library layer never imports tools:
    ``span.<name>`` for spans, ``<event>.<stage>`` for staged events, a
    pass-through ``stage_key`` (perf_gate golden pseudo-events), else
    the bare event name when it carries a numeric ``seconds``."""
    if e.get("event") == "span" and e.get("name"):
        return f"span.{e['name']}"
    if "stage_key" in e:
        return str(e["stage_key"])
    if e.get("stage"):
        return f"{e.get('event', 'event')}.{e['stage']}"
    if isinstance(e.get("seconds"), (int, float)):
        return str(e.get("event", "event"))
    return None


def classify_key(key: str | None) -> str | None:
    """The stall class of one stage key, or None (container / unknown
    keys stay unclassified and never claim timeline ownership)."""
    if key is None or key in CONTAINER_KEYS:
        return None
    for cls, pat in CLASS_RULES:
        if key == pat or fnmatch.fnmatchcase(key, pat):
            return cls
    return None


def interval_of(e: dict) -> tuple[float, float] | None:
    """``(start, end)`` on the monotonic clock, or None for instants."""
    sec = e.get("seconds")
    if not isinstance(sec, (int, float)) or sec < 0:
        return None
    start = e.get("start_mono")
    if start is not None:
        return float(start), float(start) + float(sec)
    ts = e.get("ts_mono")
    if ts is None:
        return None
    return float(ts) - float(sec), float(ts)


def intervals(events) -> list[dict]:
    """Every classifiable interval in a trail:
    ``{"start", "end", "key", "cls", "seq"}``, ordered by start."""
    out = []
    for e in events:
        key = event_key(e)
        cls = classify_key(key)
        if cls is None:
            continue
        iv = interval_of(e)
        if iv is None:
            continue
        out.append({
            "start": iv[0], "end": iv[1], "key": key, "cls": cls,
            "seq": e.get("seq", 0),
        })
    out.sort(key=lambda r: (r["start"], r["seq"]))
    return out


def flatten(ivals, window: tuple[float, float]) -> list[dict]:
    """Partition ``window`` into single-owner segments.

    Boundary sweep over the clipped intervals: between consecutive
    boundaries the owner is the highest-:data:`CLASS_PRIORITY` class
    with an active interval, else ``idle``. Adjacent same-owner
    segments merge. The segments tile the window exactly — their
    seconds sum to ``window[1] - window[0]``.
    """
    t0, t1 = float(window[0]), float(window[1])
    if t1 <= t0:
        return []
    marks: list[tuple[float, int, str]] = []
    for iv in ivals:
        s, e = max(iv["start"], t0), min(iv["end"], t1)
        if e <= s:
            continue
        marks.append((s, +1, iv["cls"]))
        marks.append((e, -1, iv["cls"]))
    bounds = sorted({t0, t1, *(m[0] for m in marks)})
    marks.sort(key=lambda m: m[0])
    rank = {c: i for i, c in enumerate(CLASS_PRIORITY)}
    active = {c: 0 for c in CLASS_PRIORITY}
    segs: list[dict] = []
    mi = 0
    for bi in range(len(bounds) - 1):
        lo, hi = bounds[bi], bounds[bi + 1]
        while mi < len(marks) and marks[mi][0] <= lo:
            active[marks[mi][2]] += marks[mi][1]
            mi += 1
        owner = "idle"
        best = len(CLASS_PRIORITY)
        for c, n in active.items():
            if n > 0 and rank[c] < best:
                owner, best = c, rank[c]
        if segs and segs[-1]["cls"] == owner:
            segs[-1]["end"] = hi
        else:
            segs.append({"start": lo, "end": hi, "cls": owner})
    return segs


def pick_window(events) -> tuple[float, float, str] | None:
    """The attribution window of a trail: the durable loop when present
    (``stream_stage.durable_loop``), else the single-run join loop
    (``stream_stage.join_loop``), else the envelope of classified
    intervals. Returns ``(t0, t1, source_key)`` or None."""
    for key in ("stream_stage.durable_loop", "stream_stage.join_loop"):
        for e in events:
            if event_key(e) == key:
                iv = interval_of(e)
                if iv is not None:
                    return iv[0], iv[1], key
    ivals = intervals(events)
    if not ivals:
        return None
    return (
        min(r["start"] for r in ivals),
        max(r["end"] for r in ivals),
        "envelope",
    )


def attribute(
    events, window: tuple[float, float] | None = None
) -> dict | None:
    """Classified wall-time attribution over a window.

    ``{"window": {...}, "wall_s", "classes": {cls: {"seconds",
    "share"}}, "sum_s", "segments": n, "critical_path": [...]}`` —
    the classes (idle included) partition the wall exactly; the
    critical path is the flattened owner sequence's top segments.
    """
    if window is None:
        w = pick_window(events)
        if w is None:
            return None
        t0, t1, source = w
    else:
        t0, t1 = float(window[0]), float(window[1])
        source = "explicit"
    wall = t1 - t0
    if wall <= 0:
        return None
    segs = flatten(intervals(events), (t0, t1))
    classes = {c: 0.0 for c in (*CLASS_PRIORITY, "idle")}
    for s in segs:
        classes[s["cls"]] += s["end"] - s["start"]
    out_classes = {
        c: {
            "seconds": round(sec, 6),
            "share": round(sec / wall, 4),
        }
        for c, sec in classes.items()
    }
    top = sorted(
        segs, key=lambda s: s["end"] - s["start"], reverse=True
    )[:10]
    return {
        "window": {
            "start": round(t0, 6), "end": round(t1, 6),
            "source": source,
        },
        "wall_s": round(wall, 6),
        "classes": out_classes,
        "sum_s": round(sum(classes.values()), 6),
        "segments": len(segs),
        "critical_path": [
            {
                "cls": s["cls"],
                "start": round(s["start"] - t0, 6),
                "seconds": round(s["end"] - s["start"], 6),
            }
            for s in top
        ],
    }


def build_tracks(events) -> dict:
    """Per-key timeline tracks: ``{key: {"count", "busy_s", "span_s",
    "gap_s", "intervals": [(start, end), ...]}}`` with same-key
    intervals merged — the raw material for gap/overlap questions
    (`is the ring build overlapped with the previous segment?`)."""
    by_key: dict = {}
    for iv in intervals(events):
        by_key.setdefault(iv["key"], []).append((iv["start"], iv["end"]))
    out = {}
    for key, ivs in by_key.items():
        n_raw = len(ivs)
        merged = merge_intervals(ivs)
        busy = sum(e - s for s, e in merged)
        span_s = merged[-1][1] - merged[0][0]
        out[key] = {
            "count": n_raw,
            "busy_s": round(busy, 6),
            "span_s": round(span_s, 6),
            "gap_s": round(span_s - busy, 6),
            "intervals": [(round(s, 6), round(e, 6)) for s, e in merged],
        }
    return out


def merge_intervals(ivs) -> list[tuple[float, float]]:
    """Union of ``(start, end)`` pairs as a sorted disjoint list."""
    out: list[list[float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_s(a, b) -> float:
    """Total overlap seconds between two ``(start, end)`` lists —
    the pipeline-overlap measure (3DPipe's question: is transfer
    hidden under compute, or serialized after it?)."""
    am, bm = merge_intervals(a), merge_intervals(b)
    i = j = 0
    total = 0.0
    while i < len(am) and j < len(bm):
        lo = max(am[i][0], bm[j][0])
        hi = min(am[i][1], bm[j][1])
        if hi > lo:
            total += hi - lo
        if am[i][1] <= bm[j][1]:
            i += 1
        else:
            j += 1
    return round(total, 6)


def overlap_fraction(a, b) -> float:
    """The share of ``a``'s busy seconds hidden under ``b`` —
    ``overlap_s(a, b) / busy(a)``, 0.0 when ``a`` is empty.

    This is the pipeline's "off the critical path" claim as a number:
    with ``a`` = snapshot ``host_callback`` intervals and ``b`` =
    ``device`` intervals, a synchronous loop scores ~0 (snapshots
    serialize after compute) and a pipelined run approaches 1 (the
    writer thread runs while the next segments execute)."""
    am = merge_intervals(a)
    busy = sum(e - s for s, e in am)
    if busy <= 0:
        return 0.0
    return round(overlap_s(am, b) / busy, 6)
