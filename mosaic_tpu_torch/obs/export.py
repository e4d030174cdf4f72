"""Exporters: one event trail, three standard renderings.

Port of ``mosaic_tpu/obs/export.py``, with its file formats: a trail
either package writes, the other reads. The telemetry spine produces one
totally-ordered list of flat event dicts (spans included, as
``event="span"``); this module turns it into the formats the outside
world reads:

- :func:`write_jsonl` / :func:`read_trail` — the trail itself, one JSON
  object per line, opened by an ``event="incarnation"`` header
  (``read_trail`` also accepts a bench artifact whose one line is a JSON
  object and reads ``detail.trail`` / ``detail.stages``);
- :func:`chrome_trace` — Chrome trace-event JSON (the ``traceEvents``
  array format Perfetto and ``chrome://tracing`` load): spans become
  complete ``"X"`` events on one timeline row per trace, flat events
  become instants, and intervals of a stall class also land on a named
  track of their class — the host-side complement of the profiler's
  device trace;
- :func:`prometheus_text` — the metrics registry snapshot in Prometheus
  text exposition format (``# TYPE``/``# HELP``, ``_bucket``/``_sum``/
  ``_count`` histogram series), ready for a scrape endpoint.

:func:`trace_summary` is the connectivity checker the acceptance tests
and ``tools/trace_report.py`` share: per trace — span count, roots, and orphans
(spans whose ``parent_id`` is not a span of the same trace).
"""

from __future__ import annotations

import json

from ..runtime import telemetry as _telemetry
from . import metrics as _metrics, timeline as _timeline

#: fixed Perfetto rows for classified intervals — stable tids well
#: above the per-trace rows so the stall classes read as named tracks
_CLASS_TIDS = {
    "compile": 1001,
    "transfer": 1002,
    "queue_wait": 1003,
    "host_callback": 1004,
}

#: span-event bookkeeping fields that are NOT user attributes
_SPAN_FIELDS = (
    "event", "seq", "ts_mono", "name", "trace_id", "span_id",
    "parent_id", "seconds", "start_mono",
)


def write_jsonl(
    events, path: str, *, stamp_incarnation: bool = True
) -> int:
    """Write events as JSON Lines; returns the number of lines written.

    Unless ``stamp_incarnation=False`` (or the first event already IS an
    incarnation meta row — e.g. re-writing a stitched fleet trail), the
    trail opens with one ``event="incarnation"`` line carrying this
    process's :data:`~mosaic_tpu_torch.runtime.telemetry.INCARNATION` id and a
    paired ``ts_mono``/``ts_epoch`` wall-clock anchor — the hook
    `tools/fleet_report.py` uses to merge many processes' trails onto
    one timeline.
    """
    n = 0
    with open(path, "w") as f:
        first = events[0] if isinstance(events, (list, tuple)) and events else None
        if stamp_incarnation and not (
            isinstance(first, dict) and first.get("event") == "incarnation"
        ):
            f.write(json.dumps(_telemetry.incarnation_event()) + "\n")
            n += 1
        for e in events:
            f.write(json.dumps(e, default=repr) + "\n")
            n += 1
    return n


def read_trail(path: str) -> list[dict]:
    """Load an event trail: a JSONL file, or a bench artifact (one JSON
    object whose ``detail`` embeds ``trail`` or ``stages``)."""
    rows: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if len(rows) == 1 and "detail" in rows[0]:
        det = rows[0]["detail"] or {}
        stages = det.get("trail") or det.get("stages") or []
        if isinstance(stages, dict):
            # summary-only artifact ({stage_key: {total_s, count, ...}},
            # the perf_gate golden shape): synthesize one pseudo-event
            # per stage so breakdowns/diffs keep a real base instead of
            # iterating the dict's key strings.
            return [
                {
                    "event": "stage_summary",
                    "stage_key": k,
                    "seconds": float(v.get("total_s", 0.0)),
                    "count": int(v.get("count", 1)),
                }
                for k, v in stages.items()
                if isinstance(v, dict)
            ]
        return list(stages)
    return rows


def chrome_trace(events) -> dict:
    """Render a trail as Chrome trace-event JSON (Perfetto-loadable).

    Spans become complete (``ph="X"``) events — one ``tid`` row per
    trace, timestamps in microseconds on the shared monotonic clock —
    and every other timestamped event becomes a thread-scoped instant
    (``ph="i"``) on its trace's row (row 0 for untraced events), so
    retries and stalls appear inside the span that owns them.

    Intervals the timeline layer classifies as a stall class (compile,
    transfer, queue_wait, host_callback — see `obs/timeline.py`)
    ADDITIONALLY land on a fixed named track per class (``mosaic:<cls>``
    via ``thread_name`` metadata), so the Perfetto view answers the
    overlap question at a glance: is the transfer row hidden under the
    trace rows' compute, or serialized after it?
    """
    tids: dict = {}
    out = []
    used_class_tids: dict = {}

    def tid_for(trace_id) -> int:
        if trace_id is None:
            return 0
        return tids.setdefault(trace_id, len(tids) + 1)

    def class_track(e, name: str) -> None:
        key = _timeline.event_key(e)
        cls = _timeline.classify_key(key)
        tid = _CLASS_TIDS.get(cls)
        if tid is None:
            return
        iv = _timeline.interval_of(e)
        if iv is None:
            return
        used_class_tids[tid] = cls
        out.append({
            "name": name,
            "cat": "mosaic.timeline",
            "ph": "X",
            "ts": round(iv[0] * 1e6, 1),
            "dur": round((iv[1] - iv[0]) * 1e6, 1),
            "pid": 1,
            "tid": tid,
            "args": {"class": cls, "trace_id": e.get("trace_id")},
        })

    for e in events:
        if e.get("event") == "span" and "seconds" in e:
            start = e.get("start_mono")
            if start is None:
                start = e.get("ts_mono", 0.0) - e["seconds"]
            args = {k: v for k, v in e.items() if k not in _SPAN_FIELDS}
            args.update(
                trace_id=e.get("trace_id"),
                span_id=e.get("span_id"),
                parent_id=e.get("parent_id"),
            )
            out.append({
                "name": e.get("name", "span"),
                "cat": "mosaic",
                "ph": "X",
                "ts": round(start * 1e6, 1),
                "dur": round(e["seconds"] * 1e6, 1),
                "pid": 1,
                "tid": tid_for(e.get("trace_id")),
                "args": args,
            })
            class_track(e, e.get("name", "span"))
        elif "ts_mono" in e:
            out.append({
                "name": str(e.get("event", "event")),
                "cat": "mosaic",
                "ph": "i",
                "s": "t",
                "ts": round(e["ts_mono"] * 1e6, 1),
                "pid": 1,
                "tid": tid_for(e.get("trace_id")),
                "args": {
                    k: v for k, v in e.items()
                    if k not in ("event", "seq", "ts_mono")
                },
            })
            if "seconds" in e:
                class_track(
                    e, _timeline.event_key(e) or str(e.get("event"))
                )
    for tid, cls in sorted(used_class_tids.items()):
        out.append({
            "name": "thread_name",
            "ph": "M",
            "pid": 1,
            "tid": tid,
            "args": {"name": f"mosaic:{cls}"},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events, path: str) -> int:
    """Write :func:`chrome_trace` JSON; returns the event count."""
    doc = chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f, default=repr)
    return len(doc["traceEvents"])


def trace_summary(events) -> dict:
    """Per-trace connectivity: ``{trace_id: {"spans": n, "names": [...],
    "roots": n, "orphans": [names]}}``.

    A *root* has ``parent_id=None``; an *orphan*'s ``parent_id`` names
    no span in its own trace — the acceptance contract for serve and
    durable-stream traces is exactly one root and zero orphans.
    """
    by_trace: dict = {}
    for e in events:
        if e.get("event") != "span" or not e.get("trace_id"):
            continue
        t = by_trace.setdefault(
            e["trace_id"], {"spans": [], "ids": set()}
        )
        t["spans"].append(e)
        t["ids"].add(e.get("span_id"))
    out = {}
    for trace_id, t in by_trace.items():
        roots, orphans = 0, []
        for s in t["spans"]:
            p = s.get("parent_id")
            if p is None:
                roots += 1
            elif p not in t["ids"]:
                orphans.append(s.get("name"))
        out[trace_id] = {
            "spans": len(t["spans"]),
            "names": sorted(s.get("name", "") for s in t["spans"]),
            "roots": roots,
            "orphans": orphans,
        }
    return out


def _sanitize(name: str) -> str:
    return "".join(
        c if (c.isalnum() or c == "_") else "_" for c in name
    )


def _escape_label_value(v) -> str:
    """Escape a label VALUE per the Prometheus text exposition format:
    backslash, double-quote, and line feed — in that order (escaping
    the escapes first keeps the round trip lossless)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels_text(labels: dict, extra: dict | None = None) -> str:
    items = {**labels, **(extra or {})}
    if not items:
        return ""
    body = ",".join(
        f'{_sanitize(str(k))}="{_escape_label_value(v)}"'
        for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def prometheus_text(snapshot: dict | None = None) -> str:
    """Render a metrics snapshot (default: the live registry) as
    Prometheus text exposition format."""
    snap = _metrics.snapshot() if snapshot is None else snapshot
    lines: list[str] = []
    for name in sorted(snap):
        m = snap[name]
        pname = _sanitize(name)
        if m.get("help"):
            lines.append(f"# HELP {pname} {m['help']}")
        lines.append(f"# TYPE {pname} {m['kind']}")
        for s in m["series"]:
            labels, value = s["labels"], s["value"]
            if m["kind"] == "histogram":
                cum = 0
                edges = [str(b) for b in value["buckets"]] + ["+Inf"]
                for count, le in zip(value["counts"], edges):
                    cum += count
                    lines.append(
                        f"{pname}_bucket"
                        f"{_labels_text(labels, {'le': le})} {cum}"
                    )
                lines.append(
                    f"{pname}_sum{_labels_text(labels)} {value['sum']}"
                )
                lines.append(
                    f"{pname}_count{_labels_text(labels)} {value['count']}"
                )
            else:
                lines.append(f"{pname}{_labels_text(labels)} {value}")
    return "\n".join(lines) + "\n"
