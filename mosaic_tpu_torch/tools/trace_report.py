"""Per-stage latency breakdown (and diff) from a telemetry trail.

    python -m mosaic_tpu_torch.tools.trace_report TRAIL.jsonl
    python -m mosaic_tpu_torch.tools.trace_report FRESH.jsonl --against BASE.jsonl
    python -m mosaic_tpu_torch.tools.trace_report --fleet A.jsonl B.jsonl ...

Port of ``tools/trace_report.py``, with its stage keys, report and diff.
Renders what a run spent its time on:

- per stage (``stream_stage.join_loop``, ``serve_stage.dispatch``,
  ``span.serve.request``, ...): count, total seconds, share of the
  trail's total, p50/p99 via the shared ``telemetry.summarize`` helper;
- trace connectivity: traces, spans, roots, orphans
  (``obs.trace_summary``);
- ``--against OTHER``: per-stage share/total deltas between two trails
  (one-sided stages are tagged ``only_in``).

Accepts JSONL trails (either package's) or a bench artifact whose one
line is a JSON object with ``detail.stages``/``detail.trail``.
``--fleet`` stitches MANY trails onto one wall-clock axis by their
incarnation headers (``fleet_report``) before reporting. The
human-readable report goes to stderr; the LAST stdout line is one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import sys


def stage_key(event: dict) -> str | None:
    """The gate/report stage identity of one event, or None.

    Timed stage events (``*_stage`` with a ``stage`` field) key as
    ``<event>.<stage>``; span events as ``span.<name>``; any other
    event carrying a numeric ``seconds`` keys as its event name.
    Pre-keyed summary pseudo-events (``stage_key``, from summary-only
    artifacts) pass their key through. Non-dict rows are skipped.
    """
    if not isinstance(event, dict):
        return None
    if not isinstance(event.get("seconds"), (int, float)):
        return None
    if "stage_key" in event:
        return str(event["stage_key"])
    ev = event.get("event", "")
    if ev == "span":
        return f"span.{event.get('name', '')}"
    if "stage" in event:
        return f"{ev}.{event['stage']}"
    return ev


def stage_breakdown(events) -> dict:
    """``{stage_key: {"count", "total_s", "share", "p50", "p99"}}``,
    shares over the summed seconds of all keyed events."""
    from mosaic_tpu_torch.runtime import telemetry

    groups: dict[str, list] = {}
    for e in events:
        key = stage_key(e)
        if key:
            groups.setdefault(key, []).append(e)
    total = sum(
        e["seconds"] for evs in groups.values() for e in evs
    )
    out = {}
    for key, evs in sorted(groups.items()):
        s = telemetry.summarize(evs)
        out[key] = {
            "count": s["count"],
            "total_s": s["sum"],
            "share": round(s["sum"] / total, 4) if total else 0.0,
            "p50": s["p50"],
            "p99": s["p99"],
        }
    return out


def diff_breakdown(fresh: dict, base: dict) -> dict:
    """Per-stage comparison: share delta and total ratio (None when the
    stage is missing on either side). One-sided stages are tolerated and
    tagged ``only_in``."""
    out = {}
    for key in sorted(set(fresh) | set(base)):
        f, b = fresh.get(key), base.get(key)
        entry = {
            "share": f["share"] if f else None,
            "base_share": b["share"] if b else None,
            "share_delta": (
                round(f["share"] - b["share"], 4) if f and b else None
            ),
            "total_ratio": (
                round(f["total_s"] / b["total_s"], 3)
                if f and b and b["total_s"] > 0
                else None
            ),
        }
        if f is None or b is None:
            entry["only_in"] = "base" if f is None else "fresh"
        out[key] = entry
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m mosaic_tpu_torch.tools.trace_report")
    ap.add_argument("trail", nargs="+",
                    help="JSONL trail or bench artifact (several with "
                         "--fleet)")
    ap.add_argument("--against", default=None,
                    help="second trail to diff against")
    ap.add_argument("--fleet", action="store_true",
                    help="stitch MANY trails by incarnation header "
                         "(fleet_report) and report over the merge")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report here")
    args = ap.parse_args(argv)

    from mosaic_tpu_torch.obs import export, trace_summary

    if args.fleet:
        from mosaic_tpu_torch.tools import fleet_report as _fleet

        events, fleet = _fleet.stitch(args.trail)
        trail_name = ",".join(args.trail)
    elif len(args.trail) > 1:
        ap.error("multiple trails require --fleet")
    else:
        events = export.read_trail(args.trail[0])
        fleet = None
        trail_name = args.trail[0]
    stages = stage_breakdown(events)
    traces = trace_summary(events)
    report = {
        "metric": "trace_report",
        "trail": trail_name,
        "events": len(events),
        "spans": sum(t["spans"] for t in traces.values()),
        "traces": len(traces),
        "connected_traces": sum(
            1 for t in traces.values()
            if t["roots"] == 1 and not t["orphans"]
        ),
        "stages": stages,
    }
    if fleet is not None:
        report["fleet"] = {
            "incarnations": len(fleet["incarnations"]),
            "chain": fleet["chain"],
            "cross_incarnation_traces": fleet["cross_incarnation_traces"],
        }

    w = sys.stderr.write
    w(f"trail: {trail_name} ({len(events)} events, "
      f"{report['spans']} spans in {report['traces']} traces, "
      f"{report['connected_traces']} fully connected)\n")
    if fleet is not None:
        for link in fleet["chain"]:
            gap = (
                f"  (+{link['gap_s']:.3f}s after {link['prev']})"
                if "prev" in link else ""
            )
            w(f"  {link['incarnation']}: {link['events']} events over "
              f"{link['span_s']:.3f}s{gap}\n")
    w(f"{'stage':<38} {'count':>6} {'total_s':>9} {'share':>6} "
      f"{'p50':>9} {'p99':>9}\n")
    for key, s in sorted(
        stages.items(), key=lambda kv: -kv[1]["total_s"]
    ):
        w(f"{key:<38} {s['count']:>6} {s['total_s']:>9.4f} "
          f"{s['share']:>6.1%} {s['p50']:>9.4f} {s['p99']:>9.4f}\n")

    if args.against:
        base = stage_breakdown(export.read_trail(args.against))
        report["against"] = args.against
        report["diff"] = diff_breakdown(stages, base)
        w(f"\nvs {args.against}:\n")
        w(f"{'stage':<38} {'share':>7} {'base':>7} {'delta':>8} "
          f"{'ratio':>7}\n")
        for key, d in sorted(
            report["diff"].items(),
            key=lambda kv: -(abs(kv[1]["share_delta"] or 0)),
        ):
            fmt = lambda v, p: ("-" if v is None else f"{v:{p}}")  # noqa: E731
            tag = (
                f"  ({d['only_in']} only)" if d.get("only_in") else ""
            )
            w(f"{key:<38} {fmt(d['share'], '7.1%')} "
              f"{fmt(d['base_share'], '7.1%')} "
              f"{fmt(d['share_delta'], '+8.1%')} "
              f"{fmt(d['total_ratio'], '7.2f')}{tag}\n")

    line = json.dumps(report)
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
