"""Stitch many processes' trails into one logical fleet timeline.

    python -m mosaic_tpu_torch.tools.fleet_report A.jsonl B.jsonl ... [--out merged.jsonl]
    python -m mosaic_tpu_torch.tools.trace_report --fleet A.jsonl B.jsonl ...

Port of ``tools/fleet_report.py``, with its stitching rule and report.
Every trail either package writes (``obs.write_jsonl`` exports,
flight-recorder dumps) opens with one ``event="incarnation"`` line: the
process's :data:`~mosaic_tpu_torch.runtime.telemetry.INCARNATION` id
plus a paired ``ts_mono``/``ts_epoch`` sample. That pair bridges the
clocks: any event's wall time is

    ts_wall = anchor.ts_epoch + (e.ts_mono - anchor.ts_mono)

so trails of any number of incarnations merge onto ONE wall-clock axis:

- every event gains ``incarnation`` and ``ts_wall`` fields and the
  merged trail is sorted by ``ts_wall`` (ties by incarnation, then
  ``seq``);
- per-incarnation summary: pid, start wall time, span covered, event
  count, and the trail files it came from;
- **incarnation links**: trace ids seen in more than one incarnation,
  plus the restart chain — each incarnation's predecessor on the wall
  clock, with the gap seconds.

Trails WITHOUT an incarnation header still stitch: they get a synthetic
``file:<stem>`` incarnation and their raw monotonic stamps as
``ts_wall``.

Human-readable summary on stderr; the LAST stdout line is one JSON
object. ``--out`` writes the merged trail as JSONL, readable by
``trace_report`` and ``doctor``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def stitch(paths) -> tuple[list[dict], dict]:
    """Merge trails from ``paths`` onto one wall-clock axis.

    Returns ``(events, summary)``: the merged, ``ts_wall``-sorted event
    list (every event stamped with ``incarnation`` and ``ts_wall``) and
    the fleet summary (per-incarnation stats, restart chain, and
    cross-incarnation trace links).
    """
    from mosaic_tpu_torch.obs import export
    from mosaic_tpu_torch.runtime import telemetry

    merged: list[dict] = []
    incarnations: dict[str, dict] = {}
    with telemetry.timed("ops_stage", stage="stitch", trails=len(paths)):
        for path in paths:
            rows = export.read_trail(path)
            anchor = None
            if rows and isinstance(rows[0], dict) and (
                rows[0].get("event") == "incarnation"
            ):
                anchor = rows[0]
            if anchor is not None and isinstance(
                anchor.get("ts_mono"), (int, float)
            ) and isinstance(anchor.get("ts_epoch"), (int, float)):
                inc = str(anchor.get("incarnation"))
                offset = anchor["ts_epoch"] - anchor["ts_mono"]
                pid = anchor.get("pid")
            else:
                # pre-ops-plane trail: synthetic incarnation, raw
                # monotonic stamps as the wall axis (best-effort)
                inc = f"file:{os.path.splitext(os.path.basename(path))[0]}"
                offset = 0.0
                pid = None
            info = incarnations.setdefault(inc, {
                "incarnation": inc,
                "pid": pid,
                "synthetic": anchor is None,
                "trails": [],
                "events": 0,
                "first_wall": None,
                "last_wall": None,
            })
            info["trails"].append(path)
            for e in rows:
                if not isinstance(e, dict):
                    continue
                if e.get("event") == "incarnation":
                    continue
                t = e.get("ts_mono")
                wall = (
                    round(t + offset, 6)
                    if isinstance(t, (int, float)) else None
                )
                row = dict(e, incarnation=inc)
                if wall is not None:
                    row["ts_wall"] = wall
                    if info["first_wall"] is None or wall < info["first_wall"]:
                        info["first_wall"] = wall
                    if info["last_wall"] is None or wall > info["last_wall"]:
                        info["last_wall"] = wall
                info["events"] += 1
                merged.append(row)
        merged.sort(key=lambda e: (
            e.get("ts_wall", 0.0), e.get("incarnation", ""),
            e.get("seq", 0),
        ))
        summary = _summarize(merged, incarnations)
    return merged, summary


def _summarize(merged: list[dict], incarnations: dict) -> dict:
    # restart chain: incarnations in start order, gap to predecessor =
    # how long the slot was dark between one process's last event and
    # the next process's first
    chain = []
    ordered = sorted(
        (i for i in incarnations.values() if i["first_wall"] is not None),
        key=lambda i: i["first_wall"],
    )
    prev = None
    for info in ordered:
        link = {
            "incarnation": info["incarnation"],
            "start_wall": info["first_wall"],
            "span_s": round(info["last_wall"] - info["first_wall"], 6),
            "events": info["events"],
        }
        if prev is not None:
            link["prev"] = prev["incarnation"]
            link["gap_s"] = round(
                info["first_wall"] - prev["last_wall"], 6
            )
        chain.append(link)
        prev = info

    # cross-incarnation trace links: a trace id observed from more than
    # one process (e.g. a request traced across a handoff)
    trace_incs: dict = {}
    for e in merged:
        tid = e.get("trace_id")
        if tid:
            trace_incs.setdefault(tid, set()).add(e["incarnation"])
    links = {
        tid: sorted(incs)
        for tid, incs in trace_incs.items() if len(incs) > 1
    }

    return {
        "incarnations": {
            inc: {k: v for k, v in info.items() if k != "trails"}
            | {"trails": list(info["trails"])}
            for inc, info in incarnations.items()
        },
        "chain": chain,
        "cross_incarnation_traces": links,
        "events": len(merged),
    }


def fleet_report(paths, out: str | None = None) -> dict:
    """The full report dict for ``paths`` (the ``--fleet`` entry point
    ``trace_report`` shares); writes the merged trail to ``out``
    when given."""
    from mosaic_tpu_torch.obs import export

    merged, summary = stitch(paths)
    if out:
        # the merged trail is already multi-incarnation — no header
        export.write_jsonl(merged, out, stamp_incarnation=False)
    return {
        "metric": "fleet_report",
        "trails": list(paths),
        "events": summary["events"],
        "incarnations": len(summary["incarnations"]),
        "chain": summary["chain"],
        "cross_incarnation_traces": summary["cross_incarnation_traces"],
        "detail": {"incarnations": summary["incarnations"]},
        "out": out,
    }


def render(report: dict, w) -> None:
    """Human-readable fleet summary (stderr side of the contract)."""
    w(f"fleet: {report['incarnations']} incarnation(s), "
      f"{report['events']} events from {len(report['trails'])} trail(s)\n")
    for link in report["chain"]:
        gap = (
            f"  (+{link['gap_s']:.3f}s after {link['prev']})"
            if "prev" in link else ""
        )
        w(f"  {link['incarnation']}: {link['events']} events over "
          f"{link['span_s']:.3f}s{gap}\n")
    n_links = len(report["cross_incarnation_traces"])
    if n_links:
        w(f"  {n_links} trace(s) span incarnations\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m mosaic_tpu_torch.tools.fleet_report")
    ap.add_argument("trails", nargs="+",
                    help="JSONL trails / recorder dumps to stitch")
    ap.add_argument("--out", default=None,
                    help="write the merged trail (JSONL) here")
    ap.add_argument("--trail", default=None,
                    help="export this run's own telemetry trail "
                         "(ops_stage.stitch) as JSONL")
    args = ap.parse_args(argv)

    from mosaic_tpu_torch import obs
    from mosaic_tpu_torch.runtime import telemetry

    with telemetry.capture() as events:
        report = fleet_report(args.trails, out=args.out)
    if args.trail:
        obs.write_jsonl(events, args.trail)
    render(report, sys.stderr.write)
    sys.stdout.write(json.dumps(report) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
