"""Stall attribution report: where a window of wall time went.

    python -m mosaic_tpu_torch.tools.stall_report TRAIL.jsonl
    python -m mosaic_tpu_torch.tools.stall_report FRESH.jsonl --against BASE.jsonl
    python -m mosaic_tpu_torch.tools.stall_report T.jsonl --inject-slowdown 'span.stream.snapshot:10'

Port of ``tools/stall_report.py``, with its report, diff and exit codes.
Given a telemetry trail (a durable stream run, a serve loop, or a
flight-recorder dump), reconstruct the interval timeline
(``mosaic_tpu_torch/obs/timeline.py``), pick the attribution window (the
durable loop when present), and partition its wall time into the closed
stall-class set::

    {compile, transfer, queue_wait, host_callback, device, idle}

The partition is exact by construction (a priority boundary sweep:
every instant has ONE owner), so the classes sum to the measured wall;
``sum_ok`` checks the 5% bound anyway as an end-to-end tripwire.

When the trail carries both the durable loop and a single-batch rate
(``stream_stage.single_batch``), the report also decomposes the
sustained-vs-single loss: ``ideal_s`` is the wall the run would take at
the single-batch rate, and the loss (``wall - ideal``) is split into the
non-device classes plus ``device_excess``.

The human-readable report goes to stderr, the LAST stdout line is one
JSON object; ``--against OTHER`` diffs class shares; ``--out`` also
writes the JSON to a file. ``--inject-slowdown KEY:FACTOR`` scales the
``seconds`` of matching stage keys (fnmatch) before attribution — the
negative lane proving an injected stall surfaces in the right class.
Exit code 1 when the trail has no classified interval.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import sys

from mosaic_tpu_torch.obs import export, timeline


def inject_slowdown(events, spec: str) -> list[dict]:
    """Scale ``seconds`` of every event whose stage key fnmatches
    ``KEY`` by ``FACTOR``. The scaled interval is anchored at its
    COMPLETION stamp (``start_mono`` dropped, so the interval is
    re-derived as ``ts_mono - seconds``): the injected stall extends
    backward into the window, where attribution can see it, instead of
    overrunning the window's tail and getting clipped. Returns a new
    event list."""
    key_pat, factor_s = spec.rsplit(":", 1)
    factor = float(factor_s)
    out = []
    for e in events:
        key = timeline.event_key(e) if isinstance(e, dict) else None
        if (
            key is not None
            and fnmatch.fnmatchcase(key, key_pat)
            and isinstance(e.get("seconds"), (int, float))
        ):
            e = dict(e)
            e["seconds"] = round(float(e["seconds"]) * factor, 6)
            e.pop("start_mono", None)
        out.append(e)
    return out


def _find_stage(events, key: str) -> dict | None:
    for e in events:
        if isinstance(e, dict) and timeline.event_key(e) == key:
            return e
    return None


def build_report(events) -> dict | None:
    """The full stall report for one trail, or None when the trail has
    no usable window (no classified intervals at all)."""
    events = [e for e in events if isinstance(e, dict)]
    attr = timeline.attribute(events)
    if attr is None:
        return None
    wall = attr["wall_s"]
    classes = attr["classes"]
    loss_classes = {
        c: classes[c]["seconds"]
        for c in classes
        if c != "device"
    }
    report = {
        "metric": "stall_report",
        "window": attr["window"],
        "wall_s": wall,
        "classes": classes,
        "sum_s": attr["sum_s"],
        "sum_ok": abs(attr["sum_s"] - wall) <= 0.05 * max(wall, 1e-9),
        "segments": attr["segments"],
        "critical_path": attr["critical_path"],
        "top_stall": max(loss_classes, key=loss_classes.get),
    }

    # ---- sustained-vs-single decomposition (stream trails) ----------
    loop = _find_stage(events, "stream_stage.durable_loop")
    single = _find_stage(events, "stream_stage.single_batch")
    if loop is None:
        loop = _find_stage(events, "stream_stage.join_loop")
    if loop is not None and single is not None:
        single_rate = float(single.get("points_per_sec") or 0.0)
        sustained_rate = float(loop.get("points_per_sec") or 0.0)
        batch = int(loop.get("batch") or single.get("batch") or 0)
        n_batches = int(loop.get("n_batches") or loop.get("batches") or 0)
        resumed = int(loop.get("resumed_from") or 0)
        n_points = max(n_batches - resumed, 0) * batch
        if not n_points and sustained_rate:
            n_points = int(round(sustained_rate * wall))
        if single_rate > 0 and n_points > 0:
            ideal_s = n_points / single_rate
            loss = {
                "single_rate": round(single_rate, 1),
                "sustained_rate": round(sustained_rate, 1),
                "sustained_frac": round(
                    sustained_rate / single_rate, 4
                ),
                "n_points": n_points,
                "ideal_s": round(ideal_s, 6),
                "loss_s": round(wall - ideal_s, 6),
                "loss_classes": {
                    **{
                        c: round(s, 6)
                        for c, s in loss_classes.items()
                    },
                    "device_excess": round(
                        classes["device"]["seconds"] - ideal_s, 6
                    ),
                },
            }
            lc = loss["loss_classes"]
            loss["top_stall"] = max(lc, key=lc.get)
            report["loss"] = loss
            report["top_stall"] = loss["top_stall"]
    return report


def load_baseline(path: str) -> dict | None:
    """A baseline for ``--against``: either a raw trail (rebuilt into a
    report) or a committed ``stall_report`` artifact (used as-is), so
    comparisons work from a saved report without the
    original trail."""
    rows = export.read_trail(path)
    if len(rows) == 1 and rows[0].get("metric") == "stall_report":
        return rows[0]
    return build_report(rows)


def diff_reports(fresh: dict, base: dict) -> dict:
    """Per-class share/seconds deltas between two reports, plus the
    sustained-vs-single loss deltas when both sides carry one."""
    out = {}
    keys = set(fresh["classes"]) | set(base["classes"])
    for c in sorted(keys):
        f = fresh["classes"].get(c, {"seconds": 0.0, "share": 0.0})
        b = base["classes"].get(c, {"seconds": 0.0, "share": 0.0})
        out[c] = {
            "seconds": round(f["seconds"] - b["seconds"], 6),
            "share": round(f["share"] - b["share"], 4),
        }
    fl, bl = fresh.get("loss"), base.get("loss")
    if fl and bl:
        out["loss"] = {
            "sustained_frac": round(
                fl["sustained_frac"] - bl["sustained_frac"], 4
            ),
            "sustained_frac_ratio": (
                round(fl["sustained_frac"] / bl["sustained_frac"], 3)
                if bl["sustained_frac"] else None
            ),
            "device_excess": round(
                fl["loss_classes"]["device_excess"]
                - bl["loss_classes"]["device_excess"], 6
            ),
        }
    return out


def render(report: dict) -> str:
    lines = [
        f"window: {report['window']['source']}  "
        f"wall {report['wall_s']:.4f}s  "
        f"({report['segments']} owner segments)",
        f"{'class':<14} {'seconds':>10} {'share':>8}",
    ]
    for c, v in sorted(
        report["classes"].items(),
        key=lambda kv: kv[1]["seconds"],
        reverse=True,
    ):
        lines.append(
            f"{c:<14} {v['seconds']:>10.4f} {v['share']:>7.1%}"
        )
    lines.append(
        f"sum {report['sum_s']:.4f}s vs wall {report['wall_s']:.4f}s "
        f"-> {'OK' if report['sum_ok'] else 'MISMATCH'}"
    )
    loss = report.get("loss")
    if loss:
        lines.append(
            f"sustained {loss['sustained_rate']:,.0f} pts/s = "
            f"{loss['sustained_frac']:.2%} of single-batch "
            f"{loss['single_rate']:,.0f}; ideal {loss['ideal_s']:.4f}s,"
            f" lost {loss['loss_s']:.4f}s:"
        )
        for c, s in sorted(
            loss["loss_classes"].items(),
            key=lambda kv: kv[1],
            reverse=True,
        ):
            lines.append(f"  {c:<16} {s:>10.4f}s")
    lines.append(f"top stall class: {report['top_stall']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mosaic_tpu_torch.tools.stall_report")
    ap.add_argument("trail", help="JSONL trail or bench artifact")
    ap.add_argument(
        "--against", default=None,
        help="baseline to diff class shares (and loss decomposition) "
             "against: a trail, or a committed stall_report artifact",
    )
    ap.add_argument(
        "--out", default=None,
        help="also write the JSON report to this path",
    )
    ap.add_argument(
        "--inject-slowdown", default=None, metavar="KEY:FACTOR",
        help="scale seconds of matching stage keys before attribution "
             "(negative-lane self-test)",
    )
    args = ap.parse_args(argv)

    events = export.read_trail(args.trail)
    if args.inject_slowdown:
        events = inject_slowdown(events, args.inject_slowdown)
    report = build_report(events)
    if report is None:
        print(
            "no classified intervals in trail; nothing to attribute",
            file=sys.stderr,
        )
        print(json.dumps({"metric": "stall_report", "error": "empty"}))
        return 1

    if args.against:
        base = load_baseline(args.against)
        if base is not None:
            report["diff"] = diff_reports(report, base)
            report["against"] = args.against

    print(render(report), file=sys.stderr)
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
