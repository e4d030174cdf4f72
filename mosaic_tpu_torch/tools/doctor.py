"""Self-diagnosis CLI: known failure signatures over saved evidence.

    python -m mosaic_tpu_torch.tools.doctor RUN.json TRAIL.jsonl ... [--trail OWN.jsonl]

Port of ``tools/doctor.py``, with its five checks, input kinds, report
and exit codes. Point it at any mix of bench artifacts (one JSON object
with ``detail``), JSONL trails / flight-recorder dumps, metrics
snapshots and ops-server ``GET /`` documents:

- **cold_compiles** — the zero-compile contract: every compile-after-
  warmup counter (``cold_compiles``, ``cold_compiles_after_swap``,
  ``relaunch_cold_compiles``, ``warm_backend_compiles``,
  ``relaunch_backend_compiles_serving``) must be 0, and a trail must
  contain no ``serve_compile`` event;
- **snapshot_overlap** — any ``snapshot_overlap_fraction`` below 0.8
  means durable-stream snapshots stopped hiding behind compute;
- **shed_imbalance** — from TRAILS and METRIC SNAPSHOTS only (bench
  A/B artifacts shed on purpose): one tenant holding ≥ 90% of
  ``router_shed`` volume (≥ 50 sheds) while others admit;
- **burn_rate** — any ``slo_violation`` event in a trail, breached SLO
  in an artifact's ``detail.slo``, or breached entry in an SLO
  snapshot;
- **cache_thrash** — ``dispatch_cache_stats`` events where a bounded
  cache sits full with misses outrunning hits 2:1, or an eviction
  counter past 100.

Every check reports ``green`` or ``red`` with its findings; ``status``
is red when any check is. The LAST stdout line is one JSON object; exit
code 1 on red. The scan and checks run under timed ``ops_stage``
telemetry (``ops_stage.scan``, ``ops_stage.checks``), exportable with
``--trail``.
"""

from __future__ import annotations

import argparse
import json
import sys

#: artifact detail keys whose committed value must be ZERO — each one
#: counts a compile that happened after the relevant warmup/freeze
ZERO_COMPILE_KEYS = frozenset({
    "cold_compiles",
    "cold_compiles_after_swap",
    "relaunch_cold_compiles",
    "warm_backend_compiles",
    "relaunch_backend_compiles_serving",
})

#: minimum acceptable snapshot_overlap_fraction (below this, durable-
#: stream snapshots serialize behind compute)
OVERLAP_MIN = 0.8

#: shed_imbalance thresholds: one tenant with >= this share of >= this
#: many sheds, observed in a TRAIL or metrics snapshot
IMBALANCE_SHARE = 0.9
IMBALANCE_MIN_SHEDS = 50

#: cache_thrash thresholds
THRASH_MISS_RATIO = 2.0
THRASH_EVICTIONS = 100


def classify(path: str) -> tuple[str, object]:
    """``(kind, payload)`` for one input file: ``"trail"`` (list of
    event dicts — JSONL trails and recorder dumps), ``"artifact"``
    (bench JSON with ``detail``), ``"metrics"`` (a registry snapshot),
    ``"ops"`` (an ops-server ``GET /`` document), or ``"opaque"``."""
    with open(path) as f:
        text = f.read()
    try:
        # whole-file parse first: pretty-printed artifacts span lines
        rows = [json.loads(text)]
    except ValueError:
        rows = [
            json.loads(line)
            for line in text.splitlines() if line.strip()
        ]
    if not rows:
        return "opaque", None
    if len(rows) > 1:
        return "trail", rows
    doc = rows[0]
    if not isinstance(doc, dict):
        return "opaque", doc
    if "detail" in doc:
        return "artifact", doc
    if "metrics" in doc and ("health" in doc or "slo" in doc):
        return "ops", doc
    if doc and all(
        isinstance(v, dict) and "kind" in v and "series" in v
        for v in doc.values()
    ):
        return "metrics", doc
    return "opaque", doc


def _walk(obj, path=""):
    """Yield ``(dotted_path, key, value)`` for every dict key at any
    depth (lists descend with ``[i]`` segments)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{path}.{k}" if path else str(k)
            yield p, k, v
            yield from _walk(v, p)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]")


def check_cold_compiles(inputs) -> dict:
    findings = []
    for src, kind, payload in inputs:
        if kind == "artifact":
            for p, k, v in _walk(payload.get("detail")):
                if k in ZERO_COMPILE_KEYS and isinstance(v, (int, float)):
                    if v != 0:
                        findings.append({
                            "source": src, "where": p, "count": v,
                            "why": "compile after warmup/freeze",
                        })
        elif kind == "trail":
            n = sum(
                1 for e in payload
                if isinstance(e, dict) and e.get("event") == "serve_compile"
            )
            if n:
                findings.append({
                    "source": src, "where": "serve_compile events",
                    "count": n, "why": "cold compile on the serve path",
                })
    return _verdict("cold_compiles", findings)


def check_snapshot_overlap(inputs) -> dict:
    findings = []
    for src, kind, payload in inputs:
        if kind != "artifact":
            continue
        for p, k, v in _walk(payload.get("detail")):
            if k == "snapshot_overlap_fraction" and isinstance(
                v, (int, float)
            ) and v < OVERLAP_MIN:
                findings.append({
                    "source": src, "where": p,
                    "overlap": v, "min": OVERLAP_MIN,
                    "why": "snapshots no longer hide behind compute",
                })
    return _verdict("snapshot_overlap", findings)


def check_shed_imbalance(inputs) -> dict:
    findings = []
    for src, kind, payload in inputs:
        sheds: dict[str, float] = {}
        if kind == "trail":
            for e in payload:
                if isinstance(e, dict) and e.get("event") == "router_shed":
                    t = str(e.get("tenant", ""))
                    sheds[t] = sheds.get(t, 0) + 1
        elif kind in ("metrics", "ops"):
            snap = payload["metrics"] if kind == "ops" else payload
            m = snap.get("serve.router_shed")
            for s in (m or {}).get("series", []):
                t = s.get("labels", {}).get("tenant", "")
                sheds[t] = sheds.get(t, 0) + float(s.get("value", 0))
        else:
            continue  # bench A/B artifacts shed on purpose — excluded
        total = sum(sheds.values())
        if total < IMBALANCE_MIN_SHEDS or len(sheds) < 2:
            continue
        top_tenant, top = max(sheds.items(), key=lambda kv: kv[1])
        if top / total >= IMBALANCE_SHARE:
            findings.append({
                "source": src, "tenant": top_tenant,
                "sheds": top, "share": round(top / total, 4),
                "why": "one tenant holds nearly all shed volume",
            })
    return _verdict("shed_imbalance", findings)


def check_burn_rate(inputs) -> dict:
    findings = []
    for src, kind, payload in inputs:
        if kind == "trail":
            for e in payload:
                if isinstance(e, dict) and e.get("event") == "slo_violation":
                    findings.append({
                        "source": src, "slo": e.get("slo"),
                        "burn_rate": e.get("burn_rate"),
                        "window_s": e.get("window_s"),
                        "why": "burn-rate breach recorded in trail",
                    })
        elif kind == "artifact":
            slo = (payload.get("detail") or {}).get("slo") or {}
            for name in slo.get("breached", []):
                findings.append({
                    "source": src, "slo": name,
                    "why": "bench --slo lane verdict: breached",
                })
        elif kind == "ops":
            slos = (payload.get("slo") or {}).get("slos", {})
            for name, s in slos.items():
                if s.get("breached"):
                    findings.append({
                        "source": src, "slo": name,
                        "burn_rate": s.get("burn_short"),
                        "why": "live SLO currently breached",
                    })
    return _verdict("burn_rate", findings)


def check_cache_thrash(inputs) -> dict:
    findings = []
    for src, kind, payload in inputs:
        if kind == "trail":
            # last dispatch_cache_stats event wins — stats are cumulative
            last = None
            for e in payload:
                if isinstance(e, dict) and (
                    e.get("event") == "dispatch_cache_stats"
                ):
                    last = e
            if last is None:
                continue
            for name, st in last.items():
                if not isinstance(st, dict) or "maxsize" not in st:
                    continue
                maxsize = st.get("maxsize") or 0
                hits, misses = st.get("hits", 0), st.get("misses", 0)
                if (
                    maxsize > 0
                    and st.get("currsize", 0) >= maxsize
                    and misses > THRASH_MISS_RATIO * max(hits, 1)
                ):
                    findings.append({
                        "source": src, "cache": name,
                        "hits": hits, "misses": misses,
                        "why": "bounded cache full with misses "
                               "outrunning hits — working set too big",
                    })
        elif kind in ("metrics", "ops"):
            snap = payload["metrics"] if kind == "ops" else payload
            m = snap.get("dispatch.core_cache_evictions")
            total = sum(
                float(s.get("value", 0))
                for s in (m or {}).get("series", [])
            )
            if total >= THRASH_EVICTIONS:
                findings.append({
                    "source": src, "evictions": total,
                    "why": "core cache churning residents",
                })
    return _verdict("cache_thrash", findings)


def _verdict(check: str, findings: list) -> dict:
    return {
        "check": check,
        "status": "red" if findings else "green",
        "findings": findings,
    }


CHECKS = (
    check_cold_compiles,
    check_snapshot_overlap,
    check_shed_imbalance,
    check_burn_rate,
    check_cache_thrash,
)


def diagnose(paths) -> dict:
    """Scan ``paths``, run every signature check, return the report."""
    from mosaic_tpu_torch.runtime import telemetry

    inputs, skipped = [], []
    with telemetry.timed("ops_stage", stage="scan", files=len(paths)):
        for path in paths:
            try:
                kind, payload = classify(path)
            except (OSError, ValueError) as e:
                skipped.append({"path": path, "error": repr(e)[:200]})
                continue
            if kind == "opaque":
                skipped.append({"path": path, "error": "unrecognized"})
            else:
                inputs.append((path, kind, payload))
    with telemetry.timed("ops_stage", stage="checks", inputs=len(inputs)):
        results = [check(inputs) for check in CHECKS]
    red = [r["check"] for r in results if r["status"] == "red"]
    return {
        "metric": "doctor",
        "status": "red" if red else "green",
        "red_checks": red,
        "inputs": {
            "scanned": len(inputs),
            "by_kind": _count_kinds(inputs),
            "skipped": skipped,
        },
        "checks": results,
    }


def _count_kinds(inputs) -> dict:
    out: dict[str, int] = {}
    for _, kind, _ in inputs:
        out[kind] = out.get(kind, 0) + 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mosaic_tpu_torch.tools.doctor")
    ap.add_argument("paths", nargs="+",
                    help="bench artifacts (.json), JSONL trails / "
                         "recorder dumps, metrics or ops snapshots")
    ap.add_argument("--trail", default=None,
                    help="export the doctor's own telemetry trail "
                         "(ops_stage.scan / ops_stage.checks) as JSONL")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report here")
    args = ap.parse_args(argv)

    from mosaic_tpu_torch import obs
    from mosaic_tpu_torch.runtime import telemetry

    with telemetry.capture() as events:
        report = diagnose(args.paths)
    if args.trail:
        obs.write_jsonl(events, args.trail)

    w = sys.stderr.write
    w(f"doctor: {report['status'].upper()} over "
      f"{report['inputs']['scanned']} input(s) "
      f"{report['inputs']['by_kind']}\n")
    for r in report["checks"]:
        mark = "OK " if r["status"] == "green" else "RED"
        w(f"  [{mark}] {r['check']}: {len(r['findings'])} finding(s)\n")
        for f_ in r["findings"]:
            w(f"        {json.dumps(f_)}\n")
    for s in report["inputs"]["skipped"]:
        w(f"  (skipped {s['path']}: {s['error']})\n")

    line = json.dumps(report)
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if report["status"] == "red" else 0


if __name__ == "__main__":
    sys.exit(main())
