"""Performance regression gate: enforce the committed stage-time shape.

    python -m mosaic_tpu_torch.tools.perf_gate --trail STREAM.jsonl --trail SERVE.jsonl
    python -m mosaic_tpu_torch.tools.perf_gate --update --trail ... [--golden PATH]
    python -m mosaic_tpu_torch.tools.perf_gate --trail ... --inject-slowdown STAGE:10

Port of ``tools/perf_gate.py``, with its rule, golden format and exit
codes. Its default golden is the port's own,
``mosaic_tpu_torch/tools/goldens/perf_gate.json``, written by
``--update`` from the trails a ``chip_smoke.py`` run on the card keeps
(``--keep-trails DIR``); its ``note`` names the card and its power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.

**What is compared.** For every stage key (``trace_report.stage_key``:
``stream_stage.join_loop``, ``serve_stage.dispatch``, ...) the gate
computes the stage's *odds* — its total seconds over the total of every
OTHER stage in the same trail. Each ``--trail`` is its own odds pool:
one run's wall time cannot dilute another's odds; a stage that appears
in several trails gates on its worst pool. Odds are invariant under
uniform machine speed, but a regression in ONE stage moves its odds by
the regression factor — so the tolerance can be modest (default 3x)
while a 10x single-stage slowdown still fails (``--inject-slowdown``
proves it).

**Gate rule** per golden stage with recorded odds g: fresh odds must
satisfy ``odds <= g * tolerance + odds_floor``; a golden stage marked
``"require": true`` that is absent from the fresh trails fails.
Optional per-stage ``"max_seconds"`` adds an absolute ceiling.

The last stdout line is one JSON object; exit 0 = green, 1 = red, 2 =
an injected stage or a stage prefix that matches nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEFAULT_GOLDEN = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "goldens", "perf_gate.json"
)
DEFAULT_TOLERANCE = 3.0
DEFAULT_ODDS_FLOOR = 0.02
#: stage keys the gate ignores — spans double-count their timed events
SKIP_PREFIXES = ("span.",)


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``"no card"`` where it does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "no card"
    return out[0].strip() if out else "no card"


def stage_odds(events) -> dict:
    """``{stage_key: {"seconds", "count", "odds"}}`` over ONE trail's
    events (one odds pool); odds = seconds / (total - seconds)."""
    from mosaic_tpu_torch.tools.trace_report import stage_breakdown

    stages = {
        k: v
        for k, v in stage_breakdown(events).items()
        if not k.startswith(SKIP_PREFIXES)
    }
    total = sum(v["total_s"] for v in stages.values())
    out = {}
    for key, v in stages.items():
        rest = max(total - v["total_s"], 1e-9 * max(total, 1e-9))
        out[key] = {
            "seconds": v["total_s"],
            "count": v["count"],
            "odds": round(v["total_s"] / rest, 6),
        }
    return out


def apply_slowdown(pool: dict, stage: str, factor: float) -> dict:
    """Scale one stage's seconds within its pool and recompute every
    odds in that pool (what a real single-stage regression does)."""
    scaled = {
        k: dict(v, seconds=v["seconds"] * (factor if k == stage else 1.0))
        for k, v in pool.items()
    }
    total = sum(v["seconds"] for v in scaled.values())
    for v in scaled.values():
        rest = max(total - v["seconds"], 1e-9 * max(total, 1e-9))
        v["odds"] = round(v["seconds"] / rest, 6)
    return scaled


def merge_pools(pools) -> dict:
    """Union of per-trail pools: seconds/count sum across trails, odds
    gate on the worst (largest) pool — a stage must be healthy in every
    bench it appears in."""
    out: dict = {}
    for pool in pools:
        for k, v in pool.items():
            cur = out.get(k)
            if cur is None:
                out[k] = dict(v)
            else:
                cur["seconds"] = round(cur["seconds"] + v["seconds"], 6)
                cur["count"] += v["count"]
                cur["odds"] = max(cur["odds"], v["odds"])
    return out


def evaluate(
    fresh: dict, golden: dict
) -> tuple[bool, dict]:
    """Apply the gate rule; returns (green, per-stage verdicts)."""
    tol = float(golden.get("tolerance", DEFAULT_TOLERANCE))
    floor = float(golden.get("odds_floor", DEFAULT_ODDS_FLOOR))
    verdicts = {}
    green = True
    for key, g in sorted(golden.get("stages", {}).items()):
        f = fresh.get(key)
        if f is None:
            ok = not g.get("require", False)
            verdicts[key] = {
                "status": "missing" if ok else "MISSING_REQUIRED",
                "ok": ok,
            }
            green &= ok
            continue
        limit = float(g["odds"]) * tol + floor
        ok = f["odds"] <= limit
        v = {
            "status": "ok" if ok else "SLOW",
            "ok": ok,
            "odds": f["odds"],
            "golden_odds": g["odds"],
            "limit": round(limit, 6),
            "seconds": f["seconds"],
        }
        max_s = g.get("max_seconds")
        if max_s is not None and f["seconds"] > float(max_s):
            v.update(status="OVER_ABSOLUTE", ok=False)
            ok = False
        verdicts[key] = v
        green &= ok
    return green, verdicts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mosaic_tpu_torch.tools.perf_gate")
    ap.add_argument("--trail", action="append", required=True,
                    help="trail file (repeatable; each trail is its "
                    "own odds pool)")
    ap.add_argument("--golden", default=DEFAULT_GOLDEN)
    ap.add_argument("--update", action="store_true",
                    help="rewrite the golden from these trails")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="override the golden's odds tolerance")
    ap.add_argument("--inject-slowdown", default=None,
                    metavar="STAGE:FACTOR",
                    help="test knob: scale one fresh stage's seconds "
                    "(the negative lane proves the gate turns red)")
    ap.add_argument("--stages-prefix", action="append", default=None,
                    metavar="PREFIX",
                    help="gate only golden stages under these key "
                    "prefixes (repeatable) — a job that produces one "
                    "lane's trail gates its own pool without every "
                    "other trail on hand")
    args = ap.parse_args(argv)

    from mosaic_tpu_torch.obs import export

    pools = [stage_odds(export.read_trail(p)) for p in args.trail]

    if args.inject_slowdown:
        stage, factor = args.inject_slowdown.rsplit(":", 1)
        if not any(stage in pool for pool in pools):
            sys.stderr.write(f"inject-slowdown: no stage {stage!r}\n")
            return 2
        pools = [
            apply_slowdown(pool, stage, float(factor))
            if stage in pool else pool
            for pool in pools
        ]
    fresh = merge_pools(pools)

    if args.update:
        golden = {
            "tolerance": args.tolerance or DEFAULT_TOLERANCE,
            "odds_floor": DEFAULT_ODDS_FLOOR,
            "note": (
                "stage odds (seconds vs all other stages) on "
                f"{card_name()}; regenerate: python -m "
                "mosaic_tpu_torch.tools.perf_gate --update --trail ... "
                "(commit the result)"
            ),
            "stages": {
                k: {
                    "odds": v["odds"],
                    "seconds": round(v["seconds"], 4),
                    "require": True,
                }
                for k, v in sorted(fresh.items())
            },
        }
        os.makedirs(os.path.dirname(args.golden), exist_ok=True)
        with open(args.golden, "w") as f:
            json.dump(golden, f, indent=2, sort_keys=True)
            f.write("\n")
        sys.stderr.write(
            f"wrote {args.golden} ({len(golden['stages'])} stages)\n"
        )
        sys.stdout.write(json.dumps(
            {"metric": "perf_gate", "updated": args.golden,
             "stages": len(golden["stages"])}
        ) + "\n")
        return 0

    with open(args.golden) as f:
        golden = json.load(f)
    if args.tolerance is not None:
        golden["tolerance"] = args.tolerance
    if args.stages_prefix:
        pref = tuple(args.stages_prefix)
        golden["stages"] = {
            k: v for k, v in golden["stages"].items()
            if k.startswith(pref)
        }
        if not golden["stages"]:
            sys.stderr.write(
                f"stages-prefix {pref} matches no golden stage\n"
            )
            return 2
    green, verdicts = evaluate(fresh, golden)

    for key, v in sorted(verdicts.items()):
        mark = "ok " if v["ok"] else "RED"
        extra = (
            f" odds {v['odds']:.4f} vs limit {v['limit']:.4f}"
            if "odds" in v else ""
        )
        sys.stderr.write(f"  [{mark}] {key}: {v['status']}{extra}\n")
    sys.stderr.write(
        f"perf gate: {'GREEN' if green else 'RED'} "
        f"({len(verdicts)} gated stages, "
        f"tolerance {golden.get('tolerance', DEFAULT_TOLERANCE)}x)\n"
    )
    sys.stdout.write(json.dumps({
        "metric": "perf_gate",
        "pass": green,
        "golden": args.golden,
        "stages": verdicts,
    }) + "\n")
    return 0 if green else 1


if __name__ == "__main__":
    sys.exit(main())
