"""mosaic-lint driver over the port's `mosaic_tpu_torch/analysis/`.

Port of the reference's ``tools/lint.py``: the same flags, the same JSON
last line, over the port's package, its tests (``tests/test_torch_*.py``)
and ``chip_smoke.py``, with the port's goldens
(``mosaic_tpu_torch/tools/goldens/lint_baseline.json`` and
``registry.json``).

Usage:
    python -m mosaic_tpu_torch.tools.lint                     # exit 0 clean
    python -m mosaic_tpu_torch.tools.lint --rule capture-purity   # one rule
    python -m mosaic_tpu_torch.tools.lint --list-rules        # the catalog
    python -m mosaic_tpu_torch.tools.lint --update-baseline   # grandfather
    python -m mosaic_tpu_torch.tools.lint --update-registry   # registry golden
    python -m mosaic_tpu_torch.tools.lint --json-only         # machine mode

The LAST stdout line is always one JSON object:
``{"tool": "mosaic-lint", "files": N, "rules_run": K, "findings": n,
"baselined": b, "suppressed": s, "stale_baseline": [...], "rules":
{rule: count}, "clean": bool}``. Exit 0 iff no active findings and no
stale baseline entries.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .. import analysis

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join(
    "mosaic_tpu_torch", "tools", "goldens", "lint_baseline.json"
)
DEFAULT_REGISTRY = os.path.join(
    "mosaic_tpu_torch", "tools", "goldens", "registry.json"
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--root", default=ROOT,
        help="repo root to analyze (default: this checkout)",
    )
    ap.add_argument(
        "--rule", action="append", default=None, metavar="NAME",
        help="run only this rule (repeatable)",
    )
    ap.add_argument(
        "--baseline", default=None, metavar="PATH",
        help=f"baseline file (default: <root>/{DEFAULT_BASELINE})",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="write current findings as the new baseline and exit 0",
    )
    ap.add_argument(
        "--update-registry", action="store_true",
        help=f"regenerate {DEFAULT_REGISTRY} from the AST scan",
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    ap.add_argument(
        "--json-only", action="store_true",
        help="suppress per-finding lines; print only the final JSON",
    )
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    if args.list_rules:
        for name, r in analysis.all_rules().items():
            print(f"{name:26s} [{r.scope:7s}] {r.doc}")
        print(json.dumps({
            "tool": "mosaic-lint", "rules": sorted(analysis.all_rules()),
        }))
        return 0

    if args.update_registry:
        reg = analysis.build_registry(root)
        path = os.path.join(root, DEFAULT_REGISTRY)
        reg["note"] = analysis.project_registry.REGISTRY_NOTE
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(reg, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(json.dumps({
            "tool": "mosaic-lint", "updated_registry": DEFAULT_REGISTRY,
            **{k: len(v) for k, v in reg.items() if isinstance(v, list)},
        }))
        return 0

    result = analysis.analyze(root, rule_names=args.rule)
    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)

    if args.update_baseline:
        counts = analysis.save_baseline(baseline_path, result.findings)
        print(json.dumps({
            "tool": "mosaic-lint",
            "updated_baseline": os.path.relpath(baseline_path, root),
            "entries": sum(counts.values()),
        }))
        return 0

    baseline = analysis.load_baseline(baseline_path)
    active, grandfathered, stale = analysis.split_baselined(
        result.findings, baseline
    )
    # a rule-filtered run only sees a slice of the findings, so unmatched
    # baseline entries are expected — never report them stale
    if args.rule:
        stale = []

    if not args.json_only:
        for f in active:
            print(f.render())
        if stale:
            for k in stale:
                print(f"baseline: stale entry (fixed? remove it): {k}")

    summary = {
        "tool": "mosaic-lint",
        "files": result.files,
        "rules_run": len(result.rules_run),
        "findings": len(active),
        "baselined": len(grandfathered),
        "suppressed": len(result.suppressed),
        "stale_baseline": stale,
        "rules": dict(sorted(_count(active).items())),
        "clean": not active and not stale,
    }
    print(json.dumps(summary))
    return 0 if summary["clean"] else 1


def _count(findings) -> dict:
    out: dict = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


if __name__ == "__main__":
    sys.exit(main())
