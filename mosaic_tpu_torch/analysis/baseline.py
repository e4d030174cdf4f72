"""Committed baseline for grandfathered findings.

Policy (docs/TORCH_ARCHITECTURE.md "Static analysis"): the baseline
exists so a NEW rule can land enforced without blocking on fixing every
historic finding in the same change — but every entry is debt with a
visible ledger.
Keys are ``rule::path::message`` (line-independent, so unrelated edits
cannot resurface an entry) with a count, so fixing one of N identical
findings in a file shrinks the allowance instead of hiding the rest.
An entry that stops matching anything is reported as stale by the
lint tool — baselines only ever shrink.
"""

from __future__ import annotations

import json

from .findings import Finding

BASELINE_NOTE = (
    "grandfathered lint findings — regenerate with "
    "`python -m mosaic_tpu_torch.tools.lint --update-baseline`; policy: "
    "shrink-only, "
    "new code never baselines"
)


def load_baseline(path: str) -> dict[str, int]:
    """``finding key -> allowed count``; missing file = empty baseline."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return {}
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def save_baseline(path: str, findings: list[Finding]) -> dict[str, int]:
    """Write the current findings as the new baseline; returns the keys."""
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {"note": BASELINE_NOTE, "findings": dict(sorted(counts.items()))},
            fh, indent=2, sort_keys=False,
        )
        fh.write("\n")
    return counts


def split_baselined(
    findings: list[Finding], baseline: dict[str, int]
) -> tuple[list[Finding], list[Finding], list[str]]:
    """``(active, baselined, stale_keys)`` — consume the per-key counts
    in order; overflow beyond an entry's count stays active."""
    budget = dict(baseline)
    active: list[Finding] = []
    grandfathered: list[Finding] = []
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            grandfathered.append(f)
        else:
            active.append(f)
    stale = sorted(k for k, v in budget.items() if v > 0)
    return active, grandfathered, stale
