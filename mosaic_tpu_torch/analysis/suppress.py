"""Inline suppression grammar: ``# lint: <rule>-ok (reason)``.

Formalizes the ad-hoc justification comments the codebase already
carries (``stream.py``'s "the loop's only host pull", the
``# noqa: BLE001 — ...`` annotations): a suppression names exactly ONE
rule, lives on the line the finding anchors to, and MUST give a reason —
an empty reason is itself a finding (rule ``suppression``), because an
unexplained opt-out is how invariants rot back into tribal knowledge.
"""

from __future__ import annotations

import re

from .findings import Finding

#: one comment, one rule: ``# lint: broad-except-ok (probe is best-effort)``
_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*(?P<rule>[a-z0-9][a-z0-9_-]*)-ok\s*"
    r"(?:\((?P<reason>[^)]*)\))?"
)


def parse_suppressions(
    rel_path: str, lines: list[str], known_rules: set[str]
) -> tuple[dict[int, set[str]], list[Finding]]:
    """``(line -> suppressed rule ids, malformed-suppression findings)``.

    Malformed: missing/empty reason, or a rule id the registry does not
    know (a typo'd suppression silently suppresses nothing — surface it).
    """
    by_line: dict[int, set[str]] = {}
    bad: list[Finding] = []
    for i, line in enumerate(lines, 1):
        if "lint:" not in line:
            continue
        for m in _SUPPRESS_RE.finditer(line):
            rid = m.group("rule")
            reason = (m.group("reason") or "").strip()
            if rid not in known_rules:
                bad.append(Finding(
                    rule="suppression", path=rel_path, line=i,
                    message=f"suppression names unknown rule {rid!r}",
                    hint=(
                        "use a rule id from `python -m "
                        "mosaic_tpu_torch.tools.lint --list-rules`"
                    ),
                ))
                continue
            if not reason:
                bad.append(Finding(
                    rule="suppression", path=rel_path, line=i,
                    message=(
                        f"suppression for {rid!r} has no reason — "
                        "the grammar is `# lint: <rule>-ok (reason)`"
                    ),
                    hint="say WHY the rule does not apply here",
                ))
                continue
            by_line.setdefault(i, set()).add(rid)
    return by_line, bad
