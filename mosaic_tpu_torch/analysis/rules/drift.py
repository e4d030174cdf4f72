"""Registry drift: code vs committed registry vs docs vs perf gate.

Port of ``mosaic_tpu/analysis/rules/drift.py`` over the port's own
surfaces. Four of them name the same things — the code (fault sites,
spans, telemetry stages, env knobs), the committed registry golden
(``mosaic_tpu_torch/tools/goldens/registry.json``), the docs
(TORCH_ARCHITECTURE.md's span taxonomy + knob/fault-site mentions in
README/docs), and the port's perf_gate golden's stage list
(``mosaic_tpu_torch/tools/goldens/perf_gate.json``, written on the
card). They drift apart one change at a time unless a machine reconciles
them; this rule is that machine.

Checks:

1. fresh AST scan == committed registry (else: regenerate + review);
2. every library span name appears in TORCH_ARCHITECTURE.md's span-taxonomy
   table, and every table row still exists in code (both directions);
3. every perf_gate golden stage is a registered stage/span/event name;
4. every ``MOSAIC_*`` env knob read in code is documented in
   README/docs (wildcard families by prefix);
5. every fault-injection site string is documented in README/docs.
"""

from __future__ import annotations

import json
import re

from ..engine import ProjectContext
from ..findings import Finding
from ..registry import rule
from ..project_registry import (
    SCAN_TARGETS, build_registry_from_modules, name_matches,
)

REGISTRY_GOLDEN = "mosaic_tpu_torch/tools/goldens/registry.json"
PERF_GOLDEN = "mosaic_tpu_torch/tools/goldens/perf_gate.json"
ARCHITECTURE = "docs/TORCH_ARCHITECTURE.md"
_UPDATE = "python -m mosaic_tpu_torch.tools.lint --update-registry"

_ROW_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|")


def fresh_registry(project: ProjectContext) -> dict:
    modules = [
        (f.rel, f.tree)
        for f in project.files
        if f.tree is not None and (
            f.rel in SCAN_TARGETS
            or any(f.rel.startswith(t + "/") for t in SCAN_TARGETS)
        )
    ]
    return build_registry_from_modules(modules)


def span_table_names(arch_text: str) -> list[str]:
    """First-cell names of TORCH_ARCHITECTURE.md's span-taxonomy table."""
    out: list[str] = []
    in_table = False
    for line in arch_text.splitlines():
        if re.match(r"^\|\s*span\s*\|", line):
            in_table = True
            continue
        if in_table:
            if not line.startswith("|"):
                break
            m = _ROW_RE.match(line)
            if m:
                out.append(m.group(1))
    return out


@rule("registry-drift", scope="project")
def registry_drift(project: ProjectContext) -> list[Finding]:
    """Fault sites, span names, telemetry stages, and MOSAIC_* knobs
    must agree across code, the committed registry, the docs, and the
    perf_gate golden."""
    out: list[Finding] = []
    reg = fresh_registry(project)

    # 1) committed registry is current
    committed_text = project.read_text(REGISTRY_GOLDEN)
    if committed_text is None:
        out.append(Finding(
            rule="registry-drift", path=REGISTRY_GOLDEN, line=0,
            message="committed registry missing",
            hint=f"run `{_UPDATE}` and commit",
        ))
        committed = None
    else:
        committed = json.loads(committed_text)
        for cat in (
            "fault_sites", "spans", "spans_tools", "events", "stages",
            "env_knobs",
        ):
            want, got = reg.get(cat, []), committed.get(cat, [])
            if want != got:
                added = sorted(set(want) - set(got))
                gone = sorted(set(got) - set(want))
                out.append(Finding(
                    rule="registry-drift", path=REGISTRY_GOLDEN, line=0,
                    message=(
                        f"registry category {cat!r} is stale "
                        f"(+{added} -{gone})"
                    ),
                    hint=f"run `{_UPDATE}`, review the diff, commit",
                ))

    # 2) span taxonomy: code <-> TORCH_ARCHITECTURE table, both ways
    arch = project.read_text(ARCHITECTURE) or ""
    table = span_table_names(arch)
    code_spans = reg["spans"]
    for name in code_spans:
        # a wildcard family (f-string span) is documented when any table
        # row falls under its prefix; an exact name needs its own row
        documented = (
            any(name_matches(n, [name]) for n in table)
            if name.endswith("*")
            else name in table
        )
        if not documented:
            out.append(Finding(
                rule="registry-drift", path=ARCHITECTURE, line=0,
                message=(
                    f"span {name!r} exists in code but not in the "
                    "span-taxonomy table"
                ),
                hint="add a row to TORCH_ARCHITECTURE.md's span table",
            ))
    for name in table:
        if not name_matches(name, code_spans):
            out.append(Finding(
                rule="registry-drift", path=ARCHITECTURE, line=0,
                message=(
                    f"span-taxonomy row {name!r} no longer exists in code"
                ),
                hint="delete the stale row (or restore the span)",
            ))

    # 3) perf_gate golden stages are registered names
    perf_text = project.read_text(PERF_GOLDEN)
    if perf_text is not None:
        gate = json.loads(perf_text)
        known = (
            reg["stages"] + reg["events"] + reg["spans"]
            + reg["spans_tools"]
        )
        for stage in sorted(gate.get("stages", {})):
            if not name_matches(stage, known):
                out.append(Finding(
                    rule="registry-drift", path=PERF_GOLDEN, line=0,
                    message=(
                        f"perf_gate stage {stage!r} is not a registered "
                        "telemetry stage/event/span"
                    ),
                    hint=(
                        "the gated stage was renamed or removed — "
                        "regenerate the perf_gate golden"
                    ),
                ))

    # 4) env knobs + 5) fault sites are documented
    docs = project.docs_text()
    for knob in reg["env_knobs"]:
        probe = knob[:-1] if knob.endswith("*") else knob
        if probe not in docs:
            out.append(Finding(
                rule="registry-drift", path="README.md", line=0,
                message=f"env knob {knob!r} read in code is undocumented",
                hint=(
                    "document it (TORCH_ARCHITECTURE.md's knob table "
                    "or README)"
                ),
            ))
    for site in reg["fault_sites"]:
        if site not in docs:
            out.append(Finding(
                rule="registry-drift", path="README.md", line=0,
                message=f"fault site {site!r} is undocumented",
                hint="mention it in TORCH_ARCHITECTURE.md's fault-site table",
            ))
    return out
