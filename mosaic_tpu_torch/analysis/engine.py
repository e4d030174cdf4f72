"""Parse-once analysis engine: collect files, run rules, apply
suppressions. Baseline filtering is the lint tool's job (`baseline.py`) —
the engine reports everything it sees.

Port of ``mosaic_tpu/analysis/engine.py``: the default targets are the
port's package, its tests (``tests/test_torch_*.py``) and
``chip_smoke.py``; the library is ``mosaic_tpu_torch/`` less its
``tools/`` (the port's tools live inside the package)."""

from __future__ import annotations

import ast
import dataclasses
import glob
import os

from .findings import Finding
from .registry import Rule, all_rules
from .suppress import parse_suppressions

#: what the port lints, relative to the root (a target may be a glob)
DEFAULT_TARGETS = (
    "mosaic_tpu_torch", "tests/test_torch_*.py", "chip_smoke.py",
)

#: the port's library package, and its tools inside it
LIBRARY = "mosaic_tpu_torch/"
TOOLS = "mosaic_tpu_torch/tools/"


def is_lib(rel: str) -> bool:
    """Is repo-relative ``rel`` library code of the port? The package
    less its tools: ``mosaic_tpu_torch/`` (never the reference's
    ``mosaic_tpu/``), not ``mosaic_tpu_torch/tools/``."""
    return rel.startswith(LIBRARY) and not rel.startswith(TOOLS)


@dataclasses.dataclass
class FileContext:
    """One parsed module, shared by every file-scoped rule."""

    path: str        # absolute
    rel: str         # repo-relative POSIX — what findings carry
    src: str
    lines: list[str]
    tree: ast.AST | None  # None when the file does not parse

    @property
    def in_library(self) -> bool:
        return is_lib(self.rel)

    @property
    def in_tests(self) -> bool:
        return self.rel.startswith("tests/")


@dataclasses.dataclass
class ProjectContext:
    """The whole analyzed tree plus the docs/goldens project rules
    cross-check against."""

    root: str
    files: list[FileContext]

    def file(self, rel: str) -> FileContext | None:
        for f in self.files:
            if f.rel == rel:
                return f
        return None

    def read_text(self, rel: str) -> str | None:
        p = os.path.join(self.root, rel)
        if not os.path.isfile(p):
            return None
        with open(p, encoding="utf-8") as fh:
            return fh.read()

    def docs_text(self) -> str:
        """README + docs/*.md (``docs/TORCH_ARCHITECTURE.md`` among
        them) concatenated — the "is it documented?" corpus for registry
        cross-checks."""
        chunks = []
        for rel in ("README.md",):
            t = self.read_text(rel)
            if t:
                chunks.append(t)
        docs_dir = os.path.join(self.root, "docs")
        if os.path.isdir(docs_dir):
            for name in sorted(os.listdir(docs_dir)):
                if name.endswith(".md"):
                    t = self.read_text(os.path.join("docs", name))
                    if t:
                        chunks.append(t)
        return "\n".join(chunks)


@dataclasses.dataclass
class AnalysisResult:
    findings: list[Finding]     # active (not suppressed)
    suppressed: list[Finding]   # silenced by an inline comment
    files: int
    rules_run: list[str]

    def by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


def _collect_files(root: str, targets) -> list[str]:
    out = []
    for t in targets:
        p = os.path.join(root, t)
        if any(c in t for c in "*?["):
            out.extend(q for q in glob.glob(p) if q.endswith(".py"))
            continue
        if os.path.isfile(p):
            out.append(p)
            continue
        for base, dirs, files in os.walk(p):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(base, f))
    return sorted(set(out))


def analyze(
    root: str,
    targets=DEFAULT_TARGETS,
    rule_names: list[str] | None = None,
) -> AnalysisResult:
    """Run the selected rules (default: all) over ``targets`` under
    ``root``; returns active + suppressed findings, never raises on
    broken source (a parse failure is a ``syntax`` finding)."""
    rules = all_rules()
    selected: list[Rule] = [
        r for n, r in rules.items()
        if rule_names is None or n in rule_names
    ]
    if rule_names is not None:
        unknown = set(rule_names) - set(rules)
        if unknown:
            raise KeyError(f"unknown rule(s): {sorted(unknown)}")
    known = set(rules)

    contexts: list[FileContext] = []
    findings: list[Finding] = []
    run_syntax = rule_names is None or "syntax" in rule_names
    for path in _collect_files(root, targets):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            tree = None
            if run_syntax:
                findings.append(Finding(
                    rule="syntax", path=rel, line=int(e.lineno or 0),
                    message=f"does not parse: {e.msg}",
                    hint="fix the syntax error",
                ))
        contexts.append(FileContext(
            path=path, rel=rel, src=src,
            lines=src.splitlines(), tree=tree,
        ))

    project = ProjectContext(root=root, files=contexts)
    for r in selected:
        if r.name == "syntax":
            continue  # handled at parse time above
        if r.scope == "file":
            for ctx in contexts:
                if ctx.tree is not None:
                    findings.extend(r.fn(ctx))
        else:
            findings.extend(r.fn(project))

    # inline suppressions: the comment must sit on the finding's line
    suppressions: dict[str, dict[int, set[str]]] = {}
    for ctx in contexts:
        by_line, bad = parse_suppressions(ctx.rel, ctx.lines, known)
        suppressions[ctx.rel] = by_line
        if rule_names is None or "suppression" in rule_names:
            findings.extend(bad)

    active: list[Finding] = []
    silenced: list[Finding] = []
    for f in findings:
        if f.rule in suppressions.get(f.path, {}).get(f.line, set()):
            silenced.append(f)
        else:
            active.append(f)
    active.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return AnalysisResult(
        findings=active, suppressed=silenced,
        files=len(contexts), rules_run=[r.name for r in selected],
    )
