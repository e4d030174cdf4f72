"""The hygiene floor, carried over from the reference's
``mosaic_tpu/analysis/rules/hygiene.py`` with the same semantics."""

from __future__ import annotations

import ast

from ..engine import FileContext
from ..findings import Finding
from ..registry import rule


@rule("syntax")
def syntax(ctx: FileContext) -> list[Finding]:
    """Every file parses — the engine reports this at parse time."""
    return []  # emitted by engine.analyze when ast.parse fails


@rule("whitespace")
def whitespace(ctx: FileContext) -> list[Finding]:
    """No trailing whitespace, no tab indentation."""
    out = []
    for i, line in enumerate(ctx.lines, 1):
        if line != line.rstrip():
            out.append(Finding(
                rule="whitespace", path=ctx.rel, line=i,
                message="trailing whitespace",
                hint="strip the line end",
            ))
        indent = line[: len(line) - len(line.lstrip())]
        if "\t" in indent:
            out.append(Finding(
                rule="whitespace", path=ctx.rel, line=i,
                message="tab indentation",
                hint="use 4 spaces",
            ))
    return out


def _used_names(tree: ast.AST) -> set[str]:
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
    return used


@rule("unused-import")
def unused_import(ctx: FileContext) -> list[Finding]:
    """Top-level imports must be used (`# noqa` on the line opts out)."""
    tree, lines = ctx.tree, ctx.lines
    used = _used_names(tree)
    in_all: set[str] = set()
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(getattr(t, "id", "") == "__all__" for t in node.targets)
            and isinstance(node.value, (ast.List, ast.Tuple))
        ):
            in_all |= {
                e.value for e in node.value.elts if isinstance(e, ast.Constant)
            }
    out = []
    for node in tree.body:
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue  # compiler directive, not a binding
        if "noqa" in lines[node.lineno - 1]:
            continue
        for alias in node.names:
            if alias.name == "*":
                continue
            bound = (alias.asname or alias.name).split(".")[0]
            if bound not in used and bound not in in_all:
                out.append(Finding(
                    rule="unused-import", path=ctx.rel, line=node.lineno,
                    message=f"unused import {bound!r}",
                    hint="remove it (or `# noqa` a deliberate re-export)",
                ))
    return out


@rule("bare-except")
def bare_except(ctx: FileContext) -> list[Finding]:
    """No bare `except:` — it swallows KeyboardInterrupt/SystemExit."""
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            out.append(Finding(
                rule="bare-except", path=ctx.rel, line=node.lineno,
                message="bare except",
                hint="catch Exception (and satisfy broad-except) instead",
            ))
    return out


@rule("print-in-lib")
def print_in_lib(ctx: FileContext) -> list[Finding]:
    """No print() in library code (tools/tests/bench may print)."""
    if not ctx.in_library:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "print"
        ):
            out.append(Finding(
                rule="print-in-lib", path=ctx.rel, line=node.lineno,
                message="print() in library code",
                hint="use runtime.telemetry.record or a logger",
            ))
    return out
