"""``except Exception`` discipline.

The runtime has a typed error taxonomy (`runtime/errors.py`) precisely
so failures stay classifiable — retryable vs capacity vs degraded. A
broad handler that swallows silently erases that information. The rule
accepts three outcomes: the handler re-raises (bare ``raise`` or a
typed conversion ``raise X(...) from e``), or it carries a
``# lint: broad-except-ok (reason)`` justification on the ``except``
line. Everything else is a finding.
"""

from __future__ import annotations

import ast

from ..engine import FileContext
from ..findings import Finding
from ..registry import rule


def _catches_exception(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if isinstance(t, ast.Name):
        return t.id == "Exception"
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, ast.Name) and e.id == "Exception" for e in t.elts
        )
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
    return False


@rule("broad-except")
def broad_except(ctx: FileContext) -> list[Finding]:
    """`except Exception` must re-raise, convert into the runtime error
    taxonomy, or carry an inline justification."""
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _catches_exception(node):
            continue
        if _reraises(node):
            continue
        out.append(Finding(
            rule="broad-except", path=ctx.rel, line=node.lineno,
            message="except Exception swallows without re-raising",
            hint=(
                "raise a runtime/errors.py type from it, or justify "
                "with `# lint: broad-except-ok (reason)`"
            ),
        ))
    return out
