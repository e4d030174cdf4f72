"""Small shared AST helpers the rules lean on."""

from __future__ import annotations

import ast


def dotted(node: ast.AST) -> str:
    """``a.b.c`` for a Name/Attribute chain, "" for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    """The dotted callee of a Call ("torch.cuda.graph", "telemetry.record", …)."""
    return dotted(call.func)


def last_attr(call: ast.Call) -> str:
    """The final attribute/name of the callee ("record" for
    ``_telemetry.record(...)``)."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def fstring_prefix(node: ast.AST) -> str | None:
    """Leading constant text of an f-string, or None."""
    if not isinstance(node, ast.JoinedStr) or not node.values:
        return None
    head = node.values[0]
    if isinstance(head, ast.Constant) and isinstance(head.value, str):
        return head.value
    return None


def name_or_wildcard(node: ast.AST) -> str | None:
    """A string-valued AST argument as a registry name: constant strings
    verbatim, f-strings as ``<prefix>*`` (the dynamic family marker)."""
    s = const_str(node)
    if s is not None:
        return s
    p = fstring_prefix(node)
    if p:
        return p + "*"
    return None


def functions_by_name(tree: ast.AST) -> dict[str, list[ast.AST]]:
    """Every (async) function def in the module, any nesting level,
    keyed by simple name — the intra-module resolution map."""
    out: dict[str, list[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out
