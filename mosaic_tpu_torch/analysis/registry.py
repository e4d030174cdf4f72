"""The typed rule registry.

A rule is a named, documented check function. ``scope="file"`` rules run
once per parsed module (``fn(FileContext) -> list[Finding]``);
``scope="project"`` rules run once over the whole tree
(``fn(ProjectContext) -> list[Finding]``) — that is where cross-file
invariants (registry drift) live.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    fn: Callable
    scope: str = "file"  # "file" | "project"
    severity: str = "error"


_RULES: dict[str, Rule] = {}


def rule(name: str, *, scope: str = "file", severity: str = "error"):
    """Register a check function under ``name`` (its docstring's first
    line becomes the catalog entry)."""
    if scope not in ("file", "project"):
        raise ValueError(f"scope must be file|project, got {scope!r}")

    def deco(fn: Callable) -> Callable:
        doc = (fn.__doc__ or "").strip().splitlines()
        _RULES[name] = Rule(
            name=name, doc=doc[0] if doc else "", fn=fn,
            scope=scope, severity=severity,
        )
        return fn

    return deco


def all_rules() -> dict[str, Rule]:
    """Registered rules by name (insertion-ordered)."""
    return dict(_RULES)


def get_rule(name: str) -> Rule:
    try:
        return _RULES[name]
    except KeyError:
        raise KeyError(
            f"unknown rule {name!r}; known: {sorted(_RULES)}"
        ) from None
