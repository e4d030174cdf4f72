"""Unbounded caches pin device memory.

Every ``functools.lru_cache`` in the port keys on or closes over
device-resident state — CUDA tensors of an index, index systems, mesh
placements — so ``maxsize=None`` (or ``functools.cache``, its alias) is
a process-lifetime pin of card memory with no eviction and no
observability. The repo convention is bounded + clearable + counted:
see ``sql/join.py``'s ``join_cache_stats()`` / ``clear_join_caches()``
and ``parallel/dist_knn.py``'s ``knn_cache_stats()`` mirror.

(A bare ``@lru_cache`` or ``lru_cache()`` defaults to ``maxsize=128``
— bounded, allowed.)
"""

from __future__ import annotations

import ast

from ..astutil import call_name, dotted
from ..engine import FileContext
from ..findings import Finding
from ..registry import rule

_HINT = (
    "set a bound (and expose *_cache_stats()/clear_*_caches() helpers "
    "like sql/join.py), or justify with "
    "`# lint: unbounded-cache-ok (reason)`"
)


def _is_none(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


@rule("unbounded-cache")
def unbounded_cache(ctx: FileContext) -> list[Finding]:
    """No lru_cache(maxsize=None) / functools.cache in library code —
    an unbounded cache over device state pins card memory."""
    if not ctx.in_library:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        bad: str | None = None
        line = getattr(node, "lineno", 0)
        if isinstance(node, ast.Call):
            tail = call_name(node).split(".")[-1]
            if tail == "lru_cache":
                maxsize = node.args[0] if node.args else None
                for kw in node.keywords:
                    if kw.arg == "maxsize":
                        maxsize = kw.value
                if _is_none(maxsize):
                    bad = "lru_cache(maxsize=None) is unbounded"
            elif tail == "cache" and call_name(node) in (
                "functools.cache", "cache"
            ):
                bad = "functools.cache is unbounded"
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # bare @functools.cache (not a Call node)
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call) and dotted(dec) in (
                    "functools.cache", "cache"
                ):
                    bad = "bare @functools.cache is unbounded"
                    line = dec.lineno
        if bad:
            out.append(Finding(
                rule="unbounded-cache", path=ctx.rel, line=line,
                message=bad, hint=_HINT,
            ))
    return out
