"""Cross-thread context adoption at every ``threading.Thread`` launch.

Telemetry sinks, trace context, and fault plans are all thread-local by
design (`runtime/telemetry.py`, `obs/trace.py`, `runtime/faults.py`) —
a worker thread that forgets to adopt them silently drops events out of
capture scopes, orphans spans from their trace, and makes injected
faults invisible. Every launch site (watchdog worker, serve batcher,
stream prefetch, load generators) has to get this right; the rule makes
the trio mandatory at the launch site or an explicit, justified
exception.

The check resolves ``target=`` to an in-module function and walks the
module-local call graph beneath it (the serve batcher adopts in
``_process``, two hops below its thread target), looking for
``adopt_sinks`` + (``adopt_context`` | ``adopt_trace``) +
``adopt_plans``.
"""

from __future__ import annotations

import ast

from ..astutil import call_name, functions_by_name, last_attr
from ..engine import FileContext
from ..findings import Finding
from ..registry import rule

_CONTEXT = ("adopt_context", "adopt_trace")
_REQUIRED = ("adopt_sinks", "CONTEXT", "adopt_plans")


def _adoptions_under(fn: ast.AST, by_name, max_depth: int = 5) -> set[str]:
    """Adoption calls reachable from ``fn`` through module-local calls
    (resolved by simple name, methods included)."""
    found: set[str] = set()
    seen: set[int] = set()
    frontier = [fn]
    for _ in range(max_depth):
        nxt: list[ast.AST] = []
        for f in frontier:
            if id(f) in seen:
                continue
            seen.add(id(f))
            for node in ast.walk(f):
                if not isinstance(node, ast.Call):
                    continue
                tail = last_attr(node)
                if tail in ("adopt_sinks", "adopt_plans") or tail in _CONTEXT:
                    found.add(tail)
                for target in by_name.get(tail, []):
                    if id(target) not in seen:
                        nxt.append(target)
        frontier = nxt
        if not frontier:
            break
    return found


@rule("thread-context-adoption")
def thread_context_adoption(ctx: FileContext) -> list[Finding]:
    """Every threading.Thread worker must adopt telemetry sinks + trace
    context + fault plans (or carry a justified suppression)."""
    by_name = functions_by_name(ctx.tree)
    out: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name not in ("threading.Thread", "Thread"):
            continue
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and node.args:
            target = node.args[0]

        missing: list[str]
        if isinstance(target, (ast.Name, ast.Attribute)):
            tname = (
                target.id if isinstance(target, ast.Name) else target.attr
            )
            fns = by_name.get(tname, [])
            if not fns:
                missing = ["<unresolvable target>"]
            else:
                got: set[str] = set()
                for f in fns:
                    got |= _adoptions_under(f, by_name)
                missing = []
                if "adopt_sinks" not in got:
                    missing.append("telemetry.adopt_sinks")
                if not (got & set(_CONTEXT)):
                    missing.append("obs.adopt_context (or adopt_trace)")
                if "adopt_plans" not in got:
                    missing.append("faults.adopt_plans")
        else:
            missing = ["<unresolvable target>"]

        if missing:
            out.append(Finding(
                rule="thread-context-adoption", path=ctx.rel,
                line=node.lineno,
                message=(
                    "worker thread does not adopt the caller's "
                    f"thread-local context: missing {', '.join(missing)}"
                ),
                hint=(
                    "adopt sinks/context/plans in the worker (see "
                    "serve/batcher.py:_process) or suppress with "
                    "`# lint: thread-context-adoption-ok (reason)`"
                ),
            ))
    return out
