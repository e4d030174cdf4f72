"""The dispatch core owns execution wiring — frontends adopt it.

Port of ``mosaic_tpu/analysis/rules/dispatch.py``. The port's dispatch
core (`mosaic_tpu_torch/dispatch`) composes the watchdog, the retry and
the degradation once (`guarded_call`), and registers every program
cache with `dispatch.bounded_cache`. This rule keeps that unification
from eroding: a frontend that re-grows its own `call_with_retry`
composition, raw `watchdog.guard` call, or module-level cache of built
programs silently forks the execution path again.

"Builds a program" means what replaces the reference's
`jit`/`shard_map`/`pallas_call` in the port: a CUDA graph
(``torch.cuda.graph``, ``torch.cuda.CUDAGraph``) or a load of the
kernel library (``kernels._build.load`` / ``load_all``). The owners —
`mosaic_tpu_torch/dispatch/`, `runtime/` and `kernels/_build.py` (the
implementations being composed) — are exempt by construction.
"""

from __future__ import annotations

import ast

from ..astutil import call_name, dotted
from ..engine import FileContext
from ..findings import Finding
from ..registry import rule

#: the only modules allowed to touch the raw wiring
_OWNERS = (
    "mosaic_tpu_torch/dispatch/", "mosaic_tpu_torch/runtime/",
    "mosaic_tpu_torch/kernels/_build.py",
)

_HINT_GUARD = (
    "route through dispatch.guarded_call(site, fn, ...) (retry=False "
    "for watchdog-only stages) so the composition exists once"
)
_HINT_CACHE = (
    "register the program cache with @dispatch.bounded_cache(name, "
    "maxsize) so it lands in dispatch.cache_stats() and stays bounded"
)


def builds_program(name: str) -> bool:
    """Does a call of dotted ``name`` build a program: a CUDA graph
    capture or graph, or a load of the kernel library?"""
    tail = name.split(".")[-1]
    if name.endswith("cuda.graph") or tail == "CUDAGraph":
        return True
    if tail == "load_all":
        return True
    return tail == "load" and name.split(".")[-2:-1] == ["_build"]


def _builds_program(fn_node: ast.AST) -> bool:
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Call) and builds_program(call_name(sub)):
            return True
    return False


@rule("dispatch-adoption")
def dispatch_adoption(ctx: FileContext) -> list[Finding]:
    """Frontends must not compose their own watchdog/retry wiring or
    module-level caches of built programs (CUDA graphs, kernel library
    loads) — that lives in mosaic_tpu_torch/dispatch (guarded_call /
    bounded_cache)."""
    if not ctx.in_library or ctx.rel.startswith(_OWNERS):
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = call_name(node)
            tail = name.split(".")[-1]
            if tail == "call_with_retry":
                out.append(Finding(
                    rule="dispatch-adoption", path=ctx.rel,
                    line=node.lineno,
                    message="frontend composes its own retry wiring "
                            "(call_with_retry)",
                    hint=_HINT_GUARD,
                ))
            elif tail == "guard" and "watchdog" in name:
                out.append(Finding(
                    rule="dispatch-adoption", path=ctx.rel,
                    line=node.lineno,
                    message="frontend calls watchdog.guard directly",
                    hint=_HINT_GUARD,
                ))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # an lru_cache-decorated program factory is a private
            # program cache — invisible to dispatch.cache_stats()
            for dec in node.decorator_list:
                dec_name = (
                    call_name(dec) if isinstance(dec, ast.Call)
                    else dotted(dec)
                )
                if dec_name.split(".")[-1] in ("lru_cache", "cache") and (
                    "functools" in dec_name or "." not in dec_name
                ) and _builds_program(node):
                    out.append(Finding(
                        rule="dispatch-adoption", path=ctx.rel,
                        line=dec.lineno,
                        message=f"private program cache {node.name!r} "
                                "bypasses the dispatch registry",
                        hint=_HINT_CACHE,
                    ))
    return out
