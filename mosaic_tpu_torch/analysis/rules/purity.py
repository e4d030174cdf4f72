"""Captured-code purity: the two rules guarding the CUDA graph capture.

Port of ``mosaic_tpu/analysis/rules/purity.py``. Where JAX traces a
function once per signature, the port captures a serving rung's probe
into a CUDA graph once (``dispatch/core.py DispatchCore._graph_shard``)
and replays it for every later dispatch. Anything the Python body of
the capture does besides enqueueing device work either breaks the
capture (a host pull: ``.item()``, ``.cpu()``, ``.tolist()``,
``.numpy()``, ``torch.cuda.synchronize``) or runs once at capture and
never again at replay (clocks, telemetry, ``print``, environment reads —
a replay bakes in the knob's value at capture). These rules make that
machine-checked.

Captured contexts detected: the body of every ``with torch.cuda.graph(
...)`` block and (transitively) the module-local functions called by
plain name and the methods called through ``self.`` from it — the
reference's own in-module reach.
"""

from __future__ import annotations

import ast

from ..astutil import call_name, functions_by_name, last_attr
from ..engine import FileContext
from ..findings import Finding
from ..registry import rule


def _is_capture_with(node: ast.AST) -> bool:
    """``with torch.cuda.graph(...)`` (among the block's items)."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        ce = item.context_expr
        if isinstance(ce, ast.Call) and call_name(ce).endswith("cuda.graph"):
            return True
    return False


def captured_nodes(tree: ast.AST) -> list[ast.AST]:
    """Every statement of a capture block's body and every function it
    reaches in the module: plain-name calls and ``self.`` method calls,
    resolved by simple name."""
    by_name = functions_by_name(tree)
    queue: list[ast.AST] = []
    for node in ast.walk(tree):
        if _is_capture_with(node):
            queue.extend(node.body)

    seen: set[int] = set()
    marked: list[ast.AST] = []
    while queue:
        fn = queue.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        marked.append(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                callee = f.id
            elif (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
            ):
                callee = f.attr
            else:
                continue
            for target in by_name.get(callee, []):
                if id(target) not in seen:
                    queue.append(target)
    return marked


#: host clock calls that run once at capture, never at replay
_TIME_FNS = {
    "time", "perf_counter", "monotonic", "sleep", "process_time",
    "perf_counter_ns", "monotonic_ns", "time_ns",
}

#: tensor methods that copy to the host (and so sync the card)
_HOST_PULLS = ("item", "cpu", "tolist", "numpy")


def _purity_violation(node: ast.Call) -> str | None:
    name = call_name(node)
    tail = last_attr(node)
    if isinstance(node.func, ast.Name) and node.func.id == "print":
        return "print() under capture runs at capture time only"
    parts = name.split(".")
    if len(parts) == 2 and parts[0] == "time" and parts[1] in _TIME_FNS:
        return f"host clock {name}() under capture runs once, not per replay"
    if tail in ("record", "timed") and "telemetry" in name:
        return f"telemetry {tail}() under capture is a host side effect"
    if tail == "asarray" and parts[0] in ("np", "numpy", "onp"):
        return f"{name}() under capture forces a host transfer"
    if tail in _HOST_PULLS and not node.args and isinstance(
        node.func, ast.Attribute
    ):
        return f".{tail}() under capture is a host pull (breaks the capture)"
    if name.endswith("cuda.synchronize"):
        return "torch.cuda.synchronize() under capture breaks the capture"
    return None


@rule("capture-purity")
def capture_purity(ctx: FileContext) -> list[Finding]:
    """No host pulls (.item()/.cpu()/.tolist()/.numpy()/np.asarray/
    torch.cuda.synchronize), clocks, telemetry or print inside a CUDA
    graph capture or the module-local code it calls."""
    out: list[Finding] = []
    reported: set[tuple[int, str]] = set()
    for fn in captured_nodes(ctx.tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            why = _purity_violation(node)
            if why and (node.lineno, why) not in reported:
                reported.add((node.lineno, why))
                out.append(Finding(
                    rule="capture-purity", path=ctx.rel, line=node.lineno,
                    message=why,
                    hint=(
                        "hoist the host op before the capture (the eager "
                        "run that precedes it) or after the replay"
                    ),
                ))
    return out


@rule("env-read-after-staging")
def env_read_after_staging(ctx: FileContext) -> list[Finding]:
    """No os.environ reads inside a CUDA graph capture — every replay
    bakes in the value read at capture and never re-reads it."""
    out: list[Finding] = []
    reported: set[int] = set()
    for fn in captured_nodes(ctx.tree):
        for node in ast.walk(fn):
            is_env = False
            if isinstance(node, ast.Attribute) and node.attr == "environ":
                is_env = True
            elif isinstance(node, ast.Call) and (
                call_name(node).endswith("getenv")
            ):
                is_env = True
            if is_env and node.lineno not in reported:
                reported.add(node.lineno)
                out.append(Finding(
                    rule="env-read-after-staging", path=ctx.rel,
                    line=node.lineno,
                    message=(
                        "os.environ read inside a CUDA graph capture "
                        "bakes the capture-time value into every replay"
                    ),
                    hint=(
                        "resolve the knob before the capture, as "
                        "sql.join.resolve_probe_mode does"
                    ),
                ))
    return out
