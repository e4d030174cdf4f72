"""Generated project registry: the machine-readable inventory of
fault-injection sites, trace span names, telemetry events/stage keys,
and ``MOSAIC_*`` env knobs, scanned from the AST.

Port of ``mosaic_tpu/analysis/project_registry.py`` over the port: the
committed copy (``mosaic_tpu_torch/tools/goldens/registry.json``,
regenerated with ``python -m mosaic_tpu_torch.tools.lint
--update-registry``) plus the ``registry-drift`` rule keep code,
TORCH_ARCHITECTURE.md's span taxonomy, the port's perf_gate golden, and
the env-knob docs from diverging.

Dynamic names register as wildcard families: an f-string span like
``f"join.probe.{lane}"`` scans as ``join.probe.*`` and matches any
documented name under the prefix; the watchdog's per-site deadline knob
(``MOSAIC_WATCHDOG_<SITE>``) scans as ``MOSAIC_WATCHDOG_*``.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re

from .astutil import (
    call_name, const_str, dotted, last_attr, name_or_wildcard,
)
from .engine import is_lib

REGISTRY_NOTE = (
    "generated inventory of the port's fault sites / spans / telemetry "
    "events / env knobs — regenerate with `python -m "
    "mosaic_tpu_torch.tools.lint --update-registry`"
)

#: library + tool code carries registered names; tests exercise them
SCAN_TARGETS = ("mosaic_tpu_torch", "chip_smoke.py")

#: call tails whose first literal argument is a fault/watchdog site.
#: `guarded_call` / `execute_resilient` are the dispatch core's guarded
#: entry points — frontends name their site there, so the scanner must
#: read it from the same position it reads `guard`'s.
_FAULT_HOOKS = {
    "maybe_fail", "maybe_corrupt", "planned_stall", "guard",
    "guarded_call", "execute_resilient",
}
_KNOB_RE = re.compile(r"^MOSAIC_[A-Z0-9_]+$")
_KNOB_PREFIX_RE = re.compile(r"^MOSAIC_[A-Z0-9_]*$")


def _is_telemetry_call(call: ast.Call) -> bool:
    name = call_name(call)
    base = name.rsplit(".", 1)[0] if "." in name else ""
    return last_attr(call) in ("record", "timed") and (
        "telemetry" in base or name in ("record", "timed")
    )


def _env_read_names(call: ast.Call) -> list[str]:
    """MOSAIC_* literals read through os.environ.get/os.getenv."""
    name = call_name(call)
    is_env = (
        name.endswith("getenv")
        or (last_attr(call) == "get" and ".environ" in f".{name}")
    )
    if not is_env:
        return []
    out = []
    for arg in call.args[:1]:
        s = const_str(arg)
        if s and _KNOB_RE.match(s):
            out.append(s)
    return out


def scan_module(rel: str, tree: ast.AST) -> dict[str, set[str]]:
    """One module's contribution: ``{category -> names}``."""
    out: dict[str, set[str]] = {
        "fault_sites": set(), "spans": set(), "events": set(),
        "stages": set(), "env_knobs": set(),
    }
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript):
            # os.environ["MOSAIC_X"] reads/writes
            if dotted(node.value).endswith("environ"):
                s = const_str(node.slice)
                if s and _KNOB_RE.match(s):
                    out["env_knobs"].add(s)
            continue
        if isinstance(node, ast.JoinedStr):
            # dynamic env-knob families, e.g. f"MOSAIC_WATCHDOG_{site}"
            head = node.values[0] if node.values else None
            if (
                isinstance(head, ast.Constant)
                and isinstance(head.value, str)
                and _KNOB_PREFIX_RE.match(head.value)
                and len(node.values) > 1
            ):
                out["env_knobs"].add(head.value + "*")
            continue
        if not isinstance(node, ast.Call):
            continue
        tail = last_attr(node)
        if tail in _FAULT_HOOKS and node.args:
            s = const_str(node.args[0])
            if s:
                out["fault_sites"].add(s)
        elif tail in ("span", "start_span") and node.args:
            s = name_or_wildcard(node.args[0])
            if s:
                out["spans"].add(s)
        elif _is_telemetry_call(node) and node.args:
            ev = const_str(node.args[0])
            if ev:
                out["events"].add(ev)
                for kw in node.keywords:
                    if kw.arg == "stage":
                        stage = const_str(kw.value)
                        if stage:
                            out["stages"].add(f"{ev}.{stage}")
                        else:
                            # dynamic stage (a variable/f-string), e.g.
                            # probe_smoke's per-lane `stage=lane` — the
                            # family registers as a wildcard
                            out["stages"].add(f"{ev}.*")
        for name in _env_read_names(node):
            out["env_knobs"].add(name)
    return out


def build_registry_from_modules(
    modules: list[tuple[str, ast.AST]]
) -> dict:
    """``modules`` is ``[(repo-relative path, parsed tree), ...]``;
    tests/ modules are excluded (fixture names are not registered
    surface). Library spans and tool-only spans are kept apart: the
    TORCH_ARCHITECTURE span table documents the library taxonomy, while
    the spans of ``mosaic_tpu_torch/tools/`` (``chaos_sweep``) and of
    ``chip_smoke.py`` are tool-scoped."""
    cats: dict[str, set[str]] = {
        "fault_sites": set(), "spans": set(), "spans_tools": set(),
        "events": set(), "stages": set(), "env_knobs": set(),
    }
    for rel, tree in modules:
        if rel.startswith("tests/") or tree is None:
            continue
        part = scan_module(rel, tree)
        lib = is_lib(rel)
        cats["fault_sites"] |= part["fault_sites"]
        cats["events"] |= part["events"]
        cats["stages"] |= part["stages"]
        cats["env_knobs"] |= part["env_knobs"]
        cats["spans" if lib else "spans_tools"] |= part["spans"]
    reg = {k: sorted(v) for k, v in cats.items()}
    reg["note"] = REGISTRY_NOTE
    return reg


def build_registry(root: str) -> dict:
    """Scan ``SCAN_TARGETS`` under ``root`` and build the registry."""
    modules: list[tuple[str, ast.AST]] = []
    for target in SCAN_TARGETS:
        p = os.path.join(root, target)
        paths: list[str] = []
        if os.path.isfile(p):
            paths = [p]
        else:
            for base, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                paths += [
                    os.path.join(base, f)
                    for f in files if f.endswith(".py")
                ]
        for path in sorted(paths):
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            try:
                modules.append((rel, ast.parse(src, filename=rel)))
            except SyntaxError:
                continue  # the syntax rule reports it; registry skips
    return build_registry_from_modules(modules)


def name_matches(name: str, registered: list[str]) -> bool:
    """Does ``name`` match any registered entry (wildcard families
    included)?"""
    return any(
        fnmatch.fnmatch(name, pat) if pat.endswith("*") else name == pat
        for pat in registered
    )
