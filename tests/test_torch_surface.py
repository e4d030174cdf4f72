"""Surface audit: the port has every public name of the reference.

Both packages are read as source with `ast`; neither is imported, so this
file needs no JAX and no torch. For each module of ``mosaic_tpu/`` the
module at the same path under ``mosaic_tpu_torch/`` must have:

- every public module-level name the reference defines (functions,
  classes, assignments);
- every entry of its ``__all__`` and every re-export of a package
  ``__init__`` (``from .x import y``); a port package that loads names
  lazily (a module ``__getattr__``) may list them in ``__all__`` instead;
- every public method and property of every public class;
- every parameter, positional-or-keyword or keyword-only, of every public
  function and method.

The only exceptions are the entries of :data:`EXCLUDED`, each naming the
JAX or TPU mechanism it stands for and its port counterpart where there is
one. An entry that no longer names a gap (the port now has it, or the
reference no longer does) fails :func:`test_no_exclusion_is_stale`.
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "mosaic_tpu"
PORT = ROOT / "mosaic_tpu_torch"

_SHARD_MAP = (
    "a jax shard_map spec; the port's mesh lanes launch one shard per "
    "device of `parallel.mesh.Mesh` with no spec to check"
)
_INTERPRET = (
    "Pallas interpret mode; the port's wrapper runs its plain torch "
    "version for a CPU tensor instead"
)
_JIT = (
    "a process-wide jax.jit executable cache; the port runs "
    "`sql.join.pip_join_points` and its helpers eagerly and caches only "
    "the nvcc builds (`dispatch.cache_stats()['kernels']`)"
)
_CHECK_REP = (
    "shard_map replication checking, off where a pallas_call has no "
    "replication rule; the port's mesh lanes check no replication"
)
_EXECUTABLE = (
    "a jax-compiled XLA executable object and the live call prototypes "
    "its PyTreeDefs are rebuilt from; the port's stored program is a "
    "kernel library, serialized and bound by its name"
)
_DONATE = (
    "jax buffer donation of the resident ring; torch tensors are "
    "reused in place, so there is nothing to donate"
)

#: "<module path>:<name>" -> why the port does not carry it. A name is a
#: module-level name, "Class.method", or "function(param=)".
EXCLUDED: dict[str, str] = {
    "parallel/_compat.py": (
        "a shim over jax's shard_map import path; the port's meshes are "
        "`parallel/mesh.py`"
    ),
    "dispatch/core.py:jit_join": _JIT,
    "dispatch/core.py:jit_counts": _JIT,
    "dispatch/core.py:jit_compact": _JIT,
    "dispatch/core.py:probe_check_rep": _CHECK_REP,
    "dispatch/__init__.py:jit_join": _JIT,
    "dispatch/__init__.py:jit_counts": _JIT,
    "dispatch/__init__.py:jit_compact": _JIT,
    "dispatch/__init__.py:probe_check_rep": _CHECK_REP,
    "kernels/pip.py:pip_zone(interpret=)": _INTERPRET,
    "kernels/pip.py:pip_heavy_tiled(interpret=)": _INTERPRET,
    "kernels/zonal.py:zonal_tiled(interpret=)": _INTERPRET,
    "dispatch/core.py:stream_programs(donate_ring=)": _DONATE,
    "sql/stream.py:build_stream_programs(donate_ring=)": _DONATE,
    "dispatch/core.py:sharded_pointwise(check_rep=)": _SHARD_MAP,
    "dispatch/core.py:sharded_pointwise(n_out=)": (
        "the shard_map out_specs count; the port's `sharded_pointwise` "
        "concatenates whatever outputs each shard returns"
    ),
    "parallel/dist_overlay.py:geom_specs(row=)": _SHARD_MAP,
    "dispatch/programs.py:serialize_compiled(compiled=)": _EXECUTABLE,
    "dispatch/programs.py:deserialize_compiled(example_args=)": _EXECUTABLE,
    "dispatch/programs.py:deserialize_compiled(out_aval=)": _EXECUTABLE,
    "analysis/rules/purity.py:jit_purity": (
        "the rule over jax.jit-traced bodies; the port's counterpart is "
        "`capture_purity`, over CUDA graph captures"
    ),
    "analysis/rules/purity.py:traced_nodes": (
        "the jit-traced function finder; the port's counterpart is "
        "`captured_nodes`"
    ),
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _params(fn) -> set[str]:
    a = fn.args
    return {x.arg for x in a.args + a.kwonlyargs} - {"self", "cls"}


def _all_of(expr, path: Path) -> set[str]:
    """The names of an ``__all__`` expression: a literal list or tuple,
    a sum of them, or ``list(sibling.__all__)`` of a sibling module."""
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return _all_of(expr.left, path) | _all_of(expr.right, path)
    if isinstance(expr, ast.Call) and expr.args:
        return _all_of(expr.args[0], path)
    if isinstance(expr, ast.Attribute) and expr.attr == "__all__":
        sibling = path.parent / f"{expr.value.id}.py"
        if not sibling.exists():
            sibling = path.parent / expr.value.id / "__init__.py"
        return _surface(sibling)["all"]
    return set(ast.literal_eval(expr))


@functools.lru_cache(maxsize=None)
def _surface(path: Path) -> dict:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    init = path.name == "__init__.py"
    names: set[str] = set()
    exported: set[str] = set()
    reexports: set[str] = set()
    classes: dict[str, dict[str, set[str]]] = {}
    funcs: dict[str, set[str]] = {}
    lazy = False
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lazy |= node.name == "__getattr__"
            if _public(node.name):
                names.add(node.name)
                funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            if _public(node.name):
                names.add(node.name)
                classes[node.name] = {
                    b.name: _params(b)
                    for b in node.body
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and _public(b.name)
                }
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if not isinstance(n, ast.Name):
                        continue
                    if n.id == "__all__":
                        exported |= _all_of(node.value, path)
                    elif _public(n.id):
                        names.add(n.id)
        elif init and isinstance(node, ast.ImportFrom) and node.level > 0:
            reexports |= {a.asname or a.name for a in node.names if _public(a.asname or a.name)}
    return {
        "names": names, "all": exported, "reexports": reexports,
        "classes": classes, "funcs": funcs, "lazy": lazy,
    }


def _gaps(rel: str) -> set[str]:
    """Every "<rel>:<name>" the reference module has and the port lacks."""
    port_path = PORT / rel
    if not port_path.exists():
        return {rel}
    r, p = _surface(REF / rel), _surface(port_path)
    have = p["names"] | p["reexports"] | (p["all"] if p["lazy"] else set())
    gaps = set()
    for n in r["names"] | r["reexports"]:
        if n not in have:
            gaps.add(n)
    for n in r["all"]:
        if n not in p["all"]:
            gaps.add(n)
    for fn, params in r["funcs"].items():
        for x in params - p["funcs"].get(fn, params):
            gaps.add(f"{fn}({x}=)")
    for cls, methods in r["classes"].items():
        port_methods = p["classes"].get(cls)
        if port_methods is None:
            continue  # the class itself is a gap above
        for m, params in methods.items():
            if m not in port_methods:
                gaps.add(f"{cls}.{m}")
                continue
            for x in params - port_methods[m]:
                gaps.add(f"{cls}.{m}({x}=)")
    return {f"{rel}:{g}" for g in gaps}


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_the_reference_has_its_modules():
    assert len(REF_MODULES) >= 140


@pytest.mark.parametrize("rel", REF_MODULES)
def test_port_module_has_the_reference_surface(rel):
    missing = sorted(g for g in _gaps(rel) if g not in EXCLUDED)
    assert not missing, f"the port lacks: {missing}"


def test_no_exclusion_is_stale():
    found = set()
    for rel in REF_MODULES:
        found |= _gaps(rel)
    stale = sorted(k for k in EXCLUDED if k not in found)
    assert not stale, f"exclusions that name no gap any more: {stale}"


@pytest.mark.parametrize("key", sorted(EXCLUDED))
def test_each_exclusion_names_a_jax_or_tpu_mechanism(key):
    reason = EXCLUDED[key].lower()
    assert any(w in reason for w in (
        "jax", "pallas", "shard_map", "xla", "tpu", "jit",
    )), key
