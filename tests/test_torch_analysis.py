"""The port's linter (`mosaic_tpu_torch/analysis`) against the
reference's (`mosaic_tpu/analysis`).

Every rule carried over as it is gives the reference engine's (rule,
path, line, message) findings on the fixtures of `tests/test_analysis.py`
(and on hygiene fixtures), each fixture written under the reference's
library (`mosaic_tpu/`) for the reference and under the port's
(`mosaic_tpu_torch/`) for the port. The port's own rules
(`capture-purity`, `env-read-after-staging` over CUDA graph captures,
`dispatch-adoption` over CUDA graphs and kernel-library loads) get
positive and negative torch fixtures, and are held to the port's real
capture site (`dispatch/core.py DispatchCore._graph_shard`). Fixture
code is written into ``tmp_path`` only."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from mosaic_tpu.analysis import analyze as ref_analyze
from mosaic_tpu_torch.analysis import (
    Finding,
    all_rules,
    analyze,
    load_baseline,
    save_baseline,
    split_baselined,
)
from mosaic_tpu_torch.analysis.engine import DEFAULT_TARGETS, is_lib
from mosaic_tpu_torch.analysis.rules.dispatch import builds_program
from mosaic_tpu_torch.analysis.rules.purity import captured_nodes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the rules the port carries over from the reference as they are
CARRIED = (
    "syntax", "whitespace", "unused-import", "bare-except", "print-in-lib",
    "broad-except", "unbounded-cache", "thread-context-adoption",
)


def project(root, **files):
    """Write ``{relative path: source}`` under ``root``; returns it."""
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


def to_port(rel: str) -> str:
    """A reference path's place in the port: its library and tools."""
    if rel.startswith("mosaic_tpu/"):
        return "mosaic_tpu_torch/" + rel[len("mosaic_tpu/"):]
    if rel.startswith("tools/"):
        return "mosaic_tpu_torch/tools/" + rel[len("tools/"):]
    return rel


def both(tmp_path, files, rules=None, keep=CARRIED + ("suppression",)):
    """Run the reference's engine on ``files`` and the port's on the same
    files moved into the port; returns both as (rule, port path, line,
    message) sets, active and suppressed."""
    ref = ref_analyze(project(tmp_path / "ref", **files), rule_names=rules)
    port = analyze(
        project(tmp_path / "port", **{to_port(k): v for k, v in files.items()}),
        rule_names=rules,
    )

    def norm(fs, mapped):
        return {(f.rule, to_port(f.path) if mapped else f.path, f.line, f.message)
                for f in fs if f.rule in keep}

    return ((norm(ref.findings, True), norm(ref.suppressed, True)),
            (norm(port.findings, False), norm(port.suppressed, False)))


# ------------------------------------------- the fixtures of test_analysis.py

THREAD_BAD = """\
    import threading

    def worker():
        pass

    def launch():
        threading.Thread(target=worker).start()
    """
THREAD_GOOD = """\
    import threading
    from mosaic_tpu.runtime import telemetry, faults
    from mosaic_tpu import obs

    def launch(ctx, sinks, plans):
        def worker():
            telemetry.adopt_sinks(sinks)
            obs.adopt_context(ctx)
            faults.adopt_plans(plans)
        threading.Thread(target=worker).start()
    """
THREAD_NESTED = """\
    import threading
    from mosaic_tpu.runtime import telemetry, faults
    from mosaic_tpu import obs

    class B:
        def _loop(self):
            self._process()

        def _process(self):
            telemetry.adopt_sinks(self.sinks)
            obs.adopt_trace(self.ctx)
            faults.adopt_plans(self.plans)

        def start(self):
            threading.Thread(target=self._loop).start()
    """
BROAD = """\
    def f():
        try:
            work()
        except Exception:
            pass

    def g():
        try:
            work()
        except Exception as e:
            raise RuntimeError("ctx") from e

    def h():
        try:
            work()
        except Exception:  # lint: broad-except-ok (best-effort probe)
            pass
    """
CACHES = """\
    import functools

    @functools.lru_cache(maxsize=None)
    def bad(x):
        return x

    @functools.lru_cache
    def fine_default(x):  # maxsize=128
        return x

    @functools.lru_cache(maxsize=8)
    def fine_bounded(x):
        return x

    @functools.cache
    def also_bad(x):
        return x
    """
MALFORMED = """\
    def f():
        try:
            work()
        except Exception:  # {m1}
            pass

    def g():
        try:
            work()
        except Exception:  # {m2}
            pass
    """.format(m1="lint: no-such-rule-ok (reason)", m2="lint: broad-except-ok")
WRONG_RULE = """\
    import functools

    @functools.lru_cache(maxsize=None)  # lint: broad-except-ok (wrong rule)
    def f(x):
        return x
    """
HYGIENE = (
    "from __future__ import annotations\n"
    "import os\n"
    "import sys  # noqa: F401\n"
    "import json\n"
    "import re as regex\n"
    "__all__ = ['json']\n"
    "\n"
    "def f(x):   \n"
    "\treturn x\n"
    "\n"
    "def g():\n"
    "    try:\n"
    "        return regex.compile('a')\n"
    "    except:\n"
    "        print('no')\n"
)

CASES = {
    "thread_bad": ("thread-context-adoption", {"mosaic_tpu/bad.py": THREAD_BAD}),
    "thread_good": ("thread-context-adoption", {"mosaic_tpu/good.py": THREAD_GOOD}),
    "thread_nested": ("thread-context-adoption", {"mosaic_tpu/m.py": THREAD_NESTED}),
    "broad_except": ("broad-except", {"mosaic_tpu/m.py": BROAD}),
    "cache_lib": ("unbounded-cache", {"mosaic_tpu/m.py": CACHES}),
    "cache_tools": ("unbounded-cache", {"tools/m.py": CACHES}),
    "malformed_suppressions": (None, {"mosaic_tpu/m.py": MALFORMED}),
    "suppression_wrong_rule": (None, {"mosaic_tpu/m.py": WRONG_RULE}),
    "hygiene_lib": (None, {"mosaic_tpu/h.py": HYGIENE}),
    "hygiene_tools": (None, {"tools/h.py": HYGIENE}),
    "syntax": (None, {"mosaic_tpu/broken.py": "def f(:\n    pass\n",
                      "mosaic_tpu/ok.py": "X = 1\n"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_carried_rules_equal_the_reference(tmp_path, case):
    rule, files = CASES[case]
    (ref, ref_sup), (port, port_sup) = both(
        tmp_path, files, rules=None if rule is None else [rule])
    assert port == ref
    assert port_sup == ref_sup


def test_fixture_findings_are_the_references_lines(tmp_path):
    """Spot checks that the shared fixtures fire where the reference's
    tests say they do (so the equality above is not of two empty sets)."""
    (bad, _), (port_bad, _) = both(
        tmp_path / "a", CASES["thread_bad"][1], ["thread-context-adoption"])
    assert [x[2] for x in port_bad] == [7] and port_bad == bad
    (_, _), (broad, silenced) = both(tmp_path / "b", {"mosaic_tpu/m.py": BROAD},
                                      ["broad-except"])
    assert [x[2] for x in broad] == [4] and [x[2] for x in silenced] == [16]
    (_, _), (caches, _) = both(tmp_path / "c", {"mosaic_tpu/m.py": CACHES},
                               ["unbounded-cache"])
    assert sorted(x[2] for x in caches) == [3, 15]
    (_, _), (hyg, _) = both(tmp_path / "d", {"mosaic_tpu/h.py": HYGIENE})
    assert {(r, ln) for r, _, ln, _ in hyg} == {
        ("unused-import", 2), ("whitespace", 8), ("whitespace", 9),
        ("bare-except", 14), ("print-in-lib", 15)}
    (_, _), (sup, _) = both(tmp_path / "e", {"mosaic_tpu/m.py": MALFORMED})
    assert sum(1 for x in sup if x[0] == "suppression") == 2
    assert any(x[0] == "broad-except" and x[2] == 10 for x in sup)


def test_rule_catalog_is_the_ports():
    rules = all_rules()
    assert set(rules) == set(CARRIED) | {
        "capture-purity", "env-read-after-staging", "dispatch-adoption",
        "registry-drift",
    }
    assert "jit-purity" not in rules
    assert all(r.doc for r in rules.values())
    assert rules["registry-drift"].scope == "project"


def test_library_scope_is_the_port_less_its_tools():
    assert is_lib("mosaic_tpu_torch/sql/join.py")
    assert is_lib("mosaic_tpu_torch/analysis/engine.py")
    assert not is_lib("mosaic_tpu_torch/tools/lint.py")
    assert not is_lib("mosaic_tpu/sql/join.py")
    assert not is_lib("chip_smoke.py")
    assert not is_lib("tests/test_torch_join.py")
    assert DEFAULT_TARGETS == (
        "mosaic_tpu_torch", "tests/test_torch_*.py", "chip_smoke.py")


def test_default_targets_lint_the_port_only(tmp_path):
    src = "import os\n"
    root = project(tmp_path, **{
        "mosaic_tpu/a.py": src, "tools/a.py": src, "tests/test_a.py": src,
        "bench.py": src, "mosaic_tpu_torch/a.py": src,
        "mosaic_tpu_torch/tools/a.py": src, "tests/test_torch_a.py": src,
        "tests/torch_fixtures.py": src, "chip_smoke.py": src,
    })
    res = analyze(root, rule_names=["unused-import"])
    assert sorted(f.path for f in res.findings) == [
        "chip_smoke.py", "mosaic_tpu_torch/a.py", "mosaic_tpu_torch/tools/a.py",
        "tests/test_torch_a.py"]
    assert res.files == 4


def test_print_in_lib_spares_the_ports_tools(tmp_path):
    src = "def f():\n    print(1)\n"
    root = project(tmp_path, **{"mosaic_tpu_torch/a.py": src,
                                "mosaic_tpu_torch/tools/a.py": src, "chip_smoke.py": src})
    res = analyze(root, rule_names=["print-in-lib"])
    assert [(f.path, f.line) for f in res.findings] == [("mosaic_tpu_torch/a.py", 2)]


# ----------------------------------------------------------- capture purity

CAPTURE_BAD = """\
    import time
    import numpy as np
    import torch
    from . import telemetry
    from ..kernels import _build

    class Core:
        def _probe(self, x):
            n = x.sum().item()
            return helper(x) + n

        def run(self, g, x):
            with _build.captured_launches() as rec, torch.cuda.graph(g):
                print("capturing")
                y = self._probe(x)
                torch.cuda.synchronize()
            return y, rec

    def helper(x):
        time.perf_counter()
        telemetry.record("ev", n=1)
        np.asarray(x)
        x.tolist()
        x.numpy()
        return x.cpu()
    """
CAPTURE_CLEAN = """\
    import os
    import time
    import torch
    from . import telemetry

    class Core:
        def _probe(self, x):
            return torch.cumsum(x, 0) * self.scale

        def run(self, g, x):
            t0 = time.perf_counter()
            knob = os.environ.get("MOSAIC_X")
            n = x.sum().item()
            with torch.no_grad():
                print("not a capture")
            with torch.cuda.graph(g):
                y = self._probe(x)
            telemetry.record("captured", n=n, knob=knob,
                             s=time.perf_counter() - t0)
            return y.cpu()

    def unreached(x):
        return x.item()
    """


def test_capture_purity_flags_host_work_under_capture(tmp_path):
    root = project(tmp_path, **{"mosaic_tpu_torch/dispatch/m.py": CAPTURE_BAD})
    res = analyze(root, rule_names=["capture-purity"])
    got = {(f.line, f.message.split()[0]) for f in res.findings}
    assert got == {
        (9, ".item()"), (14, "print()"), (16, "torch.cuda.synchronize()"),
        (20, "host"), (21, "telemetry"), (22, "np.asarray()"), (23, ".tolist()"),
        (24, ".numpy()"), (25, ".cpu()"),
    }
    assert all(f.path == "mosaic_tpu_torch/dispatch/m.py" for f in res.findings)


def test_capture_purity_ignores_host_work_outside_capture(tmp_path):
    root = project(tmp_path, **{"mosaic_tpu_torch/m.py": CAPTURE_CLEAN})
    assert analyze(root, rule_names=["capture-purity"]).findings == []
    assert analyze(root, rule_names=["env-read-after-staging"]).findings == []


def test_env_read_after_staging_flags_reads_under_capture(tmp_path):
    root = project(tmp_path, **{"mosaic_tpu_torch/m.py": """\
        import os
        import torch

        def lane():
            return os.environ.get("MOSAIC_X", "")

        def capture(g, x):
            k = os.getenv("MOSAIC_Y")  # host side: fine
            with torch.cuda.graph(g):
                y = x * 2 if lane() else x
                z = os.getenv("MOSAIC_Z")
            return y, k, z

        def host(x):
            return os.environ.get("MOSAIC_X")  # host-side: fine
        """})
    res = analyze(root, rule_names=["env-read-after-staging"])
    assert sorted(f.line for f in res.findings) == [5, 11]


def test_the_real_capture_site_is_reached_and_pure():
    """The port's one capture (`DispatchCore._graph_shard`) is found with
    the code it reaches (`_shard_probe`, `_caps_rows`, `cells_prog`), and
    both purity rules are green on the tree."""
    path = os.path.join(ROOT, "mosaic_tpu_torch", "dispatch", "core.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {getattr(n, "name", None) for n in captured_nodes(tree)}
    assert {"_shard_probe", "_caps_rows", "cells_prog"} <= names
    res = analyze(ROOT, rule_names=["capture-purity", "env-read-after-staging"])
    assert res.findings == []


def test_a_host_pull_put_into_the_real_capture_is_found(tmp_path):
    """A mutation of the real capture's reach: a ``.item()`` in
    `_shard_probe` and an environment read in `_caps_rows` are found."""
    path = os.path.join(ROOT, "mosaic_tpu_torch", "dispatch", "core.py")
    with open(path) as f:
        src = f.read()
    pull = "fcap, hcap, ccap = self._caps_rows(pts.shape[0])"
    env = "fcap = None if self.writeback == \"direct\" else rows"
    assert src.count(pull) == 1 and src.count(env) == 1
    src = src.replace(pull, "fcap, hcap, ccap = self._caps_rows(int(pts.sum().item()))")
    src = src.replace(env, "fcap = None if os.environ.get('MOSAIC_MUTATED_KNOB') else rows")
    lines = src.splitlines()
    want_pull = next(i for i, ln in enumerate(lines, 1) if ".item()" in ln)
    want_env = next(i for i, ln in enumerate(lines, 1) if "MOSAIC_MUTATED_KNOB" in ln)
    (tmp_path / "mosaic_tpu_torch" / "dispatch").mkdir(parents=True)
    (tmp_path / "mosaic_tpu_torch" / "dispatch" / "core.py").write_text(src)
    res = analyze(str(tmp_path), rule_names=["capture-purity", "env-read-after-staging"])
    assert {(f.rule, f.line) for f in res.findings} == {
        ("capture-purity", want_pull), ("env-read-after-staging", want_env)}


# ------------------------------------------------------- dispatch adoption

FRONTEND = """\
    import functools
    import torch
    from ..kernels import _build
    from ..kernels._build import load_all
    from ..runtime import watchdog
    from ..runtime.retry import call_with_retry

    @functools.lru_cache(maxsize=8)
    def graph_for(n):
        g = torch.cuda.CUDAGraph()
        return g

    @functools.lru_cache(maxsize=4)
    def capture(n, g):
        with torch.cuda.graph(g):
            return n

    @functools.lru_cache
    def library():
        return _build.load("pip")

    @functools.lru_cache(maxsize=2)
    def libraries():
        return load_all()

    @functools.lru_cache(maxsize=8)
    def plain_cache(n):
        return n * 2

    def run(fn):
        watchdog.guard("site", fn)
        return call_with_retry(fn)
    """


def test_dispatch_adoption_flags_a_frontends_private_wiring(tmp_path):
    root = project(tmp_path, **{"mosaic_tpu_torch/sql/m.py": FRONTEND})
    res = analyze(root, rule_names=["dispatch-adoption"])
    got = sorted((f.line, f.message.split()[0]) for f in res.findings)
    assert got == [(8, "private"), (13, "private"), (18, "private"), (22, "private"),
                   (31, "frontend"), (32, "frontend")]


@pytest.mark.parametrize("rel", [
    "mosaic_tpu_torch/dispatch/m.py", "mosaic_tpu_torch/runtime/m.py",
    "mosaic_tpu_torch/kernels/_build.py", "mosaic_tpu_torch/tools/m.py",
    "chip_smoke.py",
])
def test_dispatch_adoption_spares_the_owners_and_tools(tmp_path, rel):
    root = project(tmp_path, **{rel: FRONTEND})
    assert analyze(root, rule_names=["dispatch-adoption"]).findings == []


def test_what_builds_a_program():
    for name in ("torch.cuda.graph", "cuda.graph", "torch.cuda.CUDAGraph", "CUDAGraph",
                 "_build.load", "kernels._build.load", "_build.load_all", "load_all"):
        assert builds_program(name), name
    for name in ("torch.load", "json.load", "graph", "torch.cuda.synchronize",
                 "jax.jit", "pl.pallas_call"):
        assert not builds_program(name), name


# ------------------------------------------------ baseline and isolation


def test_baseline_round_trip(tmp_path):
    f1 = Finding(rule="r", path="a.py", line=3, message="m1")
    f2 = Finding(rule="r", path="a.py", line=9, message="m1")
    f3 = Finding(rule="r", path="b.py", line=1, message="m2")
    path = str(tmp_path / "baseline.json")
    save_baseline(path, [f1, f2, f3])
    baseline = load_baseline(path)
    assert baseline == {f1.key(): 2, f3.key(): 1}
    assert split_baselined([f1, f2, f3], baseline) == ([], [f1, f2, f3], [])
    active, grand, stale = split_baselined([f1], baseline)
    assert active == [] and grand == [f1] and stale == sorted([f1.key(), f3.key()])
    f4 = Finding(rule="r", path="a.py", line=20, message="m1")
    active, grand, _ = split_baselined([f1, f2, f4], baseline)
    assert active == [f4] and len(grand) == 2
    assert load_baseline(str(tmp_path / "missing.json")) == {}


def test_unknown_rule_raises():
    with pytest.raises(KeyError):
        analyze(ROOT, targets=(), rule_names=["jit-purity"])


def test_the_analysis_package_is_stdlib_only():
    """It imports nothing of JAX or the reference (only relative modules
    and the standard library), in a fresh interpreter too."""
    pkg = os.path.join(ROOT, "mosaic_tpu_torch", "analysis")
    allowed = {"__future__", "ast", "dataclasses", "fnmatch", "glob", "json", "os",
               "re", "typing"}
    for base, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(base, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    mods = [node.module.split(".")[0]]
                else:
                    continue
                assert set(mods) <= allowed, (name, mods)
    code = ("import sys, mosaic_tpu_torch.analysis\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mosaic_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
