"""Dependency-free line-coverage gate over ``mosaic_tpu_torch/``.

Port of the reference's ``tools/coverage_gate.py`` (its analog is the 80%
scoverage floor of the reference's pom.xml ``<minimum.coverage>``), with
the same method: line coverage of the package while the tests run
in-process, from PEP 669 ``sys.monitoring`` LINE events with
per-location disable (an event fires once per code location, then turns
itself off), over the executable lines of the compiled code objects.
Code that runs only on the card (the CUDA launches) counts as missed on a
machine without one.

Usage:
    python -m mosaic_tpu_torch.tools.coverage_gate [--fail-under 80] [pytest args...]

Without pytest args it runs the port's tests, ``tests/test_torch_*.py``.
Run as a module, it first forgets the package modules that ``-m``
imported, so their module-level lines are counted too.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = os.path.join(REPO, "mosaic_tpu_torch")


def executable_lines(path: str) -> set[int]:
    """All executable line numbers of a source file, from the compiled
    code objects' co_lines tables (the same denominator coverage.py
    uses), minus doc-only/constant lines compile() still attributes."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        code = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines: set[int] = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for _, _, ln in co.co_lines():
            if ln is not None:
                lines.add(ln)
        for const in co.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    return lines


def _default_tests() -> list[str]:
    return sorted(
        os.path.relpath(p, REPO)
        for p in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))
    ) + ["-q"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fail-under", type=float, default=80.0)
    ap.add_argument("pytest_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    hit: dict[str, set[int]] = {}
    mon = sys.monitoring
    tool = mon.COVERAGE_ID
    mon.use_tool_id(tool, "mosaic-torch-coverage-gate")

    def on_line(code, line):
        fn = code.co_filename
        if fn.startswith(PKG + os.sep):
            hit.setdefault(fn, set()).add(line)
        return mon.DISABLE  # once per location is all coverage needs

    mon.register_callback(tool, mon.events.LINE, on_line)
    mon.set_events(tool, mon.events.LINE)

    os.chdir(REPO)
    sys.path.insert(0, REPO)
    import pytest

    try:
        rc = pytest.main(args.pytest_args or _default_tests())
    finally:
        mon.set_events(tool, 0)
        mon.register_callback(tool, mon.events.LINE, None)
        mon.free_tool_id(tool)
    if rc != 0:
        print(f"coverage-gate: pytest failed (rc={rc})")
        return int(rc)

    total = covered = 0
    worst: list[tuple[float, str, int, int]] = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            lines = executable_lines(path)
            if not lines:
                continue
            got = len(lines & hit.get(path, set()))
            total += len(lines)
            covered += got
            worst.append(
                (got / len(lines), os.path.relpath(path, REPO), got, len(lines))
            )
    pct = 100.0 * covered / max(total, 1)
    worst.sort()
    for frac, path, got, n in worst[:10]:
        print(f"  {frac * 100:5.1f}%  {path} ({got}/{n})")
    print(
        f"coverage-gate: {pct:.1f}% of {total} executable lines "
        f"(floor {args.fail_under}%)"
    )
    if pct < args.fail_under:
        print("coverage-gate: FAIL — below the floor")
        return 2
    print("coverage-gate: OK")
    return 0


def _forget_package() -> None:
    """Drop the package's modules that ``python -m`` imported before
    :func:`main` started monitoring, so the tests import them afresh and
    their module-level lines count."""
    for name in [m for m in sys.modules if m.split(".")[0] == "mosaic_tpu_torch"]:
        del sys.modules[name]


if __name__ == "__main__":
    _forget_package()
    sys.exit(main())
