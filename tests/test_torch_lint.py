"""The port's lint driver (`python -m mosaic_tpu_torch.tools.lint`): the
reference driver's flags and JSON last line, exit 0 on the tree, exit 1
on an injected violation, and a baseline that holds no purity finding."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from mosaic_tpu_torch.tools import lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "mosaic_tpu_torch", "tools", "goldens", "lint_baseline.json")


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def run_main(capsys, *argv):
    rc = lint.main(list(argv))
    return rc, capsys.readouterr().out


def test_the_module_entry_is_clean_on_the_tree():
    r = subprocess.run([sys.executable, "-m", "mosaic_tpu_torch.tools.lint"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = last_json(r.stdout)
    assert summary["tool"] == "mosaic-lint" and summary["clean"] is True
    assert summary["findings"] == 0 and summary["stale_baseline"] == []
    assert summary["rules_run"] == 12 and summary["files"] > 150


def test_json_only_prints_one_line(capsys):
    rc, out = run_main(capsys, "--json-only")
    assert rc == 0 and len(out.strip().splitlines()) == 1
    assert set(last_json(out)) == {
        "tool", "files", "rules_run", "findings", "baselined", "suppressed",
        "stale_baseline", "rules", "clean"}


def test_list_rules(capsys):
    rc, out = run_main(capsys, "--list-rules")
    assert rc == 0
    rules = last_json(out)["rules"]
    assert {"capture-purity", "env-read-after-staging", "dispatch-adoption",
            "registry-drift", "broad-except"} <= set(rules)
    assert "capture-purity" in out.splitlines()[0] or any(
        ln.startswith("capture-purity") for ln in out.splitlines())


@pytest.mark.parametrize("rule, src", [
    ("unbounded-cache", """\
        import functools

        @functools.lru_cache(maxsize=None)
        def f(x):
            return x
        """),
    ("capture-purity", """\
        import torch

        def f(g, x):
            with torch.cuda.graph(g):
                return x.sum().item()
        """),
])
def test_an_injected_violation_turns_the_gate_red(tmp_path, capsys, rule, src):
    p = tmp_path / "mosaic_tpu_torch" / "bad.py"
    p.parent.mkdir(parents=True)
    p.write_text(textwrap.dedent(src))
    rc, out = run_main(capsys, "--root", str(tmp_path), "--rule", rule)
    assert rc == 1, out
    summary = last_json(out)
    assert summary["clean"] is False and summary["rules"] == {rule: 1}
    assert "mosaic_tpu_torch/bad.py" in out


def test_update_baseline_and_registry_on_a_copy(tmp_path, capsys):
    lib = tmp_path / "mosaic_tpu_torch"
    (lib / "tools" / "goldens").mkdir(parents=True)
    (lib / "m.py").write_text(
        "import os\nfrom .runtime import faults\n\n\ndef f():\n"
        "    faults.maybe_fail('made.up')\n    return 1\n")
    base = str(tmp_path / "b.json")
    rc, out = run_main(capsys, "--root", str(tmp_path), "--update-registry")
    assert rc == 0 and last_json(out)["fault_sites"] == 1
    with open(lib / "tools" / "goldens" / "registry.json") as f:
        assert json.load(f)["fault_sites"] == ["made.up"]
    rc, out = run_main(capsys, "--root", str(tmp_path), "--rule", "unused-import")
    assert rc == 1
    rc, out = run_main(capsys, "--root", str(tmp_path), "--rule", "unused-import",
                       "--update-baseline", "--baseline", base)
    assert rc == 0 and last_json(out)["entries"] == 1
    rc, out = run_main(capsys, "--root", str(tmp_path), "--rule", "unused-import",
                       "--baseline", base)
    assert rc == 0 and last_json(out)["baselined"] == 1
    (lib / "m.py").write_text("from .runtime import faults\n\n\n"
                              "def f():\n    faults.maybe_fail('made.up')\n")
    rc, out = run_main(capsys, "--root", str(tmp_path), "--baseline", base,
                       "--rule", "unused-import", "--rule", "syntax")
    assert rc == 0  # a rule-filtered run never reports the baseline stale


def test_the_committed_baseline_holds_no_purity_finding():
    with open(BASELINE) as f:
        data = json.load(f)
    keys = list(data["findings"])
    assert not [k for k in keys if k.split("::")[0] in (
        "capture-purity", "env-read-after-staging")]
    assert keys == []
    assert "mosaic_tpu_torch.tools.lint" in data["note"]
