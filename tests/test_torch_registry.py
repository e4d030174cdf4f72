"""The port's registry: its committed golden
(`mosaic_tpu_torch/tools/goldens/registry.json`), the docs
(`docs/TORCH_ARCHITECTURE.md`) and the port's perf_gate golden agree with
what the port's code emits, and the port guards the reference's fault
sites — the invariant the port's `registry-drift` rule enforces, pinned
with explicit names so that a scanner finding nothing cannot pass as "no
drift"."""

import ast
import json
import os

from mosaic_tpu_torch.analysis import analyze, build_registry
from mosaic_tpu_torch.analysis.project_registry import (
    build_registry_from_modules,
    name_matches,
)
from mosaic_tpu_torch.analysis.rules.drift import span_table_names

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "mosaic_tpu_torch", "tools", "goldens")
CATEGORIES = ("fault_sites", "spans", "spans_tools", "events", "stages", "env_knobs")

#: the reference's knobs the port does not read, each a documented choice
NOT_CARRIED = {"MOSAIC_STREAM_NO_SEG_WARMUP", "MOSAIC_TPU_ALLOW_FMA", "MOSAIC_TPU_NO_X64"}


def load(path):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def arch_text():
    with open(os.path.join(ROOT, "docs", "TORCH_ARCHITECTURE.md"), encoding="utf-8") as f:
        return f.read()


def test_committed_registry_matches_fresh_scan():
    fresh = build_registry(ROOT)
    committed = load(os.path.join(GOLDENS, "registry.json"))
    for cat in CATEGORIES:
        assert committed[cat] == fresh[cat], f"stale category {cat!r}"


def test_fault_sites_are_the_references_25():
    port = load(os.path.join(GOLDENS, "registry.json"))
    ref = load(os.path.join(ROOT, "tests", "goldens", "registry.json"))
    assert port["fault_sites"] == ref["fault_sites"]
    assert len(port["fault_sites"]) == 25


def test_env_knobs_are_the_references_less_the_documented_ones():
    port = set(load(os.path.join(GOLDENS, "registry.json"))["env_knobs"])
    ref = set(load(os.path.join(ROOT, "tests", "goldens", "registry.json"))["env_knobs"])
    assert "MOSAIC_RETRY_SEED" in port
    missing = ref - port
    assert {k for k in missing if not k.startswith("MOSAIC_BENCH_")} == NOT_CARRIED
    text = arch_text()
    for knob in NOT_CARRIED:
        assert knob in text


def test_known_names_are_registered():
    reg = load(os.path.join(GOLDENS, "registry.json"))
    assert "join.probe.*" in reg["spans"]
    assert "MOSAIC_WATCHDOG_*" in reg["env_knobs"]
    assert "MOSAIC_TUNE_*" in reg["env_knobs"]
    assert "chaos_sweep" in reg["spans_tools"]
    assert "chaos_site" in reg["events"]
    assert "serve_stage.dispatch" in reg["stages"]


def test_library_and_tool_spans_are_kept_apart():
    def mod(src):
        return ast.parse(src)

    span = "from x import obs\nobs.start_span({!r})\n"
    reg = build_registry_from_modules([
        ("mosaic_tpu_torch/a.py", mod(span.format("lib.span"))),
        ("mosaic_tpu_torch/tools/t.py", mod(span.format("tool.span"))),
        ("chip_smoke.py", mod(span.format("smoke.span"))),
        ("tests/test_torch_x.py", mod(span.format("test.span"))),
    ])
    assert reg["spans"] == ["lib.span"]
    assert reg["spans_tools"] == ["smoke.span", "tool.span"]


def test_span_taxonomy_table_matches_code_both_ways():
    reg = load(os.path.join(GOLDENS, "registry.json"))
    table = span_table_names(arch_text())
    assert len(table) >= 30, "span table parse came back near-empty"
    for row in table:
        assert name_matches(row, reg["spans"]), f"stale table row {row!r}"
    for span in reg["spans"]:
        if span.endswith("*"):
            assert any(name_matches(row, [span]) for row in table), span
        else:
            assert span in table, f"span {span!r} missing from the table"


def test_knobs_and_fault_sites_are_documented_in_the_ports_page():
    reg = load(os.path.join(GOLDENS, "registry.json"))
    text = arch_text()
    for knob in reg["env_knobs"]:
        assert knob.rstrip("*") in text, knob
    for site in reg["fault_sites"]:
        assert f"| `{site}` |" in text, site


def test_perf_gate_stages_are_registered_names():
    reg = load(os.path.join(GOLDENS, "registry.json"))
    known = reg["stages"] + reg["events"] + reg["spans"] + reg["spans_tools"]
    gate = load(os.path.join(GOLDENS, "perf_gate.json"))
    assert gate["stages"], "perf_gate golden has no stages"
    for stage in sorted(gate["stages"]):
        assert name_matches(stage, known), f"unregistered gate stage {stage}"


def test_registry_drift_rule_is_green_on_the_repo():
    res = analyze(ROOT, rule_names=["registry-drift"])
    assert res.findings == [], [f.render() for f in res.findings]


def test_registry_drift_finds_a_stale_golden_and_an_undocumented_knob(tmp_path):
    lib = tmp_path / "mosaic_tpu_torch"
    (lib / "tools" / "goldens").mkdir(parents=True)
    (lib / "m.py").write_text(
        "import os\nfrom .runtime import faults\n"
        "def f():\n    faults.maybe_fail('made.up')\n"
        "    return os.environ.get('MOSAIC_MADE_UP')\n")
    (lib / "tools" / "goldens" / "registry.json").write_text(json.dumps(
        {c: [] for c in CATEGORIES}))
    msgs = [f.message for f in analyze(str(tmp_path), rule_names=["registry-drift"]).findings]
    assert any("'fault_sites' is stale" in m for m in msgs)
    assert any("'MOSAIC_MADE_UP'" in m and "undocumented" in m for m in msgs)
    assert any("'made.up' is undocumented" in m for m in msgs)
