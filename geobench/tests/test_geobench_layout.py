"""Every cell's files are found by name, and BENCHMARK.json keeps to the
shape the benchmark is held to."""

import json
import os
import re

import pytest

from geobench import harness

SPEC_PATH = os.path.join(harness.ROOT, "BENCHMARK.json")
SPEC = harness.read_json(SPEC_PATH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.Cell.find(SPEC, workload)
    assert cell.config["name"] == cell.workload["config"]
    assert callable(cell.driver().run)
    assert 0 < cell.limits["mismatch_share"] < 1
    for m in cell.metrics("per_layer"):
        assert callable(harness.reader(m["name"]).read)
    e2e = [m["name"] for m in cell.metrics("end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics("per_layer")


def test_configuration_entries_match_their_files():
    for c in SPEC["configs"]:
        f = harness.read_json(os.path.join(harness.ROOT, c["file"]))
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert c["file"].startswith("geobench/")


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["geobench"] and SPEC["command"][1] == "geobench/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(SPEC_PATH) < 64 * 1024
    cells = {w["name"] for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert {w["config"] for w in SPEC["workloads"]} == configs
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names + list(cells))
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    json.dumps(SPEC)


def test_metric_reader_by_name_or_stem():
    assert harness.reader("device_idle_share.stream") is not None
    assert harness.reader("device_idle_share.batch") is not None
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.stream")
