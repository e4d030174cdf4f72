"""The exact configuration's tiny twin on the CPU: ``pip_join``'s exact
lane (``exact_recheck: true``) answers every point as the float64
reference does, so the cell's limit, below one point of any run, holds;
the float32 lane, judged against the same limit, does not meet it. A
traced run reads the exact lane's counters and ranges, and the exact
readers' arithmetic holds on made-up counters and traces.

The tiny cell is asked of a copy of ``tests/tiny/BENCHMARK.json`` with
the exact configuration, cell and readers appended, as ``BENCHMARK.json``
appends them to the benchmark."""

import json
import os
import shutil
import time

import pytest
from conftest import TINY

from geobench import harness, run
from geobench import trace as T

CELL = "tiny_zones_exact.tiny_batch_curbside"
SEED = 2**31 + 29
READERS = {
    "idle_oracle_share.batch_exact": ("share", "exact recheck: f64 oracle"),
    "narrow_ms_per_mpt.batch_exact": ("ms/Mpt", "exact recheck: narrow re-join"),
    "oracle_row_share.batch_exact": ("share", "exact recheck"),
    "device_idle_share.batch_exact": ("share", "device"),
}


def exact_spec(d, exact_recheck=True):
    """Write the tiny benchmark with the exact cell appended under ``d``;
    returns the spec's path. ``exact_recheck=False`` puts the float32
    lane in the program's place."""
    shutil.copytree(os.path.join(TINY, "configs"), d / "configs")
    if not exact_recheck:
        path = d / "configs" / "tiny_zones_exact.json"
        conf = harness.read_json(str(path))
        conf["join"]["exact_recheck"] = False
        path.write_text(json.dumps(conf))
    spec = harness.read_json(os.path.join(TINY, "BENCHMARK.json"))
    spec["configs"].append({"name": "tiny_zones_exact",
                            "source": "https://github.com/databrickslabs/mosaic",
                            "file": "configs/tiny_zones_exact.json", "reduced": [],
                            "why": "tests"})
    spec["workloads"].append({"name": CELL, "config": "tiny_zones_exact",
                              "traffic": "tiny_batch_curbside", "chips": 1, "why": "tests"})
    for m in spec["end_to_end"]:
        if m["name"] == "join_points_per_s":
            m["workloads"].append(CELL)
    for name, (unit, layer) in READERS.items():
        spec["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                  "source": "device_trace", "layer": layer,
                                  "moves": "join_points_per_s", "workloads": [CELL]})
    (d / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(d / "BENCHMARK.json")


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return exact_spec(tmp_path_factory.mktemp("exact-spec"))


def go(spec, cache, capsys, trace=0):
    code = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5",
                     "--trace", str(trace)], device="cpu", spec_path=spec, base=TINY,
                    cache=cache, t0=time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    return code, out, json.loads(out[-1])


def test_exact_cell_meets_a_limit_below_one_point(spec_path, tiny_cache, capsys):
    code, out, r = go(spec_path, tiny_cache, capsys)
    assert code == 0
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["mismatch_share"] == {"value": 0.0, "limit": 1e-9}
    assert set(r["metrics"]) == {"setup_s", "join_points_per_s"}
    ref = [json.loads(ln)["reference"] for ln in out if ln.startswith('{"reference"')][0]
    # the partitions the window answered: one or both of the pool's two
    assert ref["points"] in (20000, 2 * 20000) and ref["mismatched"] == 0
    # a single wrong point of the run would fail the limit
    assert 1 / ref["points"] > r["checks"]["mismatch_share"]["limit"]


def test_float32_lane_fails_the_exact_limit(tmp_path, tiny_cache, capsys):
    code, _, r = go(exact_spec(tmp_path, exact_recheck=False), tiny_cache, capsys)
    assert code == 0
    assert r["correct"] is False
    share = r["checks"]["mismatch_share"]
    assert share["value"] > share["limit"] == 1e-9


def test_traced_exact_cell_reads_the_recheck(spec_path, tiny_cache, capsys):
    from mosaic_tpu_torch.obs import metrics

    # a run is a fresh process on the card: its counters start empty
    metrics.REGISTRY.reset()
    code, _, r = go(spec_path, tiny_cache, capsys, trace=1)
    assert code == 0
    assert r["correct"] is True
    m = r["metrics"]
    # no card: the device's idle share has no device op to read
    assert set(m) == {"idle_oracle_share.batch_exact", "narrow_ms_per_mpt.batch_exact",
                      "oracle_row_share.batch_exact"}
    for name, (unit, _) in READERS.items():
        if name in m:
            assert m[name]["unit"] == unit
    assert 0 < m["oracle_row_share.batch_exact"]["value"] < 1
    assert m["narrow_ms_per_mpt.batch_exact"]["value"] > 0
    assert 0 < m["idle_oracle_share.batch_exact"]["value"] <= 1
    band = metrics.REGISTRY.counter("join.recheck_rows").value(lane="band")
    oracle = metrics.REGISTRY.counter("join.recheck_rows").value(lane="oracle")
    assert band > 0 and oracle > 0
    metrics.REGISTRY.reset()


@pytest.mark.parametrize("cell", ["tiny_zones.tiny_batch", "tiny_zones.tiny_curbside"])
def test_exact_readers_are_silent_in_the_float32_cells(cell, tmp_path, tiny_cache, capsys):
    """Asked of a float32 cell, the exact readers find nothing to read."""
    from mosaic_tpu_torch.obs import metrics

    path = exact_spec(tmp_path)
    spec = harness.read_json(path)
    for m in spec["per_layer"]:
        if m["name"] in READERS:
            m["workloads"] = [cell]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    metrics.REGISTRY.reset()
    code = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.3",
                     "--trace", "1"], device="cpu", spec_path=path, base=TINY,
                    cache=tiny_cache, t0=time.perf_counter())
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and r["correct"] is True
    assert not set(r["metrics"]) & set(READERS)
    metrics.REGISTRY.reset()


def test_exact_cell_files_found_by_name(spec_path):
    spec = harness.read_json(spec_path)
    root = os.path.dirname(spec_path)
    cell = harness.Cell.find(spec, CELL, root=root, base=TINY)
    assert cell.config["join"]["exact_recheck"] is True
    assert cell.limits == {"mismatch_share": 1e-9}
    assert [m["name"] for m in cell.metrics("per_layer")] == list(READERS)


def test_exact_readers_divide_the_recheck_counters():
    from mosaic_tpu_torch.obs import metrics

    metrics.REGISTRY.reset()
    narrow = harness.reader("narrow_ms_per_mpt.batch_exact")
    rows = harness.reader("oracle_row_share.batch_exact")
    assert narrow.read(T.Trace()) is None and rows.read(T.Trace()) is None
    metrics.counter("trace.stage_device_seconds").inc(0.003, stage="join.pip.narrow")
    metrics.counter("trace.stage_points").inc(1_000_000, stage="join.pip.narrow")
    assert narrow.read(T.Trace()) == pytest.approx(3.0)
    # the points come from the cells stage, the rows from the oracle lane
    metrics.counter("trace.stage_points").inc(4_000_000, stage="join.pip.cells")
    assert rows.read(T.Trace()) is None
    metrics.counter("join.recheck_rows").inc(190_000, lane="band")
    assert rows.read(T.Trace()) is None
    metrics.counter("join.recheck_rows").inc(120_000, lane="oracle")
    assert rows.read(T.Trace()) == pytest.approx(0.03)
    metrics.REGISTRY.reset()


def test_exact_idle_readers_need_their_ranges(tmp_path):
    p = tmp_path / "t.json"
    events = [
        ("user_annotation", T.WINDOW, 0, 100),
        ("user_annotation", "join.pip", 0, 100),
        ("user_annotation", "join.pip.narrow", 10, 20),   # 10-30: busy
        ("user_annotation", "join.pip.oracle", 40, 50),   # 40-90: idle 40-90
        ("kernel", "k", 0, 40), ("kernel", "k", 90, 10),
    ]
    p.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": s, "dur": d} for c, n, s, d in events]}))
    tr = T.Trace(profile=T.read_chrome_trace(str(p)))
    oracle = harness.reader("idle_oracle_share.batch_exact")
    idle = harness.reader("device_idle_share.batch_exact")
    assert oracle.read(tr) == pytest.approx(0.50)
    assert idle.read(tr) == pytest.approx(0.50)
    assert oracle.read(T.Trace()) is None and idle.read(T.Trace()) is None
    no_ranges = T.Profile(window=(0, 100), device=[("k", 0, 10)], host_spans=[], host_ops=[])
    assert oracle.read(T.Trace(profile=no_ranges)) is None
    assert idle.read(T.Trace(profile=no_ranges)) == pytest.approx(0.90)
