"""The four readers of the program's stage spans and counters
(``loop_cells_ms_per_mpt``, ``loop_probe_ms_per_mpt``,
``idle_h2d_share``, ``idle_prepare_share``): through ``run.py --trace 1``
on the tiny CPU cells, each reads a number in the cells whose traffic
runs its stages and nothing in the others; and their arithmetic on
made-up traces."""

import json
import os
import shutil
import time

import pytest

from geobench import harness
from geobench import trace as T

from conftest import TINY

#: the four metrics, each with the tiny cells whose traffic runs its stages
STAGE_METRICS = {
    "loop_cells_ms_per_mpt.stream": ("ms/Mpt", "cell assignment", "stream_points_per_s",
                                     ("tiny_zones.tiny_stream", "tiny_zones.tiny_curbside")),
    "loop_probe_ms_per_mpt.stream": ("ms/Mpt", "probe", "stream_points_per_s",
                                     ("tiny_zones.tiny_stream", "tiny_zones.tiny_curbside")),
    "idle_h2d_share.batch": ("share", "host entry", "join_points_per_s",
                             ("tiny_zones.tiny_batch",)),
    "idle_prepare_share.batch": ("share", "host entry", "join_points_per_s",
                                 ("tiny_zones.tiny_batch",)),
}
CELLS = ("tiny_zones.tiny_stream", "tiny_zones.tiny_batch", "tiny_zones.tiny_curbside")


@pytest.fixture(scope="module")
def stage_spec(tmp_path_factory):
    """The tiny benchmark with the four metrics asked of every tiny cell,
    so that the harness calls each reader everywhere."""
    d = tmp_path_factory.mktemp("stage-spec")
    shutil.copytree(os.path.join(TINY, "configs"), d / "configs")
    spec = harness.read_json(os.path.join(TINY, "BENCHMARK.json"))
    e2e = {m["name"]: m.get("workloads", list(CELLS)) for m in spec["end_to_end"]}
    for name, (unit, layer, moves, _) in STAGE_METRICS.items():
        spec["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                  "source": "device_trace", "layer": layer, "moves": moves,
                                  "workloads": list(CELLS)})
        assert set(e2e[moves]) <= set(CELLS)
    (d / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(d / "BENCHMARK.json")


@pytest.mark.parametrize("cell", CELLS)
def test_stage_readers_in_traced_tiny_cells(cell, stage_spec, tiny_cache, capsys):
    from mosaic_tpu_torch.obs import metrics

    from geobench import run

    # a run is a fresh process on the card: its counters start empty
    metrics.REGISTRY.reset()
    code = run.main(["--workload", cell, "--seed", str(2**31 + 23), "--seconds", "0.3",
                     "--trace", "1"], device="cpu", spec_path=stage_spec, base=TINY,
                    cache=tiny_cache, t0=time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    assert code == 0
    r = json.loads(out[-1])
    assert r["correct"] is True
    for name, (unit, _, _, cells) in STAGE_METRICS.items():
        if cell in cells:
            assert r["metrics"][name]["unit"] == unit
            assert r["metrics"][name]["value"] >= 0
        else:
            assert name not in r["metrics"]
    if cell == "tiny_zones.tiny_batch":
        assert (r["metrics"]["idle_h2d_share.batch"]["value"]
                + r["metrics"]["idle_prepare_share.batch"]["value"]) <= 1.0
    else:
        assert r["metrics"]["loop_cells_ms_per_mpt.stream"]["value"] > 0
        assert r["metrics"]["loop_probe_ms_per_mpt.stream"]["value"] > 0


def test_loop_readers_divide_the_stage_counters():
    from mosaic_tpu_torch.obs import metrics

    metrics.REGISTRY.reset()
    cells = harness.reader("loop_cells_ms_per_mpt.stream")
    probe = harness.reader("loop_probe_ms_per_mpt.stream")
    assert cells.read(T.Trace()) is None and probe.read(T.Trace()) is None
    metrics.counter("trace.stage_device_seconds").inc(0.004, stage="stream.assign")
    metrics.counter("trace.stage_points").inc(2_000_000, stage="stream.assign")
    assert cells.read(T.Trace()) == pytest.approx(2.0)
    assert probe.read(T.Trace()) is None
    metrics.counter("trace.stage_device_seconds").inc(0.006, stage="stream.join")
    metrics.counter("trace.stage_points").inc(1_000_000, stage="stream.join")
    assert probe.read(T.Trace()) == pytest.approx(6.0)
    metrics.REGISTRY.reset()


def test_idle_shares_count_the_overlap_of_gaps_and_ranges(tmp_path):
    p = tmp_path / "t.json"
    events = [
        ("user_annotation", T.WINDOW, 0, 100),
        ("user_annotation", "batch.call", 0, 100),
        ("user_annotation", "join.pip.h2d", 5, 20),      # 5-25: idle 10-20
        ("user_annotation", "join.pip.prepare", 30, 40),  # 30-70: idle 40-60
        ("user_annotation", "join.pip.h2d", 70, 40),     # 70-110, clipped: idle 90-100
        ("kernel", "k", 0, 10), ("gpu_memcpy", "Memcpy HtoD", 20, 20),
        ("kernel", "k", 60, 30),
    ]
    p.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": s, "dur": d} for c, n, s, d in events]}))
    prof = T.read_chrome_trace(str(p))
    assert prof.gaps() == [(10, 20), (40, 60), (90, 100)]
    tr = T.Trace(profile=prof)
    h2d = harness.reader("idle_h2d_share.batch")
    prep = harness.reader("idle_prepare_share.batch")
    assert h2d.read(tr) == pytest.approx(0.20)
    assert prep.read(tr) == pytest.approx(0.20)
    # the gap 40-60 began inside no stage range's start, but is counted
    assert prof.idle_gaps()[0][0] == "join.pip.prepare"
    assert h2d.read(T.Trace()) is None
    no_ranges = T.Profile(window=(0, 100), device=[], host_spans=[], host_ops=[])
    assert h2d.read(T.Trace(profile=no_ranges)) is None
