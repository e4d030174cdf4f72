"""``run.py`` on a tiny cell on the CPU: the shape of the last line, the
checks beside their limits, the set-up split; and no result without a
card or without the program."""

import json
import os
import shutil
import subprocess
import sys

from geobench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def last(lines):
    return json.loads(lines[-1])


def test_stream_result_line(run_tiny):
    code, out, err = run_tiny("tiny_zones.tiny_stream")
    assert code == 0
    r = last(out)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] % 2 == 0
    assert set(r["metrics"]) == {"setup_s", "stream_points_per_s"}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert set(r["checks"]) == {"fold_runs_differing", "overflow_points", "mismatch_share"}
    # the numbers compared are the last lines of stderr, each beside its limit
    tail = err[-len(r["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(r["checks"])
    assert all(" limit " in ln for ln in tail)
    setup = [json.loads(ln)["setup"] for ln in out if ln.startswith('{"setup"')][0]
    assert {"imports_s", "index_s", "data_s", "warm_s", "total_s"} <= set(setup)


def test_traced_batch_result_line(run_tiny):
    code, out, _ = run_tiny("tiny_zones.tiny_batch", trace=1)
    assert code == 0
    r = last(out)
    assert r["correct"] is True and list(r)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card: nothing for the device readers, and too few calls for a p90
    assert r["metrics"] == {}
    assert any(ln.startswith('{"probe_route"') for ln in out)


def test_no_card_no_result(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                        "taxi_zones_r9.stream_pickups", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_only_the_benchmark_no_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "geobench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = subprocess.run([sys.executable, str(tmp_path / "geobench" / "run.py"), "--workload",
                        "taxi_zones_r9.stream_pickups", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_loaded_jax_refuses_the_result(run_tiny, monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code, out, err = run_tiny("tiny_zones.tiny_stream")
    assert code == 3 and not any(ln.startswith('{"correct"') for ln in out)
    assert "jax" in err[-1]
