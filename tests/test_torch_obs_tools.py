"""The port's ops plane against the reference's, on real trails, and the
port's tools against the reference's tools.

Each package runs the same small workloads on the CPU — a ``pip_join``, a
durable ``StreamJoin.run_durable`` and a ``ServeEngine`` loop over the
custom grid ``(-180, 180, -90, 90, 2, 10, 10)`` at resolution 3, on the
same numpy points (seed 0) — and writes its trails with its own
``write_jsonl``. Every trail (both packages', and a seeded synthetic one)
then goes through both packages, which must agree exactly:
``trace_summary``, ``timeline.attribute``, ``chrome_trace``,
``evaluate_trail``, and the Prometheus text of the same events folded by
each bridge (byte-equal). Each tool's last JSON line, the port's
``python -m mosaic_tpu_torch.tools.<name>`` against the reference's
``tools/<name>.py``, must be equal on the same files. The events of each
port entry point round-trip through ``write_jsonl`` and ``read_trail``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mosaic_tpu import obs as ref_obs
from mosaic_tpu.obs import metrics as ref_metrics
from mosaic_tpu.obs import slo as ref_slo
from mosaic_tpu.obs import timeline as ref_timeline
from mosaic_tpu_torch import obs
from mosaic_tpu_torch.obs import metrics as obs_metrics
from mosaic_tpu_torch.obs import slo, timeline
from mosaic_tpu_torch.runtime import telemetry
from torch_obs_fixtures import reset_port_plane, synthetic_trail

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO / "tools"))

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
BBOX = (-25.0, -25.0, 35.0, 20.0)
RES = 3
ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))",
    "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
    "POLYGON ((20 -10, 30 -10, 30 5, 20 5, 20 -10))",
]
KINDS = ("pip_join", "stream", "serve")


def _port_col(col):
    from mosaic_tpu_torch.core.types import PackedGeometry

    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def _inputs():
    rng = np.random.default_rng(0)
    pts = rng.uniform(BBOX[:2], BBOX[2:], (2048, 2))
    ring = [rng.uniform(BBOX[:2], BBOX[2:], (1024, 2)) for _ in range(3)]
    reqs = [rng.uniform(BBOX[:2], BBOX[2:], (int(n), 2))
            for n in rng.integers(1, 200, 12)]
    return pts, ring, reqs


def _port_trails(run_dir):
    from mosaic_tpu.core.geometry import wkt
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.serve import BucketLadder, ServeEngine
    from mosaic_tpu_torch.sql.join import build_chip_index, pip_join
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

    grid = CustomIndexSystem(GridConf(*CONF))
    ix = build_chip_index(tessellate(_port_col(wkt.from_wkt(ZONES)), grid, RES,
                                     keep_core_geoms=False), device="cpu")
    pts, ring, reqs = _inputs()
    out = {}
    with telemetry.capture() as out["pip_join"]:
        pip_join(pts, None, grid, RES, chip_index=ix, device="cpu")
    sj = StreamJoin(ix, grid, RES)
    r = ring_from_host(ring, device="cpu")
    with telemetry.capture() as out["stream"]:
        sj.run_durable(r, 6, run_dir=str(run_dir), snapshot_every=2)
    with ServeEngine(ix, grid, RES, ladder=BucketLadder(64, 256), bounds=BBOX,
                     max_wait_s=0.01) as eng:
        eng.warmup()
        with telemetry.capture() as out["serve"]:
            for f in [eng.submit(q, deadline_s=30.0) for q in reqs]:
                f.result(timeout=30)
    return out


def _ref_trails(run_dir):
    from mosaic_tpu.core.geometry import wkt
    from mosaic_tpu.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu.core.tessellate import tessellate
    from mosaic_tpu.runtime import telemetry as ref_telemetry
    from mosaic_tpu.serve import BucketLadder, ServeEngine
    from mosaic_tpu.sql.join import build_chip_index, pip_join
    from mosaic_tpu.sql.stream import StreamJoin, ring_from_host

    grid = CustomIndexSystem(GridConf(*CONF))
    ix = build_chip_index(tessellate(wkt.from_wkt(ZONES), grid, RES,
                                     keep_core_geoms=False))
    pts, ring, reqs = _inputs()
    out = {}
    with ref_telemetry.capture() as out["pip_join"]:
        pip_join(pts, None, grid, RES, chip_index=ix)
    sj = StreamJoin(ix, grid, RES)
    r = ring_from_host(ring)
    with ref_telemetry.capture() as out["stream"]:
        sj.run_durable(r, 6, run_dir=str(run_dir), snapshot_every=2)
    with ServeEngine(ix, grid, RES, ladder=BucketLadder(64, 256), bounds=BBOX,
                     max_wait_s=0.01) as eng:
        eng.warmup()
        with ref_telemetry.capture() as out["serve"]:
            for f in [eng.submit(q, deadline_s=120.0) for q in reqs]:
                f.result(timeout=120)
    return out


@pytest.fixture(scope="module")
def trails(tmp_path_factory):
    """{(package, kind): (events, path)}: each package's runs, written by
    its own ``write_jsonl``; plus ``("synthetic", "synthetic")``."""
    d = tmp_path_factory.mktemp("trails")
    out = {}
    for pkg, run, writer in (("port", _port_trails, obs),
                             ("reference", _ref_trails, ref_obs)):
        for kind, events in run(d / f"{pkg}_run").items():
            path = str(d / f"{pkg}_{kind}.jsonl")
            writer.write_jsonl(events, path)
            out[(pkg, kind)] = (events, path)
    syn = synthetic_trail(seed=11)
    path = str(d / "synthetic.jsonl")
    obs.write_jsonl(syn, path)
    out[("synthetic", "synthetic")] = (syn, path)
    return out


TRAILS = [(p, k) for p in ("port", "reference") for k in KINDS] + [
    ("synthetic", "synthetic")]


@pytest.fixture(autouse=True)
def _fresh_plane():
    reset_port_plane()
    yield


def test_port_workloads_emit_the_reference_spans_and_stages(trails):
    """Both packages' runs give the same span names and stage keys (the
    names every tool and gate reads)."""
    from mosaic_tpu_torch.tools.trace_report import stage_key

    for kind in KINDS:
        port, ref = trails[("port", kind)][0], trails[("reference", kind)][0]
        keys = lambda evs: {stage_key(e) for e in evs} - {None}  # noqa: E731
        names = lambda evs: {e["name"] for e in evs if e["event"] == "span"}  # noqa: E731
        assert keys(port) <= keys(ref) | {"dispatch_stage.warmup"}, kind
        assert names(port) & names(ref), kind


@pytest.mark.parametrize("key", TRAILS, ids=lambda k: "-".join(k))
def test_trail_reads_back_equal_in_both_packages(trails, key):
    events, path = trails[key]
    port_rows, ref_rows = obs.read_trail(path), ref_obs.read_trail(path)
    assert port_rows == ref_rows
    assert port_rows[0]["event"] == "incarnation"
    assert port_rows[1:] == json.loads(json.dumps(events))


@pytest.mark.parametrize("key", TRAILS, ids=lambda k: "-".join(k))
def test_views_equal_the_reference(trails, key):
    events = obs.read_trail(trails[key][1])
    assert obs.trace_summary(events) == ref_obs.trace_summary(events)
    port_attr = timeline.attribute(events)
    assert port_attr == ref_timeline.attribute(events)
    if port_attr is not None:
        assert sum(c["seconds"] for c in port_attr["classes"].values()) \
            == pytest.approx(port_attr["wall_s"], rel=1e-6)
    assert obs.chrome_trace(events) == ref_obs.chrome_trace(events)
    with telemetry.capture():
        port_slo = slo.evaluate_trail(events)
    assert port_slo == ref_slo.evaluate_trail(events)


@pytest.mark.parametrize("key", TRAILS, ids=lambda k: "-".join(k))
def test_bridged_prometheus_text_is_byte_equal(trails, key, monkeypatch):
    events = obs.read_trail(trails[key][1])
    monkeypatch.setattr(obs_metrics, "REGISTRY", obs_metrics.Registry())
    monkeypatch.setattr(ref_metrics, "REGISTRY", ref_metrics.Registry())
    for e in events:
        obs_metrics._on_event(e)
        ref_metrics._on_event(e)
    assert obs.prometheus_text() == ref_obs.prometheus_text()


def test_serve_trail_counts_every_request(trails):
    """The bridge over the port's serve trail: one
    ``serve.requests_completed`` and one ``serve.request_seconds``
    observation a request, no cold compile."""
    events = trails[("port", "serve")][0]
    n = sum(e["event"] == "serve_request" for e in events)
    assert n == len(_inputs()[2])
    for e in events:
        obs_metrics._on_event(e)
    snap = obs.snapshot()
    assert snap["serve.requests_completed"]["series"][0]["value"] == n
    assert snap["serve.request_seconds"]["series"][0]["value"]["count"] == n
    assert "obs.compile_count" not in snap


# ------------------------------------------------------------------ tools


def _last_line(out: str):
    lines = out.strip().splitlines()
    return json.loads(lines[-1]) if lines else None


def _port_cli(tool, *args):
    """``python -m mosaic_tpu_torch.tools.<tool> args``: (exit code, last
    stdout line parsed, or None)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", f"mosaic_tpu_torch.tools.{tool}", *args],
        capture_output=True, text=True, cwd=str(REPO), env=env, timeout=300,
    )
    return proc.returncode, _last_line(proc.stdout)


def _port_main(tool, capsys, *args):
    """The port tool's ``main(args)`` in this process (what ``python -m``
    runs): (exit code, last stdout line parsed, or None)."""
    import importlib

    mod = importlib.import_module(f"mosaic_tpu_torch.tools.{tool}")
    capsys.readouterr()
    rc = mod.main(list(args))
    return rc or 0, _last_line(capsys.readouterr().out)


def _ref_cli(tool, capsys, monkeypatch, *args):
    """The reference's ``tools/<tool>.py`` main on ``args`` in this
    process: (exit code, last stdout line parsed, or None)."""
    import importlib

    mod = importlib.import_module(tool)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{tool}.py", *args])
    rc = mod.main()
    return rc or 0, _last_line(capsys.readouterr().out)


def test_trace_report_cli_equals_the_reference(trails, capsys, monkeypatch):
    fresh, base = trails[("port", "stream")][1], trails[("reference", "stream")][1]
    assert _port_cli("trace_report", fresh) == _ref_cli(
        "trace_report", capsys, monkeypatch, fresh)
    for args in ([fresh, "--against", base],
                 ["--fleet", fresh, trails[("port", "serve")][1]]):
        assert _port_main("trace_report", capsys, *args) == _ref_cli(
            "trace_report", capsys, monkeypatch, *args)


def test_stall_report_cli_equals_the_reference(trails, capsys, monkeypatch):
    t, base = trails[("port", "stream")][1], trails[("reference", "stream")][1]
    port = _port_cli("stall_report", t)
    assert port == _ref_cli("stall_report", capsys, monkeypatch, t)
    assert port[0] == 0 and port[1]["sum_ok"] is True
    for args in ([t, "--against", base],
                 [t, "--inject-slowdown", "span.stream.snapshot:10"],
                 [trails[("port", "pip_join")][1]]):
        assert _port_main("stall_report", capsys, *args) == _ref_cli(
            "stall_report", capsys, monkeypatch, *args)


def test_perf_gate_cli_equals_the_reference(trails, tmp_path, capsys, monkeypatch):
    golden = str(tmp_path / "golden.json")
    port_trails = ["--trail", trails[("port", "stream")][1],
                   "--trail", trails[("port", "serve")][1]]
    ref_trails = ["--trail", trails[("reference", "stream")][1],
                  "--trail", trails[("reference", "serve")][1]]
    update = ["--update", "--golden", golden, *port_trails]
    rc, ref_line = _ref_cli("perf_gate", capsys, monkeypatch, *update)
    with open(golden) as f:
        ref_golden = json.load(f)
    assert _port_main("perf_gate", capsys, *update) == (rc, ref_line)
    with open(golden) as f:
        port_golden = json.load(f)
    assert port_golden.pop("note") != ref_golden.pop("note")
    assert port_golden == ref_golden
    top = max(port_golden["stages"], key=lambda k: port_golden["stages"][k]["odds"])
    red = ["--golden", golden, *port_trails, "--inject-slowdown", f"{top}:10"]
    port = _port_cli("perf_gate", *red)
    assert port == _ref_cli("perf_gate", capsys, monkeypatch, *red)
    assert port[0] == 1 and port[1]["pass"] is False
    for args in (["--golden", golden, *port_trails],
                 ["--golden", golden, *ref_trails, "--tolerance", "100"],
                 ["--golden", golden, *port_trails, "--inject-slowdown", "nope:10"],
                 ["--golden", golden, *port_trails, "--stages-prefix", "nope"]):
        assert _port_main("perf_gate", capsys, *args) == _ref_cli(
            "perf_gate", capsys, monkeypatch, *args)


def test_fleet_report_cli_equals_the_reference(trails, tmp_path, capsys, monkeypatch):
    paths = [trails[(p, k)][1] for p in ("port", "reference") for k in KINDS]
    out = str(tmp_path / "merged.jsonl")
    port = _port_cli("fleet_report", *paths, "--out", out)
    merged_port = obs.read_trail(out)
    assert port == _ref_cli("fleet_report", capsys, monkeypatch, *paths, "--out", out)
    assert obs.read_trail(out) == merged_port
    assert port[1]["incarnations"] == 2
    walls = [e["ts_wall"] for e in merged_port if "ts_wall" in e]
    assert walls == sorted(walls)


def test_doctor_cli_equals_the_reference(trails, tmp_path, capsys, monkeypatch):
    paths = [trails[(p, k)][1] for p in ("port", "reference") for k in KINDS]
    port = _port_cli("doctor", *paths)
    assert port == _ref_cli("doctor", capsys, monkeypatch, *paths)
    assert port[0] == 0 and port[1]["status"] == "green"
    # the synthetic trail carries a serve_compile and an slo_violation
    paths.append(trails[("synthetic", "synthetic")][1])
    port = _port_main("doctor", capsys, *paths)
    assert port == _ref_cli("doctor", capsys, monkeypatch, *paths)
    assert port[0] == 1
    assert {"cold_compiles", "burn_rate"} <= set(port[1]["red_checks"])


# ------------------------------------------------- JSON-clean entry points


def _roundtrip(events, tmp_path, name):
    p = str(tmp_path / f"{name}.jsonl")
    obs.write_jsonl(events, p)
    assert obs.read_trail(p)[1:] == events, name


def test_entry_point_events_round_trip(trails, tmp_path):
    """Every event of the port's entry points on the CPU is plain JSON:
    a trail written and read back equals the live events (no tuple, no
    torch object, no non-string key)."""
    from mosaic_tpu.core.geometry import wkt
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.index import EpochalIndex
    from mosaic_tpu_torch.knn import KNNFrontend, build_knn_index
    from mosaic_tpu_torch.raster import Raster, ZonalEngine
    from mosaic_tpu_torch.sql.join import build_chip_index

    for kind in KINDS:
        _roundtrip(trails[("port", kind)][0], tmp_path, kind)
    grid = CustomIndexSystem(GridConf(*CONF))
    col = _port_col(wkt.from_wkt(ZONES))
    ix = build_chip_index(tessellate(col, grid, RES, keep_core_geoms=False),
                          device="cpu")
    rng = np.random.default_rng(1)
    raster = Raster(data=rng.uniform(0, 100, (1, 40, 50)),
                    gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0), srid=0, nodata=None)
    with telemetry.capture() as ev:
        ZonalEngine(grid, RES, chip_index=ix, device="cpu").zones(raster, tile=(32, 32))
    _roundtrip(ev, tmp_path, "zonal")
    polys = [f"POLYGON(({x} {y}, {x + 1} {y}, {x + 1} {y + 1}, {x} {y + 1}, {x} {y}))"
             for x, y in rng.uniform((-20, -20), (30, 15), (40, 2))]
    kx = build_knn_index(_port_col(wkt.from_wkt(polys)), grid, RES, device="cpu")
    with telemetry.capture() as ev:
        KNNFrontend(kx, lane="ring").dispatch(rng.uniform((-10, -10), (10, 10), (8, 2)), 3)
    _roundtrip(ev, tmp_path, "knn")
    with telemetry.capture() as ev:
        ep = EpochalIndex(col, grid, RES, keep_core_geoms=False, device="cpu",
                          log_dir=str(tmp_path / "log"))
        ep.publish()
        ep.apply(upsert=_port_col(wkt.from_wkt(
            ["POLYGON ((-22 -22, -4 -22, -4 -4, -22 -4, -22 -22))"])), ids=[1])
        ep.publish()
    _roundtrip(ev, tmp_path, "epoch")
