"""The trace's arithmetic and the per-layer readers, on made-up traces;
and the heavy kernel's work count against a count made point by point."""

import json

import numpy as np
import torch

from geobench import harness, roofline
from geobench import trace as T


def chrome(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": s, "dur": d} for c, n, s, d in events]}))
    return T.read_chrome_trace(str(p))


def test_busy_gaps_and_breakdown(tmp_path):
    prof = chrome(tmp_path, [
        ("user_annotation", T.WINDOW, 0, 100),
        ("user_annotation", "stream.run", 0, 60),
        ("cpu_op", "aten::copy_", 40, 10),
        ("kernel", "k_a", 10, 20), ("kernel", "k_b", 20, 20),  # overlap: busy 10-40
        ("gpu_memcpy", "Memcpy HtoD", 45, 5),
        ("kernel", "k_a", 90, 20),  # runs past the window's end
    ])
    assert prof.window_s == 100e-6
    assert abs(prof.busy_s() - 45e-6) < 1e-12
    assert prof.gaps() == [(0, 10), (40, 45), (50, 90)]
    assert prof.idle_gaps() == [["stream.run", 40e-6], ["stream.run", 10e-6],
                                ["stream.run / aten::copy_", 5e-6]]
    assert prof.device_ops()[0] == ["k_a", 40e-6]
    tr = T.Trace(profile=prof)
    assert abs(harness.reader("device_idle_share.stream").read(tr) - 0.55) < 1e-9


def test_readers_return_nothing_without_data():
    empty = T.Trace()
    for name in ("call_p90_ms.batch", "cells_ms_per_mpt.stream", "probe_ms_per_mpt.stream",
                 "device_idle_share.stream", "pip_heavy_tiled_roofline.stream"):
        assert harness.reader(name).read(empty) is None


def test_call_p90_needs_ten_calls_beyond_it():
    p90 = harness.reader("call_p90_ms.batch")
    calls = [{"name": "batch.call", "seconds": s / 1000, "points": 1, "clock": "host"}
             for s in range(1, 101)]
    assert p90.read(T.Trace(spans=calls)) == 90.0
    assert p90.read(T.Trace(spans=calls[:99])) is None


def test_roofline_reader_needs_matching_launches(tmp_path):
    prof = chrome(tmp_path, [("user_annotation", T.WINDOW, 0, 100),
                             ("kernel", "pip_heavy_kernel(x)", 0, 10),
                             ("kernel", "pip_heavy_hist_kernel", 10, 10)])
    work = {"bytes": roofline.PEAK_BYTES * 5e-6, "ops": 0, "launches": 1}
    r = harness.reader("pip_heavy_tiled_roofline.stream")
    assert abs(r.read(T.Trace(profile=prof, work={"pip_heavy_tiled": work})) - 25.0) < 1e-9
    work["launches"] = 2
    assert r.read(T.Trace(profile=prof, work={"pip_heavy_tiled": work})) is None


def test_heavy_work_counts_what_the_points_need():
    g = torch.Generator().manual_seed(1)
    H, E2, M2 = 5, 8, 3
    edges = torch.rand((H, E2, 4), generator=g, dtype=torch.float32)
    ebits = (torch.rand((H, E2), generator=g) > 0.3).to(torch.int32)
    f = {"heavy_edges": edges, "heavy_ebits": ebits,
         "heavy_slot_geom": torch.zeros((H, M2), dtype=torch.int32),
         "border.shift": torch.tensor([0.0, 0.0], dtype=torch.float64)}
    pts = torch.rand((50, 2), generator=g, dtype=torch.float64)
    row = torch.randint(-1, 3, (50,), generator=g)
    w = roofline.heavy_work(pts, row, f)
    real = cross = 0
    for p, r in zip(pts.numpy(), row.numpy()):
        if r < 0:
            continue
        for e, b in zip(edges[r].numpy(), ebits[r].numpy()):
            if b:
                real += 1
                cross += (e[1] > np.float32(p[1])) != (e[3] > np.float32(p[1]))
    touched = len(set(int(r) for r in row if r >= 0))
    row_edges = int(sum(int((ebits[r] != 0).sum()) for r in set(int(r) for r in row if r >= 0)))
    live = int((row >= 0).sum())
    assert w["real_edge_tests"] == real and w["straddling"] == cross
    assert w["ops"] == 3 * real + 7 * cross
    assert w["bytes"] == live * 16 + row_edges * 16 + touched * (E2 * 4 + M2 * 4)
