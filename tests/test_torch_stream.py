"""The port's streaming join (`mosaic_tpu_torch/sql/stream.py`) against the
JAX package's, on the CPU.

Mirrors `tests/test_stream.py` case for case, on its fixtures: the custom
grid `CUSTOM(-180, 180, -90, 90, 2, 10, 10)` at resolution 3, its three
zones, a ring of K=3 batches of 4,096 points drawn with numpy seed 0, and
NB=7 batches (the ring cycles). Each package tessellates and indexes the
same zones itself and stages the same numpy batches; every run is also
run by the reference's `StreamJoin`, and the two must give equal
``(checksum, matches, overflow)`` and equal rows (tolerance 0). Beyond
the mirror: the adaptive probe on an index with heavy and convex cells
(``edge_cap=8``: `pip_heavy_tiled` in the port, the Pallas kernel in
interpret mode in the reference), and H3 at resolution 9 with f64 cells
on both sides (torch's f32 trigonometry is not XLA's, so f32 H3 cells
are not comparable bit for bit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import H3 as RefH3
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.sql import join as RJ
from mosaic_tpu.sql import stream as RS
from mosaic_tpu_torch import DeviceUnavailable
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf, H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.kernels import pip as TP
from mosaic_tpu_torch.obs import metrics
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.sql import join as TJ
from mosaic_tpu_torch.sql.stream import (
    StreamJoin,
    fold_stats,
    fold_stats_np,
    generator_rate,
    hbm_peak,
    ring_from_generator,
    ring_from_host,
)

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
REF = RefCustom(RefConf(*CONF))
PORT = CustomIndexSystem(GridConf(*CONF))
RES = 3
ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1), "
    "(5 5, 5 8, 8 8, 8 5, 5 5))",
    "POLYGON ((20 0, 30 0, 30 10, 25 4, 20 10, 20 0))",
    "MULTIPOLYGON (((-20 -20, -12 -20, -12 -12, -20 -12, -20 -20)), "
    "((-8 -8, -2 -8, -2 -2, -8 -2, -8 -8)))",
]
K, BATCH, NB = 3, 4096, 7  # NB > K: the ring must cycle
NYC = [
    "POLYGON ((-74.02 40.70, -73.96 40.70, -73.96 40.76, "
    "-74.02 40.76, -74.02 40.70))",
    "POLYGON ((-73.96 40.70, -73.90 40.70, -73.90 40.76, "
    "-73.96 40.76, -73.96 40.70))",
]


def port_geometry(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def indexes(zones, ref_sys, port_sys, res, **kw):
    col = wkt.from_wkt(zones)
    ref = RJ.build_chip_index(ref_tessellate(col, ref_sys, res, keep_core_geoms=False), **kw)
    port = TJ.build_chip_index(
        tessellate(port_geometry(col), port_sys, res, keep_core_geoms=False),
        device="cpu", **kw,
    )
    return ref, port


def stats(r):
    return (r.checksum, r.matches, r.overflow)


@pytest.fixture(scope="module")
def ixs():
    return indexes(ZONES, REF, PORT, RES)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [rng.uniform((-25, -25), (35, 20), (BATCH, 2)) for _ in range(K)]


@pytest.fixture(scope="module")
def ring(batches):
    return ring_from_host(batches, device="cpu")


@pytest.fixture(scope="module")
def sj(ixs):
    return StreamJoin(ixs[1], PORT, RES, prefetch=True)


@pytest.fixture(scope="module")
def ref_run(ixs, batches):
    """The reference's prefetching run over the same batches."""
    return RS.StreamJoin(ixs[0], REF, RES, prefetch=True).run(
        RS.ring_from_host(batches), NB, collect=True
    )


def test_ring_cycling_bit_identical_to_per_batch(ixs, ring, sj, ref_run):
    """Ring loop == one pip_join_points call per batch, row for row —
    including cycled slots — and == the reference's loop."""
    index = ixs[1]
    res = sj.run(ring, NB, collect=True)
    assert res.outs.shape == (NB, BATCH)
    shift = index.border.shift
    for i in range(NB):
        pts = ring[i % K]
        cells = PORT.point_to_cell(pts.to(torch.float32), RES).to(torch.int64)
        want = TJ.pip_join_points((pts - shift).to(index.border.verts.dtype), cells, index)
        np.testing.assert_array_equal(res.outs[i], want.numpy())
    assert res.matches == int((res.outs >= 0).sum())
    assert res.overflow == 0
    assert res.matches > 0  # the workload must actually hit polygons
    np.testing.assert_array_equal(res.outs, ref_run.outs)
    assert stats(res) == stats(ref_run)


def test_run_batched_matches_scanned_loop(ring, sj, ref_run):
    rs = sj.run(ring, NB, collect=True)
    rb = sj.run_batched(ring, NB)
    np.testing.assert_array_equal(rs.outs, rb.outs)
    assert stats(rs) == stats(rb) == stats(ref_run)
    np.testing.assert_array_equal(rb.outs, ref_run.outs)


def test_prefetch_equals_non_prefetch(ixs, ring, sj, batches, ref_run):
    """Prefetching the cell assignment must be invisible in the results
    (it only changes what runs when)."""
    sj0 = StreamJoin(ixs[1], PORT, RES, prefetch=False)
    r1 = sj.run(ring, NB, collect=True)
    r0 = sj0.run(ring, NB, collect=True)
    np.testing.assert_array_equal(r1.outs, r0.outs)
    assert stats(r1) == stats(r0)
    assert r1.prefetch and not r0.prefetch
    ref0 = RS.StreamJoin(ixs[0], REF, RES, prefetch=False).run(
        RS.ring_from_host(batches), NB, collect=True
    )
    assert stats(r0) == stats(ref0) == stats(ref_run)
    np.testing.assert_array_equal(r0.outs, ref0.outs)


def test_step_stats_folds_step(ixs, ring, sj, batches):
    out = sj.step(ring[0])
    want = fold_stats(out).numpy()
    got = sj.step_stats(ring[0]).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    rsj = RS.StreamJoin(ixs[0], REF, RES)
    rring = RS.ring_from_host(batches)
    np.testing.assert_array_equal(got, np.asarray(rsj.step_stats(rring[0])))
    np.testing.assert_array_equal(out.numpy(), np.asarray(rsj.step(rring[0])))


def test_telemetry_stage_timings(ixs, ring):
    """Every stage event carries a non-negative measured duration."""
    with telemetry.capture() as events:
        sj = StreamJoin(ixs[1], PORT, RES, prefetch=True)
        sj.compile(ring, 4)
        sj.run(ring, 4)
        generator_rate(
            lambda g: torch.rand((256, 2), generator=g, dtype=torch.float64),
            1, 3, 256, device="cpu",
        )
    stages = [e for e in events if e["event"] == "stream_stage"]
    names = {e["stage"] for e in stages}
    assert {"compile", "join_loop", "gen_compile", "gen_loop"} <= names
    for e in stages:
        assert e["seconds"] >= 0.0, e
    loop = [e for e in stages if e["stage"] == "join_loop"][0]
    assert loop["n_batches"] == 4 and loop["batch"] == BATCH
    assert loop["points_per_sec"] > 0


def test_ring_from_host_shape_and_residency(ring, batches, monkeypatch):
    assert ring.shape == (K, BATCH, 2)
    assert ring.dtype == torch.float64 and ring.device.type == "cpu"
    np.testing.assert_array_equal(ring.numpy(), np.stack(batches))
    # the card by default: without one, staging refuses instead of
    # carrying on on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        ring_from_host(batches)


def test_hbm_peak_never_zero(ring):
    """The census must always see at least the resident ring."""
    peak, source = hbm_peak("cpu", fallback_arrays=[ring])
    assert peak >= ring.numel() * 8
    assert source == "live_buffer_census"  # a named source, never silent
    snap = metrics.snapshot()["stream.hbm_peak_bytes"]
    assert snap["kind"] == "gauge"
    assert {"source": "live_buffer_census"} in [s["labels"] for s in snap["series"]]


# ------------------------------------------------------- beyond the mirror


def test_fold_stats_wraps_like_the_reference():
    """The checksum term of 4,096 large rows overflows int32: the device
    fold must wrap to the reference's int32 value, and the host twin
    agree after `_wrap_i32`."""
    rng = np.random.default_rng(5)
    out = rng.integers(2**30, 2**31 - 1, 4096).astype(np.int32)
    out[:7] = -1
    out[7:9] = -2
    got = fold_stats(torch.from_numpy(out)).numpy()
    want = np.asarray(RS.fold_stats(jnp.asarray(out)))
    np.testing.assert_array_equal(got, want)
    host = RS._wrap_i32(fold_stats_np(out))
    np.testing.assert_array_equal(host, got.astype(np.int64))


def _star_wkt(cx=25.0, cy=-14.0, n=240):
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    r = np.where(np.arange(n) % 2 == 0, 4.0, 2.0)
    x, y = cx + r * np.cos(th), cy + r * np.sin(th)
    ring = ", ".join(f"{a:.6f} {b:.6f}" for a, b in zip(x, y))
    return f"POLYGON (({ring}, {x[0]:.6f} {y[0]:.6f}))"


@pytest.fixture(scope="module")
def heavy_ixs():
    """The zones plus a 240-vertex star, with ``edge_cap=8``: heavy and
    convex cells, so the adaptive probe routes every lane (the recheck
    suite's custom-grid case)."""
    return indexes(ZONES + [_star_wkt()], REF, PORT, RES, edge_cap=8)


@pytest.mark.parametrize("probe", ["adaptive", "scatter"])
def test_adaptive_stream_launches_heavy_lane_and_equals_reference(heavy_ixs, batches, probe):
    ref, port = heavy_ixs
    assert port.num_heavy_cells > 0 and port.num_convex_cells > 0
    calls = []
    real = TP.pip_heavy_tiled

    def counting(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    sj = StreamJoin(port, PORT, RES, probe=probe)
    ring = ring_from_host(batches, device="cpu")
    TP.pip_heavy_tiled = counting
    try:
        got = sj.run(ring, NB, collect=True)
        batched = sj.run_batched(ring, NB)
    finally:
        TP.pip_heavy_tiled = real
    assert len(calls) == (2 * NB if probe == "adaptive" else 0)
    want = RS.StreamJoin(ref, REF, RES, probe=probe).run(
        RS.ring_from_host(batches), NB, collect=True
    )
    assert stats(got) == stats(want) == stats(batched)
    np.testing.assert_array_equal(got.outs, want.outs)
    assert got.overflow == 0 and got.matches > 0


def test_h3_stream_f64_cells_equal_reference():
    """H3 at resolution 9 over two NYC zones, cells in f64 on both sides:
    rows and stats equal the reference's, and the f64 host oracle's."""
    H3 = H3IndexSystem()
    ref, port = indexes(NYC, RefH3, H3, 9)
    rng = np.random.default_rng(2)
    b = [np.column_stack([rng.uniform(-74.05, -73.87, 1024),
                          rng.uniform(40.68, 40.82, 1024)]) for _ in range(2)]
    sj = StreamJoin(port, H3, 9, cell_dtype=torch.float64, probe="adaptive")
    got = sj.run(ring_from_host(b, device="cpu"), 3, collect=True)
    want = RS.StreamJoin(ref, RefH3, 9, cell_dtype=jnp.float64).run_batched(
        RS.ring_from_host(b), 3
    )
    assert stats(got) == stats(want)
    np.testing.assert_array_equal(got.outs, want.outs)
    assert got.matches > 0


def test_ring_from_generator_seeds_each_slot():
    """Slot i draws from its own generator seeded ``key + i``: the ring
    is reproducible, its slots differ, and ``key`` may be a generator."""

    def gen(g):
        return torch.rand((64, 2), generator=g, dtype=torch.float64) * 40 - 20

    a = ring_from_generator(gen, 7, 3, device="cpu")
    b = ring_from_generator(gen, torch.Generator().manual_seed(7), 3, device="cpu")
    assert a.shape == (3, 64, 2) and a.dtype == torch.float64
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    g8 = torch.Generator().manual_seed(8)
    assert torch.equal(a[1], gen(g8))


def test_unported_arguments_raise(ixs):
    # mesh= is ported (it raised before): only a count or a Mesh is
    # taken, and a meshed stream's batch must divide over the mesh
    from mosaic_tpu_torch.dispatch import data_mesh

    with pytest.raises(TypeError, match="mesh="):
        StreamJoin(ixs[1], PORT, RES, mesh=object())
    sj = StreamJoin(ixs[1], PORT, RES, mesh=data_mesh(devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="divide"):
        sj.step(torch.zeros((100, 2), dtype=torch.float64))


def test_donate_ring_keeps_the_ring(ixs, ring, sj):
    r = StreamJoin(ixs[1], PORT, RES, donate_ring=True).run(ring, 2)
    assert r.metrics == {"donate_ring": True, "ring_donated": False,
                         "ring_bytes": ring.numel() * 8}
    assert stats(r) == stats(sj.run(ring, 2))


def test_ring_on_another_device_is_refused(ixs, batches):
    sj = StreamJoin(ixs[1], PORT, RES)
    meta = torch.empty((K, BATCH, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="ring lives on"):
        sj.run(meta, 1)


@pytest.mark.parametrize("knob, env, raw, parsed", [
    ("stream_window", "MOSAIC_STREAM_WINDOW", "3", 3),
    ("stream_pipeline", "MOSAIC_STREAM_PIPELINE", "1", True),
    ("stream_pipeline", "MOSAIC_STREAM_PIPELINE", "0", False),
    ("probe", "MOSAIC_TUNE_PROBE", "adaptive", "adaptive"),
    ("lookup", "MOSAIC_TUNE_LOOKUP", "gather", "gather"),
])
def test_knob_precedence_explicit_env_default(monkeypatch, knob, env, raw, parsed):
    """explicit > env > default, as the reference's resolver gives it
    without a profile; one ``tune_resolve`` event names each source."""
    from mosaic_tpu.tune import resolve as ref_resolve
    from mosaic_tpu_torch.tune import resolve

    monkeypatch.delenv(env, raising=False)
    assert resolve.resolve_knob(knob, None, None, "d") == ("d", "default")
    monkeypatch.setenv(env, raw)
    assert resolve.resolve_knob(knob, None, None, "d") == (parsed, "env")
    assert resolve.resolve_knob(knob, "x", None, "d") == ("x", "explicit")
    for explicit in (None, "x"):
        assert resolve.resolve_knob(knob, explicit, None, "d") == \
            ref_resolve.resolve_knob(knob, explicit, None, "d")
    with telemetry.capture() as ev:
        out = resolve.resolve_knobs("unit", None, explicit={}, defaults={knob: "d"})
    assert out == {knob: parsed}
    (evt,) = [e for e in ev if e["event"] == "tune_resolve"]
    assert evt["entry"] == "unit" and evt[f"{knob}_source"] == "env"


def test_knob_resolution_refuses_bad_values(monkeypatch):
    from mosaic_tpu_torch.tune import resolve

    with pytest.raises(KeyError):
        resolve.resolve_knob("warp_factor", None, None, 9)
    monkeypatch.setenv("MOSAIC_STREAM_WINDOW", "many")
    with pytest.raises(ValueError, match="MOSAIC_STREAM_WINDOW|stream_window"):
        resolve.resolve_knob("stream_window", None, None, None)


def test_pip_join_reads_the_probe_and_lookup_knobs(monkeypatch, ixs, batches):
    """`pip_join` resolves ``probe`` and ``lookup`` through the same
    resolver as `StreamJoin`: the env knobs apply to both, and an explicit
    argument beats them."""
    pts = batches[0][:512]
    want = TJ.pip_join(pts, None, PORT, RES, chip_index=ixs[1], device="cpu")
    monkeypatch.setenv("MOSAIC_TUNE_PROBE", "adaptive")
    monkeypatch.setenv("MOSAIC_TUNE_LOOKUP", "gather")
    with telemetry.capture() as ev:
        got = TJ.pip_join(pts, None, PORT, RES, chip_index=ixs[1], device="cpu")
    np.testing.assert_array_equal(got, want)
    (evt,) = [e for e in ev if e["event"] == "tune_resolve"]
    assert evt["entry"] == "pip_join"
    assert (evt["probe"], evt["probe_source"]) == ("adaptive", "env")
    assert (evt["lookup"], evt["lookup_source"]) == ("gather", "env")
    monkeypatch.setenv("MOSAIC_TUNE_PROBE", "no-such-probe")
    with pytest.raises(ValueError):
        TJ.pip_join(pts, None, PORT, RES, chip_index=ixs[1], device="cpu")
    with telemetry.capture() as ev:
        TJ.pip_join(pts, None, PORT, RES, chip_index=ixs[1], probe="scatter",
                    device="cpu")
    (evt,) = [e for e in ev if e["event"] == "tune_resolve"]
    assert (evt["probe"], evt["probe_source"]) == ("scatter", "explicit")
