"""The port's durable raster scan (`mosaic_tpu_torch/sql/raster_stream.py`)
and `ZonalEngine`'s runtime hooks against the JAX package's, on the CPU.

Mirrors the `RasterStream` tests of `tests/test_raster_zonal.py` case for
case, on their fixtures: the custom grid at resolution 3, three zones
whose edges cross the 32x32 tile boundaries and run exactly through pixel
centers (one with a hole), and the 75x90 raster of seed 29 with nodata
speckle (a 3x3 tile grid, both axes padded). Every scan — plain, durable,
killed and resumed, retried, degraded — must equal the reference's scan,
the port's f64 host oracle and the reference's oracle bit for bit (keys,
counts, and the f64 bits of sum, min and max). Across packages, a scan
the reference killed is resumed by the port. The f32 tiled lane (the
port's ``lane="tiled"``) must equal `ZonalEngine.zones` in that lane bit
for bit.
"""

import numpy as np
import pytest

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.raster import Raster as RefRaster
from mosaic_tpu.raster import zonal as RZ
from mosaic_tpu.runtime import faults as ref_faults
from mosaic_tpu.sql import RasterStream as RefRasterStream
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.raster import Raster
from mosaic_tpu_torch.raster import zonal as TZ
from mosaic_tpu_torch.runtime import checkpoint, faults, telemetry
from mosaic_tpu_torch.runtime.errors import TransientDeviceError
from mosaic_tpu_torch.runtime.retry import RetryPolicy
from mosaic_tpu_torch.sql import RasterStream
from mosaic_tpu_torch.sql import join as TJ

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
REF = RefCustom(RefConf(*CONF))
PORT = CustomIndexSystem(GridConf(*CONF))
RES = 3
TILE = (32, 32)
ZONES = [
    "POLYGON ((6 -20, 50 -25, 70 10, 40 8, 6 8, 6 -20), "
    "(20 -10, 30 -10, 30 -2, 20 -2, 20 -10))",
    "POLYGON ((55 -50, 85 -50, 85 -20, 70 -35, 55 -20, 55 -50))",
    "POLYGON ((2 -55, 20 -55, 20 -40, 2 -40, 2 -55))",
]
FAST = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)


def _mk(cls, h=75, w=90, nodata=-9.0, seed=5, integer=False):
    """The reference's `_mk_raster`: 75x90 at (32, 32) tiles, a 3x3 grid
    with both axes padded; pixel centers at integer world coordinates."""
    rng = np.random.default_rng(seed)
    if integer:
        data = rng.integers(0, 100, (1, h, w)).astype(np.float64)
    else:
        data = rng.uniform(0, 100, (1, h, w))
    speck = rng.random((h, w)) < 0.1
    if nodata is not None:
        data[0][speck] = nodata
    return cls(data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0), srid=0, nodata=nodata)


def _port_geometry(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def _rows(r) -> dict:
    """{key: (count, sum, min, max)}, f64 bit patterns kept."""
    return {int(k): (int(c), float(s).hex(), float(a).hex(), float(b).hex())
            for k, c, s, a, b in zip(r.keys, r.count, r.sum, r.min, r.max)}


def assert_equal(got, want):
    assert got.keys.dtype == np.int64 and got.count.dtype == np.int64
    assert got.sum.dtype == got.min.dtype == got.max.dtype == np.float64
    assert _rows(got) == _rows(want)
    assert got.pixels == want.pixels and got.band == want.band


@pytest.fixture(scope="module")
def ixs():
    col = wkt.from_wkt(ZONES)
    ref = RJ.build_chip_index(ref_tessellate(col, REF, RES, keep_core_geoms=False))
    port = TJ.build_chip_index(
        tessellate(_port_geometry(col), PORT, RES, keep_core_geoms=False), device="cpu"
    )
    return ref, port


@pytest.fixture(scope="module")
def index(ixs):
    return ixs[1]


@pytest.fixture(scope="module")
def stream(index):
    return RasterStream(index, PORT, RES)


@pytest.fixture(scope="module")
def ref_stream(ixs):
    return RefRasterStream(ixs[0], REF, RES)


@pytest.fixture(scope="module")
def raster():
    return _mk(Raster, seed=29)


@pytest.fixture(scope="module")
def ref_raster():
    return _mk(RefRaster, seed=29)


@pytest.fixture(scope="module")
def ref_clean(ref_stream, ref_raster):
    return ref_stream.scan(ref_raster, tile=TILE)


@pytest.fixture(scope="module")
def clean(stream, raster, ref_clean):
    r = stream.scan(raster, tile=TILE)
    assert_equal(r.stats, ref_clean.stats)
    return r


# ------------------------------------------------------------ durable scan


def test_scan_matches_engine_and_oracle(stream, raster, ref_raster, clean, ixs):
    want = TZ.host_zonal_zones_oracle(raster, ixs[1], PORT, RES, tile=TILE)
    assert_equal(clean.stats, want)
    assert_equal(clean.stats, RZ.host_zonal_zones_oracle(ref_raster, ixs[0], REF, RES, tile=TILE))
    assert_equal(clean.stats, TZ.ZonalEngine(PORT, RES, chip_index=ixs[1], lane="fold",
                                             device="cpu").zones(raster, tile=TILE))
    assert clean.ntiles == 9
    assert clean.pixels == 75 * 90


def test_durable_scan_equals_plain(stream, raster, clean, tmp_path):
    r = stream.scan(
        raster, tile=TILE, run_dir=str(tmp_path), snapshot_every=2,
    )
    assert_equal(r.stats, clean.stats)
    # 9 tiles, every-2 boundaries: 2, 4, 6, 8, 9
    assert r.metrics["snapshots"] == 5
    assert checkpoint.list_snapshots(str(tmp_path)) == [2, 4, 6, 8, 9]


@pytest.mark.parametrize("kill_after", [2, 4, 6])
def test_scan_kill_and_resume_bit_identical(
    stream, raster, clean, tmp_path, kill_after
):
    """Fatal device loss after ``kill_after`` tiles; resume() from the
    newest snapshot converges to the clean fold bit for bit."""
    d = str(tmp_path / f"kill{kill_after}")
    with faults.inject(
        fail_first=99, skip_first=kill_after,
        sites=("raster.zonal",),
        exc_factory=lambda s: RuntimeError(f"simulated device loss @ {s}"),
    ):
        with pytest.raises(RuntimeError, match="simulated device loss"):
            stream.scan(
                raster, tile=TILE, run_dir=d, snapshot_every=2,
                retry_policy=FAST,
            )
    assert checkpoint.list_snapshots(d)
    r = stream.resume(d, raster, retry_policy=FAST)
    assert_equal(r.stats, clean.stats)
    assert r.metrics["resumed_from"] == kill_after  # boundary == kill pt


def test_scan_transient_faults_retry_to_clean(stream, raster, clean, tmp_path):
    with telemetry.capture() as ev:
        with faults.transient_errors(2, sites=("raster.zonal",)):
            r = stream.scan(
                raster, tile=TILE, run_dir=str(tmp_path / "t"),
                snapshot_every=4, retry_policy=FAST,
            )
    assert_equal(r.stats, clean.stats)
    assert r.metrics["degraded"] is False
    assert [e["event"] for e in ev].count("transient_retry") == 2


def test_scan_exhausted_tile_degrades_to_host(stream, raster, clean, tmp_path):
    """On the CPU a tile whose retry budget exhausts is answered by the
    f64 host twin — bit-identical, so the final fold still equals clean
    (on the card the scan raises: a `gpu` test)."""
    with telemetry.capture() as ev:
        with faults.transient_errors(
            3, sites=("raster.zonal",)
        ):  # == FAST.max_attempts: tile 0's budget exhausts
            r = stream.scan(
                raster, tile=TILE, run_dir=str(tmp_path / "d"),
                snapshot_every=4, retry_policy=FAST,
            )
    assert r.metrics["degraded"] is True
    assert r.metrics["degraded_tiles"] == 1
    assert_equal(r.stats, clean.stats)
    assert "degraded" in [e["event"] for e in ev]


def test_scan_snapshot_failure_does_not_kill_run(
    stream, raster, clean, tmp_path
):
    with telemetry.capture() as ev:
        with faults.transient_errors(999, sites=("raster.snapshot",)):
            # the snapshot write is not a guarded site: simulate a sick
            # disk by pointing run_dir at a file
            p = tmp_path / "not_a_dir"
            p.write_text("x")
            r = stream.scan(
                raster, tile=TILE, run_dir=str(p), snapshot_every=4,
            )
    assert_equal(r.stats, clean.stats)
    assert r.metrics["snapshots"] == 0
    assert "snapshot_skipped" in [e["event"] for e in ev]


def test_resume_rejects_wrong_raster(stream, raster, tmp_path):
    stream.scan(
        raster, tile=TILE, run_dir=str(tmp_path), snapshot_every=4,
    )
    other = _mk(Raster, seed=99)
    with pytest.raises(ValueError, match="fingerprint"):
        stream.resume(str(tmp_path), other)


def test_resume_without_snapshots_raises(stream, raster, tmp_path):
    with pytest.raises(FileNotFoundError, match="nothing to resume"):
        stream.resume(str(tmp_path / "empty"), raster)


def test_scan_joins_trace_on_resume(stream, raster, tmp_path):
    d = str(tmp_path)
    with faults.inject(
        fail_first=99, skip_first=4, sites=("raster.zonal",),
        exc_factory=lambda s: RuntimeError("boom"),
    ):
        with telemetry.capture() as ev1:
            with pytest.raises(RuntimeError):
                stream.scan(
                    raster, tile=TILE, run_dir=d, snapshot_every=2,
                )
    with telemetry.capture() as ev2:
        stream.resume(d, raster)

    def scan_span(evs):
        return next(
            e for e in evs
            if e["event"] == "span" and e["name"] == "raster.scan"
        )

    first, second = scan_span(ev1), scan_span(ev2)
    # the resumed run joins the killed run's trace, not a fresh one
    assert second["trace_id"] == first["trace_id"]
    assert second["resumed_from"] == 4
    assert first["error"] == "RuntimeError"


# ------------------------------------------------------- beyond the mirror


def test_port_resumes_the_references_killed_scan(ref_stream, ref_raster, stream,
                                                 raster, ref_clean, tmp_path):
    """The reference's durable scan is killed after 4 tiles; the port's
    `resume` on its run directory ends at the reference's clean fold."""
    d = str(tmp_path)
    with ref_faults.inject(
        fail_first=99, skip_first=4, sites=("raster.zonal",),
        exc_factory=lambda s: RuntimeError("simulated device loss"),
    ):
        with pytest.raises(RuntimeError, match="simulated device loss"):
            ref_stream.scan(ref_raster, tile=TILE, run_dir=d, snapshot_every=2)
    assert checkpoint.list_snapshots(d) == [2, 4]
    r = stream.resume(d, raster, retry_policy=FAST)
    assert r.metrics["resumed_from"] == 4
    assert_equal(r.stats, ref_clean.stats)


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "float"])
def test_tiled_lane_scan_equals_tiled_zones(index, ixs, integer, tmp_path):
    """``lane="tiled"`` folds with `zonal_tiled` and accumulates in f32 as
    `ZonalEngine.zones` does: equal bit for bit, through a kill and a
    resume too; on integer data it equals the reference's tiled lane."""
    r = _mk(Raster, seed=31, integer=integer)
    want = TZ.ZonalEngine(PORT, RES, chip_index=index, lane="tiled",
                          device="cpu").zones(r, tile=TILE)
    st = RasterStream(index, PORT, RES, lane="tiled")
    assert_equal(st.scan(r, tile=TILE).stats, want)
    d = str(tmp_path)
    with faults.inject(
        fail_first=99, skip_first=4, sites=("raster.zonal",),
        exc_factory=lambda s: RuntimeError("kill"),
    ):
        with pytest.raises(RuntimeError):
            st.scan(r, tile=TILE, run_dir=d, snapshot_every=2)
    assert_equal(st.resume(d, r).stats, want)
    if integer:
        ref = RZ.ZonalEngine(REF, RES, chip_index=ixs[0], lane="tiled").zones(
            _mk(RefRaster, seed=31, integer=True), tile=TILE)
        assert_equal(want, ref)


@pytest.mark.parametrize("written", ["tiled", "fold"])
def test_resume_rejects_the_other_lanes_snapshot(index, raster, written, tmp_path):
    """A snapshot records its lane: the f32 partials of the tiled lane do
    not continue the f64 fold, nor the other way round. A snapshot with
    no lane (the reference's) is the fold lane's."""
    d = str(tmp_path)
    with faults.inject(
        fail_first=99, skip_first=4, sites=("raster.zonal",),
        exc_factory=lambda s: RuntimeError("kill"),
    ):
        with pytest.raises(RuntimeError):
            RasterStream(index, PORT, RES, lane=written).scan(
                raster, tile=TILE, run_dir=d, snapshot_every=2)
    assert checkpoint.load_latest(d)[2]["lane"] == written
    other = "fold" if written == "tiled" else "tiled"
    with pytest.raises(ValueError, match="lane"):
        RasterStream(index, PORT, RES, lane=other).resume(d, raster)


def test_resume_reads_a_snapshot_without_lane_as_fold(ref_stream, ref_raster,
                                                      index, raster, tmp_path):
    d = str(tmp_path)
    with ref_faults.inject(
        fail_first=99, skip_first=4, sites=("raster.zonal",),
        exc_factory=lambda s: RuntimeError("simulated device loss"),
    ):
        with pytest.raises(RuntimeError):
            ref_stream.scan(ref_raster, tile=TILE, run_dir=d, snapshot_every=2)
    assert "lane" not in checkpoint.load_latest(d)[2]
    with pytest.raises(ValueError, match="lane"):
        RasterStream(index, PORT, RES, lane="tiled").resume(d, raster)


def test_unported_arguments_raise(index, raster):
    st = RasterStream(index, PORT, RES)
    # expression scans are ported: a tree the raster cannot feed is
    # refused by validation before any tile runs
    from mosaic_tpu_torch import expr as E

    with pytest.raises(ValueError, match="out of range"):
        st.scan(raster, expr=E.band(9).zonal())
    # mesh= is ported (it raised before): only a count or a Mesh is taken
    with pytest.raises(TypeError, match="mesh="):
        RasterStream(index, PORT, RES, mesh=object())


def test_zonal_emits_stage_telemetry_and_spans(index, raster):
    """The reference's `test_zonal_emits_stage_telemetry`: a zones call
    records the ``tile`` and ``zonal`` stages; grid adds ``assign`` and
    one ``raster.assign`` span a tile under its ``raster.zonal`` span."""
    with telemetry.capture() as ev:
        TZ.zonal_zones(raster, index, PORT, RES, tile=TILE, device="cpu")
        TZ.zonal_grid(raster, RES, index_system=PORT, tile=TILE, device="cpu")
    stages = [e.get("stage") for e in ev if e["event"] == "raster_stage"]
    assert "tile" in stages and "zonal" in stages and "assign" in stages
    spans = [e for e in ev if e["event"] == "span"]
    grid = next(s for s in spans if s["name"] == "raster.zonal" and s.get("mode") == "grid")
    assigns = [s for s in spans if s["name"] == "raster.assign"]
    assert len(assigns) == 9
    assert all(s["parent_id"] == grid["span_id"] for s in assigns)


@pytest.mark.parametrize("mode", ["zones", "grid"])
def test_zonal_fault_site_trips_per_tile(index, raster, mode):
    """Every tile passes the ``raster.zonal`` fault site: an injected
    transient error surfaces from the engine's call."""
    eng = TZ.ZonalEngine(PORT, RES, chip_index=index, device="cpu")
    call = (lambda: eng.zones(raster, tile=TILE)) if mode == "zones" else (
        lambda: eng.grid(raster, tile=TILE))
    with faults.transient_errors(1, sites=("raster.zonal",), skip_first=3) as plan:
        with pytest.raises(TransientDeviceError):
            call()
    assert plan.seen == 4 and plan.trips == ["raster.zonal"]
