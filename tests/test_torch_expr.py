"""The port's expression compiler (`mosaic_tpu_torch/expr`) against the JAX
package's, on the CPU.

Mirrors `tests/test_expr.py` test for test, on its fixtures: the custom
grid at resolution 3, three zones whose edges cross the 32x32 tile
boundaries and run exactly through pixel centers (one with a hole), the
NaN-speckled 75x90 three-band raster of seed 5 and the planar raster.
Every fused result is held bit for bit (keys, counts, and the f64 bits of
sum, min and max) to the port's staged pipeline, the port's f64 host
oracle and the reference's fused map. `TestPixelFrontends`' ``rst_*``
cases run `map_pixels` (the SQL frontends are ROADMAP item 14). On top:
the trees hash as the reference's, a tree mixing ``cell_of()`` with a
float constant promotes as jnp does, an H3 case, and the port resumes an
expression scan the reference killed.
"""

import numpy as np
import pytest

from mosaic_tpu import expr as RE
from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.raster import Raster as RefRaster
from mosaic_tpu.raster.zonal import ZonalEngine as RefEngine
from mosaic_tpu.runtime import faults as ref_faults
from mosaic_tpu.sql import RasterStream as RefRasterStream
from mosaic_tpu.sql.join import build_chip_index as ref_build
from mosaic_tpu_torch import expr as E
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.dispatch import core as dispatch
from mosaic_tpu_torch.expr import compile as expr_compile
from mosaic_tpu_torch.raster import Raster
from mosaic_tpu_torch.raster.zonal import ZonalEngine, zonal_zones
from mosaic_tpu_torch.runtime import checkpoint, faults, telemetry
from mosaic_tpu_torch.runtime.retry import RetryPolicy
from mosaic_tpu_torch.sql import RasterStream
from mosaic_tpu_torch.sql.join import build_chip_index

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
REF = RefCustom(RefConf(*CONF))
CUSTOM = CustomIndexSystem(GridConf(*CONF))
RES = 3
TILE = (32, 32)

#: same adversarial zone set as test_expr.py: edges cross the (32, 32)
#: tile boundaries and the x=6 / y=8 edges run EXACTLY through pixel
#: centers of the fixture raster; zone 0 carries a hole
ZONES = [
    "POLYGON ((6 -20, 50 -25, 70 10, 40 8, 6 8, 6 -20), "
    "(20 -10, 30 -10, 30 -2, 20 -2, 20 -10))",
    "POLYGON ((55 -50, 85 -50, 85 -20, 70 -35, 55 -20, 55 -50))",
    "POLYGON ((2 -55, 20 -55, 20 -40, 2 -40, 2 -55))",
]

FAST = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)


def _port_geometry(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


@pytest.fixture(scope="module")
def ixs():
    col = wkt.from_wkt(ZONES)
    ref = ref_build(ref_tessellate(col, REF, RES, keep_core_geoms=False))
    port = build_chip_index(
        tessellate(_port_geometry(col), CUSTOM, RES, keep_core_geoms=False),
        device="cpu",
    )
    return ref, port


@pytest.fixture(scope="module")
def index(ixs):
    return ixs[1]


@pytest.fixture(scope="module")
def engine(index):
    return ZonalEngine(CUSTOM, RES, chip_index=index, device="cpu")


@pytest.fixture(scope="module")
def ref_engine(ixs):
    return RefEngine(REF, RES, chip_index=ixs[0])


def _mk_raster(cls, h=75, w=90, bands=3, seed=5):
    """The reference's `_mk_raster`: multi-band 75x90 at (32, 32) -> 3x3
    padded tile grid; pixel centers at integer world coordinates; NaN
    nodata with ~8% speckle per band."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.0, 100.0, (bands, h, w))
    for b in range(bands):
        speck = rng.random((h, w)) < 0.08
        data[b][speck] = np.nan
    return cls(
        data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0), srid=0,
        nodata=float("nan"),
    )


def _planar_raster(cls, h=75, w=90, bands=3):
    """The reference's `_planar_raster`: each band constant per tile."""
    data = np.zeros((bands, h, w))
    for b in range(bands):
        for ti, r0 in enumerate(range(0, h, 32)):
            for tj, c0 in enumerate(range(0, w, 32)):
                data[b, r0:r0 + 32, c0:c0 + 32] = (
                    10.0 * (b + 1) + ti + 0.5 * tj
                )
    return cls(
        data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0), srid=0,
        nodata=float("nan"),
    )


@pytest.fixture(scope="module")
def raster():
    return _mk_raster(Raster)


@pytest.fixture(scope="module")
def ref_raster():
    return _mk_raster(RefRaster)


#: the acceptance pipeline: NDVI, cloud mask, zonal fold — in either package
def _pipeline(M=E):
    return (
        M.ndvi(nir=2, red=1)
        .mask_where(M.band(3) < 80.0)
        .zonal(by="zones")
    )


def _rows(r) -> dict:
    """{key: (count, sum, min, max)}, f64 bit patterns kept."""
    return {int(k): (int(c), float(s).hex(), float(a).hex(), float(b).hex())
            for k, c, s, a, b in zip(r.keys, r.count, r.sum, r.min, r.max)}


def _assert_result_equal(got, want):
    assert got.keys.dtype == np.int64 and got.count.dtype == np.int64
    assert got.sum.dtype == got.min.dtype == got.max.dtype == np.float64
    assert _rows(got) == _rows(want)


def _oracle(raster, e, index=None, by=None, system=CUSTOM):
    return E.host_expr_zonal_oracle(
        raster, e, index_system=system, resolution=RES,
        chip_index=index, tile=TILE, by=by,
    )


# --------------------------------------------------------------- ast


class TestAst:
    def test_structural_equality_and_hash(self):
        a = _pipeline()
        b = _pipeline()
        assert a == b
        assert E.structure_key(a) == E.structure_key(b)
        assert E.tree_hash(a) == E.tree_hash(b)
        assert E.tree_hash(a) != E.tree_hash(
            E.ndvi(nir=3, red=1).zonal(by="zones")
        )

    @pytest.mark.parametrize("build", [
        _pipeline,
        lambda M: M.ndvi(nir=3, red=1).zonal(),
        lambda M: M.where((M.band(1) < 30.0) | (M.band(2) > 70.0),
                          M.band(3), M.band(1) - M.band(2)).zonal(by="grid"),
        lambda M: (M.cell_of() * 0.5 + M.zone_data((1.5, -2.0), fill=0.25)
                   ).mask_where(~M.in_zone()).join(),
        lambda M: M.overlap_fraction(),
        lambda M: M.where(M.overlap_area() > 0.1,
                          M.left_area() - M.right_area(), M.const(-1.0)),
    ])
    def test_tree_hash_equals_reference(self, build):
        """Durable scans store the tree hash: the port's must be the
        reference's digest, character for character."""
        assert E.tree_hash(build(E)) == RE.tree_hash(build(RE))
        assert repr(E.structure_key(build(E))) == repr(
            RE.structure_key(build(RE))
        )

    def test_eq_is_a_method_not_dunder(self):
        node = E.band(1).eq(E.band(2))
        assert isinstance(node, E.Compare)
        assert node.op == "eq"

    def test_bands_of_and_terminal(self):
        e = _pipeline()
        value, kind, by, stats = E.terminal_of(e)
        assert kind == "zonal" and by == "zones"
        assert list(E.bands_of(value)) == [1, 2, 3]
        assert set(stats) == {"count", "sum", "min", "max", "mean"}

    def test_validation_errors(self):
        with pytest.raises(ValueError, match="out of range"):
            E.validate(E.band(4).zonal(), 3)
        with pytest.raises(TypeError, match="numeric"):
            E.validate(E.band(1) + (E.band(2) < 1.0), 3)
        with pytest.raises(ValueError, match="grid"):
            E.validate(
                (E.band(1) + E.zone_data((1.0,))).zonal(by="grid"), 3
            )
        with pytest.raises(ValueError, match="terminal"):
            E.validate(E.band(1).zonal() + E.band(2), 3)
        with pytest.raises(ValueError, match="vector side"):
            E.validate(
                (E.band(1) + E.zone_data((1.0,))).zonal(), 3,
                has_zones=False,
            )
        with pytest.raises(TypeError, match="numeric value tree"):
            E.validate((E.band(1) < 2.0).zonal(), 3)


# ------------------------------------------------- fused == staged == oracle


class TestBitIdentity:
    def test_fused_equals_staged_and_oracle(
        self, engine, raster, index, ref_engine, ref_raster
    ):
        """The acceptance pipeline, four ways: fused; staged (the value
        per pixel by `map_pixels`, then the fold lane's
        `ZonalEngine.zones`); the f64 host oracle; the reference's
        fused map."""
        fused = engine.map(_pipeline(), raster, tile=TILE)
        px, valid = E.map_pixels(
            E.ndvi(nir=2, red=1).mask_where(E.band(3) < 80.0), raster,
            tile=TILE, device="cpu",
        )
        staged = zonal_zones(
            Raster(data=np.where(valid, px, np.nan)[None], gt=raster.gt,
                   srid=0, nodata=float("nan")),
            index, CUSTOM, RES, tile=TILE, lane="fold", device="cpu",
        )
        _assert_result_equal(fused, staged)
        _assert_result_equal(fused, _oracle(raster, _pipeline(), index))
        _assert_result_equal(
            fused, ref_engine.map(_pipeline(RE), ref_raster, tile=TILE)
        )

    def test_edge_pixels_fold_identically(
        self, engine, raster, index, ref_engine, ref_raster
    ):
        """Pixel centers exactly on the x=6 / y=8 zone edges go through
        the epsilon-band host re-join in both lanes — counts too."""
        fused = engine.map(
            (E.band(1) * 2.0 - E.band(2)).zonal(by="zones"), raster,
            tile=TILE,
        )
        staged_px = raster.data[0] * 2.0 - raster.data[1]
        staged = zonal_zones(
            Raster(data=staged_px[None], gt=raster.gt, srid=0,
                   nodata=float("nan")),
            index, CUSTOM, RES, tile=TILE, device="cpu",
        )
        _assert_result_equal(fused, staged)
        _assert_result_equal(fused, ref_engine.map(
            (RE.band(1) * 2.0 - RE.band(2)).zonal(by="zones"), ref_raster,
            tile=TILE,
        ))

    def test_planar_tiles(self, engine, index, ref_engine):
        r = _planar_raster(Raster)
        e = E.norm_diff(E.band(2), E.band(1)).zonal(by="zones")
        fused = engine.map(e, r, tile=TILE)
        _assert_result_equal(fused, _oracle(r, e, index))
        _assert_result_equal(fused, ref_engine.map(
            RE.norm_diff(RE.band(2), RE.band(1)).zonal(by="zones"),
            _planar_raster(RefRaster), tile=TILE,
        ))

    def test_where_and_boolean_ops(self, engine, raster, index):
        e = E.where(
            (E.band(1) < 30.0) | (E.band(2) > 70.0),
            E.band(3),
            E.band(1) - E.band(2),
        ).zonal(by="zones")
        fused = engine.map(e, raster, tile=TILE)
        _assert_result_equal(fused, _oracle(raster, e, index))

    def test_grid_mode(self, engine, raster, ref_engine, ref_raster):
        e = E.ndvi(nir=2, red=1).zonal(by="grid")
        fused = engine.map(e, raster, tile=TILE)
        _assert_result_equal(fused, _oracle(raster, e, by="grid"))
        _assert_result_equal(fused, ref_engine.map(
            RE.ndvi(nir=2, red=1).zonal(by="grid"), ref_raster, tile=TILE,
        ))

    def test_nan_detectable_in_tree(self, engine, raster):
        e = E.where(
            E.band(1).ne(E.band(1)), E.const(-1.0), E.band(1)
        ).zonal(by="zones")
        fused = engine.map(e, raster, tile=TILE)
        plain = engine.map(E.band(1).zonal(by="zones"), raster, tile=TILE)
        _assert_result_equal(fused, plain)

    @pytest.mark.parametrize("by", ["zones", "grid"])
    def test_cell_of_with_float_const_promotes_like_jnp(
        self, engine, raster, index, ixs, ref_raster, by
    ):
        """int64 cells meeting f64 constants: jnp promotes to f64 (torch
        alone would give float32). The fused results equal the port's
        oracle and the reference's oracle bit for bit; a compare of
        cells against a float constant selects the same pixels."""
        trees = [
            lambda M: (M.cell_of() * 0.5 + M.band(1)).zonal(by=by),
            lambda M: (M.cell_of() / 7.0 - M.band(2)).zonal(by=by),
            lambda M: M.band(1).mask_where(
                M.cell_of() > 1.0e3).zonal(by=by),
            lambda M: M.where(M.band(1) > 50.0, M.const(0.5),
                              M.cell_of()).zonal(by=by),
        ]
        for build in trees:
            fused = engine.map(build(E), raster, tile=TILE)
            zi = index if by == "zones" else None
            _assert_result_equal(fused, _oracle(raster, build(E), zi, by))
            ref = RE.host_expr_zonal_oracle(
                ref_raster, build(RE), index_system=REF, resolution=RES,
                chip_index=None if zi is None else ixs[0],
                tile=TILE, by=by,
            )
            _assert_result_equal(fused, ref)


# ----------------------------------------------------- one-program fusion


class TestFusion:
    def test_warm_map_compiles_nothing(self, engine, raster):
        """After warmup a map builds nothing: zero nvcc builds (the
        port's only compiles) and no new signature."""
        e = _pipeline()
        engine.warmup_expr(e, raster, tile=TILE)
        n0 = dispatch.backend_compiles()
        sigs = expr_compile.signatures()
        engine.map(e, raster, tile=TILE)
        assert dispatch.backend_compiles() == n0
        assert expr_compile.signatures() == sigs

    def test_structural_sharing_one_compile(self, engine, raster):
        a = (E.band(1) + E.band(2) * 0.25).mask_where(
            E.band(3) < 99.0
        ).zonal(by="zones")
        b = (E.band(1) + E.band(2) * 0.25).mask_where(
            E.band(3) < 99.0
        ).zonal(by="zones")
        assert a is not b and a == b
        engine.map(a, raster, tile=TILE)
        before = dispatch.cache_view("expr_programs")
        n0 = dispatch.backend_compiles()
        got_b = engine.map(b, raster, tile=TILE)
        after = dispatch.cache_view("expr_programs")
        assert after["misses"] == before["misses"]  # no new program
        assert after["hits"] > before["hits"]
        assert dispatch.backend_compiles() == n0
        _assert_result_equal(got_b, engine.map(a, raster, tile=TILE))

    def test_post_freeze_cold_compile_tripwire(self, engine, raster):
        sigs = expr_compile.signatures()
        frozen = expr_compile._frozen
        try:
            engine.warmup_expr(_pipeline(), raster, tile=TILE)
            expr_compile.freeze()
            cold0 = expr_compile.cold_compiles()
            engine.map(_pipeline(), raster, tile=TILE)
            assert expr_compile.cold_compiles() == cold0
            novel = (E.band(1) * 7.75 - E.band(3)).zonal(by="zones")
            with telemetry.capture() as ev:
                engine.map(novel, raster, tile=TILE)
            assert expr_compile.cold_compiles() == cold0 + 1
            trips = [e for e in ev if e["event"] == "expr_compile"]
            assert len(trips) == 1 and trips[0]["after_freeze"]
        finally:
            expr_compile._frozen = frozen
            expr_compile._signatures.update(sigs)

    def test_first_build_opens_compile_span(self, engine, raster):
        """The first execution of a signature sits under one
        ``dispatch.compile`` span (site=expr) carrying the nvcc-build
        delta (0 on the CPU); a warm repeat opens none."""
        novel = (E.band(2) / (E.band(1) + 123.25)).zonal(by="zones")
        n0 = dispatch.backend_compiles()
        with telemetry.capture() as ev:
            engine.map(novel, raster, tile=TILE)
        comp = [
            e for e in ev
            if e["event"] == "span" and e["name"] == "dispatch.compile"
            and e.get("site") == "expr"
        ]
        assert len(comp) == 1
        assert comp[0]["backend_compiles"] == dispatch.backend_compiles() - n0
        with telemetry.capture() as ev2:
            engine.map(novel, raster, tile=TILE)
        assert not [
            e for e in ev2
            if e["event"] == "span" and e["name"] == "dispatch.compile"
        ]

    def test_map_emits_expr_stage(self, engine, raster):
        with telemetry.capture() as ev:
            engine.map(_pipeline(), raster, tile=TILE)
        stages = [e for e in ev if e["event"] == "expr_stage"]
        assert len(stages) == 1
        st = stages[0]
        assert st["stage"] == "map" and st["mode"] == "zones"
        assert st["pixels"] > 0 and st["pixels_per_sec"] > 0
        spans = [e for e in ev if e["event"] == "span"
                 and e["name"] == "expr.map"]
        assert len(spans) == 1 and spans[0]["ntiles"] == 9

    def test_program_op_count(self, engine, raster):
        """A fused program is a short run of eager ops a tile: the
        acceptance pipeline's zero tile counts the same ops every call."""
        value = E.terminal_of(_pipeline())[0]
        prog = expr_compile.zonal_program(
            value, 32, 32, engine.num_zones, "float64", CUSTOM, RES
        )
        import torch

        args = (np.zeros(6), np.zeros(2, np.int32),
                torch.zeros(3, 1024, dtype=torch.float64),
                torch.zeros(3, 1024, dtype=torch.bool),
                torch.full((1024,), -1, dtype=torch.int32))
        n = expr_compile.program_ops(prog, *args)
        assert 10 < n < 200
        assert expr_compile.program_ops(prog, *args) == n


# -------------------------------------------------------- guarded path


class TestDegradation:
    def test_exhausted_tile_degrades_bit_identically(self, engine, raster):
        e = _pipeline()
        clean = engine.map(e, raster, tile=TILE)
        with telemetry.capture() as ev:
            with faults.transient_errors(3, sites=("expr.map",)):
                got = engine.map(e, raster, tile=TILE, retry_policy=FAST)
        _assert_result_equal(got, clean)
        degr = [e2 for e2 in ev if e2["event"] == "degraded"]
        assert degr and degr[0]["label"] == "expr.map"

    def test_exhausted_grid_tile_degrades_bit_identically(
        self, engine, raster
    ):
        e = E.ndvi(nir=2, red=1).zonal(by="grid")
        clean = engine.map(e, raster, tile=TILE)
        with faults.transient_errors(3, sites=("expr.map",)):
            got = engine.map(e, raster, tile=TILE, retry_policy=FAST)
        _assert_result_equal(got, clean)

    def test_transient_faults_retry_to_clean(self, engine, raster):
        e = _pipeline()
        clean = engine.map(e, raster, tile=TILE)
        with telemetry.capture() as ev:
            with faults.transient_errors(2, sites=("expr.map",)):
                got = engine.map(e, raster, tile=TILE, retry_policy=FAST)
        _assert_result_equal(got, clean)
        assert [e2["event"] for e2 in ev].count("transient_retry") == 2


# ------------------------------------------------------- pixel frontends


class TestPixelFrontends:
    def test_rst_ndvi_matches_numpy(self, raster):
        out, valid = E.map_pixels(E.ndvi(nir=2, red=1), raster, device="cpu")
        assert out.shape == (75, 90)
        nir, red = raster.data[1], raster.data[0]
        want = (nir - red) / (nir + red)
        ok = np.isfinite(nir) & np.isfinite(red)
        np.testing.assert_array_equal(valid, ok)
        np.testing.assert_array_equal(out[ok], want[ok])
        assert np.isnan(out[~ok]).all()

    def test_rst_mapbands_mask_where(self, raster, ref_raster):
        from mosaic_tpu.functions.raster import rst_mapbands

        e = E.band(1).mask_where(E.band(2) < 50.0)
        out, _ = E.map_pixels(e, raster, device="cpu")
        b1, b2 = raster.data[0], raster.data[1]
        keep = np.isfinite(b1) & np.isfinite(b2) & (b2 < 50.0)
        np.testing.assert_array_equal(out[keep], b1[keep])
        assert np.isnan(out[~keep]).all()
        ref = rst_mapbands(
            [ref_raster], RE.band(1).mask_where(RE.band(2) < 50.0)
        )[0].data[0]
        assert out.tobytes() == np.asarray(ref, np.float64).tobytes()

    def test_rst_mapbands_cell_of_needs_resolution(self, raster):
        with pytest.raises(ValueError, match="resolution"):
            E.map_pixels(E.cell_of(), raster, index_system=CUSTOM,
                         device="cpu")

    def test_map_join_zones_raster(self, engine, raster, ref_engine,
                                   ref_raster):
        zones, vals, valid = engine.map(
            E.ndvi(nir=2, red=1).join(), raster, tile=TILE
        )
        assert zones.shape == (75, 90) and vals.shape == (75, 90)
        assert (zones[~valid] == -1).all()
        assert set(np.unique(zones)) <= {-1, 0, 1, 2}
        rz, rv, rm = ref_engine.map(
            RE.ndvi(nir=2, red=1).join(), ref_raster, tile=TILE
        )
        np.testing.assert_array_equal(zones, np.asarray(rz))
        np.testing.assert_array_equal(valid, np.asarray(rm))
        assert vals.tobytes() == np.asarray(rv, np.float64).tobytes()


# ---------------------------------------------------------- durable scan


class TestExprScan:
    @pytest.fixture(scope="class")
    def stream(self, index):
        return RasterStream(index, CUSTOM, RES)

    def test_fused_scan_matches_map_and_oracle(
        self, stream, engine, raster, index
    ):
        e = _pipeline()
        fused = stream.scan(raster, expr=e, tile=TILE)
        _assert_result_equal(fused.stats, engine.map(e, raster, tile=TILE))
        _assert_result_equal(fused.stats, _oracle(raster, e, index))

    def test_kill_resume_and_expr_hash_refusals(
        self, stream, raster, tmp_path
    ):
        e = _pipeline()
        clean = stream.scan(raster, expr=e, tile=TILE)
        d = str(tmp_path / "fused")
        with faults.inject(
            fail_first=99, skip_first=4, sites=("raster.zonal",),
            exc_factory=lambda s: RuntimeError("simulated device loss"),
        ):
            with pytest.raises(RuntimeError, match="device loss"):
                stream.scan(
                    raster, expr=e, tile=TILE, run_dir=d,
                    snapshot_every=2, retry_policy=FAST,
                )
        assert checkpoint.list_snapshots(d) == [2, 4]
        with pytest.raises(ValueError, match="expression mismatch"):
            stream.resume(
                d, raster, expr=E.ndvi(nir=3, red=1).zonal(),
                retry_policy=FAST,
            )
        with pytest.raises(ValueError, match="expression mismatch"):
            stream.resume(d, raster, retry_policy=FAST)
        r = stream.resume(d, raster, expr=e, retry_policy=FAST)
        _assert_result_equal(r.stats, clean.stats)
        assert r.metrics["resumed_from"] == 4

    def test_plain_snapshot_refuses_expr_resume(
        self, stream, raster, tmp_path
    ):
        d = str(tmp_path / "plain")
        with faults.inject(
            fail_first=99, skip_first=2, sites=("raster.zonal",),
            exc_factory=lambda s: RuntimeError("boom"),
        ):
            with pytest.raises(RuntimeError):
                stream.scan(
                    raster, tile=TILE, run_dir=d,
                    snapshot_every=2, retry_policy=FAST,
                )
        with pytest.raises(ValueError, match="expression mismatch"):
            stream.resume(d, raster, expr=_pipeline(), retry_policy=FAST)

    def test_scan_rejects_non_zonal_terminals(self, stream, raster):
        with pytest.raises(ValueError, match="zones"):
            stream.scan(raster, expr=E.ndvi().zonal(by="grid"), tile=TILE)

    def test_exhausted_tile_degrades_on_the_cpu(self, stream, raster):
        e = _pipeline()
        clean = stream.scan(raster, expr=e, tile=TILE)
        with faults.transient_errors(3, sites=("raster.zonal",)):
            got = stream.scan(raster, expr=e, tile=TILE, retry_policy=FAST)
        _assert_result_equal(got.stats, clean.stats)
        assert got.metrics["degraded_tiles"] >= 1

    def test_port_resumes_reference_expr_run(
        self, stream, raster, ref_raster, ixs, tmp_path
    ):
        """A durable expression scan the reference killed: the port
        resumes its run directory (same layout, same tree hash) and
        lands on the reference's uninterrupted scan bit for bit."""
        ref_stream = RefRasterStream(ixs[0], REF, RES)
        want = ref_stream.scan(ref_raster, expr=_pipeline(RE), tile=TILE)
        d = str(tmp_path / "ref")
        with ref_faults.inject(
            fail_first=99, skip_first=4, sites=("raster.zonal",),
            exc_factory=lambda s: RuntimeError("simulated device loss"),
        ):
            with pytest.raises(RuntimeError):
                ref_stream.scan(
                    ref_raster, expr=_pipeline(RE), tile=TILE, run_dir=d,
                    snapshot_every=2,
                )
        assert checkpoint.load_latest(d)[2]["expr_sha256"] == E.tree_hash(
            _pipeline()
        )
        got = stream.resume(d, raster, expr=_pipeline(), retry_policy=FAST)
        assert got.metrics["resumed_from"] == 4
        _assert_result_equal(got.stats, want.stats)


# ------------------------------------------------------------------ H3


H3_ZONES = [
    "POLYGON ((-74.00 40.70, -73.97 40.70, -73.97 40.73, -74.00 40.73, "
    "-74.00 40.70))",
    "POLYGON ((-73.965 40.705, -73.94 40.71, -73.95 40.74, "
    "-73.965 40.705))",
]


def test_h3_zones_and_grid_equal_reference():
    """An H3 case (resolution 9 zones, a 48x64 two-band raster over
    Manhattan): zones and grid folds equal the port's oracle and the
    reference's fused map bit for bit."""
    col = wkt.from_wkt(H3_ZONES)
    ref_ix = ref_build(ref_tessellate(col, RefH3(), 9, keep_core_geoms=False))
    ix = build_chip_index(
        tessellate(_port_geometry(col), H3IndexSystem(), 9,
                   keep_core_geoms=False),
        device="cpu",
    )
    rng = np.random.default_rng(3)
    data = rng.uniform(1.0, 50.0, (2, 48, 64))
    data[0][rng.random((48, 64)) < 0.05] = np.nan
    gt = (-74.005, 0.001, 0.0, 40.745, 0.0, -0.001)
    r = Raster(data=data, gt=gt, srid=4326, nodata=float("nan"))
    rr = RefRaster(data=data, gt=gt, srid=4326, nodata=float("nan"))
    eng = ZonalEngine(H3IndexSystem(), 9, chip_index=ix, device="cpu")
    ref_eng = RefEngine(RefH3(), 9, chip_index=ref_ix)
    for by in ("zones", "grid"):
        e = E.norm_diff(E.band(2), E.band(1)).zonal(by=by)
        got = eng.map(e, r, tile=TILE)
        assert got.pixels > 0
        _assert_result_equal(got, E.host_expr_zonal_oracle(
            r, e, index_system=H3IndexSystem(), resolution=9,
            chip_index=ix if by == "zones" else None, tile=TILE, by=by,
        ))
        _assert_result_equal(got, ref_eng.map(
            RE.norm_diff(RE.band(2), RE.band(1)).zonal(by=by), rr,
            tile=TILE,
        ))
