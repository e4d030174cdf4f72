"""The port's resolution analyzer (`mosaic_tpu_torch/sql/analyzer.py`),
its geometry measures (`core/geometry/oracle.py area`, `centroid`) and
input coercion (`functions/_coerce.py`) against the reference's, on the
CPU. The analyzer is host numpy in both packages, so every resolution,
metric, area and centroid is compared exactly; the sample-strategy
errors are the reference's `tests/test_tune.py::TestSampleStrategyErrors`,
raised by both."""

import numpy as np
import pytest

from mosaic_tpu.core.geometry import oracle as ref_oracle
from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.index.bng import BNGIndexSystem as RefBNG
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.datasets import synthetic_zones as ref_synthetic_zones
from mosaic_tpu.functions import _coerce as ref_coerce
from mosaic_tpu.sql import analyzer as RA
from mosaic_tpu_torch.core.geometry import oracle
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.bng import BNGIndexSystem
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.datasets import synthetic_zones
from mosaic_tpu_torch.functions import _coerce
from mosaic_tpu_torch.sql import analyzer as TA

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)

SHAPES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1), (5 5, 5 8, 8 8, 8 5, 5 5))",
    "POLYGON ((20 0, 30 0, 30 10, 25 4, 20 10, 20 0))",
    "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
    "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 1, 0 0)), ((3 3, 5 3, 5 6, 3 3)))",
    "LINESTRING (0 0, 3 4, 6 0)",
    "POINT (2.5 -1)",
    "MULTIPOINT ((0 0), (2 2), (4 1))",
    # a clockwise outer ring and a degenerate (zero-area) polygon
    "POLYGON ((0 0, 0 4, 4 4, 4 0, 0 0))",
    "POLYGON ((0 0, 2 0, 4 0, 0 0))",
]


def port_col(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


@pytest.fixture(scope="module")
def shapes():
    col = wkt.from_wkt(SHAPES)
    return col, port_col(col)


SYSTEMS = {
    "custom": (lambda: RefCustom(RefConf(*CONF)), lambda: CustomIndexSystem(GridConf(*CONF))),
    "h3": (RefH3, H3IndexSystem),
    "bng": (RefBNG, BNGIndexSystem),
}


def _zones(name):
    """(reference, port) columns a system's analyzer runs on."""
    if name == "h3":
        ref = ref_synthetic_zones(6, 6, verts=32, seed=3)
        port = synthetic_zones(6, 6, verts=32, seed=3)
        np.testing.assert_array_equal(port.xy, np.asarray(ref.xy))
        return ref, port
    if name == "bng":
        ref = ref_synthetic_zones(5, 5, bbox=(500000.0, 170000.0, 540000.0, 200000.0),
                                  verts=12, seed=4, srid=27700)
        return ref, port_col(ref)
    col = wkt.from_wkt(SHAPES[:3])
    return col, port_col(col)


# ------------------------------------------------------------ measures


def test_area_equals_reference(shapes):
    ref, port = shapes
    np.testing.assert_array_equal(oracle.area(port), ref_oracle.area(ref))
    assert oracle.area(port)[2] == 225.0 and oracle.area(port)[4] == 0.0


def test_centroid_equals_reference(shapes):
    ref, port = shapes
    got = oracle.centroid(port)
    np.testing.assert_array_equal(got, ref_oracle.centroid(ref))
    np.testing.assert_array_equal(got[7], [2.0, 2.0])  # orientation-free


@pytest.mark.parametrize("name", ["h3", "bng"])
def test_measures_on_the_zone_sets(name):
    ref, port = _zones(name)
    np.testing.assert_array_equal(oracle.area(port), ref_oracle.area(ref))
    np.testing.assert_array_equal(oracle.centroid(port), ref_oracle.centroid(ref))


# ------------------------------------------------------------- analyzer


@pytest.mark.parametrize("name", list(SYSTEMS))
@pytest.mark.parametrize("target", [16.0, 64.0, 256.0])
def test_optimal_resolution_equals_reference(name, target):
    rsys, psys = (f() for f in SYSTEMS[name])
    ref, port = _zones(name)
    want = RA.MosaicAnalyzer(rsys, target_cells=target).get_optimal_resolution(ref)
    got = TA.MosaicAnalyzer(psys, target_cells=target).get_optimal_resolution(port)
    assert got == want and isinstance(got, int)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_resolution_metrics_equal_reference(name):
    rsys, psys = (f() for f in SYSTEMS[name])
    ref, port = _zones(name)
    strat = dict(fraction=0.5, limit=20)
    want = RA.MosaicAnalyzer(rsys).get_resolution_metrics(
        ref, RA.SampleStrategy(**strat), seed=4)
    got = TA.MosaicAnalyzer(psys).get_resolution_metrics(
        port, TA.SampleStrategy(**strat), seed=4)
    assert got == want and got


@pytest.mark.parametrize("name", ["custom", "h3"])
def test_reference_recipe_equals_reference(name):
    """The cell-boundary recipe (`get_optimal_resolution_reference`)
    reads `point_to_cell` and `cell_boundary` of the port's systems."""
    rsys, psys = (f() for f in SYSTEMS[name])
    ref, port = _zones(name)
    kw = dict(lower=1.0, upper=100.0) if name == "custom" else {}
    want = RA.MosaicAnalyzer(rsys).get_optimal_resolution_reference(ref, **kw)
    got = TA.MosaicAnalyzer(psys).get_optimal_resolution_reference(port, **kw)
    assert got == want


def test_percentile_and_seed_follow_the_reference():
    rsys, psys = (f() for f in SYSTEMS["h3"])
    ref, port = _zones("h3")
    for pct, seed in ((10.0, 0), (90.0, 3)):
        s = dict(fraction=0.3)
        want = RA.MosaicAnalyzer(rsys).get_optimal_resolution(
            ref, RA.SampleStrategy(**s), percentile=pct, seed=seed)
        got = TA.MosaicAnalyzer(psys).get_optimal_resolution(
            port, TA.SampleStrategy(**s), percentile=pct, seed=seed)
        assert got == want


def test_no_polygon_is_typed(shapes):
    _, port = shapes
    lines = port.take([4, 5, 6])
    with pytest.raises(ValueError, match="no polygonal geometries"):
        TA.MosaicAnalyzer(CustomIndexSystem(GridConf(*CONF))).get_optimal_resolution(lines)


# ------------------------------------------------------- sample strategy


class TestSampleStrategyErrors:
    """The reference's typed errors, raised by both packages."""

    @pytest.mark.parametrize("n", [0, -3])
    def test_zero_rows_typed(self, n):
        for mod in (RA, TA):
            with pytest.raises(ValueError, match="empty geometry column"):
                mod.SampleStrategy(fraction=1.0).apply(n, np.random.default_rng(0))

    def test_zero_fraction_typed(self):
        for mod in (RA, TA):
            with pytest.raises(ValueError, match="fraction"):
                mod.SampleStrategy(fraction=0.0)

    def test_overrange_fraction_typed(self):
        for mod in (RA, TA):
            with pytest.raises(ValueError, match="fraction"):
                mod.SampleStrategy(fraction=1.5)

    def test_zero_limit_typed(self):
        for mod in (RA, TA):
            with pytest.raises(ValueError, match="limit"):
                mod.SampleStrategy(fraction=1.0, limit=0)

    @pytest.mark.parametrize("n,fraction,limit", [(10, 1.0, None), (10, 0.35, None),
                                                  (100, 1.0, 7), (1, 0.01, None)])
    def test_samples_equal_reference(self, n, fraction, limit):
        want = RA.SampleStrategy(fraction, limit).apply(n, np.random.default_rng(9))
        got = TA.SampleStrategy(fraction, limit).apply(n, np.random.default_rng(9))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- coercion


@pytest.mark.parametrize("data,fmt", [
    (["POLYGON ((0 0, 1 0, 1 1, 0 0))"], "wkt"),
    ("POINT (1 2)", "wkt"),
    ([b"\x01\x01\x00\x00\x00"], "wkb"),
    (["0101000000000000000000F03F"], "hex"),
    ([{"type": "Point", "coordinates": [1, 2]}], "geojson"),
    (['{"type": "Point", "coordinates": [1, 2]}'], "geojson"),
])
def test_detect_format_equals_reference(data, fmt):
    assert _coerce.detect_format(data) == ref_coerce.detect_format(data) == fmt


def test_to_packed_passes_packed_columns_and_names_the_readers(shapes):
    _, port = shapes
    assert _coerce.to_packed(port) is port
    assert _coerce.coerce(port) == (port, "packed")
    # the readers are ported: WKT coerces to the reference's column
    got = _coerce.to_packed(["POINT (1 2)"])
    want = ref_coerce.to_packed(["POINT (1 2)"])
    for f in ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    with pytest.raises(TypeError, match="cannot interpret"):
        _coerce.detect_format([3.5])


@pytest.mark.parametrize("name", ["custom", "h3"])
def test_knn_model_default_resolution_equals_reference(name):
    """`SpatialKNN` without a resolution takes the analyzer's pick, as
    the reference's does."""
    from mosaic_tpu.models import knn as ref_knn_model
    from mosaic_tpu_torch.models import knn as knn_model

    rsys, psys = (f() for f in SYSTEMS[name])
    ref, port = _zones(name)
    assert knn_model._default_resolution(psys, port) == \
        ref_knn_model._default_resolution(rsys, ref)
