"""The custom rectangular grid: the port against the JAX package.

Both packages get the same numpy inputs made from a seed. Cell ids,
neighbourhoods, validity and string forms are integers and must be equal
exactly; centers and boundaries are f64 and must be equal bit for bit (the
decode is the same few correctly rounded f64 operations in both).
`point_to_cell` is also run on torch tensors, the port's device path.

The grid is the one the reference's zonal tests and `tools/raster_bench.py`
use: `CUSTOM(-180, 180, -90, 90, 2, 10, 10)`. Its join index, built by
each package from the same zones, must be equal field for field, and the
reference's index must carry across with `chip_index_from_reference`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.index.custom import custom_from_name as ref_from_name
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch.convert import chip_index_from_reference
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf, custom_from_name
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.sql import join as TJ

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
REF = RefCustom(RefConf(*CONF))
PORT = CustomIndexSystem(GridConf(*CONF))
RES = 3
ZONES = [
    "POLYGON ((6 -20, 50 -25, 70 10, 40 8, 6 8, 6 -20), "
    "(20 -10, 30 -10, 30 -2, 20 -2, 20 -10))",
    "POLYGON ((55 -50, 85 -50, 85 -20, 70 -35, 55 -20, 55 -50))",
    "POLYGON ((2 -55, 20 -55, 20 -40, 2 -40, 2 -55))",
]
FIELDS = TJ.ChipIndex.field_names() + [f"border.{n}" for n in TJ.ChipIndex._BORDER]


def port_geometry(col) -> PackedGeometry:
    """The port's geometry column with the reference column's arrays."""
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def reference_arrays(ix) -> dict:
    out = {n: np.asarray(getattr(ix, n)) for n in TJ.ChipIndex.field_names()}
    out.update(
        {f"border.{n}": np.asarray(getattr(ix.border, n)) for n in TJ.ChipIndex._BORDER}
    )
    out.update(ix.host.save_arrays())
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def points():
    """Random points, points exactly on cell edges at every resolution
    tested, and points outside the bounds (clamped to the border cells)."""
    rng = np.random.default_rng(7)
    pts = [rng.uniform((-180, -90), (180, 90), (3000, 2))]
    for r in (0, RES, 6):
        w, h = PORT.cell_size(r)
        ix = rng.integers(0, PORT.cells_x(r), 200)
        iy = rng.integers(0, PORT.cells_y(r), 200)
        pts.append(np.stack([-180 + ix * w, -90 + iy * h], axis=1))
    pts.append(np.array([[-181.0, 0.0], [180.0, 90.0], [200.0, -95.0], [0.0, 0.0]]))
    return np.concatenate(pts)


@pytest.fixture(scope="module")
def cells(points):
    return np.concatenate([np.asarray(REF.point_to_cell(jnp.asarray(points), r))
                           for r in (0, RES, 6)])


def test_conf_and_resolutions():
    assert PORT.name == REF.name
    assert list(PORT.resolutions()) == list(REF.resolutions())
    assert PORT.conf.max_resolution == REF.conf.max_resolution
    for r in PORT.resolutions():
        assert PORT.cell_size(r) == REF.cell_size(r)
        assert PORT.buffer_radius(r) == REF.buffer_radius(r)
        assert PORT.cell_area_approx(r) == REF.cell_area_approx(r)
    assert PORT.min_resolution() == REF.min_resolution()
    assert PORT.max_resolution() == REF.max_resolution()


@pytest.mark.parametrize("res", [0, RES, 6, 20])
def test_point_to_cell_equals_reference(points, res):
    res = min(res, PORT.conf.max_resolution)
    want = np.asarray(REF.point_to_cell(jnp.asarray(points), res))
    host = PORT.point_to_cell(points, res)
    dev = PORT.point_to_cell(torch.from_numpy(points), res)
    assert host.dtype == np.int64 and dev.dtype == torch.int64
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev.numpy(), want)


def test_decode_equals_reference(cells):
    for name in ("cell_center", "cell_boundary"):
        want = np.asarray(getattr(REF, name)(jnp.asarray(cells)))
        got = getattr(PORT, name)(cells)
        assert _same(got, want), name
        dev = getattr(PORT, name)(torch.from_numpy(cells))
        assert isinstance(dev, torch.Tensor) and _same(dev.numpy(), want), name
    np.testing.assert_array_equal(
        PORT.resolution_of(cells), np.asarray(REF.resolution_of(jnp.asarray(cells)))
    )


def test_is_valid_equals_reference(cells):
    bad = np.array([-1, (30 << 56) | 5, (1 << 56) | (10**9), 0], np.int64)
    c = np.concatenate([cells, bad])
    want = np.asarray(REF.is_valid(jnp.asarray(c)))
    np.testing.assert_array_equal(PORT.is_valid(c), want)
    assert not want[-4:-1].any() and want[-1]


@pytest.mark.parametrize("k", [0, 1, 3])
def test_neighbours_equal_reference(cells, k):
    c = cells[::7]
    for name in ("k_ring", "k_loop"):
        want = np.asarray(getattr(REF, name)(jnp.asarray(c), k))
        assert _same(getattr(PORT, name)(c, k), want), name
    loop = np.asarray(REF.k_loop(jnp.asarray(c), k))
    a = np.repeat(c, loop.shape[1])[loop.reshape(-1) >= 0]
    b = loop.reshape(-1)[loop.reshape(-1) >= 0]
    want = np.asarray(REF.grid_distance(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(PORT.grid_distance(a, b), want)
    assert (want == k).all()


@pytest.mark.parametrize(
    "bounds",
    [(6.0, -25.0, 70.0, 10.0), (-200.0, -100.0, -170.0, -80.0), (5.0, 5.0, 5.0, 9.0),
     (0.3, 0.3, 0.7, 0.9)],
)
def test_polyfill_candidates_equal_reference(bounds):
    b = np.asarray(bounds)
    np.testing.assert_array_equal(
        PORT.polyfill_candidates(b, RES), REF.polyfill_candidates(b, RES)
    )


def test_strings_and_name_parse(cells):
    assert PORT.format(cells) == REF.format(cells)
    s = REF.format(cells)
    np.testing.assert_array_equal(PORT.parse(s), REF.parse(s))
    spec = "CUSTOM(-180, 180, -90, 90, 2, 10, 10)"
    assert custom_from_name(spec).conf == GridConf(*CONF)
    assert custom_from_name(spec).name == ref_from_name(spec).name
    with pytest.raises(ValueError, match="CUSTOM"):
        custom_from_name("H3")


@pytest.fixture(scope="module")
def indexes():
    col = wkt.from_wkt(ZONES)
    ref = RJ.build_chip_index(ref_tessellate(col, REF, RES, keep_core_geoms=False))
    port = TJ.build_chip_index(
        tessellate(port_geometry(col), PORT, RES, keep_core_geoms=False), device="cpu"
    )
    return reference_arrays(ref), port


@pytest.mark.parametrize("field", FIELDS)
def test_chip_index_field_equal_on_custom_grid(indexes, field):
    ref, port = indexes
    assert _same(port.to_arrays()[field], ref[field])


def test_chip_index_from_reference_on_custom_grid(indexes):
    ref, port = indexes
    ix = chip_index_from_reference(ref, device="cpu")
    for n in TJ.ChipIndex.field_names():
        assert torch.equal(getattr(ix, n), getattr(port, n)), n
    got = ix.host.save_arrays()
    for k, v in port.host.save_arrays().items():
        assert _same(got[k], v), k
