"""The index helpers the port carries beside the reference's:
`core.index.index_system_from_name` and `H3`, H3's `resolution`,
`base_cell`, `cell_to_owned_fijk`, `geo_azimuth` and `select_rows`,
`DeviceGeometry.vert_mask`/`ring_mask` and `ChipTable.core_count`.

Integers are compared exactly; the torch f64 azimuth within 4 ulp of the
numpy lane (torch's CPU trig is not numpy's), the numpy lane bit for
bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mosaic_tpu.core import tessellate as ref_tz
from mosaic_tpu.core.geometry import wkt as ref_wkt
from mosaic_tpu.core.geometry.device import pack_to_device as ref_pack
from mosaic_tpu.core import index as ref_index
from mosaic_tpu.core.index.h3 import core as ref_core
from mosaic_tpu.core.index.h3 import hexmath as ref_hm
from mosaic_tpu.core.index.h3.tables import derive as ref_derive
from mosaic_tpu_torch.core import index as port_index
from mosaic_tpu_torch.core import tessellate as tz
from mosaic_tpu_torch.core.geometry import wkt
from mosaic_tpu_torch.core.geometry.device import pack_to_device
from mosaic_tpu_torch.core.index.h3 import core
from mosaic_tpu_torch.core.index.h3 import hexmath as hm

CPU = hm.TorchNamespace("cpu")
N_CELLS = 10_000

# the inputs of the reference's tests/test_tessellate.py
POLY = "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))"
POLY_HOLE = "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1), (5 5, 5 8, 8 8, 8 5, 5 5))"
MULTIPOLY = "MULTIPOLYGON (((0 0, 6 0, 6 6, 0 6, 0 0)), ((20 20, 26 20, 26 27, 20 27, 20 20)))"
LINE = "LINESTRING (0 0, 9 4, 14 -3, 21 8)"
CUSTOM_SPEC = "CUSTOM(-180,180,-90,90,2,10,10)"


# ----------------------------------------------------- index_system_from_name


@pytest.mark.parametrize("name", ["H3", " bng ", "h3", CUSTOM_SPEC, " CUSTOM(0,100,0,50,4,25,25) "])
def test_index_system_from_name_matches_the_reference(name):
    got = port_index.index_system_from_name(name)
    want = ref_index.index_system_from_name(name)
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name
    if hasattr(want, "conf"):
        assert tuple(vars(got.conf).values()) == tuple(vars(want.conf).values())


def test_named_singletons():
    assert port_index.index_system_from_name("H3") is port_index.H3
    assert port_index.index_system_from_name("bng") is port_index.BNG
    assert isinstance(port_index.H3, port_index.H3IndexSystem)


@pytest.mark.parametrize("name", ["S2", "", "CUSTOM", "H3 BNG", "custom(0,100,0,50,4,25,25)"])
def test_unknown_name_raises_the_references_error(name):
    with pytest.raises(ValueError) as want:
        ref_index.index_system_from_name(name)
    with pytest.raises(ValueError) as got:
        port_index.index_system_from_name(name)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- H3 cells


def _pentagon_centres() -> np.ndarray:
    """(12, 2) lng/lat degrees of the 12 pentagon base cells' centres."""
    bcs = np.nonzero(ref_derive().is_pentagon)[0]
    cells = (np.int64(1) << 59) | (bcs.astype(np.int64) << 45) | np.int64((1 << 45) - 1)
    lat, lng = ref_core.cell_to_geo(cells)
    return np.stack([np.degrees(lng), np.degrees(lat)], -1)


@pytest.fixture(scope="module")
def cells() -> np.ndarray:
    """10,000 seeded cells over res 0-15: random points on the sphere, the
    12 pentagons at every resolution and a point beside each of them."""
    rng = np.random.default_rng(2024)
    pent = _pentagon_centres()
    extra = []
    for r in range(16):
        extra.append(ref_index.H3.point_to_cell(pent, r))
        near = pent + rng.normal(scale=2.0 ** -r, size=pent.shape)
        near[:, 1] = np.clip(near[:, 1], -89.9, 89.9)
        extra.append(ref_index.H3.point_to_cell(near, r))
    extra = np.concatenate(extra)
    n = N_CELLS - len(extra)
    pts = np.stack([
        rng.uniform(-180.0, 180.0, n),
        np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, n))),
    ], -1)
    res = np.arange(n) % 16
    rand = np.empty(n, np.int64)
    for r in range(16):
        rand[res == r] = ref_index.H3.point_to_cell(pts[res == r], r)
    out = np.concatenate([rand, extra]).astype(np.int64)
    assert out.shape == (N_CELLS,)
    assert ref_core.is_pentagon_cell(out).sum() >= 12 * 16
    return out


@pytest.mark.parametrize("fn", ["resolution", "base_cell"])
def test_cell_fields_match_the_reference(cells, fn):
    want = getattr(ref_core, fn)(cells)
    got = getattr(core, fn)(cells)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    t = getattr(core, fn)(torch.as_tensor(cells), CPU)
    assert t.dtype == torch.int64 and t.device.type == "cpu"
    assert np.array_equal(t.numpy(), want)
    if fn == "resolution":
        assert set(want.tolist()) == set(range(16))


def test_cell_to_owned_fijk_matches_the_reference(cells):
    want = ref_core.cell_to_owned_fijk(cells)
    got = core.cell_to_owned_fijk(cells)
    lanes = core.cell_to_owned_fijk(torch.as_tensor(cells), CPU)
    assert len(got) == len(lanes) == len(want) == 5
    for g, t, w in zip(got, lanes, want):
        w = np.asarray(w)
        assert np.asarray(g).dtype == w.dtype and np.array_equal(g, w)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), w)


def test_geo_azimuth_matches_the_reference():
    rng = np.random.default_rng(17)
    n = 10_000
    lat1, lat2 = (np.arcsin(rng.uniform(-1, 1, n)) for _ in range(2))
    lng1, lng2 = (rng.uniform(-np.pi, np.pi, n) for _ in range(2))
    want = ref_hm.geo_azimuth(lat1, lng1, lat2, lng2)
    got = hm.geo_azimuth(lat1, lng1, lat2, lng2)
    assert got.tobytes() == want.tobytes()
    t = hm.geo_azimuth(*(torch.as_tensor(a) for a in (lat1, lng1, lat2, lng2)), xp=CPU)
    assert t.dtype == torch.float64
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(t.numpy() - want) <= 4 * ulp)


# -------------------------------------------- tessellation and device masks


def _cols(w):
    return wkt.from_wkt([w]), ref_wkt.from_wkt([w])


@pytest.mark.parametrize("res", [2, 3])
@pytest.mark.parametrize("w", [POLY, POLY_HOLE, MULTIPOLY, LINE])
def test_core_count_matches_the_reference(w, res):
    port_col, ref_col = _cols(w)
    got = tz.tessellate(port_col, port_index.index_system_from_name(CUSTOM_SPEC), res)
    want = ref_tz.tessellate(ref_col, ref_index.index_system_from_name(CUSTOM_SPEC), res)
    assert isinstance(got.core_count(), int)
    assert got.core_count() == want.core_count() == int(want.is_core.sum())


@pytest.mark.parametrize("w", [POLY, POLY_HOLE, MULTIPOLY, LINE])
def test_device_masks_match_the_reference(w):
    port_col, ref_col = _cols(w)
    got = pack_to_device(port_col, device="cpu")
    want = ref_pack(ref_col)
    for name in ("vert_mask", "ring_mask"):
        g, r = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.bool and g.device == got.verts.device
        assert tuple(g.shape) == r.shape and np.array_equal(g.numpy(), r), name
    G, R, V, _ = got.verts.shape
    assert tuple(got.vert_mask.shape) == (G, R, V) and tuple(got.ring_mask.shape) == (G, R)


@pytest.mark.parametrize("table_shape", [(20,), (20, 3), (20, 3, 3)])
def test_select_rows_matches_the_reference(table_shape):
    table = np.random.default_rng(3).random(table_shape)
    chips = ref_tz.tessellate(ref_wkt.from_wkt([POLY_HOLE]), ref_index.index_system_from_name(CUSTOM_SPEC), 3)
    idx = (np.asarray(chips.cell_id) % 20).astype(np.int32).reshape(-1, 1)
    want = ref_hm.select_rows(idx, table, 20, np)
    got = hm.select_rows(idx, table, 20, np)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    t = hm.select_rows(torch.as_tensor(idx), table, 20, CPU)
    assert t.dtype == torch.float64 and tuple(t.shape) == want.shape
    assert t.numpy().tobytes() == want.tobytes()
