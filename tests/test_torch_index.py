"""Tessellation and the join index: the port builds exactly the reference's
arrays, field by field (shape, dtype and bytes — tolerance 0, in the
manner of `mosaic_tpu/index/epoch.py chip_index_equal`), and
`chip_index_from_reference` carries a reference index across unchanged.

The zones are `synthetic_zones(3, 3, verts=256)` over a 0.1° box: at
H3 res 9 over the default NYC box those zones have no heavy cell (each
cell sees only a few of a zone's 256 vertices), so the box is shrunk
until cells hold more than EDGE_CAP edges — as the NYC shorelines do.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.datasets import synthetic_zones as ref_zones
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch.convert import chip_index_from_reference
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.datasets import synthetic_zones
from mosaic_tpu_torch.sql import join as TJ

BBOX = (-74.0, 40.7, -73.9, 40.786)
RES = 9
FIELDS = TJ.ChipIndex.field_names() + [f"border.{n}" for n in TJ.ChipIndex._BORDER]


def reference_arrays(ix) -> dict:
    """A reference ChipIndex as {field: numpy array} (+ host companion)."""
    out = {n: np.asarray(getattr(ix, n)) for n in TJ.ChipIndex.field_names()}
    out.update(
        {f"border.{n}": np.asarray(getattr(ix.border, n)) for n in TJ.ChipIndex._BORDER}
    )
    out.update(ix.host.save_arrays())
    return out


@pytest.fixture(scope="module")
def built():
    rtab = ref_tessellate(ref_zones(3, 3, bbox=BBOX, verts=256), RefH3(), RES,
                          keep_core_geoms=False)
    ttab = tessellate(synthetic_zones(3, 3, bbox=BBOX, verts=256), H3IndexSystem(),
                      RES, keep_core_geoms=False)
    ref = RJ.build_chip_index(rtab)
    port = TJ.build_chip_index(ttab, device="cpu")
    return rtab, ttab, reference_arrays(ref), port


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_tessellation_equal(built):
    rtab, ttab, _, _ = built
    for n in ("geom_id", "cell_id", "is_core", "has_geom"):
        assert _same(getattr(ttab, n), getattr(rtab, n)), n
    for n in ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type"):
        assert _same(getattr(ttab.chips, n), getattr(rtab.chips, n)), n


def test_index_has_every_lane(built):
    _, _, _, port = built
    assert port.num_heavy_cells > 0
    assert port.num_convex_cells > 0
    assert port.num_cells > port.num_heavy_cells + port.num_convex_cells


@pytest.mark.parametrize("field", FIELDS)
def test_chip_index_field_equal(built, field):
    _, _, ref, port = built
    assert _same(port.to_arrays()[field], ref[field])


def test_host_companion_equal(built):
    _, _, ref, port = built
    got = port.host.save_arrays()
    for k, v in got.items():
        assert _same(v, ref[k]), k


def test_chip_index_from_reference_round_trips(built):
    _, _, ref, port = built
    ix = chip_index_from_reference(ref, device="cpu")
    back = ix.to_arrays()
    assert set(back) == set(ref)
    for k in ref:
        assert _same(back[k], ref[k]), k
    # and it is the same index the port builds itself
    for n in TJ.ChipIndex.field_names():
        assert torch.equal(getattr(ix, n), getattr(port, n)), n
    assert ix.cell_ebits.dtype == torch.int32 and ix.hash_mult.dtype == torch.int64
