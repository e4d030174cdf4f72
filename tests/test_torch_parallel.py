"""The port's sharded join (`mosaic_tpu_torch/parallel/dist_join.py`) on
the CPU.

Mirrors, case for case, `tests/test_dist_join.py` (the ``(dp, cell)``
step at ``cell_axis`` 1, 2, 4 and 8, the replicated and the indivisible
hash table, the padded index, the never-matching point pads) and
`tests/test_resilience.py`'s `dist_pip_join` cases (clean, shrunken caps
with transient faults, exhausted retries degrading on the CPU). The pair
axes (`dist_knn`, `dist_overlay`, the meshed overlay) are in
`tests/test_torch_parallel_pairs.py`: the reference's compiles of both
halves would not fit one file's time.

The reference runs on its 8 virtual CPU devices; the port runs each
meshed call on a logical CPU mesh of the same shape (``devices=["cpu"] *
8``: a mesh's device list may repeat a device). Every meshed answer is
held bit for bit (tolerance 0; float64 through an integer view) against
the port's single-device call and against the reference's meshed call on
the same seeded numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.datasets import synthetic_zones as ref_zones
from mosaic_tpu.parallel import dist_join as RD
from mosaic_tpu.runtime import faults as ref_faults
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.datasets import random_points, synthetic_zones
from mosaic_tpu_torch.parallel import dist_join as D
from mosaic_tpu_torch.runtime import DegradedResult, faults, telemetry
from mosaic_tpu_torch.sql import join as TJ

RES = 7
BBOX = (-74.05, 40.60, -73.85, 40.78)


def logical_mesh(n, **kw):
    """The port's stand-in for the reference's ``make_mesh(n, ...)``."""
    return D.make_mesh(n, devices=["cpu"] * n, **kw)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------ dist_join


@pytest.fixture(scope="module")
def problem():
    """The reference's `tests/test_dist_join.py` problem in both packages:
    3x3 zones at H3 resolution 7 and 301 points (odd: the point axis pads)."""
    zones = synthetic_zones(3, 3, bbox=BBOX)
    index = TJ.build_chip_index(
        tessellate(zones, H3IndexSystem(), RES, keep_core_geoms=False), device="cpu"
    )
    ref_index = RJ.build_chip_index(
        ref_tessellate(ref_zones(3, 3, bbox=BBOX), RefH3(), RES, keep_core_geoms=False)
    )
    pts = random_points(301, bbox=BBOX, seed=5)
    cells = H3IndexSystem().point_to_cell(torch.from_numpy(pts), RES).numpy()
    np.testing.assert_array_equal(
        cells, np.asarray(RefH3().point_to_cell(jnp.asarray(pts), RES))
    )
    shifted = (pts - index.host.shift).astype(np.float32)
    single = TJ.pip_join_points(
        torch.from_numpy(shifted), torch.from_numpy(cells), index
    ).numpy()
    ref_single = np.asarray(RJ.pip_join_points(
        jnp.asarray(shifted), jnp.asarray(cells), ref_index
    ))
    _same(single, ref_single)
    return index, ref_index, shifted, cells, single, len(zones)


def _run(mesh, index, shifted, cells, num_zones, table_size):
    index = D.pad_index_for_shards(index, mesh.shape["cell"])
    p, c = D.pad_points(shifted, cells, mesh.size)
    step = D.distributed_join_step(mesh, num_zones, table_size=table_size)
    match, counts = step(torch.from_numpy(p), torch.from_numpy(c), index)
    return match.numpy()[: shifted.shape[0]], counts.numpy()


def _ref_run(n, cell_axis, index, shifted, cells, num_zones, table_size):
    mesh = RD.make_mesh(n, cell_axis=cell_axis)
    index = RD.pad_index_for_shards(index, mesh.shape["cell"])
    p, c = RD.pad_points(shifted, cells, mesh.size)
    step = RD.distributed_join_step(mesh, num_zones, table_size=table_size)
    match, counts = step(jnp.asarray(p), jnp.asarray(c), index)
    return np.asarray(match)[: shifted.shape[0]], np.asarray(counts)


@pytest.mark.parametrize("cell_axis", [1, 2, 4, 8])
def test_mesh_shapes_match_single_device(problem, cell_axis):
    index, ref_index, shifted, cells, single, nz = problem
    mesh = logical_mesh(8, cell_axis=cell_axis)
    assert mesh.shape == {"dp": 8 // cell_axis, "cell": cell_axis}
    T = int(index.table_cell.shape[0])
    match, counts = _run(mesh, index, shifted, cells, nz, T)
    _same(match, single)
    # summed per-zone histogram == host bincount of the single-device match
    _same(counts, np.bincount(single[single >= 0], minlength=nz).astype(np.int64))
    ref_match, ref_counts = _ref_run(8, cell_axis, ref_index, shifted, cells, nz, T)
    _same(match, ref_match)
    _same(counts, ref_counts)


def test_replicated_table_path(problem):
    """table_size=None keeps the hash table replicated — same answer."""
    index, ref_index, shifted, cells, single, nz = problem
    with telemetry.capture() as ev:
        match, _ = _run(logical_mesh(8, cell_axis=2), index, shifted, cells, nz, None)
    _same(match, single)
    layout = [e for e in ev if e["event"] == "dist_join_layout"]
    assert layout and not layout[0]["table_sharded"]
    _same(match, _ref_run(8, 2, ref_index, shifted, cells, nz, None)[0])


def test_indivisible_table_falls_back_to_replicated(problem):
    """A table size the cell axis doesn't divide must still be correct."""
    index, ref_index, shifted, cells, single, nz = problem
    T1 = int(index.table_cell.shape[0]) + 1
    match, _ = _run(logical_mesh(8, cell_axis=4), index, shifted, cells, nz, T1)
    _same(match, single)
    _same(match, _ref_run(8, 4, ref_index, shifted, cells, nz, T1)[0])


def test_pad_index_roundtrip(problem):
    """Padding preserves the single-device join result exactly."""
    index, ref_index, shifted, cells, single, nz = problem
    padded = D.pad_index_for_shards(index, 8)
    assert int(padded.cells.shape[0]) % 8 == 0
    assert int(padded.chip_geom.shape[0]) % 8 == 0
    assert int(padded.cells[-1]) == np.iinfo(np.int64).max
    assert padded.host is index.host
    out = TJ.pip_join_points(torch.from_numpy(shifted), torch.from_numpy(cells), padded)
    _same(out.numpy(), single)
    ref_padded = RD.pad_index_for_shards(ref_index, 8)
    for f in TJ.ChipIndex.field_names():
        np.testing.assert_array_equal(
            getattr(padded, f).numpy().view(np.asarray(getattr(ref_padded, f)).dtype)
            if f in ("cell_ebits", "heavy_ebits", "convex_ebits", "hash_mult")
            else getattr(padded, f).numpy(),
            np.asarray(getattr(ref_padded, f)), err_msg=f,
        )


def test_pad_points_sentinels_never_match(problem):
    index, ref_index, shifted, cells, single, nz = problem
    p, c = D.pad_points(shifted, cells, 8)
    assert p.shape[0] % 8 == 0 and (c[shifted.shape[0]:] == -1).all()
    idx = D.pad_index_for_shards(index, 2)
    step = D.distributed_join_step(
        logical_mesh(8, cell_axis=2), nz, table_size=int(idx.table_cell.shape[0])
    )
    match, _ = step(torch.from_numpy(p), torch.from_numpy(c), idx)
    match = match.numpy()
    assert (match[shifted.shape[0]:] == -1).all()
    ref_idx = RD.pad_index_for_shards(ref_index, 2)
    ref_step = RD.distributed_join_step(
        RD.make_mesh(8, cell_axis=2), nz, table_size=int(ref_idx.table_cell.shape[0])
    )
    _same(match, np.asarray(ref_step(jnp.asarray(p), jnp.asarray(c), ref_idx)[0]))


# --------------------------------------------- dist_pip_join under faults


@pytest.fixture(scope="module")
def resilient():
    """`tests/test_resilience.py`'s problem: a chip index with a tiny
    edge_cap so heavy (tier-2) cells exist, 1,200 points, f64 cells."""
    zones = synthetic_zones(3, 3, bbox=BBOX)
    index = TJ.build_chip_index(
        tessellate(zones, H3IndexSystem(), RES, keep_core_geoms=False),
        edge_cap=8, device="cpu",
    )
    assert index.num_heavy_cells > 0
    ref_index = RJ.build_chip_index(
        ref_tessellate(ref_zones(3, 3, bbox=BBOX), RefH3(), RES, keep_core_geoms=False),
        edge_cap=8,
    )
    pts = random_points(1200, bbox=BBOX, seed=5)
    cells = H3IndexSystem().point_to_cell(torch.from_numpy(pts), RES).numpy()
    clean = TJ.pip_join(pts, None, H3IndexSystem(), RES, chip_index=index,
                        recheck=False, cell_dtype=torch.float64, device="cpu")
    return index, ref_index, pts, cells, clean, len(zones)


def test_dist_pip_join_clean_matches_pip_join(resilient):
    index, ref_index, pts, cells, clean, nz = resilient
    match, counts = D.dist_pip_join(pts, cells, index, logical_mesh(8, cell_axis=2), nz)
    _same(match, clean)
    _same(counts, np.bincount(clean[clean >= 0], minlength=nz).astype(np.int64))
    rm, rc = RD.dist_pip_join(pts, cells, ref_index, RD.make_mesh(8, cell_axis=2), nz)
    _same(match, np.asarray(rm))
    _same(counts, np.asarray(rc))


def test_dist_pip_join_faults_bit_identical(resilient):
    """Shrunken caps AND two transient failures: the distributed join
    still converges to the clean answer, with the trail in telemetry."""
    index, ref_index, pts, cells, clean, nz = resilient
    with telemetry.capture() as ev:
        with faults.shrink_caps(found_cap=16, heavy_cap=16):
            with faults.transient_errors(2, sites=("dist_join.step",)):
                match, counts = D.dist_pip_join(
                    pts, cells, index, logical_mesh(8, cell_axis=2), nz, probe="adaptive"
                )
    _same(match, clean)
    assert (match != TJ.OVERFLOW).all()
    kinds = [e["event"] for e in ev]
    assert kinds.count("transient_retry") == 2
    assert "capacity_overflow" in kinds and "escalation_resolved" in kinds
    with ref_faults.shrink_caps(found_cap=16, heavy_cap=16):
        rm, rc = RD.dist_pip_join(pts, cells, ref_index, RD.make_mesh(8, cell_axis=2),
                                  nz, probe="adaptive")
    _same(match, np.asarray(rm))
    _same(counts, np.asarray(rc))


def test_dist_pip_join_exhaustion_degrades(resilient):
    """On the CPU exhausted retries answer from the f64 host oracle,
    flagged; the reference's degraded answer is the same."""
    index, ref_index, pts, cells, clean, nz = resilient
    with faults.transient_errors(99, sites=("dist_join.step",)):
        match, counts = D.dist_pip_join(pts, cells, index, logical_mesh(8, cell_axis=2), nz)
    assert isinstance(match, DegradedResult) and match.degraded
    expect = TJ.host_join_with_cells(pts, cells, index.host)
    _same(np.asarray(match), expect)
    _same(counts, np.bincount(expect[expect >= 0], minlength=nz).astype(np.int64))
    with ref_faults.transient_errors(99, sites=("dist_join.step",)):
        rm, rc = RD.dist_pip_join(pts, cells, ref_index, RD.make_mesh(8, cell_axis=2), nz)
    _same(np.asarray(match), np.asarray(rm))
    _same(counts, np.asarray(rc))
