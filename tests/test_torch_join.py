"""The join probe and the managed join: the port against the JAX package.

`pip_join_points` runs in both packages on ONE index — built by the
reference and carried across with `chip_index_from_reference` — and on
the same cells and narrowed points, over the adversarial batches of
`tests/test_probe_adaptive.py` (mixed, all-light, all-heavy,
convex-only, near-edge band). Every probe mode, the banded variant and
undersized caps (OVERFLOW rows) must match exactly (tolerance 0): the
probe is integer and f32 compare/arith work in the same op order.

`pip_join` end to end (each package tessellating and building its own
index, cells in float64) must equal `mosaic_tpu.sql.join.pip_join`
exactly, and the port's `host_join` the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.datasets import synthetic_zones as ref_zones
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch.convert import chip_index_from_reference
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.datasets import synthetic_zones
from mosaic_tpu_torch.runtime.errors import CapacityOverflow
from mosaic_tpu_torch.runtime.escalate import run_escalating
from mosaic_tpu_torch.sql import join as TJ

BBOX = (-74.0, 40.7, -73.9, 40.786)
RES = 9
MODES = ("scatter", "adaptive", "adaptive-light", "adaptive-heavy", "adaptive-convex")
BATCHES = ("mixed", "all_light", "all_heavy", "convex_only", "near_edge_band")
N_BATCH = 1024


@pytest.fixture(scope="module")
def ref_index():
    col = ref_zones(3, 3, bbox=BBOX, verts=256)
    ix = RJ.build_chip_index(ref_tessellate(col, RefH3(), RES, keep_core_geoms=False))
    assert ix.num_heavy_cells > 0 and ix.num_convex_cells > 0
    return ix


@pytest.fixture(scope="module")
def port_index(ref_index):
    arrays = {n: np.asarray(getattr(ref_index, n)) for n in TJ.ChipIndex.field_names()}
    arrays.update({
        f"border.{n}": np.asarray(getattr(ref_index.border, n))
        for n in TJ.ChipIndex._BORDER
    })
    arrays.update(ref_index.host.save_arrays())
    return chip_index_from_reference(arrays, device="cpu")


@pytest.fixture(scope="module")
def batches(ref_index):
    """{name: (raw f64 points, cells)} — one batch per adversarial shape."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(BBOX[:2], BBOX[2:], (6000, 2))
    cells = RefH3().point_to_cell(pts, RES)
    ucells = np.asarray(ref_index.cells)
    u = np.clip(np.searchsorted(ucells, cells), 0, len(ucells) - 1)
    found = ucells[u] == cells
    heavy = found & (np.asarray(ref_index.cell_heavy)[u] >= 0)
    convex = found & (np.asarray(ref_index.cell_convex)[u] >= 0)

    edges = np.asarray(ref_index.cell_edges, dtype=np.float64)
    ab = edges[np.asarray(ref_index.cell_ebits) != 0]
    ab = ab[rng.permutation(len(ab))[:400]]
    a, b = ab[:, 0:2], ab[:, 2:4]
    mid, t = 0.5 * (a + b), b - a
    nrm = np.stack([-t[:, 1], t[:, 0]], axis=1)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    shift = np.asarray(ref_index.border.shift, dtype=np.float64)
    band = np.concatenate(
        [mid + d * s * nrm for d in (1e-7, 1e-5) for s in (1, -1)]
    ) + shift

    out = {
        "mixed": pts,
        "all_light": pts[found & ~heavy & ~convex],
        "all_heavy": pts[heavy],
        "convex_only": pts[convex],
        "near_edge_band": band,
    }
    res = {}
    for name, p in out.items():
        assert len(p) > 0, name
        # one batch length: the reference's eager ops compile once per shape
        p = p[rng.choice(len(p), N_BATCH, replace=len(p) < N_BATCH)]
        res[name] = (p, RefH3().point_to_cell(p, RES))
    return res


def _both(ref_index, port_index, pts, cells, **kw):
    """(reference, port) pip_join_points outputs as numpy."""
    shift = ref_index.host.shift
    shifted = (pts - shift).astype(np.float32)
    eps2 = kw.pop("eps2", None)
    want = RJ.pip_join_points(
        jnp.asarray(shifted), jnp.asarray(cells), ref_index,
        edge_eps2=None if eps2 is None else jnp.asarray(eps2, jnp.float32), **kw,
    )
    got = TJ.pip_join_points(
        torch.as_tensor(shifted), torch.as_tensor(cells), port_index,
        edge_eps2=None if eps2 is None else torch.tensor(eps2, dtype=torch.float32),
        **kw,
    )
    if eps2 is None:
        return np.asarray(want), got.numpy()
    return (np.asarray(want[0]), np.asarray(want[1])), (got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mode", MODES)
def test_probe_modes_equal_reference(ref_index, port_index, batches, mode, batch):
    pts, cells = batches[batch]
    want, got = _both(ref_index, port_index, pts, cells, probe=mode)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want, err_msg=f"{mode}/{batch}")


@pytest.mark.parametrize("writeback", ["gather", "direct"])
def test_writebacks_equal_reference(ref_index, port_index, batches, writeback):
    pts, cells = batches["mixed"]
    for probe in (("scatter",) if writeback == "direct" else ("scatter", "adaptive")):
        want, got = _both(ref_index, port_index, pts, cells, probe=probe,
                          writeback=writeback)
        np.testing.assert_array_equal(got, want, err_msg=f"{writeback}/{probe}")


@pytest.mark.parametrize("mode", MODES)
def test_banded_outputs_equal_reference(ref_index, port_index, batches, mode):
    """Match rows AND band flags of the banded variant, per mode."""
    pts, cells = batches["near_edge_band"]
    (w, wn), (g, gn) = _both(ref_index, port_index, pts, cells, probe=mode,
                             eps2=np.float32(1e-10))
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(gn, wn)
    assert wn.any()


@pytest.mark.parametrize(
    "cap, batch",
    [("found_cap", "mixed"), ("heavy_cap", "all_heavy"), ("convex_cap", "convex_only")],
)
def test_undersized_caps_overflow_like_reference(
    ref_index, port_index, batches, cap, batch
):
    pts, cells = batches[batch]
    want, got = _both(ref_index, port_index, pts, cells, probe="adaptive",
                      **{cap: 8})
    assert (want == TJ.OVERFLOW).any()
    np.testing.assert_array_equal(got, want)


def test_probe_counts_equal_reference(ref_index, port_index, batches):
    pts, cells = batches["mixed"]
    want = np.asarray(RJ._probe_counts(jnp.asarray(cells), ref_index))
    got = TJ._probe_counts(torch.as_tensor(cells), port_index).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- managed join


@pytest.fixture(scope="module")
def own_indexes(ref_index):
    """Each package tessellates and builds its own index (the reference's
    is ``ref_index``; the port's is built here, once for the module)."""
    col = synthetic_zones(3, 3, bbox=BBOX, verts=256)
    port = TJ.build_chip_index(
        tessellate(col, H3IndexSystem(), RES, keep_core_geoms=False), device="cpu"
    )
    return ref_index, port


@pytest.mark.parametrize(
    "probe, batch_size", [("scatter", None), ("adaptive", None), ("adaptive", 512)]
)
def test_pip_join_equals_reference(own_indexes, batches, probe, batch_size):
    ref, port = own_indexes
    pts = batches["mixed"][0]
    want = np.asarray(RJ.pip_join(
        pts, None, RefH3(), RES, chip_index=ref, recheck=False, probe=probe,
        cell_dtype=jnp.float64, batch_size=batch_size,
    ))
    got = TJ.pip_join(
        pts, None, H3IndexSystem(), RES, chip_index=port, probe=probe,
        cell_dtype=torch.float64, batch_size=batch_size, device="cpu",
    )
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_host_join_equals_reference(own_indexes, batches):
    ref, port = own_indexes
    pts = np.concatenate([batches["mixed"][0], batches["near_edge_band"][0]])
    want = RJ.host_join(pts, ref.host, RefH3(), RES)
    got = TJ.host_join(pts, port.host, H3IndexSystem(), RES)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "kw", [{"recheck": True}, {"mesh": 2}, {"profile": object()}],
    ids=["recheck", "mesh", "profile"],
)
def test_later_slices_raise_typed(port_index, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TJ.pip_join(np.zeros((4, 2)), None, H3IndexSystem(), RES,
                    chip_index=port_index, device="cpu", **kw)


def test_resolve_probe_mode(monkeypatch):
    monkeypatch.delenv("MOSAIC_PROBE_FORCE_LANE", raising=False)
    assert TJ.resolve_probe_mode("adaptive") == RJ.resolve_probe_mode("adaptive")
    for lane in ("light", "heavy", "convex"):
        monkeypatch.setenv("MOSAIC_PROBE_FORCE_LANE", lane)
        assert TJ.resolve_probe_mode("adaptive") == f"adaptive-{lane}"
        assert TJ.resolve_probe_mode("scatter") == "scatter"
    with pytest.raises(ValueError, match="probe"):
        TJ.resolve_probe_mode("mxu")
    monkeypatch.setenv("MOSAIC_PROBE_FORCE_LANE", "turbo")
    with pytest.raises(ValueError, match="MOSAIC_PROBE_FORCE_LANE"):
        TJ.resolve_probe_mode("adaptive")


def test_adaptive_rejects_direct_writeback(port_index):
    with pytest.raises(ValueError, match="writeback"):
        TJ.pip_join(np.zeros((4, 2)), None, H3IndexSystem(), RES,
                    chip_index=port_index, probe="adaptive", writeback="direct",
                    device="cpu")


def test_escalation_grows_caps_then_raises():
    calls = []

    def attempt(c):
        calls.append(dict(c))
        return np.full(4, TJ.OVERFLOW if c["found_cap"] < 64 else 0)

    out, caps = run_escalating(
        attempt, {"found_cap": 8}, {"found_cap": 1024},
        overflow_count=lambda o: int((o == TJ.OVERFLOW).sum()),
    )
    assert caps == {"found_cap": 64} and [c["found_cap"] for c in calls] == [8, 16, 32, 64]
    with pytest.raises(CapacityOverflow):
        run_escalating(
            lambda c: np.full(4, TJ.OVERFLOW), {"found_cap": 8}, {"found_cap": 16},
            overflow_count=lambda o: int((o == TJ.OVERFLOW).sum()),
        )
