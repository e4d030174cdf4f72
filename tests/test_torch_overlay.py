"""The port's overlay join (`mosaic_tpu_torch/sql/overlay.py`,
`kernels/overlay.py`) against the JAX package's, on the CPU.

Mirrors `tests/test_overlay_device.py` and `tests/test_overlay_join.py`
case for case, on their fixtures (squares on the custom grid at
resolution 3; H3 resolution 7 and BNG resolution 4 for the intersects
join): the port's device lane (torch on the CPU) must equal its own host
lane AND the reference's device lane bit for bit (pairs, value, valid,
area, sure — NaN payloads included); the intersects join must return the
reference's pairs and the dense f64 oracle's. The mesh cases belong to
ROADMAP item 12 and the function/frame frontends to item 14. On top: the
kernels against the reference's numpy and jnp lanes, shapes that need
the native boolean engine, the batched f64 intersects predicate
against the host oracle,
`PackedGeometry.take/slice/concat`, and the card-only rules (``mesh=``,
a default device without CUDA).
"""

import numpy as np
import pytest
import torch

from fixtures import oracle_pairs as _oracle_pairs

from mosaic_tpu import expr as RE
from mosaic_tpu.core import types as RT
from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.index.bng import BNGIndexSystem as RefBNG
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.kernels import overlay as RK
from mosaic_tpu.sql import overlay as RO
from mosaic_tpu_torch import DeviceUnavailable
from mosaic_tpu_torch import expr as E
from mosaic_tpu_torch.core import types as T
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.bng import BNGIndexSystem
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.dispatch import core as dispatch
from mosaic_tpu_torch.expr import compile as expr_compile
from mosaic_tpu_torch.kernels import overlay as K
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.sql import overlay as O
from mosaic_tpu_torch.sql.join import OVERFLOW

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
REF = RefCustom(RefConf(*CONF))
GRID = CustomIndexSystem(GridConf(*CONF))
RES = 3  # 1.25-degree cells


def _port(col) -> T.PackedGeometry:
    return T.PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def _squares(specs):
    return wkt.from_wkt([
        f"POLYGON (({x0} {y0}, {x0 + w} {y0}, {x0 + w} {y0 + h},"
        f" {x0} {y0 + h}, {x0} {y0}))"
        for x0, y0, w, h in specs
    ])


def _assert_bitwise(got, want):
    for f in ("pairs", "value", "valid", "area", "sure"):
        a = np.asarray(getattr(got, f))
        b = np.asarray(getattr(want, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f"{f} diverged"
    assert got.overflow == want.overflow


def _three_lanes(left, right, value=None, **kw):
    """(port device, port host, reference device) on the same tables."""
    pv = None if value is None else value(E)
    rv = None if value is None else value(RE)
    dev = O.overlay_measures(_port(left), _port(right), GRID, RES, pv,
                             device="cpu", **kw)
    host = O.overlay_measures(_port(left), _port(right), GRID, RES, pv,
                              device="cpu", lane="host", **kw)
    ref = RO.overlay_measures(left, right, REF, RES, rv, **kw)
    return dev, host, ref


def _frac(M):
    return M.overlap_fraction()


# ------------------------------------------------------ device lane


def test_device_matches_host_oracle_bitwise():
    left = _squares([(i * 2.9, j * 2.9, 2.7, 2.7)
                     for i in range(4) for j in range(4)])
    right = _squares([(i * 2.9 + 0.9, j * 2.9 + 0.6, 2.4, 2.4)
                      for i in range(4) for j in range(4)])
    dev, host, ref = _three_lanes(left, right, _frac)
    assert dev.lane == "device" and not dev.degraded
    assert host.lane == "host"
    _assert_bitwise(dev, host)
    _assert_bitwise(dev, ref)
    assert dev.host_overridden == ref.host_overridden
    assert dev.pairs.shape[0] > 0
    assert np.nanmax(dev.value) > 0.0


def test_self_join_symmetry():
    geoms = _squares([(0.2, 0.3, 2.6, 2.6), (2.0, 2.1, 3.1, 2.2),
                      (5.4, 0.7, 1.9, 3.3)])
    dev, host, ref = _three_lanes(geoms, geoms, _frac)
    _assert_bitwise(dev, host)
    _assert_bitwise(dev, ref)
    pairs = {(int(a), int(b)) for a, b in dev.pairs}
    assert pairs == {(b, a) for a, b in pairs}
    diag = dev.pairs[:, 0] == dev.pairs[:, 1]
    assert set(dev.pairs[diag, 0].tolist()) == {0, 1, 2}
    np.testing.assert_allclose(dev.value[diag], 1.0, rtol=1e-12)


def test_shared_edge_only_touches_not_overlaps():
    dev, host, ref = _three_lanes(_squares([(0.0, 0.0, 1.0, 1.0)]),
                                  _squares([(1.0, 0.0, 1.0, 1.0)]))
    _assert_bitwise(dev, host)
    _assert_bitwise(dev, ref)
    assert dev.pairs.shape[0] == 1
    assert float(dev.area[0]) == 0.0
    assert float(dev.value[0]) == 0.0


def test_all_border_multicell_span():
    dev, host, ref = _three_lanes(_squares([(0.1, 0.2, 5.9, 0.6)]),
                                  _squares([(0.3, 0.4, 5.2, 0.6)]))
    _assert_bitwise(dev, host)
    _assert_bitwise(dev, ref)
    assert not bool(dev.sure.any())
    assert dev.pairs.shape[0] == 1
    np.testing.assert_allclose(float(dev.area[0]), 5.2 * 0.4, rtol=1e-12)


def test_empty_intersection_candidate_reports_zero():
    dev, host, ref = _three_lanes(_squares([(0.0, 0.0, 0.5, 0.5)]),
                                  _squares([(0.7, 0.0, 0.5, 0.5)]), _frac)
    _assert_bitwise(dev, host)
    _assert_bitwise(dev, ref)
    assert dev.pairs.shape[0] == 1
    assert float(dev.area[0]) == 0.0
    assert float(dev.value[0]) == 0.0


def test_overflow_cap_through_fused_path():
    left = _squares([(i * 2.9, 0.0, 2.7, 2.7) for i in range(4)])
    right = _squares([(i * 2.9 + 0.8, 0.5, 2.4, 2.4) for i in range(4)])
    dev, host, ref = _three_lanes(left, right, _frac, pair_cap=2)
    assert dev.overflow > 0 and host.overflow == dev.overflow
    assert tuple(dev.pairs[-1]) == (OVERFLOW, OVERFLOW)
    assert np.isnan(dev.value[-1]) and np.isnan(dev.area[-1])
    assert not dev.valid[-1]
    _assert_bitwise(dev, host)
    _assert_bitwise(dev, ref)


def test_general_shapes_take_the_native_engine():
    """Holed and concave polygons: their border chips are not
    device-clippable, so the f64 host lane re-answers the whole pair
    through the native boolean engine — the same answer as the
    reference's, in both lanes."""
    left = wkt.from_wkt([
        "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 3 1, 3 3, 1 3, 1 1))",
        "POLYGON ((5 0, 7 0, 6 3, 7 5, 5 5, 5.5 2.5, 5 0))",
    ])
    right = _squares([(0.5, 0.5, 5.5, 3.0), (2.2, 2.2, 4.0, 0.6)])
    dev, host, ref = _three_lanes(left, right, _frac)
    assert dev.host_overridden > 0
    assert dev.host_overridden == ref.host_overridden
    _assert_bitwise(dev, host)
    _assert_bitwise(dev, ref)


def test_zero_cold_compiles_after_warmup():
    left = _port(_squares([(0.3, 0.1, 2.6, 2.6), (3.3, 0.1, 2.6, 2.6)]))
    right = _port(_squares([(1.0, 0.8, 2.6, 2.6), (4.0, 0.8, 2.6, 2.6)]))
    value = E.overlap_fraction()
    prep = O.warmup_overlay(left, right, GRID, RES, value, device="cpu")
    sigs = expr_compile.signatures()
    frozen = expr_compile._frozen
    try:
        expr_compile.freeze()
        c0 = dispatch.backend_compiles()
        cold0 = expr_compile.cold_compiles()
        out = O.overlay_measures(left, right, GRID, RES, value, prep=prep)
        assert out.lane == "device"
        assert dispatch.backend_compiles() - c0 == 0
        assert expr_compile.cold_compiles() == cold0
    finally:
        expr_compile._frozen = frozen
        expr_compile._signatures.update(sigs)


def test_device_failure_degrades_to_host_oracle(monkeypatch):
    left = _port(_squares([(0.3, 0.1, 2.6, 2.6)]))
    right = _port(_squares([(1.0, 0.8, 2.6, 2.6)]))
    want = O.overlay_measures(left, right, GRID, RES, lane="host",
                              device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(expr_compile, "run_tracked", boom)
    with telemetry.capture() as ev:
        got = O.overlay_measures(left, right, GRID, RES, device="cpu")
    assert got.lane == "host" and got.degraded
    assert "injected device fault" in got.reason
    _assert_bitwise(got, want)
    assert [e for e in ev if e["event"] == "degraded"]


def test_device_failure_on_the_card_propagates(monkeypatch):
    """The port's rule: only the CPU degrades. A prep on a CUDA device
    whose program fails raises instead of moving to the host lane."""
    left = _port(_squares([(0.3, 0.1, 2.6, 2.6)]))
    right = _port(_squares([(1.0, 0.8, 2.6, 2.6)]))
    prep = O.prepare_overlay(
        tessellate(left, GRID, RES), tessellate(right, GRID, RES),
        left, right, GRID, RES, device="cpu",
    )
    card = O.OverlayPrep(**{
        **{f: getattr(prep, f) for f in (
            "left", "right", "shift", "scale", "index_system",
            "resolution", "acc_name", "band", "vpad")},
        "device": torch.device("cuda"),
    })

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(O, "_device_lane", boom)
    with pytest.raises(RuntimeError, match="injected device fault"):
        O.overlay_measures(left, right, GRID, RES, prep=card)


def test_prepared_overlay_reuse_is_identical():
    left = _port(_squares([(0.3, 0.1, 2.6, 2.6), (3.3, 0.1, 2.6, 2.6)]))
    right = _port(_squares([(1.0, 0.8, 2.6, 2.6)]))
    lt = tessellate(left, GRID, RES)
    rt = tessellate(right, GRID, RES)
    prep = O.prepare_overlay(lt, rt, left, right, GRID, RES, device="cpu")
    a = O.overlay_measures(left, right, GRID, RES, prep=prep)
    b = O.overlay_measures(left, right, GRID, RES, device="cpu")
    c = O.overlay_measures(left, right, GRID, RES, prep=prep)
    _assert_bitwise(a, b)
    _assert_bitwise(a, c)
    assert prep.tensors  # the side tables were copied once and kept


def test_prep_tables_equal_reference():
    left = _squares([(0.3, 0.1, 2.6, 2.6), (3.3, 0.1, 2.6, 2.6)])
    right = _squares([(1.0, 0.8, 2.6, 2.6)])
    from mosaic_tpu.core.tessellate import tessellate as ref_tess

    p = O.prepare_overlay(
        tessellate(_port(left), GRID, RES), tessellate(_port(right), GRID, RES),
        _port(left), _port(right), GRID, RES, device="cpu",
    )
    r = RO.prepare_overlay(ref_tess(left, REF, RES), ref_tess(right, REF, RES),
                           left, right, REF, RES)
    assert (p.scale, p.band, p.vpad, p.acc_name) == (
        r.scale, r.band, r.vpad, r.acc_name)
    for side in ("left", "right"):
        ps, rs = getattr(p, side), getattr(r, side)
        for f in ("cells", "geom", "core", "ok_subj", "ok_win", "verts",
                  "vlen", "chip_area", "cell_area", "rows", "geom_area"):
            assert np.asarray(getattr(ps, f)).tobytes() == np.asarray(
                getattr(rs, f)).tobytes(), (side, f)


def test_overlay_stage_telemetry_and_spans():
    left = _port(_squares([(0.3, 0.1, 2.6, 2.6)]))
    right = _port(_squares([(1.0, 0.8, 2.6, 2.6)]))
    with telemetry.capture() as ev:
        O.overlay_measures(left, right, GRID, RES, device="cpu")
    stages = [e["stage"] for e in ev if e["event"] == "overlay_stage"]
    assert stages == ["candidates", "measures"]
    names = {e["name"] for e in ev if e["event"] == "span"}
    assert {"overlay.prepare", "overlay.device_candidates",
            "overlay.measures"} <= names
    assert [e for e in ev if e["event"] == "overlay_candidates"]


def test_unported_options_raise():
    left = _port(_squares([(0.3, 0.1, 2.6, 2.6)]))
    # mesh= is ported (it raised before): a device count takes real
    # devices, of which the CPU has one; a logical mesh gives the bits
    with pytest.raises(ValueError, match="devices"):
        O.overlay_measures(left, left, GRID, RES, mesh=2, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        O.warmup_overlay(left, left, GRID, RES, mesh=2, device="cpu")
    mesh = dispatch.data_mesh(devices=["cpu"] * 2)
    prep = O.warmup_overlay(left, left, GRID, RES, mesh=mesh, device="cpu")
    _assert_bitwise(
        O.overlay_measures(left, left, GRID, RES, prep=prep, mesh=mesh),
        O.overlay_measures(left, left, GRID, RES, prep=prep),
    )
    with pytest.raises(ValueError, match="lane"):
        O.overlay_measures(left, left, GRID, RES, lane="gpu", device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left = _port(_squares([(0.3, 0.1, 2.6, 2.6)]))
    with pytest.raises(DeviceUnavailable):
        O.overlay_measures(left, left, GRID, RES)
    with pytest.raises(DeviceUnavailable):  # never answered by the host oracle
        O.intersects_join(left, left, GRID, RES)


# ------------------------------------------------------------ kernels


def _convex_rings(rng, P, V):
    n = rng.integers(3, V + 1, P)
    out = np.zeros((P, V, 2))
    for i in range(P):
        ang = np.sort(rng.uniform(0, 2 * np.pi, n[i]))
        c = rng.uniform(-1, 1, 2)
        pts = c + rng.uniform(0.5, 1.5) * np.stack(
            [np.cos(ang), np.sin(ang)], -1)
        out[i, : n[i]] = pts
        out[i, n[i]:] = pts[-1]
    return out, n.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_clip_area_convex_equals_reference_lanes(seed):
    """The torch lane, the numpy twin and the reference's numpy and jnp
    lanes give the same f64 bits (areas, lengths, spill flags)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    s, sl = _convex_rings(rng, 64, 6)
    w, wl = _convex_rings(rng, 64, 5)
    sl[:3] = 0  # empty subjects report exactly 0
    got = K.clip_area_convex(torch.from_numpy(s), torch.from_numpy(sl),
                             torch.from_numpy(w), torch.from_numpy(wl))
    twin = K.clip_area_convex(s, sl, w, wl, xp=np)
    ref = RK.clip_area_convex(s, sl, w, wl, xp=np)
    refj = RK.clip_area_convex(jnp.asarray(s), jnp.asarray(sl),
                               jnp.asarray(w), jnp.asarray(wl))
    for i in range(3):
        a = got[i].numpy()
        for b in (twin[i], ref[i], np.asarray(refj[i])):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert got[0].numpy().tobytes() == np.asarray(refj[0]).tobytes()
    assert (got[0][:3] == 0).all()


@pytest.mark.parametrize("limit", [None, 5, 0])
def test_emit_pairs_equals_reference(limit):
    rng = np.random.default_rng(4)
    lc = np.sort(rng.integers(0, 20, 30)).astype(np.int64)
    rc = np.sort(rng.integers(0, 20, 25)).astype(np.int64)
    lc = np.concatenate([lc, [K.LEFT_PAD_CELL] * 2])
    rc = np.concatenate([rc, [K.RIGHT_PAD_CELL] * 3])
    total = int(K.pair_count(torch.from_numpy(lc), torch.from_numpy(rc), 30))
    assert total == int(RK.pair_count(lc, rc, 30, xp=np))
    lim = total if limit is None else limit
    got = K.emit_pairs(torch.from_numpy(lc), torch.from_numpy(rc), 30, lim, 64)
    twin = K.emit_pairs(lc, rc, 30, lim, 64, xp=np)
    want = RK.emit_pairs(lc, rc, 30, lim, 64, xp=np)
    for a, b, c in zip(got, twin, want):
        np.testing.assert_array_equal(a.numpy(), c)
        np.testing.assert_array_equal(b, c)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool


def test_host_pair_fold_equals_reference():
    rng = np.random.default_rng(6)
    vals = rng.normal(size=200)
    seg = rng.integers(-1, 12, 200)
    valid = rng.random(200) < 0.8
    a = K.host_pair_fold(vals, valid, seg, 12)
    b = RK.host_pair_fold(vals, valid, seg, 12)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


# ------------------------------------------------------ intersects join


def _sq3(n, size, offx, offy, scale=1.0):
    return wkt.from_wkt([
        f"POLYGON (({offx + (i % 3) * scale} {offy + (i // 3) * scale}, "
        f"{offx + (i % 3) * scale + size} {offy + (i // 3) * scale}, "
        f"{offx + (i % 3) * scale + size} {offy + (i // 3) * scale + size}, "
        f"{offx + (i % 3) * scale} {offy + (i // 3) * scale + size}, "
        f"{offx + (i % 3) * scale} {offy + (i // 3) * scale}))"
        for i in range(n)
    ])


@pytest.mark.parametrize("prebuilt", [False, True])
@pytest.mark.parametrize("grid", ["h3", "bng"])
def test_overlay_matches_dense_oracle(grid, prebuilt):
    if grid == "h3":
        idx, ridx, res = H3IndexSystem(), RefH3(), 7
        left = _sq3(6, 0.08, -0.02, 51.48, 0.06)
        right = _sq3(6, 0.08, 0.01, 51.50, 0.05)
    else:
        idx, ridx, res = BNGIndexSystem(), RefBNG(), 4
        left = _sq3(6, 4030, 530000, 180000, 3070)
        right = _sq3(6, 4030, 531517, 181533, 2531)
    chips = ({"left_chips": tessellate(_port(left), idx, res),
              "right_chips": tessellate(_port(right), idx, res)}
             if prebuilt else {})
    got = O.intersects_join(_port(left), _port(right), idx, res,
                            device="cpu", **chips)
    np.testing.assert_array_equal(got, _oracle_pairs(left, right))
    np.testing.assert_array_equal(got, RO.intersects_join(left, right, ridx, res))
    assert got.dtype == np.int64 and got.shape[0] > 0


def test_device_predicate_equals_oracle_on_touching_shapes():
    """The batched f64 predicate answers as the host oracle row for row:
    shared edges, a shared corner, nesting without crossing, holes,
    lines and empties."""
    from mosaic_tpu_torch.core.geometry.oracle import pair_intersects

    a = _port(wkt.from_wkt([
        "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))",
        "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))",
        "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 3 1, 3 3, 1 3, 1 1))",
        "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 3 1, 3 3, 1 3, 1 1))",
        "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))",
        "LINESTRING (0 0, 2 2)",
        "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))",
        "POLYGON EMPTY",
    ]))
    b = _port(wkt.from_wkt([
        "POLYGON ((1 0, 2 0, 2 1, 1 1, 1 0))",
        "POLYGON ((1 1, 2 1, 2 2, 1 2, 1 1))",
        "POLYGON ((1.5 1.5, 2.5 1.5, 2.5 2.5, 1.5 2.5, 1.5 1.5))",
        "POLYGON ((0.2 0.2, 0.8 0.2, 0.8 0.8, 0.2 0.8, 0.2 0.2))",
        "POLYGON ((2 2, 3 2, 3 3, 2 3, 2 2))",
        "POLYGON ((1.5 0, 3 0, 3 1, 1.5 1, 1.5 0))",
        "POLYGON ((1.0000001 0, 2 0, 2 1, 1.0000001 1, 1.0000001 0))",
        "POLYGON ((0 0, 1 0, 1 1, 0 0))",
    ]))
    want = pair_intersects(a, b)
    got = O._device_pair_intersects(a, b, torch.device("cpu"))
    np.testing.assert_array_equal(got, want)
    assert want.tolist() == [True, True, False, True, True, False, False, False]


def test_device_predicate_degrades_on_the_cpu():
    from mosaic_tpu_torch.runtime import DegradedResult, faults

    left = _port(_sq3(6, 0.08, -0.02, 51.48, 0.06))
    right = _port(_sq3(6, 0.08, 0.01, 51.50, 0.05))
    want = O.intersects_join(left, right, H3IndexSystem(), 7, device="cpu")
    with faults.transient_errors(50, sites=("overlay.predicate",)):
        got = O.intersects_join(left, right, H3IndexSystem(), 7,
                                device="cpu")
    assert isinstance(got, DegradedResult)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_overlay_disjoint_tables():
    left = _port(_sq3(3, 0.01, 0.0, 51.0, 0.05))
    right = _port(_sq3(3, 0.01, 3.0, 52.0, 0.05))
    got = O.intersects_join(left, right, H3IndexSystem(), 7, device="cpu")
    assert got.shape == (0, 2)


def test_overlay_core_shortcut_counts():
    big = _port(_sq3(1, 0.5, 0.0, 51.0))
    small = _port(_sq3(1, 0.05, 0.2, 51.2))
    got = O.intersects_join(big, small, H3IndexSystem(), 7, device="cpu")
    np.testing.assert_array_equal(got, [[0, 0]])


def test_multi_cell_pair_emitted_once():
    left = _port(wkt.from_wkt([
        "POLYGON ((0.2 0.2, 4.8 0.2, 4.8 4.8, 0.2 4.8, 0.2 0.2))",
        "POLYGON ((0.1 5.1, 4.9 5.1, 4.9 5.4, 0.1 5.4, 0.1 5.1))",
    ]))
    right = _port(wkt.from_wkt([
        "POLYGON ((0.4 0.4, 4.6 0.4, 4.6 5.6, 0.4 5.6, 0.4 0.4))",
    ]))
    lt = tessellate(left, GRID, RES)
    rt = tessellate(right, GRID, RES)
    lrows, rrows = O.chip_candidate_rows(lt, rt)
    raw = np.stack(
        [np.asarray(lt.geom_id)[lrows], np.asarray(rt.geom_id)[rrows]],
        axis=-1,
    )
    assert np.count_nonzero((raw == [0, 0]).all(axis=1)) > 1
    assert np.count_nonzero((raw == [1, 0]).all(axis=1)) > 1
    with telemetry.capture() as ev:
        lgeom, rgeom, sure = O.candidate_pairs(lt, rt)
    np.testing.assert_array_equal(np.stack([lgeom, rgeom], -1),
                                  [[0, 0], [1, 0]])
    assert bool(sure[0]) and not bool(sure[1])
    st = [e for e in ev if e["event"] == "overlay_candidates"]
    assert st and st[0]["candidates"] == 2 and st[0]["sure_fraction"] == 0.5


# ------------------------------------------------------------- columns


def test_packed_take_slice_concat_equal_reference():
    wkts = [
        "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 3 1, 3 3, 1 3, 1 1))",
        "MULTIPOLYGON (((10 0, 12 0, 11 2, 10 0)), ((20 0, 22 0, 21 2, 20 0)))",
        "LINESTRING (0 0, 1 1, 2 0)",
        "POINT (3 4)",
    ]
    ref = wkt.from_wkt(wkts)
    col = _port(ref)

    def same(a, b):
        for f in ("xy", "ring_offsets", "part_offsets", "geom_offsets",
                  "geom_type", "srid", "geom_has_z"):
            assert np.asarray(getattr(a, f)).tobytes() == np.asarray(
                getattr(b, f)).tobytes(), f

    same(col.take([3, 0, 1]), ref.take([3, 0, 1]))
    same(col.slice(1, 9), ref.slice(1, 9))
    same(col.slice(-2, -1), ref.slice(-2, -1))
    same(col.concat(col.take([2])), ref.concat(ref.take([2])))
    same(T.concat_packed([col.take([]), col, col.slice(0, 1)]),
         RT.concat_packed([ref.take([]), ref, ref.slice(0, 1)]))
    assert len(T.concat_packed([])) == 0
    assert len(T.PackedGeometry.empty()) == 0
