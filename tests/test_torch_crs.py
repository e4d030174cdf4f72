"""The port's CRS engine (`mosaic_tpu_torch/core/crs*.py`) against the
reference's, on the CPU.

- Every case of the reference's `tests/test_crs_affine.py`,
  `tests/test_crs_proj.py` and `tests/test_crs_wkt.py` runs again against
  the port (`torch_reference_tests.port_of`), with the reference's own
  assertions and bands. The four cases that run the reference's
  ``jax.numpy`` lane are written again below against the port's torch
  lane (``xp=crs.TORCH``), each also held to the reference's jitted
  ``jax.numpy`` lane on the same inputs.
- The numpy lane equals the reference's bit for bit (``tobytes``) for
  every code either package knows, forward and inverse, and so do both
  validity envelopes: it is the same numpy arithmetic.
- The torch lane holds the reference's device bands against the numpy
  lane on every code: 1e-6 in projected units forward, 1e-6 degrees
  inverse, the same non-finite rows. Torch's CPU float64 ``sqrt`` is not
  correctly rounded, so the torch lane is not bit-equal on the CPU.
- `.prj` registration (`crs_wkt.register_prj_text`) gives the same codes
  and the same transforms as the reference when both registries get the
  same texts in the same order.

Each package keeps its own runtime registry, and a registration outlives
the test that made it (writing a shapefile with ``srid=27700`` registers
its `.prj`'s 27700, without the Helmert shift). So every test here starts
from empty registries in both packages and leaves them as it found them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core import crs as R
from mosaic_tpu.core import crs_proj as RP
from mosaic_tpu.core import crs_wkt as RW
from mosaic_tpu_torch.core import crs as T
from mosaic_tpu_torch.core import crs_proj as TP
from mosaic_tpu_torch.core import crs_wkt as TW
from torch_reference_tests import cases, fresh_registries, port_of  # noqa: F401

# ------------------------------------------- the reference's cases, ported

_affine = port_of("test_crs_affine.py")
_proj = port_of("test_crs_proj.py")
_wkt = port_of("test_crs_wkt.py")

_JAX_LANE = ("test_transform_jax_matches_numpy", "test_proj_table_code_under_jit",
             "test_polyconic_inverse_under_jit", "TestProjectionFamilies")
globals().update(cases(_affine, skip=_JAX_LANE))
globals().update(cases(_proj, skip=_JAX_LANE))
globals().update(cases(_wkt, skip=_JAX_LANE))


@pytest.fixture(autouse=True)
def _fresh(fresh_registries):
    """Every test starts from empty CRS registries in both packages."""


def _torch(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _jit(fn, srid, x):
    return np.asarray(jax.jit(lambda a: fn(a, srid, xp=jnp))(jnp.asarray(x)))


class TestProjectionFamilies(_affine.TestProjectionFamilies):
    """The reference's class, its jnp case on the torch lane."""

    test_jnp_matches_numpy_families = None

    def test_torch_matches_numpy_families(self):
        rng = np.random.default_rng(1)
        ll = np.stack([rng.uniform(-5, 9, 200), rng.uniform(42, 51, 200)], -1)
        for srid in [2154, 3035]:
            a = T.from_wgs84(ll, srid, np)
            b = T.from_wgs84(_torch(ll), srid, T.TORCH).numpy()
            np.testing.assert_allclose(a, b, atol=1e-6)
            ref = np.asarray(R.from_wgs84(jnp.asarray(ll), srid, jnp))
            np.testing.assert_allclose(b, ref, atol=1e-6)


def test_transform_torch_matches_numpy():
    pts = np.array([[-0.1195, 51.5033], [-2.0, 53.0], [0.5, 52.0]])
    host = T.from_wgs84(pts, 27700)
    dev = T.from_wgs84(_torch(pts), 27700, xp=T.TORCH).numpy()
    np.testing.assert_allclose(dev, host, atol=1e-5)
    np.testing.assert_allclose(dev, _jit(R.from_wgs84, 27700, pts), atol=1e-5)


def test_proj_table_code_on_torch_lane():
    ll = _proj._interior_grid(3067, n=4)
    want = T.from_wgs84(ll, 3067)
    got = T.from_wgs84(_torch(ll), 3067, xp=T.TORCH).numpy()
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(got - _jit(R.from_wgs84, 3067, ll)).max() < 1e-6


def test_polyconic_inverse_on_torch_lane():
    """The polyconic inverse picks its finite-difference step from the
    tensor's dtype, never from a host copy of the tensor."""
    ll = _proj._interior_grid(5880, n=4)
    en = T.from_wgs84(ll, 5880)
    want = T.to_wgs84(en, 5880)
    got = T.to_wgs84(_torch(en), 5880, xp=T.TORCH).numpy()
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(got - _jit(R.to_wgs84, 5880, en)).max() < 1e-5


# ------------------------------------------------ every code, both lanes

_CODES = sorted(
    set(R._NAMED) | set(R._NAMED_TM) | set(RP._EPSG) | set(R._BOUNDS)
    | {3857, 3785, 900913, 102100, 27700, 32618, 32733, 25832, 26917}
)


def _sample(srid, n=64):
    x0, y0, x1, y1 = R.crs_bounds(srid, reprojected=False)
    rng = np.random.default_rng(srid)
    return np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, min(y1, 89.5), n)], -1)


def test_port_knows_the_reference_codes():
    assert set(TP._EPSG) == set(RP._EPSG)
    assert set(T._NAMED) == set(R._NAMED) and set(T._NAMED_TM) == set(R._NAMED_TM)
    assert all(T.supported(s) for s in _CODES)
    assert T.supported(999999) == R.supported(999999) is False


@pytest.mark.parametrize("srid", _CODES)
def test_numpy_lane_equals_reference_bit_for_bit(srid):
    ll = _sample(srid)
    fwd, rfwd = T.from_wgs84(ll, srid), R.from_wgs84(ll, srid)
    assert np.asarray(fwd).tobytes() == np.asarray(rfwd).tobytes()
    inv, rinv = T.to_wgs84(rfwd, srid), R.to_wgs84(rfwd, srid)
    assert np.asarray(inv).tobytes() == np.asarray(rinv).tobytes()
    for flag in (False, True):
        assert T.crs_bounds(srid, reprojected=flag) == R.crs_bounds(srid, reprojected=flag)


@pytest.mark.parametrize("srid", _CODES)
def test_torch_lane_holds_the_reference_band(srid):
    ll = _sample(srid)
    want = np.asarray(T.from_wgs84(ll, srid))
    got = T.from_wgs84(_torch(ll), srid, T.TORCH)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.abs(np.where(fin, got - want, 0.0)).max() <= 1e-6
    en = np.where(fin, want, 0.0)[fin.all(axis=1)]
    back = np.asarray(T.to_wgs84(en, srid))
    tback = T.to_wgs84(_torch(en), srid, T.TORCH)
    tback = tback.numpy() if isinstance(tback, torch.Tensor) else np.asarray(tback)
    fin = np.isfinite(back)
    assert np.array_equal(np.isfinite(tback), fin)
    if fin.any():
        assert np.abs(np.where(fin, tback - back, 0.0)).max() <= 1e-6


def test_torch_lane_makes_no_host_copy(monkeypatch):
    """No transform reads a tensor back to the host: converting one to
    numpy, to a Python number or to a bool raises here."""

    def refuse(*a, **k):
        raise AssertionError("host round trip")

    for name in ("__array__", "item", "__bool__", "__float__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for srid in (32618, 27700, 3857, 3067, 5880, 2154, 3035, 3413, 27200, 5514, 2056):
        ll = torch.tensor(_sample(srid, 8))
        en = T.from_wgs84(ll, srid, T.TORCH)
        T.to_wgs84(en, srid, T.TORCH)


# ------------------------------------------------------- .prj registration

_PRJ = [_wkt.BNG, _wkt.TX_FEET, _wkt.WEB_MERC, _wkt.TX_FEET.replace("Texas_Central", "Other")]


def test_prj_registration_equals_reference():
    pts = np.array([[-97.7, 30.3], [-98.5, 31.0], [-1.5, 52.0]])
    for text in _PRJ:
        assert TW.wkt_to_proj_string(text) == RW.wkt_to_proj_string(text)
        assert TW.srid_of_wkt(text) == RW.srid_of_wkt(text)
        s, rs = TW.register_prj_text(text), RW.register_prj_text(text)
        assert s == rs
        assert TW.register_prj_text(text) == s  # stable on a second call
        a, b = T.from_wgs84(pts, s), R.from_wgs84(pts, rs)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert T.crs_bounds(s, True) == R.crs_bounds(rs, True)
    assert dict(TW._synthetic) == dict(RW._synthetic)
