"""The zonal kernels' lanes: the port against the JAX package, on the CPU.

- `zonal_fold` carries the f64 bit-identity contract: each segment's sum
  is sequential in pixel order. It must equal the JAX `zonal_fold` (under
  x64) and a sequential Python loop bit for bit (tolerance 0), and so must
  `zonal_fold_masked`.
- `zonal_tiled_plain` is the CPU version of the `zonal_tiled` CUDA kernel
  and must equal the Pallas `zonal_tiled` run with ``interpret=True``:
  count, min and max exactly; sums exactly on integer-valued data (every
  partial is an exact f32 integer below 2**24) and to ``rtol=1e-6`` of the
  segment's sum of |v| otherwise (the two sum in different orders). On a
  CPU tensor the `zonal_tiled` wrapper runs the plain version and launches
  nothing. The `TilingError` checks are the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mosaic_tpu.kernels import zonal as RZ
from mosaic_tpu.kernels.pip import TilingError as RefTilingError
from mosaic_tpu_torch.kernels import zonal as TZ

SUM_RTOL = 1e-6


def _sequential(vals, seg, k):
    """The order contract spelled out: one pass in pixel order."""
    cnt = np.zeros(k, np.int64)
    s = np.zeros(k, np.float64)
    mn = np.full(k, np.inf)
    mx = np.full(k, -np.inf)
    for g, v in zip(seg.tolist(), vals.tolist()):
        if 0 <= g < k:
            cnt[g] += 1
            s[g] += v
            mn[g] = min(mn[g], v)
            mx[g] = max(mx[g], v)
    return cnt, s, mn, mx


def _np(out):
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "n, k, lo, hi",
    [(4096, 37, -50.0, 50.0), (200_000, 3, 0.0, 1.0), (20_001, 256, -1e6, 1e6), (1, 1, 0, 1)],
)
def test_zonal_fold_f64_sequential_and_equal_to_reference(n, k, lo, hi):
    rng = np.random.default_rng(n)
    vals = rng.uniform(lo, hi, n)
    seg = rng.integers(-1, k, n).astype(np.int32)
    got = _np(TZ.zonal_fold(torch.from_numpy(vals), torch.from_numpy(seg), k,
                            acc_dtype=torch.float64))
    ref = _np(RZ.zonal_fold(vals, seg, k, acc_dtype=jnp.float64))
    assert got[0].dtype == np.int32 and got[1].dtype == np.float64
    for a, b in zip(got, ref):
        assert _same(a, b)
    want = _sequential(vals, seg, k)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert _same(a, b)  # bitwise, empty segments (±inf) included


def test_zonal_fold_default_dtype_and_masked_equal_reference():
    rng = np.random.default_rng(5)
    vals = rng.uniform(-3, 3, 5000).astype(np.float32)
    seg = rng.integers(-1, 11, 5000).astype(np.int32)
    valid = rng.random(5000) < 0.7
    for got, ref in (
        (TZ.zonal_fold(vals, seg, 11), RZ.zonal_fold(vals, seg, 11)),
        (TZ.zonal_fold_masked(vals, valid, seg, 11, acc_dtype=torch.float64),
         RZ.zonal_fold_masked(vals, valid, seg, 11, acc_dtype=jnp.float64)),
    ):
        got, ref = _np(got), _np(ref)
        assert got[1].dtype == ref[1].dtype
        for a, b in zip(got, ref):
            assert _same(a, b)


def _inputs(n, k, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:
        vals = rng.integers(0, 100, n).astype(np.float32)
    else:
        vals = rng.uniform(-100, 100, n).astype(np.float32)
    seg = rng.integers(-1, k, n).astype(np.int32)
    return vals, seg


def _check_tiled(got, ref, vals, seg, k, integer):
    got, ref = _np(got), _np(ref)
    assert [a.dtype for a in got] == [np.int32, np.float32, np.float32, np.float32]
    for i in (0, 2, 3):  # count, min, max: exact, sentinels included
        assert _same(got[i], ref[i])
    if integer:
        assert _same(got[1], ref[1])
    else:
        live = (seg >= 0) & (seg < k)
        abs_sum = np.zeros(k)
        np.add.at(abs_sum, seg[live], np.abs(vals[live].astype(np.float64)))
        assert (np.abs(got[1].astype(np.float64) - ref[1]) <= SUM_RTOL * abs_sum).all()


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "float"])
@pytest.mark.parametrize(
    "n, k", [(5000, 19), (1, 1), (3000, 129), (4099, 256), (777, 7)],
)
def test_zonal_tiled_plain_equals_reference_interpret(n, k, integer):
    vals, seg = _inputs(n, k, integer, seed=n + k)
    ref = RZ.zonal_tiled(vals, seg, k, interpret=True)
    before = TZ.zonal_tiled.launches
    got = TZ.zonal_tiled(torch.from_numpy(vals), torch.from_numpy(seg), k)
    assert TZ.zonal_tiled.launches == before  # CPU tensors launch nothing
    _check_tiled(got, ref, vals, seg, k, integer)
    _check_tiled(TZ.zonal_tiled_plain(vals, seg, k), ref, vals, seg, k, integer)


def test_zonal_tiled_empty_and_out_of_range_segments():
    vals = np.arange(300, dtype=np.float32)
    for seg in (np.full(300, -1, np.int32), np.full(300, 200, np.int32)):
        ref = _np(RZ.zonal_tiled(vals, seg, 130, interpret=True))
        got = _np(TZ.zonal_tiled(vals, seg, 130))
        for a, b in zip(got, ref):
            assert _same(a, b)
        assert (got[0] == 0).all() and (got[2] == 1e30).all() and (got[3] == -1e30).all()
    cnt, s, mn, mx = TZ.zonal_tiled(np.zeros(0, np.float32), np.zeros(0, np.int32), 5)
    assert cnt.tolist() == [0] * 5 and s.tolist() == [0.0] * 5
    assert (mn == 1e30).all() and (mx == -1e30).all()


@pytest.mark.parametrize("tiling", [dict(tile_n=100), dict(tile_s=64), dict(tile_n=0)])
def test_zonal_tiled_rejects_bad_tiling(tiling):
    vals = np.zeros(256, np.float32)
    seg = np.zeros(256, np.int32)
    with pytest.raises(TZ.TilingError, match="multiple"):
        TZ.zonal_tiled(vals, seg, 4, **tiling)
    if tiling.get("tile_n", 8) > 0:
        with pytest.raises(RefTilingError):
            RZ.zonal_tiled(vals, seg, 4, interpret=True, **tiling)


def test_zonal_tiled_rejects_more_than_2_24_pixels():
    n = (1 << 24) + 1
    with pytest.raises(TZ.TilingError, match="2\\*\\*24"):
        TZ.zonal_tiled(torch.zeros(n), torch.zeros(n, dtype=torch.int32), 4)
