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
- `exact_sum_ok`, the test by which the `zonal_seq_fold` kernel sums a
  segment as a tree: wherever it holds, a shuffled-order sum equals the
  sequential `index_add_` sum bit for bit (a hypothesis property, f64
  and f32), and it rejects -0.0, NaN, inf and ``m * M > 2**(p + e)``.
- The CPU lane's rules for ties and NaN, which the kernel copies, are
  pinned: a tie between -0.0 and +0.0 goes to the first in pixel order;
  a NaN makes min and max the last NaN and the sum that NaN quieted, or
  the default NaN (sign set) when inf and -inf meet.
"""

import math
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

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


# ------------------------------------------------- the exact-sum branch


_BITS = {torch.float64: (torch.int64, 64), torch.float32: (torch.int32, 32)}


def _bits(t):
    it, w = _BITS[t.dtype]
    return [x & ((1 << w) - 1) for x in t.reshape(-1).view(it).tolist()]


def _from_bits(bits, dtype):
    it, w = _BITS[dtype]
    signed = [b - (1 << w) if b >= 1 << (w - 1) else b for b in bits]
    return torch.tensor(signed, dtype=it).view(dtype)


def _seq_sum(v):
    """The CPU lane's sum of one segment: index_add_ in pixel order."""
    return torch.zeros(1, dtype=v.dtype).index_add_(
        0, torch.zeros(v.numel(), dtype=torch.long), v)


@settings(max_examples=300, deadline=None)
@given(
    dtype=st.sampled_from([torch.float64, torch.float32]),
    e=st.integers(-160, 90),
    mag_bits=st.integers(1, 53),
    ks=st.lists(st.integers(-(1 << 53), 1 << 53), min_size=1, max_size=64),
    seed=st.integers(0, 2 ** 32 - 1),
)
def test_exact_sum_ok_makes_any_order_sequential(dtype, e, mag_bits, ks, seed):
    """Values k * 2**e, |k| < 2**mag_bits (-0.0 included): wherever the
    test holds, a shuffled order gives the sequential sum's bits."""
    vals = torch.tensor([np.ldexp(math.copysign(abs(k) % (1 << mag_bits), k), e)
                         for k in ks], dtype=torch.float64).to(dtype)
    seg = torch.zeros(vals.numel(), dtype=torch.int32)
    ok = bool(TZ.exact_sum_ok(vals, seg, 1)[0])
    want = _seq_sum(vals)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(vals.numel()))
    if ok:
        assert _bits(_seq_sum(vals[perm])) == _bits(want)
        assert _bits(_seq_sum(vals.flip(0))) == _bits(want)
    # the plain twin of the kernel equals the sequential lane either way
    got = TZ.zonal_seq_fold_plain(vals, seg, 1)
    assert _bits(got[1]) == _bits(want)


@pytest.mark.parametrize("dtype, p, emax", [(torch.float64, 53, 1023), (torch.float32, 24, 127)])
def test_exact_sum_ok_rejects(dtype, p, emax):
    """One segment per case; the boundary m * M == 2**(p + e) passes."""
    e = -3
    cases = {
        "ok": ([1.0, 2.0, 3.0], True),
        "neg_zero": ([1.0, -0.0], False),
        "pos_zero": ([1.0, 0.0, 2.0], True),
        "nan": ([1.0, float("nan")], False),
        "inf": ([1.0, float("inf")], False),
        "neg_inf": ([-float("inf"), 1.0], False),
        # m = 4, M = 2**(p-2+e): m * M = 2**(p+e) exactly
        "boundary": ([2.0 ** (p - 2 + e), 2.0 ** e, 2.0 ** e, 2.0 ** e], True),
        # one more pixel: m * M = 5 * 2**(p-2+e) > 2**(p+e)
        "over": ([2.0 ** (p - 2 + e)] + [2.0 ** e] * 4, False),
        # M / 2**e alone above 2**p
        "wide": ([2.0 ** (p + 1), 1.0], False),
        # p + e above the largest exponent
        "huge": ([2.0 ** (emax - p + 1)], False),
        "empty_values": ([0.0, 0.0], True),
    }
    names = list(cases)
    vals = torch.tensor([v for n in names for v in cases[n][0]], dtype=dtype)
    seg = torch.tensor([i for i, n in enumerate(names) for _ in cases[n][0]],
                       dtype=torch.int32)
    got = TZ.exact_sum_ok(vals, seg, len(names) + 1)
    assert dict(zip(names, got.tolist())) == {n: c[1] for n, c in cases.items()}
    assert bool(got[-1])  # an empty segment passes


def test_exact_sum_ok_near_2_52_takes_the_sequential_branch():
    """Integers near 2**52: M / 2**e is under 2**53 but m * M is not, and
    the order of the adds changes the sum's bits."""
    base = float(2 ** 52)
    # in pixel order 2**53 + 1 rounds to 2**53 twice; reversed, 2 is kept
    vals = torch.tensor([base, base, 1.0, 1.0, 3.0, base + 1.0, -base], dtype=torch.float64)
    seg = torch.zeros(vals.numel(), dtype=torch.int32)
    assert not bool(TZ.exact_sum_ok(vals, seg, 1)[0])
    assert _bits(_seq_sum(vals)) != _bits(_seq_sum(vals.flip(0)))
    got = TZ.zonal_fold(vals, seg, 1)
    assert _bits(got[1]) == _bits(_seq_sum(vals))
    want = _sequential(vals.numpy(), seg.numpy(), 1)
    assert _same(got[1].numpy(), want[1])


def test_exact_sum_ok_subnormal_values():
    """Subnormal multiples of 2**-1074: the test needs 2**1074, which
    overflows as one factor."""
    tiny = np.ldexp(1.0, -1074)
    vals = torch.tensor([3 * tiny, 5 * tiny, 1e-310], dtype=torch.float64)
    seg = torch.tensor([0, 0, 1], dtype=torch.int32)
    assert TZ.exact_sum_ok(vals, seg, 2).tolist() == [True, True]


_NAN2 = 0x7FF8000000000002
_QNAN = 0x7FF8000000000000
_SNAN = 0x7FF0000000000005
_INF64, _NINF64, _ONE64 = 0x7FF0000000000000, 0xFFF0000000000000, 0x3FF0000000000000


@pytest.mark.parametrize(
    "bits, want",
    [
        # (values' bits, (sum, min, max) bits) — the CPU lane's rules
        ([0, 1 << 63], (0, 0, 0)),                                   # +0, -0
        ([1 << 63, 0], (0, 1 << 63, 1 << 63)),                       # -0, +0
        ([_ONE64, 1 << 63, 0, _ONE64], (0x4000000000000000, 1 << 63, _ONE64)),
        ([_QNAN | 1, _NAN2, _ONE64], (_NAN2, _NAN2, _NAN2)),         # last NaN
        ([_NAN2, _ONE64, _QNAN | 1], (_QNAN | 1,) * 3),
        ([_ONE64, _SNAN], (_SNAN | (1 << 51), _SNAN, _SNAN)),        # quieted sum
        ([_INF64, _NINF64, _ONE64], (0xFFF8000000000000, _NINF64, _INF64)),
        ([_INF64, _NINF64, _NAN2, _ONE64], (_NAN2,) * 3),
    ],
    ids=["pos_neg_zero", "neg_pos_zero", "zero_tie_inside", "last_nan",
         "last_nan_2", "snan", "inf_minus_inf", "inf_then_nan"],
)
def test_cpu_lane_tie_and_nan_rules(bits, want):
    """The CPU lane's bits for ties and NaN, which the zonal_seq_fold
    kernel reproduces; f32 follows the same rules with its own quiet bit
    and default NaN."""
    vals = _from_bits(bits, torch.float64)
    seg = torch.zeros(len(bits), dtype=torch.int32)
    _, s, mn, mx = TZ.zonal_fold(vals, seg, 1)
    assert (_bits(s)[0], _bits(mn)[0], _bits(mx)[0]) == want
    f32 = vals.to(torch.float32)
    _, s32, mn32, mx32 = TZ.zonal_fold(f32, seg, 1)
    f = struct.unpack
    for got, w in ((s32, want[0]), (mn32, want[1]), (mx32, want[2])):
        w32 = _from_bits([w], torch.float64).to(torch.float32)
        if f("<d", struct.pack("<Q", w))[0] != f("<d", struct.pack("<Q", w))[0]:
            # a NaN: the f32 NaN of the same sign, quieted in the sum
            assert _bits(got)[0] & 0xFF800000 == _bits(w32)[0] & 0xFF800000
        else:
            assert _bits(got) == _bits(w32)
