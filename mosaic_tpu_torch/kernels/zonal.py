"""Segment-reduced zonal statistics: a hand-written CUDA kernel and torch lanes.

Port of ``mosaic_tpu/kernels/zonal.py``. Two lanes with one contract —
fold (count, sum, min, max) of masked pixel values grouped by a segment
id, where a segment outside ``[0, S)`` (``-1`` by convention) folds
nowhere (nodata, tile pad, or no containing zone):

- :func:`zonal_fold` — the segment-reduce lane, in any dtype, and the
  holder of the f64 bit-identity contract: each segment's sum is the
  sequential sum in pixel order, which is what the host oracle in
  `raster/zonal.py` computes, and count, min and max are those of a
  sequential pass (a tie goes to the first value, a NaN makes min and
  max the last NaN). On the CPU that is :func:`zonal_seq_fold_plain`,
  torch's ``index_add_``/``scatter_reduce_`` on a 1-D tensor (sequential
  loops over the indices). On CUDA those use atomics, whose order is not
  fixed, so there the pixels are sorted by segment with a stable sort
  and the ``zonal_seq_fold`` kernel (``csrc/zonal.cu``) folds each run
  with one block: a tree sum where :func:`exact_sum_ok` proves every
  order exact (integer rasters), a dependent add chain in pixel order
  elsewhere.
- :func:`zonal_tiled` — replaces the Pallas ``zonal_tiled`` (f32 results,
  i32 counts, at most 2**24 pixels). CUDA tensors launch ``zonal_tiled``
  in ``csrc/zonal.cu``: per-(segment, chunk) partials folded warp by warp
  in shared memory, then a fold over the chunks — a fixed order, no float
  atomics. CPU tensors take :func:`zonal_tiled_plain`, whose sum order
  is not the kernel's. Both accumulate the sum in f64 and round it to f32
  once, so each returns the f32 nearest the exact sum (to within the f64
  error): they agree exactly on integer-valued data and to the last bit
  otherwise, but for a rounding tie. A sequential f32 sum of the ~10**4
  pixels a zone holds in one tile drifts by ~3e-6 of its size with the
  order, so an f32 accumulator would tie the result to one order.

Pixel values are expected pre-masked (pad/nodata pixels carry value 0
AND segment -1, see `raster/tiles.py`). Each CUDA wrapper counts its
launches in a ``launches`` attribute (a launch captured into a CUDA graph
counts at each replay, `_build.count_launch`).
"""

from __future__ import annotations

import torch

from . import _build
from .pip import TilingError

__all__ = [
    "TilingError",
    "exact_sum_ok",
    "zonal_fold",
    "zonal_fold_masked",
    "zonal_seq_fold_plain",
    "zonal_tiled",
    "zonal_tiled_plain",
]

#: inert fill for the tiled lane's min/max — far beyond any geographic or
#: sensor value, well inside f32 range (the reference's constant)
_BIG_F = 1e30

_INF = float("inf")


def _flat(values, seg):
    values = torch.as_tensor(values).reshape(-1)
    seg = torch.as_tensor(seg, device=values.device).to(torch.int32).reshape(-1)
    return values, seg


def _reduce_plain(av, segc, k: int, lo: float, hi: float):
    """(cnt, sum, min, max) over ``k + 1`` buckets; bucket ``k`` is the
    overflow bucket of the pixels that fold nowhere (their values are
    masked to 0 / ``lo`` / ``hi`` by the caller)."""
    idx = segc.long()
    cnt = torch.zeros(k + 1, dtype=torch.int32, device=av.device)
    cnt.index_add_(0, idx, torch.ones_like(segc))
    s = torch.zeros(k + 1, dtype=av.dtype, device=av.device)
    s.index_add_(0, idx, av)
    mn = torch.full((k + 1,), lo, dtype=av.dtype, device=av.device)
    mn.scatter_reduce_(0, idx, av, "amin", include_self=True)
    mx = torch.full((k + 1,), hi, dtype=av.dtype, device=av.device)
    mx.scatter_reduce_(0, idx, av, "amax", include_self=True)
    return cnt, s, mn, mx


# ------------------------------------------------------------ fold lane

#: (precision, largest exponent) of each accumulator: the exact-sum test's
#: p and the bound on p + e
_FP = {torch.float64: (53, 1023), torch.float32: (24, 127)}


def exact_sum_ok(values, seg, num_segments: int, *, acc_dtype=None):
    """(S,) bool: True where every partial sum of the segment's values, in
    any order, is exact in ``acc_dtype`` (default: the value dtype), so
    that any order of adds gives the sequential sum's bits. The test the
    ``zonal_seq_fold`` kernel makes per segment: no NaN, no inf, no -0.0,
    and ``m * M <= 2**(p + e)`` with ``p + e <= emax``, where ``m`` is the
    segment's pixel count, ``M`` its largest magnitude, ``e`` the exponent
    of the lowest set bit over its values and ``p`` the accumulator's
    precision (53, or 24 for float32). Every partial sum is then a
    multiple of ``2**e`` no larger than ``2**(p + e)``. A segment without a
    nonzero value passes (its sums are +0.0); an empty segment passes.
    ``acc_dtype`` is float32 or float64."""
    values, seg = _flat(values, seg)
    dt = values.dtype if acc_dtype is None else acc_dtype
    if dt not in _FP:
        raise ValueError(f"exact_sum_ok takes a float32 or float64 accumulator, got {dt}")
    p, emax = _FP[dt]
    k = int(num_segments)
    dev = values.device
    valid = (seg >= 0) & (seg < k)
    idx = torch.where(valid, seg, k).long()
    v = values.to(dt).to(torch.float64)  # exact: the bits of e and M stay
    b = v.view(torch.int64)
    mag = b & 0x7FFF_FFFF_FFFF_FFFF
    bad = torch.isnan(v) | torch.isinf(v) | (b == -(1 << 63))
    nz = (mag != 0) & ~bad
    ef = mag >> 52
    frac = mag & ((1 << 52) - 1)
    mant = torch.where(ef == 0, frac, frac | (1 << 52))
    low = mant & -mant  # lowest set bit of the significand
    e = (torch.where(ef == 0, -1074, ef - 1075)
         + torch.frexp(low.to(torch.float64)).exponent.long() - 1)
    big_e = torch.iinfo(torch.int64).max
    n_bad = torch.zeros(k + 1, dtype=torch.int64, device=dev).index_add_(
        0, idx, bad.long())
    m = torch.zeros(k + 1, dtype=torch.int64, device=dev).index_add_(
        0, idx, torch.ones_like(idx))
    big = torch.zeros(k + 1, dtype=torch.float64, device=dev).scatter_reduce_(
        0, idx, torch.where(nz, v.abs(), 0.0), "amax")
    emin = torch.full((k + 1,), big_e, dtype=torch.int64, device=dev).scatter_reduce_(
        0, idx, torch.where(nz, e, big_e), "amin")
    some = emin != big_e
    es = torch.where(some, emin, 0)
    # M / 2**e, an integer; two exact power-of-two steps, as 2**1074
    # alone overflows
    h = torch.div(-es, 2, rounding_mode="floor")
    kk = torch.ldexp(torch.ldexp(big, h.to(torch.float64)), (-es - h).to(torch.float64))
    lim = 1 << p
    ok_k = kk <= lim
    ki = torch.where(ok_k, kk, 0.0).long()
    fits = ok_k & (ki <= lim // m.clamp(min=1)) & (p + es <= emax)
    return ((n_bad == 0) & (~some | fits))[:k]


def zonal_seq_fold_plain(values, seg, num_segments: int, *, acc_dtype=None):
    """Plain torch version of the ``zonal_seq_fold`` kernel and the CPU
    lane of :func:`zonal_fold`. Count, min and max by ``index_add_`` and
    ``scatter_reduce_``, sequential on the CPU: a tie resolves to the
    first value in pixel order and a NaN makes min and max the last NaN.
    The sum takes the kernel's two branches: where :func:`exact_sum_ok`
    holds, every order gives the same bits, so it is summed in reverse
    pixel order (the kernel sums a tree); elsewhere in pixel order."""
    values, seg = _flat(values, seg)
    dt = values.dtype if acc_dtype is None else acc_dtype
    av = values.to(dt)
    k = int(num_segments)
    valid = (seg >= 0) & (seg < k)
    segc = torch.where(valid, seg, k)
    zero = torch.zeros((), dtype=dt, device=av.device)
    masked = torch.where(valid, av, zero)
    cnt, s, mn, mx = _reduce_plain(masked, segc, k, _INF, -_INF)
    s = s[:k]
    if dt in _FP:  # float16/bfloat16 keep the sequential sum alone
        rev = torch.zeros(k + 1, dtype=dt, device=av.device).index_add_(
            0, segc.flip(0).long(), masked.flip(0))
        s = torch.where(exact_sum_ok(av, seg, k), rev[:k], s)
    return cnt[:k], s, mn[:k], mx[:k]


def zonal_fold(values, seg, num_segments: int, *, acc_dtype=None):
    """((S,) i32 count, (S,) sum, (S,) min, (S,) max) of ``values``
    grouped by ``seg``. Empty segments report count 0, sum 0, min +inf,
    max -inf — callers mask on count.

    ``acc_dtype`` picks the accumulator (default: the value dtype; the
    zonal frontends stage f64 for the oracle contract). Each segment's sum
    is the sequential sum in pixel order, bit for bit, on the CPU
    (:func:`zonal_seq_fold_plain`) and on CUDA (the ``zonal_seq_fold``
    kernel, float32 or float64 only).
    """
    values, seg = _flat(values, seg)
    dt = values.dtype if acc_dtype is None else acc_dtype
    k = int(num_segments)
    if values.device.type == "cpu":
        return zonal_seq_fold_plain(values, seg, k, acc_dtype=dt)
    if dt not in _FP:
        raise ValueError(
            f"zonal_fold on CUDA accumulates in float32 or float64, got {dt}"
        )
    av = values.to(dt)
    valid = (seg >= 0) & (seg < k)
    segc = torch.where(valid, seg, k)
    order = torch.sort(segc, stable=True).indices
    ends = torch.cumsum(torch.bincount(segc, minlength=k + 1)[:k], 0)
    return _seq_fold_sorted(av[order], ends, k)


def _seq_fold_sorted(sorted_vals: torch.Tensor, ends: torch.Tensor, k: int):
    """Launch the ``zonal_seq_fold`` kernel: segment ``s`` is the run
    ``sorted_vals[ends[s-1]:ends[s]]`` (``ends`` the (k,) int64 inclusive
    prefix sum of the run lengths). The part of :func:`zonal_fold` after
    its sort, on CUDA tensors."""
    dt = sorted_vals.dtype
    dev = sorted_vals.device
    cnt = torch.empty(k, dtype=torch.int32, device=dev)
    s = torch.empty(k, dtype=dt, device=dev)
    mn = torch.empty(k, dtype=dt, device=dev)
    mx = torch.empty(k, dtype=dt, device=dev)
    if k == 0:
        return cnt, s, mn, mx
    sorted_vals = sorted_vals.contiguous()
    ends = ends.to(torch.int64).contiguous()
    fn = "mosaic_zonal_seq_fold_f64" if dt == torch.float64 else (
        "mosaic_zonal_seq_fold_f32"
    )
    lib = _build.load("zonal")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            sorted_vals.data_ptr(), ends.data_ptr(), k,
            cnt.data_ptr(), s.data_ptr(), mn.data_ptr(), mx.data_ptr(), stream,
        )
    _build.check(rc, "zonal_fold")
    _build.count_launch(zonal_fold)
    return cnt, s, mn, mx


zonal_fold.launches = 0


def dadd_latency(device, n: int = 1 << 20) -> tuple[float, float]:
    """(SM clock cycles, ns) per dependent ``__dadd_rn`` on one thread of
    the card: the latency that bounds the sequential fold."""
    out = torch.empty(1, dtype=torch.float64, device=device)
    cycles = torch.empty(1, dtype=torch.int64, device=device)
    lib = _build.load("zonal")
    stream = torch.cuda.current_stream(device).cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        _build.check(lib.mosaic_dadd_chain(1.0, 2.0 ** -30, 1024, out.data_ptr(),
                                           cycles.data_ptr(), stream), "dadd_chain")
        start.record()
        _build.check(lib.mosaic_dadd_chain(1.0, 2.0 ** -30, n, out.data_ptr(),
                                           cycles.data_ptr(), stream), "dadd_chain")
        end.record()
    torch.cuda.synchronize(device)
    return int(cycles.item()) / n, start.elapsed_time(end) * 1e6 / n


def zonal_fold_masked(values, valid, seg, num_segments: int, *,
                      acc_dtype=None):
    """:func:`zonal_fold` with an explicit per-pixel validity lane:
    invalid pixels fold nowhere (segment forced to -1)."""
    values, seg = _flat(values, seg)
    valid = torch.as_tensor(valid, device=values.device).to(torch.bool).reshape(-1)
    segm = torch.where(valid, seg, -1)
    return zonal_fold(values, segm, num_segments, acc_dtype=acc_dtype)


# ----------------------------------------------------------- tiled lane


def zonal_tiled_plain(values, seg, num_segments: int):
    """Plain torch version of :func:`zonal_tiled`: ((S,) i32 count, (S,)
    f32 sum, (S,) f32 min, (S,) f32 max), min 1e30 and max -1e30 on empty
    segments. The f32 values are folded in f64 (exact for min and max) and
    rounded to f32 once, as the kernel rounds its f64 sums."""
    values, seg = _flat(values, seg)
    av = values.to(torch.float32).to(torch.float64)
    k = int(num_segments)
    valid = (seg >= 0) & (seg < k)
    segc = torch.where(valid, seg, k)
    zero = torch.zeros((), dtype=torch.float64, device=av.device)
    cnt, s, mn, mx = _reduce_plain(
        torch.where(valid, av, zero), segc, k, _BIG_F, -_BIG_F
    )
    f32 = torch.float32
    return cnt[:k], s[:k].to(f32), mn[:k].to(f32), mx[:k].to(f32)


def zonal_tiled(
    values,
    seg,
    num_segments: int,
    *,
    tile_n: "int | None" = None,
    tile_s: int = 128,
):
    """Zonal fold in f32: ((S,) i32 count, (S,) f32 sum, (S,) f32 min,
    (S,) f32 max), with min 1e30 and max -1e30 on empty segments.

    ``tile_n`` (a multiple of 8) is the kernel's pixel chunk per block and
    ``tile_s`` (a multiple of 128) its segment block; other values raise
    :class:`TilingError`, as do more than 2**24 pixels (the f32-exact
    count bound). By default ``tile_n`` gives about ``_TARGET_BLOCKS``
    blocks, enough to fill the card, with chunks of at least 512 pixels.
    CPU tensors run :func:`zonal_tiled_plain`; CUDA tensors launch the
    kernel.
    """
    if tile_n is not None and (tile_n % 8 or tile_n < 8) or tile_s % 128 or tile_s < 128:
        raise TilingError(
            f"tile_n must be a multiple of 8 and tile_s of 128, got "
            f"({tile_n}, {tile_s})"
        )
    values, seg = _flat(values, seg)
    n = values.shape[0]
    if n > (1 << 24):
        raise TilingError(
            f"{n} pixels exceeds the f32-exact count bound 2**24 — "
            "fold per tile and merge, or use zonal_fold"
        )
    if values.device.type == "cpu":
        return zonal_tiled_plain(values, seg, num_segments)
    dev = values.device
    k = int(num_segments)
    if n == 0 or k == 0:
        return (
            torch.zeros(k, dtype=torch.int32, device=dev),
            torch.zeros(k, dtype=torch.float32, device=dev),
            torch.full((k,), _BIG_F, dtype=torch.float32, device=dev),
            torch.full((k,), -_BIG_F, dtype=torch.float32, device=dev),
        )
    if tile_n is None:
        tile_n = _auto_tile_n(n, -(-k // tile_s))
    vals = values.to(torch.float32).contiguous()
    segs = seg.contiguous()
    # the kernel writes every output, empty segments included
    cnt = torch.empty(k, dtype=torch.int32, device=dev)
    s = torch.empty(k, dtype=torch.float32, device=dev)
    mn = torch.empty(k, dtype=torch.float32, device=dev)
    mx = torch.empty(k, dtype=torch.float32, device=dev)
    n_chunks = -(-n // tile_n)
    # per-(segment, chunk) partials: f64 sum, i32 count, f32 min and max
    scratch = torch.empty(n_chunks * k * 5, dtype=torch.int32, device=dev)
    lib = _build.load("zonal")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.mosaic_zonal_tiled(
            vals.data_ptr(), segs.data_ptr(), n, k, tile_n, tile_s,
            scratch.data_ptr(), cnt.data_ptr(), s.data_ptr(),
            mn.data_ptr(), mx.data_ptr(), stream,
        )
    _build.check(rc, "zonal_tiled")
    _build.count_launch(zonal_tiled)
    return cnt, s, mn, mx


zonal_tiled.launches = 0

#: blocks the default ``tile_n`` aims at: four on each of the H100's 132 SMs
_TARGET_BLOCKS = 4 * 132


def _auto_tile_n(n: int, s_blocks: int) -> int:
    """The default pixel chunk: about ``_TARGET_BLOCKS`` blocks over the
    ``s_blocks`` segment blocks, a multiple of 256, at least 512."""
    chunks = max(1, -(-_TARGET_BLOCKS // s_blocks))
    per_chunk = -(-n // chunks)
    return max(512, -(-per_chunk // 256) * 256)
