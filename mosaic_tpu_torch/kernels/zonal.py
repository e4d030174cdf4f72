"""Segment-reduced zonal statistics: a hand-written CUDA kernel and torch lanes.

Port of ``mosaic_tpu/kernels/zonal.py``. Two lanes with one contract —
fold (count, sum, min, max) of masked pixel values grouped by a segment
id, where a segment outside ``[0, S)`` (``-1`` by convention) folds
nowhere (nodata, tile pad, or no containing zone):

- :func:`zonal_fold` — the segment-reduce lane, in any dtype, and the
  holder of the f64 bit-identity contract: each segment's sum is
  accumulated sequentially in pixel order, which is what the host
  oracle in `raster/zonal.py` computes. On the CPU that is torch's
  ``index_add_`` on a 1-D tensor (a sequential loop over the indices).
  On CUDA ``index_add_``/``scatter_add_``/``scatter_reduce_`` use
  atomics, whose order is not fixed, so there the pixels are sorted by
  segment with a stable sort and one thread per segment walks its run in
  order (``zonal_seq_fold`` in ``csrc/zonal.cu``).
- :func:`zonal_tiled` — replaces the Pallas ``zonal_tiled`` (f32 results,
  counts in f32, exact up to 2**24 pixels). CUDA tensors launch
  ``zonal_tiled`` in ``csrc/zonal.cu``: per-chunk sequential partials,
  then a fold over the chunks in chunk order — a fixed order, no float
  atomics. CPU tensors take :func:`zonal_tiled_plain`, whose sum order
  is not the kernel's. Both accumulate the sum in f64 and round it to f32
  once, so each returns the f32 nearest the exact sum (to within the f64
  error): they agree exactly on integer-valued data and to the last bit
  otherwise, but for a rounding tie. A sequential f32 sum of the ~10**4
  pixels a zone holds in one tile drifts by ~3e-6 of its size with the
  order, so an f32 accumulator would tie the result to one order.

Pixel values are expected pre-masked (pad/nodata pixels carry value 0
AND segment -1, see `raster/tiles.py`). Each CUDA wrapper counts its
launches in a ``launches`` attribute.
"""

from __future__ import annotations

import torch

from . import _build
from .pip import TilingError

__all__ = [
    "TilingError",
    "zonal_fold",
    "zonal_fold_masked",
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


def zonal_fold(values, seg, num_segments: int, *, acc_dtype=None):
    """((S,) i32 count, (S,) sum, (S,) min, (S,) max) of ``values``
    grouped by ``seg``. Empty segments report count 0, sum 0, min +inf,
    max -inf — callers mask on count.

    ``acc_dtype`` picks the accumulator (default: the value dtype; the
    zonal frontends stage f64 for the oracle contract). Each segment's sum
    is sequential in pixel order on the CPU and on CUDA.
    """
    values, seg = _flat(values, seg)
    dt = values.dtype if acc_dtype is None else acc_dtype
    av = values.to(dt)
    k = int(num_segments)
    valid = (seg >= 0) & (seg < k)
    segc = torch.where(valid, seg, k)
    if av.device.type == "cpu":
        zero = torch.zeros((), dtype=dt)
        cnt, s, mn, mx = _reduce_plain(
            torch.where(valid, av, zero), segc, k, _INF, -_INF
        )
        return cnt[:k], s[:k], mn[:k], mx[:k]
    return _seq_fold_cuda(av, segc, k)


def _seq_fold_cuda(av: torch.Tensor, segc: torch.Tensor, k: int):
    """The CUDA lane of :func:`zonal_fold`: stable sort by segment, then
    one thread per segment folds its run in pixel order."""
    if av.dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"zonal_fold on CUDA accumulates in float32 or float64, got {av.dtype}"
        )
    dev = av.device
    cnt = torch.empty(k, dtype=torch.int32, device=dev)
    s = torch.empty(k, dtype=av.dtype, device=dev)
    mn = torch.empty(k, dtype=av.dtype, device=dev)
    mx = torch.empty(k, dtype=av.dtype, device=dev)
    if k == 0:
        return cnt, s, mn, mx
    order = torch.sort(segc, stable=True).indices
    sorted_vals = av[order].contiguous()
    counts = torch.bincount(segc, minlength=k + 1)[:k].contiguous()
    starts = (torch.cumsum(counts, 0) - counts).contiguous()
    fn = "mosaic_zonal_seq_fold_f64" if av.dtype == torch.float64 else (
        "mosaic_zonal_seq_fold_f32"
    )
    lib = _build.load("zonal")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            sorted_vals.data_ptr(), starts.data_ptr(), counts.data_ptr(), k,
            cnt.data_ptr(), s.data_ptr(), mn.data_ptr(), mx.data_ptr(), stream,
        )
    _build.check(rc, "zonal_fold")
    zonal_fold.launches += 1
    return cnt, s, mn, mx


zonal_fold.launches = 0


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
    tile_n: int = 2048,
    tile_s: int = 128,
):
    """Zonal fold in f32: ((S,) i32 count, (S,) f32 sum, (S,) f32 min,
    (S,) f32 max), with min 1e30 and max -1e30 on empty segments.

    ``tile_n`` (a multiple of 8) is the kernel's pixel chunk per block and
    ``tile_s`` (a multiple of 128) its segment block; other values raise
    :class:`TilingError`, as do more than 2**24 pixels (the f32-exact
    count bound). CPU tensors run :func:`zonal_tiled_plain`; CUDA tensors
    launch the kernel.
    """
    if tile_n % 8 or tile_s % 128 or tile_n < 8 or tile_s < 128:
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
    vals = values.to(torch.float32).contiguous()
    segs = seg.contiguous()
    cnt = torch.zeros(k, dtype=torch.int32, device=dev)
    s = torch.zeros(k, dtype=torch.float32, device=dev)
    mn = torch.full((k,), _BIG_F, dtype=torch.float32, device=dev)
    mx = torch.full((k,), -_BIG_F, dtype=torch.float32, device=dev)
    if n == 0 or k == 0:
        return cnt, s, mn, mx
    n_chunks = -(-n // tile_n)
    # per-chunk partials: count, min and max in f32, the sum in f64
    partials = torch.empty(3 * n_chunks * k, dtype=torch.float32, device=dev)
    psum = torch.empty(n_chunks * k, dtype=torch.float64, device=dev)
    lib = _build.load("zonal")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.mosaic_zonal_tiled(
            vals.data_ptr(), segs.data_ptr(), n, k, tile_n, tile_s,
            partials.data_ptr(), psum.data_ptr(), cnt.data_ptr(), s.data_ptr(),
            mn.data_ptr(), mx.data_ptr(), stream,
        )
    _build.check(rc, "zonal_tiled")
    zonal_tiled.launches += 1
    return cnt, s, mn, mx


zonal_tiled.launches = 0
