"""Overlay join kernels: sorted segment equi-join + convex clip area.

Port of ``mosaic_tpu/kernels/overlay.py``. The reference writes these in
jnp with no Pallas kernel, so they are torch code here, not a hand
kernel. Every function takes ``xp``: ``torch`` (the default) runs on the
input tensors' device, ``numpy`` is the f64 host twin the overlay oracle
uses — ONE body for both, so the two lanes cannot drift apart:

- :func:`pair_spans` / :func:`pair_count` — run-length segment spans via
  two ``searchsorted`` probes of the right table per left row: the span
  ``[lo, lo+cnt)`` of right rows sharing the left row's cell.
- :func:`emit_pairs` — bounded CSR cross-join emission against a STATIC
  pair bucket: pair rank ``k`` maps to its left row by a
  ``searchsorted`` over the exclusive span offsets and to its right row
  by the in-span remainder. Caps are full-bucket: the caller truncates at
  an explicit cap and reports OVERFLOW(-2) in-band.
- :func:`clip_area_convex` — batched Sutherland–Hodgman clip area for
  convex chip pairs, operation for operation the tessellation clipper's
  (same half-plane sign test, ``denom`` guard and parametric
  intersection), with a static output width ``Vs + Vw + 2``.

Floating point: the device ≡ host bit identity of the overlay lanes
holds because every float op here is one IEEE-rounded elementwise torch
op (or numpy op) in the reference's order — no fused multiply-add, no
``addcmul``, no compiled graph — and the shoelace is an unrolled Python
loop over the static width, a fixed add chain on both sides. The two
vertex packings of each clip round write disjoint targets (exclusive
cumsum positions), so neither depends on an order: numpy scatters
through ``nonzero``, torch through ``scatter_`` into a dump column,
which keeps the device loop free of host syncs. The fold back to
per-geometry-pair totals is `kernels/zonal.py zonal_fold_masked` on the
device and :func:`host_pair_fold` (``np.add.at``, sequential in row
order, as the fold lane) on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "CLIP_EPS",
    "LEFT_PAD_CELL",
    "RIGHT_PAD_CELL",
    "clip_area_convex",
    "emit_pairs",
    "host_pair_fold",
    "pair_areas",
    "pair_count",
    "pair_spans",
]

#: same half-plane epsilon as `core.tessellate._EPS` — device clips and
#: the tessellation clipper must agree on what "on the edge" means
CLIP_EPS = 1e-12

#: pad sentinels for the sorted cell columns. Distinct per side so a pad
#: row can never equi-join another pad row; both sort above every real
#: cell id, so pads stay at the tail of the sorted table.
LEFT_PAD_CELL = np.int64(2**62 - 1)
RIGHT_PAD_CELL = np.int64(2**62 - 2)


class _TorchXP:
    """The numpy functions the bodies below call, over torch tensors on
    one device (numpy's argument spellings: ``side=``, ``axis=``)."""

    int32 = torch.int32

    def __init__(self, device):
        self.device = device

    def asarray(self, x, dtype=None):
        if isinstance(x, torch.Tensor):
            return x if dtype is None else x.to(dtype)
        if dtype is not None and np.ndim(x) == 0:
            return torch.full((), x, dtype=dtype, device=self.device)
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @staticmethod
    def searchsorted(a, v, side="left"):
        return torch.searchsorted(a, v.to(a.dtype), right=side == "right")

    def arange(self, n, dtype=None):
        return torch.arange(n, dtype=dtype or torch.int64, device=self.device)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def cumsum(x, axis=0):
        return torch.cumsum(x, dim=axis)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def minimum(a, b):
        if not isinstance(a, torch.Tensor):
            a, b = b, a
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, max=b)
        return torch.minimum(a, b)

    @staticmethod
    def broadcast_to(x, shape):
        return torch.broadcast_to(x, shape)

    @staticmethod
    def take_along_axis(a, idx, axis):
        return torch.take_along_dim(a, idx.long(), dim=axis)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or torch.float64, device=self.device)

    abs = staticmethod(torch.abs)


def _ns(xp, like):
    """numpy itself, or the torch namespace on ``like``'s device."""
    if xp is np:
        return np
    if xp is not torch:
        raise ValueError(f"xp must be torch or numpy, got {xp!r}")
    dev = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
    return _TorchXP(dev)


def _astype(x, dtype):
    return x.to(dtype) if isinstance(x, torch.Tensor) else x.astype(dtype)


def _sum(x, axis=None):
    if isinstance(x, torch.Tensor):
        return x.sum() if axis is None else x.sum(dim=axis)
    return x.sum() if axis is None else x.sum(axis=axis)


# ----------------------------------------------------- segment equi-join


def pair_spans(lcells, rcells, n_left, xp=torch):
    """Per-left-row right-table span: ``(lo, cnt)`` with ``cnt[i]`` right
    rows sharing cell ``lcells[i]`` starting at sorted right row
    ``lo[i]``. Both cell columns must be sorted ascending with their pad
    sentinels at the tail; rows at and past ``n_left`` count zero."""
    T = _ns(xp, lcells)
    lcells = T.asarray(lcells)
    rcells = T.asarray(rcells)
    lo = T.searchsorted(rcells, lcells, side="left")
    hi = T.searchsorted(rcells, lcells, side="right")
    valid = T.arange(lcells.shape[0]) < n_left
    cnt = T.where(valid, hi - lo, 0)
    return lo, cnt


def pair_count(lcells, rcells, n_left, xp=torch):
    """Total candidate pair count of the sorted equi-join (exact, the
    number `emit_pairs` would emit uncapped)."""
    _, cnt = pair_spans(lcells, rcells, n_left, xp=xp)
    return _sum(cnt)


def emit_pairs(lcells, rcells, n_left, emit_limit, pair_bucket: int,
               xp=torch):
    """CSR cross-join emission against a static ``pair_bucket``.

    Returns ``(li, ri, valid)`` — (Pb,) int32 sorted-table row indices
    and the live-slot mask. Pair rank ``k`` resolves to its left row by
    ``searchsorted(off, k, 'right') - 1`` over the exclusive span
    offsets (zero-count rows are skipped by construction) and to its
    right row by ``lo + (k - off)``. Emission order is left-row-major
    over the cell-sorted table == cell-major, the stream order the fold
    order depends on. Slots at and past ``min(total, emit_limit)`` are
    invalid (the caller books ``total - emitted`` as OVERFLOW)."""
    T = _ns(xp, lcells)
    lo, cnt = pair_spans(lcells, rcells, n_left, xp=xp)
    off = T.cumsum(cnt) - cnt
    total = _sum(cnt)
    nl = lcells.shape[0]
    k = T.arange(pair_bucket, dtype=off.dtype)
    li = T.clip(T.searchsorted(off, k, side="right") - 1, 0, nl - 1)
    ri = lo[li] + (k - off[li])
    valid = k < T.minimum(total, emit_limit)
    li = T.where(valid, li, 0)
    ri = T.where(valid, T.clip(ri, 0, rcells.shape[0] - 1), 0)
    return _astype(li, T.int32), _astype(ri, T.int32), valid


# ------------------------------------------------------------- clip area


def _gather_rows(arr, idx, T):
    """(P, V, 2) rows at per-row vertex index ``idx`` (P,) → (P, 2)."""
    ix = T.broadcast_to(
        _astype(idx, T.int32)[:, None, None], (arr.shape[0], 1, 2)
    )
    return T.take_along_axis(arr, ix, axis=1)[:, 0]


def _scatter_rows(buf, pos, vals, width: int):
    """Scatter ``vals`` (P, W, 2) to ``buf[row, pos[row, j]]``; slots with
    ``pos == width`` are dropped. Targets are disjoint by construction
    (exclusive-cumsum positions), so the scatter has no order to depend
    on. numpy scatters the kept slots; torch writes the dropped ones into
    a dump column ``width`` of a ``width + 1`` buffer and cuts it off."""
    if isinstance(buf, torch.Tensor):
        P = buf.shape[0]
        wide = torch.cat([buf, buf.new_zeros((P, 1, 2))], dim=1)
        ix = pos.long()[:, :, None].expand(P, pos.shape[1], 2)
        return wide.scatter_(1, ix, vals)[:, :width]
    m = pos < width
    rr, jj = np.nonzero(m)
    buf[rr, pos[rr, jj]] = vals[rr, jj]
    return buf


def clip_area_convex(subj, slen, win, wlen, *, eps=CLIP_EPS, xp=torch):
    """Batched Sutherland–Hodgman clip AREA: signed area of
    ``subj ∩ win`` per row.

    ``subj`` (P, Vs, 2) / ``win`` (P, Vw, 2) CCW open rings, left-packed
    to ``slen`` / ``wlen``; both convex (the table prep routes anything
    else to the host lane). Returns ``(area, out_len, spill)`` — the
    half-shoelace of the clipped ring, its vertex count, and a True
    flag where a round wanted to emit more than the static ``Vs + Vw +
    2`` buffer (impossible for convex inputs; a misclassified concave
    ring trips it and is re-answered by the f64 host lane). Rows with
    ``slen == 0`` report area 0.0 exactly."""
    T = _ns(xp, subj)
    P, Vs, _ = subj.shape
    Vw = win.shape[1]
    W = Vs + Vw + 2
    dt = subj.dtype
    zero = T.asarray(0.0, dt)
    one = T.asarray(1.0, dt)
    cur = T.zeros((P, W, 2), dt)
    cur[:, :Vs] = subj
    clen = _astype(T.asarray(slen), T.int32)
    wlen = _astype(T.asarray(wlen), T.int32)
    spill = T.zeros(P, bool if T is np else torch.bool)
    jdx = T.arange(W, dtype=T.int32)[None, :]
    for e in range(Vw):
        active = (e < wlen) & (clen > 0)
        a = _gather_rows(win, T.minimum(e, wlen - 1), T)
        b = _gather_rows(win, T.where(e + 1 < wlen, e + 1, 0), T)
        ax, ay = a[:, 0][:, None], a[:, 1][:, None]
        dx = (b[:, 0] - a[:, 0])[:, None]
        dy = (b[:, 1] - a[:, 1])[:, None]
        s_cur = dx * (cur[:, :, 1] - ay) - dy * (cur[:, :, 0] - ax)
        nxt = T.where(jdx + 1 < clen[:, None], jdx + 1, 0)
        nxt_xy = T.take_along_axis(
            cur, T.broadcast_to(nxt[:, :, None], (P, W, 2)), axis=1
        )
        s_nxt = T.take_along_axis(s_cur, nxt, axis=1)
        valid = jdx < clen[:, None]
        inside_cur = s_cur >= -eps
        inside_nxt = s_nxt >= -eps
        denom = s_cur - s_nxt
        denom = T.where(T.abs(denom) < eps, one, denom)
        t = T.clip(s_cur / denom, zero, one)[:, :, None]
        inter = cur + t * (nxt_xy - cur)
        emit0 = valid & inside_cur & active[:, None]
        emit1 = valid & (inside_cur != inside_nxt) & active[:, None]
        cnt = _astype(emit0, T.int32) + _astype(emit1, T.int32)
        base = T.cumsum(cnt, axis=1) - cnt
        new_len = _sum(cnt, axis=1)
        spill = spill | (active & (new_len > W))
        buf = T.zeros((P, W, 2), dt)
        buf = _scatter_rows(buf, T.where(emit0, base, W), cur, W)
        buf = _scatter_rows(
            buf, T.where(emit1, base + _astype(emit0, T.int32), W), inter, W,
        )
        cur = T.where(active[:, None, None], buf, cur)
        clen = T.where(active, T.minimum(new_len, W), clen)
    # unrolled shoelace: a fixed-order add chain on both lanes
    acc = T.zeros(P, dt)
    for j in range(W):
        nj = T.where(j + 1 < clen, j + 1, 0)
        nxy = _gather_rows(cur, nj, T)
        contrib = cur[:, j, 0] * nxy[:, 1] - nxy[:, 0] * cur[:, j, 1]
        acc = acc + T.where(j < clen, contrib, zero)
    area = T.asarray(0.5, dt) * acc
    return area, clen, spill


# ------------------------------------------------------ per-pair measure


def pair_areas(
    lcore, rcore, lok, rok,
    lverts, lvlen, rverts, rvlen,
    larea, rarea, lcell_area,
    band, *, eps=CLIP_EPS, xp=torch,
):
    """Per-candidate intersection area with the host-lane routing flag.

    Chips are clipped to their cell, so within a shared cell the pair
    kinds collapse (``core ∩ X = X``):

    - core × core   → the cell's area (precomputed f64 table);
    - core × border → the border chip's area (precomputed f64 table);
    - border × border, both device-clippable (single convex ring within
      the vertex pad) → :func:`clip_area_convex`;
    - anything else (multi-ring, holed, concave, over-pad) → area 0.0
      here and ``host_needed`` True — the f64 host lane recomputes the
      WHOLE geometry pair, in stream order, exactly as the oracle does.

    ``band`` is the epsilon recheck threshold in area units: a clipped
    area whose magnitude falls inside it (shared edges, slivers,
    near-degenerate contact) is also flagged for the f64 recheck.
    Returns ``(area, host_needed)``."""
    T = _ns(xp, lverts)
    bb = ~lcore & ~rcore
    ok2 = bb & lok & rok
    area2, _, spill = clip_area_convex(
        lverts, T.where(ok2, lvlen, 0), rverts, rvlen, eps=eps, xp=xp,
    )
    zero = T.asarray(0.0, area2.dtype)
    area = T.where(
        lcore & rcore, lcell_area,
        T.where(
            lcore & ~rcore, rarea,
            T.where(~lcore & rcore, larea,
                    T.where(ok2, area2, zero)),
        ),
    )
    near = ok2 & (T.abs(area2) < band)
    host_needed = (bb & ~(lok & rok)) | spill | near
    area = T.where(host_needed, zero, area)
    return area, host_needed


def host_pair_fold(values, valid, seg, num_segments: int,
                   acc_dtype=np.float64):
    """Sequential-order host fold of per-candidate values into per-pair
    (count, sum) — the ``np.add.at`` twin of the fold lane's count and
    sum: same overflow bucket for masked rows, same accumulator dtype,
    same row-order accumulation."""
    g = int(num_segments)
    dt = np.dtype(acc_dtype)
    seg = np.asarray(seg, np.int64)
    valid = np.asarray(valid, bool) & (seg >= 0)
    segc = np.where(valid, seg, g)
    vals = np.where(valid, np.asarray(values, dt), dt.type(0))
    s = np.zeros(g + 1, dt)
    c = np.zeros(g + 1, np.int64)
    np.add.at(s, segc, vals)
    np.add.at(c, segc, valid.astype(np.int64))
    return c[:g], s[:g]
