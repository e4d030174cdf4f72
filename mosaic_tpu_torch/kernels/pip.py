"""Point-in-polygon kernels: hand-written CUDA for Hopper, plain torch twins.

Port of ``mosaic_tpu/kernels/pip.py``. Two functions reach a kernel:

- :func:`pip_zone` — brute-force first-containing-polygon per point
  against edge planes ``(4, E, G)`` (replaces the Pallas ``pip_zone``);
- :func:`pip_heavy_tiled` — the join's tier-2 probe: per-point slot
  parity against the point's own heavy-table row (replaces the Pallas
  ``pip_heavy_tiled``).

Each wrapper takes its plain torch version (:func:`pip_zone_plain`,
:func:`pip_heavy_plain`) only for tensors that lie on the CPU; for CUDA
tensors it launches the kernel in ``csrc/pip.cu`` or raises. Each wrapper
counts its launches in a ``launches`` attribute (a launch captured into a
CUDA graph counts at each replay, `_build.count_launch`). The plain
versions repeat the kernels' arithmetic one torch op per step (eager
torch rounds every op, and no fused op is used), so they are exact twins
of the kernels and of the reference.

The tiling arguments and the :class:`TilingError` checks are kept for API
parity with the reference; the CUDA kernels choose their own tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.geometry.device import DeviceGeometry, edges as _edges, is_polygonal
from . import _build

_BIG_F = 1e30
_SENT = 2**30
_I32_MAX = int(np.iinfo(np.int32).max)


class TilingError(ValueError):
    """A pad/tile size violates the (8, 128) tiling contract of the
    reference kernels. Raised at call time, where the bad argument is
    visible."""


def _pad_to(x: torch.Tensor, size: int, axis: int, value=0):
    pad = size - x.shape[axis]
    if pad < 0:
        raise TilingError(
            f"_pad_to cannot shrink axis {axis}: size {size} < existing "
            f"{x.shape[axis]}"
        )
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def edge_planes(polys: DeviceGeometry, g_pad: int = 128, e_pad: int = 64):
    """Flatten a polygon column to edge coordinate planes ``[4, E, G]``.

    Returns (planes, g_real) where planes[0..3] = ax, ay, bx, by and invalid
    edges are encoded as degenerate (ay == by == BIG) so they never straddle
    any point's scanline. ``e_pad`` must be a multiple of 8 and ``g_pad`` a
    multiple of 128 (the reference's tiling contract); violations raise
    :class:`TilingError`. Each zone's real edges are compacted to the front
    and E is trimmed to the largest real count, as in the reference.
    """
    if g_pad < 128 or g_pad % 128:
        raise TilingError(
            f"g_pad must be a positive multiple of 128 (TPU lane width), "
            f"got {g_pad}"
        )
    if e_pad < 8 or e_pad % 8:
        raise TilingError(
            f"e_pad must be a positive multiple of 8 (TPU sublane width), "
            f"got {e_pad}"
        )
    from types import SimpleNamespace

    host = SimpleNamespace(
        verts=polys.verts.cpu().numpy(),
        ring_len=polys.ring_len.cpu().numpy(),
        geom_type=polys.geom_type.cpu().numpy(),
    )
    G, R, V = host.verts.shape[0], host.verts.shape[1], host.verts.shape[2]
    a4, b4, poly_mask, _, _ = _edges(host, xp=np)
    a = a4.reshape(G, R * (V - 1), 2)
    b = b4.reshape(G, R * (V - 1), 2)
    mask = poly_mask.reshape(G, R * (V - 1))
    order = np.argsort(~mask, axis=1, kind="stable")
    a = np.take_along_axis(a, order[..., None], axis=1)
    b = np.take_along_axis(b, order[..., None], axis=1)
    mask = np.take_along_axis(mask, order, axis=1)
    # keep at least one (degenerate) edge column
    e_real = max(int(mask.sum(axis=1).max()), 1) if G else 0
    a, b, mask = a[:, :e_real], b[:, :e_real], mask[:, :e_real]
    E = e_real
    g_sz = ((G + g_pad - 1) // g_pad) * g_pad
    e_sz = ((E + e_pad - 1) // e_pad) * e_pad
    planes = np.empty((4, e_sz, g_sz), dtype=host.verts.dtype)
    planes[0], planes[2] = 0.0, 0.0
    planes[1], planes[3] = _BIG_F, _BIG_F
    planes[0, :E, :G] = np.where(mask, a[..., 0], 0.0).T
    planes[1, :E, :G] = np.where(mask, a[..., 1], _BIG_F).T
    planes[2, :E, :G] = np.where(mask, b[..., 0], 0.0).T
    planes[3, :E, :G] = np.where(mask, b[..., 1], _BIG_F).T
    return torch.as_tensor(planes, device=polys.verts.device), G


# ----------------------------------------------------------------- pip_zone


def pip_zone_plain(
    points: torch.Tensor, planes: torch.Tensor, n_real_g: int,
    chunk_e: int = 8,
) -> torch.Tensor:
    """Plain torch twin of the ``pip_zone`` kernel: (N,) int32 first
    containing polygon id, else -1. Slope once per edge, then
    ``ax + (py - ay) * slope`` — the reference kernel's order. Loops over
    edges in chunks of ``chunk_e`` so the (N, G, chunk) intermediate stays
    bounded."""
    px = points[:, 0][:, None, None]  # (N, 1, 1)
    py = points[:, 1][:, None, None]
    E, G = planes.shape[1], planes.shape[2]
    cnt = torch.zeros(points.shape[0], G, dtype=torch.int32, device=points.device)
    for e0 in range(0, E, chunk_e):
        ax = planes[0, e0:e0 + chunk_e].T[None]  # (1, G, c)
        ay = planes[1, e0:e0 + chunk_e].T[None]
        bx = planes[2, e0:e0 + chunk_e].T[None]
        by = planes[3, e0:e0 + chunk_e].T[None]
        straddle = (ay > py) != (by > py)
        denom = torch.where(by == ay, torch.ones_like(by), by - ay)
        slope = (bx - ax) / denom
        xcross = ax + (py - ay) * slope
        hit = straddle & (px < xcross)
        cnt += hit.sum(dim=2, dtype=torch.int32)
    gid = torch.arange(G, dtype=torch.int32, device=points.device)[None, :]
    valid = ((cnt & 1) == 1) & (gid < n_real_g)
    best = torch.where(valid, gid, _SENT).amin(dim=1)
    return torch.where(best >= _SENT, -1, best).to(torch.int32)


def pip_zone(
    points: torch.Tensor,
    planes: torch.Tensor,
    n_real_g: int | None = None,
    tile_n: int = 1024,
    tile_e: int = 64,
    tile_g: int = 128,
) -> torch.Tensor:
    """For each point, the id of the first polygon containing it, else -1.

    points: (N, 2); planes: (4, E, G) from :func:`edge_planes`. ``tile_n``
    must be a multiple of 8; E and G are padded to ``tile_e``/``tile_g``
    multiples here. CPU tensors run :func:`pip_zone_plain`; CUDA tensors
    launch the kernel (float32 only).
    """
    if n_real_g is None:
        n_real_g = planes.shape[2]
    if tile_n % 8:
        raise ValueError(f"tile_n must be a multiple of 8, got {tile_n}")
    E, G = planes.shape[1], planes.shape[2]
    if E % tile_e or G % tile_g:
        e_sz = ((E + tile_e - 1) // tile_e) * tile_e
        g_sz = ((G + tile_g - 1) // tile_g) * tile_g
        planes = torch.stack([
            _pad_to(_pad_to(planes[c], e_sz, 0, v), g_sz, 1, v)
            for c, v in enumerate((0.0, _BIG_F, 0.0, _BIG_F))
        ])
    if points.device.type == "cpu":
        return pip_zone_plain(points, planes, int(n_real_g))
    if points.dtype != torch.float32 or planes.dtype != torch.float32:
        raise ValueError(
            f"pip_zone on CUDA takes float32 points and planes, got "
            f"{points.dtype}/{planes.dtype}"
        )
    if planes.device != points.device:
        raise ValueError("points and planes must be on the same device")
    points = points.contiguous()
    planes = planes.contiguous()
    N = points.shape[0]
    out = torch.empty(N, dtype=torch.int32, device=points.device)
    if N == 0:
        return out
    lib = _build.load("pip")
    stream = torch.cuda.current_stream(points.device).cuda_stream
    with torch.cuda.device(points.device):
        rc = lib.mosaic_pip_zone(
            points.data_ptr(), N, planes.data_ptr(), planes.shape[1],
            planes.shape[2], int(n_real_g), out.data_ptr(), stream,
        )
    _build.check(rc, "pip_zone")
    _build.count_launch(pip_zone)
    return out


pip_zone.launches = 0


def pip_zone_reference(points: torch.Tensor, polys: DeviceGeometry) -> torch.Tensor:
    """torch oracle for pip_zone (first containing polygon id per point):
    the dense even-odd test of ``core/geometry/predicates.contains_xy``
    with the multiply-then-divide crossing, over every polygon edge."""
    a, b, mask, _, _ = _edges(polys)
    mask = mask & is_polygonal(polys.geom_type)[:, None, None]
    G = a.shape[0]
    a = a.reshape(G, -1, 2)
    b = b.reshape(G, -1, 2)
    mask = mask.reshape(G, -1)
    px = points[:, 0][:, None, None]
    py = points[:, 1][:, None, None]
    ay, by = a[None, ..., 1], b[None, ..., 1]
    ax, bx = a[None, ..., 0], b[None, ..., 0]
    straddle = (ay > py) != (by > py)
    denom = by - ay
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    xcross = ax + (py - ay) * (bx - ax) / denom
    hit = straddle & (px < xcross) & mask[None]
    inside = (hit.sum(dim=-1) & 1) == 1  # (N, G)
    g_ids = torch.arange(G, dtype=torch.int32, device=points.device)[None, :]
    first = torch.where(inside, g_ids, _SENT).amin(dim=1)
    return torch.where(first == _SENT, -1, first).to(torch.int32)


# ---------------------------------------------------------- pip_heavy_tiled


def pip_heavy_plain(px, py, rows, heavy_edges, heavy_ebits, heavy_slot_geom,
                    eps2=None):
    """Plain torch twin of the ``pip_heavy_tiled`` kernel.

    Same contract as :func:`pip_heavy_tiled`. The slot bits are held as
    int32 with the reference's uint32 bit patterns (torch's uint32
    support is partial); XOR, ``>>`` then ``& 1`` read the same bits.
    torch has no XOR reduction, so parity is XOR-accumulated in a loop
    over the E2 edges. A row past the table (>= H), like -1, is a pad, as
    the reference kernel masks it.
    """
    live = (rows >= 0) & (rows < heavy_edges.shape[0])
    r = torch.where(live, rows.long(), 0)
    edges = heavy_edges[r]  # (K, E2, 4)
    bits = heavy_ebits[r].to(torch.int32)  # (K, E2)
    geoms = heavy_slot_geom[r]  # (K, M2)
    ax, ay = edges[..., 0], edges[..., 1]
    bx, by = edges[..., 2], edges[..., 3]
    pxb, pyb = px[:, None], py[:, None]
    straddle = (ay > pyb) != (by > pyb)
    denom = torch.where(by == ay, torch.ones_like(by), by - ay)
    xcross = ax + (pyb - ay) * (bx - ax) / denom
    crossed = straddle & (pxb < xcross)
    vals = torch.where(crossed, bits, torch.zeros_like(bits))
    par = torch.zeros_like(bits[:, 0])
    for e in range(vals.shape[1]):
        par = par ^ vals[:, e]
    m = torch.arange(geoms.shape[1], dtype=torch.int32, device=par.device)
    inside = ((par[:, None] >> m) & 1) == 1
    hit = inside & (geoms >= 0)
    best = torch.where(hit, geoms, _I32_MAX).amin(dim=1)
    best = torch.where(live, best, _I32_MAX).to(torch.int32)
    if eps2 is None:
        return best, None
    e2 = torch.as_tensor(eps2, dtype=heavy_edges.dtype, device=px.device)
    ex, ey = bx - ax, by - ay
    qx, qy = pxb - ax, pyb - ay
    dd = ex * ex + ey * ey
    t = (qx * ex + qy * ey) / torch.where(dd == 0, torch.ones_like(dd), dd)
    t = torch.clamp(t, 0.0, 1.0)
    rx, ry = qx - t * ex, qy - t * ey
    near = ((rx * rx + ry * ry <= e2) & (bits != 0)).any(dim=1)
    return best, near & live


def pip_heavy_tiled(
    px: torch.Tensor,
    py: torch.Tensor,
    rows: torch.Tensor,
    heavy_edges: torch.Tensor,
    heavy_ebits: torch.Tensor,
    heavy_slot_geom: torch.Tensor,
    eps2=None,
    *,
    tile_n: int = 512,
    tile_e: int = 64,
    tile_g: int = 128,
):
    """Heavy-cell probe: per-point slot parity against its own heavy row.

    ``px``/``py``: (K,) f32 compacted heavy-lane points; ``rows``: (K,)
    int32 heavy-table row per point (-1 or >= H = pad). ``heavy_edges`` (H, E2,
    4) f32, ``heavy_ebits`` (H, E2) int32 slot bitmasks (uint32 bit
    patterns) and ``heavy_slot_geom`` (H, M2) int32 are the ChipIndex
    heavy tables. ``eps2`` is the squared band width: pass a Python float
    already rounded to f32 (a tensor also works, at the cost of reading
    it back from the device on every call). Returns ``(best, near)``
    with ``best`` (K,) int32 using int32-max as the no-hit sentinel and
    ``near`` (K,) bool when ``eps2`` is given, else None. CPU tensors run
    :func:`pip_heavy_plain`; CUDA tensors launch the kernels: one call
    groups the points by row on the device (a counting sort into one int32
    scratch tensor) and probes each group against its row staged in shared
    memory, and counts one launch.
    """
    if heavy_edges.dtype != torch.float32:
        raise ValueError(
            "pip_heavy_tiled requires float32 heavy tables (the kernel has "
            f"no f64 path), got {heavy_edges.dtype}"
        )
    if tile_g < 128 or tile_g % 128:
        raise TilingError(
            f"tile_g must be a positive multiple of 128, got {tile_g}"
        )
    if tile_e % 8 or tile_n % 8:
        raise TilingError(
            f"tile_e/tile_n must be multiples of 8, got {tile_e}/{tile_n}"
        )
    if px.device.type == "cpu":
        return pip_heavy_plain(
            px, py, rows, heavy_edges, heavy_ebits, heavy_slot_geom, eps2
        )
    dev = px.device
    for name, t in (("py", py), ("rows", rows), ("heavy_edges", heavy_edges),
                    ("heavy_ebits", heavy_ebits),
                    ("heavy_slot_geom", heavy_slot_geom)):
        if t.device != dev:
            raise ValueError(f"pip_heavy_tiled: {name} is on {t.device}, not {dev}")
    K = px.shape[0]
    H, E2 = heavy_edges.shape[0], heavy_edges.shape[1]
    M2 = heavy_slot_geom.shape[1]
    if M2 > 32:
        raise ValueError(f"pip_heavy_tiled: at most 32 slots per row, got {M2}")
    if K >= _I32_MAX:
        raise ValueError(f"pip_heavy_tiled: at most 2**31 - 2 points, got {K}")
    pxc = px.to(torch.float32).contiguous()
    pyc = py.to(torch.float32).contiguous()
    rws = rows.to(torch.int32).contiguous()
    edges = heavy_edges.contiguous()
    bits = heavy_ebits.to(torch.int32).contiguous()
    geom = heavy_slot_geom.to(torch.int32).contiguous()
    best = torch.empty(K, dtype=torch.int32, device=dev)
    banded = eps2 is not None
    near = torch.empty(K if banded else 0, dtype=torch.bool, device=dev)
    if K == 0 or H == 0:
        best.fill_(_I32_MAX)
        near.fill_(False)
        return best, (near if banded else None)
    e2 = float(np.float32(float(eps2))) if banded else 0.0
    lib = _build.load("pip")
    # the counting sort's counts, offsets, ranks, order and work items
    n_scratch = lib.mosaic_pip_heavy_scratch(K, H)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.mosaic_pip_heavy(
            pxc.data_ptr(), pyc.data_ptr(), rws.data_ptr(), K, H,
            edges.data_ptr(), bits.data_ptr(), geom.data_ptr(), E2, M2, e2,
            int(banded), best.data_ptr(), near.data_ptr() if banded else None,
            scratch.data_ptr(), n_scratch, stream,
        )
    _build.check(rc, "pip_heavy_tiled")
    _build.count_launch(pip_heavy_tiled)
    return best, (near if banded else None)


pip_heavy_tiled.launches = 0
