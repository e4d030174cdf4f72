"""Device-resident geometry column (a dataclass of torch tensors).

Port of ``mosaic_tpu/core/geometry/device.py``: a whole column lives on
the device as one rectangular tensor set, produced from
:class:`PaddedGeometry` via :func:`to_device`.

Precision strategy: hosts keep float64; device tensors default to float32
with an optional per-column ``shift`` (a float64 origin subtracted on the
host before narrowing), so coordinates keep ~1e-7·range relative
precision. The shift itself stays float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import FLOAT, resolve_device
from ..types import GeometryType, PackedGeometry, PaddedGeometry


@dataclasses.dataclass
class DeviceGeometry:
    """Columnar geometry batch on a device.

    verts: (G, R, V, 2) — polygon rings closed (first vertex repeated at
        index ``ring_len``); pad is zeros.
    ring_len: (G, R) int32 — real vertex count per ring (no closing vertex).
    ring_is_hole: (G, R) bool.
    n_rings: (G,) int32.
    geom_type: (G,) int32 — GeometryType codes.
    shift: (2,) float64 — origin that was subtracted from all coordinates.
    """

    verts: torch.Tensor
    ring_len: torch.Tensor
    ring_is_hole: torch.Tensor
    n_rings: torch.Tensor
    geom_type: torch.Tensor
    shift: torch.Tensor

    def __len__(self):
        return self.geom_type.shape[0]


def recenter_shift(padded: PaddedGeometry) -> np.ndarray:
    """The f64 origin ``to_device(recenter=True)`` subtracts: the midpoint
    of the real vertices' bounding box."""
    verts = np.asarray(padded.verts, dtype=np.float64)
    mask = padded.vert_mask()
    if not mask.any():
        return np.zeros(2)
    lo = np.array([verts[..., 0][mask].min(), verts[..., 1][mask].min()])
    hi = np.array([verts[..., 0][mask].max(), verts[..., 1][mask].max()])
    return (lo + hi) / 2.0


def to_device(
    padded: PaddedGeometry,
    dtype=FLOAT,
    recenter: bool = False,
    shifted_verts: np.ndarray | None = None,
    shift: np.ndarray | None = None,
    device=None,
) -> DeviceGeometry:
    """Move a padded column to ``device`` (default: the card).

    ``shifted_verts``/``shift`` let a caller that already recentered the
    f64 vertex array (`sql.join.build_chip_index`) skip the duplicate pass.
    Narrowing happens on the host (numpy), so the device values are the
    same bits as the reference's."""
    dev = resolve_device(device)
    if not padded.rings_closed:
        raise ValueError(
            "DeviceGeometry kernels assume closed polygon rings; build the "
            "PaddedGeometry with close_rings=True"
        )
    if shifted_verts is not None:
        verts = shifted_verts
        shift = np.zeros(2) if shift is None else shift
    elif recenter:
        verts = np.asarray(padded.verts, dtype=np.float64)
        shift = recenter_shift(padded)
        verts = np.where(
            (padded.ring_len[:, :, None] > 0)[..., None], verts - shift, 0.0
        )
    else:
        verts = np.asarray(padded.verts, dtype=np.float64)
        shift = np.zeros(2)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))

    def put(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dt), device=dev)

    return DeviceGeometry(
        verts=put(verts, np_dtype),
        ring_len=put(padded.ring_len, np.int32),
        ring_is_hole=put(padded.ring_is_hole, bool),
        n_rings=put(padded.n_rings, np.int32),
        geom_type=put(padded.geom_type, np.int32),
        shift=put(shift, np.float64),
    )


def pack_to_device(
    col: PackedGeometry,
    dtype=FLOAT,
    max_rings: int | None = None,
    max_verts: int | None = None,
    recenter: bool = False,
    device=None,
) -> DeviceGeometry:
    return to_device(
        col.to_padded(max_rings=max_rings, max_verts=max_verts, dtype=np.float64),
        dtype=dtype,
        recenter=recenter,
        device=device,
    )


def take_rows(dg: DeviceGeometry, rows) -> DeviceGeometry:
    """Row-gather a DeviceGeometry column (the shared shift is
    untouched)."""
    return DeviceGeometry(
        verts=dg.verts[rows],
        ring_len=dg.ring_len[rows],
        ring_is_hole=dg.ring_is_hole[rows],
        n_rings=dg.n_rings[rows],
        geom_type=dg.geom_type[rows],
        shift=dg.shift,
    )


def edges(geoms, xp=torch):
    """Shared edge extraction: returns (a, b, poly_mask, line_mask, type_mask).

    a, b: (G, R, V-1, 2) edge endpoints. ``poly_mask`` treats rings as closed
    (valid for i < ring_len, polygon rings store the closing vertex);
    ``line_mask`` treats them as open (i < ring_len - 1). ``type_mask`` picks
    the right one per geometry's type (points contribute no edges).
    ``geoms`` is a DeviceGeometry (``xp=torch``) or anything with numpy
    verts/ring_len/geom_type arrays of the same layout (``xp=np``).
    """
    v = geoms.verts
    a = v[:, :, :-1, :]
    b = v[:, :, 1:, :]
    if xp is np:
        idx = np.arange(v.shape[2] - 1, dtype=np.int32)[None, None, :]
    else:
        idx = torch.arange(v.shape[2] - 1, device=v.device)[None, None, :]
    poly_mask = idx < geoms.ring_len[:, :, None]
    line_mask = idx < (geoms.ring_len[:, :, None] - 1)
    gt = geoms.geom_type
    type_mask = xp.where(
        is_polygonal(gt)[:, None, None],
        poly_mask,
        line_mask & is_linear(gt)[:, None, None],
    )
    return a, b, poly_mask, line_mask, type_mask


def is_polygonal(geom_type):
    return (geom_type == GeometryType.POLYGON) | (geom_type == GeometryType.MULTIPOLYGON)


def is_linear(geom_type):
    return (geom_type == GeometryType.LINESTRING) | (
        geom_type == GeometryType.MULTILINESTRING
    )


def is_point_like(geom_type):
    return (geom_type == GeometryType.POINT) | (geom_type == GeometryType.MULTIPOINT)
