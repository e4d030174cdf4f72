"""H3 cell assignment: a hand-written CUDA kernel for Hopper, and its plain torch version.

:func:`geo_to_cell_kernel` maps (N, 2) lng/lat degrees to (N,) int64 H3
cells at one resolution and, with ``with_margin``, to the (N, 2)
relative margins of the finest hex rounding as well
(`core/index/h3/core.py _rel_margin`, the exact join's band input). It
is the port's cell assignment for every H3 caller of ``point_to_cell``
and ``point_to_cell_margin`` on a CUDA tensor (`H3IndexSystem._geo`).

It replaces no Pallas kernel: the JAX package runs ``geo_to_cell`` as one
jitted program that XLA fuses on the TPU, while eager torch runs the same
chain (:func:`geo_to_cell_plain`, `core._geo_to_cell_device`) as some 600
device ops, each reading and writing whole per-point intermediates in
device memory. The kernel (``csrc/h3.cu``) takes a point end to end in
registers and writes only the outputs; it repeats the plain version op
for op as ATen evaluates it on the card, so the two give the same bits
(the argument is in the source).

`H3IndexSystem._geo` sends a CUDA tensor to the kernel, which launches
or raises, and any other tensor to the plain version. The kernel reads the
input through its strides (a ring slot's view or a column-major array is
not copied), reads the constant tables from the device copies the plain
version uses (`hexmath.TorchNamespace.asarray`), allocates its outputs
with ``torch.empty`` and reads nothing back, so a warm call makes no host
sync. Launches are counted in ``geo_to_cell_kernel.launches``
(`_build.count_launch`: a launch captured into a CUDA graph counts at
each replay).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.index.h3 import constants as C
from ..core.index.h3 import core as _core
from ..core.index.h3 import hexmath as hm
from . import _build

__all__ = ["geo_to_cell_kernel", "geo_to_cell_plain"]

#: the factor ``torch.deg2rad`` multiplies by (ATen's ``M_PI_180``)
DEG2RAD = 0.017453292519943295769236907684886127134428718885417

_ENTRY = {torch.float32: "mosaic_h3_cells_f32", torch.float64: "mosaic_h3_cells_f64"}


def geo_to_cell_plain(xy: torch.Tensor, res: int, with_margin: bool = False,
                      alt: bool = False):
    """Plain torch version: ``torch.deg2rad`` of each column, then the
    eager chain of `core._geo_to_cell_device` on the tensor's device.
    ``with_margin`` and ``alt`` are `core.geo_to_cell`'s."""
    xp = hm.TorchNamespace(xy.device)
    lng = torch.deg2rad(xy[..., 0])
    lat = torch.deg2rad(xy[..., 1])
    return _core._geo_to_cell_device(lat, lng, res, xp, with_margin, alt)


def _scalars(dtype: torch.dtype, res: int):
    """The Python floats the plain version computes with, in the kernel's
    order (``Scalars`` in ``csrc/h3.cu``). ``y / SIN60`` runs on the card
    as ``y * (1 / SIN60)``, the reciprocal taken in the tensor's dtype
    (ATen's division by a CPU scalar), so that reciprocal is passed."""
    scale = float(C.SQRT7**res / C.RES0_U_GNOMONIC)
    if dtype == torch.float32:
        inv_sin60 = float(np.float32(1.0) / np.float32(C.SIN60))
    else:
        inv_sin60 = 1.0 / C.SIN60
    return (ctypes.c_double * 8)(
        DEG2RAD, scale, hm._COS_AP7, hm._SIN_AP7, C.SIN60, inv_sin60,
        hm.DOT_FLOOR, scale,
    )


def geo_to_cell_kernel(xy: torch.Tensor, res: int, with_margin: bool = False):
    """(..., 2) lng/lat degrees -> (...,) int64 H3 cells at ``res``; with
    ``with_margin``, ``(cells, margins)``, the (..., 2) relative margins
    in the input's dtype. Takes a CUDA tensor of float32 or float64 points
    and ``res`` in 0-15, else ``ValueError``. Counts one launch in
    ``geo_to_cell_kernel.launches`` (none for an empty input)."""
    if xy.device.type != "cuda":
        raise ValueError(f"the h3 kernel runs on CUDA tensors, got one on {xy.device}")
    if xy.dtype not in _ENTRY:
        raise ValueError(
            f"geo_to_cell on CUDA takes float32 or float64 points, got {xy.dtype}"
        )
    if xy.shape[-1:] != (2,):
        raise ValueError(f"geo_to_cell takes (..., 2) lng/lat points, got {tuple(xy.shape)}")
    if not 0 <= int(res) <= C.MAX_RES:
        raise ValueError(f"H3 resolution must lie in 0-{C.MAX_RES}, got {res}")
    res = int(res)
    dev = xy.device
    lead = tuple(xy.shape[:-1])
    pts = xy if xy.dim() == 2 else xy.reshape(-1, 2)
    n = pts.shape[0]
    cells = torch.empty(n, dtype=torch.int64, device=dev)
    margin = torch.empty((n, 2) if with_margin else (0,), dtype=xy.dtype, device=dev)
    if n:
        xp = hm.TorchNamespace(dev)
        face_vec = xp.asarray(hm._FACE_CENTER_VEC3, dtype=xy.dtype)
        face_basis = xp.asarray(hm._face_basis(), dtype=xy.dtype)
        combo = xp.asarray(_core._combo_table())
        turns = xp.asarray(_core._TURNS)
        rot_pow = xp.asarray(hm.ROT60_CCW_POW.astype(np.int32).reshape(-1))
        lib = _build.load("h3")
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = getattr(lib, _ENTRY[xy.dtype])(
                pts.data_ptr(), n, pts.stride(0), pts.stride(1),
                face_vec.data_ptr(), face_basis.data_ptr(), combo.data_ptr(),
                turns.data_ptr(), rot_pow.data_ptr(), _scalars(xy.dtype, res),
                hm.pack_const(res), res, cells.data_ptr(),
                margin.data_ptr() if with_margin else None, stream,
            )
        _build.check(rc, "h3 geo_to_cell")
        _build.count_launch(geo_to_cell_kernel)
    cells = cells.reshape(lead)
    if not with_margin:
        return cells
    return cells, margin.reshape(lead + (2,))


geo_to_cell_kernel.launches = 0
