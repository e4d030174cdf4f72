"""Carry state across from the JAX package.

The port and the reference agree field for field on the join index, the
KNN index, the geometry column and the in-memory raster; this module
builds the port's :class:`~mosaic_tpu_torch.sql.join.ChipIndex`,
:class:`~mosaic_tpu_torch.knn.KNNIndex`,
:class:`~mosaic_tpu_torch.core.types.PackedGeometry` and
:class:`~mosaic_tpu_torch.raster.Raster` from the reference's, so both
packages can run on one input. It reads plain numpy fields and never
imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .sql.join import ChipIndex

#: PackedGeometry fields a reference candidate column is carried by
_PACKED = ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid")
#: DeviceGeometry fields of the shifted candidate column
_DEVICE = ("verts", "ring_len", "ring_is_hole", "n_rings", "geom_type", "shift")
#: Raster fields, all host values
_RASTER = ("data", "gt", "srid", "nodata", "meta_xml", "path", "pages")


def geometry_from_reference(col):
    """The port's PackedGeometry from a reference ``PackedGeometry`` (or
    any object with its numpy fields): the same arrays, copied, z and the
    per-geometry z flags included."""
    from .core.types import PackedGeometry

    z = getattr(col, "z", None)
    has_z = getattr(col, "geom_has_z", None)
    return PackedGeometry(
        **{n: np.array(getattr(col, n)) for n in _PACKED},
        z=None if z is None else np.array(z),
        geom_has_z=None if has_z is None else np.array(has_z),
    )


def raster_from_reference(raster):
    """The port's Raster from a reference ``Raster`` (its numpy pixels
    copied, the geotransform, SRID, nodata and metadata as they are)."""
    from .raster import Raster

    fields = {n: getattr(raster, n) for n in _RASTER}
    fields["data"] = np.array(fields["data"])
    fields["gt"] = tuple(float(v) for v in fields["gt"])
    return Raster(**fields)


def chip_index_from_reference(arrays: dict[str, np.ndarray], device=None) -> ChipIndex:
    """The port's ChipIndex from a reference ChipIndex's fields as numpy.

    ``arrays`` maps each field name of ``mosaic_tpu.sql.join.ChipIndex``
    to its array (uint32 slot bits and the uint64 hash multiplier as the
    reference stores them), ``border.<field>`` to the fields of its
    ``border`` geometry, and optionally the ``hr_*`` keys of the host
    companion's ``save_arrays()``, which become ``.host``, and the
    ``voronoi.<field>`` arrays of its ``VoronoiTables`` (``method`` a 0-d
    string), which become ``.voronoi``. ``device`` defaults to the card.
    :meth:`ChipIndex.to_arrays` is the inverse.
    """
    return ChipIndex.from_arrays(arrays, device=device)


def knn_index_from_reference(arrays: dict, index_system, device=None):
    """The port's KNNIndex from a reference ``mosaic_tpu.knn.KNNIndex``
    as numpy arrays.

    ``arrays`` holds ``candidates.<field>`` (the candidate column's
    PackedGeometry arrays), ``cells``, ``rows``, ``shift``,
    ``resolution``, ``cell_width`` and ``fingerprint``, ``dc.<field>``
    (the shifted device column), and, for polygonal candidates,
    ``chip.<key>`` (the chip index as :func:`chip_index_from_reference`
    takes it, ``chip.voronoi.*`` included). ``index_system`` is the port's
    system of the same grid. The host twin is rebuilt from the
    candidates; the fingerprint is recomputed and must equal the
    reference's.
    """
    import torch

    from . import resolve_device
    from .core.geometry.device import DeviceGeometry
    from .core.types import PackedGeometry
    from .knn.index import KNNIndex, _fingerprint, _host_twin

    dev = resolve_device(device)
    cand = PackedGeometry(**{n: np.asarray(arrays[f"candidates.{n}"]) for n in _PACKED})
    cells = np.asarray(arrays["cells"], dtype=np.int64)
    rows = np.asarray(arrays["rows"], dtype=np.int64)
    shift = np.asarray(arrays["shift"], dtype=np.float64)
    res = int(np.asarray(arrays["resolution"]))
    fp = _fingerprint(cells, rows, shift, res, index_system)
    if fp != str(np.asarray(arrays["fingerprint"])):
        raise ValueError(
            f"KNN index fingerprint {fp} differs from the reference's "
            f"{arrays['fingerprint']!s}: another index system or arrays"
        )
    dc = DeviceGeometry(**{
        n: torch.from_numpy(np.array(arrays[f"dc.{n}"], order="C")).to(dev)
        for n in _DEVICE
    })
    chip = {k[5:]: v for k, v in arrays.items() if k.startswith("chip.")}
    return KNNIndex(
        candidates=cand,
        index_system=index_system,
        resolution=res,
        cells=cells,
        rows=rows,
        dc=dc,
        shift=shift,
        cell_width=float(np.asarray(arrays["cell_width"])),
        host=_host_twin(cand, shift),
        chip_index=ChipIndex.from_arrays(chip, device=dev) if chip else None,
        fingerprint=fp,
    )
