"""What the harness takes from the program: its polygon column type, its
index build, and the documented fields of its ChipIndex (the keys of
``ChipIndex.to_arrays()``). The reference never imports this module."""

from __future__ import annotations

import numpy as np
import torch

#: ChipIndex fields the harness reads (documented keys of to_arrays())
FIELDS = ("cells", "cell_heavy", "cell_convex", "heavy_edges", "heavy_ebits",
          "heavy_slot_geom")


def packed(polys):
    """The polygons as the program's PackedGeometry (one part each)."""
    from mosaic_tpu_torch.core.types import GeometryType, PackedGeometry

    n = len(polys)
    return PackedGeometry(
        xy=np.asarray(polys.xy, np.float64),
        ring_offsets=np.asarray(polys.ring_offsets, np.int64),
        part_offsets=np.asarray(polys.geom_rings, np.int64),
        geom_offsets=np.arange(n + 1, dtype=np.int64),
        geom_type=np.full(n, int(GeometryType.POLYGON), np.uint8),
        srid=np.full(n, 4326, np.int32),
    )


def index_system(name: str):
    from mosaic_tpu_torch.core.index import index_system_from_name

    return index_system_from_name(name)


def build_index(polys, system, resolution: int, device):
    """The program's public path: tessellate, then build_chip_index."""
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql.join import build_chip_index

    table = tessellate(packed(polys), system, resolution, keep_core_geoms=False)
    return build_chip_index(table, device=device)


def index_from_arrays(arrays: dict, device):
    from mosaic_tpu_torch.sql.join import ChipIndex

    return ChipIndex.from_arrays(arrays, device=device)


def fields(ix) -> dict | None:
    """The documented fields the harness reads, or None if one is gone."""
    out = {}
    for n in FIELDS:
        v = getattr(ix, n, None)
        if not isinstance(v, torch.Tensor):
            return None
        out[n] = v
    shift = getattr(getattr(ix, "border", None), "shift", None)
    if not isinstance(shift, torch.Tensor):
        return None
    out["border.shift"] = shift
    return out


def lanes(cells: torch.Tensor, f: dict) -> dict:
    """Each point's lane from its cell and the index's cell table: found
    (its cell is in the index), convex (a convex single-chip cell), heavy
    (a heavy cell, not convex), as (N,) masks and its heavy row."""
    table = f["cells"]
    u = torch.searchsorted(table, cells).clamp(max=table.numel() - 1)
    found = table[u] == cells
    convex = found & (f["cell_convex"][u] >= 0)
    row = torch.where(found & ~convex, f["cell_heavy"][u], -1)
    return {"found": found, "convex": convex, "heavy": row >= 0, "row": row}
