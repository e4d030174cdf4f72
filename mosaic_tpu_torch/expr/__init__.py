"""Geo-expression compiler: typed op-trees fused into one program per
dispatch signature.

Port of ``mosaic_tpu/expr``: a small algebra over per-pixel band values
(`expr.ast`, a copy of the reference's, so trees hash alike), a lowering
that fuses the whole tree INTO the segment-reduced zonal fold so "NDVI,
mask clouds, zonal-mean by district" is one program per tile
(`expr.compile`), execution through the dispatch core's guarded path
(`expr.eval`), and a numpy-f64 interpreter of the same tree that the
fused results must match bit for bit (`expr.host_oracle`).

Entry points most callers want::

    from mosaic_tpu_torch import expr

    e = expr.ndvi(nir=2, red=1).mask_where(expr.band(3) < 0.5)
    result = engine.map(e.zonal(by="zones"), raster)
"""

from .ast import (  # noqa: F401
    Band,
    BinOp,
    BoolOp,
    CellOf,
    Compare,
    Const,
    Expr,
    InZone,
    Join,
    MaskWhere,
    Not,
    Where,
    Zonal,
    ZoneData,
    band,
    bands_of,
    cell_of,
    const,
    in_zone,
    left_area,
    mask_where,
    ndvi,
    norm_diff,
    overlap_area,
    overlap_fraction,
    right_area,
    structure_key,
    terminal_of,
    tree_hash,
    uses_cells,
    uses_zones,
    validate,
    validate_pair,
    where,
    zone_data,
)
from .compile import (  # noqa: F401
    cold_compiles,
    freeze,
    pixel_program,
    run_zonal,
    signature_of,
    signatures,
    zonal_program,
)
from .eval import map_join, map_pixels, map_zonal, warmup_expr  # noqa: F401
from .host_oracle import (  # noqa: F401
    host_expr_tile_partial,
    host_expr_zonal_oracle,
    interpret,
)

__all__ = [
    "Band",
    "BinOp",
    "BoolOp",
    "CellOf",
    "Compare",
    "Const",
    "Expr",
    "InZone",
    "Join",
    "MaskWhere",
    "Not",
    "Where",
    "Zonal",
    "ZoneData",
    "band",
    "bands_of",
    "cell_of",
    "cold_compiles",
    "const",
    "freeze",
    "host_expr_tile_partial",
    "host_expr_zonal_oracle",
    "in_zone",
    "interpret",
    "map_join",
    "map_pixels",
    "map_zonal",
    "mask_where",
    "ndvi",
    "norm_diff",
    "pixel_program",
    "run_zonal",
    "signature_of",
    "signatures",
    "structure_key",
    "terminal_of",
    "tree_hash",
    "uses_cells",
    "uses_zones",
    "validate",
    "warmup_expr",
    "where",
    "zonal_program",
    "zone_data",
]
