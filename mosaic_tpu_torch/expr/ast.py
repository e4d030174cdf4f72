"""Typed expression trees over raster tile stacks.

Port of ``mosaic_tpu/expr/ast.py``, a copy of that plain-Python module
(the port imports nothing of the JAX package): the nodes, the sugar,
:func:`structure_key`, :func:`tree_hash` and the validation rules are
the reference's line for line, so a tree hashes to the reference's
digest and the port resumes the reference's durable expression scans.

Reference analog: Catalyst's expression nodes — the reference compiles
~120 ST_/RST_ expressions through Spark's whole-stage codegen; here the
tree is a small algebra over per-pixel band values that
`expr/compile.py` lowers into ONE fused program per dispatch signature
(tree structure × tile bucket × segment count), so an "NDVI, mask
clouds, zonal-mean" pipeline is one program per tile instead of N
staged host→device round trips.

Nodes are frozen dataclasses: structural equality and hashability come
for free, which is what lets two independently-built but equal trees
share one compiled program in the dispatch core's named cache
(`expr_programs`), and what makes :func:`tree_hash` a stable durable-
scan fingerprint.

The algebra (all per-pixel, over the (B, P) tile stack):

===============  =========  ====================================
node             dtype      meaning
===============  =========  ====================================
``Band(i)``      f64        band *i* (1-based) of the tile stack
``Const(v)``     f64        scalar broadcast
``BinOp``        f64        ``+ - * /`` (also ``min``/``max``)
``Compare``      bool       ``< <= > >= == !=`` (methods ``eq``/``ne``)
``BoolOp``/Not   bool       ``& |`` / ``~`` over bool operands
``Where``        promote    ``cond ? a : b``
``MaskWhere``    value's    keep value where cond; else INVALID
``CellOf``       i64        grid cell id of the pixel center
``InZone``       bool       pixel center inside some vector zone
``ZoneData``     f64        per-zone scalar broadcast to pixels
``Zonal``        terminal   fold into per-zone/per-cell stats
``Join``         terminal   per-pixel (zone row, value) output
===============  =========  ====================================

Mask propagation (the validity rule both the device lowering and the
f64 host oracle implement, over the tile stack's pad ∧ not-nodata ∧
not-NaN mask):

- ``Band(i)`` → band *i*'s tile mask;
- ``Const``/``CellOf``/``InZone``/``ZoneData`` → all-valid;
- ``BinOp``/``Compare``/``BoolOp`` → AND of the operand masks;
- ``Where(c, a, b)`` → ``c.mask ∧ (c ? a.mask : b.mask)`` (only the
  taken branch's validity matters);
- ``MaskWhere(v, c)`` → ``v.mask ∧ c.mask ∧ c`` — the cloud/nodata
  masking primitive: where the condition is False the pixel becomes
  invalid and folds nowhere.

NaN caveat: a NaN *produced on a valid pixel* (e.g. ``0/0`` on real
data) is outside the bit-identity contract — mask such pixels with
:class:`MaskWhere` first. NaN arriving via nodata/speckle is already
invalid in the tile mask and never reaches the fold.
"""

from __future__ import annotations

import dataclasses
import hashlib

__all__ = [
    "Band",
    "BinOp",
    "BoolOp",
    "Compare",
    "CellOf",
    "Const",
    "Expr",
    "InZone",
    "Join",
    "LeftArea",
    "MaskWhere",
    "Not",
    "OverlapArea",
    "RightArea",
    "Where",
    "ZoneData",
    "Zonal",
    "band",
    "bands_of",
    "cell_of",
    "const",
    "in_zone",
    "left_area",
    "mask_where",
    "ndvi",
    "norm_diff",
    "overlap_area",
    "overlap_fraction",
    "right_area",
    "structure_key",
    "terminal_of",
    "tree_hash",
    "uses_cells",
    "uses_zones",
    "validate",
    "validate_pair",
    "walk",
    "where",
    "zone_data",
]

_ARITH = ("add", "sub", "mul", "div", "min", "max")
_CMP = ("lt", "le", "gt", "ge", "eq", "ne")
_BOOL = ("and", "or")
_STATS = ("count", "sum", "min", "max", "mean")


def _as_expr(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, (int, float)):
        return Const(float(v))
    raise TypeError(f"cannot coerce {type(v).__name__} into an Expr")


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base node: operator sugar + the terminal constructors. Equality
    is structural (dataclass), so equal trees share compiled programs."""

    # -- arithmetic (numbers coerce to Const) --------------------------
    def __add__(self, o):
        return BinOp("add", self, _as_expr(o))

    def __radd__(self, o):
        return BinOp("add", _as_expr(o), self)

    def __sub__(self, o):
        return BinOp("sub", self, _as_expr(o))

    def __rsub__(self, o):
        return BinOp("sub", _as_expr(o), self)

    def __mul__(self, o):
        return BinOp("mul", self, _as_expr(o))

    def __rmul__(self, o):
        return BinOp("mul", _as_expr(o), self)

    def __truediv__(self, o):
        return BinOp("div", self, _as_expr(o))

    def __rtruediv__(self, o):
        return BinOp("div", _as_expr(o), self)

    # -- comparisons (``==``/``!=`` stay structural equality; use the
    #    ``eq``/``ne`` methods for pixel comparison nodes) -------------
    def __lt__(self, o):
        return Compare("lt", self, _as_expr(o))

    def __le__(self, o):
        return Compare("le", self, _as_expr(o))

    def __gt__(self, o):
        return Compare("gt", self, _as_expr(o))

    def __ge__(self, o):
        return Compare("ge", self, _as_expr(o))

    def eq(self, o):
        return Compare("eq", self, _as_expr(o))

    def ne(self, o):
        return Compare("ne", self, _as_expr(o))

    def __and__(self, o):
        return BoolOp("and", self, _as_expr(o))

    def __or__(self, o):
        return BoolOp("or", self, _as_expr(o))

    def __invert__(self):
        return Not(self)

    # -- masking + terminals -------------------------------------------
    def mask_where(self, cond) -> "MaskWhere":
        """Keep this value where ``cond`` holds; else the pixel becomes
        invalid (folds nowhere) — the cloud/nodata masking primitive."""
        return MaskWhere(self, _as_expr(cond))

    def zonal(self, stats=_STATS, *, by: str = "zones") -> "Zonal":
        """Terminal: fold into per-zone (``by="zones"``) or per-grid-
        cell (``by="grid"``) statistics."""
        if isinstance(stats, str):
            stats = (stats,)
        return Zonal(self, by=by, stats=tuple(stats))

    def join(self) -> "Join":
        """Terminal: per-pixel (zone row, value) output — the raster
        side of a raster×vector join without a reduction."""
        return Join(self)

    # dtype of the node's per-pixel value: "f64" | "i64" | "bool"
    def dtype(self) -> str:  # pragma: no cover - overridden everywhere
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Band(Expr):
    """Band ``index`` (1-based, GDAL-style) of the tile stack."""

    index: int

    def dtype(self) -> str:
        return "f64"


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float

    def dtype(self) -> str:
        return "f64"


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str
    a: Expr
    b: Expr

    def dtype(self) -> str:
        return "f64"


@dataclasses.dataclass(frozen=True)
class Compare(Expr):
    op: str
    a: Expr
    b: Expr

    def dtype(self) -> str:
        return "bool"


@dataclasses.dataclass(frozen=True)
class BoolOp(Expr):
    op: str
    a: Expr
    b: Expr

    def dtype(self) -> str:
        return "bool"


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    a: Expr

    def dtype(self) -> str:
        return "bool"


@dataclasses.dataclass(frozen=True)
class Where(Expr):
    cond: Expr
    a: Expr
    b: Expr

    def dtype(self) -> str:
        da, db = self.a.dtype(), self.b.dtype()
        if da == db:
            return da
        return "f64"


@dataclasses.dataclass(frozen=True)
class MaskWhere(Expr):
    value: Expr
    cond: Expr

    def dtype(self) -> str:
        return self.value.dtype()


@dataclasses.dataclass(frozen=True)
class CellOf(Expr):
    """Grid cell id of each pixel center at the engine's
    (index_system, resolution) — usable in comparisons and ``Where``."""

    def dtype(self) -> str:
        return "i64"


@dataclasses.dataclass(frozen=True)
class InZone(Expr):
    """True where the pixel center lies inside some vector zone —
    the PIP-probe membership (epsilon-band-exact), as a predicate."""

    def dtype(self) -> str:
        return "bool"


@dataclasses.dataclass(frozen=True)
class ZoneData(Expr):
    """A per-zone f64 scalar (row ``g`` of ``values``) broadcast to
    every pixel of zone ``g``; ``fill`` outside every zone. Build from
    PackedGeometry measures with :func:`zone_data`. The values are part
    of the tree structure, so different tables compile different
    programs — keep tables small (zone counts, not pixel counts)."""

    values: tuple
    fill: float = 0.0

    def dtype(self) -> str:
        return "f64"


@dataclasses.dataclass(frozen=True)
class OverlapArea(Expr):
    """Overlay-join leaf: the intersection area of the candidate
    geometry pair (summed over its shared-cell chip pairs by the device
    fold). Only valid in PAIR trees (`sql.overlay.overlay_measures`),
    never in raster trees — :func:`validate` rejects it there and
    :func:`validate_pair` accepts it."""

    def dtype(self) -> str:
        return "f64"


@dataclasses.dataclass(frozen=True)
class LeftArea(Expr):
    """Overlay-join leaf: the LEFT geometry's total area (pair trees
    only) — the denominator of ``st_overlap_fraction``."""

    def dtype(self) -> str:
        return "f64"


@dataclasses.dataclass(frozen=True)
class RightArea(Expr):
    """Overlay-join leaf: the RIGHT geometry's total area (pair trees
    only)."""

    def dtype(self) -> str:
        return "f64"


@dataclasses.dataclass(frozen=True)
class Zonal(Expr):
    """Terminal: fold ``value`` into per-key (count, sum, min, max)."""

    value: Expr
    by: str = "zones"
    stats: tuple = _STATS

    def dtype(self) -> str:
        return self.value.dtype()


@dataclasses.dataclass(frozen=True)
class Join(Expr):
    """Terminal: per-pixel (zone row, value, valid) — no reduction."""

    value: Expr

    def dtype(self) -> str:
        return self.value.dtype()


# ------------------------------------------------------------- builders


def band(i: int) -> Band:
    return Band(int(i))


def const(v: float) -> Const:
    return Const(float(v))


def where(cond, a, b) -> Where:
    return Where(_as_expr(cond), _as_expr(a), _as_expr(b))


def mask_where(value, cond) -> MaskWhere:
    return MaskWhere(_as_expr(value), _as_expr(cond))


def norm_diff(a, b) -> BinOp:
    """The normalized difference ``(a - b) / (a + b)`` — one fixed
    operation order, shared by the device lowering and the host oracle
    so both compute bit-identical f64."""
    a, b = _as_expr(a), _as_expr(b)
    return BinOp("div", BinOp("sub", a, b), BinOp("add", a, b))


def ndvi(nir: int = 2, red: int = 1) -> BinOp:
    """NDVI over band indices: ``(nir - red) / (nir + red)``."""
    return norm_diff(Band(int(nir)), Band(int(red)))


def cell_of() -> CellOf:
    return CellOf()


def in_zone() -> InZone:
    return InZone()


def overlap_area() -> OverlapArea:
    return OverlapArea()


def left_area() -> LeftArea:
    return LeftArea()


def right_area() -> RightArea:
    return RightArea()


def overlap_fraction() -> BinOp:
    """``intersection_area / left_area`` — the overlay fraction measure,
    one fixed operation order shared by the device lowering and the f64
    host oracle (like :func:`norm_diff`)."""
    return BinOp("div", OverlapArea(), LeftArea())


def zone_data(values, fill: float = 0.0) -> ZoneData:
    """Per-zone auxiliary data as an expression leaf. ``values`` may be
    a sequence of floats (row g = zone g) or a PackedGeometry-measure
    array, e.g. ``zone_data(measures.area(zones_device))``."""
    import numpy as np

    vals = tuple(float(v) for v in np.asarray(values, dtype=np.float64))
    return ZoneData(vals, float(fill))


# ----------------------------------------------------------- inspection


def _children(node: Expr) -> tuple:
    if isinstance(node, (BinOp, Compare, BoolOp)):
        return (node.a, node.b)
    if isinstance(node, Not):
        return (node.a,)
    if isinstance(node, Where):
        return (node.cond, node.a, node.b)
    if isinstance(node, MaskWhere):
        return (node.value, node.cond)
    if isinstance(node, (Zonal, Join)):
        return (node.value,)
    return ()


def walk(node: Expr):
    yield node
    for c in _children(node):
        yield from walk(c)


def bands_of(node: Expr) -> list[int]:
    """Sorted distinct band indices the tree reads."""
    return sorted({n.index for n in walk(node) if isinstance(n, Band)})


def uses_cells(node: Expr) -> bool:
    return any(isinstance(n, CellOf) for n in walk(node))


def uses_zones(node: Expr) -> bool:
    return any(isinstance(n, (InZone, ZoneData)) for n in walk(node))


def terminal_of(node: Expr) -> tuple[Expr, str, str, tuple]:
    """(value tree, kind, by, stats) with the terminal peeled: bare
    value trees default to a full-stats zones fold."""
    if isinstance(node, Zonal):
        return node.value, "zonal", node.by, node.stats
    if isinstance(node, Join):
        return node.value, "join", "zones", ()
    return node, "zonal", "zones", _STATS


def structure_key(node: Expr):
    """The canonical nested-tuple spelling of the tree — the structural
    identity programs are cached on and :func:`tree_hash` digests."""
    if isinstance(node, Band):
        return ("band", node.index)
    if isinstance(node, Const):
        return ("const", repr(node.value))
    if isinstance(node, (BinOp, Compare, BoolOp)):
        tag = {"BinOp": "bin", "Compare": "cmp", "BoolOp": "bool"}[
            type(node).__name__
        ]
        return (tag, node.op, structure_key(node.a), structure_key(node.b))
    if isinstance(node, Not):
        return ("not", structure_key(node.a))
    if isinstance(node, Where):
        return (
            "where", structure_key(node.cond),
            structure_key(node.a), structure_key(node.b),
        )
    if isinstance(node, MaskWhere):
        return (
            "mask_where", structure_key(node.value),
            structure_key(node.cond),
        )
    if isinstance(node, CellOf):
        return ("cell_of",)
    if isinstance(node, InZone):
        return ("in_zone",)
    if isinstance(node, OverlapArea):
        return ("overlap_area",)
    if isinstance(node, LeftArea):
        return ("left_area",)
    if isinstance(node, RightArea):
        return ("right_area",)
    if isinstance(node, ZoneData):
        return (
            "zone_data",
            tuple(repr(v) for v in node.values),
            repr(node.fill),
        )
    if isinstance(node, Zonal):
        return ("zonal", node.by, node.stats, structure_key(node.value))
    if isinstance(node, Join):
        return ("join", structure_key(node.value))
    raise TypeError(f"unknown expression node {type(node).__name__}")


def tree_hash(node: Expr) -> str:
    """Process-stable sha256 of the tree structure (``repr`` of floats
    round-trips f64 exactly) — the durable-scan snapshot fingerprint:
    a resume against a structurally different expression must refuse."""
    return hashlib.sha256(
        repr(structure_key(node)).encode()
    ).hexdigest()


# ----------------------------------------------------------- validation


def validate(
    node: Expr,
    num_bands: int,
    *,
    has_zones: bool = True,
    by: str = "zones",
) -> Expr:
    """Type/shape-check the tree against a raster: band indices in
    range, bool conditions, numeric arithmetic, zone nodes only where a
    vector side exists. Returns the node (for chaining); raises
    ``ValueError``/``TypeError`` with the offending node spelled out."""
    value, kind, term_by, stats = terminal_of(node)
    if kind == "zonal":
        if term_by not in ("zones", "grid"):
            raise ValueError(
                f"zonal(by={term_by!r}): expected 'zones' or 'grid'"
            )
        bad = [s for s in stats if s not in _STATS]
        if bad:
            raise ValueError(
                f"unknown zonal stats {bad} (have {list(_STATS)})"
            )
        by = term_by
    for n in walk(value):
        if isinstance(n, (Zonal, Join)):
            raise ValueError(
                f"{type(n).__name__} is a terminal — it may only appear "
                "at the root of the tree"
            )
        if isinstance(n, Band) and not 1 <= n.index <= num_bands:
            raise ValueError(
                f"Band({n.index}) out of range — raster has "
                f"{num_bands} band(s), indices are 1-based"
            )
        if isinstance(n, (BinOp, Compare)):
            for side in (n.a, n.b):
                if side.dtype() == "bool":
                    raise TypeError(
                        f"{type(n).__name__}({n.op!r}) needs numeric "
                        "operands; got a bool tree — compare or Where "
                        "it first"
                    )
        if isinstance(n, BoolOp):
            for side in (n.a, n.b):
                if side.dtype() != "bool":
                    raise TypeError(
                        f"BoolOp({n.op!r}) needs bool operands; got "
                        f"{side.dtype()!r}"
                    )
        if isinstance(n, Not) and n.a.dtype() != "bool":
            raise TypeError("~ needs a bool operand")
        if isinstance(n, Where) and n.cond.dtype() != "bool":
            raise TypeError("Where condition must be bool")
        if isinstance(n, MaskWhere) and n.cond.dtype() != "bool":
            raise TypeError("mask_where condition must be bool")
        if isinstance(n, (OverlapArea, LeftArea, RightArea)):
            raise ValueError(
                f"{type(n).__name__} is an overlay-pair leaf — it only "
                "appears in pair trees (sql.overlay.overlay_measures)"
            )
        if isinstance(n, (InZone, ZoneData)):
            if not has_zones:
                raise ValueError(
                    f"{type(n).__name__} needs a vector side — the "
                    "engine was built without a chip_index"
                )
            if by == "grid":
                raise ValueError(
                    f"{type(n).__name__} is zone-keyed — it cannot "
                    "appear under zonal(by='grid')"
                )
    if value.dtype() == "bool" and kind == "zonal":
        raise TypeError(
            "a zonal fold needs a numeric value tree (fold bools via "
            "Where(cond, 1.0, 0.0))"
        )
    return node


#: node families allowed in an overlay PAIR tree: the three pair leaves
#: plus pure per-pair scalar algebra — no raster/zone machinery
_PAIR_NODES = (
    Const, BinOp, Compare, BoolOp, Not, Where, MaskWhere,
    OverlapArea, LeftArea, RightArea,
)


def validate_pair(node: Expr) -> Expr:
    """Check a tree for the overlay pair lane: pair leaves plus scalar
    algebra only, no terminal, numeric root (the per-pair value the
    measures result carries). Returns the node for chaining."""
    for n in walk(node):
        if not isinstance(n, _PAIR_NODES):
            raise ValueError(
                f"{type(n).__name__} cannot appear in an overlay pair "
                "tree — allowed: Const/BinOp/Compare/BoolOp/Not/Where/"
                "MaskWhere over OverlapArea/LeftArea/RightArea"
            )
        if isinstance(n, (BinOp, Compare)):
            for side in (n.a, n.b):
                if side.dtype() == "bool":
                    raise TypeError(
                        f"{type(n).__name__}({n.op!r}) needs numeric "
                        "operands; got a bool tree"
                    )
    if node.dtype() == "bool":
        raise TypeError(
            "an overlay pair tree must produce a numeric per-pair value "
            "(wrap predicates in Where(cond, 1.0, 0.0))"
        )
    return node
