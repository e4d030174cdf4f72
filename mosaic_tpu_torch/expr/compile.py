"""Lower expression trees into ONE fused program per dispatch signature.

Port of ``mosaic_tpu/expr/compile.py``. Reference analog: Spark's
whole-stage codegen collapsing a Catalyst expression pipeline into one
generated function — here the whole tree (band reads, arithmetic,
masking, grid/zone predicates, the terminal zonal fold) lowers into a
single closed function over torch tensors on one device, so a 3-op
"NDVI → cloud mask → zonal mean" pipeline is one program per tile
instead of N staged host→device round trips.

What a "program" is here: the reference jit-compiles the tree into one
XLA executable; the port has no tracer, so a program is a Python
closure over the tree's torch ops (a few dozen eager ops a tile, see
:func:`program_ops`), ending in the fold lane
`kernels/zonal.py zonal_fold_masked` — on the card that launches the
``zonal_seq_fold`` CUDA kernel in f64. Nothing is compiled per shape:
the only build in the port is nvcc's, once per machine.

Programs live in the dispatch core's named-cache registry
(:func:`mosaic_tpu_torch.dispatch.core.bounded_cache`, cache name
``expr_programs``) keyed on the tree ITSELF plus the bucket — nodes are
frozen dataclasses with structural equality, so two independently-built
but equal trees share one program. The public execution signature
(:func:`signature_of`) is ``(tree-structure-hash, bucket, index,
mesh)``: the first execution of a signature opens a ``dispatch.compile``
span (site=``expr``) carrying the ``backend_compiles()`` delta (nvcc
builds, 0 once the kernels are built), and after :func:`freeze` a novel
signature trips the cold-compile counter plus an ``expr_compile``
telemetry event, mirroring ``DispatchCore``'s tripwire.

Type promotion follows jnp's over strongly typed operands, not torch's:
a ``Const`` is an f64 scalar, and an int64 ``CellOf`` or a bool
``Compare``/``InZone`` meeting it is cast explicitly (torch would promote
an int64 tensor with a 0-dim f64 tensor to float32); an integer ``/`` is
a true divide in f64. Every float op is one elementwise torch op in the
reference's order, so on the CPU a program's f64 results are the numpy
oracle's bits (`expr/host_oracle.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dispatch import core as _dispatch
from ..dispatch.bucket import backend_compiles, mesh_key
from ..kernels.zonal import zonal_fold_masked
from ..obs import trace as _trace
from ..raster.tiles import assign_tile_cells
from ..runtime import telemetry as _telemetry
from . import ast

__all__ = [
    "PairCtx",
    "cold_compiles",
    "freeze",
    "overlay_program",
    "overlay_signature_of",
    "pixel_program",
    "program_ops",
    "run_pixels",
    "run_tracked",
    "run_zonal",
    "run_zonal_async",
    "signature_of",
    "signatures",
    "warmup_zonal",
    "zonal_program",
]


# ------------------------------------------------------------- lowering

_BIN = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "min": torch.minimum,
    "max": torch.maximum,
}
_CMP = {
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
    "eq": torch.eq,
    "ne": torch.ne,
}


def _common(a: torch.Tensor, b: torch.Tensor):
    """Both operands cast to jnp's result type of strongly typed operands
    over the tree's dtypes: any float → f64, else any int → int64, else
    bool."""
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        dt = torch.float64
    elif a.dtype == torch.bool and b.dtype == torch.bool:
        dt = torch.bool
    else:
        dt = torch.int64
    return a.to(dt), b.to(dt)


def _apply(node, av, bv):
    """One BinOp/Compare over promoted operands (integer ``/`` in f64)."""
    av, bv = _common(av, bv)
    if isinstance(node, ast.Compare):
        return _CMP[node.op](av, bv)
    if node.op == "div" and not av.dtype.is_floating_point:
        av, bv = av.to(torch.float64), bv.to(torch.float64)
    return _BIN[node.op](av, bv)


def _const(value, device) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float64, device=device)


class _Ctx:
    """Per-call lowering context: band rows of the (B, P) tile stack,
    lazily-computed cell ids, and the zone segment vector."""

    def __init__(self, vals, mask, gt, origin, th, tw, rows,
                 index_system, resolution, seg):
        self.vals = vals
        self.mask = mask
        self.gt = gt
        self.origin = origin
        self.th = th
        self.tw = tw
        self.rows = rows  # band index (1-based) -> stack row
        self.index_system = index_system
        self.resolution = resolution
        self.seg = seg
        self.device = vals.device
        self._cells = None

    def cells(self):
        if self._cells is None:
            self._cells = assign_tile_cells(
                self.gt, self.origin, (self.th, self.tw),
                self.index_system, self.resolution, device=self.device,
            ).reshape(-1)
        return self._cells


def _lower(node: ast.Expr, ctx: _Ctx):
    """→ (value, valid) tensors, implementing the mask-propagation rule
    documented in `expr.ast` — the f64 host oracle mirrors this function
    shape for shape."""
    true = torch.ones((), dtype=torch.bool, device=ctx.device)
    if isinstance(node, ast.Band):
        r = ctx.rows[node.index]
        return ctx.vals[r], ctx.mask[r]
    if isinstance(node, ast.Const):
        return _const(node.value, ctx.device), true
    if isinstance(node, (ast.BinOp, ast.Compare)):
        av, am = _lower(node.a, ctx)
        bv, bm = _lower(node.b, ctx)
        return _apply(node, av, bv), am & bm
    if isinstance(node, ast.BoolOp):
        av, am = _lower(node.a, ctx)
        bv, bm = _lower(node.b, ctx)
        return (av & bv) if node.op == "and" else (av | bv), am & bm
    if isinstance(node, ast.Not):
        av, am = _lower(node.a, ctx)
        return ~av, am
    if isinstance(node, ast.Where):
        cv, cm = _lower(node.cond, ctx)
        av, am = _lower(node.a, ctx)
        bv, bm = _lower(node.b, ctx)
        av, bv = _common(av, bv)
        return torch.where(cv, av, bv), cm & torch.where(cv, am, bm)
    if isinstance(node, ast.MaskWhere):
        vv, vm = _lower(node.value, ctx)
        cv, cm = _lower(node.cond, ctx)
        return vv, vm & cm & cv
    if isinstance(node, ast.CellOf):
        return ctx.cells(), true
    if isinstance(node, ast.InZone):
        return ctx.seg >= 0, true
    if isinstance(node, ast.ZoneData):
        table = torch.as_tensor(
            np.asarray(node.values, np.float64), device=ctx.device
        )
        inside = ctx.seg >= 0
        idx = torch.where(inside, ctx.seg, 0).long()
        return torch.where(
            inside, table[idx], _const(node.fill, ctx.device)
        ), true
    raise TypeError(
        f"cannot lower {type(node).__name__} — terminals are peeled by "
        "eval before lowering"
    )


def _band_rows(value: ast.Expr) -> dict:
    """Band index (1-based) → row of the (B, P) stack, rows sorted by
    band index — the layout `eval` stacks and both programs consume."""
    return {b: r for r, b in enumerate(ast.bands_of(value))}


class PairCtx:
    """Lowering context for overlay PAIR trees: per-unique-pair (S,)
    tables — the folded intersection area and the two geometry total
    areas. Shared shape with `expr.host_oracle.interpret_pair`."""

    def __init__(self, area, larea, rarea):
        self.area = area
        self.larea = larea
        self.rarea = rarea


def _lower_pair(node: ast.Expr, ctx: PairCtx):
    """→ (value, valid) tensors over the per-pair tables — the pair-tree
    twin of :func:`_lower`, with the same operator maps so the f64 host
    oracle (`interpret_pair`) mirrors it op for op."""
    dev = ctx.area.device
    true = torch.ones((), dtype=torch.bool, device=dev)
    if isinstance(node, ast.Const):
        return _const(node.value, dev), true
    if isinstance(node, ast.OverlapArea):
        return ctx.area, true
    if isinstance(node, ast.LeftArea):
        return ctx.larea, true
    if isinstance(node, ast.RightArea):
        return ctx.rarea, true
    if isinstance(node, (ast.BinOp, ast.Compare)):
        av, am = _lower_pair(node.a, ctx)
        bv, bm = _lower_pair(node.b, ctx)
        return _apply(node, av, bv), am & bm
    if isinstance(node, ast.BoolOp):
        av, am = _lower_pair(node.a, ctx)
        bv, bm = _lower_pair(node.b, ctx)
        return (av & bv) if node.op == "and" else (av | bv), am & bm
    if isinstance(node, ast.Not):
        av, am = _lower_pair(node.a, ctx)
        return ~av, am
    if isinstance(node, ast.Where):
        cv, cm = _lower_pair(node.cond, ctx)
        av, am = _lower_pair(node.a, ctx)
        bv, bm = _lower_pair(node.b, ctx)
        av, bv = _common(av, bv)
        return torch.where(cv, av, bv), cm & torch.where(cv, am, bm)
    if isinstance(node, ast.MaskWhere):
        vv, vm = _lower_pair(node.value, ctx)
        cv, cm = _lower_pair(node.cond, ctx)
        return vv, vm & cm & cv
    raise TypeError(
        f"cannot lower {type(node).__name__} in an overlay pair tree"
    )


# ------------------------------------------------------------- programs

_ACC = {"float64": torch.float64, "float32": torch.float32}


@_dispatch.bounded_cache("expr_programs", 64)
def zonal_program(
    value: ast.Expr, th: int, tw: int, num_segments: int,
    acc_name: str, index_system, resolution: int,
):
    """The fused program: ``(gt, origin, vals (B, P), mask (B, P),
    seg (P,)) → ((S,) count, sum, min, max)`` on the tensors' device.
    One call reads raw bands and emits per-segment stats — the per-pixel
    expression is fused INTO the segment-reduced fold. Cached on the tree
    itself (structural equality), so equal trees share one entry."""
    rows = _band_rows(value)
    acc_dt = _ACC[acc_name]
    p = th * tw

    def fused(gt, origin, vals, mask, seg):
        ctx = _Ctx(vals, mask, gt, origin, th, tw, rows,
                   index_system, resolution, seg)
        v, m = _lower(value, ctx)
        v = torch.broadcast_to(v, (p,)).to(acc_dt)
        m = torch.broadcast_to(m, (p,))
        return zonal_fold_masked(
            v, m, seg, num_segments, acc_dtype=acc_dt
        )

    return fused


@_dispatch.bounded_cache("expr_pixel_programs", 64)
def pixel_program(
    value: ast.Expr, th: int, tw: int, index_system, resolution,
):
    """Per-pixel program for map_pixels/join values: ``(gt, origin,
    vals, mask, seg) → ((P,) value, (P,) valid)`` — no fold; callers
    without a vector side pass an all ``-1`` segment vector (zone nodes
    are rejected by validation there)."""
    rows = _band_rows(value)
    p = th * tw

    def pixels(gt, origin, vals, mask, seg):
        ctx = _Ctx(vals, mask, gt, origin, th, tw, rows,
                   index_system, resolution, seg)
        v, m = _lower(value, ctx)
        return (
            torch.broadcast_to(v, (p,)).to(torch.float64),
            torch.broadcast_to(m, (p,)),
        )

    return pixels


@_dispatch.bounded_cache("overlay_programs", 64)
def overlay_program(
    value: ast.Expr, Lb: int, Rb: int, Pb: int, Sb: int, vpad: int,
    acc_name: str, mesh=None,
):
    """The fused overlay measure program: gather candidate chip pairs
    from the two sorted side tables, compute per-pair intersection areas
    (kind routing + convex clip, `kernels.overlay.pair_areas`), fold
    them into per-geometry-pair totals (`zonal_fold_masked`: on the card
    the ``zonal_seq_fold`` kernel), and evaluate the pair tree over the
    folded tables — one program per ``(tree, buckets, mesh)`` signature.
    Under ``mesh`` the per-pair stage runs data parallel over the pair
    axis (side tables replicated, candidates sharded), and its outputs
    are gathered back in shard order BEFORE the f64 fold: the segment sum
    is never split into per-shard partials (a different accumulation
    order, 1 ulp of drift), so a sharded run equals the single-device
    one bit for bit."""
    acc_dt = _ACC[acc_name]
    from ..kernels import overlay as _ko

    def per_pair(li, ri, lcore, lok, lverts, lvlen, larea, lcell,
                 rcore, rok, rverts, rvlen, rarea, band):
        li = li.long()
        ri = ri.long()
        return _ko.pair_areas(
            lcore[li], rcore[ri], lok[li], rok[ri],
            lverts[li], lvlen[li], rverts[ri], rvlen[ri],
            larea[li], rarea[ri], lcell[li], band, xp=torch,
        )

    def sharded(li, ri, *tables):
        from ..parallel import mesh as _mesh

        return _mesh.run_sharded(
            per_pair, mesh, sharded=(li, ri), replicated=tables,
        )

    stage = per_pair if mesh is None else sharded

    def fused(li, ri, valid, seg, lcore, lok, lverts, lvlen, larea,
              lcell, rcore, rok, rverts, rvlen, rarea, seg_larea,
              seg_rarea, band):
        area, host_needed = stage(
            li, ri, lcore, lok, lverts, lvlen, larea, lcell,
            rcore, rok, rverts, rvlen, rarea, band,
        )
        cnt, s, _mn, _mx = zonal_fold_masked(
            area, valid, seg, Sb, acc_dtype=acc_dt
        )
        val, vok = _lower_pair(value, PairCtx(s, seg_larea, seg_rarea))
        return (
            torch.broadcast_to(val, (Sb,)).to(torch.float64),
            torch.broadcast_to(vok, (Sb,)),
            s, cnt, host_needed,
        )

    return fused


def overlay_signature_of(
    value: ast.Expr, Lb: int, Rb: int, Pb: int, Sb: int, vpad: int,
    acc_name: str, index_system, resolution, mesh=None,
) -> tuple:
    """The dispatch signature an overlay measure execution is tracked
    under: ``(tree-hash, buckets, index, mesh)`` — the overlay twin of
    :func:`signature_of`."""
    return (
        "overlay:" + ast.tree_hash(value)[:16],
        (int(Lb), int(Rb), int(Pb), int(Sb), int(vpad), str(acc_name)),
        (type(index_system).__name__, int(resolution)),
        mesh_key(mesh),
    )


def program_ops(fn, *args) -> int:
    """Device ops one call of a program issues: the count of torch
    operator calls a :class:`torch.utils._python_dispatch.TorchDispatchMode`
    sees (the eager ops a fused program is made of; a kernel launched
    through ctypes is not one of them)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            _Count.n += 1
            return func(*args, **(kwargs or {}))

    with _Count():
        fn(*args)
    return _Count.n


# ------------------------------------- signature tracking (the tripwire)

_signatures: set = set()
_frozen: "frozenset | None" = None
_cold_compiles = 0


def signature_of(
    value: ast.Expr, th: int, tw: int, num_segments: int,
    acc_name: str, index_system, resolution, mesh=None,
) -> tuple:
    """The dispatch signature a fused execution is tracked under:
    ``(tree-structure-hash, bucket, index, mesh)``."""
    return (
        ast.tree_hash(value)[:16],
        (int(th), int(tw), int(num_segments), str(acc_name)),
        (type(index_system).__name__, int(resolution)),
        mesh_key(mesh),
    )


def signatures() -> "frozenset":
    return frozenset(_signatures)


def freeze() -> "frozenset":
    """Snapshot the signature set after warmup — a NEW signature
    executing later is a cold compile in production, counted and
    telemetered (`DispatchCore.freeze` discipline)."""
    global _frozen
    _frozen = frozenset(_signatures)
    return _frozen


def cold_compiles() -> int:
    return _cold_compiles


def _reset_for_tests():
    global _frozen, _cold_compiles
    _signatures.clear()
    _frozen = None
    _cold_compiles = 0


def _track(sig: tuple):
    """First sight of ``sig`` → open a ``dispatch.compile`` span
    (site=expr) so timeline attribution books the first run as
    *compile*; post-freeze novelty additionally trips the cold counter.
    Returns (span, compiles_before) — (None, None) for warm signatures."""
    global _cold_compiles
    if sig in _signatures:
        return None, None
    _signatures.add(sig)
    if _frozen is not None and sig not in _frozen:
        _cold_compiles += 1
        _telemetry.record(
            "expr_compile", signature=repr(sig), after_freeze=True,
            cold_compiles=_cold_compiles,
        )
    c0 = backend_compiles()
    span = _trace.start_span(
        "dispatch.compile", site="expr", signature=repr(sig)
    )
    return span, c0


def _untrack(span, c0):
    if span is None:
        return
    c1 = backend_compiles()
    if c0 is not None and c1 is not None:
        span.set(backend_compiles=c1 - c0)
    span.end()


def run_tracked(sig: tuple, fn, *args):
    """Execute any program under expr signature tracking — the public
    wrapper overlay dispatch uses so its first runs land in the same
    `dispatch.compile` span / post-freeze tripwire as the raster
    programs."""
    span, c0 = _track(sig)
    try:
        return fn(*args)
    finally:
        _untrack(span, c0)


def _on(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=dtype
    )


def run_zonal_async(prog, sig: tuple, gt, origin, vals, mask, seg, *,
                    device):
    """Execute a fused program under signature tracking on ``device``,
    returning the four partials as DEVICE tensors (not synchronized —
    the caller owns the pull). ``gt``/``origin`` stay host arrays (the
    cell path reads them as numbers); the stack and segments are copied
    to the device."""
    span, c0 = _track(sig)
    try:
        return prog(
            np.asarray(gt, np.float64), np.asarray(origin),
            _on(vals, device, torch.float64), _on(mask, device, torch.bool),
            _on(seg, device, torch.int32),
        )
    finally:
        _untrack(span, c0)


def run_zonal(prog, sig: tuple, gt, origin, vals, mask, seg, *, device):
    """:func:`run_zonal_async`, then the blocking pull of the four
    partials as numpy arrays."""
    parts = run_zonal_async(prog, sig, gt, origin, vals, mask, seg,
                            device=device)
    return tuple(p.cpu().numpy() for p in parts)


def run_pixels(prog, sig: tuple, gt, origin, vals, mask, seg, *, device):
    """Execute a per-pixel program under the same signature tracking."""
    span, c0 = _track(sig)
    try:
        v, m = prog(
            np.asarray(gt, np.float64), np.asarray(origin),
            _on(vals, device, torch.float64), _on(mask, device, torch.bool),
            _on(seg, device, torch.int32),
        )
        return v.cpu().numpy(), m.cpu().numpy()
    finally:
        _untrack(span, c0)


def warmup_zonal(
    value: ast.Expr, th: int, tw: int, num_segments: int,
    acc_name: str, index_system, resolution, mesh=None, *, device,
) -> tuple:
    """Run one fused signature once on a zero tile (every pixel folds
    nowhere) on ``device``, so it is registered for :func:`freeze` and
    the kernel library is bound. Returns the signature."""
    prog = zonal_program(
        value, int(th), int(tw), int(num_segments), acc_name,
        index_system, int(resolution),
    )
    sig = signature_of(
        value, th, tw, num_segments, acc_name, index_system,
        resolution, mesh,
    )
    b = len(ast.bands_of(value))
    p = int(th) * int(tw)
    run_zonal(
        prog, sig,
        np.zeros(6, np.float64), np.zeros(2, np.int32),
        np.zeros((b, p), np.float64), np.zeros((b, p), bool),
        np.full(p, -1, np.int32), device=device,
    )
    return sig
