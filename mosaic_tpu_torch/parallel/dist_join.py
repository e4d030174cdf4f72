"""Mesh-sharded point-in-polygon join with an all-gathered chip index.

Port of ``mosaic_tpu/parallel/dist_join.py``. The data stay resident:

- the **point side** is sharded over *every* device of the mesh and
  never moves;
- the **chip index** (`sql.join.build_chip_index`) is sharded over the
  ``cell`` mesh axis, and each device all-gathers the probe's leaves of
  its ``cell`` group inside the step, so it holds the full probe tables
  only while it probes;
- the per-zone counts (the Quickstart's group-by count) are summed over
  every shard.

What differs from the reference, and why: the mesh is the port's
single-controller `parallel.mesh.Mesh`, the step a Python function that
runs the shards one after another in device order (launches on
different cards overlap; a logical mesh runs them on one device), the
gather a concatenation in shard order and the sum an int64 sum in shard
order, so both are exact and the sharded answer equals the single-device
one bit for bit. Past the retry budget only a join on the CPU degrades
to the f64 host oracle (`DegradedResult`); on the card
`dist_pip_join` raises `RetryExhausted`, as `pip_join` does.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .. import resolve_device
from ..core.geometry.device import DeviceGeometry
from ..dispatch import core as _dispatch
from ..runtime import faults as _faults, telemetry as _telemetry
from ..runtime.errors import DegradedResult, RetryExhausted
from ..runtime.escalate import run_escalating
from ..sql.join import (
    OVERFLOW,
    ChipIndex,
    HostRecheck,
    host_join_with_cells,
    pip_join_points,
    resolve_probe_mode,
)
from . import mesh as _mesh
from .mesh import Mesh

__all__ = [
    "dist_pip_join",
    "distributed_join_step",
    "index_nbytes",
    "make_mesh",
    "pad_index_for_shards",
    "pad_points",
]

_I64_MAX = int(np.iinfo(np.int64).max)

#: the probe's leaves, all-gathered inside the step (the hash table only
#: when it is sharded); the other per-cell and per-chip leaves stay
#: sharded, as the probe never reads them
_TABLE = ("table_cell", "table_slot", "table_pack")
_GATHERED = (
    "cell_edges", "cell_ebits", "cell_slot_geom", "cell_slot_core",
    "cell_heavy", "cell_convex",
)


def make_mesh(
    n_devices: int | None = None,
    devices=None,
    cell_axis: int | None = None,
    slices: int | None = None,
    device=None,
) -> Mesh:
    """A ``(dp, cell)`` mesh — or ``(dcn, dp, cell)`` with ``slices`` set —
    over the first ``n_devices`` of ``devices`` (default: the platform's
    real devices of ``device``'s kind, the card unless ``device="cpu"``).

    Every axis shards the point axis; ``cell`` also shards the chip index
    (all-gathered inside the step). ``slices`` models multi-slice
    topologies: the outer ``dcn`` axis spans slices, so the only traffic
    between slices is the final sum of the per-zone counts. A logical
    mesh repeats a device in ``devices``.
    """
    if devices is None:
        devs = _mesh.platform_devices(resolve_device(device).type)
    else:
        devs = list(devices)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} available"
            )
        devs = devs[:n_devices]
    n = len(devs)
    if cell_axis is None:
        cell_axis = 2 if n % 2 == 0 and n > 1 else 1
    if n % cell_axis:
        raise ValueError(f"{n} devices not divisible by cell_axis={cell_axis}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    if slices is not None:
        rest = n // cell_axis
        if rest % slices:
            raise ValueError(
                f"{rest} dp-devices not divisible by slices={slices}"
            )
        return Mesh(
            grid.reshape(slices, rest // slices, cell_axis), ("dcn", "dp", "cell")
        )
    return Mesh(grid.reshape(n // cell_axis, cell_axis), ("dp", "cell"))


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _pad0(x: torch.Tensor, n: int, value=0) -> torch.Tensor:
    if not n:
        return x
    pad = torch.full((n, *x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def pad_index_for_shards(index: ChipIndex, shards: int) -> ChipIndex:
    """Pad the U (cells) and C (chips) axes to multiples of ``shards``.

    Pad cells are ``int64`` max, so the sorted-cells invariant the probe
    relies on survives; pad chip rows have zero rings, so the crossing
    test can never report them. The hash table (T a power of two), the
    heavy and the convex tables keep their shapes: they stay replicated,
    or shard whole when the shard count divides T. The host companion and
    the Voronoi tables carry over.
    """
    U = int(index.cells.shape[0])
    C = int(index.chip_geom.shape[0])
    du = _round_up(U, shards) - U
    dc = _round_up(C, shards) - C
    if not du and not dc:
        return index
    b = index.border
    out = dataclasses.replace(
        index,
        cells=_pad0(index.cells, du, _I64_MAX),
        chip_rows=_pad0(index.chip_rows, du, -1),
        chip_geom=_pad0(index.chip_geom, dc),
        chip_core=_pad0(index.chip_core, dc),
        border=DeviceGeometry(
            verts=_pad0(b.verts, dc),
            ring_len=_pad0(b.ring_len, dc),
            ring_is_hole=_pad0(b.ring_is_hole, dc),
            n_rings=_pad0(b.n_rings, dc),
            geom_type=_pad0(b.geom_type, dc),
            shift=b.shift,
        ),
        # table_slot values index the U axis, which only grew at its end
        cell_edges=_pad0(index.cell_edges, du),
        cell_ebits=_pad0(index.cell_ebits, du),
        cell_slot_geom=_pad0(index.cell_slot_geom, du, -1),
        cell_slot_core=_pad0(index.cell_slot_core, du),
        cell_heavy=_pad0(index.cell_heavy, du, -1),
        cell_convex=_pad0(index.cell_convex, du, -1),
    )
    out.host = getattr(index, "host", None)
    return out


def _index_specs(table_sharded: bool) -> dict:
    """The per-leaf layout of a sharded index: ``True`` where a leaf
    shards over ``cell`` (``border.<field>`` for the border column, whose
    shift stays replicated), ``False`` where it is replicated. The hash
    table shards only when the cell-shard count divides T."""
    specs = {f: True for f in ChipIndex.field_names()}
    for f in ("hash_mult", "pack_low", "heavy_edges", "heavy_ebits",
              "heavy_slot_geom", "convex_edges", "convex_ebits",
              "convex_geom", "convex_ybin"):
        specs[f] = False
    for f in _TABLE:
        specs[f] = table_sharded
    for f in ChipIndex._BORDER:
        specs[f"border.{f}"] = f != "shift"
    return specs


def _shard_index(index: ChipIndex, mesh: Mesh, table_sharded: bool) -> list:
    """One ChipIndex a device of ``mesh``, in shard order: the sharded
    leaves cut over ``cell`` onto their devices, the replicated ones
    placed once a distinct device."""
    specs = _index_specs(table_sharded)

    def leaves(get, names, prefix=""):
        out = {}
        for n in names:
            x = get(n)
            if specs[prefix + n]:
                out[n] = _mesh.shard(x, mesh, "cell")
            else:
                placed = _mesh.replicas(x, mesh)
                out[n] = [placed[str(d)] for d in mesh.device_list]
        return out

    top = leaves(lambda n: getattr(index, n), ChipIndex.field_names())
    bor = leaves(lambda n: getattr(index.border, n), ChipIndex._BORDER, "border.")
    return [
        dataclasses.replace(
            index,
            border=DeviceGeometry(**{n: v[i] for n, v in bor.items()}),
            **{n: v[i] for n, v in top.items()},
        )
        for i in range(mesh.size)
    ]


def _cell_groups(mesh: Mesh) -> list:
    """For each device in shard order, the shard indices of its ``cell``
    group (the devices that differ from it only along ``cell``), in
    ``cell`` order: the shards its all-gather concatenates."""
    pos = mesh.axis_names.index("cell")
    shape = mesh.devices.shape
    flat = np.arange(mesh.size).reshape(shape)
    out = []
    for coords in np.ndindex(*shape):
        sl = list(coords)
        sl[pos] = slice(None)
        out.append([int(k) for k in flat[tuple(sl)]])
    return out


def _gather_index(shards: list, i: int, group: list, dev, table_sharded: bool) -> ChipIndex:
    """Shard ``i``'s index with the probe's leaves of its ``group``
    all-gathered on ``dev``. Leading-axis shards were contiguous, so the
    tiled gather gives the arrays in their original row order and
    ``table_slot`` entries stay valid. The per-chip leaves the probe does
    not read (cells, chip_rows, chip_geom, chip_core, border) stay
    sharded."""
    own = shards[i]
    names = list(_GATHERED)
    if table_sharded:
        names += [n for n in _TABLE if n != "table_pack" or own.table_pack.shape[0]]
    return dataclasses.replace(own, **{
        n: _mesh.all_gather([getattr(shards[k], n) for k in group], dev)
        for n in names
    })


def index_nbytes(index: ChipIndex) -> int:
    """Bytes of every tensor of a ChipIndex (its border included)."""
    n = sum(getattr(index, f).nbytes for f in ChipIndex.field_names())
    return n + sum(getattr(index.border, f).nbytes for f in ChipIndex._BORDER)


def distributed_join_step(
    mesh: Mesh,
    num_zones: int,
    table_size: int | None = None,
    found_cap: int | None = None,
    heavy_cap: int | None = None,
    probe: str = "scatter",
    convex_cap: int | None = None,
):
    """The full distributed join and aggregate step for ``mesh``.

    Returns ``step(points, pcells, index) -> (match, zone_counts)`` where

    - ``points``  (N, 2) shift-applied coordinates in the index's dtype,
      N divisible by the mesh size — sharded over every axis;
    - ``pcells``  (N,) int64 cell ids, sharded the same way;
    - ``index``   a `pad_index_for_shards(ix, mesh.shape['cell'])` chip
      index — its leading axes shard over ``cell``;
    - ``table_size``  T = ``index.table_cell.shape[0]``; the hash table
      shards over ``cell`` (and is all-gathered in the step) only when
      the shard count divides T — otherwise it stays replicated, which is
      always correct (None forces replication);
    - ``match``   (N,) int32 matched polygon row (-1 none), on the mesh's
      first device;
    - ``zone_counts`` (num_zones,) int64, summed over every shard;
    - ``found_cap``/``heavy_cap``/``convex_cap``  optional PER-SHARD
      compaction caps of `pip_join_points` (None is exact);
    - ``probe``  the per-cell routing mode (resolve it with
      `resolve_probe_mode` first; `dist_pip_join` does). Under
      ``"adaptive"`` on the card each shard launches ``pip_heavy_tiled``.

    Each step records a ``dist_join_layout`` event: the index bytes a
    device holds sharded and after its gather.
    """
    cell_shards = int(mesh.shape["cell"])
    table_sharded = (
        table_size is not None and cell_shards > 1 and table_size % cell_shards == 0
    )
    groups = _cell_groups(mesh)

    def step(points, pcells, index):
        shards = _shard_index(index, mesh, table_sharded)
        pp = _mesh.shard(points, mesh)
        cc = _mesh.shard(pcells, mesh)
        matches, counts = [], []
        gathered_bytes = 0
        for i, dev in enumerate(mesh.device_list):
            with _mesh.device_scope(dev):
                full = _gather_index(shards, i, groups[i], dev, table_sharded)
                if not i:
                    gathered_bytes = index_nbytes(full)
                match = pip_join_points(
                    pp[i], cc[i], full, heavy_cap=heavy_cap,
                    found_cap=found_cap, probe=probe, convex_cap=convex_cap,
                )
                del full
                zone = torch.where(match >= 0, match, num_zones).to(torch.int64)
                counts.append(
                    torch.bincount(zone, minlength=num_zones + 1)[:num_zones]
                )
                matches.append(match)
        _telemetry.record(
            "dist_join_layout", devices=mesh.size, cell_shards=cell_shards,
            table_sharded=table_sharded, shard_bytes=index_nbytes(shards[0]),
            gathered_bytes=gathered_bytes,
        )
        return _mesh.all_gather(matches, mesh.first), _mesh.psum(counts, mesh.first)

    return step


def pad_points(points: np.ndarray, cells: np.ndarray, multiple: int):
    """Pad the point axis to ``multiple`` with never-matching sentinels
    (cell -1)."""
    n = points.shape[0]
    d = _round_up(n, multiple) - n
    if not d:
        return points, cells
    return (
        np.pad(points, ((0, d), (0, 0))),
        np.pad(cells, (0, d), constant_values=-1),
    )


@_dispatch.bounded_cache("dist_join_step", 32)
def _cached_step(
    mesh, num_zones, table_size, found_cap, heavy_cap,
    probe="scatter", convex_cap=None,
):
    """One step per (mesh, zones, layout, caps, probe): escalation
    re-enters here with grown caps. Registered in the dispatch cache
    registry (`dispatch.cache_stats()["dist_join_step"]`)."""
    return distributed_join_step(
        mesh, num_zones, table_size=table_size,
        found_cap=found_cap, heavy_cap=heavy_cap,
        probe=probe, convex_cap=convex_cap,
    )


def dist_pip_join(
    points: np.ndarray,
    pcells: np.ndarray,
    index: ChipIndex,
    mesh: Mesh,
    num_zones: int,
    *,
    table_size: int | None = None,
    found_cap: int | None = None,
    heavy_cap: int | None = None,
    probe: str = "scatter",
    convex_cap: int | None = None,
    host: HostRecheck | None = None,
):
    """Managed distributed join: the resilience-wrapped spelling of
    `distributed_join_step`.

    Takes RAW (unshifted) f64 ``points`` and their cell ids; owns the
    recentring shift, the shard padding and the failure story:

    - OVERFLOW rows (caps shrunk by `runtime.faults`, or explicit
      per-shard caps undersized) trigger the bounded escalation engine —
      caps regrow until the match column is exact, else typed
      ``CapacityOverflow``;
    - transient device failures retry with backoff under the
      ``dist_join.step`` watchdog site; past the budget a join on the CPU
      degrades to the exact f64 host oracle (``host`` defaults to the
      index's companion) and the match column comes back flagged
      :class:`DegradedResult`; a join on the card raises
      :class:`RetryExhausted`.

    Returns ``(match, zone_counts)``: (N,) int32 matched row per point
    and the (num_zones,) int64 per-zone histogram. The index and the mesh
    must be on one kind of device.
    """
    if mesh.type != index.device.type:
        raise ValueError(
            f"the index lives on {index.device}, the mesh on {mesh.type} "
            "devices"
        )
    probe = resolve_probe_mode(probe)
    host = host if host is not None else getattr(index, "host", None)
    raw = np.asarray(points, dtype=np.float64)
    pc = np.asarray(pcells, dtype=np.int64)
    n = raw.shape[0]
    shift = (
        host.shift if host is not None
        else index.border.shift.cpu().numpy()
    )
    dtype = np.dtype(str(index.border.verts.dtype).removeprefix("torch."))
    padded_index = pad_index_for_shards(index, int(mesh.shape["cell"]))
    p, c = pad_points((raw - shift).astype(dtype), pc, mesh.size)
    per_shard = p.shape[0] // mesh.size
    if convex_cap is None and probe != "scatter" and index.num_convex_cells:
        convex_cap = per_shard
    caps = _faults.clamp_caps(
        {
            "found_cap": found_cap,
            "heavy_cap": heavy_cap,
            "convex_cap": convex_cap if probe != "scatter" else None,
        }
    )
    grow = {k: v for k, v in caps.items() if v is not None}
    ceilings = {k: per_shard for k in grow}
    pj = torch.from_numpy(np.ascontiguousarray(p)).to(mesh.first)
    cj = torch.from_numpy(np.ascontiguousarray(c)).to(mesh.first)

    def attempt(capset):
        # fault plans for "dist_join.step" trip inside guarded_call's
        # watchdog; the copies back end the attempt, so its deadline
        # covers the device work
        step = _cached_step(
            mesh, num_zones, table_size,
            capset.get("found_cap"), capset.get("heavy_cap"),
            probe, capset.get("convex_cap"),
        )
        match, counts = step(pj, cj, padded_index)
        return match.cpu().numpy()[:n], counts.cpu().numpy()

    try:
        (match, counts), _ = run_escalating(
            lambda cc: _dispatch.guarded_call("dist_join.step", attempt, cc),
            grow, ceilings,
            overflow_count=lambda r: int((r[0] == OVERFLOW).sum()),
            stage="dist_pip_join",
        )
        return match, counts
    except RetryExhausted as e:
        if host is None or mesh.type != "cpu":
            raise
        _telemetry.record(
            "degraded", label="dist_pip_join", attempts=e.attempts,
            error=repr(e.last)[:200],
        )
        logging.getLogger("mosaic_tpu_torch.runtime").warning(
            "dist_pip_join: device path failed %d times (%r); answering "
            "from the f64 host oracle", e.attempts, e.last,
        )
        hmatch = host_join_with_cells(raw, pc, host)
        hcounts = np.bincount(
            hmatch[hmatch >= 0], minlength=num_zones
        )[:num_zones].astype(np.int64)
        return (
            DegradedResult.wrap(
                hmatch,
                reason=f"dist_pip_join retries exhausted ({e.last!r})"[:300],
                attempts=e.attempts,
            ),
            hcounts,
        )
