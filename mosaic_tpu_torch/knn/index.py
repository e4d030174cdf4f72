"""The resident KNN index: everything a serve frontend needs to answer
nearest-neighbour queries against a fixed candidate column.

Port of ``mosaic_tpu/knn/index.py``. Built once per candidate set:

- the candidate chips in a sorted-cell CSR (``cells``/``rows``), the
  structure the ring expansion probes with ``searchsorted``;
- the device geometry column ``dc`` (float64), recentred by a shift
  derived from the candidate column's bounds alone — for queries inside
  the candidate bounding box this is the shift
  `functions.geometry._pair_pack` derives in the batch model, which is
  what makes served distances equal batch `SpatialKNN` distances;
- a host f64 twin of the candidate column in the same shifted frame,
  the brute-force oracle's data;
- the candidate :class:`~mosaic_tpu_torch.sql.join.ChipIndex` (polygonal
  candidates only), whose build attached the Voronoi adjacency of its
  convex chip sites (``chip_index.voronoi``) that the frontend's convex
  lane walks.

What differs from the reference: ``device`` places ``dc`` and the chip index (the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from .. import resolve_device
from ..core.geometry.device import DeviceGeometry, pack_to_device
from ..core.index.base import IndexSystem
from ..core.tessellate import tessellate
from ..core.types import GeometryType, PackedGeometry
from ..core.geometry.affine import translate
from ..functions.geometry import DEVICE_DTYPE


@dataclasses.dataclass
class HostCandidates:
    """Host f64 twin of the device candidate column, shifted frame.

    Per candidate geometry: the real vertices, the type-aware boundary
    edges (closed rings for polygons, open runs for lines, none for
    points), and the closed polygon rings for the containment parity
    test — the three masked terms of `core/geometry/predicates.
    min_distance` / `crossing_number`.
    """

    verts: list  # g -> (V, 2) f64
    edges: list  # g -> ((E, 2), (E, 2)) f64 boundary edge endpoints
    poly_edges: list  # g -> ((E, 2), (E, 2)) closed polygon edges or None


@dataclasses.dataclass
class KNNIndex:
    """Resident candidate-side state for served KNN."""

    candidates: PackedGeometry
    index_system: IndexSystem
    resolution: int
    cells: np.ndarray  # (T,) int64 chip cells, sorted
    rows: np.ndarray  # (T,) int64 candidate row per chip, cell-sorted
    dc: DeviceGeometry  # shifted device candidate column (float64)
    shift: np.ndarray  # (2,) f64 recenter origin of dc and the twin
    cell_width: float  # guaranteed covered radius added per ring
    host: HostCandidates
    chip_index: object  # ChipIndex | None (non-polygonal candidates)
    fingerprint: str  # restart-stable identity of the index

    @property
    def n(self) -> int:
        return len(self.candidates)

    @property
    def device(self):
        return self.dc.verts.device

    @property
    def voronoi(self):
        """`sql.join.VoronoiTables` of the convex chip sites, or None
        (non-polygonal candidates)."""
        return getattr(self.chip_index, "voronoi", None)

    def to(self, device) -> "KNNIndex":
        """This index with its device parts (``dc``, the chip index) on
        ``device``; the host parts are shared."""
        dev = resolve_device(device)
        dc = DeviceGeometry(
            **{f.name: getattr(self.dc, f.name).to(dev)
               for f in dataclasses.fields(DeviceGeometry)}
        )
        chip = self.chip_index
        if chip is not None:
            chip = type(chip).from_arrays(chip.to_arrays(), device=dev)
        return dataclasses.replace(self, dc=dc, chip_index=chip)

    def candidate_rows(self, cells: np.ndarray) -> np.ndarray:
        """Distinct candidate rows whose chips land in ``cells`` (the
        batch model's searchsorted CSR probe)."""
        if not cells.size:
            return np.zeros(0, dtype=np.int64)
        lo = np.searchsorted(self.cells, cells, side="left")
        hi = np.searchsorted(self.cells, cells, side="right")
        out: set = set()
        for a, b in zip(lo, hi):
            out.update(self.rows[a:b].tolist())
        return np.fromiter(out, dtype=np.int64, count=len(out))


def _candidate_shift(cand: PackedGeometry) -> np.ndarray:
    """Midpoint of the candidate column's finite bounds — equals
    `_pair_pack(queries, cand)`'s union-bounds shift whenever the query
    bbox sits inside the candidate bbox."""
    bb = cand.bounds()
    finite = bb[np.isfinite(bb[:, 0])]
    if not finite.size:
        return np.zeros(2)
    lo = finite[:, :2].min(axis=0)
    hi = finite[:, 2:].max(axis=0)
    return (lo + hi) / 2.0


def _host_twin(cand: PackedGeometry, shift: np.ndarray) -> HostCandidates:
    verts, edges, poly_edges = [], [], []
    for g in range(len(cand)):
        base = cand.geometry_type(g).base
        polygonal = base == GeometryType.POLYGON
        linear = base == GeometryType.LINESTRING
        v_list, ea, eb, pa, pb = [], [], [], [], []
        for p in cand.geom_parts(g):
            for r in cand.part_rings(p):
                ring = cand.ring_xy(r) - shift  # open form, f64
                v_list.append(ring)
                if polygonal and ring.shape[0] >= 2:
                    closed = np.vstack([ring, ring[:1]])
                    ea.append(closed[:-1])
                    eb.append(closed[1:])
                    pa.append(closed[:-1])
                    pb.append(closed[1:])
                elif linear and ring.shape[0] >= 2:
                    ea.append(ring[:-1])
                    eb.append(ring[1:])
        verts.append(np.concatenate(v_list) if v_list else np.zeros((0, 2)))
        edges.append(
            (np.concatenate(ea), np.concatenate(eb))
            if ea
            else (np.zeros((0, 2)), np.zeros((0, 2)))
        )
        poly_edges.append(
            (np.concatenate(pa), np.concatenate(pb)) if pa else None
        )
    return HostCandidates(verts=verts, edges=edges, poly_edges=poly_edges)


def _fingerprint(cells, rows, shift, resolution, index_system) -> str:
    """The reference's identity string of an index (the same bytes
    hashed, so both packages name one index alike)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(cells).tobytes())
    h.update(np.ascontiguousarray(rows).tobytes())
    h.update(np.ascontiguousarray(shift).tobytes())
    h.update(str(int(resolution)).encode())
    h.update(type(index_system).__name__.encode())
    return "knn-" + h.hexdigest()[:32]


def _cell_width(index_system: IndexSystem, res: int) -> float:
    # conservative per-ring growth of the guaranteed-covered radius: one
    # ring adds at least the cell in-diameter ~ sqrt(area)/1.5
    return float(np.sqrt(index_system.cell_area_approx(res)) / 1.5)


def build_knn_index(
    candidates: PackedGeometry,
    index_system: "IndexSystem | None" = None,
    resolution: "int | None" = None,
    *,
    device=None,
) -> KNNIndex:
    """Tessellate + pack + twin the candidate column into a
    :class:`KNNIndex` a frontend can hold resident. Without a
    ``resolution`` the resolution analyzer picks one for the candidates
    (`sql/analyzer.py`), as the reference's does."""
    if index_system is None:
        from ..context import current_context

        index_system = current_context().index_system
    from ..functions._coerce import to_packed

    dev = resolve_device(device)
    cand = to_packed(candidates)
    if resolution is not None:
        res = index_system.resolution_arg(resolution)
    else:
        from ..sql.analyzer import MosaicAnalyzer

        res = MosaicAnalyzer(index_system).get_optimal_resolution(cand)

    table = tessellate(cand, index_system, res, keep_core_geoms=False)
    order = np.argsort(table.cell_id, kind="stable")
    cells = np.asarray(table.cell_id[order], dtype=np.int64)
    rows = table.geom_id[order].astype(np.int64)

    shift = np.asarray(_candidate_shift(cand), dtype=np.float64)
    dc = pack_to_device(
        translate(cand, -shift[0], -shift[1]), dtype=DEVICE_DTYPE, device=dev,
    )

    chip_index = None
    if all(
        cand.geometry_type(g).base == GeometryType.POLYGON
        for g in range(len(cand))
    ):
        from ..sql.join import build_chip_index

        chip_index = build_chip_index(table, device=dev)

    return KNNIndex(
        candidates=cand,
        index_system=index_system,
        resolution=res,
        cells=cells,
        rows=rows,
        dc=dc,
        shift=shift,
        cell_width=_cell_width(index_system, res),
        host=_host_twin(cand, shift),
        chip_index=chip_index,
        fingerprint=_fingerprint(cells, rows, shift, res, index_system),
    )
