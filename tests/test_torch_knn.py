"""KNN in the port (`mosaic_tpu_torch/knn`, `models/knn.py` and what they
stand on), held against the JAX package on the CPU.

The same seeded numpy inputs go through both packages; everything is
compared bit for bit (tolerance 0): integer cells and ids exactly, f64
distances through their int64 bit patterns.

- H3's neighbourhood (`k_ring`, `k_loop`, `grid_distance`,
  `resolution_of`, `cell_area_approx`, `is_pentagon`) at resolutions
  0-15, pentagons included;
- the Voronoi tables `build_chip_index` attaches;
- the pair programs `_distance_dense` / `_contains_dense` on point x
  polygon and polygon x polygon pairs;
- `build_knn_index` (arrays, host twin, fingerprint) and
  `convert.knn_index_from_reference`;
- both frontend lanes and the brute-force oracle (`SpatialKNN`:
  `tests/test_torch_knn_model.py`);
- on the card's rule, exhausted retries raise; on the CPU they degrade
  to the oracle, flagged.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu import functions as RF
from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.functions import geometry as RG
from mosaic_tpu.knn import KNNFrontend as RefFrontend
from mosaic_tpu.knn import brute_force_knn as ref_brute
from mosaic_tpu.knn import build_knn_index as ref_build
from mosaic_tpu.serve import BucketLadder as RefLadder
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch import convert
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.dispatch import BucketLadder, cache_stats, clear_caches
from mosaic_tpu_torch.functions import geometry as PG
from mosaic_tpu_torch.knn import KNNFrontend, brute_force_knn, build_knn_index
from mosaic_tpu_torch.models import SpatialKNN
from mosaic_tpu_torch.runtime import DegradedResult, RetryExhausted, faults, telemetry
from mosaic_tpu_torch.sql.join import build_chip_index

from torch_knn_fixtures import (
    BBOX, CONF, PAIRS, RES, ROWS, bits, l_shapes, port, square_wkts,
)


# ------------------------------------------------------------------ H3


def h3_cells(res: int) -> np.ndarray:
    """Seeded global cells at ``res`` plus two of its pentagons."""
    ref = RefH3()
    rng = np.random.default_rng(100 + res)
    xy = np.stack([rng.uniform(-180, 180, 5), rng.uniform(-85, 85, 5)], axis=1)
    cells = np.asarray(ref.point_to_cell(xy, res), dtype=np.int64)
    from mosaic_tpu.core.index.h3 import constants as RC
    from mosaic_tpu.core.index.h3 import hexmath as rhm
    from mosaic_tpu.core.index.h3.tables import derive

    pents = []
    for bc in np.nonzero(derive().is_pentagon)[0][[0, 7]]:
        digits = np.full((1, RC.MAX_RES), RC.INVALID_DIGIT, np.int64)
        digits[:, :res] = 0
        pents.append(int(rhm.pack(np.asarray([bc]), digits, res, np)[0]))
    return np.concatenate([cells, np.asarray(pents, dtype=np.int64)])


@pytest.mark.parametrize("res", range(16))
def test_h3_neighbourhood_equals_reference(res):
    ref, h3 = RefH3(), H3IndexSystem()
    cells = h3_cells(res)
    assert h3.is_pentagon(cells)[-2:].all()
    np.testing.assert_array_equal(h3.is_pentagon(cells), np.asarray(ref.is_pentagon(cells)))
    np.testing.assert_array_equal(h3.resolution_of(cells), np.asarray(ref.resolution_of(cells)))
    assert h3.resolution_of(cells).dtype == np.int32
    assert h3.cell_area_approx(res) == ref.cell_area_approx(res)
    for k in (0, 1, 2):
        got, want = h3.k_ring(cells, k), np.asarray(ref.k_ring(cells, k))
        assert got.dtype == np.int64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(h3.k_loop(cells, k), np.asarray(ref.k_loop(cells, k)))
    ring = h3.k_ring(cells, 2)
    a = np.repeat(cells, ring.shape[1])
    b = ring.reshape(-1)
    a, b = a[b >= 0], b[b >= 0]
    np.testing.assert_array_equal(h3.grid_distance(a, b), np.asarray(ref.grid_distance(a, b)))


def test_h3_k_ring_rows_do_not_depend_on_the_batch():
    """The frontends batch the shells of every active query into one
    call: each row must equal the row computed alone."""
    h3 = H3IndexSystem()
    cells = np.concatenate([h3_cells(9), h3_cells(9)[::-1]])
    full = h3.k_loop(cells, 3)
    for i in (0, 3, 5, 6):
        np.testing.assert_array_equal(full[i], h3.k_loop(cells[i : i + 1], 3)[0])


def test_h3_tensor_inputs_come_back_as_host_arrays():
    h3 = H3IndexSystem()
    cells = h3_cells(7)
    t = torch.from_numpy(cells)
    np.testing.assert_array_equal(h3.k_ring(t, 1), h3.k_ring(cells, 1))
    assert h3.resolution_of(t).dtype == torch.int32


# --------------------------------------------------- the Voronoi tables


@pytest.fixture(scope="module")
def grids():
    return RefCustom(RefConf(*CONF)), CustomIndexSystem(GridConf(*CONF))


@pytest.mark.parametrize("mixed", [False, True], ids=["convex", "mixed"])
def test_voronoi_tables_equal_reference(grids, mixed):
    rg, pg = grids
    rng = np.random.default_rng(5)
    polys, _, _ = square_wkts(rng, 60)
    if mixed:
        polys += l_shapes(rng, 12)
    col = wkt.from_wkt(polys)
    from mosaic_tpu.core.tessellate import tessellate as ref_tessellate

    rix = RJ.build_chip_index(ref_tessellate(col, rg, RES, keep_core_geoms=False))
    pix = build_chip_index(tessellate(port(col), pg, RES, keep_core_geoms=False), device="cpu")
    rv, pv = rix.voronoi, pix.voronoi
    assert pv.method == rv.method == "delaunay"
    for f in ("sites", "adjacency", "geom", "cell", "shift"):
        got, want = getattr(pv, f), np.asarray(getattr(rv, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # the arrays round trip, and the index's arrays carry them
    back = type(pix).from_arrays(pix.to_arrays(), device="cpu").voronoi
    for f in ("sites", "adjacency", "geom", "cell", "shift"):
        np.testing.assert_array_equal(getattr(back, f), getattr(pv, f))
    assert back.method == pv.method


def test_voronoi_adjacency_falls_back_to_nearest_on_collinear_sites():
    from mosaic_tpu.sql.join import _voronoi_adjacency as ref_adj
    from mosaic_tpu_torch.sql.join import _voronoi_adjacency

    sites = np.stack([np.arange(6.0), np.zeros(6)], axis=1)
    got, method = _voronoi_adjacency(sites)
    want, rmethod = ref_adj(sites)
    assert method == rmethod == "nearest"
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ pair programs


def _pairs(kind):
    rng = np.random.default_rng(3)
    polys, _, _ = square_wkts(rng, 40, side=(0.5, 3.0), bbox=(-5, -5, 5, 5))
    extra = [
        "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 1 2, 2 2, 2 1, 1 1))",
        "LINESTRING (0 0, 3 3, 5 0)",
    ]
    a = wkt.from_wkt(polys + extra)
    if kind == "point_polygon":
        pts = rng.uniform(-6, 6, (len(a), 2))
        pts[-2] = (1.5, 1.5)  # inside the hole
        pts[-3] = (0.5, 0.5)
        return wkt.from_wkt([f"POINT ({x} {y})" for x, y in pts]), a
    b, _, _ = square_wkts(rng, len(a), side=(0.5, 3.0), bbox=(-5, -5, 5, 5))
    return a, wkt.from_wkt(b)


@pytest.mark.parametrize("kind", ["point_polygon", "polygon_point", "polygon_polygon",
                                  "polygon_self"])
def test_distance_dense_equals_reference(kind):
    if kind == "polygon_self":
        a, _ = _pairs("polygon_polygon")
        b = a
    else:
        a, b = _pairs(kind.replace("polygon_point", "point_polygon"))
        if kind == "polygon_point":
            a, b = b, a
    da, db = RG._pair_pack(a, b)
    pa, pb = PG._pair_pack(port(a), port(b), device="cpu")
    out = {}
    for fn in ("_distance_dense", "_contains_dense"):
        want = np.asarray(RG._vmap_pair(getattr(RG, fn), da, db))
        out[fn] = got = PG._vmap_pair(getattr(PG, fn), pa, pb).numpy()
        assert got.dtype == want.dtype, fn
        if got.dtype == np.float64:
            np.testing.assert_array_equal(bits(got), bits(want))
        else:
            np.testing.assert_array_equal(got, want)
    assert (out["_distance_dense"] == 0).any()  # containment is exercised


def test_dense_functions_without_a_pair_axis_equal_reference():
    a, b = _pairs("polygon_polygon")
    a, b = a.take(np.arange(6)), b.take(np.arange(5))
    da, db = RG._pair_pack(a, b)
    pa, pb = PG._pair_pack(port(a), port(b), device="cpu")
    from mosaic_tpu.core.geometry import predicates as RP
    from mosaic_tpu_torch.core.geometry import predicates as PP

    np.testing.assert_array_equal(
        bits(PG._distance_dense(pa, pb).numpy()), bits(RG._distance_dense(da, db)))
    np.testing.assert_array_equal(
        PP.edges_intersect(pa, pb).numpy(), np.asarray(RP.edges_intersect(da, db)))


def test_cpu_sqrt_is_correctly_rounded():
    """torch's CPU sqrt is one ulp off on some doubles; the pair programs
    take the root through numpy there."""
    from mosaic_tpu_torch.core.geometry.predicates import _sqrt

    x = np.random.default_rng(0).uniform(0, 1000, 50_000)
    np.testing.assert_array_equal(bits(_sqrt(torch.from_numpy(x)).numpy()), bits(np.sqrt(x)))


# ---------------------------------------------------------- the index


@pytest.fixture(scope="module")
def problem(grids):
    """Dense convex candidates on the custom grid and a query sampler
    staying inside the candidate bbox (the reference test's fixture)."""
    rg, pg = grids
    rng = np.random.default_rng(11)
    polys, cx, cy = square_wkts(rng, 100)
    cand = RF.st_geomfromwkt(np.array(polys))
    rkx = ref_build(cand, index_system=rg, resolution=RES)
    kx = build_knn_index(port(cand), pg, RES, device="cpu")
    lo = np.array([cx.min(), cy.min()])
    hi = np.array([cx.max(), cy.max()])

    def qpts(n, seed):
        r = np.random.default_rng(seed)
        return lo + r.uniform(0.1, 0.9, (n, 2)) * (hi - lo)

    return cand, rkx, kx, qpts


def test_knn_index_equals_reference(problem):
    _, rkx, kx, _ = problem
    assert kx.fingerprint == rkx.fingerprint
    assert kx.resolution == rkx.resolution and kx.n == rkx.n
    assert kx.cell_width == rkx.cell_width
    np.testing.assert_array_equal(kx.cells, rkx.cells)
    np.testing.assert_array_equal(kx.rows, rkx.rows)
    np.testing.assert_array_equal(bits(kx.shift), bits(rkx.shift))
    assert kx.dc.verts.dtype == torch.float64
    for f in ("verts", "ring_len", "ring_is_hole", "n_rings", "geom_type", "shift"):
        np.testing.assert_array_equal(getattr(kx.dc, f).numpy(), np.asarray(getattr(rkx.dc, f)))
    for g in range(kx.n):
        np.testing.assert_array_equal(bits(kx.host.verts[g]), bits(rkx.host.verts[g]))
        for a, b in zip(kx.host.edges[g], rkx.host.edges[g]):
            np.testing.assert_array_equal(bits(a), bits(b))
    np.testing.assert_array_equal(kx.voronoi.adjacency, rkx.voronoi.adjacency)
    cells = np.unique(kx.cells)[:7]
    np.testing.assert_array_equal(np.sort(kx.candidate_rows(cells)),
                                  np.sort(rkx.candidate_rows(cells)))


def reference_arrays(rkx) -> dict:
    """A reference KNNIndex as the numpy arrays `convert` takes."""
    out = {f"candidates.{n}": np.asarray(getattr(rkx.candidates, n))
           for n in ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid")}
    out.update(cells=rkx.cells, rows=rkx.rows, shift=rkx.shift,
               resolution=np.asarray(rkx.resolution), cell_width=np.asarray(rkx.cell_width),
               fingerprint=np.asarray(rkx.fingerprint))
    out.update({f"dc.{n}": np.asarray(getattr(rkx.dc, n))
                for n in ("verts", "ring_len", "ring_is_hole", "n_rings", "geom_type", "shift")})
    ci = rkx.chip_index
    out.update({f"chip.{n}": np.asarray(getattr(ci, n))
                for n in convert.ChipIndex.field_names()})
    out.update({f"chip.border.{n}": np.asarray(getattr(ci.border, n))
                for n in convert.ChipIndex._BORDER})
    vt = ci.voronoi
    out.update({f"chip.voronoi.{n}": np.asarray(getattr(vt, n))
                for n in ("sites", "adjacency", "geom", "cell", "shift")})
    out["chip.voronoi.method"] = np.asarray(vt.method)
    return out


def test_convert_carries_a_reference_knn_index(problem, grids):
    _, rkx, kx, qpts = problem
    ckx = convert.knn_index_from_reference(reference_arrays(rkx), grids[1], device="cpu")
    assert ckx.fingerprint == kx.fingerprint
    np.testing.assert_array_equal(ckx.voronoi.sites, kx.voronoi.sites)
    q = qpts(9, seed=2)
    for lane in ("ring", "voronoi"):
        got = KNNFrontend(ckx, lane=lane).dispatch(q, 3)[0]
        want = KNNFrontend(kx, lane=lane).dispatch(q, 3)[0]
        np.testing.assert_array_equal(bits(got), bits(want))
    bad = reference_arrays(rkx)
    bad["fingerprint"] = np.asarray("knn-0")
    with pytest.raises(ValueError, match="fingerprint"):
        convert.knn_index_from_reference(bad, grids[1], device="cpu")


def test_build_needs_system_and_resolution(grids, problem):
    """An index system is still needed (the context's is item 14); a
    missing resolution is the resolution analyzer's pick, as the
    reference's."""
    rg, pg = grids
    cand = port(problem[0])
    with pytest.raises(NotImplementedError, match="item 14"):
        build_knn_index(cand, None, RES, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        SpatialKNN(None, RES, device="cpu")
    rkx = ref_build(problem[0], index_system=rg)
    kx = build_knn_index(cand, pg, device="cpu")
    assert kx.resolution == rkx.resolution
    assert kx.fingerprint == rkx.fingerprint


# ------------------------------------------------------------- lanes


@pytest.fixture(scope="module")
def frontends(problem):
    _, rkx, kx, _ = problem
    out = {}
    for lane in ("ring", "voronoi"):
        fe = KNNFrontend(kx, lane=lane, row_ladder=BucketLadder(*ROWS),
                         pair_ladder=BucketLadder(*PAIRS))
        rep = fe.warmup()
        assert rep["signatures"] == 14 and rep["backend_compiles"] == 0
        rfe = RefFrontend(rkx, lane=lane, row_ladder=RefLadder(*ROWS),
                          pair_ladder=RefLadder(*PAIRS))
        rfe.warmup()
        out[lane] = (fe, rfe)
    return out


@pytest.mark.parametrize("lane", ["ring", "voronoi"])
@pytest.mark.parametrize("k", [1, 4])
def test_lane_equals_reference_and_oracle(problem, frontends, lane, k):
    _, rkx, kx, qpts = problem
    fe, rfe = frontends[lane]
    q = qpts(13, seed=40 + k)
    out, occ = fe.dispatch(q, k)
    rout, rocc = rfe.dispatch(q, k)
    np.testing.assert_array_equal(bits(out), bits(rout))
    assert occ == rocc
    ids, dist = brute_force_knn(q, kx, k)
    rids, rdist = ref_brute(q, rkx, k)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(bits(dist), bits(rdist))
    np.testing.assert_array_equal(bits(out[:, :k]), bits(dist))
    np.testing.assert_array_equal(out[:, k:].astype(np.int64), ids)
    assert fe.cold_compiles == 0
    assert fe.stats[f"lane_{lane}"] >= 13


def test_voronoi_equals_ring_on_mixed_candidates(grids):
    """Concave candidates break the walk's guarantee for some queries:
    those take the ring lane, and the answers stay the ring lane's."""
    rg, pg = grids
    rng = np.random.default_rng(5)
    polys, _, _ = square_wkts(rng, 40)
    col = RF.st_geomfromwkt(np.array(polys + l_shapes(rng, 12)))
    kx = build_knn_index(port(col), pg, RES, device="cpu")
    rkx = ref_build(col, index_system=rg, resolution=RES)
    q = np.stack([np.random.default_rng(8).uniform(BBOX[0] + 5, BBOX[2] - 5, 9),
                  np.random.default_rng(9).uniform(BBOX[1] + 5, BBOX[3] - 5, 9)], axis=1)
    fr, fv = (KNNFrontend(kx, lane=lane) for lane in ("ring", "voronoi"))
    out_r, out_v = fr.dispatch(q, 3)[0], fv.dispatch(q, 3)[0]
    np.testing.assert_array_equal(bits(out_v), bits(out_r))
    np.testing.assert_array_equal(
        bits(out_v), bits(RefFrontend(rkx, lane="voronoi").dispatch(q, 3)[0]))


def test_query_answers_per_row_and_empty_batches(frontends, problem):
    fe = frontends["ring"][0]
    q = problem[3](3, seed=1)
    answers = fe.query(q, 2)
    out = fe.dispatch(q, 2)[0]
    assert len(answers) == 3 and not answers[0].degraded
    np.testing.assert_array_equal(answers[1].ids, out[1, 2:].astype(np.int64))
    empty, occ = fe.dispatch(np.zeros((0, 2)), 2)
    assert empty.shape == (0, 4) and occ == 1.0
    with pytest.raises(ValueError, match="k must be"):
        fe.dispatch(q, 0)
    with pytest.raises(ValueError, match="unknown knn lane"):
        KNNFrontend(problem[2], lane="grid")
    # mesh= is ported: a meshed frontend answers the same bits, and
    # anything but a count or a Mesh is refused
    with pytest.raises(TypeError, match="mesh="):
        KNNFrontend(problem[2], mesh=object())
    from mosaic_tpu_torch.dispatch import data_mesh

    meshed = KNNFrontend(problem[2], mesh=data_mesh(devices=["cpu"] * 2))
    np.testing.assert_array_equal(
        meshed.dispatch(q, 2)[0].view(np.int64), out.view(np.int64)
    )


def test_more_neighbours_than_candidates_pad(grids):
    _, pg = grids
    col = wkt.from_wkt(square_wkts(np.random.default_rng(2), 3)[0])
    kx = build_knn_index(port(col), pg, RES, device="cpu")
    out = KNNFrontend(kx).dispatch(np.array([[0.0, 0.0]]), 5)[0]
    ids, dist = brute_force_knn(np.array([[0.0, 0.0]]), kx, 5)
    assert (ids[0, 3:] == -1).all() and np.isinf(dist[0, 3:]).all()
    np.testing.assert_array_equal(bits(out[:, :5]), bits(dist))


def test_transient_fault_retries_to_the_same_bits(frontends, problem):
    fe = frontends["ring"][0]
    q = problem[3](6, seed=3)
    want = fe.dispatch(q, 3)[0]
    for site in ("knn.expand", "knn.distance", "knn.scatter"):
        with telemetry.capture() as ev, faults.transient_errors(1, sites=(site,)):
            got = fe.dispatch(q, 3)[0]
        assert [e["event"] for e in ev].count("transient_retry") == 1, site
        assert not isinstance(got, DegradedResult)
        np.testing.assert_array_equal(bits(got), bits(want))


def test_exhausted_retries_degrade_on_the_cpu_and_raise_on_the_card(frontends, problem):
    fe = frontends["ring"][0]
    q = problem[3](5, seed=4)
    want = fe.dispatch(q, 3)[0]
    with faults.transient_errors(50, sites=("knn.distance",)):
        got, _ = fe.dispatch(q, 3)
    assert isinstance(got, DegradedResult)
    np.testing.assert_array_equal(bits(got), bits(want))
    # the card's rule: no fallback to the CPU
    fe._degrade_to_host = False
    try:
        with telemetry.capture() as ev, faults.transient_errors(50, sites=("knn.distance",)):
            with pytest.raises(RetryExhausted):
                fe.dispatch(q, 3)
    finally:
        fe._degrade_to_host = True
    assert "degraded" not in [e["event"] for e in ev]


def test_point_pair_program_lives_in_the_cache_registry(frontends, problem):
    from mosaic_tpu_torch.knn.frontend import _point_pair_prog
    from mosaic_tpu_torch.models.knn import _pair_distance_prog

    _point_pair_prog()
    _pair_distance_prog()
    stats = cache_stats(emit=False)
    assert stats["knn_point_pairs"]["currsize"] == 1
    assert stats["knn_pair_distance"]["currsize"] == 1
    clear_caches(names=["knn_pair_distance"], emit=False)
    assert cache_stats(emit=False)["knn_pair_distance"]["currsize"] == 0
