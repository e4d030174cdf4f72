"""Chaos sweep: one injected fault at EVERY registered site, one verdict.

Port of the reference's ``tools/chaos_sweep.py``, run on the port.
``mosaic_tpu_torch/tools/goldens/registry.json`` enumerates the fault
sites the port's runtime guards (regenerated by ``python -m
mosaic_tpu_torch.tools.lint --update-registry``, so a new site cannot
hide). For each site this sweep runs the site's workload clean, re-runs
it with exactly ONE injected fault at that site, proves the injection
actually tripped (``plan.trips``), and asserts the outcome is one of the
published resilience contracts:

- **typed**     — a typed `MosaicRuntimeError` subclass reached the
                  caller: never a bare exception, never a hang, and the
                  driver re-proves the surface still serves afterwards;
- **identical** — the retry layer absorbed the fault and the result is
                  bit-identical to the clean run;
- **degraded**  — the result is explicitly flagged degraded AND still
                  matches the clean run (the f64 host-oracle fallback;
                  only a CPU run degrades: on the card exhausted retries
                  raise ``RetryExhausted``);
- **contained** — a data-corruption site: exactly the poisoned rows are
                  quarantined, callers' inputs untouched.

A registry site with NO driver here FAILS the sweep. Drivers for sites
not in the registry run too and are reported under ``detail.extra``.
Every driver runs on ``--device`` (the card by default; ``--device cpu``
runs the plain torch paths). The port's retry policy is the constant
default (a one-shot fault costs one 0.05 s backoff), so the sweep sets no
environment knob.

The final stdout line is ALWAYS one machine-parseable JSON object;
everything else goes to stderr.

Usage:
  python -m mosaic_tpu_torch.tools.chaos_sweep --trail /tmp/chaos.jsonl
  python -m mosaic_tpu_torch.tools.chaos_sweep --device cpu --sites 'epoch.*'
"""

from __future__ import annotations

import argparse
import contextlib
import fnmatch
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_REGISTRY = os.path.join(HERE, "goldens", "registry.json")

RES = 3
RES_H3 = 7
BBOX = (-25.0, -25.0, 35.0, 20.0)
BBOX_NY = (-74.05, 40.60, -73.85, 40.78)
ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))",
    "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
    "POLYGON ((20 -10, 30 -10, 30 5, 20 5, 20 -10))",
]
ZONE0_V2 = "POLYGON ((1 1, 14 1, 12 12, 5 13, 1 8, 1 1))"
MESH_SHARDS = 8

#: the device every driver runs on (`run_sweep` sets it)
DEVICE = "cuda"
#: the sweep's scratch directories live under this root (`run_sweep`)
_TMP_ROOT: list = []


class ChaosMiss(AssertionError):
    """A site's driver broke the chaos contract (never tripped, untyped
    escape, silent divergence) — the sweep fails on the first one."""


DRIVERS: dict = {}


def driver(site):
    def deco(fn):
        DRIVERS[site] = fn
        return fn
    return deco


_CACHE: dict = {}


def memo(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def tmpdir(tag: str) -> str:
    base = _TMP_ROOT[0] if _TMP_ROOT else None
    return tempfile.mkdtemp(prefix=f"chaos-{tag.replace('.', '-')}-", dir=base)


# ------------------------------------------------------------- fixtures


def grid():
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf

    return memo(
        "grid",
        lambda: CustomIndexSystem(GridConf(-180, 180, -90, 90, 2,
                                           10.0, 10.0)),
    )


def grid_table():
    def build():
        from mosaic_tpu_torch.core.geometry import wkt
        from mosaic_tpu_torch.core.tessellate import tessellate

        return tessellate(wkt.from_wkt(ZONES), grid(), RES,
                          keep_core_geoms=False)

    return memo("grid_table", build)


def grid_index():
    def build():
        from mosaic_tpu_torch.sql.join import build_chip_index

        return build_chip_index(grid_table(), device=DEVICE)

    return memo("grid_index", build)


def grid_pts(n=256, seed=3):
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.uniform(BBOX[:2], BBOX[2:], (n, 2))


def h3_problem():
    """Zones + chip index with a tiny edge_cap (tier-2 cells genuinely
    exist) + points — the resilience-test fixture, verbatim."""

    def build():
        import numpy as np

        from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
        from mosaic_tpu_torch.core.tessellate import tessellate
        from mosaic_tpu_torch.datasets import random_points, synthetic_zones
        from mosaic_tpu_torch.sql.join import build_chip_index

        h3 = H3IndexSystem()
        zones = synthetic_zones(3, 3, bbox=BBOX_NY)
        index = build_chip_index(
            tessellate(zones, h3, RES_H3, keep_core_geoms=False),
            edge_cap=8, device=DEVICE,
        )
        pts = random_points(1200, bbox=BBOX_NY, seed=5)
        return h3, zones, index, np.asarray(pts)

    return memo("h3_problem", build)


def overlay_squares():
    def build():
        from mosaic_tpu_torch.core.geometry import wkt

        def squares(specs):
            return wkt.from_wkt([
                f"POLYGON (({x0} {y0}, {x0 + w} {y0}, {x0 + w} {y0 + h},"
                f" {x0} {y0 + h}, {x0} {y0}))"
                for x0, y0, w, h in specs
            ])

        left = squares([(i * 2.9, j * 2.9, 2.7, 2.7)
                        for i in range(4) for j in range(4)])
        right = squares([(i * 2.9 + 0.9, j * 2.9 + 0.6, 2.4, 2.4)
                         for i in range(4) for j in range(4)])
        return left, right

    return memo("overlay_squares", build)


def stream_ctx():
    def build():
        import numpy as np

        from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

        rng = np.random.default_rng(7)
        batches = [
            rng.uniform(BBOX[:2], BBOX[2:], (512, 2)) for _ in range(3)
        ]
        ring = ring_from_host(batches, device=DEVICE)
        sj = StreamJoin(grid_index(), grid(), RES, prefetch=True)
        return sj, batches, ring

    return memo("stream_ctx", build)


def fast_policy():
    from mosaic_tpu_torch.runtime.retry import RetryPolicy

    return RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)


# ----------------------------------------------------------- comparators


def host(a):
    """``a`` as a host numpy array (a tensor anywhere, or array-like)."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def arr_same(a, b) -> bool:
    a, b = host(a), host(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def fields_same(names):
    def same(a, b):
        return all(
            arr_same(getattr(a, f), getattr(b, f)) for f in names
        )
    return same


zonal_same = fields_same(("keys", "count", "sum", "min", "max"))
measures_same = fields_same(("pairs", "value", "valid", "area", "sure"))


def stats_same(a, b) -> bool:
    return (a.checksum, a.matches, a.overflow) == (
        b.checksum, b.matches, b.overflow
    )


# ------------------------------------------------------ one-shot harness


def catching(fn):
    try:
        return fn(), None
    except BaseException as e:  # lint: broad-except-ok (the sweep classifies EVERY escape: typed passes, untyped is the finding)
        return None, e


def require_typed(site, err):
    from mosaic_tpu_torch.runtime.errors import MosaicRuntimeError

    if err is None:
        raise ChaosMiss(f"{site}: expected a typed error, got success")
    if not isinstance(err, MosaicRuntimeError):
        raise ChaosMiss(
            f"{site}: UNTYPED {type(err).__name__} escaped: {err!r}"
        )


def one_shot(site, run, same, clean=None):
    """Run ``run()`` clean, then with one injected fault at ``site``;
    classify the faulted outcome against the resilience contract."""
    from mosaic_tpu_torch.runtime import faults, telemetry
    from mosaic_tpu_torch.runtime.errors import DegradedResult

    if clean is None:
        clean = run()
    with telemetry.capture() as ev:
        with faults.transient_errors(1, sites=(site,)) as plan:
            out, err = catching(run)
    if not plan.trips:
        raise ChaosMiss(
            f"{site}: the one-shot fault never tripped — the driver "
            "does not reach this site"
        )
    retries = sum(1 for e in ev if e["event"] == "transient_retry")
    if err is not None:
        require_typed(site, err)
        return {"outcome": "typed", "error": type(err).__name__}
    degraded = isinstance(out, DegradedResult) or bool(
        getattr(out, "degraded", False)
    )
    if not degraded:
        m = getattr(out, "metrics", None)
        if isinstance(m, dict):
            degraded = bool(m.get("degraded"))
    if not same(out, clean):
        raise ChaosMiss(
            f"{site}: faulted result diverged from clean with no typed "
            "error and no degradation flag — a silent wrong answer"
        )
    return {
        "outcome": "degraded" if degraded else "identical",
        "retries": retries,
    }


# ------------------------------------------------------- join / overlay


def _grid_join(pts, index=None):
    from mosaic_tpu_torch.sql.join import pip_join

    return pip_join(pts, None, grid(), RES, chip_index=index or grid_index(),
                    recheck=False, device=DEVICE)


@driver("pip_join.device")
def drive_pip_join():
    pts = grid_pts()
    return one_shot("pip_join.device", lambda: _grid_join(pts), arr_same)


@driver("overlay.predicate")
def drive_overlay_predicate():
    from mosaic_tpu_torch.datasets import synthetic_zones
    from mosaic_tpu_torch.sql.overlay import overlay_join

    h3, zones, _, _ = h3_problem()
    left = zones
    right = memo("overlay_right",
                 lambda: synthetic_zones(2, 2, bbox=BBOX_NY))
    return one_shot(
        "overlay.predicate",
        lambda: overlay_join(left, right, h3, RES_H3, device=DEVICE),
        arr_same,
    )


def _overlay_measures_run():
    from mosaic_tpu_torch import expr as E
    from mosaic_tpu_torch.sql.overlay import overlay_measures

    left, right = overlay_squares()
    return overlay_measures(left, right, grid(), RES,
                            E.overlap_fraction(), device=DEVICE)


@driver("overlay.device_candidates")
def drive_overlay_candidates():
    return one_shot(
        "overlay.device_candidates", _overlay_measures_run,
        measures_same,
    )


@driver("overlay.measures")
def drive_overlay_measures():
    return one_shot(
        "overlay.measures", _overlay_measures_run, measures_same,
    )


@driver("dist_join.step")
def drive_dist_join():
    import torch

    from mosaic_tpu_torch.parallel import dist_pip_join, make_mesh

    h3, zones, index, pts = h3_problem()
    mesh = make_mesh(MESH_SHARDS, devices=[torch.device(DEVICE)] * MESH_SHARDS,
                     cell_axis=2)
    cells = host(h3.point_to_cell(
        torch.from_numpy(pts).to(DEVICE), RES_H3))
    return one_shot(
        "dist_join.step",
        lambda: dist_pip_join(pts, cells, index, mesh, len(zones))[0],
        arr_same,
    )


@driver("knn.pair_distances")
def drive_knn():
    import numpy as np

    from mosaic_tpu_torch.datasets import synthetic_zones
    from mosaic_tpu_torch.models import SpatialKNN

    h3, zones, _, _ = h3_problem()
    lands = synthetic_zones(2, 2, bbox=(-74.0, 40.62, -73.9, 40.7))

    def run():
        knn = SpatialKNN(index=h3, resolution=RES_H3, k_neighbours=2,
                         device=DEVICE)
        return knn.transform(lands, zones)

    def same(a, b):
        # the KNN degradation contract is the oracle distances at
        # rtol 1e-9 (the published bound), candidate ids exact
        return arr_same(a.candidate_id, b.candidate_id) and bool(
            np.allclose(host(a.distance), host(b.distance), rtol=1e-9)
        )

    return one_shot("knn.pair_distances", run, same)


# ---------------------------------------------------------- knn serving


def knn_ctx():
    """A warmed ring-lane KNN frontend over dense grid-indexed squares
    plus a fixed query batch — shared by the three knn.* site drivers
    (warmup is the expensive part; the clean answer is memoized too)."""

    def build():
        import numpy as np

        from mosaic_tpu_torch import functions as F
        from mosaic_tpu_torch.knn import KNNFrontend, build_knn_index

        rng = np.random.default_rng(23)
        n = 80
        cx = rng.uniform(BBOX[0], BBOX[2], n)
        cy = rng.uniform(BBOX[1], BBOX[3], n)
        s = rng.uniform(0.5, 1.5, n)
        cand = F.st_geomfromwkt(np.array([
            f"POLYGON(({x} {y}, {x + w} {y}, {x + w} {y + w},"
            f" {x} {y + w}, {x} {y}))"
            for x, y, w in zip(cx, cy, s)
        ]))
        kx = build_knn_index(cand, index_system=grid(), resolution=RES,
                             device=DEVICE)
        fe = KNNFrontend(kx, lane="ring")
        fe.warmup()
        lo = np.array([cx.min(), cy.min()])
        hi = np.array([cx.max(), cy.max()])
        q = lo + rng.uniform(0.1, 0.9, (6, 2)) * (hi - lo)
        return fe, q

    return memo("knn_ctx", build)


def _knn_site(site):
    fe, q = knn_ctx()

    def run():
        out, _ = fe.dispatch(q, 2)
        return out

    clean = memo("knn_clean", run)
    r = one_shot(site, run, arr_same, clean=clean)
    # the frontend must keep serving exactly after the fault
    if not arr_same(run(), clean):
        raise ChaosMiss(f"{site}: frontend did not recover after the "
                        "injected fault")
    return r


@driver("knn.expand")
def drive_knn_expand():
    return _knn_site("knn.expand")


@driver("knn.distance")
def drive_knn_distance():
    return _knn_site("knn.distance")


@driver("knn.scatter")
def drive_knn_scatter():
    return _knn_site("knn.scatter")


# --------------------------------------------------------- expr / raster


@driver("expr.map")
def drive_expr_map():
    import numpy as np

    from mosaic_tpu_torch import expr as E
    from mosaic_tpu_torch.raster import Raster
    from mosaic_tpu_torch.raster.zonal import ZonalEngine

    engine = ZonalEngine(grid(), RES, chip_index=grid_index(), device=DEVICE)
    rng = np.random.default_rng(5)
    data = rng.uniform(0.0, 100.0, (3, 75, 90))
    for b in range(3):
        data[b][rng.random((75, 90)) < 0.08] = np.nan
    raster = Raster(data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0),
                    srid=0, nodata=float("nan"))
    pipe = E.ndvi(nir=2, red=1).mask_where(E.band(3) < 80.0).zonal(
        by="zones"
    )
    return one_shot(
        "expr.map",
        lambda: engine.map(pipe, raster, tile=(32, 32),
                           retry_policy=fast_policy()),
        zonal_same,
    )


@driver("raster.decode")
def drive_raster_decode():
    import numpy as np

    from mosaic_tpu_torch.raster import Raster, read_raster, write_geotiff

    rng = np.random.default_rng(11)
    r = Raster(
        data=rng.uniform(0, 100, (1, 16, 16)),
        gt=(-74.05, 0.01, 0.0, 40.78, 0.0, -0.01),
        srid=4326, nodata=-9.0,
    )
    path = os.path.join(tmpdir("raster.decode"), "chaos.tif")
    write_geotiff(path, r)
    return one_shot(
        "raster.decode",
        lambda: read_raster(path),
        lambda a, b: arr_same(a.data, b.data),
    )


@driver("raster.zonal")
def drive_raster_zonal():
    import numpy as np

    from mosaic_tpu_torch.raster import Raster
    from mosaic_tpu_torch.raster.zonal import zonal_zones

    rng = np.random.default_rng(5)
    data = rng.uniform(0, 100, (1, 40, 40))
    data[0][rng.random((40, 40)) < 0.1] = -9.0
    r = Raster(data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0),
               srid=0, nodata=-9.0)
    return one_shot(
        "raster.zonal",
        lambda: zonal_zones(r, grid_index(), grid(), RES, tile=(32, 32),
                            device=DEVICE),
        zonal_same,
    )


# ---------------------------------------------------------------- serve


def _serve_engine():
    from mosaic_tpu_torch.serve import BucketLadder, ServeEngine

    return ServeEngine(grid_index(), grid(), RES,
                       ladder=BucketLadder(64, 4096), bounds=BBOX,
                       max_wait_s=0.01)


def _serve_site(site):
    pts = grid_pts(90, seed=21)
    ref = host(_grid_join(pts))
    with _serve_engine() as eng:
        eng.warmup()

        def run():
            return host(eng.join(pts, deadline_s=60.0))

        r = one_shot(site, run, arr_same, clean=ref)
        # the engine must keep serving cleanly after the fault
        if not arr_same(run(), ref):
            raise ChaosMiss(f"{site}: engine did not recover after "
                            "the injected fault")
        return r


@driver("serve.admit")
def drive_serve_admit():
    return _serve_site("serve.admit")


@driver("serve.batch")
def drive_serve_batch():
    return _serve_site("serve.batch")


@driver("serve.dispatch")
def drive_serve_dispatch():
    return _serve_site("serve.dispatch")


# --------------------------------------------------------------- router


def _mk_router():
    from mosaic_tpu_torch.dispatch import BucketLadder
    from mosaic_tpu_torch.serve import ServeRouter

    return ServeRouter(grid(), program_store=tmpdir("router-store"),
                       engine_defaults={
                           "ladder": BucketLadder(64, 256),
                           "bounds": BBOX,
                           "max_wait_s": 0.01,
                       })


@driver("router.admit")
def drive_router_admit():
    with _mk_router() as router:
        router.add_tenant("a", grid_index(), RES, warm=False)
        pts = grid_pts(16, seed=10)
        ref = host(router.join("a", pts))
        r = one_shot(
            "router.admit",
            lambda: host(router.join("a", pts)),
            arr_same, clean=ref,
        )
        if not arr_same(host(router.join("a", pts)), ref):
            raise ChaosMiss("router.admit: tenant did not keep serving "
                            "after the failed admission")
        return r


@driver("router.evict")
def drive_router_evict():
    from mosaic_tpu_torch.runtime import faults

    with _mk_router() as router:
        router.add_tenant("a", grid_index(), RES, warm=False)
        router.join("a", grid_pts(8, seed=10))
        with faults.transient_errors(1, sites=("router.evict",)) as plan:
            _, err = catching(lambda: router.evict("a"))
        if not plan.trips:
            raise ChaosMiss("router.evict: fault never tripped")
        require_typed("router.evict", err)
        if not router.metrics()["tenants"]["a"]["resident"]:
            raise ChaosMiss("router.evict: failed evict must leave the "
                            "engine resident and serving")
        router.evict("a")
        if router.metrics()["tenants"]["a"]["resident"]:
            raise ChaosMiss("router.evict: clean evict did not release "
                            "the engine")
        return {"outcome": "typed", "error": type(err).__name__}


@driver("router.swap")
def drive_router_swap():
    from mosaic_tpu_torch.core.geometry import wkt
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.runtime import faults
    from mosaic_tpu_torch.sql.join import build_chip_index

    index_b = build_chip_index(tessellate(
        wkt.from_wkt(["POLYGON ((-24 -24, 34 -24, 34 19, -24 19, "
                      "-24 -24))"]),
        grid(), RES, keep_core_geoms=False,
    ), device=DEVICE)
    pts = grid_pts(64, seed=10)
    ref_a = host(_grid_join(pts))
    ref_b = host(_grid_join(pts, index_b))
    with _mk_router() as router:
        router.add_tenant("a", grid_index(), RES, warm=False)
        with faults.transient_errors(1, sites=("router.swap",)) as plan:
            _, err = catching(lambda: router.swap("a", index_b))
        if not plan.trips:
            raise ChaosMiss("router.swap: fault never tripped")
        require_typed("router.swap", err)
        # all-or-nothing: the tenant still serves the OLD snapshot
        if not arr_same(host(router.join("a", pts)), ref_a):
            raise ChaosMiss("router.swap: failed swap left a torn "
                            "snapshot — answers match neither index")
        router.swap("a", index_b)
        if not arr_same(host(router.join("a", pts)), ref_b):
            raise ChaosMiss("router.swap: clean swap after the fault "
                            "did not take")
        return {"outcome": "typed", "error": type(err).__name__}


# --------------------------------------------------------------- stream


@driver("stream.admit")
def drive_stream_admit():
    import numpy as np

    from mosaic_tpu_torch.runtime import faults

    sj, batches, _ = stream_ctx()
    originals = [b.copy() for b in batches]
    with faults.corrupt_batches(rows=4, n=1,
                                sites=("stream.admit",)) as plan:
        _, rep = sj.admit(batches, bounds=BBOX)
    if not getattr(plan, "corrupted", 0):
        raise ChaosMiss("stream.admit: the corruption plan never "
                        "touched a batch")
    if rep.n_quarantined != 4:
        raise ChaosMiss(f"stream.admit: expected exactly the 4 poisoned "
                        f"rows quarantined, got {rep.n_quarantined}")
    for b, o in zip(batches, originals):
        if not np.array_equal(b, o):
            raise ChaosMiss("stream.admit: admission mutated the "
                            "caller's arrays")
    return {"outcome": "contained", "quarantined": rep.n_quarantined}


@driver("stream.prefetch")
def drive_stream_prefetch():
    from mosaic_tpu_torch.sql.stream import ring_from_host

    _, batches, _ = stream_ctx()
    return one_shot(
        "stream.prefetch",
        lambda: host(ring_from_host(batches, device=DEVICE)),
        arr_same,
    )


def _stream_durable(site):
    sj, _, ring = stream_ctx()

    def run():
        return sj.run_durable(
            ring, 7, run_dir=tmpdir(site), snapshot_every=2,
            retry_policy=fast_policy(),
        )

    return one_shot(site, run, stats_same)


@driver("stream.scan_step")
def drive_stream_scan_step():
    return _stream_durable("stream.scan_step")


@driver("stream.snapshot")
def drive_stream_snapshot():
    return _stream_durable("stream.snapshot")


# ---------------------------------------------------------------- epoch


def _mk_epochal(tag):
    from mosaic_tpu_torch.core.geometry import wkt
    from mosaic_tpu_torch.index.epoch import EpochalIndex

    d = tmpdir(tag)
    ep = EpochalIndex(wkt.from_wkt(ZONES), grid(), RES, log_dir=d,
                      keep_core_geoms=False, device=DEVICE)
    ep.publish()
    return ep, d


def _epoch_apply(ep):
    from mosaic_tpu_torch.core.geometry import wkt

    ep.apply(upsert=wkt.from_wkt([ZONE0_V2]), ids=[0])


def _replay_equals_live(site, ep, d):
    from mosaic_tpu_torch.index.epoch import EpochalIndex, chip_index_equal

    r = EpochalIndex.replay(d, grid(), device=DEVICE)
    if not chip_index_equal(r.index, ep.index):
        raise ChaosMiss(f"{site}: replay of the delta log diverged "
                        "from the live index after the fault")


@driver("epoch.apply")
def drive_epoch_apply():
    from mosaic_tpu_torch.runtime import faults

    ep, d = _mk_epochal("epoch.apply")
    with faults.transient_errors(1, sites=("epoch.apply",)) as plan:
        _, err = catching(lambda: _epoch_apply(ep))
    if not plan.trips:
        raise ChaosMiss("epoch.apply: fault never tripped")
    require_typed("epoch.apply", err)
    if ep.applied_epoch != 0:
        raise ChaosMiss("epoch.apply: a killed apply must not advance "
                        "the applied epoch")
    _epoch_apply(ep)
    ep.publish()
    _replay_equals_live("epoch.apply", ep, d)
    return {"outcome": "typed", "error": type(err).__name__}


@driver("epoch.publish")
def drive_epoch_publish():
    from mosaic_tpu_torch.runtime import faults

    ep, d = _mk_epochal("epoch.publish")
    _epoch_apply(ep)
    with faults.transient_errors(1, sites=("epoch.publish",)) as plan:
        _, err = catching(ep.publish)
    if not plan.trips:
        raise ChaosMiss("epoch.publish: fault never tripped")
    require_typed("epoch.publish", err)
    if ep.epoch != 0:
        raise ChaosMiss("epoch.publish: a killed publish must leave the "
                        "old epoch serving")
    ep.publish()
    if ep.epoch != 1:
        raise ChaosMiss("epoch.publish: retried publish did not land")
    _replay_equals_live("epoch.publish", ep, d)
    return {"outcome": "typed", "error": type(err).__name__}


@driver("epoch.compact")
def drive_epoch_compact():
    from mosaic_tpu_torch.runtime import faults

    ep, d = _mk_epochal("epoch.compact")
    _epoch_apply(ep)
    ep.publish()
    with faults.transient_errors(1, sites=("epoch.compact",)) as plan:
        _, err = catching(ep.compact)
    if not plan.trips:
        raise ChaosMiss("epoch.compact: fault never tripped")
    require_typed("epoch.compact", err)
    _replay_equals_live("epoch.compact", ep, d)  # log still whole
    ep.compact()
    _replay_equals_live("epoch.compact", ep, d)  # compacted log too
    return {"outcome": "typed", "error": type(err).__name__}


# ----------------------------------------------------------------- main


def run_sweep(registry: str = DEFAULT_REGISTRY, device: str = "cuda",
              sites=None, trail: str | None = None) -> tuple[dict, int]:
    """Sweep every registered site (or those matching ``sites``) on
    ``device``; returns ``(the JSON line, exit code)``. The fixtures'
    device state and scratch directories are freed before it returns."""
    global DEVICE
    from mosaic_tpu_torch import resolve_device

    detail: dict = {"device": str(device)}
    line = {"metric": "chaos_sites_clean", "value": 0, "unit": "sites",
            "detail": detail}
    stages: list = []
    cap = root_span = None
    rc = 1
    _CACHE.clear()
    _TMP_ROOT[:] = [tempfile.mkdtemp(prefix="chaos-sweep-")]
    try:
        DEVICE = str(resolve_device(device))
        with open(registry) as f:
            registered = list(json.load(f)["fault_sites"])

        missing = sorted(s for s in registered if s not in DRIVERS)
        extra = sorted(set(DRIVERS) - set(registered))
        targets = sorted(set(registered) | set(DRIVERS))
        if sites:
            targets = [t for t in targets
                       if any(fnmatch.fnmatch(t, p) for p in sites)]
            missing = [m for m in missing
                       if any(fnmatch.fnmatch(m, p) for p in sites)]

        from mosaic_tpu_torch import obs
        from mosaic_tpu_torch.runtime import telemetry

        cap = telemetry.capture()
        stages = cap.__enter__()
        root_span = obs.start_span("chaos_sweep", sites=len(targets))

        outcomes: dict = {}
        failures: dict = {}
        for site in targets:
            fn = DRIVERS.get(site)
            if fn is None:
                continue  # already recorded in `missing`
            t0 = time.perf_counter()
            try:
                r = fn()
                r["seconds"] = round(time.perf_counter() - t0, 3)
                outcomes[site] = r
                print(f"[chaos] {site}: {r['outcome']} "
                      f"({r['seconds']}s)", file=sys.stderr)
            except Exception as e:  # lint: broad-except-ok (one site's failure must not hide the rest of the sweep)
                failures[site] = repr(e)[:300]
                print(f"[chaos] {site}: FAIL {e!r}", file=sys.stderr)
            telemetry.record(
                "chaos_site", site=site,
                outcome=outcomes.get(site, {}).get("outcome", "fail"),
            )

        detail["outcomes"] = outcomes
        detail["failures"] = failures
        detail["missing_drivers"] = missing
        detail["extra"] = extra
        detail["registered"] = len(registered)
        line["value"] = len(outcomes)

        if missing:
            raise AssertionError(
                f"{len(missing)} registered fault site(s) have no chaos "
                f"driver: {missing} — every site in the registry must "
                "ship one"
            )
        if failures:
            raise AssertionError(
                f"{len(failures)} site(s) broke the chaos contract: "
                f"{sorted(failures)}"
            )
        rc = 0
    except Exception as e:  # lint: broad-except-ok (the sweep must always emit its JSON line; rc carries failure)
        detail["error"] = repr(e)[:400]
    finally:
        if root_span is not None:
            try:
                root_span.end()
            except Exception:  # lint: broad-except-ok (span cleanup must not mask the sweep result)
                pass
        if cap is not None:
            cap.__exit__(None, None, None)
        _CACHE.clear()
        shutil.rmtree(_TMP_ROOT[0], ignore_errors=True)
        _TMP_ROOT[:] = []

    if trail and stages:
        try:
            from mosaic_tpu_torch import obs as _obs

            _obs.write_jsonl(stages, trail)
        except Exception as e:  # lint: broad-except-ok (a sick trail disk degrades the trail, not the sweep)
            detail["trail_error"] = repr(e)[:200]
    return line, rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--registry", default=DEFAULT_REGISTRY)
    ap.add_argument("--device", default="cuda",
                    help="device every driver runs on (default: the card; "
                    "cpu runs the plain torch paths)")
    ap.add_argument("--sites", action="append", default=None,
                    help="fnmatch pattern(s) restricting the sweep; "
                    "repeatable (default: every site)")
    ap.add_argument("--trail", default=None,
                    help="export the captured telemetry trail as JSONL")
    args = ap.parse_args(argv)

    emit_to = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        line, rc = run_sweep(args.registry, args.device, args.sites,
                             args.trail)
    emit_to.write(json.dumps(line) + "\n")
    emit_to.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
