"""Map a `WorkloadProfile` to a `TuningProfile` with auditable rules.

Port of ``mosaic_tpu/tune/recommend.py``: the same rule table, rule
names, thresholds and rationale entries ``{knob, value, rule,
evidence}``, so a profile recommends the same knobs in both packages
given the same priors. A knob the rules have no evidence for stays None,
which the resolver reads as "keep the built-in default".

What differs from the reference: :func:`load_priors` with no root reads
``mosaic_tpu_torch/tune/priors/``, which holds only the port's own
measurements on the card (each names the card and its power limit),
never the repository root, whose ``BENCH_*``/``STREAM_*``/``RASTER_*``/
``OVERLAY_*``/``KNN_*`` rounds were measured on a TPU or a CPU. The
thresholds below keep the reference's values; the rounds their comments
cite are the reference's evidence, not the port's.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from ..runtime import telemetry as _telemetry
from .profiler import WorkloadProfile

#: class-share threshold above which the per-cell router pays for itself —
#: the round-7 probe bench (BENCH_r07) showed adaptive winning once dense
#: cells carry >~25% of the points and losing (router overhead) below it
ADAPTIVE_DENSE_SHARE = 0.25

#: tile occupancy below which halving the tile shape wins — raster_bench
#: round 6 (RASTER_r06): sparse coverage wastes pad compute in big tiles
SPARSE_TILE_OCCUPANCY = 0.5

#: border-pair share above which an overlay join is predicate-bound and
#: one step finer tessellation pays: smaller cells convert border chips
#: to core chips, and core pairs are decided WITHOUT the exact
#: ``st_intersects`` predicate (`sql/overlay.py` accepts them outright),
#: so past an even split the predicate batch shrinks faster than the
#: candidate list grows
OVERLAY_BORDER_SHARE = 0.5

#: candidate-pair count above which the device overlay lane amortizes its
#: fixed costs (prep transfer + one fused launch) over enough pairs to beat
#: the host numpy twin — the OVERLAY_r17 bench lane crosses over well below
#: this, so the threshold is conservative; below it the host oracle lane is
#: both exact and cheaper
OVERLAY_DEVICE_CANDIDATES = 4096

#: convex-candidate share above which the KNN Voronoi fast path pays: the
#: one-shot cover dispatch needs the Voronoi walk's strict-descent
#: guarantee, which only convex chip sites give, so its fallback-to-ring
#: fraction tracks (1 - convex share). The KNN_r19 bench lane measured the
#: Voronoi lane well above parity on an all-convex fixture (see
#: ``detail.voronoi_speedup_vs_ring``); at half-convex the saved ring
#: iterations still dominate the wasted walk on the non-convex half
KNN_CONVEX_SHARE = 0.5


@dataclasses.dataclass
class TuningProfile:
    """A set of knob recommendations. None = no recommendation: the
    resolver falls through to the built-in default. ``rationale`` is the
    machine-checkable audit trail, ``source`` summarizes the inputs."""

    resolution: "int | None" = None
    probe: "str | None" = None
    writeback: "str | None" = None
    lookup: "str | None" = None
    batch_size: "int | None" = None
    bucket_min: "int | None" = None
    bucket_max: "int | None" = None
    stream_window: "int | None" = None
    stream_pipeline: "bool | None" = None
    raster_tile: "tuple | None" = None
    zonal_lane: "str | None" = None
    overlay_lane: "str | None" = None
    knn_lane: "str | None" = None
    rationale: list = dataclasses.field(default_factory=list)
    source: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("raster_tile") is not None:
            d["raster_tile"] = list(d["raster_tile"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TuningProfile":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if kw.get("raster_tile") is not None:
            kw["raster_tile"] = tuple(int(v) for v in kw["raster_tile"])
        return cls(**kw)

    @classmethod
    def merged(cls, *profiles: "TuningProfile") -> "TuningProfile":
        """Combine recommendations from complementary workload profiles
        (e.g. the polygon side's resolution with the point side's probe
        and batch knobs). First non-None wins per knob; rationales
        concatenate in the same order so the audit trail survives."""
        out = cls()
        for p in profiles:
            for f in dataclasses.fields(cls):
                if f.name in ("rationale", "source"):
                    continue
                if getattr(out, f.name) is None:
                    setattr(out, f.name, getattr(p, f.name))
            out.rationale.extend(p.rationale)
            out.source.setdefault("merged", []).append(p.source)
        return out


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


#: the port's own priors: measurements on the card only
PRIORS_DIR = Path(__file__).resolve().parent / "priors"


def load_priors(root: "str | Path | None" = None) -> dict:
    """Best-effort read of the committed bench history: ``TREND.json``
    plus any ``BENCH_*``/``STREAM_*``/``RASTER_*``/``OVERLAY_*``/``KNN_*``
    artifacts under ``root`` (default: :data:`PRIORS_DIR`). Missing or
    unreadable files are skipped — priors sharpen rules, they never gate
    them."""
    if root is None:
        root = PRIORS_DIR
    root = Path(root)
    priors: dict = {"artifacts": {}}
    for pattern in (
        "TREND.json",
        "BENCH_*.json",
        "STREAM_*.json",
        "RASTER_*.json",
        "OVERLAY_*.json",
        "KNN_*.json",
    ):
        for path in sorted(root.glob(pattern)):
            try:
                priors["artifacts"][path.name] = json.loads(path.read_text())
            except (OSError, ValueError):
                continue
    return priors


def recommend(profile: WorkloadProfile, priors: "dict | None" = None) -> TuningProfile:
    """The rule table. Each branch appends one rationale entry; the
    returned profile's ``source`` echoes the statistics it read."""
    if priors is None:
        priors = load_priors()
    with _telemetry.timed("tune_stage", stage="recommend", kind=profile.kind):
        return _recommend(profile, priors)


def _recommend(profile: WorkloadProfile, priors: dict) -> TuningProfile:
    out = TuningProfile()
    why = out.rationale

    def set_knob(knob, value, rule, evidence):
        setattr(out, knob, value)
        why.append({"knob": knob, "value": value if not isinstance(value, tuple)
                    else list(value), "rule": rule, "evidence": evidence})

    if profile.kind == "polygons" and profile.optimal_resolution is not None:
        set_knob(
            "resolution", int(profile.optimal_resolution),
            "analyzer-target-cells",
            {"cells_per_geom": profile.cells_per_geom,
             "optimal_resolution": profile.optimal_resolution},
        )

    if (
        profile.kind == "overlay"
        and profile.border_fraction is not None
        and profile.resolution is not None
        and profile.border_fraction > OVERLAY_BORDER_SHARE
    ):
        # consumed from the overlay.candidates span stats the profiler
        # captures (sql/overlay.py emits them on every candidate pass)
        set_knob(
            "resolution", int(profile.resolution) + 1,
            "border-dominated-finer-tessellation",
            {"border_fraction": profile.border_fraction,
             "sure_fraction": profile.sure_fraction,
             "candidates": profile.n_sampled,
             "threshold": OVERLAY_BORDER_SHARE},
        )

    if profile.kind == "overlay" and profile.n_sampled:
        speedup, artifact = _overlay_lane_prior(priors)
        evidence = {
            "candidates": profile.n_sampled,
            "threshold": OVERLAY_DEVICE_CANDIDATES,
            "artifact": artifact,
            "speedup_vs_host": speedup,
        }
        if profile.n_sampled >= OVERLAY_DEVICE_CANDIDATES and (
            speedup is None or speedup >= 1.0
        ):
            # the fused device lane wins once the fixed prep/launch cost is
            # spread over enough pairs, provided the committed bench did not
            # measure it losing to the host twin on this hardware
            set_knob("overlay_lane", "device",
                     "device-lane-amortized-candidates", evidence)
        else:
            set_knob("overlay_lane", "host",
                     "small-candidate-host-lane", evidence)

    shares = profile.class_shares or {}
    dense = float(shares.get("heavy", 0.0)) + float(shares.get("convex", 0.0))
    if profile.kind == "points" and shares:
        if dense > ADAPTIVE_DENSE_SHARE:
            set_knob(
                "probe", "adaptive", "dense-share-router",
                {"heavy": shares.get("heavy"), "convex": shares.get("convex"),
                 "threshold": ADAPTIVE_DENSE_SHARE},
            )
        else:
            set_knob(
                "probe", "scatter", "light-dominated-single-lane",
                {"light": shares.get("light"),
                 "threshold": ADAPTIVE_DENSE_SHARE},
            )

    if profile.kind == "points" and shares:
        speedup, artifact = _knn_lane_prior(priors)
        convex = float(shares.get("convex", 0.0))
        evidence = {
            "convex": convex,
            "threshold": KNN_CONVEX_SHARE,
            "artifact": artifact,
            "voronoi_speedup_vs_ring": speedup,
        }
        if convex > KNN_CONVEX_SHARE and (speedup is None or speedup >= 1.0):
            # mostly-convex candidates: the Voronoi walk's one-shot cover
            # replaces the iterative ring loop, and the committed bench
            # did not measure it losing to ring on this hardware
            set_knob("knn_lane", "voronoi",
                     "convex-share-voronoi-lane", evidence)
        else:
            set_knob("knn_lane", "ring",
                     "mixed-share-ring-lane", evidence)

    n_total = profile.n_total or profile.n_sampled
    if profile.kind == "points" and n_total:
        # batch at a pow2 that amortizes dispatch overhead but keeps the
        # probe intermediates bounded — sized from the FULL workload (the
        # profiling sample is capped; chunking a large stream at the
        # sample size would multiply dispatches ~50x)
        batch = min(65536, max(1024, _next_pow2(n_total // 8)))
        set_knob(
            "batch_size", batch, "pow2-amortized-chunks",
            {"n_total": n_total},
        )
        set_knob(
            "bucket_min", max(64, batch // 16), "ladder-spans-batch",
            {"batch_size": batch},
        )
        set_knob(
            "bucket_max", batch, "ladder-spans-batch",
            {"batch_size": batch},
        )

    if profile.band_fraction is not None and profile.band_fraction > 0.05:
        # a fat epsilon band means the f64 recheck dominates — the exact
        # fold lane keeps zonal answers bit-identical without a recheck
        set_knob(
            "zonal_lane", "fold", "band-fraction-exactness",
            {"band_fraction": profile.band_fraction},
        )

    if profile.kind == "raster" and profile.tile_occupancy is not None:
        if profile.tile_occupancy < SPARSE_TILE_OCCUPANCY:
            set_knob(
                "raster_tile", (128, 128), "sparse-raster-small-tiles",
                {"tile_occupancy": profile.tile_occupancy,
                 "threshold": SPARSE_TILE_OCCUPANCY},
            )
        else:
            set_knob(
                "raster_tile", (256, 256), "dense-raster-default-tiles",
                {"tile_occupancy": profile.tile_occupancy,
                 "threshold": SPARSE_TILE_OCCUPANCY},
            )

    stream = _stream_pipeline_prior(priors)
    if stream is not None:
        window, speedup, name = stream
        set_knob(
            "stream_window", window, "bench-history-window",
            {"artifact": name, "speedup_vs_sync": speedup},
        )
        if speedup is not None:
            set_knob(
                "stream_pipeline", bool(speedup >= 1.0),
                "bench-history-pipeline-speedup",
                {"artifact": name, "speedup_vs_sync": speedup},
            )

    out.source = {
        "profile": profile.as_dict(),
        "priors": sorted(priors.get("artifacts", {})),
    }
    _telemetry.record(
        "tune_recommend",
        kind=profile.kind,
        knobs=",".join(sorted(r["knob"] for r in why)),
        rules=",".join(sorted({r["rule"] for r in why})),
    )
    return out


def _overlay_lane_prior(priors: dict):
    """The committed overlay bench's device-vs-host measurement, when one
    exists: ``(speedup_vs_host, artifact)``. A measured speedup < 1.0 means
    the fused device lane lost to the host numpy twin on this hardware, so
    the router should keep candidates on the host lane regardless of size."""
    speedup, artifact = None, None
    for name, art in sorted(priors.get("artifacts", {}).items()):
        if not name.startswith("OVERLAY_") or not isinstance(art, dict):
            continue
        detail = art.get("detail")
        if not isinstance(detail, dict):
            continue
        s = detail.get("speedup_vs_host")
        if isinstance(s, (int, float)):
            # newest round wins (names sort by round suffix)
            speedup, artifact = float(s), name
    return speedup, artifact


def _knn_lane_prior(priors: dict):
    """The committed KNN bench's Voronoi-vs-ring measurement, when one
    exists: ``(voronoi_speedup_vs_ring, artifact)``. A measured speedup
    < 1.0 means the one-shot Voronoi cover lost to iterative ring
    expansion on this hardware, so the router keeps the ring lane even
    for convex-dominated candidates."""
    speedup, artifact = None, None
    for name, art in sorted(priors.get("artifacts", {}).items()):
        if not name.startswith("KNN_") or not isinstance(art, dict):
            continue
        detail = art.get("detail")
        if not isinstance(detail, dict):
            continue
        s = detail.get("voronoi_speedup_vs_ring")
        if isinstance(s, (int, float)):
            # newest round wins (names sort by round suffix)
            speedup, artifact = float(s), name
    return speedup, artifact


def _stream_pipeline_prior(priors: dict):
    """The committed stream bench's pipelined-executor measurement, when
    one exists: ``(window, speedup_vs_sync, artifact)``. The measured-good
    window depth beats the hardcoded default, and the measured speedup
    decides whether the pipelined lane is worth turning on at all."""
    best = None
    for name, art in sorted(priors.get("artifacts", {}).items()):
        if not name.startswith("STREAM_") or not isinstance(art, dict):
            continue
        detail = art.get("detail")
        pipe = detail.get("pipeline") if isinstance(detail, dict) else None
        if not isinstance(pipe, dict):
            continue
        win = pipe.get("window")
        if isinstance(win, (int, float)) and int(win) >= 1:
            speedup = pipe.get("speedup_vs_sync")
            cand = (
                int(win),
                float(speedup) if isinstance(speedup, (int, float)) else None,
                name,
            )
            # newest round wins (names sort by round suffix)
            best = cand
    return best
