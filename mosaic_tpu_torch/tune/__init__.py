"""mosaic_tpu_torch.tune — the self-tuning workload optimizer.

Port of ``mosaic_tpu/tune`` with the reference's names, events and
spans; the priors the recommender reads by default are the port's own
measurements on the card (`recommend.PRIORS_DIR`).

Profile a workload (`profiler.WorkloadProfile`), map it to knob
recommendations (`recommend.TuningProfile`), persist them next to the
index artifacts (`store.ProfileStore`), and hand the profile to any
frontend via ``profile=`` — resolved with one documented precedence
(`resolve`): explicit argument > env knob > profile > built-in default.

Import discipline: the frontends this package tunes import
``tune.resolve`` at module scope, so nothing here may import ``sql``/
``raster``/``serve`` back at module scope (the profiler pulls them
lazily inside its entry points).
"""

from __future__ import annotations

from .profiler import (
    WorkloadProfile,
    profile_overlay,
    profile_points,
    profile_polygons,
    profile_raster,
)
from .recommend import TuningProfile, load_priors, recommend
from .resolve import KNOBS, resolve_knob, resolve_knobs
from .store import (
    ProfileFingerprintMismatch,
    ProfileStore,
    ProfileStoreCorrupt,
    index_fingerprint,
)

__all__ = [
    "KNOBS",
    "ProfileFingerprintMismatch",
    "ProfileStore",
    "ProfileStoreCorrupt",
    "TuningProfile",
    "WorkloadProfile",
    "index_fingerprint",
    "load_priors",
    "profile_overlay",
    "profile_points",
    "profile_polygons",
    "profile_raster",
    "recommend",
    "resolve_knob",
    "resolve_knobs",
]
