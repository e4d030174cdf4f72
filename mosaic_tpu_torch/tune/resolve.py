"""Knob-precedence resolution: explicit arg > env knob > profile > default.

Port of ``mosaic_tpu/tune/resolve.py``. Every frontend that accepts
``profile=`` (`pip_join`, `StreamJoin`, `ServeEngine` and its
``hot_swap``, `ZonalEngine`, `RasterStream`) funnels its
profile-consumed knobs through :func:`resolve_knobs` at the host entry
point, before any value reaches the device. The precedence is the
reference's single documented order:

    explicit argument  >  env knob  >  TuningProfile  >  built-in default

Knobs that already had an env spelling keep it (``MOSAIC_STREAM_WINDOW``,
``MOSAIC_STREAM_PIPELINE``, ``MOSAIC_RASTER_TILE``, ``MOSAIC_RASTER_LANE``);
tune-only knobs read the ``MOSAIC_TUNE_*`` family (``MOSAIC_TUNE_PROBE``,
``MOSAIC_TUNE_WRITEBACK``, ``MOSAIC_TUNE_LOOKUP``, ``MOSAIC_TUNE_BATCH``,
``MOSAIC_TUNE_BUCKET_MIN``, ``MOSAIC_TUNE_BUCKET_MAX``,
``MOSAIC_TUNE_KNN_LANE``). ``resolution`` has deliberately NO env layer:
it changes the tessellation artifact, not just the execution schedule,
so it only flows explicitly or via a profile.

What the port adds: ``epoch_log_max`` (``MOSAIC_EPOCH_LOG_MAX``, an int;
0 or unset: no bound), the delta records `index/epoch.py
EpochalIndex.apply` lets pile up before it compacts; no profile carries
it. A ``MOSAIC_TUNE_KNN_LANE`` other than ``ring`` or ``voronoi`` is
malformed here, where the reference lets it through to the frontend.

Each entry-point call records ONE ``tune_resolve`` telemetry event naming
every resolved knob's value and source.
"""

from __future__ import annotations

import os

from ..runtime import telemetry as _telemetry


def _parse_bool(raw: str):
    return raw not in ("", "0")


def _parse_tile(raw: str):
    th, tw = (int(p) for p in raw.lower().split("x"))
    if th < 1 or tw < 1:
        raise ValueError(raw)
    return th, tw


def _parse_lane(raw: str) -> str:
    if raw not in ("ring", "voronoi"):
        raise ValueError(f"knn lane must be 'ring' or 'voronoi', got {raw!r}")
    return raw


#: tune-only knobs: profile field -> (MOSAIC_TUNE_ env suffix, parser)
_TUNE_ENV = {
    "probe": ("PROBE", str),
    "writeback": ("WRITEBACK", str),
    "lookup": ("LOOKUP", str),
    "batch_size": ("BATCH", int),
    "bucket_min": ("BUCKET_MIN", int),
    "bucket_max": ("BUCKET_MAX", int),
    "knn_lane": ("KNN_LANE", _parse_lane),
}

#: knobs whose env spelling predates the tune subsystem: knob -> (reader,
#: parser). The readers keep each name as a LITERAL os.environ.get call,
#: so a scan of the source sees every spelling.
_SHARED_ENV = {
    "stream_window": (
        lambda: os.environ.get("MOSAIC_STREAM_WINDOW"), int,
    ),
    "stream_pipeline": (
        lambda: os.environ.get("MOSAIC_STREAM_PIPELINE"), _parse_bool,
    ),
    "raster_tile": (
        lambda: os.environ.get("MOSAIC_RASTER_TILE"), _parse_tile,
    ),
    "zonal_lane": (
        lambda: os.environ.get("MOSAIC_RASTER_LANE"), str,
    ),
    "epoch_log_max": (
        lambda: os.environ.get("MOSAIC_EPOCH_LOG_MAX"), int,
    ),
}

#: knobs with no env layer at all (artifact-changing, not schedule-changing)
_NO_ENV = frozenset({"resolution"})

KNOBS = tuple(sorted({*_TUNE_ENV, *_SHARED_ENV, *_NO_ENV}))


def _env_value(name: str):
    """The env layer's parsed value for one knob, or None when unset."""
    if name in _TUNE_ENV:
        suffix, parse = _TUNE_ENV[name]
        raw = os.environ.get(f"MOSAIC_TUNE_{suffix}")
    elif name in _SHARED_ENV:
        read, parse = _SHARED_ENV[name]
        raw = read()
    else:
        return None
    if raw is None or raw == "":
        return None
    try:
        return parse(raw)
    except (TypeError, ValueError) as exc:
        raise ValueError(
            f"malformed env value for tune knob {name!r}: {raw!r}"
        ) from exc


def resolve_knob(name: str, explicit, profile, default):
    """One knob through the precedence chain; returns ``(value, source)``
    with source in ``explicit|env|profile|default``. ``explicit=None``
    means "the caller did not pass it"."""
    if name not in KNOBS:
        raise KeyError(f"unknown tune knob {name!r} (expected one of {KNOBS})")
    if explicit is not None:
        return explicit, "explicit"
    env = _env_value(name)
    if env is not None:
        return env, "env"
    pval = getattr(profile, name, None) if profile is not None else None
    if pval is not None:
        return pval, "profile"
    return default, "default"


def resolve_knobs(entry: str, profile, *, explicit: dict, defaults: dict) -> dict:
    """Resolve every knob in ``defaults`` for one frontend entry point and
    record the single summarizing ``tune_resolve`` telemetry event.
    Returns ``{knob: value}``."""
    values, sources = {}, {}
    for name, default in defaults.items():
        values[name], sources[name] = resolve_knob(
            name, explicit.get(name), profile, default
        )
    _telemetry.record(
        "tune_resolve",
        entry=entry,
        profiled=profile is not None,
        **{f"{k}_source": s for k, s in sources.items()},
        **{
            k: (v if isinstance(v, (int, float, bool, str, type(None))) else repr(v))
            for k, v in values.items()
        },
    )
    return values
