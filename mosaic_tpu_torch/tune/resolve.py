"""Knob-precedence resolution: explicit arg > env knob > default.

Port of the part of ``mosaic_tpu/tune/resolve.py`` that the port's
frontends read. `StreamJoin` and `RasterStream` funnel their knobs
through :func:`resolve_knobs` at the host entry point, before any value
reaches the device loop. The reference's precedence is

    explicit argument  >  env knob  >  TuningProfile  >  built-in default

and the port has no tuning profiles yet (ROADMAP queue 1 item 13): a
non-None ``profile`` raises ``NotImplementedError``, as ``pip_join``'s
does. The knobs carried are the ones the port reads:

- ``probe`` (``MOSAIC_TUNE_PROBE``) and ``lookup``
  (``MOSAIC_TUNE_LOOKUP``);
- ``stream_pipeline`` (``MOSAIC_STREAM_PIPELINE``, "" and "0" are
  false) and ``stream_window`` (``MOSAIC_STREAM_WINDOW``, an int);
- ``knn_lane`` (``MOSAIC_TUNE_KNN_LANE``, ``ring`` or ``voronoi``), the
  KNN frontend's lane that `ServeEngine` builds;
- ``epoch_log_max`` (``MOSAIC_EPOCH_LOG_MAX``, an int; 0 or unset: no
  bound), the delta records `index/epoch.py EpochalIndex.apply` lets
  pile up before it compacts.

Each entry-point call records ONE ``tune_resolve`` telemetry event naming
every resolved knob's value and source.
"""

from __future__ import annotations

import os

from ..runtime import telemetry as _telemetry

_PROFILE_TODO = (
    "is not ported yet (ROADMAP queue 1, item 13: tuning profiles)"
)


def _parse_bool(raw: str):
    return raw not in ("", "0")


def _parse_lane(raw: str) -> str:
    if raw not in ("ring", "voronoi"):
        raise ValueError(f"knn lane must be 'ring' or 'voronoi', got {raw!r}")
    return raw


#: knob -> (env reader, parser); the readers keep each name as a literal
#: ``os.environ.get`` call, so a scan of the source sees every spelling
_ENV = {
    "probe": (lambda: os.environ.get("MOSAIC_TUNE_PROBE"), str),
    "lookup": (lambda: os.environ.get("MOSAIC_TUNE_LOOKUP"), str),
    "knn_lane": (lambda: os.environ.get("MOSAIC_TUNE_KNN_LANE"), _parse_lane),
    "stream_window": (lambda: os.environ.get("MOSAIC_STREAM_WINDOW"), int),
    "epoch_log_max": (lambda: os.environ.get("MOSAIC_EPOCH_LOG_MAX"), int),
    "stream_pipeline": (
        lambda: os.environ.get("MOSAIC_STREAM_PIPELINE"), _parse_bool,
    ),
}

KNOBS = tuple(sorted(_ENV))


def _env_value(name: str):
    """The env layer's parsed value for one knob, or None when unset."""
    read, parse = _ENV[name]
    raw = read()
    if raw is None or raw == "":
        return None
    try:
        return parse(raw)
    except (TypeError, ValueError) as exc:
        raise ValueError(
            f"malformed env value for tune knob {name!r}: {raw!r}"
        ) from exc


def _check_profile(entry: str, profile) -> None:
    if profile is not None:
        raise NotImplementedError(f"{entry}(profile=...) {_PROFILE_TODO}")


def resolve_knob(name: str, explicit, profile, default):
    """One knob through the precedence chain; returns ``(value, source)``
    with source in ``explicit|env|default``. ``explicit=None`` means "the
    caller did not pass it"."""
    if name not in KNOBS:
        raise KeyError(f"unknown tune knob {name!r} (expected one of {KNOBS})")
    _check_profile("resolve_knob", profile)
    if explicit is not None:
        return explicit, "explicit"
    env = _env_value(name)
    if env is not None:
        return env, "env"
    return default, "default"


def resolve_knobs(entry: str, profile, *, explicit: dict, defaults: dict) -> dict:
    """Resolve every knob in ``defaults`` for one frontend entry point and
    record the single summarizing ``tune_resolve`` telemetry event.
    Returns ``{knob: value}``."""
    _check_profile(entry, profile)
    values, sources = {}, {}
    for name, default in defaults.items():
        values[name], sources[name] = resolve_knob(
            name, explicit.get(name), None, default
        )
    _telemetry.record(
        "tune_resolve",
        entry=entry,
        profiled=False,
        **{f"{k}_source": s for k, s in sources.items()},
        **{
            k: (v if isinstance(v, (int, float, bool, str, type(None))) else repr(v))
            for k, v in values.items()
        },
    )
    return values
