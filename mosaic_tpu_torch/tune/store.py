"""Versioned, checksummed `TuningProfile` persistence.

Port of ``mosaic_tpu/tune/store.py``, format v1 byte for byte: a store
either package writes loads in the other, and :func:`index_fingerprint`
of an index on the card equals that of its CPU copy and of the
reference's index over the same tessellation (the cell column is int64
in all three).

A profile lives NEXT TO the index artifacts it was tuned for — the pair
ships together, the pair hot-swaps together. The store is the
`runtime/checkpoint` discipline applied to a JSON document:

- one version = one ``profile-vNNNN.json`` written temp-first and
  ``os.replace``\\ d, with the payload's SHA-256 embedded over the
  canonical (sorted-keys) body — a kill mid-write leaves an orphaned temp
  file, never a half-written profile under the real name;
- :meth:`ProfileStore.load_latest` walks versions newest-first and skips
  corrupt entries with ``tune_profile_corrupt_skipped`` telemetry (same
  newest-valid-wins as snapshot resume); when EVERY version is damaged it
  raises the typed :class:`ProfileStoreCorrupt`;
- each profile records the **tessellation fingerprint** of the index it
  was tuned against (`runtime.checkpoint.fingerprint` over the sorted
  cell ids). Loading against a different index raises the typed
  :class:`ProfileFingerprintMismatch` — applying a profile tuned for
  another tessellation would silently mis-tune, so it is a refusal, not
  a skip.

Format (v1): ``{"version": 1, "profile_version": N, "sha256": hex,
"fingerprint": hex|None, "profile": TuningProfile.as_dict()}``. Readers
must reject a ``version`` they don't know.
"""

from __future__ import annotations

import hashlib
import json
import os
import re

from ..runtime import checkpoint as _checkpoint
from ..runtime import telemetry as _telemetry
from ..runtime.errors import MosaicRuntimeError
from .recommend import TuningProfile

VERSION = 1
_PROFILE_RE = re.compile(r"^profile-v(\d{4})\.json$")


class ProfileStoreCorrupt(MosaicRuntimeError):
    """Every persisted profile version failed validation — the store
    cannot produce a profile. Rebuild with :meth:`ProfileStore.save`."""


class ProfileFingerprintMismatch(MosaicRuntimeError):
    """The newest valid profile was tuned for a DIFFERENT tessellation
    than the index being served — refusing to apply it. Re-profile the
    workload against the current index (or pass the matching index)."""


def index_fingerprint(chip_index) -> str:
    """The tessellation identity a profile binds to: the checkpoint
    fingerprint of the index's sorted cell-id column (resolution and
    geometry changes both change it)."""
    return _checkpoint.fingerprint(_checkpoint.host_array(chip_index.cells))


def _body_sha256(payload: dict) -> str:
    body = {k: v for k, v in payload.items() if k != "sha256"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()
    ).hexdigest()


class ProfileStore:
    """Profile versions under one directory (conventionally the index
    artifact directory)."""

    def __init__(self, root: str):
        self.root = str(root)

    def _path(self, version: int) -> str:
        return os.path.join(self.root, f"profile-v{version:04d}.json")

    def versions(self) -> list[int]:
        """Persisted profile versions, ascending (validity unchecked)."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return sorted(
            int(m.group(1))
            for m in (_PROFILE_RE.match(n) for n in names)
            if m
        )

    def save(
        self,
        profile: TuningProfile,
        *,
        fingerprint: "str | None" = None,
    ) -> str:
        """Persist ``profile`` as the next version; returns the path.
        ``fingerprint`` (from :func:`index_fingerprint`) binds the profile
        to its tessellation — pass it whenever the profile was tuned
        against a concrete index."""
        os.makedirs(self.root, exist_ok=True)
        version = (self.versions() or [0])[-1] + 1
        payload = {
            "version": VERSION,
            "profile_version": version,
            "fingerprint": fingerprint,
            "profile": profile.as_dict(),
        }
        payload["sha256"] = _body_sha256(payload)
        path = self._path(version)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True, indent=1)
        os.replace(tmp, path)
        _telemetry.record(
            "tune_profile_saved", root=self.root, profile_version=version,
            sha256=payload["sha256"][:12], fingerprint=(fingerprint or "")[:12],
        )
        return path

    def load_latest(
        self,
        *,
        expect_fingerprint: "str | None" = None,
    ) -> tuple[TuningProfile, dict]:
        """(profile, payload) of the newest VALID version.

        Corrupt versions (unparseable, unknown format version, checksum
        mismatch) are skipped with ``tune_profile_corrupt_skipped``
        telemetry; if nothing survives, :class:`ProfileStoreCorrupt`.
        When ``expect_fingerprint`` is given and the newest valid
        profile's recorded fingerprint differs,
        :class:`ProfileFingerprintMismatch` — a refusal, never a silent
        fallback to an older (potentially matching) version: versions are
        a history of ONE index's tuning, not a pool of candidates."""
        versions = self.versions()
        if not versions:
            raise ProfileStoreCorrupt(
                f"no tuning profile under {self.root!r} — save one with "
                f"ProfileStore.save"
            )
        for version in reversed(versions):
            path = self._path(version)
            try:
                with open(path) as f:
                    payload = json.load(f)
                if payload.get("version") != VERSION:
                    raise ValueError(
                        f"unknown profile format version "
                        f"{payload.get('version')!r}"
                    )
                if _body_sha256(payload) != payload.get("sha256"):
                    raise ValueError("content hash mismatch")
                profile = TuningProfile.from_dict(payload["profile"])
            except (OSError, ValueError, KeyError, TypeError) as e:
                _telemetry.record(
                    "tune_profile_corrupt_skipped", root=self.root,
                    profile_version=version, error=repr(e)[:200],
                )
                continue
            if (
                expect_fingerprint is not None
                and payload.get("fingerprint") != expect_fingerprint
            ):
                raise ProfileFingerprintMismatch(
                    f"profile v{version} under {self.root!r} was tuned for "
                    f"tessellation {str(payload.get('fingerprint'))[:12]}…, "
                    f"not the index being served "
                    f"({expect_fingerprint[:12]}…) — re-profile against "
                    f"the current index"
                )
            _telemetry.record(
                "tune_profile_loaded", root=self.root,
                profile_version=version,
            )
            return profile, payload
        raise ProfileStoreCorrupt(
            f"all {len(versions)} profile version(s) under {self.root!r} "
            f"failed validation — every candidate was skipped as corrupt"
        )
