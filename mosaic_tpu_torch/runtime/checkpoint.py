"""Checksummed snapshot store for resumable streaming runs.

Port of ``mosaic_tpu/runtime/checkpoint.py``, with the same on-disk
layout, so a run directory written by either package is readable by the
other. The port hashes host numpy bytes: a tensor goes through
``.cpu().numpy()`` first, so a ring or an index on the card fingerprints
exactly as the same values in numpy (or in the reference's arrays) do.

A durable stream (``sql/stream.py`` ``run_durable``) periodically pulls
its scan carry to the host — fold accumulators, ring cursor, prefetched
cell ids, generator key — and persists it here so a device loss after
batch 900k of a 1M-batch run costs one segment, not the run. The store
is deliberately boring:

- one snapshot = one ``snap-<step>.npz`` (the arrays) plus one
  ``snap-<step>.json`` sidecar carrying the run metadata and the npz
  file's SHA-256. Both are written to a temp name and ``os.replace``\\ d,
  so a kill mid-write leaves a missing/orphaned temp file, never a
  half-written snapshot under the real name;
- :func:`load_latest` walks snapshots newest-first, re-hashes each npz
  against its sidecar and silently skips corrupt or truncated ones
  (emitting ``snapshot_corrupt_skipped`` telemetry) — the last VALID
  snapshot wins;
- metadata mismatches (different ring fingerprint, batch shape, or
  total batch count) are the caller's contract to enforce via ``meta``.

Format note (v1): the npz holds
exactly the scan carry arrays the stream needs; the sidecar is
``{"version": 1, "step": int, "sha256": hex, "meta": {...}}``. Forward
compatibility: readers must reject a ``version`` they don't know.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time

import numpy as np
import torch

from . import telemetry

VERSION = 1
_SNAP_RE = re.compile(r"^snap-(\d{8})\.json$")


def _snap_paths(run_dir: str, step: int) -> tuple[str, str]:
    base = os.path.join(run_dir, f"snap-{step:08d}")
    return base + ".npz", base + ".json"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_snapshot(
    run_dir: str,
    step: int,
    arrays: dict[str, np.ndarray],
    meta: dict | None = None,
) -> str:
    """Persist one snapshot; returns the npz path.

    ``step`` is the ring-cursor of the NEXT batch to run (everything
    below it is folded into the saved accumulators). Atomic per file:
    temp-write + ``os.replace``; the sidecar (with the content hash)
    lands only after the npz, so a sidecar's existence implies a
    complete npz was on disk at write time.
    """
    t0 = time.perf_counter()
    os.makedirs(run_dir, exist_ok=True)
    npz_path, json_path = _snap_paths(run_dir, step)
    tmp_npz = npz_path + ".tmp"
    with open(tmp_npz, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp_npz, npz_path)
    digest = _sha256_file(npz_path)
    sidecar = {
        "version": VERSION,
        "step": int(step),
        "sha256": digest,
        # which process wrote this snapshot — fleet_report joins
        # sidecars to trails by this id when stitching a restart storm
        "incarnation": telemetry.INCARNATION,
        "meta": dict(meta or {}),
    }
    tmp_json = json_path + ".tmp"
    with open(tmp_json, "w") as f:
        json.dump(sidecar, f, sort_keys=True)
    os.replace(tmp_json, json_path)
    telemetry.record(
        "snapshot_saved", run_dir=run_dir, step=int(step),
        bytes=os.path.getsize(npz_path), sha256=digest[:12],
        seconds=round(time.perf_counter() - t0, 6),
    )
    return npz_path


def list_snapshots(run_dir: str) -> list[int]:
    """Steps with a sidecar on disk, ascending (validity not checked)."""
    try:
        names = os.listdir(run_dir)
    except FileNotFoundError:
        return []
    steps = []
    for n in names:
        m = _SNAP_RE.match(n)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def load_latest(
    run_dir: str,
) -> tuple[int, dict[str, np.ndarray], dict] | None:
    """(step, arrays, meta) of the newest VALID snapshot, or None.

    Walks newest-first; a snapshot is valid when its sidecar parses,
    carries a known version, and the npz re-hashes to the recorded
    SHA-256. Anything else (truncated npz from a kill mid-write, bit
    rot, an injected ``stream.snapshot`` corruption) is skipped with a
    ``snapshot_corrupt_skipped`` event — resume falls back to the
    previous boundary rather than failing the run.
    """
    for step in reversed(list_snapshots(run_dir)):
        npz_path, json_path = _snap_paths(run_dir, step)
        try:
            with open(json_path) as f:
                sidecar = json.load(f)
            if sidecar.get("version") != VERSION:
                raise ValueError(
                    f"unknown snapshot version {sidecar.get('version')!r}"
                )
            if _sha256_file(npz_path) != sidecar["sha256"]:
                raise ValueError("content hash mismatch")
            with np.load(npz_path) as z:
                arrays = {k: np.array(z[k]) for k in z.files}
        except Exception as e:  # lint: broad-except-ok (any damage means skip; emits snapshot_corrupt_skipped)
            telemetry.record(
                "snapshot_corrupt_skipped", run_dir=run_dir, step=step,
                error=repr(e)[:200],
            )
            continue
        telemetry.record(
            "snapshot_resumed", run_dir=run_dir, step=step,
        )
        return int(sidecar["step"]), arrays, dict(sidecar.get("meta", {}))
    return None


def host_array(array) -> np.ndarray:
    """A numpy view of ``array``: a tensor (on any device) goes through
    ``.cpu().numpy()``."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def fingerprint(array) -> str:
    """SHA-256 over an array's bytes + shape + dtype — the ring identity
    a resume validates against (resuming against a different ring would
    silently produce garbage stats). A tensor hashes as its host copy."""
    a = host_array(array)
    h = hashlib.sha256()
    h.update(str((a.shape, str(a.dtype))).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def index_identity(index) -> str:
    """Restart-stable identity of one device join index.

    The fingerprint of the index's cells array, with its
    ``epoch_token`` attribute folded in when it has one (an index that
    `index/epoch.py EpochalIndex.publish` built carries one: its epochs
    can share a cell set while their edge tables differ). A build-once
    index keeps the bare cells fingerprint, the same in both packages.
    """
    fp = fingerprint(index.cells)
    token = getattr(index, "epoch_token", None)
    return f"{fp}@{token}" if token else fp
