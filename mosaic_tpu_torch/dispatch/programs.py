"""The program store: compiled programs as durable artifacts.

Port of ``mosaic_tpu/dispatch/programs.py``. A relaunched server loads
its warmed ladder from the store instead of compiling it. The port's
compiled programs are its nvcc-built kernel libraries
(`kernels/_build.py`, named by a hash of the source and the flags); the
per-rung programs around them are eager torch, which compile nothing. So
the store keeps, with the reference's file format, keys, events and
refusals:

- one **library entry** per kernel library: the shared object's bytes,
  keyed by its name, its source-and-flags hash and the environment
  fingerprint, never by an index, and with no epoch in its meta, so one
  entry serves every index and `ProgramStore.gc_superseded` leaves it
  alone. Loading one writes the library where `kernels/_build.py` looks
  for it (temp file, then ``os.replace``) and binds it: a relaunch on a
  machine without the CUDA toolkit launches the kernels it stored;
- per ladder rung, the reference's two **program entries**, ``cells``
  and ``join``, keyed by `program_key` over the index's restart-stable
  identity (`runtime.checkpoint.index_identity`) and the rung's statics
  (`core_program_statics`). Their payload is a JSON manifest: the kind,
  the statics, and the name and source hash of each library the program
  launches (``pip`` for a ``join`` whose probe reaches
  ``pip_heavy_tiled``). A manifest whose statics or libraries differ from
  the live program's is a refusal (:class:`ProgramStoreCorrupt`).

The store's discipline is the reference's: one program is one
``prog-<key>.bin`` payload and one ``prog-<key>.json`` sidecar (format
``version``, ``key``, the payload's ``sha256``, the environment
fingerprint ``env``, the exporting process's ``incarnation`` and
``meta``), each written temp-first and ``os.replace``\\ d, payload BEFORE
sidecar, so a kill mid-export leaves an orphaned payload (a clean miss),
never half a program under a valid name. A damaged entry raises
:class:`ProgramStoreCorrupt`, one built under another environment
:class:`ProgramFingerprintMismatch`; both are refusals the caller answers
by taking the nvcc path and exporting again, so the store heals itself.
Nothing ever falls back to a plain torch version of a kernel.

CUDA graphs cannot be serialized: a store-warmed core still captures one
graph per rung at warmup (`dispatch/core.py DispatchCore._graph_run`).

Knob: ``MOSAIC_PROGRAM_STORE`` names the store directory (an explicit
``program_store=`` argument beats it).
"""

from __future__ import annotations

import hashlib
import json
import os

from ..runtime import telemetry as _telemetry
from ..runtime.errors import MosaicRuntimeError

VERSION = 1


class ProgramStoreCorrupt(MosaicRuntimeError):
    """A persisted program failed validation (unparseable sidecar,
    unknown format version, payload checksum mismatch, a manifest that is
    not the live program's, a library that does not bind). The caller
    falls back to the nvcc path; the next export heals the entry."""


class ProgramFingerprintMismatch(MosaicRuntimeError):
    """The persisted program was built under a DIFFERENT environment
    fingerprint (torch or CUDA version, platform, card, compute
    capability, device count): loading it could run a wrong or crashing
    program, so this is a refusal. Fall back to the nvcc path and
    re-export."""


def backend_fingerprint() -> dict:
    """The environment a stored program binds to: the torch and CUDA
    versions, the platform (``"gpu"`` or ``"cpu"``), the card's name and
    compute capability, and the device count. Any difference refuses the
    entry."""
    import torch

    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(0),
            "capability": f"{major}.{minor}",
            "device_count": torch.cuda.device_count(),
        }
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": "cpu",
        "device_kind": "cpu",
        "capability": None,
        "device_count": 1,
    }


def program_key(index_fingerprint: str, kind: str, **statics) -> str:
    """Stable content key for one program: sha256 over the canonical
    JSON of the tessellation fingerprint, the program kind (``cells`` /
    ``join``), and every static argument — the reference's key, so both
    packages give the same key for the same inputs."""
    body = {
        "index": index_fingerprint,
        "kind": kind,
        "statics": {k: statics[k] for k in sorted(statics)},
    }
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=str).encode()
    ).hexdigest()[:32]


def resolve_program_store(program_store):
    """Host-side resolution of the store argument: an explicit
    :class:`ProgramStore` or path wins; otherwise the
    ``MOSAIC_PROGRAM_STORE`` env knob; otherwise None (no store)."""
    if program_store is None:
        raw = os.environ.get("MOSAIC_PROGRAM_STORE", "").strip()
        if not raw:
            return None
        return ProgramStore(raw)
    if isinstance(program_store, ProgramStore):
        return program_store
    return ProgramStore(str(program_store))


class ProgramStore:
    """Stored programs under one directory (conventionally next to the
    index artifacts and tune profiles)."""

    def __init__(self, root: str):
        self.root = str(root)

    def _paths(self, key: str) -> tuple[str, str]:
        base = os.path.join(self.root, f"prog-{key}")
        return base + ".bin", base + ".json"

    def keys(self) -> list[str]:
        """Persisted program keys (validity unchecked): sidecar-backed
        entries only — an orphaned payload is a kill-mid-export remnant,
        not a program."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        return sorted(
            n[len("prog-"):-len(".json")]
            for n in names
            if n.startswith("prog-") and n.endswith(".json")
        )

    def save(self, key: str, payload: bytes, meta: dict | None = None) -> str:
        """Persist one program; returns the sidecar path.

        Atomic per file, payload FIRST: a sidecar's existence implies a
        complete payload was on disk at write time (the ordering
        `runtime/checkpoint.py` uses for its npz + json pair)."""
        os.makedirs(self.root, exist_ok=True)
        bin_path, json_path = self._paths(key)
        tmp = bin_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, bin_path)
        sidecar = {
            "version": VERSION,
            "key": key,
            "sha256": hashlib.sha256(payload).hexdigest(),
            "env": backend_fingerprint(),
            # which process exported this program: fleet_report joins
            # sidecars to trails by this id across a restart storm
            "incarnation": _telemetry.INCARNATION,
            "meta": meta or {},
        }
        tmp = json_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sidecar, f, sort_keys=True, indent=1)
        os.replace(tmp, json_path)
        _telemetry.record(
            "program_store_saved", root=self.root, key=key,
            nbytes=len(payload), **_flat_meta(meta),
        )
        return json_path

    def load(self, key: str) -> "bytes | None":
        """The payload for ``key``, or None on a clean miss (no sidecar,
        including the orphaned-payload state a kill mid-export leaves).

        Raises :class:`ProgramFingerprintMismatch` when the entry was
        built under a different environment fingerprint, and
        :class:`ProgramStoreCorrupt` when the sidecar or payload fails
        validation — both after recording the typed telemetry event."""
        bin_path, json_path = self._paths(key)
        try:
            with open(json_path) as f:
                sidecar = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            self._corrupt(key, f"unreadable sidecar: {e!r}")
        if sidecar.get("version") != VERSION:
            self._corrupt(
                key, f"unknown format version {sidecar.get('version')!r}"
            )
        env = backend_fingerprint()
        if sidecar.get("env") != env:
            _telemetry.record(
                "program_store_mismatch", root=self.root, key=key,
                stored=json.dumps(sidecar.get("env"), sort_keys=True),
                current=json.dumps(env, sort_keys=True),
            )
            raise ProgramFingerprintMismatch(
                f"program {key} under {self.root!r} was built for "
                f"{sidecar.get('env')!r}, not the current environment "
                f"{env!r} — falling back to the nvcc path"
            )
        try:
            with open(bin_path, "rb") as f:
                payload = f.read()
        except OSError as e:
            self._corrupt(key, f"unreadable payload: {e!r}")
        if hashlib.sha256(payload).hexdigest() != sidecar.get("sha256"):
            self._corrupt(key, "payload checksum mismatch")
        _telemetry.record(
            "program_store_loaded", root=self.root, key=key,
            nbytes=len(payload),
        )
        return payload

    def gc_superseded(self, series: str, keep_epoch: int) -> int:
        """Drop every entry persisted for an EARLIER epoch of the same
        index series (sidecar meta ``index_series``/``index_epoch``,
        stamped by the dispatch core when its index carries an epoch).

        Superseded entries can never be loaded again (the epoch token is
        part of their key). Entries from other series, from the current
        (or a newer) epoch, or without epoch provenance — kernel
        libraries among them — are untouched. The sidecar is unlinked
        FIRST, so a kill mid-GC leaves an orphaned payload (a miss),
        never a sidecar pointing at nothing."""
        removed = 0
        for key in self.keys():
            bin_path, json_path = self._paths(key)
            try:
                with open(json_path) as f:
                    sidecar = json.load(f)
            except (OSError, ValueError):
                continue  # unreadable entries are load's problem, not GC's
            meta = sidecar.get("meta") or {}
            if meta.get("index_series") != series:
                continue
            try:
                entry_epoch = int(meta["index_epoch"])
            except (KeyError, TypeError, ValueError):
                continue
            if entry_epoch >= int(keep_epoch):
                continue
            for path in (json_path, bin_path):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
            removed += 1
        if removed:
            _telemetry.record(
                "program_store_gc", root=self.root, series=series[:16],
                keep_epoch=int(keep_epoch), removed=removed,
            )
        return removed

    def _corrupt(self, key: str, why: str):
        _telemetry.record(
            "program_store_corrupt_skipped", root=self.root, key=key,
            error=why[:200],
        )
        raise ProgramStoreCorrupt(
            f"program {key} under {self.root!r} failed validation "
            f"({why}) — falling back to the nvcc path"
        )


def _flat_meta(meta: dict | None) -> dict:
    out = {}
    for k, v in (meta or {}).items():
        if isinstance(v, (int, float, bool, str, type(None))):
            out[f"meta_{k}"] = v
    return out


# ------------------------------------------------------ kernel libraries

def serialize_compiled(name: str) -> bytes:
    """The bytes of the built kernel library ``name`` (the shared object
    nvcc wrote, or the one a store bound)."""
    from ..kernels import _build

    return _build.library_bytes(name)


def deserialize_compiled(payload: bytes, name: str):
    """Write ``payload`` to the kernel library ``name``'s path (temp file,
    then ``os.replace``) and bind it; returns the bound library. A payload
    that does not load as a shared object, or lacks an entry point of
    ``SIGNATURES[name]``, raises :class:`ProgramStoreCorrupt`."""
    from ..kernels import _build

    try:
        return _build.bind_payload(name, payload)
    except (OSError, AttributeError, ValueError) as e:
        raise ProgramStoreCorrupt(
            f"kernel library {name!r} from the store does not bind: {e!r}"
        ) from e


def library_key(name: str) -> str:
    """The store key of kernel library ``name``: its name, its source and
    flags hash and the environment fingerprint — no index."""
    from ..kernels import _build

    return program_key(
        _build.source_hash(name), "library", name=name, **backend_fingerprint()
    )


def bind_library(store: ProgramStore, name: str, stats: dict) -> None:
    """Bind kernel library ``name`` from ``store``, or else take the nvcc
    path (`kernels._build.load`: bound already, on disk, or built) and
    export it. ``stats["loaded"]`` or ``stats["exported"]`` counts the
    entry. A refused entry is recorded by its typed event and exported
    again."""
    from ..kernels import _build

    key = library_key(name)
    try:
        payload = store.load(key)
    except (ProgramStoreCorrupt, ProgramFingerprintMismatch):
        payload = None  # typed telemetry already recorded by the store
    if payload is not None:
        try:
            deserialize_compiled(payload, name)
            stats["loaded"] += 1
            return
        except ProgramStoreCorrupt as e:
            _telemetry.record(
                "program_store_corrupt_skipped", root=store.root, key=key,
                error=str(e)[:200],
            )
    _build.load(name)
    store.save(key, serialize_compiled(name), meta={"kind": "library", "library": name})
    stats["exported"] += 1


# ------------------------------------------------------ program manifests

def manifest(kind: str, statics: dict, libraries=()) -> dict:
    """A program entry's payload: its kind, its statics and the kernel
    libraries it launches, each with its source and flags hash."""
    from ..kernels import _build

    return {
        "kind": kind,
        "statics": statics,
        "libraries": [
            {"name": n, "source": _build.source_hash(n)} for n in libraries
        ],
    }


def _encode(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, default=str).encode()


def one_program(store: ProgramStore, key: str, doc: dict, meta: dict,
                stats: dict, bind) -> dict:
    """Load one program's manifest from ``store`` or export it. The
    libraries it names are bound first (``bind(name)``), so an exported
    manifest never names a library the store lacks. A stored manifest
    that is not ``doc`` is a refusal (``program_store_corrupt_skipped``)
    and is exported again, as a corrupt or mismatched entry is."""
    for lib in doc["libraries"]:
        bind(lib["name"])
    try:
        payload = store.load(key)
        if payload is not None and payload != _encode(doc):
            store._corrupt(key, "manifest is not the live program's")
    except (ProgramStoreCorrupt, ProgramFingerprintMismatch):
        payload = None  # typed telemetry already recorded by the store
    if payload is not None:
        stats["loaded"] += 1
        return doc
    store.save(key, _encode(doc), meta=meta)
    stats["exported"] += 1
    return doc


def core_program_statics(core, bucket: int, kind: str) -> dict:
    """The restart-stable static identity of one of a
    :class:`~mosaic_tpu_torch.dispatch.core.DispatchCore`'s per-bucket
    programs — everything `dispatch_signature` keys on, with the
    process-local ``id(index)`` replaced by the tessellation fingerprint
    (done by the caller) and the dtypes pinned: the reference's fields."""
    fcap, hcap, ccap = core.caps(bucket)
    statics = {
        "bucket": int(bucket),
        "resolution": core.resolution,
        "dtype": str(core._dtype).removeprefix("torch."),
        "cell_dtype": str(core.cell_dtype) if core.cell_dtype else None,
    }
    if kind == "join":
        statics.update(
            writeback=core.writeback, lookup=core.lookup, probe=core.probe,
            found_cap=fcap, heavy_cap=hcap, convex_cap=ccap,
        )
    return statics
