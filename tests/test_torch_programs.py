"""The port's program store (`mosaic_tpu_torch/dispatch/programs.py`).

Mirrors `tests/test_programs.py` case for case on its fixture (the custom
grid `GridConf(-180, 180, -90, 90, 2, 10, 10)` at resolution 3, its three
zones, a 64-256 ladder: 3 rungs x 2 programs = 6 entries):

- **Store discipline**: payload-first atomic writes, clean misses for an
  absent entry and an orphaned payload, typed refusals (checksum, sidecar,
  version, environment fingerprint) with their events;
- **Core AOT**: a second core on the same store and index loads every
  entry, exports none and answers bit for bit the reference's plain
  `pip_join`; corrupt, mismatched and orphaned entries fall back and are
  exported again; no store, no AOT;
- **Epochs**: a new epoch never loads a stale entry and warmup drops the
  superseded ones; the same epoch reloads stably; GC spares other series,
  unstamped entries and kernel-library entries.

Beyond the reference's file: both packages give the same key for the
same inputs, and each refuses the other's entries (their environment
fingerprints differ); kernel-library entries round trip through a
stand-in shared object under a temporary build directory; `ServeEngine`,
`ServeRouter` and `KNNFrontend` bind the store; meshed cores and
frontends refuse it. The `gpu` cases store the real ``pip`` library and
bind it in a process that has neither a build directory nor nvcc.

The reference is imported inside the `ref` fixture only, so the `gpu`
cases run on a machine without JAX (``--noconftest -m gpu``).
"""

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mosaic_tpu_torch.core.geometry import wkt
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.dispatch import (
    BucketLadder,
    DispatchCore,
    ProgramFingerprintMismatch,
    ProgramStore,
    ProgramStoreCorrupt,
    backend_fingerprint,
    data_mesh,
    program_key,
    resolve_program_store,
)
from mosaic_tpu_torch.dispatch import programs
from mosaic_tpu_torch.kernels import _build
from mosaic_tpu_torch.runtime import checkpoint, telemetry
from mosaic_tpu_torch.sql.join import build_chip_index

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
BBOX = (-25.0, -25.0, 35.0, 20.0)
RES = 3
ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))",
    "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
    "POLYGON ((20 -10, 30 -10, 30 5, 20 5, 20 -10))",
]
#: zone 0 with one vertex nudged INSIDE its cells: the covered cell set is
#: unchanged, the chip geometry is not
ZONE0_NUDGED = "POLYGON ((1 1, 13 2.001, 12 11, 6 14, 2 9, 1 1))"
LADDER = BucketLadder(64, 256)  # 3 rungs x 2 programs = 6 store entries
FP_KEYS = {"torch", "cuda", "platform", "device_kind", "capability", "device_count"}


@pytest.fixture(scope="module")
def grid():
    return CustomIndexSystem(GridConf(*CONF))


@pytest.fixture(scope="module")
def index(grid):
    return build_chip_index(
        tessellate(wkt.from_wkt(ZONES), grid, RES, keep_core_geoms=False),
        device="cpu",
    )


@pytest.fixture(scope="module")
def ref():
    """The reference's store, core, index and plain join (JAX)."""
    from mosaic_tpu import dispatch as rd
    from mosaic_tpu.core.geometry import wkt as rwkt
    from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
    from mosaic_tpu.core.index import GridConf as RefConf
    from mosaic_tpu.core.tessellate import tessellate as rtess
    from mosaic_tpu.dispatch import programs as rp
    from mosaic_tpu.runtime import checkpoint as rcheck
    from mosaic_tpu.sql import join as rj

    rgrid = RefCustom(RefConf(*CONF))
    rindex = rj.build_chip_index(
        rtess(rwkt.from_wkt(ZONES), rgrid, RES, keep_core_geoms=False))
    return types.SimpleNamespace(
        dispatch=rd, programs=rp, checkpoint=rcheck, grid=rgrid, index=rindex,
        join=lambda pts: np.asarray(rj.pip_join(
            pts, None, rgrid, RES, chip_index=rindex, recheck=False)),
    )


@pytest.fixture()
def pts():
    rng = np.random.default_rng(11)
    return rng.uniform(BBOX[:2], BBOX[2:], (100, 2))


def make_core(index, grid, store, **kw):
    """A core computing cells in f64, as the reference's `pip_join` does
    under x64, so its rows are the reference's bit for bit."""
    return DispatchCore(index, grid, RES, ladder=LADDER, program_store=store,
                        cell_dtype=torch.float64, **kw)


def run_core(core, pts):
    padded, n = core.ladder.pad(pts)
    return np.asarray(core.execute_padded(padded))[:n]


def event_names(events) -> list:
    return [e.get("event") for e in events]


# ---------------------------------------------------------------- store

class TestStoreDiscipline:
    def test_roundtrip_and_keys(self, tmp_path):
        store = ProgramStore(str(tmp_path))
        store.save("abc123", b"payload-bytes", meta={"kind": "cells"})
        assert store.load("abc123") == b"payload-bytes"
        assert store.keys() == ["abc123"]

    def test_missing_is_clean_miss(self, tmp_path):
        assert ProgramStore(str(tmp_path)).load("nope") is None
        assert ProgramStore(str(tmp_path / "absent")).keys() == []

    def test_orphan_payload_is_clean_miss(self, tmp_path):
        """A payload without its sidecar is the kill-mid-export remnant:
        invisible to keys() and a miss on load."""
        store = ProgramStore(str(tmp_path))
        (tmp_path / "prog-dead.bin").write_bytes(b"partial")
        assert store.load("dead") is None
        assert store.keys() == []

    def test_no_temp_files_survive_save(self, tmp_path):
        store = ProgramStore(str(tmp_path))
        store.save("k", b"x" * 64)
        assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]

    def test_corrupt_payload_typed_refusal(self, tmp_path):
        store = ProgramStore(str(tmp_path))
        store.save("k", b"payload")
        (tmp_path / "prog-k.bin").write_bytes(b"tampered")
        with telemetry.capture() as events:
            with pytest.raises(ProgramStoreCorrupt, match="checksum"):
                store.load("k")
        assert "program_store_corrupt_skipped" in event_names(events)

    def test_corrupt_sidecar_typed_refusal(self, tmp_path):
        store = ProgramStore(str(tmp_path))
        store.save("k", b"payload")
        (tmp_path / "prog-k.json").write_text("{not json")
        with pytest.raises(ProgramStoreCorrupt, match="sidecar"):
            store.load("k")

    def test_unknown_version_typed_refusal(self, tmp_path):
        store = ProgramStore(str(tmp_path))
        path = tmp_path / "prog-k.json"
        store.save("k", b"payload")
        sidecar = json.loads(path.read_text())
        sidecar["version"] = 999
        path.write_text(json.dumps(sidecar))
        with pytest.raises(ProgramStoreCorrupt, match="version"):
            store.load("k")

    def test_env_fingerprint_mismatch_typed_refusal(self, tmp_path):
        store = ProgramStore(str(tmp_path))
        path = tmp_path / "prog-k.json"
        store.save("k", b"payload")
        sidecar = json.loads(path.read_text())
        sidecar["env"]["torch"] = "0.0.0-other"
        path.write_text(json.dumps(sidecar))
        with telemetry.capture() as events:
            with pytest.raises(ProgramFingerprintMismatch):
                store.load("k")
        assert "program_store_mismatch" in event_names(events)

    def test_program_key_separates_statics(self):
        a = program_key("fp", "join", bucket=64, probe="scatter")
        b = program_key("fp", "join", bucket=128, probe="scatter")
        c = program_key("fp", "cells", bucket=64, probe="scatter")
        d = program_key("fp2", "join", bucket=64, probe="scatter")
        assert len({a, b, c, d}) == 4
        assert a == program_key("fp", "join", probe="scatter", bucket=64)

    def test_backend_fingerprint_shape(self):
        fp = backend_fingerprint()
        assert set(fp) == FP_KEYS
        assert fp["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
        assert fp["torch"] == torch.__version__

    def test_resolve_precedence(self, tmp_path, monkeypatch):
        explicit = ProgramStore(str(tmp_path))
        assert resolve_program_store(explicit) is explicit
        assert resolve_program_store(str(tmp_path)).root == str(tmp_path)
        monkeypatch.setenv("MOSAIC_PROGRAM_STORE", str(tmp_path / "env"))
        assert resolve_program_store(None).root == str(tmp_path / "env")
        monkeypatch.setenv("MOSAIC_PROGRAM_STORE", "")
        assert resolve_program_store(None) is None


# ------------------------------------------------------------- core AOT

class TestCoreAOT:
    def test_export_then_reload_bit_identical(self, index, grid, ref, tmp_path, pts):
        """The first core exports every rung; a second core warms purely by
        loading, builds nothing, and both answer the reference's plain
        `pip_join` bit for bit."""
        store = str(tmp_path)
        c1 = make_core(index, grid, store)
        w1 = c1.warmup()
        assert w1["aot"] == {"loaded": 0, "exported": 6, "fallback": 0}
        assert len(ProgramStore(store).keys()) == 6

        c2 = make_core(index, grid, store)
        w2 = c2.warmup()
        assert w2["aot"] == {"loaded": 6, "exported": 0, "fallback": 0}
        assert w2["backend_compiles"] == 0 and c2.cold_compiles == 0

        want = ref.join(pts)
        np.testing.assert_array_equal(run_core(c1, pts), want)
        np.testing.assert_array_equal(run_core(c2, pts), want)

    def test_corrupt_entry_self_heals(self, index, grid, ref, tmp_path, pts):
        """One flipped payload byte: the next core records the typed skip,
        exports that entry again, and the store is clean again."""
        store = str(tmp_path)
        make_core(index, grid, store).warmup()
        victim = sorted(tmp_path.glob("prog-*.bin"))[0]
        blob = bytearray(victim.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        victim.write_bytes(bytes(blob))

        with telemetry.capture() as events:
            c = make_core(index, grid, store)
            w = c.warmup()
        assert w["aot"]["loaded"] == 5 and w["aot"]["exported"] == 1
        assert "program_store_corrupt_skipped" in event_names(events)
        np.testing.assert_array_equal(run_core(c, pts), ref.join(pts))

        healed = make_core(index, grid, store).warmup()
        assert healed["aot"] == {"loaded": 6, "exported": 0, "fallback": 0}

    def test_fingerprint_mismatch_falls_back(self, index, grid, ref, tmp_path, pts):
        """A sidecar stamped with a foreign environment is refused and
        replaced by a fresh export."""
        store = str(tmp_path)
        make_core(index, grid, store).warmup()
        sidecar = sorted(tmp_path.glob("prog-*.json"))[0]
        doc = json.loads(sidecar.read_text())
        doc["env"]["device_count"] = 4096
        sidecar.write_text(json.dumps(doc))

        with telemetry.capture() as events:
            c = make_core(index, grid, store)
            w = c.warmup()
        assert w["aot"]["exported"] == 1
        assert "program_store_mismatch" in event_names(events)
        np.testing.assert_array_equal(run_core(c, pts), ref.join(pts))

    def test_orphan_payload_reexports(self, index, grid, tmp_path):
        """A deleted sidecar (a kill between payload and sidecar) is a
        clean miss: the entry is exported and its sidecar restored."""
        store = str(tmp_path)
        make_core(index, grid, store).warmup()
        sorted(tmp_path.glob("prog-*.json"))[0].unlink()
        w = make_core(index, grid, store).warmup()
        assert w["aot"]["loaded"] == 5 and w["aot"]["exported"] == 1
        assert len(list(tmp_path.glob("prog-*.json"))) == 6

    def test_no_store_no_aot(self, index, grid, monkeypatch):
        monkeypatch.delenv("MOSAIC_PROGRAM_STORE", raising=False)
        core = DispatchCore(index, grid, RES, ladder=LADDER)
        assert core._programs is None
        assert "aot" not in core.warmup()


class TestManifests:
    def test_manifest_names_statics_and_no_library_on_the_cpu(self, index, grid, tmp_path):
        """A rung's payload is its manifest: kind, the reference's statics,
        and the kernel libraries it launches (none on the CPU)."""
        core = make_core(index, grid, str(tmp_path))
        core.warmup()
        fp = checkpoint.index_identity(index)
        statics = programs.core_program_statics(core, 256, "join")
        assert set(statics) == {
            "bucket", "resolution", "dtype", "cell_dtype", "writeback",
            "lookup", "probe", "found_cap", "heavy_cap", "convex_cap",
        }
        payload = ProgramStore(str(tmp_path)).load(program_key(fp, "join", **statics))
        doc = json.loads(payload)
        assert doc == {"kind": "join", "statics": json.loads(json.dumps(statics)),
                       "libraries": []}

    def test_stale_manifest_is_refused_and_exported_again(self, index, grid, tmp_path):
        """A manifest whose statics are not the live program's (a key
        collision, a hand-edited entry) is a refusal, never a load."""
        store = ProgramStore(str(tmp_path))
        core = make_core(index, grid, store)
        core.warmup()
        fp = checkpoint.index_identity(index)
        key = program_key(fp, "cells", **programs.core_program_statics(core, 64, "cells"))
        store.save(key, json.dumps({"kind": "cells", "statics": {}, "libraries": []}).encode())
        with telemetry.capture() as events:
            w = make_core(index, grid, store).warmup()
        assert w["aot"] == {"loaded": 5, "exported": 1, "fallback": 0}
        assert "program_store_corrupt_skipped" in event_names(events)
        assert make_core(index, grid, store).warmup()["aot"]["loaded"] == 6

    def test_unwritable_store_falls_back_without_failing(self, index, grid, ref, tmp_path, pts):
        """A store that cannot be written records program_store_fallback a
        rung and the core answers as without one."""
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        with telemetry.capture() as events:
            core = make_core(index, grid, str(blocker / "store"))
            w = core.warmup()
        assert w["aot"] == {"loaded": 0, "exported": 0, "fallback": 3}
        assert event_names(events).count("program_store_fallback") == 3
        np.testing.assert_array_equal(run_core(core, pts), ref.join(pts))


# --------------------------------------------------- epochal provenance

class TestEpochPrograms:
    """The store key folds in the index's EPOCH identity, not just its
    cell fingerprint: two epochs can cover the same cells with different
    chip geometry."""

    def _epochal(self, grid, tmp_path):
        from mosaic_tpu_torch.index import EpochalIndex

        ep = EpochalIndex(wkt.from_wkt(ZONES), grid, RES, keep_core_geoms=False,
                          log_dir=str(tmp_path / "log"), device="cpu")
        ep.publish()
        return ep

    def test_new_epoch_same_cells_never_loads_stale(self, grid, tmp_path):
        ep = self._epochal(grid, tmp_path)
        idx0 = ep.index
        store = str(tmp_path / "store")
        w0 = make_core(idx0, grid, store).warmup()
        assert w0["aot"] == {"loaded": 0, "exported": 6, "fallback": 0}
        assert w0["aot_gc"] == 0

        ep.apply(upsert=wkt.from_wkt([ZONE0_NUDGED]), ids=[0])
        ep.publish()
        idx1 = ep.index
        np.testing.assert_array_equal(idx0.cells.numpy(), idx1.cells.numpy())
        assert checkpoint.index_identity(idx0) != checkpoint.index_identity(idx1)

        with telemetry.capture() as events:
            w1 = make_core(idx1, grid, store).warmup()
        assert w1["aot"] == {"loaded": 0, "exported": 6, "fallback": 0}
        assert w1["aot_gc"] == 6  # epoch 0's ladder dropped
        assert len(ProgramStore(store).keys()) == 6
        assert "program_store_gc" in event_names(events)

    def test_same_epoch_reload_is_stable(self, grid, tmp_path):
        ep = self._epochal(grid, tmp_path)
        store = str(tmp_path / "store")
        make_core(ep.index, grid, store).warmup()
        w = make_core(ep.index, grid, store).warmup()
        assert w["aot"] == {"loaded": 6, "exported": 0, "fallback": 0}
        assert w["aot_gc"] == 0
        assert len(ProgramStore(store).keys()) == 6

    def test_gc_spares_other_series_unstamped_and_libraries(self, tmp_path):
        """gc_superseded only touches entries of the SAME series with an
        OLDER epoch: plain entries, foreign series and kernel-library
        entries (no epoch meta) survive."""
        store = ProgramStore(str(tmp_path))
        store.save("plain", b"x", meta={"kind": "cells"})
        store.save("other", b"y", meta={"index_series": "someoneelse", "index_epoch": 0})
        store.save("mine-old", b"z", meta={"index_series": "s1", "index_epoch": 0})
        store.save("mine-new", b"w", meta={"index_series": "s1", "index_epoch": 3})
        store.save("lib", b"v", meta={"kind": "library", "library": "pip"})
        assert store.gc_superseded("s1", 3) == 1
        assert store.keys() == ["lib", "mine-new", "other", "plain"]


# ------------------------------------------------- across the packages

class TestAcrossPackages:
    @pytest.mark.parametrize("kind, statics", [
        ("cells", {"bucket": 64, "resolution": 3, "dtype": "float32", "cell_dtype": None}),
        ("join", {"bucket": 4096, "resolution": 9, "dtype": "float32", "cell_dtype": None,
                  "writeback": "scatter", "lookup": "gather", "probe": "adaptive",
                  "found_cap": 4096, "heavy_cap": 4096, "convex_cap": None}),
        ("knn_pairs", {"bucket": 256, "dtype": "float64"}),
    ])
    def test_program_key_equals_the_references(self, ref, kind, statics):
        assert program_key("abc@tok", kind, **statics) == ref.programs.program_key(
            "abc@tok", kind, **statics)

    @pytest.mark.parametrize("kind", ["cells", "join"])
    def test_core_keys_equal_the_references(self, index, grid, ref, kind):
        """Over the same zones both packages name a rung's program by the
        same key: the same index identity and the same statics."""
        core = DispatchCore(index, grid, RES, ladder=LADDER)
        rcore = ref.dispatch.DispatchCore(ref.index, ref.grid, RES,
                                          ladder=ref.dispatch.BucketLadder(64, 256))
        assert checkpoint.index_identity(index) == ref.checkpoint.index_identity(ref.index)
        for b in LADDER.buckets:
            assert programs.core_program_statics(core, b, kind) == \
                ref.programs.core_program_statics(rcore, b, kind)

    def test_reference_store_is_refused_by_the_port(self, ref, tmp_path):
        ref.programs.ProgramStore(str(tmp_path)).save("k", b"xla", meta={"kind": "join"})
        with telemetry.capture() as events:
            with pytest.raises(ProgramFingerprintMismatch):
                ProgramStore(str(tmp_path)).load("k")
        assert "program_store_mismatch" in event_names(events)

    def test_port_store_is_refused_by_the_reference(self, ref, tmp_path):
        ProgramStore(str(tmp_path)).save("k", b"{}", meta={"kind": "join"})
        with pytest.raises(ref.programs.ProgramFingerprintMismatch):
            ref.programs.ProgramStore(str(tmp_path)).load("k")

    def test_core_over_a_reference_store_exports_its_own(self, index, grid, ref, tmp_path, pts):
        """A store the reference wrote under the port's keys loads nothing:
        every entry is refused, exported again, and the answers hold."""
        core = make_core(index, grid, str(tmp_path))
        fp = checkpoint.index_identity(index)
        rstore = ref.programs.ProgramStore(str(tmp_path))
        for b in LADDER.buckets:
            for kind in ("cells", "join"):
                statics = programs.core_program_statics(core, b, kind)
                rstore.save(program_key(fp, kind, **statics), b"xla-executable")
        with telemetry.capture() as events:
            w = core.warmup()
        assert w["aot"] == {"loaded": 0, "exported": 6, "fallback": 0}
        assert event_names(events).count("program_store_mismatch") == 6
        np.testing.assert_array_equal(run_core(core, pts), ref.join(pts))
        assert make_core(index, grid, str(tmp_path)).warmup()["aot"]["loaded"] == 6


# ------------------------------------------------------ kernel libraries

@pytest.fixture()
def standin(tmp_path, monkeypatch):
    """A stand-in kernel library under a temporary build directory: the
    `math` extension module's shared object, whose entry point is
    ``PyInit_math`` (bound, never called). ``build()`` puts it where nvcc
    would have written it."""
    src = tmp_path / "standin.cu"
    src.write_text("// stand-in source\n")
    monkeypatch.setattr(_build, "SOURCES", {"standin": src})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "SIGNATURES", {"standin": {"PyInit_math": ()}})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "ORIGINS", {})
    payload = open(math.__file__, "rb").read()

    def build():
        out = _build.library_path("standin")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(payload)
        return out

    return types.SimpleNamespace(src=src, payload=payload, build=build,
                                 store=ProgramStore(str(tmp_path / "store")))


class TestLibraryEntries:
    def test_library_is_named_by_its_source_and_flags_hash(self, standin):
        first = _build.library_path("standin")
        assert first.name == f"libstandin_{_build.source_hash('standin')}.so"
        standin.src.write_text("// another source\n")
        assert _build.library_path("standin") != first

    def test_serialize_then_bind_in_a_fresh_build_dir(self, standin):
        standin.build()
        _build.load("standin")
        payload = programs.serialize_compiled("standin")
        assert payload == standin.payload
        # a relaunch: nothing bound, nothing built
        _build._LIBS.clear()
        _build.library_path("standin").unlink()
        before = _build.nvcc_builds()
        lib = programs.deserialize_compiled(payload, "standin")
        assert hasattr(lib, "PyInit_math")
        assert _build.ORIGINS["standin"] == "store"
        assert _build.nvcc_builds() == before
        assert _build.library_path("standin").read_bytes() == payload
        assert not [p for p in _build.BUILD_DIR.iterdir() if ".tmp" in p.name]

    def test_bind_library_exports_then_loads(self, standin):
        standin.build()
        stats = {"loaded": 0, "exported": 0, "fallback": 0}
        programs.bind_library(standin.store, "standin", stats)
        assert stats == {"loaded": 0, "exported": 1, "fallback": 0}
        (key,) = standin.store.keys()
        assert key == programs.library_key("standin")
        meta = json.loads(open(os.path.join(standin.store.root, f"prog-{key}.json")).read())
        assert meta["meta"] == {"kind": "library", "library": "standin"}

        _build._LIBS.clear()
        _build.library_path("standin").unlink()
        before = _build.nvcc_builds()
        stats = {"loaded": 0, "exported": 0, "fallback": 0}
        programs.bind_library(standin.store, "standin", stats)
        assert stats == {"loaded": 1, "exported": 0, "fallback": 0}
        assert _build.ORIGINS["standin"] == "store" and _build.nvcc_builds() == before

    def test_changed_source_hash_is_a_clean_miss(self, standin):
        standin.build()
        programs.bind_library(standin.store, "standin", {"loaded": 0, "exported": 0})
        old_key = programs.library_key("standin")
        standin.src.write_text("// edited kernel\n")
        new_key = programs.library_key("standin")
        assert new_key != old_key
        assert standin.store.load(new_key) is None
        assert standin.store.load(old_key) == standin.payload

    def test_truncated_payload_is_corrupt(self, standin):
        with pytest.raises(ProgramStoreCorrupt, match="does not bind"):
            programs.deserialize_compiled(standin.payload[:4096], "standin")
        assert "standin" not in _build._LIBS
        assert not _build.library_path("standin").exists()

    def test_missing_entry_point_is_corrupt(self, standin, monkeypatch):
        monkeypatch.setattr(_build, "SIGNATURES", {"standin": {"mosaic_absent": ()}})
        with pytest.raises(ProgramStoreCorrupt, match="does not bind"):
            programs.deserialize_compiled(standin.payload, "standin")

    def test_payload_of_another_build_is_refused_while_bound(self, standin):
        standin.build()
        _build.load("standin")
        with pytest.raises(ProgramStoreCorrupt, match="another build"):
            programs.deserialize_compiled(standin.payload + b"\0", "standin")

    def test_unbindable_entry_falls_back_to_the_build_and_heals(self, standin, monkeypatch):
        """A stored library that does not bind is recorded, built again on
        the nvcc path and exported over the bad entry."""
        built = []

        def fake_nvcc(names):
            for n in names:
                if not _build.library_path(n).exists():
                    built.append(n)
                    standin.build()

        monkeypatch.setattr(_build, "compile_libraries", fake_nvcc)
        key = programs.library_key("standin")
        standin.store.save(key, standin.payload[:4096], meta={"kind": "library"})
        stats = {"loaded": 0, "exported": 0, "fallback": 0}
        with telemetry.capture() as events:
            programs.bind_library(standin.store, "standin", stats)
        assert built == ["standin"]
        assert stats == {"loaded": 0, "exported": 1, "fallback": 0}
        assert "program_store_corrupt_skipped" in event_names(events)
        assert standin.store.load(key) == standin.payload


# ------------------------------------------ the entry points that bind it

class TestEntryPoints:
    def _engine(self, index, grid, **kw):
        from mosaic_tpu_torch.serve import ServeEngine

        return ServeEngine(index, grid, RES, ladder=LADDER, bounds=BBOX,
                           max_wait_s=0.01, cell_dtype=torch.float64, **kw)

    def test_engine_warmup_reports_aot_and_reloads(self, index, grid, ref, tmp_path, pts):
        with self._engine(index, grid, program_store=str(tmp_path)) as e1:
            w1 = e1.warmup()
            assert w1["aot"] == {"loaded": 0, "exported": 6, "fallback": 0}
        with self._engine(index, grid, program_store=str(tmp_path)) as e2:
            w2 = e2.warmup()
            assert w2["aot"] == {"loaded": 6, "exported": 0, "fallback": 0}
            assert w2["backend_compiles"] == 0
            np.testing.assert_array_equal(e2.join(pts, deadline_s=30.0), ref.join(pts))

    def test_hot_swap_passes_the_store_on(self, index, grid, tmp_path):
        with self._engine(index, grid, program_store=str(tmp_path)) as eng:
            eng.warmup()
            stats = eng.hot_swap(index)
            assert eng.core._programs is eng.program_store
            assert stats["aot"] == {"loaded": 6, "exported": 0, "fallback": 0}

    @pytest.mark.parametrize("entry", ["core", "engine", "router", "knn"])
    def test_env_knob_binds_the_store(self, index, grid, tmp_path, monkeypatch, entry):
        from mosaic_tpu_torch.knn import KNNFrontend, build_knn_index
        from mosaic_tpu_torch.serve import ServeRouter

        monkeypatch.setenv("MOSAIC_PROGRAM_STORE", str(tmp_path))
        if entry == "core":
            bound = DispatchCore(index, grid, RES, ladder=LADDER)._programs
        elif entry == "engine":
            with self._engine(index, grid) as eng:
                bound = eng.program_store
                assert eng.core._programs is bound
        elif entry == "router":
            bound = ServeRouter(grid).program_store
        else:
            kx = build_knn_index(wkt.from_wkt(ZONES), grid, RES, device="cpu")
            bound = KNNFrontend(kx)._programs
        assert isinstance(bound, ProgramStore) and bound.root == str(tmp_path)

    def test_router_revival_warms_from_the_store(self, index, grid, ref, tmp_path, pts):
        """max_resident=1: a second tenant on the same tessellation, and
        the first one's revival, load every entry and build nothing."""
        from mosaic_tpu_torch.obs import health
        from mosaic_tpu_torch.serve import ServeRouter

        with ServeRouter(grid, max_resident=1, program_store=str(tmp_path),
                         health_monitor=health.HealthMonitor(),
                         engine_defaults={"ladder": LADDER, "bounds": BBOX,
                                          "max_wait_s": 0.01,
                                          "cell_dtype": torch.float64}) as router:
            first = router.add_tenant("a", index, RES)
            assert first["aot"]["exported"] == 6
            stats = router.add_tenant("b", index, RES)
            assert stats["aot"] == {"loaded": 6, "exported": 0, "fallback": 0}
            assert stats["backend_compiles"] == 0
            np.testing.assert_array_equal(router.join("a", pts), ref.join(pts))
            m = router.metrics()
            assert m["tenants"]["a"]["revivals"] == 2
            assert router._tenants["a"].engine.program_store is router.program_store

    def test_knn_frontend_entries(self, grid, tmp_path):
        """The reference's knn_cells / knn_pairs entries, one a rung, named
        by the reference's keys, with manifests that name no library."""
        from mosaic_tpu_torch.knn import KNNFrontend, build_knn_index

        kx = build_knn_index(wkt.from_wkt(ZONES), grid, RES, device="cpu")
        rows, pairs = BucketLadder(8, 32), BucketLadder(64, 256)
        fe = KNNFrontend(kx, row_ladder=rows, pair_ladder=pairs, program_store=str(tmp_path))
        rep = fe.warmup()
        n = len(rows.buckets) + len(pairs.buckets)
        assert rep["aot"] == {"loaded": 0, "exported": n, "fallback": 0}
        key = program_key(kx.fingerprint, "knn_pairs", bucket=64, dtype="float64")
        doc = json.loads(ProgramStore(str(tmp_path)).load(key))
        assert doc == {"kind": "knn_pairs", "statics": {"bucket": 64, "dtype": "float64"},
                       "libraries": []}
        fe2 = KNNFrontend(kx, row_ladder=rows, pair_ladder=pairs, program_store=str(tmp_path))
        assert fe2.warmup()["aot"] == {"loaded": n, "exported": 0, "fallback": 0}
        assert fe2.metrics()["knn_aot"]["loaded"] == n
        q = np.array([[3.0, 4.0], [-10.0, -10.0]])
        np.testing.assert_array_equal(fe2.dispatch(q, 2)[0], fe.dispatch(q, 2)[0])

    def test_engine_knn_frontend_shares_the_store(self, index, grid, tmp_path):
        from mosaic_tpu_torch.knn import build_knn_index

        kx = build_knn_index(wkt.from_wkt(ZONES), grid, RES, device="cpu")
        with self._engine(index, grid, program_store=str(tmp_path), knn=kx) as eng:
            assert eng.knn._programs is eng.program_store

    def test_meshed_core_refuses_the_store(self, index, grid, tmp_path, pts):
        mesh = data_mesh(devices=["cpu"] * 2)
        with telemetry.capture() as events:
            core = DispatchCore(index, grid, RES, ladder=LADDER, mesh=mesh,
                                program_store=str(tmp_path))
        refused = [e for e in events if e.get("event") == "program_store_refused"]
        assert refused and refused[0]["reason"] == "mesh" and refused[0]["devices"] == 2
        assert core._programs is None and "aot" not in core.warmup()
        single = DispatchCore(index, grid, RES, ladder=LADDER)
        np.testing.assert_array_equal(run_core(core, pts), run_core(single, pts))
        assert ProgramStore(str(tmp_path)).keys() == []

    def test_meshed_knn_frontend_refuses_the_store(self, grid, tmp_path):
        from mosaic_tpu_torch.knn import KNNFrontend, build_knn_index

        kx = build_knn_index(wkt.from_wkt(ZONES), grid, RES, device="cpu")
        with telemetry.capture() as events:
            fe = KNNFrontend(kx, mesh=data_mesh(devices=["cpu"] * 2),
                             pair_ladder=BucketLadder(64, 256),
                             program_store=str(tmp_path))
        assert "program_store_refused" in event_names(events)
        assert fe._programs is None


# ------------------------------------------------------------ the card

_CHILD = r"""
import json, os, sys
import numpy as np, torch
from mosaic_tpu_torch.kernels import _build
_build.BUILD_DIR = _build.Path(sys.argv[2])
from mosaic_tpu_torch.dispatch import ProgramStore, programs
from mosaic_tpu_torch.kernels import pip as TP
stats = {"loaded": 0, "exported": 0, "fallback": 0}
programs.bind_library(ProgramStore(sys.argv[1]), "pip", stats)
rng = np.random.default_rng(5)
H, E2, M2, K = 37, 64, 32, 5000
a = rng.uniform(-1, 1, (H, E2, 2))
edges = np.concatenate([a, a + rng.uniform(-0.5, 0.5, (H, E2, 2))], 2).astype(np.float32)
bits = (np.uint32(1) << rng.integers(0, M2, (H, E2)).astype(np.uint32)).view(np.int32)
geom = rng.integers(0, 50, (H, M2)).astype(np.int32)
arrays = [rng.uniform(-1, 1, K).astype(np.float32), rng.uniform(-1, 1, K).astype(np.float32),
          rng.integers(0, H, K).astype(np.int32), edges, bits, geom]
args = [torch.as_tensor(x, device="cuda") for x in arrays]
got, _ = TP.pip_heavy_tiled(*args)
want, _ = TP.pip_heavy_plain(*args)
torch.cuda.synchronize()
print(json.dumps({"stats": stats, "origin": _build.ORIGINS.get("pip"),
                  "nvcc_builds": _build.nvcc_builds(), "launches": TP.pip_heavy_tiled.launches,
                  "equal": bool(torch.equal(got, want))}))
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_stored_pip_library_binds_without_nvcc_on_card(cuda, tmp_path):
    """The real ``pip`` library exported to a store, then bound in a fresh
    process whose build directory is empty and which has no nvcc: no
    build, and its kernel launches equal to the plain version."""
    store = ProgramStore(str(tmp_path / "store"))
    stats = {"loaded": 0, "exported": 0, "fallback": 0}
    programs.bind_library(store, "pip", stats)
    assert stats["exported"] + stats["loaded"] == 1
    empty = tmp_path / "no_cuda"
    empty.mkdir()
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc"))
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=path, CUDA_HOME=str(empty), PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, store.root, str(tmp_path / "build")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"stats": {"loaded": 1, "exported": 0, "fallback": 0}, "origin": "store",
                   "nvcc_builds": 0, "launches": 1, "equal": True}


@pytest.mark.gpu
def test_card_core_stores_its_library_and_rungs(cuda, tmp_path):
    """A core on the card whose probe launches pip_heavy_tiled exports two
    entries a rung and the two libraries (pip, and h3 for its cells); a
    second core loads all of them, its join manifests name pip and its
    cells manifests h3."""
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.datasets import synthetic_zones
    from mosaic_tpu_torch.sql.join import pip_join

    bbox = (-74.0, 40.7, -73.9, 40.786)
    h3 = H3IndexSystem()
    zones = synthetic_zones(4, 4, bbox=bbox, verts=256)
    ix = build_chip_index(tessellate(zones, h3, 9, keep_core_geoms=False), device=cuda)
    lad = BucketLadder(64, 256)
    c1 = DispatchCore(ix, h3, 9, ladder=lad, probe="adaptive", program_store=str(tmp_path))
    assert c1.warmup()["aot"] == {"loaded": 0, "exported": 8, "fallback": 0}
    c2 = DispatchCore(ix, h3, 9, ladder=lad, probe="adaptive", program_store=str(tmp_path))
    assert c2.warmup()["aot"] == {"loaded": 8, "exported": 0, "fallback": 0}
    for kind, lib in (("join", "pip"), ("cells", "h3")):
        key = program_key(checkpoint.index_identity(ix), kind,
                          **programs.core_program_statics(c2, 64, kind))
        doc = json.loads(ProgramStore(str(tmp_path)).load(key))
        assert doc["libraries"] == [{"name": lib, "source": _build.source_hash(lib)}]
    pts = np.random.default_rng(3).uniform(bbox[:2], bbox[2:], (200, 2))
    want = np.asarray(pip_join(pts, None, h3, 9, chip_index=ix, probe="adaptive",
                               recheck=False))
    np.testing.assert_array_equal(c2.execute(pts), want)
    c1.release_graphs()
    c2.release_graphs()
