"""The port's epochal indexes (`mosaic_tpu_torch/index/epoch.py`) against
the reference's (`mosaic_tpu/index/epoch.py`), class for class with
`tests/test_epoch.py`: delta tessellation, every epoch bit for bit equal
to a from-scratch rebuild and to the reference's index, the delta log
byte for byte the reference's (so each package replays the other's
directories), kill-at-every-boundary replay, typed log refusals,
compaction, the durable-stream epoch fence and the router's epoch
advance. Everything runs on the CPU (``device="cpu"``), where the kernel
wrappers run their plain versions; the comparisons are exact."""

import hashlib
import json

import numpy as np
import pytest

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate_subset as ref_tessellate_subset
from mosaic_tpu.index import EpochalIndex as RefEpochalIndex
from mosaic_tpu.runtime import checkpoint as ref_checkpoint
from mosaic_tpu_torch.convert import chip_index_from_reference
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate, tessellate_subset
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.index import (
    EpochalIndex,
    EpochFingerprintMismatch,
    EpochLogCorrupt,
    chip_index_equal,
)
from mosaic_tpu_torch.raster import Raster
from mosaic_tpu_torch.raster.zonal import host_zonal_zones_oracle, zonal_zones
from mosaic_tpu_torch.runtime import checkpoint, faults, telemetry
from mosaic_tpu_torch.runtime.errors import TransientDeviceError
from mosaic_tpu_torch.runtime.retry import RetryPolicy
from mosaic_tpu_torch.serve import BucketLadder, ServeEngine, ServeRouter
from mosaic_tpu_torch.sql.join import ChipIndex, build_chip_index, host_join, pip_join
from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
CUSTOM = CustomIndexSystem(GridConf(*CONF))
REF_CUSTOM = RefCustom(RefConf(*CONF))
RES = 3
BBOX = (-25.0, -25.0, 35.0, 20.0)
FAST = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)

ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))",
    "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
    "POLYGON ((20 -10, 30 -10, 30 5, 20 5, 20 -10))",
]
#: epoch 1: zone 1 grows (a live edit of an existing geometry)
ZONE1_V2 = "POLYGON ((-22 -22, -4 -22, -4 -4, -22 -4, -22 -22))"
#: epoch 2: a brand-new zone under a fresh stable id
ZONE3_NEW = "POLYGON ((-15 5, -5 5, -5 15, -15 15, -15 5))"

BOOM = lambda s: RuntimeError(f"synthetic kill @ {s}")  # noqa: E731


def port_col(col) -> PackedGeometry:
    """The port's geometry column with the reference column's arrays (the
    port has no WKT reader yet)."""
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def geoms(wkts) -> PackedGeometry:
    return port_col(wkt.from_wkt(wkts))


def mk(log_dir=None, **kw):
    kw.setdefault("keep_core_geoms", False)
    return EpochalIndex(
        geoms(ZONES), CUSTOM, RES, device="cpu",
        log_dir=str(log_dir) if log_dir else None, **kw,
    )


def mk_ref(log_dir=None, **kw):
    kw.setdefault("keep_core_geoms", False)
    return RefEpochalIndex(
        wkt.from_wkt(ZONES), REF_CUSTOM, RES,
        log_dir=str(log_dir) if log_dir else None, **kw,
    )


def scratch(ep):
    """The from-scratch oracle: a full tessellate + build of the epochal
    index's CURRENT column."""
    return build_chip_index(
        tessellate(ep.column(), CUSTOM, RES, keep_core_geoms=False),
        device="cpu",
    )


def edit_replace(ep, conv=geoms):
    return ep.apply(upsert=conv([ZONE1_V2]), ids=[1])


def edit_insert(ep, conv=geoms):
    return ep.apply(upsert=conv([ZONE3_NEW]), ids=[3])


def edit_remove(ep, conv=geoms):
    return ep.apply(remove=[0])


EDITS = (edit_replace, edit_insert, edit_remove)


def ref_arrays(ix) -> dict:
    """A reference ChipIndex as the numpy arrays `chip_index_from_reference`
    takes: every field, the border geometry, the host twin and the
    Voronoi tables."""
    out = {n: np.asarray(getattr(ix, n)) for n in ChipIndex.field_names()}
    out.update({f"border.{n}": np.asarray(getattr(ix.border, n))
                for n in ChipIndex._BORDER})
    out.update(ix.host.save_arrays())
    v = getattr(ix, "voronoi", None)
    if v is not None:
        out.update({f"voronoi.{n}": np.asarray(getattr(v, n))
                    for n in ("sites", "adjacency", "geom", "cell", "shift")})
        out["voronoi.method"] = np.asarray(v.method)
    return out


def equals_reference(ix, ref_ix) -> bool:
    return chip_index_equal(
        ix, chip_index_from_reference(ref_arrays(ref_ix), device="cpu")
    )


def log_files(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(3)
    return rng.uniform(BBOX[:2], BBOX[2:], (256, 2))


@pytest.fixture(scope="module")
def advanced():
    """One epochal index driven through every edit kind and published at
    the final epoch (shared by the read-only frontend tests)."""
    ep = mk()
    for e in EDITS:
        e(ep)
    ep.publish()
    return ep


@pytest.fixture(scope="module")
def both_logs(tmp_path_factory):
    """The same three edits written by both packages, each index
    published at every epoch: (port dir, reference dir, port indexes,
    reference indexes, port index, reference index)."""
    root = tmp_path_factory.mktemp("logs")
    pd, rd = root / "port", root / "ref"
    ep, rp = mk(pd), mk_ref(rd)
    ep.publish()
    rp.publish()
    port_ix, ref_ix = [ep.index], [rp.index]
    for edit in EDITS:
        edit(ep)
        edit(rp, conv=wkt.from_wkt)
        ep.publish()
        rp.publish()
        port_ix.append(ep.index)
        ref_ix.append(rp.index)
    return pd, rd, port_ix, ref_ix, ep, rp


# ------------------------------------------------- delta tessellation


class TestDeltaTessellation:
    def test_subset_equals_full_blocks(self):
        """Tessellation is per-geometry independent, so a subset pass is
        bit-identical to the matching blocks of a full pass — and to the
        reference's subset pass."""
        col = geoms(ZONES)
        full = tessellate(col, CUSTOM, RES, keep_core_geoms=False)
        for g in range(len(ZONES)):
            sub = tessellate_subset(
                col, np.array([g]), CUSTOM, RES, keep_core_geoms=False
            )
            rows = np.nonzero(np.asarray(full.geom_id) == g)[0]
            assert len(sub) == rows.size
            np.testing.assert_array_equal(sub.geom_id, g)
            for f in ("cell_id", "is_core", "has_geom"):
                np.testing.assert_array_equal(
                    getattr(sub, f), np.asarray(getattr(full, f))[rows]
                )
            want = full.chips.take([int(r) for r in rows])
            ref = ref_tessellate_subset(
                wkt.from_wkt(ZONES), np.array([g]), REF_CUSTOM, RES,
                keep_core_geoms=False,
            )
            for f in ("xy", "ring_offsets", "part_offsets",
                      "geom_offsets", "geom_type", "srid"):
                got = getattr(sub.chips, f)
                np.testing.assert_array_equal(got, getattr(want, f))
                r = np.asarray(getattr(ref.chips, f))
                assert got.dtype == r.dtype and got.tobytes() == r.tobytes(), f
            for f in ("geom_id", "cell_id", "is_core", "has_geom"):
                np.testing.assert_array_equal(getattr(sub, f), getattr(ref, f))

    def test_subset_relabels_geom_ids(self):
        sub = tessellate_subset(
            geoms(ZONES), np.array([0, 2]), CUSTOM, RES,
            keep_core_geoms=False, geom_ids=np.array([7, 9]),
        )
        assert set(np.unique(sub.geom_id)) == {7, 9}
        with pytest.raises(ValueError, match="labels for"):
            tessellate_subset(geoms(ZONES), np.array([0, 2]), CUSTOM, RES,
                              geom_ids=np.array([7]))


# ------------------------------------------------- epoch bit-identity


class TestEpochBitIdentity:
    def test_epoch0_matches_scratch_and_reference(self):
        ep, rp = mk(), mk_ref()
        ep.publish()
        rp.publish()
        assert ep.epoch == 0 and ep.applied_epoch == 0
        assert chip_index_equal(ep.index, scratch(ep))
        assert equals_reference(ep.index, rp.index)
        assert ep.series == rp.series and ep.epoch_token() == rp.epoch_token()

    def test_every_epoch_matches_scratch_and_reference(self, both_logs):
        """After replace, insert and remove edits, each published epoch is
        bit-identical to a from-scratch rebuild of its column and to the
        reference's index of the same epoch, and carries the reference's
        epoch token."""
        _pd, _rd, port_ix, ref_ix, ep, rp = both_logs
        for n, (ix, rix) in enumerate(zip(port_ix, ref_ix)):
            assert ix.epoch == rix.epoch == n
            assert ix.epoch_token == rix.epoch_token
            assert ix.epoch_series == rix.epoch_series == ep.series
            assert equals_reference(ix, rix), n
        assert chip_index_equal(ep.index, scratch(ep))
        assert ep.chain == rp.chain and ep.epoch_token() == rp.epoch_token()
        assert list(ep._order) == list(rp._order) == [1, 2, 3]

    def test_each_edit_matches_scratch(self):
        ep = mk()
        ep.publish()
        for n, edit in enumerate(EDITS, start=1):
            stats = edit(ep)
            assert stats["epoch"] == n
            assert ep.applied_epoch == n and ep.epoch == n - 1
            ep.publish()
            assert ep.epoch == n
            assert chip_index_equal(ep.index, scratch(ep))
            assert ep.index.epoch == n
            assert ep.index.epoch_token == ep.epoch_token(n)

    def test_grow_from_empty(self):
        ep = EpochalIndex(None, CUSTOM, RES, keep_core_geoms=False, device="cpu")
        rp = RefEpochalIndex(None, REF_CUSTOM, RES, keep_core_geoms=False)
        assert len(ep) == 0
        ep.apply(upsert=geoms(ZONES), ids=[0, 1, 2])
        rp.apply(upsert=wkt.from_wkt(ZONES), ids=[0, 1, 2])
        ep.publish()
        rp.publish()
        assert chip_index_equal(ep.index, scratch(ep))
        assert equals_reference(ep.index, rp.index)
        assert ep.epoch_token() == rp.epoch_token()

    def test_apply_validation(self):
        ep = mk()
        with pytest.raises(ValueError, match="ids for"):
            ep.apply(upsert=geoms([ZONE1_V2]), ids=[1, 2])
        with pytest.raises(ValueError, match="both upserted and removed"):
            ep.apply(upsert=geoms([ZONE1_V2]), ids=[1], remove=[1])
        with pytest.raises(KeyError, match="unknown geometry ids"):
            ep.apply(remove=[99])
        assert ep.applied_epoch == 0  # nothing durable happened

    def test_index_identity_carries_epoch_token(self, advanced):
        ident = checkpoint.index_identity(advanced.index)
        assert "@" in ident
        assert ident.endswith(advanced.index.epoch_token)
        plain = build_chip_index(
            tessellate(geoms(ZONES), CUSTOM, RES, keep_core_geoms=False),
            device="cpu",
        )
        assert "@" not in checkpoint.index_identity(plain)

    def test_index_identity_equals_reference(self, both_logs):
        _pd, _rd, port_ix, ref_ix, _ep, _rp = both_logs
        for ix, rix in zip(port_ix, ref_ix):
            assert checkpoint.index_identity(ix) == ref_checkpoint.index_identity(rix)

    def test_reprofile_equals_reference(self, monkeypatch):
        """`EpochalIndex.reprofile` recommends what the reference's does
        for the same column (both read the port's priors here)."""
        import importlib

        from mosaic_tpu_torch.tune import load_priors

        ref_recommend = importlib.import_module("mosaic_tpu.tune.recommend")
        monkeypatch.setattr(ref_recommend, "load_priors", lambda: load_priors())
        ep, ref = mk(), mk_ref()
        for e in (edit_replace, edit_insert):
            e(ep)
            e(ref, conv=wkt.from_wkt)
        assert ep.reprofile().as_dict() == ref.reprofile().as_dict()

    def test_publish_reprofile_builds_the_same_index(self):
        """``publish(reprofile=True)`` without an engine publishes the
        same epoch as a plain publish, flagged ``reprofiled``."""
        ep, plain = mk(), mk()
        stats = ep.publish(reprofile=True)
        assert stats["reprofiled"] is True and ep.epoch == 0
        plain.publish()
        assert chip_index_equal(ep.index, plain.index)
        assert chip_index_equal(ep.index, scratch(ep))

    def test_log_meta_keeps_the_reference_values(self, both_logs):
        pd, _rd, _pi, _ri, _ep, _rp = both_logs
        meta = json.loads((pd / "delta-00000001.json").read_text())
        base = json.loads(
            (pd / "base-00000000.json").read_text()
        )["meta"]
        assert base["dtype"] == "float32" and base["system"] == "CustomIndexSystem"
        assert meta["meta"] == {"upserts": 1, "removed": 0}


def test_h3_epochs_match_reference_and_scratch(tmp_path):
    """A small H3 case: four zones in the NYC bbox at resolution 8, one
    upsert, one insert and one removal; every epoch equals the
    reference's and a rebuild, and the logs are byte-equal."""
    from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.datasets import synthetic_zones

    h3, rh3 = H3IndexSystem(), RefH3()
    box = (-74.0, 40.7, -73.9, 40.786)
    zones = synthetic_zones(2, 2, bbox=box, verts=24, seed=5)
    moved = synthetic_zones(2, 2, bbox=box, verts=24, seed=6)
    kw = dict(keep_core_geoms=False)

    def ref(col):
        from mosaic_tpu.core.types import PackedGeometry as RefPacked

        return RefPacked(**{f: np.asarray(getattr(col, f)) for f in (
            "xy", "ring_offsets", "part_offsets", "geom_offsets",
            "geom_type", "srid")})

    ep = EpochalIndex(zones, h3, 8, log_dir=str(tmp_path / "p"), device="cpu", **kw)
    rp = RefEpochalIndex(ref(zones), rh3, 8, log_dir=str(tmp_path / "r"), **kw)
    steps = [
        dict(upsert=moved.take([1]), ids=[1]),
        dict(upsert=moved.take([3]), ids=[7]),
        dict(remove=[2]),
    ]
    for n, step in enumerate([None] + steps):
        if step is not None:
            ep.apply(**step)
            rstep = dict(step)
            if "upsert" in rstep:
                rstep["upsert"] = ref(rstep["upsert"])
            rp.apply(**rstep)
        ep.publish()
        rp.publish()
        assert equals_reference(ep.index, rp.index), n
        assert chip_index_equal(ep.index, build_chip_index(
            tessellate(ep.column(), h3, 8, **kw), device="cpu"))
        assert ep.epoch_token() == rp.epoch_token()
    assert log_files(tmp_path / "p") == log_files(tmp_path / "r")


# ------------------------------------------------- frontends vs oracle


class TestFrontendsVsOracle:
    def test_pip_join_matches_f64_oracle(self, advanced, pts):
        got = pip_join(
            pts, None, CUSTOM, RES, chip_index=advanced.index,
            recheck=False, device="cpu",
        )
        want = host_join(pts, advanced.index.host, CUSTOM, RES)
        np.testing.assert_array_equal(np.asarray(got), want)

    def test_zonal_matches_f64_oracle(self, advanced):
        rng = np.random.default_rng(5)
        data = rng.uniform(0, 100, (1, 40, 40))
        data[0][rng.random((40, 40)) < 0.1] = -9.0
        r = Raster(
            data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0), srid=0,
            nodata=-9.0,
        )
        got = zonal_zones(r, advanced.index, CUSTOM, RES, tile=(32, 32),
                          device="cpu")
        want = host_zonal_zones_oracle(
            r, advanced.index, CUSTOM, RES, tile=(32, 32)
        )
        for f in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))

    def test_serve_engine_spans_epochs(self, pts):
        """Live edits published INTO a running engine: every epoch's
        answers match that epoch's f64 oracle, and a publish that fails
        before the swap leaves the engine serving the old epoch."""
        ep = mk()
        ep.publish()
        with ServeEngine(
            ep.index, CUSTOM, RES, ladder=BucketLadder(64, 1024),
            bounds=BBOX, max_wait_s=0.0,
        ) as eng:
            old = ep.index.host
            np.testing.assert_array_equal(
                np.asarray(eng.join(pts, deadline_s=60.0)),
                host_join(pts, old, CUSTOM, RES),
            )
            edit_replace(ep)
            with faults.transient_errors(
                1, sites=("epoch.publish",), exc_factory=BOOM
            ):
                with pytest.raises(RuntimeError, match="synthetic kill"):
                    ep.publish(eng)
            assert ep.epoch == 0  # epochal stayed put...
            np.testing.assert_array_equal(  # ...and so did the engine
                np.asarray(eng.join(pts, deadline_s=60.0)),
                host_join(pts, old, CUSTOM, RES),
            )
            stats = ep.publish(eng)
            assert ep.epoch == 1 and stats["swap"]["backend_compiles"] == 0
            np.testing.assert_array_equal(
                np.asarray(eng.join(pts, deadline_s=60.0)),
                host_join(pts, ep.index.host, CUSTOM, RES),
            )
            assert eng.metrics()["cold_compiles"] == 0


# ------------------------------------------------- kill-storm replay


#: (fault site, matching calls let through, epoch the log must replay
#: to) — the reference's matrix. apply's boundaries: pre-tessellate /
#: pre-append / post-append (the delta record is the durable point).
#: publish writes nothing, so both its boundaries replay to the applied
#: epoch. compact's: pre-snapshot / post-snapshot-pre-truncate /
#: post-truncate.
KILL_MATRIX = [
    ("epoch.apply", 0, 0),
    ("epoch.apply", 1, 0),
    ("epoch.apply", 2, 1),
    ("epoch.publish", 0, 1),
    ("epoch.publish", 1, 1),
    ("epoch.compact", 0, 1),
    ("epoch.compact", 1, 1),
    ("epoch.compact", 2, 1),
]


class TestKillReplay:
    @pytest.mark.parametrize("site,skip,survivor", KILL_MATRIX)
    def test_kill_at_every_boundary(self, tmp_path, site, skip, survivor):
        """A kill at ANY fault-site boundary leaves a log that replays to
        a bit-identical index at the surviving epoch, and the reference
        replays the same directory to the same index."""
        d = tmp_path / "log"
        ep = mk(d)
        with faults.transient_errors(
            1, sites=(site,), skip_first=skip, exc_factory=BOOM
        ):
            with pytest.raises(RuntimeError, match="synthetic kill"):
                edit_replace(ep)
                if site == "epoch.publish":
                    ep.publish()
                elif site == "epoch.compact":
                    ep.compact()
        r = EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert r.applied_epoch == survivor and r.epoch == survivor
        assert chip_index_equal(r.index, scratch(r))
        assert len(r) == 3 and list(r._order) == [0, 1, 2]
        rr = RefEpochalIndex.replay(str(d), REF_CUSTOM)
        assert rr.epoch_token() == r.epoch_token()
        assert equals_reference(r.index, rr.index)

    def test_torn_publish_never_half_bumps(self, tmp_path):
        """The torn boundary: index swapped, counter not yet bumped. The
        published-epoch counter must NOT have advanced, and replay lands
        cleanly on the durable epoch."""
        d = tmp_path / "log"
        ep = mk(d)
        ep.publish()
        edit_replace(ep)
        with faults.transient_errors(
            1, sites=("epoch.publish",), skip_first=1, exc_factory=BOOM
        ):
            with pytest.raises(RuntimeError, match="synthetic kill"):
                ep.publish()
        assert ep.epoch == 0  # old epoch or a clean replay, never between
        r = EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert r.epoch == 1
        assert chip_index_equal(r.index, scratch(r))

    def test_replay_equals_live_instance(self, tmp_path):
        d = tmp_path / "log"
        ep = mk(d)
        for e in EDITS:
            e(ep)
        ep.publish()
        r = EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert r.applied_epoch == ep.applied_epoch == 3
        assert r.epoch_token() == ep.epoch_token()
        assert r.series == ep.series and r.chain == ep.chain
        assert chip_index_equal(r.index, ep.index)

    def test_replay_upto_historical_epoch(self, both_logs):
        """``upto`` stops the replay at a historical epoch — the audit
        knob — and the result matches that epoch's published index."""
        pd, _rd, port_ix, _ri, _ep, _rp = both_logs
        for n in range(4):
            r = EpochalIndex.replay(str(pd), CUSTOM, upto=n, device="cpu")
            assert r.applied_epoch == n
            assert chip_index_equal(r.index, port_ix[n])

    def test_log_records_byte_equal_across_packages(self, both_logs):
        """Log format v1 is the reference's byte for byte: the same
        column and edits give the same payloads and sidecars, so the
        same payload hashes, chains, series and epoch tokens."""
        pd, rd, _pi, _ri, ep, rp = both_logs
        got, want = log_files(pd), log_files(rd)
        assert sorted(got) == sorted(want) == sorted(
            [f"base-00000000.{x}" for x in ("json", "npz")]
            + [f"delta-0000000{e}.{x}" for e in (1, 2, 3) for x in ("json", "npz")]
        )
        for name in got:
            assert got[name] == want[name], name
        assert (ep.series, ep.chain) == (rp.series, rp.chain)

    def test_port_replays_reference_log(self, both_logs):
        _pd, rd, port_ix, ref_ix, _ep, rp = both_logs
        for n in range(4):
            r = EpochalIndex.replay(str(rd), CUSTOM, upto=n, device="cpu")
            assert r.applied_epoch == n
            assert r.epoch_token() == ref_ix[n].epoch_token
            assert chip_index_equal(r.index, port_ix[n])
            assert equals_reference(r.index, ref_ix[n])
        assert r.chain == rp.chain

    def test_reference_replays_port_log(self, both_logs):
        pd, _rd, port_ix, _ri, ep, _rp = both_logs
        for n in range(4):
            rr = RefEpochalIndex.replay(str(pd), REF_CUSTOM, upto=n)
            assert rr.applied_epoch == n
            assert rr.epoch_token() == port_ix[n].epoch_token
            assert equals_reference(port_ix[n], rr.index)
        assert rr.chain == ep.chain


# ------------------------------------------------- log refusals


class TestLogRefusals:
    def _logged(self, tmp_path, n_edits=2):
        d = tmp_path / "log"
        ep = mk(d)
        for e in EDITS[:n_edits]:
            e(ep)
        return d, ep

    def test_corrupt_tail_truncates(self, tmp_path):
        """Bit rot / kill-mid-write on the NEWEST delta is tail residue:
        replay truncates it (typed telemetry) and lands on the previous
        epoch, bit-identical."""
        d, _ = self._logged(tmp_path)
        p = d / "delta-00000002.npz"
        p.write_bytes(p.read_bytes()[:-7])
        with telemetry.capture() as events:
            r = EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert r.applied_epoch == 1
        assert chip_index_equal(r.index, scratch(r))
        kinds = [e for e in events if e["event"] == "epoch_log_truncated"]
        assert kinds and kinds[0]["kind"] == "delta"
        # the truncated record was unlinked: a second replay is clean
        with telemetry.capture() as events:
            EpochalIndex.replay(str(d), CUSTOM, publish=False, device="cpu")
        assert not [e for e in events if e["event"] == "epoch_log_truncated"]

    def test_corrupt_interior_refuses_typed(self, tmp_path):
        """A damaged record with VALID successors is not a tail — data
        loss would be silent, so replay refuses typed."""
        d, _ = self._logged(tmp_path)
        p = d / "delta-00000001.npz"
        p.write_bytes(p.read_bytes()[:-7])
        with pytest.raises(EpochLogCorrupt, match="valid successors") as ei:
            EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert ei.value.epoch == 1

    def test_missing_interior_epoch_refuses_typed(self, tmp_path):
        d, _ = self._logged(tmp_path)
        (d / "delta-00000001.npz").unlink()
        (d / "delta-00000001.json").unlink()
        with pytest.raises(EpochLogCorrupt, match="missing"):
            EpochalIndex.replay(str(d), CUSTOM, device="cpu")

    def test_reordered_records_refuse_typed(self, tmp_path):
        """Two deltas swapped on disk: each record still validates alone,
        but the chain does not bind — a typed fingerprint refusal."""
        d, _ = self._logged(tmp_path)
        for x in ("npz", "json"):
            a, b = d / f"delta-00000001.{x}", d / f"delta-00000002.{x}"
            ta, tb = a.read_bytes(), b.read_bytes()
            a.write_bytes(tb)
            b.write_bytes(ta)
        with pytest.raises(EpochFingerprintMismatch, match="chains from"):
            EpochalIndex.replay(str(d), CUSTOM, device="cpu")

    def test_forged_chain_refuses_typed(self, tmp_path):
        """A record whose checksum validates but whose ``prev`` does not
        bind to the predecessor is a forged/foreign record — replay
        refuses with the fingerprint mismatch, not a generic error."""
        d, _ = self._logged(tmp_path)
        p = d / "delta-00000002.json"
        sidecar = json.loads(p.read_text())
        sidecar["prev"] = "f" * 64
        sidecar["chain"] = hashlib.sha256(
            f"{sidecar['prev']}:{sidecar['sha256']}".encode()
        ).hexdigest()
        p.write_text(json.dumps(sidecar))
        with pytest.raises(EpochFingerprintMismatch, match="chains from"):
            EpochalIndex.replay(str(d), CUSTOM, device="cpu")

    def test_wrong_index_system_refuses_typed(self, tmp_path):
        d, _ = self._logged(tmp_path)

        class OtherSystem(CustomIndexSystem):
            pass

        other = OtherSystem(GridConf(*CONF))
        with pytest.raises(EpochFingerprintMismatch, match="index"):
            EpochalIndex.replay(str(d), other, device="cpu")

    def test_empty_or_baseless_log_refuses_typed(self, tmp_path):
        with pytest.raises(EpochLogCorrupt, match="no delta log"):
            EpochalIndex.replay(str(tmp_path / "nothing"), CUSTOM, device="cpu")
        d, _ = self._logged(tmp_path, n_edits=1)
        (d / "base-00000000.npz").write_bytes(b"shredded")
        with pytest.raises(EpochLogCorrupt, match="base record"):
            EpochalIndex.replay(str(d), CUSTOM, device="cpu")


# ------------------------------------------------- compaction


class TestCompaction:
    def test_compact_preserves_identity_and_truncates(self, tmp_path):
        d = tmp_path / "log"
        ep = mk(d)
        edit_replace(ep)
        edit_insert(ep)
        stats = ep.compact()
        assert stats["epoch"] == 2 and stats["truncated"] == 3
        names = sorted(f.name for f in d.iterdir())
        assert names == ["compact-00000002.json", "compact-00000002.npz"]
        ep.publish()
        assert chip_index_equal(ep.index, scratch(ep))
        # the chain is untouched by compaction: a post-compact delta
        # still chains from the last delta's hash, and replay proves it
        edit_remove(ep)
        r = EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert r.applied_epoch == 3
        assert chip_index_equal(r.index, scratch(r))
        assert r.series == ep.series  # sealed into the compact record
        # the reference writes the same compacted log
        rd = tmp_path / "ref"
        rp = mk_ref(rd)
        edit_replace(rp, conv=wkt.from_wkt)
        edit_insert(rp, conv=wkt.from_wkt)
        rp.compact()
        edit_remove(rp, conv=wkt.from_wkt)
        assert log_files(d) == log_files(rd)

    def test_log_max_knob_autocompacts(self, tmp_path):
        """``log_max=`` (which beats ``MOSAIC_EPOCH_LOG_MAX``): once that
        many deltas accumulate, apply compacts and truncates with the
        prefix's fingerprint sealed into the snapshot."""
        d = tmp_path / "log"
        ep = mk(d, log_max=2)
        s1 = edit_replace(ep)
        assert "compacted" not in s1
        s2 = edit_insert(ep)
        assert s2["compacted"]["epoch"] == 2
        entries = sorted(f.name for f in d.iterdir())
        assert entries == ["compact-00000002.json", "compact-00000002.npz"]
        edit_remove(ep)  # 1 delta since compact: below the limit again
        assert (d / "delta-00000003.json").exists()
        r = EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert r.applied_epoch == 3
        assert chip_index_equal(r.index, scratch(r))

    def test_log_max_env_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MOSAIC_EPOCH_LOG_MAX", "1")
        ep = mk(tmp_path / "log")
        s = edit_replace(ep)
        assert s["compacted"]["epoch"] == 1
        # the explicit argument beats the env
        s = edit_replace(mk(tmp_path / "log2", log_max=5))
        assert "compacted" not in s
        # the port's single resolver refuses a malformed value
        monkeypatch.setenv("MOSAIC_EPOCH_LOG_MAX", "many")
        with pytest.raises(ValueError, match="epoch_log_max"):
            edit_replace(mk(tmp_path / "log3"))

    def test_background_compact_adopts_sinks(self, tmp_path):
        d = tmp_path / "log"
        ep = mk(d)
        edit_replace(ep)
        with telemetry.capture() as events:
            t = ep.compact(background=True)
            t.join(timeout=60)
        assert not t.is_alive()
        assert [e for e in events if e["event"] == "epoch_compacted"]
        assert len(ep._blocks) == 1
        ep.publish()
        assert chip_index_equal(ep.index, scratch(ep))

    def test_background_compact_adopts_fault_plans(self, tmp_path):
        """The worker runs under the caller's fault plans: a kill there is
        a telemetry event, the log keeps its prefix, and replay is clean."""
        d = tmp_path / "log"
        ep = mk(d)
        edit_replace(ep)
        with telemetry.capture() as events, faults.transient_errors(
            1, sites=("epoch.compact",), exc_factory=BOOM
        ):
            t = ep.compact(background=True)
            t.join(timeout=60)
        failed = [e for e in events if e["event"] == "epoch_compact_failed"]
        assert failed and "synthetic kill" in failed[0]["error"]
        assert (d / "delta-00000001.json").exists()
        r = EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert chip_index_equal(r.index, scratch(r))

    def test_half_written_compact_falls_back(self, tmp_path):
        """A compact snapshot shredded BEFORE truncation ran (the
        kill-mid-compaction residue) must not poison replay: the base +
        delta prefix still replays the same epoch."""
        d = tmp_path / "log"
        ep = mk(d)
        edit_replace(ep)
        with faults.transient_errors(
            1, sites=("epoch.compact",), skip_first=1, exc_factory=BOOM
        ):
            with pytest.raises(RuntimeError, match="synthetic kill"):
                ep.compact()  # snapshot durable, prefix NOT truncated
        p = d / "compact-00000001.npz"
        p.write_bytes(p.read_bytes()[:-7])
        with telemetry.capture() as events:
            r = EpochalIndex.replay(str(d), CUSTOM, device="cpu")
        assert r.applied_epoch == 1
        assert chip_index_equal(r.index, scratch(r))
        trunc = [e for e in events if e["event"] == "epoch_log_truncated"]
        assert trunc and trunc[0]["kind"] == "compact"


# ------------------------------------------------- durable-stream fence


class TestStreamEpochFence:
    def test_resume_across_epoch_boundary(self, tmp_path):
        """A durable stream run killed mid-flight, with a compaction kill
        AND an epoch advance before anyone resumes: resume against the NEW
        epoch's index refuses typed; resume against the snapshot's OWN
        epoch finishes bit-identical to a clean run."""
        log_dir = tmp_path / "log"
        run_dir = str(tmp_path / "run")
        ep = mk(log_dir)
        ep.publish()
        idx0 = ep.index
        rng = np.random.default_rng(7)
        batches = [rng.uniform(BBOX[:2], BBOX[2:], (1024, 2)) for _ in range(3)]
        ring = ring_from_host(batches, device="cpu")
        sj0 = StreamJoin(idx0, CUSTOM, RES, prefetch=True)
        clean = sj0.run(ring, 7, collect=True)
        with faults.inject(
            fail_first=99, skip_first=2, sites=("stream.scan_step",),
            exc_factory=BOOM,
        ):
            with pytest.raises(RuntimeError, match="synthetic kill"):
                sj0.run_durable(
                    ring, 7, run_dir=run_dir, snapshot_every=2,
                    retry_policy=FAST,
                )
        assert checkpoint.list_snapshots(run_dir)
        # the world moves on: an edit lands and a compaction dies
        edit_replace(ep)
        with faults.transient_errors(
            1, sites=("epoch.compact",), skip_first=1, exc_factory=BOOM
        ):
            with pytest.raises(RuntimeError, match="synthetic kill"):
                ep.compact()
        r = EpochalIndex.replay(str(log_dir), CUSTOM, device="cpu")
        assert r.epoch == 1
        # refusal direction: the snapshot is fenced to its epoch
        sj1 = StreamJoin(r.index, CUSTOM, RES, prefetch=True)
        with pytest.raises(EpochFingerprintMismatch, match="epoch"):
            sj1.resume(run_dir, ring, retry_policy=FAST)
        # completion direction: the snapshot's own index finishes the run
        # bit-identically to the clean epoch-0 run
        got = sj0.resume(run_dir, ring, retry_policy=FAST)
        assert (got.checksum, got.matches, got.overflow) == (
            clean.checksum, clean.matches, clean.overflow
        )


# ------------------------------------------------- router epoch advance


def make_router(**kw):
    kw.setdefault("engine_defaults", {
        "ladder": BucketLadder(64, 256),
        "bounds": BBOX,
        "max_wait_s": 0.01,
    })
    return ServeRouter(CUSTOM, **kw)


class TestRouterEpochAdvance:
    def test_advance_updates_tenant_and_metrics(self, pts):
        ep = mk()
        ep.publish()
        with make_router() as router:
            router.add_tenant("a", ep.index, RES, warm=False)
            assert router.metrics()["tenants"]["a"]["epoch"] == 0
            edit_replace(ep)
            with telemetry.capture() as events:
                stats = router.advance_epoch("a", ep)
            assert stats["epoch"] == 1
            m = router.metrics()["tenants"]["a"]
            assert m["epoch"] == 1 and m["epoch_advances"] == 1
            adv = [e for e in events if e["event"] == "router_epoch_advanced"]
            assert adv and adv[0]["epoch"] == 1 and adv[0]["tenant"] == "a"
            np.testing.assert_array_equal(
                np.asarray(router.join("a", pts)),
                host_join(pts, ep.index.host, CUSTOM, RES),
            )

    def test_failed_advance_keeps_old_snapshot(self, pts):
        """A fault at router.swap mid-advance: the tenant keeps serving its
        current snapshot bit-identically, the tenant's epoch accounting is
        untouched, AND the epochal index stays on its previous published
        epoch."""
        ep = mk()
        ep.publish()
        old_oracle = host_join(pts, ep.index.host, CUSTOM, RES)
        with make_router() as router:
            router.add_tenant("a", ep.index, RES, warm=False)
            edit_replace(ep)
            with faults.transient_errors(1, sites=("router.swap",)):
                with pytest.raises(TransientDeviceError):
                    router.advance_epoch("a", ep)
            assert ep.epoch == 0
            m = router.metrics()["tenants"]["a"]
            assert m["epoch"] == 0 and m["epoch_advances"] == 0
            np.testing.assert_array_equal(
                np.asarray(router.join("a", pts)), old_oracle
            )
            # the delta log is durable: the retry publishes the epoch
            stats = router.advance_epoch("a", ep)
            assert stats["epoch"] == 1 and ep.epoch == 1

    def test_advance_epoch_reprofile_serves_the_live_epoch(self, pts):
        """``advance_epoch(reprofile=True)``: every answer after each
        reprofiled advance equals `pip_join` of the live epoch, at the
        epochal index's resolution."""
        ep = mk()
        ep.publish()
        with make_router() as router:
            router.add_tenant("a", ep.index, RES)
            for e in EDITS:
                e(ep)
                stats = router.advance_epoch("a", ep, reprofile=True)
                assert stats["reprofiled"] is True
                assert router._tenants["a"].engine.resolution == RES
                got = np.asarray(router.join("a", pts))
                want = pip_join(pts, None, CUSTOM, RES, chip_index=ep.index,
                                recheck=False, device="cpu")
                np.testing.assert_array_equal(got.astype(np.int64),
                                              want.astype(np.int64))
            m = router.metrics()["tenants"]["a"]
            assert m["epoch_advances"] == 3 and m["epoch"] == 3

    def test_failed_reprofiled_advance_keeps_the_old_epoch(self, pts):
        ep = mk()
        ep.publish()
        old_oracle = host_join(pts, ep.index.host, CUSTOM, RES)
        with make_router() as router:
            router.add_tenant("a", ep.index, RES, warm=False)
            edit_replace(ep)
            with faults.transient_errors(1, sites=("router.swap",)):
                with pytest.raises(TransientDeviceError):
                    router.advance_epoch("a", ep, reprofile=True)
            assert router.metrics()["tenants"]["a"]["epoch_advances"] == 0
            assert ep.epoch == 0
            np.testing.assert_array_equal(
                np.asarray(router.join("a", pts)), old_oracle
            )
