"""The port's durable stream against the JAX package's, on the CPU:
checkpoint/resume, watchdog, quarantine and stream fault injection.

Mirrors `tests/test_stream_faults.py` case for case, on its fixtures:
the custom grid at resolution 3 with two zones, K=3 batches of 1,024
points drawn with numpy seed 7 inside ``BOUNDS``, NB=7 batches and
snapshots every SNAP=2 ring cycles (boundaries 2, 4, 6, 7). The clean
run of each package is computed once, and every durable, resumed,
degraded or admitted run of the port must give the reference's
``(checksum, matches, overflow)`` (and its rows where it collects them),
tolerance 0:

1. kill-and-resume ≡ clean run under every injected fault plan, with the
   synchronous and the pipelined executor; and across packages: a run
   directory the reference's killed `run_durable` left is resumed by the
   port to the reference's clean stats;
2. quarantine exactness: injected poison rows appear exactly (and only)
   in the quarantine report, admitted rows' results are unchanged;
3. the watchdog turns an injected stall into a typed
   `StalledDeviceError` that the retry layer recovers;
4. degradation: on the CPU a segment that exhausts its retries is
   answered by the f64 host oracle and surfaces ``metrics["degraded"]``
   (on the card it raises `RetryExhausted`: a `gpu` test of
   `tests/test_torch_kernels_gpu.py`).

Fault plans are the port's own (`mosaic_tpu_torch.runtime.faults`); the
reference's plans are installed only for the cross-package kill.
"""

import os
import random

import numpy as np
import pytest

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.runtime import faults as ref_faults
from mosaic_tpu.runtime.retry import RetryPolicy as RefRetryPolicy
from mosaic_tpu.runtime.retry import backoff_delays as ref_backoff
from mosaic_tpu.sql import join as RJ
from mosaic_tpu.sql import stream as RS
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.runtime import (
    EpochFingerprintMismatch,
    RetryPolicy,
    StalledDeviceError,
    TransientDeviceError,
    backoff_delays,
    checkpoint,
    faults,
    is_transient,
    quarantine,
    telemetry,
    watchdog,
)
from mosaic_tpu_torch.sql import join as TJ
from mosaic_tpu_torch.sql.stream import StreamJoin, fold_stats_np, ring_from_host

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
REF = RefCustom(RefConf(*CONF))
PORT = CustomIndexSystem(GridConf(*CONF))
RES = 3
ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1), "
    "(5 5, 5 8, 8 8, 8 5, 5 5))",
    "POLYGON ((20 0, 30 0, 30 10, 25 4, 20 10, 20 0))",
]
K, BATCH, NB = 3, 1024, 7
SNAP = 2  # snapshot every 2 ring cycles -> boundaries at 2, 4, 6, 7
BOUNDS = (-25.0, -25.0, 35.0, 20.0)
FAST = RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)


def port_geometry(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


@pytest.fixture(scope="module")
def ixs():
    col = wkt.from_wkt(ZONES)
    ref = RJ.build_chip_index(ref_tessellate(col, REF, RES, keep_core_geoms=False))
    port = TJ.build_chip_index(
        tessellate(port_geometry(col), PORT, RES, keep_core_geoms=False),
        device="cpu",
    )
    return ref, port


@pytest.fixture(scope="module")
def index(ixs):
    return ixs[1]


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(7)
    return [
        rng.uniform(BOUNDS[:2], BOUNDS[2:], (BATCH, 2)) for _ in range(K)
    ]


@pytest.fixture(scope="module")
def ring(batches):
    return ring_from_host(batches, device="cpu")


@pytest.fixture(scope="module")
def sj(index):
    return StreamJoin(index, PORT, RES, prefetch=True)


@pytest.fixture(scope="module")
def ref_sj(ixs):
    return RS.StreamJoin(ixs[0], REF, RES, prefetch=True)


@pytest.fixture(scope="module")
def ref_clean(ref_sj, batches):
    """The reference's clean run: the answer every port run must give."""
    return ref_sj.run(RS.ring_from_host(batches), NB, collect=True)


@pytest.fixture(scope="module")
def clean(sj, ring, ref_clean):
    r = sj.run(ring, NB, collect=True)
    assert _stats(r) == _stats(ref_clean)
    np.testing.assert_array_equal(r.outs, ref_clean.outs)
    return r


def _stats(r):
    return (r.checksum, r.matches, r.overflow)


# ------------------------------------------------------------ checkpoint


def test_durable_run_equals_plain_run(sj, ring, clean, tmp_path):
    r = sj.run_durable(
        ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
        retry_policy=FAST,
    )
    assert _stats(r) == _stats(clean)
    assert r.metrics["degraded"] is False
    assert r.metrics["snapshots"] == 4  # boundaries 2, 4, 6, 7
    assert checkpoint.list_snapshots(str(tmp_path)) == [2, 4, 6, 7]


def test_durable_non_prefetch_equals_plain_run(index, ring, clean, tmp_path):
    sj0 = StreamJoin(index, PORT, RES, prefetch=False)
    r = sj0.run_durable(
        ring, NB, run_dir=str(tmp_path), snapshot_every=3,
        retry_policy=FAST,
    )
    assert _stats(r) == _stats(clean)


@pytest.mark.parametrize("kill_after", [1, 2, 3])
def test_kill_and_resume_bit_identical(sj, ring, clean, tmp_path, kill_after):
    """A fatal (non-transient) device loss after ``kill_after`` segments
    aborts the run; resume() from the last snapshot converges to the
    clean run's exact final stats."""
    d = str(tmp_path / f"kill{kill_after}")
    with faults.inject(
        fail_first=99, skip_first=kill_after,
        sites=("stream.scan_step",),
        exc_factory=lambda s: RuntimeError(f"simulated device loss @ {s}"),
    ):
        with pytest.raises(RuntimeError, match="simulated device loss"):
            sj.run_durable(
                ring, NB, run_dir=d, snapshot_every=SNAP,
                retry_policy=FAST,
            )
    assert checkpoint.list_snapshots(d)  # at least one boundary persisted
    r = sj.resume(d, ring, retry_policy=FAST, collect=True)
    assert _stats(r) == _stats(clean)
    assert r.metrics["resumed_from"] == kill_after * SNAP
    # the resumed call's rows are the clean run's from the cursor on
    np.testing.assert_array_equal(r.outs, clean.outs[kill_after * SNAP:])


def test_resume_skips_corrupt_snapshot(sj, ring, clean, tmp_path):
    """Bit rot / a kill mid-write on the NEWEST snapshot must fall back
    to the previous valid boundary, not fail the resume."""
    d = str(tmp_path)
    with faults.inject(
        fail_first=99, skip_first=2, sites=("stream.scan_step",),
        exc_factory=lambda s: RuntimeError("simulated device loss"),
    ):
        with pytest.raises(RuntimeError):
            sj.run_durable(
                ring, NB, run_dir=d, snapshot_every=SNAP,
                retry_policy=FAST,
            )
    steps = checkpoint.list_snapshots(d)
    assert steps == [2, 4]
    # truncate the newest npz: its sidecar hash no longer matches
    with open(os.path.join(d, "snap-00000004.npz"), "r+b") as f:
        f.truncate(64)
    with telemetry.capture() as ev:
        r = sj.resume(d, ring, retry_policy=FAST)
    assert _stats(r) == _stats(clean)
    assert r.metrics["resumed_from"] == 2
    kinds = [e["event"] for e in ev]
    assert "snapshot_corrupt_skipped" in kinds
    assert "snapshot_resumed" in kinds


def test_resume_rejects_wrong_ring(sj, ring, tmp_path):
    d = str(tmp_path)
    sj.run_durable(
        ring, NB, run_dir=d, snapshot_every=SNAP, retry_policy=FAST
    )
    other = ring + 1.0
    with pytest.raises(ValueError, match="fingerprint"):
        sj.resume(d, other, retry_policy=FAST)


def test_resume_without_snapshots_raises(sj, ring, tmp_path):
    with pytest.raises(FileNotFoundError):
        sj.resume(str(tmp_path / "empty"), ring)


def test_snapshot_atomicity_and_checksum_roundtrip(tmp_path):
    d = str(tmp_path)
    arrays = {"acc": np.arange(3, dtype=np.int32), "cells": np.arange(8)}
    checkpoint.save_snapshot(d, 5, arrays, {"n_batches": 9})
    loaded = checkpoint.load_latest(d)
    assert loaded is not None
    step, arrs, meta = loaded
    assert step == 5 and meta["n_batches"] == 9
    np.testing.assert_array_equal(arrs["acc"], arrays["acc"])
    np.testing.assert_array_equal(arrs["cells"], arrays["cells"])
    assert not [p for p in os.listdir(d) if p.endswith(".tmp")]


# --------------------------------------------------- transient + degraded


def test_transient_scan_faults_retry_to_clean(sj, ring, clean, tmp_path):
    with telemetry.capture() as ev:
        with faults.transient_errors(2, sites=("stream.scan_step",)):
            r = sj.run_durable(
                ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                retry_policy=FAST,
            )
    assert _stats(r) == _stats(clean)
    assert r.metrics["degraded"] is False
    assert [e["event"] for e in ev].count("transient_retry") == 2


def test_exhausted_segment_degrades_to_host_oracle(sj, ring, clean, tmp_path):
    """On the CPU degradation must surface in the STREAM metrics, never
    vanish into the fold. The degraded segment is answered by the f64
    host oracle; on this fixture the oracle agrees with the device bit
    for bit, so the final stats still equal clean."""
    with telemetry.capture() as ev:
        with faults.transient_errors(
            3, sites=("stream.scan_step",)
        ):  # == FAST.max_attempts: the first segment's budget exhausts
            r = sj.run_durable(
                ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                retry_policy=FAST,
            )
    assert r.metrics["degraded"] is True
    assert r.metrics["degraded_segments"] == 1
    assert _stats(r) == _stats(clean)
    kinds = [e["event"] for e in ev]
    assert "degraded" in kinds


def test_snapshot_failure_does_not_kill_run(sj, ring, clean, tmp_path):
    """A sick disk (every snapshot write failing) coarsens durability,
    but the stream still converges with the snapshot_skipped trail."""
    with telemetry.capture() as ev:
        with faults.transient_errors(999, sites=("stream.snapshot",)):
            r = sj.run_durable(
                ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                retry_policy=FAST,
            )
    assert _stats(r) == _stats(clean)
    assert r.metrics["snapshots"] == 0
    assert [e["event"] for e in ev].count("snapshot_skipped") == 4


# -------------------------------------------------------------- watchdog


def test_watchdog_guard_raises_typed_stall(monkeypatch):
    monkeypatch.setenv("MOSAIC_WATCHDOG_UNIT_SITE", "0.05")
    with telemetry.capture() as ev:
        with pytest.raises(StalledDeviceError) as ei:
            with faults.stalls(0.5, sites=("unit.site",)):
                watchdog.guard("unit.site", lambda: 42)
    assert ei.value.site == "unit.site"
    assert ei.value.deadline_s == pytest.approx(0.05)
    assert is_transient(ei.value)  # stalls ride the retry path
    assert isinstance(ei.value, TransientDeviceError)
    assert any(e["event"] == "watchdog_stall" for e in ev)


def test_watchdog_inline_when_disabled(monkeypatch):
    monkeypatch.delenv("MOSAIC_WATCHDOG_S", raising=False)
    assert watchdog.guard("no.deadline", lambda: 7) == 7
    assert watchdog.deadline_for("no.deadline") is None
    monkeypatch.setenv("MOSAIC_WATCHDOG_S", "3.5")
    assert watchdog.deadline_for("any.site") == 3.5
    monkeypatch.setenv("MOSAIC_WATCHDOG_ANY_SITE", "0")  # 0 disables
    assert watchdog.deadline_for("any.site") is None


def test_watchdog_stall_recovered_by_retry(sj, ring, clean, tmp_path,
                                           monkeypatch):
    """An injected mid-stream stall becomes a typed StalledDeviceError
    the retry layer recovers — the run completes with full, exact stats
    and the stall is visible in telemetry."""
    monkeypatch.setenv("MOSAIC_WATCHDOG_STREAM_SCAN_STEP", "0.15")
    with telemetry.capture() as ev:
        with faults.stalls(1.2, n=1, sites=("stream.scan_step",)):
            r = sj.run_durable(
                ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                retry_policy=FAST,
            )
    assert _stats(r) == _stats(clean)
    assert r.metrics["degraded"] is False
    kinds = [e["event"] for e in ev]
    assert "fault_stall_injected" in kinds
    assert "watchdog_stall" in kinds
    assert "transient_retry" in kinds


# ------------------------------------------------------------ quarantine


def test_quarantine_exact_poison_set(sj, batches, clean, ref_sj):
    """Injected poison rows appear exactly (and only) in the quarantine;
    admitted rows' results are bit-identical to the clean ring's, and
    the final fold equals the clean fold minus the poison rows'
    contributions (parked rows contribute exactly zero) — and the
    reference's admission of the same rows gives the same."""
    poisoned = [b.copy() for b in batches]
    poison = [(0, 3), (1, 5), (1, 6), (2, 100)]
    for bi, row in poison[:3]:
        poisoned[bi][row] = np.nan
    poisoned[2][100] = (1e6, 1e6)  # finite but far out of CRS bounds
    with telemetry.capture() as ev:
        ring_q, rep = sj.admit(poisoned, bounds=BOUNDS)
    assert rep.n_quarantined == 4
    assert sorted(rep.rows) == sorted(poison)
    assert rep.reasons["nonfinite"] == 3
    assert rep.reasons["out_of_bounds"] == 1
    assert rep.buffer.shape == (4, 2)
    assert any(e["event"] == "stream_quarantine" for e in ev)

    r = sj.run(ring_q, NB, collect=True)
    # admitted rows row-for-row identical to the clean ring's results
    mask = np.zeros((NB, BATCH), dtype=bool)
    for i in range(NB):
        for bi, row in poison:
            if i % K == bi:
                mask[i, row] = True
    np.testing.assert_array_equal(r.outs[~mask], clean.outs[~mask])
    # parked rows miss: exactly -1, zero fold contribution
    assert (r.outs[mask] == -1).all()
    want = fold_stats_np(np.where(mask, -1, clean.outs))
    assert (r.checksum & 0xFFFFFFFF) == (int(want[0]) & 0xFFFFFFFF)
    assert r.matches == int(want[1]) and r.overflow == int(want[2])
    ref_ring, ref_rep = ref_sj.admit(poisoned, bounds=BOUNDS)
    np.testing.assert_array_equal(ring_q.numpy(), np.asarray(ref_ring))
    assert sorted(ref_rep.rows) == sorted(rep.rows)
    rr = ref_sj.run(ref_ring, NB, collect=True)
    assert _stats(r) == _stats(rr)
    np.testing.assert_array_equal(r.outs, rr.outs)


def test_quarantine_via_fault_injection(sj, batches):
    """faults.corrupt_batches poisons admission inputs; the quarantine
    must catch exactly the corrupted rows and never mutate the caller's
    arrays."""
    originals = [b.copy() for b in batches]
    with faults.corrupt_batches(rows=4, n=1, sites=("stream.admit",)):
        ring_q, rep = sj.admit(batches, bounds=BOUNDS)
    for b, o in zip(batches, originals):
        np.testing.assert_array_equal(b, o)  # inputs untouched
    assert rep.n_quarantined == 4
    assert rep.rows == [(0, 0), (0, 1), (0, 2), (0, 3)]
    assert rep.reasons["nonfinite"] == 4
    # the admitted ring runs like any other: the loop equals the per-batch path
    assert _stats(sj.run(ring_q, NB)) == _stats(sj.run_batched(ring_q, NB))


def test_quarantine_metrics_surface_in_durable_run(sj, batches, tmp_path):
    poisoned = [b.copy() for b in batches]
    poisoned[0][0] = np.inf
    ring_q, rep = sj.admit(poisoned, bounds=BOUNDS)
    r = sj.run_durable(
        ring_q, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
        retry_policy=FAST,
    )
    assert r.metrics["quarantined"] == 1
    assert r.metrics["quarantine_reasons"] == {"nonfinite": 1}


def test_clean_admission_is_bit_identical_to_ring_from_host(sj, batches,
                                                            ring):
    ring_a, rep = sj.admit(batches, bounds=BOUNDS)
    assert rep.n_quarantined == 0
    np.testing.assert_array_equal(ring_a.numpy(), ring.numpy())


def test_degenerate_zone_mask_host_oracle():
    col = port_geometry(wkt.from_wkt([
        ZONES[0],                                      # healthy
        "POLYGON ((0 0, 2 2, 2 0, 0 2, 0 0))",         # bowtie
        "POLYGON ((0 0, 1 1, 2 2, 0 0))",              # zero area
        "POINT (3 3)",                                 # non-polygon: pass
    ]))
    mask, reasons = quarantine.degenerate_zone_mask(col)
    np.testing.assert_array_equal(mask, [False, True, True, False])
    assert reasons["self_intersecting"] == 1
    assert reasons["tiny_area"] == 1


# ----------------------------------------------- telemetry + retry seeds


def test_telemetry_events_totally_ordered(sj, ring, tmp_path):
    with telemetry.capture() as ev:
        sj.run_durable(
            ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
            retry_policy=FAST,
        )
    assert len(ev) >= 5
    seqs = [e["seq"] for e in ev]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    ts = [e["ts_mono"] for e in ev]
    assert all(b >= a for a, b in zip(ts, ts[1:]))


def test_snapshot_precedes_resume_in_event_order(sj, ring, clean, tmp_path):
    d = str(tmp_path)
    with telemetry.capture() as ev:
        with faults.inject(
            fail_first=9, skip_first=1, sites=("stream.scan_step",),
            exc_factory=lambda s: RuntimeError("kill"),
        ):
            with pytest.raises(RuntimeError):
                sj.run_durable(
                    ring, NB, run_dir=d, snapshot_every=SNAP,
                    retry_policy=FAST,
                )
        sj.resume(d, ring, retry_policy=FAST)
    saved = [e["seq"] for e in ev if e["event"] == "snapshot_saved"]
    resumed = [e["seq"] for e in ev if e["event"] == "snapshot_resumed"]
    assert saved and resumed
    assert min(resumed) > saved[0]  # the resume reads an earlier save


def test_backoff_jitter_deterministic_under_seed():
    """A seeded ``rng`` makes the jittered delays reproducible; so does
    the ``MOSAIC_RETRY_SEED`` knob, which the port reads as the
    reference does (`test_retry_seed_knob_matches_the_reference`)."""
    pol = RetryPolicy(base_delay_s=0.1, max_delay_s=1.0, jitter=0.5)
    d1 = backoff_delays(pol, rng=random.Random(1234))
    d2 = backoff_delays(pol, rng=random.Random(1234))
    assert [next(d1) for _ in range(5)] == [next(d2) for _ in range(5)]
    d3 = backoff_delays(pol, rng=random.Random(9))
    d4 = backoff_delays(pol, rng=random.Random(9))
    assert [next(d3) for _ in range(5)] == [next(d4) for _ in range(5)]


@pytest.mark.parametrize("seed", ["1234", "seed-text"])
def test_retry_seed_knob_matches_the_reference(monkeypatch, seed):
    """Under ``MOSAIC_RETRY_SEED`` each schedule restarts one seeded
    sequence: the port's first eight delays equal the reference's bit for
    bit, for an integer seed and for one that seeds by its text."""
    monkeypatch.setenv("MOSAIC_RETRY_SEED", seed)
    pol = RetryPolicy(base_delay_s=0.1, max_delay_s=1.0, jitter=0.5)
    ref_pol = RefRetryPolicy(base_delay_s=0.1, max_delay_s=1.0, jitter=0.5)
    port, ref = backoff_delays(pol), ref_backoff(ref_pol)
    got = [next(port) for _ in range(8)]
    want = [next(ref) for _ in range(8)]
    assert np.array(got).tobytes() == np.array(want).tobytes()
    again = backoff_delays(pol)
    assert [next(again) for _ in range(8)] == got
    # an injected rng still wins over the knob
    d = backoff_delays(pol, rng=random.Random(9))
    e = backoff_delays(pol, rng=random.Random(9))
    assert [next(d) for _ in range(8)] == [next(e) for _ in range(8)] != got


# ------------------------------------------------- pipelined executor


class TestPipelinedDurable:
    """The asynchronous pipelined mode (`dispatch/pipeline.py`) is
    bit-identical to the synchronous loop under EVERY fault plan the
    synchronous matrix pins — same sites, same budgets, same
    degradation — plus kill-at-every-boundary + resume."""

    def test_pipelined_equals_plain_and_sync(self, sj, ring, clean,
                                             tmp_path):
        r = sj.run_durable(
            ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
            retry_policy=FAST, pipeline=True,
        )
        assert _stats(r) == _stats(clean)
        assert r.metrics["degraded"] is False
        assert r.metrics["snapshots"] == 4  # boundaries 2, 4, 6, 7
        assert checkpoint.list_snapshots(str(tmp_path)) == [2, 4, 6, 7]
        p = r.metrics["pipeline"]
        assert p["launched"] == 4 and p["landed"] == 4
        assert p["window"] >= 1

    def test_pipelined_collect_outs_bit_identical(self, sj, ring, clean,
                                                  tmp_path):
        r = sj.run_durable(
            ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
            retry_policy=FAST, pipeline=True, collect=True,
        )
        np.testing.assert_array_equal(r.outs, clean.outs)

    def test_pipelined_non_prefetch_equals_plain(self, index, ring,
                                                 clean, tmp_path):
        sj0 = StreamJoin(index, PORT, RES, prefetch=False)
        r = sj0.run_durable(
            ring, NB, run_dir=str(tmp_path), snapshot_every=3,
            retry_policy=FAST, pipeline=True,
        )
        assert _stats(r) == _stats(clean)

    def test_env_knob_selects_pipelined_mode(self, sj, ring, clean,
                                             tmp_path, monkeypatch):
        monkeypatch.setenv("MOSAIC_STREAM_PIPELINE", "1")
        monkeypatch.setenv("MOSAIC_STREAM_WINDOW", "2")
        r = sj.run_durable(
            ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
            retry_policy=FAST,
        )
        assert _stats(r) == _stats(clean)
        assert r.metrics["pipeline"]["window"] == 2

    @pytest.mark.parametrize("kill_after", [1, 2, 3])
    def test_kill_and_resume_bit_identical(self, sj, ring, clean,
                                           tmp_path, kill_after):
        """Fatal device loss mid-flight: the pipeline's best-effort
        drain makes every already-launched segment durable, so the
        newest snapshot is exactly the kill boundary — and a PIPELINED
        resume converges to the clean stats bit for bit."""
        d = str(tmp_path / f"kill{kill_after}")
        with faults.inject(
            fail_first=99, skip_first=kill_after,
            sites=("stream.scan_step",),
            exc_factory=lambda s: RuntimeError(
                f"simulated device loss @ {s}"
            ),
        ):
            with pytest.raises(RuntimeError, match="simulated device loss"):
                sj.run_durable(
                    ring, NB, run_dir=d, snapshot_every=SNAP,
                    retry_policy=FAST, pipeline=True,
                )
        assert checkpoint.list_snapshots(d)
        r = sj.resume(d, ring, retry_policy=FAST, pipeline=True)
        assert _stats(r) == _stats(clean)
        assert r.metrics["resumed_from"] == kill_after * SNAP

    def test_transient_faults_retry_to_clean(self, sj, ring, clean,
                                             tmp_path):
        with telemetry.capture() as ev:
            with faults.transient_errors(2, sites=("stream.scan_step",)):
                r = sj.run_durable(
                    ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                    retry_policy=FAST, pipeline=True,
                )
        assert _stats(r) == _stats(clean)
        assert r.metrics["degraded"] is False
        assert [e["event"] for e in ev].count("transient_retry") == 2

    def test_exhausted_segment_degrades_to_host_oracle(self, sj, ring,
                                                       clean, tmp_path):
        with telemetry.capture() as ev:
            with faults.transient_errors(3, sites=("stream.scan_step",)):
                r = sj.run_durable(
                    ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                    retry_policy=FAST, pipeline=True,
                )
        assert _stats(r) == _stats(clean)
        assert r.metrics["degraded"] is True
        assert r.metrics["degraded_segments"] == 1
        assert "degraded" in [e["event"] for e in ev]

    def test_snapshot_failure_does_not_kill_run(self, sj, ring, clean,
                                                tmp_path):
        """Sick disk with the writes on the BACKGROUND thread: the
        adopted fault plans trip inside the writer's guarded call,
        every boundary degrades to ``snapshot_skipped``, and the run
        still answers exactly."""
        with telemetry.capture() as ev:
            with faults.transient_errors(
                999, sites=("stream.snapshot",)
            ):
                r = sj.run_durable(
                    ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                    retry_policy=FAST, pipeline=True,
                )
        assert _stats(r) == _stats(clean)
        assert r.metrics["snapshots"] == 0
        skipped = [e for e in ev if e["event"] == "snapshot_skipped"]
        assert len(skipped) == 4

    def test_watchdog_stall_recovered_by_retry(self, sj, ring, clean,
                                               tmp_path, monkeypatch):
        monkeypatch.setenv("MOSAIC_WATCHDOG_STREAM_SCAN_STEP", "0.15")
        with telemetry.capture() as ev:
            with faults.stalls(1.2, n=1, sites=("stream.scan_step",)):
                r = sj.run_durable(
                    ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                    retry_policy=FAST, pipeline=True,
                )
        assert _stats(r) == _stats(clean)
        assert r.metrics["degraded"] is False
        kinds = [e["event"] for e in ev]
        assert "watchdog_stall" in kinds
        assert "transient_retry" in kinds

    def test_snapshot_spans_marked_async(self, sj, ring, tmp_path):
        """The writer thread emits the same ``stream.snapshot`` spans
        (adopted trace context) with ``mode="async"``."""
        with telemetry.capture() as ev:
            sj.run_durable(
                ring, NB, run_dir=str(tmp_path), snapshot_every=SNAP,
                retry_policy=FAST, pipeline=True,
            )
        snaps = [
            e for e in ev
            if e["event"] == "span" and e.get("name") == "stream.snapshot"
        ]
        assert len(snaps) == 4
        assert all(s.get("mode") == "async" for s in snaps)
        flushes = [
            e for e in ev
            if e["event"] == "span"
            and e.get("name") == "stream.pipeline.flush"
        ]
        assert len(flushes) == 1


# --------------------------------------------- across the two packages


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_port_resumes_the_references_killed_run(ref_sj, sj, batches, ring,
                                                 ref_clean, tmp_path, pipeline):
    """The reference's `run_durable` is killed after 2 segments; the
    port's `resume` on that run directory, with the same ring, ends at
    the reference's clean stats: same layout, same ring and index
    fingerprints, same carry."""
    d = str(tmp_path)
    with ref_faults.inject(
        fail_first=99, skip_first=2, sites=("stream.scan_step",),
        exc_factory=lambda s: RuntimeError("simulated device loss"),
    ):
        with pytest.raises(RuntimeError, match="simulated device loss"):
            ref_sj.run_durable(
                RS.ring_from_host(batches), NB, run_dir=d, snapshot_every=SNAP,
                retry_policy=RefRetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0),
            )
    assert checkpoint.list_snapshots(d) == [2, 4]
    r = sj.resume(d, ring, retry_policy=FAST, pipeline=pipeline, collect=True)
    assert r.metrics["resumed_from"] == 4
    assert _stats(r) == _stats(ref_clean)
    np.testing.assert_array_equal(r.outs, ref_clean.outs[4:])


def test_resume_refuses_another_index(sj, ring, batches, tmp_path):
    """A snapshot taken against one index is never finished against
    another: `EpochFingerprintMismatch`, the reference's refusal."""
    d = str(tmp_path)
    with faults.inject(
        fail_first=99, skip_first=1, sites=("stream.scan_step",),
        exc_factory=lambda s: RuntimeError("kill"),
    ):
        with pytest.raises(RuntimeError):
            sj.run_durable(ring, NB, run_dir=d, snapshot_every=SNAP, retry_policy=FAST)
    other = TJ.build_chip_index(
        tessellate(port_geometry(wkt.from_wkt(ZONES[:1])), PORT, RES,
                   keep_core_geoms=False),
        device="cpu",
    )
    with pytest.raises(EpochFingerprintMismatch) as ei:
        StreamJoin(other, PORT, RES).resume(d, ring, retry_policy=FAST)
    assert ei.value.expected == checkpoint.index_identity(sj.index)
    assert ei.value.actual == checkpoint.index_identity(other)
    assert ei.value.expected != ei.value.actual


def test_checkpoint_fingerprints_equal_the_references(ixs, ring, batches):
    """A tensor fingerprints as its host bytes: the port's ring and index
    identity equal the reference's for the same values."""
    from mosaic_tpu.runtime import checkpoint as ref_checkpoint

    assert checkpoint.fingerprint(ring) == ref_checkpoint.fingerprint(
        RS.ring_from_host(batches))
    assert checkpoint.index_identity(ixs[1]) == ref_checkpoint.index_identity(ixs[0])
