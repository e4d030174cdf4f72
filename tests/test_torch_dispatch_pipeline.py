"""Unit contracts for the port's pipelined execution core
(`mosaic_tpu_torch/dispatch/pipeline.py`): bounded-window ordering, the
replay-from-materialized-carry rule, best-effort drain on fatal errors,
and the SnapshotWriter's context adoption + held-error/durability
barriers.

Mirrors `tests/test_dispatch_pipeline.py` case for case on the port
(the core is host Python, with the same synthetic launch/land callbacks
and the same expected orders and counts). Frontend-level semantics
(bit-identity, kill/resume, degradation) are pinned where they live:
tests/test_torch_stream_faults.py and tests/test_torch_raster_stream.py.
"""

from __future__ import annotations

import threading
import time

import pytest

from mosaic_tpu_torch.dispatch import (
    SnapshotWriter,
    execute_pipeline,
    resolve_window,
)
from mosaic_tpu_torch.obs import trace
from mosaic_tpu_torch.runtime import faults, telemetry
from mosaic_tpu_torch.runtime.errors import TransientDeviceError


class TestResolveWindow:
    def test_default(self, monkeypatch):
        monkeypatch.delenv("MOSAIC_STREAM_WINDOW", raising=False)
        assert resolve_window() == 4

    def test_env_knob(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_STREAM_WINDOW", "7")
        assert resolve_window() == 7

    def test_explicit_beats_env(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_STREAM_WINDOW", "7")
        assert resolve_window(2) == 2

    def test_clamped_to_one(self):
        assert resolve_window(0) == 1
        assert resolve_window(-3) == 1

    def test_garbage_env_raises(self, monkeypatch):
        """One reader of the env, one rule: `tune/resolve.py` refuses a
        malformed knob (the reference's `resolve_window` falls back to 4
        while its entry points raise)."""
        monkeypatch.setenv("MOSAIC_STREAM_WINDOW", "many")
        with pytest.raises(ValueError, match="stream_window"):
            resolve_window()
        assert resolve_window(3) == 3


class TestExecutePipeline:
    def test_lands_in_order_and_counts(self):
        landed = []
        stats = execute_pipeline(
            10, lambda i: i * i,
            lambda i, h: landed.append((i, h)),
            drain_site="t.drain", window=3,
        )
        assert landed == [(i, i * i) for i in range(10)]
        assert stats.launched == 10 and stats.landed == 10
        assert stats.max_inflight == 3
        assert stats.replays == 0 and stats.replayed == 0

    def test_window_bounds_inflight(self):
        live = set()
        high = [0]

        def launch(i):
            live.add(i)
            high[0] = max(high[0], len(live))
            return i

        stats = execute_pipeline(
            12, launch, lambda i, h: live.discard(i),
            drain_site="t.drain", window=2,
        )
        assert high[0] == 2
        assert stats.max_inflight == 2

    def test_window_one_is_the_synchronous_loop(self):
        order = []
        execute_pipeline(
            4, lambda i: order.append(("launch", i)),
            lambda i, h: order.append(("land", i)),
            drain_site="t.drain", window=1,
        )
        assert order == [
            (op, i) for i in range(4) for op in ("launch", "land")
        ]

    def test_transient_drain_replays_from_materialized_carry(self):
        landed, replays = [], []
        boom = [True]

        def land(i, h):
            if i == 1 and boom[0]:
                boom[0] = False
                raise TransientDeviceError("drain hiccup")
            landed.append(i)

        with telemetry.capture() as ev:
            stats = execute_pipeline(
                5, lambda i: i, land, drain_site="t.drain",
                replay=lambda lo, hi: replays.append((lo, hi)),
                window=2,
            )
        # launches 0,1 -> land 0 -> launch 2 -> land 1 FAILS with
        # items 1,2 in flight: the window is discarded and the caller
        # replays [materialized+1 .. last launched] = [1, 2]
        assert replays == [(1, 2)]
        assert landed == [0, 3, 4]
        assert stats.replays == 1 and stats.replayed == 2
        kinds = [e["event"] for e in ev]
        assert kinds.count("pipeline_replay") == 1

    def test_transient_launch_discards_unlanded_window(self):
        replays = []
        boom = [True]

        def launch(i):
            if i == 1 and boom[0]:
                boom[0] = False
                raise TransientDeviceError("launch hiccup")
            return i

        stats = execute_pipeline(
            3, launch, lambda i, h: None, drain_site="t.drain",
            replay=lambda lo, hi: replays.append((lo, hi)),
            window=4,
        )
        # item 0 was launched but NOT yet materialized when launch(1)
        # failed — it is part of the poisoned window and replays too
        assert replays == [(0, 1)]
        assert stats.replayed == 2

    def test_commit_runs_on_caller_thread_with_pulled_value(self):
        # the guarded pull runs on the watchdog worker (a deadline is
        # set), but commit — where effects live — must run on the
        # caller thread, only after the pull returned
        main = threading.get_ident()
        land_threads, commits = [], []

        def land(i, h):
            land_threads.append(threading.get_ident())
            return h * 10

        def commit(i, pulled):
            commits.append((i, pulled, threading.get_ident()))

        execute_pipeline(
            3, lambda i: i, land, commit=commit,
            drain_site="t.drain", window=2, watchdog_default_s=30.0,
        )
        assert [(i, p) for i, p, _ in commits] == [(0, 0), (1, 10), (2, 20)]
        assert all(t == main for _, _, t in commits)
        assert all(t != main for t in land_threads)

    def test_transient_commit_replays_own_item(self):
        # the replay anchor advances only after commit returns: a
        # transient mid-commit replays the SAME item from the pre-item
        # carry — it is neither skipped nor applied twice
        commits, replays = [], []
        boom = [True]

        def commit(i, pulled):
            if i == 1 and boom[0]:
                boom[0] = False
                raise TransientDeviceError("commit hiccup")
            commits.append(i)

        stats = execute_pipeline(
            5, lambda i: i, lambda i, h: h, commit=commit,
            drain_site="t.drain",
            replay=lambda lo, hi: replays.append((lo, hi)), window=2,
        )
        assert replays == [(1, 2)]
        assert commits == [0, 3, 4]
        assert stats.replays == 1 and stats.replayed == 2

    def test_deadline_abandoned_land_commits_nothing(self):
        # the watchdog ABANDONS its worker on deadline: the stalled
        # pull eventually finishes in the background, but its item was
        # already replayed — commit must never run for it, or the
        # item's effects would double-apply
        commits, replays = [], []
        slow = [True]

        def land(i, h):
            if i == 1 and slow[0]:
                slow[0] = False
                time.sleep(0.3)  # blocks past the drain deadline
            return h

        stats = execute_pipeline(
            4, lambda i: i, land,
            commit=lambda i, pulled: commits.append(i),
            drain_site="t.drain",
            replay=lambda lo, hi: replays.append((lo, hi)),
            window=2, watchdog_default_s=0.1,
        )
        time.sleep(0.4)  # let the abandoned worker finish its pull
        assert replays == [(1, 2)]
        assert commits == [0, 3]  # item 1 committed by nobody but replay
        assert stats.replays == 1

    def test_transient_without_replay_propagates(self):
        def land(i, h):
            raise TransientDeviceError("no replay path")

        with pytest.raises(TransientDeviceError):
            execute_pipeline(
                3, lambda i: i, land, drain_site="t.drain", window=2,
            )

    def test_fatal_launch_drains_completed_work_then_raises(self):
        landed = []

        def launch(i):
            if i == 3:
                raise RuntimeError("simulated device loss")
            return i

        with pytest.raises(RuntimeError, match="device loss"):
            execute_pipeline(
                6, launch, lambda i, h: landed.append(i),
                drain_site="t.drain", window=2,
            )
        # everything launched before the fatal error still lands —
        # the durable caller's snapshots become resume points
        assert landed == [0, 1, 2]

    def test_fatal_drain_error_wins_over_best_effort(self):
        def land(i, h):
            raise ValueError(f"bad land {i}")

        with pytest.raises(ValueError, match="bad land 0"):
            execute_pipeline(
                4, lambda i: i, land, drain_site="t.drain", window=2,
            )

    def test_empty_input(self):
        stats = execute_pipeline(
            0, lambda i: i, lambda i, h: None, drain_site="t.drain",
        )
        assert stats.launched == 0 and stats.landed == 0

    def test_drain_emits_stage_and_span(self):
        with telemetry.capture() as ev:
            execute_pipeline(
                2, lambda i: i, lambda i, h: None,
                drain_site="t.drain", window=1,
            )
        stages = [
            e for e in ev
            if e["event"] == "stream_stage"
            and e.get("stage") == "pipeline_drain"
        ]
        spans = [
            e for e in ev
            if e["event"] == "span"
            and e.get("name") == "stream.pipeline.drain"
        ]
        assert len(stages) == 2 and len(spans) == 2
        assert all(s["site"] == "t.drain" for s in stages)


class TestSnapshotWriter:
    def test_jobs_run_fifo_and_flush_is_a_barrier(self):
        done = []
        w = SnapshotWriter(name="t", maxsize=4)
        for i in range(6):
            w.submit(lambda i=i: done.append(i))
        w.flush()
        assert done == list(range(6))
        assert w.pending == 0
        w.close()

    def test_worker_adopts_telemetry_sinks(self):
        with telemetry.capture() as ev:
            w = SnapshotWriter(name="t")
            w.submit(lambda: telemetry.record("from_writer", ok=True))
            w.flush()
            w.close()
        assert any(e["event"] == "from_writer" for e in ev)

    def test_worker_shares_fault_budgets(self):
        # the plan list is SHARED (not copied): budget consumed on the
        # writer thread is visible to the caller — one budget, two
        # threads, exactly like an inline write
        with faults.transient_errors(1, sites=("t.site",)):
            w = SnapshotWriter(name="t")
            hits = []

            def job():
                try:
                    faults.maybe_fail("t.site")
                except TransientDeviceError:
                    hits.append(1)

            w.submit(job)
            w.flush()
            # budget of 1 was consumed by the writer thread
            faults.maybe_fail("t.site")  # must NOT raise
            w.close()
        assert hits == [1]

    def test_job_error_held_and_reraised_on_flush(self):
        w = SnapshotWriter(name="t")
        w.submit(lambda: (_ for _ in ()).throw(OSError("disk on fire")))
        with pytest.raises(OSError, match="disk on fire"):
            w.flush()
        # the error does not re-raise twice
        w.flush()
        w.close()

    def test_submit_after_close_raises(self):
        w = SnapshotWriter(name="t")
        w.close()
        with pytest.raises(RuntimeError, match="closed"):
            w.submit(lambda: None)

    def test_close_noflush_abandons_queued_jobs(self):
        # flush=False is the fatal-unwind path: queued jobs must NOT
        # run (the STOP marker may not queue FIFO behind them) and
        # close must not block on a full queue
        gate = threading.Event()
        ran = []
        w = SnapshotWriter(name="t", maxsize=2)
        w.submit(gate.wait)  # occupies the worker
        w.submit(lambda: ran.append(1))
        w.submit(lambda: ran.append(2))  # queue now full

        def release():
            time.sleep(0.05)
            gate.set()

        threading.Thread(target=release).start()  # lint: thread-context-adoption-ok (test timer thread: only sets an Event, records nothing)
        w.close(flush=False)
        assert ran == []
        assert w.pending == 0

    def test_backpressure_blocks_submit(self):
        gate = threading.Event()
        w = SnapshotWriter(name="t", maxsize=1)
        w.submit(gate.wait)  # occupies the worker
        w.submit(lambda: None)  # fills the queue
        t0 = time.perf_counter()

        def release():
            time.sleep(0.05)
            gate.set()

        threading.Thread(target=release).start()  # lint: thread-context-adoption-ok (test timer thread: only sets an Event, records nothing)
        w.submit(lambda: None)  # must block until the worker drains
        assert time.perf_counter() - t0 >= 0.04
        w.close()


def test_writer_jobs_join_the_callers_trace():
    """Spans a snapshot job opens on the writer thread are children of the
    span that was active where the writer was created."""
    with telemetry.capture() as ev:
        with trace.span("unit.parent") as parent:
            w = SnapshotWriter(name="t")

            def job():
                with trace.span("unit.child"):
                    pass

            w.submit(job)
            w.flush()
            w.close()
    child = next(e for e in ev if e["event"] == "span" and e["name"] == "unit.child")
    assert child["trace_id"] == parent.context.trace_id
    assert child["parent_id"] == parent.context.span_id
