"""Shared inputs of the port's observability tests
(`tests/test_torch_{obs,ops_plane,recorder,slo,timeline,obs_tools}.py`):
a seeded synthetic trail that touches every stall class, every bridged
event and both kinds of interval, and a helper that resets the port's
process-wide registries. numpy and the port only."""

import numpy as np

#: ``(span name, stall class it lands in)`` of the synthetic trail's spans
SPANS = (
    ("stream.segment", "device"),
    ("dispatch.transfer.h2d", "transfer"),
    ("dispatch.compile", "compile"),
    ("stream.snapshot", "host_callback"),
    ("serve.dispatch", "device"),
    ("serve.request", None),  # a container: never classified
)

#: flat events the metric bridge folds, with the fields it reads
BRIDGED = (
    {"event": "capacity_overflow", "stage": "heavy", "attempt": 1},
    {"event": "escalation_resolved", "stage": "found"},
    {"event": "transient_retry", "label": "serve.dispatch"},
    {"event": "degraded", "label": "pip_join"},
    {"event": "watchdog_stall", "site": "stream.scan_step"},
    {"event": "fault_injected", "site": "serve.dispatch"},
    {"event": "fault_stall_injected", "site": "stream.scan_step"},
    {"event": "fault_batch_corrupted", "site": "stream.admit"},
    {"event": "serve_shed", "reason": "deadline"},
    {"event": "router_shed", "tenant": "tenant_0", "reason": "quota"},
    {"event": "slo_violation", "slo": "serve.shed"},
    {"event": "serve_compile", "bucket": 64, "signatures": 2},
    {"event": "serve_quarantine", "rows": 3},
    {"event": "stream_quarantine", "quarantined": 2},
    {"event": "snapshot_saved", "step": 2},
    {"event": "snapshot_skipped", "step": 3},
    {"event": "stream_stage", "stage": "compile", "seconds": 0.25},
    {"event": "stream_stage", "stage": "join_loop", "seconds": 1.5,
     "points_per_sec": 1234.5},
)


def synthetic_trail(seed: int = 0, n: int = 60) -> list:
    """``n`` rounds of seeded events on one monotonic axis: spans of every
    class (overlapping at random), ``serve_stage`` queue waits,
    ``serve_request`` latencies and sheds, and every bridged event, in a
    few traces; ``seq`` strictly increasing. A ``stream_stage``
    ``durable_loop`` event covering the whole trail comes last."""
    rng = np.random.default_rng(seed)
    events, seq, t = [], 0, 100.0
    traces = [f"{i:032x}" for i in range(1, 4)]
    for i in range(n):
        trace = traces[i % len(traces)]
        for name, _ in SPANS:
            start = round(t + float(rng.uniform(0.0, 0.05)), 6)
            sec = round(float(rng.uniform(0.001, 0.04)), 6)
            seq += 1
            events.append({
                "event": "span", "seq": seq, "ts_mono": round(start + sec, 6),
                "name": name, "trace_id": trace, "span_id": f"{seq:016x}",
                "parent_id": None if name == "serve.request" else f"{seq + 1:016x}",
                "seconds": sec, "start_mono": start,
            })
        seq += 1
        events.append({
            "event": "serve_stage", "stage": "queue_wait", "seq": seq,
            "seconds": round(float(rng.uniform(0.0, 0.01)), 6),
            "ts_mono": round(t + 0.06, 6), "trace_id": trace,
        })
        seq += 1
        events.append({
            "event": "serve_request", "seq": seq,
            "seconds": round(float(rng.exponential(0.02)), 6),
            "ts_mono": round(t + 0.07, 6), "rows": int(rng.integers(1, 1025)),
        })
        if rng.random() < 0.2:
            seq += 1
            events.append({"event": "serve_shed", "reason": "deadline",
                           "seq": seq, "ts_mono": round(t + 0.075, 6)})
        b = dict(BRIDGED[i % len(BRIDGED)])
        seq += 1
        b.update(seq=seq, ts_mono=round(t + 0.08, 6))
        events.append(b)
        t += 0.1
    seq += 1
    events.append({
        "event": "stream_stage", "stage": "durable_loop", "seq": seq,
        "seconds": round(t - 100.0, 6), "ts_mono": round(t, 6),
        "n_batches": n, "batch": 1024,
    })
    return events


def reset_port_plane() -> None:
    """Reset the port's process-wide registry, flight recorder, SLO
    monitor and health monitor (never the reference's)."""
    from mosaic_tpu_torch.obs import health, metrics, recorder, slo

    metrics.REGISTRY.reset()
    recorder.RECORDER.clear()
    slo.MONITOR.reset()
    health.MONITOR.reset()
