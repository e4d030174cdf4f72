"""The batch driver: one caller in a closed loop of ``pip_join(points,
None, <system>, <res>, chip_index=..., probe="adaptive")`` calls, each on
one host-resident numpy partition of ``partition`` float64 points, cycling
a pool of ``pool`` partitions made from the seed. Every call ends with its
numpy answer. The window runs calls until one ends past ``--seconds``;
every call counts. A call fails if it raises, returns a
``DegradedResult`` or holds an overflow (-2). The last answer the window
gave for each partition goes to the reference.
"""

from __future__ import annotations

import statistics
import sys
import time
import traceback

import numpy as np

#: calls in the profiled window of a traced run
PROFILED_CALLS = 4


def run(r):
    import torch
    from torch.profiler import record_function

    from mosaic_tpu_torch.runtime import DegradedResult, telemetry
    from mosaic_tpu_torch.sql.join import pip_join

    from geobench import points
    from geobench.harness import Outcome
    from geobench import trace as T

    t = r.cell.traffic
    n_pool, b = int(t["pool"]), int(t["partition"])
    dev = r.device
    gen = points.generator(r.seed, dev)
    made = points.make(t["points"], r.cell.config, r.polys, n_pool * b, gen, dev)
    pool = [np.ascontiguousarray(made[i * b:(i + 1) * b].cpu().numpy()) for i in range(n_pool)]
    del made
    r.clock.stage("data")
    ix, system, res = r.index, r.index_system, r.resolution
    join = r.cell.config["join"]

    def call(x):
        return pip_join(x, None, system, res, chip_index=ix, probe=join["probe"],
                        recheck=join["exact_recheck"], device=dev)

    with telemetry.capture() as events:
        for x in pool:
            call(x)
    routes = [{k: e[k] for k in ("found", "heavy", "convex", "light")}
              for e in events if e.get("event") == "probe_route"]
    r.clock.done()

    last = [None] * n_pool
    calls, failed, spans = 0, 0, []
    t0 = time.perf_counter()
    deadline = t0 + r.seconds
    while True:
        i = calls % n_pool
        ts = time.perf_counter()
        try:
            out = call(pool[i])
        except Exception:  # a failed call is counted, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            out = None
        te = time.perf_counter()
        calls += 1
        spans.append({"name": "batch.call", "seconds": te - ts, "points": b, "clock": "host"})
        if out is None or isinstance(out, DegradedResult) or bool((np.asarray(out) == -2).any()):
            failed += 1
        if out is not None:
            last[i] = np.asarray(out)
        if te >= deadline:
            break
    window_s = te - t0
    secs = [x["seconds"] for x in spans]

    tr = None
    if r.trace:
        tr = T.Trace(spans=spans)

        def calls_profiled():
            for j in range(PROFILED_CALLS):
                with record_function("batch.call"):
                    call(pool[j % n_pool])

        tr.profile = T.profile(calls_profiled)

    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    # every partition the window answered is judged (all of them once the
    # window has made as many calls as the pool holds); with none answered,
    # all are judged, as unanswered (-3)
    judged = [i for i in range(n_pool) if last[i] is not None] or list(range(n_pool))
    r.index = ix = None
    return Outcome(
        attempted=calls,
        failed=failed,
        e2e={"join_points_per_s": calls * b / window_s},
        memory_peak_bytes=peak,
        points=np.concatenate([pool[i] for i in judged]),
        answers=np.concatenate([last[i] if last[i] is not None else np.full(b, -3, np.int32)
                                for i in judged]),
        checks={"failed_calls": (failed, 0)},
        trace=tr,
        lines=[{"probe_route": routes},
               {"window": {"calls": calls, "window_s": window_s, "points": calls * b,
                           "partitions_judged": len(judged),
                           "call_s_quartiles": statistics.quantiles(secs, n=4) if calls > 1 else secs,
                           "call_s_min_max": [min(secs), max(secs)]}}],
    )
