"""The stream driver: a ring of ``ring`` slots of ``batch`` points made on
the card from the seed, joined by one ``StreamJoin(probe="adaptive")``
whose caps are sized from the exact lane counts of every slot with 5%
headroom (as the stream bench sizes them). The window calls ``run()``
over whole ring cycles until ``--seconds`` have passed; each ``run`` ends
with its fold pulled to the host.

Afterwards one more cycle of the same ``StreamJoin`` with
``collect=True`` gives every point's answer; each window run's fold
(checksum, matches, overflow) is held against the fold of those answers,
and the answers go to the reference.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np

#: cap headroom over the largest slot's exact lane count
HEADROOM = 1.05
#: ring cycles in the profiled window of a traced run
PROFILED_CYCLES = 2


def next_pow2(n: int, lo: int = 16) -> int:
    return max(lo, 1 << int(math.ceil(math.log2(max(n, 1)))))


def wrap32(v: int) -> int:
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def fold(outs: np.ndarray) -> tuple[int, int, int]:
    """(checksum, matches, overflow) of int32 answers, as the stream folds
    them: the XOR-shift checksum summed and wrapped to int32, the answers
    >= 0, the answers -2."""
    o = outs.astype(np.int64)
    return (wrap32(int((o ^ (o >> 16)).sum())), wrap32(int((o >= 0).sum())),
            wrap32(int((o == -2).sum())))


def run(r):
    import torch
    from torch.profiler import record_function

    from mosaic_tpu_torch.sql.stream import StreamJoin

    from geobench import points, port, roofline
    from geobench.harness import Outcome
    from geobench import trace as T

    t = r.cell.traffic
    k, b = int(t["ring"]), int(t["batch"])
    dev = r.device
    gen = points.generator(r.seed, dev)
    ring = points.make(t["points"], r.cell.config, r.polys, k * b, gen, dev)
    ring = ring.reshape(k, b, 2).contiguous()
    r.clock.stage("data")

    f = port.fields(r.index)
    if f is None:
        raise RuntimeError("the index lacks a ChipIndex field the harness reads "
                           f"({', '.join(port.FIELDS)}, border.shift)")
    assign = StreamJoin(r.index, r.index_system, r.resolution, probe=r.cell.config["join"]["probe"]).assign
    rows, counts = [], []
    for i in range(k):
        ln = port.lanes(assign(ring[i]), f)
        rows.append(ln["row"])
        counts.append([int(ln["found"].sum()), int(ln["heavy"].sum()), int(ln["convex"].sum())])
    top = [max(c[j] for c in counts) for j in range(3)]
    caps = {name: min(next_pow2(int(top[j] * HEADROOM) + 1), b)
            for j, name in enumerate(("found_cap", "heavy_cap", "convex_cap"))}
    sj = StreamJoin(r.index, r.index_system, r.resolution,
                    probe=r.cell.config["join"]["probe"], **caps)
    sj.compile(ring, k)
    r.clock.done()

    folds, walls = [], []
    t0 = time.perf_counter()
    deadline = t0 + r.seconds
    while True:
        ts = time.perf_counter()
        res = sj.run(ring, k)
        te = time.perf_counter()
        walls.append(te - ts)
        folds.append((res.checksum, res.matches, res.overflow))
        if te >= deadline:
            break
    window_s = te - t0

    tr = None
    if r.trace:
        tr = T.Trace()
        # CUDA events first: a process the profiler has traced runs its
        # later eager ops slower
        if dev.type == "cuda":
            for i in range(k):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                cells = sj.assign(ring[i])
                ev[1].record()
                sj.join(ring[i], cells, sj.index)
                ev[2].record()
                torch.cuda.synchronize()
                for name, a, z in (("stream.assign", 0, 1), ("stream.join", 1, 2)):
                    tr.spans.append({"name": name, "seconds": ev[a].elapsed_time(ev[z]) / 1e3,
                                     "points": b, "clock": "device"})

        def cycles():
            for _ in range(PROFILED_CYCLES):
                with record_function("stream.run"):
                    sj.run(ring, k)

        tr.profile = T.profile(cycles)
        if r.index.num_heavy_cells:
            w = [roofline.heavy_work(ring[i], rows[i], f) for i in range(k)]
            tr.work["pip_heavy_tiled"] = {
                "bytes": PROFILED_CYCLES * sum(x["bytes"] for x in w),
                "ops": PROFILED_CYCLES * sum(x["ops"] for x in w),
                "launches": PROFILED_CYCLES * k,
            }

    collected = sj.run(ring, k, collect=True)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    outs = collected.outs.reshape(-1)
    want = fold(outs)
    del sj, assign, rows
    r.index = None
    return Outcome(
        attempted=len(folds) * k,
        failed=sum(k for x in folds if x[2] != 0),
        e2e={"stream_points_per_s": len(folds) * k * b / window_s},
        memory_peak_bytes=peak,
        points=ring.reshape(-1, 2),
        answers=outs,
        checks={
            "fold_runs_differing": (sum(x != want for x in folds), 0),
            "overflow_points": (int((outs == -2).sum()), 0),
        },
        trace=tr,
        lines=[{"lanes": {"batch": b, "ring": k, "found_heavy_convex_by_slot": counts,
                          "caps": caps}},
               {"window": {"runs": len(folds), "window_s": window_s, "points": len(folds) * k * b,
                           "run_s_quartiles": statistics.quantiles(walls, n=4) if len(walls) > 1 else walls,
                           "run_s_min_max": [min(walls), max(walls)]}}],
    )
