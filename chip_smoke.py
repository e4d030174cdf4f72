#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Runs ``mosaic_tpu_torch`` (never the JAX package) on the card:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles ``mosaic_tpu_torch/kernels/csrc/pip.cu`` with nvcc;
3. index: tessellates the 256 ``synthetic_zones(16, 16, verts=256)`` zones
   at H3 resolution 9 and builds the join index on the card;
4. pip_heavy_tiled: the kernel on the real heavy tables and the compacted
   heavy points of a 4M-point batch, equal bit for bit to its plain torch
   version with and without the epsilon band, timed against its bound;
5. pip_zone: the brute-force zone kernel (the bench's zone lane) at 500k
   points, equal bit for bit to its plain version on a 16,384-point
   subset, timed on all 500k against its bound;
6. main path: ``pip_join(probe="adaptive")`` on the 4M batch must launch
   the heavy kernel and equal ``probe="scatter"`` bit for bit; prints
   points/s and the agreement with the f64 host oracle on 100k points
   (at least ``MIN_ORACLE_AGREEMENT``: f32 rounding near boundaries is
   expected, a wrong path is not); then where the time of one warm join
   goes (stage times and the profiler's device time by op);
7. a ``kernels`` line with each kernel's launches, times and bound.

Every phase prints one JSON line; any failed check exits non-zero. The
last line is ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA card is available or the package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

N_POINTS = 4_000_000       # the bench's batch
N_ZONE = 500_000           # the bench's zone-kernel lane
N_ZONE_CHECK = 16_384      # subset held against the plain version
N_ORACLE = 100_000         # subset held against the f64 host oracle
RES = 9
SEED = 11
ZONES = (16, 16)
DEVICE = "cuda"

#: H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
#: f32 operations per (point, real edge) test of the heavy kernel without
#: the band: 3 compares, 1 equality test, 3 subtractions, 1 multiply,
#: 1 divide, 1 add
OPS_HEAVY = 10
#: f32 operations per (point, zone slot, edge) test of the zone kernel, the
#: count bench.py uses for the same lane
OPS_ZONE = 8
#: floor on the join's agreement with the f64 host oracle. Exact agreement
#: is not expected (f32 cells and edges differ from f64 near cell and zone
#: boundaries, which the later epsilon-band recheck repairs); a path that
#: is wrong, and not merely rounded, falls far below it
MIN_ORACLE_AGREEMENT = 0.99


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "mosaic_tpu_torch")):
        print("chip_smoke: mosaic_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from mosaic_tpu_torch.core.geometry.device import pack_to_device
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.datasets import NYC_BBOX, random_points, synthetic_zones
    from mosaic_tpu_torch.kernels import _build
    from mosaic_tpu_torch.kernels import pip as K
    from mosaic_tpu_torch.sql import join as J

    dev = torch.device(DEVICE)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave no output"
    print(card, flush=True)
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    # 2. build
    t0 = time.perf_counter()
    _build.load("pip")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.BUILD_LOGS.get("pip", "").splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    # 3. index
    H3 = H3IndexSystem()
    zones = synthetic_zones(*ZONES, verts=256)
    t0 = time.perf_counter()
    table = tessellate(zones, H3, RES, keep_core_geoms=False)
    t1 = time.perf_counter()
    ix = J.build_chip_index(table, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    table_bytes = sum(
        getattr(ix, n).numel() * getattr(ix, n).element_size()
        for n in J.ChipIndex.field_names()
    )
    emit({
        "phase": "index", "zones": len(zones), "res": RES,
        "cells": ix.num_cells, "heavy": ix.num_heavy_cells,
        "convex": ix.num_convex_cells,
        "cell_edges": list(ix.cell_edges.shape),
        "heavy_edges": list(ix.heavy_edges.shape),
        "heavy_slot_geom": list(ix.heavy_slot_geom.shape),
        "table_mb": table_bytes / 1e6,
        "tessellate_s": t1 - t0, "build_s": t2 - t1,
    })
    if ix.num_heavy_cells == 0:
        return fail("the index has no heavy cells: the heavy lane is not exercised")

    raw = random_points(N_POINTS, NYC_BBOX, seed=SEED)
    shift = ix.host.shift
    pts_f32 = torch.from_numpy(raw).to(dev).to(torch.float32)
    shifted = torch.from_numpy((raw - shift).astype(np.float32)).to(dev)

    def cuda_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    def bound(n_bytes, n_ops):
        t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    # 4. pip_heavy_tiled on the compacted heavy points of the 4M batch,
    # compacted exactly as pip_join_points(probe="adaptive") compacts them
    cells = H3.point_to_cell(pts_f32, RES)
    u = J._probe_slot(cells, ix)
    found = u >= 0
    cvrow = torch.where(found, ix.cell_convex[torch.clamp(u, min=0)], -1)
    src1, valid1, _, _ = J._compact(found & (cvrow < 0), N_POINTS)
    us = torch.clamp(u[src1], min=0).long()
    hs = torch.where(valid1, ix.cell_heavy[us], -1)
    nh = int((hs >= 0).sum())
    src2, valid2, _, _ = J._compact(hs >= 0, N_POINTS)
    rows = torch.clamp(hs[src2[:nh]], min=0)  # int32, as the join passes them
    pq = shifted[src1][src2[:nh]]
    hpx, hpy = pq[:, 0].contiguous(), pq[:, 1].contiguous()
    eps2 = torch.tensor(
        (J.EDGE_BAND_K * float(np.finfo(np.float32).eps) * ix.host.coord_scale) ** 2,
        dtype=torch.float32, device=dev,
    )
    heavy_args = (hpx, hpy, rows, ix.heavy_edges, ix.heavy_ebits, ix.heavy_slot_geom)
    heavy_ok = True
    heavy_err = 0
    for e2 in (None, eps2):
        kb, kn = K.pip_heavy_tiled(*heavy_args, eps2=e2)
        pb, pn = K.pip_heavy_plain(*heavy_args, eps2=e2)
        torch.cuda.synchronize()
        heavy_err = max(heavy_err, int((kb.long() - pb.long()).abs().max()))
        heavy_ok &= torch.equal(kb, pb) and (e2 is None or torch.equal(kn, pn))
    heavy_ms = cuda_ms(lambda: K.pip_heavy_tiled(*heavy_args))
    heavy_plain_ms = cuda_ms(lambda: K.pip_heavy_plain(*heavy_args), reps=3)
    real_edges = (ix.heavy_ebits != 0).sum(dim=1)
    heavy_tests = int(real_edges[rows].sum())
    H, E2 = ix.heavy_ebits.shape
    M2 = ix.heavy_slot_geom.shape[1]
    # per point: px, py, row (int32) in, best out; per table entry: one f32
    # edge (16 B) and its uint32 slot bits; per slot: its int32 geom
    heavy_bytes = nh * (4 + 4 + 4 + 4) + H * E2 * (16 + 4) + H * M2 * 4
    heavy_bound, heavy_by = bound(heavy_bytes, heavy_tests * OPS_HEAVY)
    emit({
        "phase": "pip_heavy_tiled", "points": nh, "rows": H, "E2": E2, "M2": M2,
        "edge_tests": heavy_tests, "equal": heavy_ok,
        "ms": heavy_ms, "plain_ms": heavy_plain_ms,
        "bound_ms": heavy_bound, "bound_by": heavy_by,
    })
    if not heavy_ok:
        return fail("pip_heavy_tiled differs from pip_heavy_plain")

    # 5. pip_zone: the bench's brute-force lane, every point x every zone
    zdev = pack_to_device(zones, dtype=torch.float32, recenter=True, device=dev)
    planes, n_real = K.edge_planes(zdev)
    zshift = zdev.shift.cpu().numpy()
    zpts = torch.from_numpy((raw[:N_ZONE] - zshift).astype(np.float32)).to(dev)
    sub = zpts[:N_ZONE_CHECK]
    kz = K.pip_zone(sub, planes, n_real)
    pz = K.pip_zone_plain(sub, planes, n_real)
    torch.cuda.synchronize()
    zone_ok = torch.equal(kz, pz)
    zone_err = int((kz.long() - pz.long()).abs().max())
    E, G = planes.shape[1], planes.shape[2]
    zone_ms = cuda_ms(lambda: K.pip_zone(zpts, planes, n_real), reps=5)
    zone_plain_ms = cuda_ms(lambda: K.pip_zone_plain(zpts, planes, n_real), reps=1)
    zone_bytes = N_ZONE * (8 + 4) + planes.numel() * 4
    zone_bound, zone_by = bound(zone_bytes, OPS_ZONE * N_ZONE * G * E)
    emit({
        "phase": "pip_zone", "points": N_ZONE, "zone_slots": G, "edges": E,
        "equal_on_subset": zone_ok, "subset": N_ZONE_CHECK,
        "ms": zone_ms, "plain_ms": zone_plain_ms,
        "bound_ms": zone_bound, "bound_by": zone_by,
    })
    if not zone_ok:
        return fail("pip_zone differs from pip_zone_plain")

    # 6. the main paths, each with the counts set to 0 just before it
    K.pip_heavy_tiled.launches = 0
    K.pip_zone.launches = 0
    t0 = time.perf_counter()
    out = J.pip_join(raw, None, H3, RES, chip_index=ix, probe="adaptive")
    cold_s = time.perf_counter() - t0
    heavy_launches = K.pip_heavy_tiled.launches
    zone_lane_launches_in_join = K.pip_zone.launches
    K.pip_heavy_tiled.launches = 0
    K.pip_zone.launches = 0
    lane = K.pip_zone(zpts, planes, n_real)
    torch.cuda.synchronize()
    zone_launches = K.pip_zone.launches
    base = J.pip_join(raw, None, H3, RES, chip_index=ix, probe="scatter")
    same = bool(np.array_equal(out, base))
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        J.pip_join(raw, None, H3, RES, chip_index=ix, probe="adaptive")
        warm.append(time.perf_counter() - t0)
    warm_scatter = []
    for _ in range(3):
        t0 = time.perf_counter()
        J.pip_join(raw, None, H3, RES, chip_index=ix, probe="scatter")
        warm_scatter.append(time.perf_counter() - t0)
    oracle = J.host_join(raw[:N_ORACLE], ix.host, H3, RES)
    agree = float((oracle == out[:N_ORACLE]).mean())
    lane_match = float((lane.cpu().numpy() >= 0).mean())
    valid = (
        out.shape == (N_POINTS,) and out.dtype == np.int32
        and int(out.min()) >= -1 and int(out.max()) < len(zones)
    )
    emit({
        "phase": "main_path", "points": N_POINTS, "probe": "adaptive",
        "pip_heavy_tiled_launches": heavy_launches,
        "pip_zone_launches_in_join": zone_lane_launches_in_join,
        "pip_zone_lane_launches": zone_launches,
        "equal_to_scatter": same, "valid_output": valid,
        "match_rate": float((out >= 0).mean()),
        "zone_lane_match_rate": lane_match,
        "cold_s": cold_s, "warm_s": warm, "warm_scatter_s": warm_scatter,
        "points_per_s": N_POINTS / min(warm),
        "scatter_points_per_s": N_POINTS / min(warm_scatter),
        "host_oracle_agreement": agree, "oracle_points": N_ORACLE,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if heavy_launches <= 0:
        return fail("pip_join(probe='adaptive') never launched pip_heavy_tiled")
    if zone_launches <= 0:
        return fail("the zone lane never launched pip_zone")
    if not same:
        return fail("pip_join adaptive differs from scatter")
    if not valid:
        return fail("pip_join output is not valid polygon ids of the right shape")
    if agree < MIN_ORACLE_AGREEMENT:
        return fail(f"pip_join agrees with the f64 host oracle on {agree:.5f} "
                    f"of {N_ORACLE} points (floor {MIN_ORACLE_AGREEMENT})")

    # where the time of one warm adaptive pip_join goes: its stages one at
    # a time (CUDA events), then the whole call under the profiler
    nf, nhc, ncv = J._probe_counts(cells, ix).tolist()
    caps = {
        "found_cap": min(J._next_pow2(nf + 1), N_POINTS),
        "heavy_cap": min(J._next_pow2(nhc + 1), N_POINTS),
        "convex_cap": min(J._next_pow2(ncv + 1), N_POINTS),
    }
    stages = {
        "h2d_points": lambda: torch.from_numpy(raw).to(dev).to(torch.float32),
        "h3_cells_f32": lambda: H3.point_to_cell(pts_f32, RES),
        "probe_counts": lambda: J._probe_counts(cells, ix).tolist(),
        "probe_adaptive": lambda: J.pip_join_points(
            shifted, cells, ix, probe="adaptive", **caps),
        "probe_scatter": lambda: J.pip_join_points(
            shifted, cells, ix, probe="scatter", **caps),
        "d2h_result": lambda: out_dev.cpu().numpy(),
    }
    out_dev = torch.from_numpy(out).to(dev)
    stage_ms = {k: cuda_ms(fn, reps=5) for k, fn in stages.items()}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        J.pip_join(raw, None, H3, RES, chip_index=ix, probe="adaptive")
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows_ = []
    for ev in prof.key_averages():
        # device-side events only (kernels and copies): the host-side
        # aten ops carry the same device time again
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        if ev.key.startswith("Activity Buffer"):  # profiler bookkeeping
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows_.append((dev_us / 1e3, ev.key, ev.count))
    rows_.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows_)
    # the profiler adds host time to the call it traces: the idle share is
    # taken against the best unprofiled warm call, and the traced call's
    # own wall time is printed beside it
    warm_ms = min(warm) * 1e3
    emit({
        "phase": "breakdown", "points": N_POINTS, "stage_ms": stage_ms,
        "warm_wall_ms": warm_ms, "profiled_wall_ms": prof_wall_ms,
        "device_busy_ms": busy_ms if rows_ else "not measured",
        "device_idle_share": (
            max(0.0, 1.0 - busy_ms / warm_ms) if rows_ else "not measured"
        ),
        "top_device_ops": [
            {"op": k[:80], "ms": ms, "calls": c} for ms, k, c in rows_[:10]
        ],
    })

    # 7. the kernels line
    src = "mosaic_tpu_torch/kernels/csrc/pip.cu"
    kernels = {"kernels": [
        {"name": "pip_heavy_tiled", "route": "cuda", "source": src,
         "replaces": "mosaic_tpu/kernels/pip.py:492", "launches": heavy_launches,
         "match": heavy_ok, "max_abs_err": heavy_err,
         "ms": heavy_ms, "plain_ms": heavy_plain_ms,
         "bound_ms": heavy_bound, "bound_by": heavy_by, "library_ms": None},
        {"name": "pip_zone", "route": "cuda", "source": src,
         "replaces": "mosaic_tpu/kernels/pip.py:245", "launches": zone_launches,
         "match": zone_ok, "max_abs_err": zone_err,
         "ms": zone_ms, "plain_ms": zone_plain_ms,
         "bound_ms": zone_bound, "bound_by": zone_by, "library_ms": None},
    ]}
    print(card, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
