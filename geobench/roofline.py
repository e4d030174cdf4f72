"""Peaks of the chip and the work a kernel's inputs need.

The arithmetic is frozen from ``chip_smoke.py`` (``PEAK_*``, ``OPS_*``,
``heavy_work``, ``KERNEL_OPS``), so that a later change to the program
cannot move the yardstick.
"""

from __future__ import annotations

import torch

#: H100 SXM rates: HBM3 bytes/s (NVIDIA data sheet); single f32 operations
#: a second outside the tensor cores. The data sheet's 67 TFLOP/s count a
#: fused multiply-add as two operations; the kernels build with
#: -fmad=false and the counts below are of single operations, so the
#: rate is one per lane and clock: 132 SMs x 128 f32 lanes x 1.98 GHz
PEAK_F32 = 132 * 128 * 1.98e9
PEAK_BYTES = 3.35e12
#: f32 operations of the heavy kernel: the straddle test of a (point,
#: real edge) pair (2 compares, 1 inequality); the crossing of a
#: straddling pair (3 subtractions, 1 multiply, 1 divide, 1 add, 1 compare)
OPS_STRADDLE = 3
OPS_CROSS = 7
#: device-op name fragments of each hand-written kernel: every device
#: kernel its wrapper launches, the one counted as the launch first
KERNEL_OPS = {
    "pip_heavy_tiled": ("pip_heavy_kernel", "pip_heavy_hist_kernel",
                        "pip_heavy_scan_kernel", "pip_heavy_scatter_kernel"),
}
#: points of one chunk of the count (bounds its (points, edges) arrays)
CHUNK = 1 << 16


def bound_s(n_bytes: float, ops: float) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time the chip could take."""
    t_b, t_o = n_bytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def heavy_work(pts: torch.Tensor, row: torch.Tensor, f: dict) -> dict:
    """Bytes and f32 operations one ``pip_heavy_tiled`` call needs for the
    points ``pts`` ((N, 2) f64) whose heavy rows are ``row`` (-1: none),
    on the index fields ``f``: each live point's row, coordinates and
    answer; of the rows touched, every slot bit, the real edges and the
    slot geoms; the straddle test of every real edge of a point's row and
    the crossing of each straddling one (no band)."""
    live = row >= 0
    r = row[live].long()
    q = (pts[live] - f["border.shift"]).to(torch.float32)
    edges, ebits = f["heavy_edges"], f["heavy_ebits"]
    n_real = n_cross = 0
    for s in range(0, r.numel(), CHUNK):
        rr, qy = r[s:s + CHUNK], q[s:s + CHUNK, 1:2]
        real = ebits[rr] != 0
        ed = edges[rr]
        n_real += int(real.sum())
        n_cross += int((((ed[..., 1] > qy) != (ed[..., 3] > qy)) & real).sum())
    rows_hit = torch.unique(r)
    row_edges = int((ebits[rows_hit] != 0).sum())
    n_live = int(r.numel())
    n_bytes = (n_live * (4 + 8 + 4) + row_edges * 16
               + int(rows_hit.numel()) * (edges.shape[1] * 4 + f["heavy_slot_geom"].shape[1] * 4))
    return {"bytes": n_bytes, "ops": OPS_STRADDLE * n_real + OPS_CROSS * n_cross,
            "live_points": n_live, "real_edge_tests": n_real, "straddling": n_cross,
            "rows_touched": int(rows_hit.numel())}
