"""Calibration sweep for the epsilon-band recheck constants, on the port.

Port of ``tools/calibrate_margins.py``. The recheck band
(`sql/join.py`) flags a point as borderline when its cell-rounding
margin is below ``CELL_MARGIN_K * eps`` or it lies within
``EDGE_BAND_K * eps * coord_scale`` of a probed chip edge. The
reference's constants were calibrated against XLA's f32 drift; the
port's f32 cells come from PyTorch's trigonometry (the CPU's, or CUDA's
on the card), so this sweep measures the port's own drift, on the
device the caller names:

- **cell-margin drift** — over area-uniform global points, the largest
  margin (in units of ``eps(f32)``) at which the port's f32 cell
  disagrees with its f64 host cell;
- **edge-band drift** — over a tessellated zone index, with cells pinned
  to the exact f64 assignment, the largest distance from a probed chip
  edge (in units of ``eps(f32) * coord_scale``) at which the f32 probe
  disagrees with the f64 host oracle.

The constants must keep >= 2x headroom over both maxima.

Run (prints one JSON document; ``--device cuda`` on a card):

    python -m mosaic_tpu_torch.tools.calibrate_margins --device cpu \
        [--n 200000]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import resolve_device

EPS32 = float(np.finfo(np.float32).eps)


def global_points(n: int, seed: int) -> np.ndarray:
    """Area-uniform points over the sphere (degrees)."""
    rng = np.random.default_rng(seed)
    lng = rng.uniform(-180, 180, n)
    lat = np.degrees(np.arcsin(rng.uniform(-0.999, 0.999, n)))
    return np.stack([lng, lat], -1)


def measure_cell_drift(
    index_system, points: np.ndarray, res: int, device=None
) -> dict:
    """Max margin (units of eps32) among f32-vs-f64 cell disagreements,
    the f32 cells and margins computed on ``device`` (the card unless the
    caller names another, `mosaic_tpu_torch.resolve_device`)."""
    device = resolve_device(device)
    c64 = np.asarray(index_system.point_to_cell(points, res))  # host f64
    f32 = torch.from_numpy(points).to(device).to(torch.float32)
    c32, m = index_system.point_to_cell_margin(f32, res)
    c32, m = c32.cpu().numpy(), m.cpu().numpy()
    dis = c32 != c64
    worst = float(m[dis, 0].max() / EPS32) if dis.any() else 0.0
    return {
        "resolution": res,
        "n_points": int(points.shape[0]),
        "n_disagreements": int(dis.sum()),
        "max_observed_k": round(worst, 4),
    }


def _seg_dist(px, py, e):
    """(R, E) squared f64 distance from each point to its row of segments.

    px, py: (R,); e: (R, E, 4) ax/ay/bx/by rows (pad rows are masked by
    the caller via the parity bits).
    """
    ax, ay, bx, by = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
    ex, ey = bx - ax, by - ay
    qx, qy = px[:, None] - ax, py[:, None] - ay
    dd = ex * ex + ey * ey
    t = np.clip((qx * ex + qy * ey) / np.where(dd == 0, 1.0, dd), 0.0, 1.0)
    rx, ry = qx - t * ex, qy - t * ey
    return rx * rx + ry * ry


def near_edge_points(host, n: int, seed: int, spread_k: float = 64.0
                     ) -> np.ndarray:
    """Adversarial probe set: points within ``spread_k * eps32 *
    coord_scale`` of random real chip edges — uniform points almost never
    land inside the drift band, so the samples are concentrated where the
    f32 parity can actually flip."""
    rng = np.random.default_rng(seed)
    u_idx, e_idx = np.nonzero(host.cell_ebits != 0)
    take = rng.integers(0, u_idx.size, n)
    e = host.cell_edges[u_idx[take], e_idx[take]]  # (n, 4) f64, shifted
    ax, ay, bx, by = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    t = rng.uniform(0.0, 1.0, n)
    px, py = ax + t * (bx - ax), ay + t * (by - ay)
    ex, ey = bx - ax, by - ay
    ln = np.hypot(ex, ey)
    ln = np.where(ln == 0, 1.0, ln)
    mag = rng.uniform(0.0, spread_k, n) * EPS32 * host.coord_scale
    sign = rng.choice([-1.0, 1.0], n)
    return np.stack(
        [px - sign * mag * ey / ln, py + sign * mag * ex / ln], 1
    ) + host.shift  # back to raw (unshifted) coordinates


def measure_edge_drift(
    zones, index_system, res: int, points: np.ndarray, seed: int = 0,
    device=None,
) -> dict:
    """Max edge distance (units of eps32 * coord_scale) among f32-vs-f64
    parity disagreements, with the cell assignment pinned to f64, the f32
    probe running on ``device`` (the card unless the caller names
    another). ``points`` is augmented with an equal-sized near-edge probe
    set."""
    device = resolve_device(device)
    from ..core.tessellate import tessellate
    from ..sql.join import (
        build_chip_index,
        host_join_with_cells,
        pip_join_points,
    )

    idx = build_chip_index(
        tessellate(zones, index_system, res, keep_core_geoms=False),
        device=device,
    )
    host = idx.host
    points = np.concatenate(
        [points, near_edge_points(host, points.shape[0], seed + 1)]
    )
    # exact f64 cells for BOTH paths: any disagreement below is pure
    # probe-arithmetic drift, the band EDGE_BAND_K must cover
    cells = np.asarray(index_system.point_to_cell(points, res))
    want = host_join_with_cells(points, cells, host)
    shifted = torch.from_numpy(
        (points - host.shift).astype(np.float32)).to(idx.device)
    got = pip_join_points(
        shifted, torch.from_numpy(cells).to(idx.device), idx
    ).cpu().numpy()
    dis = np.nonzero(got != want)[0]
    worst = 0.0
    scale = EPS32 * host.coord_scale
    if dis.size:
        p = points[dis] - host.shift
        u = np.clip(
            np.searchsorted(host.cells, cells[dis]), 0, host.cells.size - 1
        )
        d2 = _seg_dist(p[:, 0], p[:, 1], host.cell_edges[u])
        d2 = np.where(host.cell_ebits[u] != 0, d2, np.inf).min(axis=1)
        hrow = host.cell_heavy[u]
        hv = np.nonzero(hrow >= 0)[0]
        if hv.size and host.heavy_edges.shape[0]:
            h = hrow[hv]
            d2h = _seg_dist(p[hv, 0], p[hv, 1], host.heavy_edges[h])
            d2h = np.where(
                host.heavy_ebits[h] != 0, d2h, np.inf
            ).min(axis=1)
            d2[hv] = np.minimum(d2[hv], d2h)
        worst = float(np.sqrt(d2.max()) / scale)
    return {
        "resolution": res,
        "n_points": int(points.shape[0]),
        "n_disagreements": int(dis.size),
        "max_observed_k": round(worst, 4),
        "coord_scale": round(float(host.coord_scale), 6),
    }


def run_sweep(
    n: int, seeds=(3, 11), device=None, resolutions=(5, 7, 9, 11),
    log=None,
) -> dict:
    """The reference's sweep on the port: H3 cell drift at each of
    ``resolutions`` and ``seeds``, a BNG lane, and the edge drift over
    ``synthetic_zones(12, 12)`` at res 9 for each seed, on ``device``
    (the card unless the caller names another)."""
    device = resolve_device(device)
    from ..core.index import BNG, H3IndexSystem
    from ..datasets import synthetic_zones
    from ..sql.join import CELL_MARGIN_K, EDGE_BAND_K

    h3 = H3IndexSystem()
    cell_sweep = []
    for res in resolutions:
        for seed in seeds:
            r = measure_cell_drift(h3, global_points(n, seed), res, device)
            r["system"] = "h3"
            r["seed"] = seed
            cell_sweep.append(r)
            if log:
                log(f"h3 cell res={res} seed={seed}: max_k={r['max_observed_k']}")
    # BNG margins are exact binning distances — drift only at the binning
    # boundary itself; measured for completeness, not the binding max
    rng = np.random.default_rng(9)
    bng_pts = np.column_stack(
        [rng.uniform(0, 700000, n // 2), rng.uniform(0, 1300000, n // 2)]
    )
    rb = measure_cell_drift(BNG, bng_pts, 4, device)
    rb["system"] = "bng"
    rb["seed"] = 9
    cell_sweep.append(rb)

    edge_sweep = []
    bbox = (-74.05, 40.60, -73.85, 40.85)
    for seed in seeds:
        zones = synthetic_zones(12, 12, bbox=bbox, seed=seed)
        rng = np.random.default_rng(seed + 100)
        pts = rng.uniform(bbox[:2], bbox[2:], (n, 2))
        r = measure_edge_drift(zones, h3, 9, pts, seed=seed, device=device)
        r["seed"] = seed
        edge_sweep.append(r)
        if log:
            log(f"edge res=9 seed={seed}: max_k={r['max_observed_k']} "
                f"({r['n_disagreements']} disagreements)")

    cell_max = max(r["max_observed_k"] for r in cell_sweep)
    edge_max = max(r["max_observed_k"] for r in edge_sweep)
    return {
        "device": str(device),
        "defaults": {"CELL_MARGIN_K": CELL_MARGIN_K, "EDGE_BAND_K": EDGE_BAND_K},
        "cell_margin": {
            "max_observed_k": cell_max,
            "headroom_vs_default": round(CELL_MARGIN_K / max(cell_max, 1e-9), 3),
            "sweep": cell_sweep,
        },
        "edge_band": {
            "max_observed_k": edge_max,
            "headroom_vs_default": round(EDGE_BAND_K / max(edge_max, 1e-9), 3),
            "sweep": edge_sweep,
        },
        "meta": {
            "n_points_per_config": n,
            "seeds": list(seeds),
            "contract": "defaults must keep >= 2x headroom over max_observed_k",
        },
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    doc = run_sweep(
        args.n, device=args.device,
        log=lambda s: print(f"[calibrate] {s}", file=sys.stderr),
    )
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
