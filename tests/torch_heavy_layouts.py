"""Skewed point-to-row layouts for the heavy-cell kernel's tests.

`pip_heavy_tiled` groups its points by heavy row on the card (a counting
sort, then one block per run of at most 32 points of one row), skips pad
edges, divides the crossing only where the ray straddles an edge and the
band's projection only where its clamp is not decided. Each layout here
aims at one of those: one crowded row, pad rows interleaved, many more
rows than points, rows in reverse order, degenerate edges, points whose
projection clamps at exactly 0 and 1, rows wider than one staged chunk,
and rows past the table's end.

The same numpy inputs feed the JAX package's Pallas kernel in interpret
mode against the plain torch version (`tests/test_torch_kernels_pip.py`)
and the CUDA kernel against the plain version on the card
(`tests/test_torch_kernels_gpu.py`). numpy only: the card's test file
imports neither JAX nor the JAX package.

Each layout returns ``(px, py, rows, edges, bits, geom, eps2)``: f32
points, int32 rows (-1 or >= H = pad), f32 edges (H, E2, 4), uint32 slot bits
(H, E2), int32 slot geoms (H, M2) and an f32 band ``eps2``.
"""

import numpy as np


def _table(rng, H, E2, M2):
    """Random short edges with one slot bit each; the last five edges of
    every row are pads (bits 0); slot 1 of row 0 is empty (geom -1)."""
    a = rng.uniform(-1, 1, (H, E2, 2))
    b = a + rng.uniform(-0.5, 0.5, (H, E2, 2))
    edges = np.concatenate([a, b], axis=2).astype(np.float32)
    slot = rng.integers(0, M2, (H, E2))
    bits = (np.uint32(1) << slot.astype(np.uint32)).astype(np.uint32)
    bits[:, -5:] = 0
    geom = rng.integers(0, 50, (H, M2)).astype(np.int32)
    geom[0, 1] = -1
    return edges, bits, geom


def _points(rng, K):
    return (rng.uniform(-1, 1, K).astype(np.float32),
            rng.uniform(-1, 1, K).astype(np.float32))


def one_row(rng):
    """5,000 points on one row: one row spread over 157 work items."""
    edges, bits, geom = _table(rng, 4, 64, 32)
    px, py = _points(rng, 5000)
    rows = np.full(5000, 2, dtype=np.int32)
    return px, py, rows, edges, bits, geom, np.float32(1e-3)


def pads_interleaved(rng):
    """A third of the rows -1, spread through the batch, not at its tail."""
    edges, bits, geom = _table(rng, 37, 64, 32)
    px, py = _points(rng, 3000)
    rows = rng.integers(0, 37, 3000).astype(np.int32)
    rows[rng.random(3000) < 1 / 3] = -1
    return px, py, rows, edges, bits, geom, np.float32(1e-3)


def sparse_rows(rng):
    """4,096 rows, 300 points, one point on each row it touches."""
    edges, bits, geom = _table(rng, 4096, 16, 8)
    px, py = _points(rng, 300)
    rows = rng.choice(4096, 300, replace=False).astype(np.int32)
    return px, py, rows, edges, bits, geom, np.float32(1e-3)


def reverse_rows(rng):
    """Rows in descending order, runs of every length."""
    edges, bits, geom = _table(rng, 37, 64, 32)
    px, py = _points(rng, 3000)
    rows = np.sort(rng.integers(0, 37, 3000))[::-1].astype(np.int32)
    return px, py, rows, edges, bits, geom, np.float32(1e-3)


def degenerate(rng):
    """Horizontal edges (ay == by), zero-length edges (dd == 0) and edges
    so short that ex*ex + ey*ey underflows to 0 while the projection's
    numerator does not; a third of the points sit on those edges'
    scanlines and vertices."""
    H, E2 = 8, 16
    edges, bits, geom = _table(rng, H, E2, 8)
    edges[:, 0:3, 3] = edges[:, 0:3, 1]             # ay == by
    edges[:, 3:6, 2:4] = edges[:, 3:6, 0:2]         # a == b: dd == 0
    edges[:, 6:9, 0] = 0.0
    edges[:, 6:9, 2] = np.float32(1e-23)
    edges[:, 6:9, 3] = edges[:, 6:9, 1]             # dd underflows to 0
    K = 2000
    px, py = _points(rng, K)
    rows = rng.integers(0, H, K).astype(np.int32)
    on = rng.random(K) < 1 / 3
    e = rng.integers(0, 9, K)
    px[on] = edges[rows[on], e[on], 0]
    py[on] = edges[rows[on], e[on], 1]
    shift = rng.random(K) < 0.5  # half of them moved along x, on the scanline
    px[on & shift] += np.float32(0.25)
    return px, py, rows, edges, bits, geom, np.float32(1e-3)


def band_clamp(rng):
    """Dyadic edges and points placed on the normals through each edge's
    endpoints, just before and just past them, so that the projection's
    numerator equals 0 or the squared length exactly (the clamp at 0 and
    at 1) or passes it; the offsets put some within the band and some
    outside it."""
    H, E2, M2 = 6, 16, 8
    edges, bits, geom = _table(rng, H, E2, M2)
    dirs = np.array([(1, 0), (0, 1), (1, 1), (2, 1), (-1, 3), (3, -2)], np.float64)
    ax = rng.integers(-32, 32, (H, E2)) / 64
    ay = rng.integers(-32, 32, (H, E2)) / 64
    di = dirs[rng.integers(0, len(dirs), (H, E2))]
    edges[..., 0], edges[..., 1] = ax, ay
    edges[..., 2], edges[..., 3] = ax + di[..., 0] / 16, ay + di[..., 1] / 16
    K = 3000
    rows = rng.integers(0, H, K).astype(np.int32)
    e = rng.integers(0, E2 - 5, K)  # real edges only
    end = rng.integers(0, 2, K)     # at a (t clamps at 0) or at b (at 1)
    along = rng.choice([0.0, 0.0, -1 / 64, 1 / 64], K)  # past or short of it
    off = rng.choice([1 / 128, 1 / 32, -1 / 128, 1 / 4], K)  # along the normal
    ed = edges[rows, e].astype(np.float64)
    base = np.where(end[:, None] == 0, ed[:, 0:2], ed[:, 2:4])
    dv = di[rows, e]  # integer direction: every coordinate below is dyadic
    nv = np.stack([-dv[:, 1], dv[:, 0]], axis=1)
    sgn = np.where(end == 0, -1.0, 1.0)[:, None]
    p = base + off[:, None] * nv + sgn * along[:, None] * dv
    px, py = p[:, 0].astype(np.float32), p[:, 1].astype(np.float32)
    return px, py, rows, edges, bits, geom, np.float32(2.0 ** -12)


def wide_rows(rng):
    """Rows of 1,100 edges, more than the 512 the kernel stages at once and
    not a multiple of it: the crossings and band hits of the second and
    third chunks decide many points."""
    edges, bits, geom = _table(rng, 5, 1100, 16)
    px, py = _points(rng, 1500)
    rows = rng.integers(0, 5, 1500).astype(np.int32)
    return px, py, rows, edges, bits, geom, np.float32(1e-4)


def rows_past_table(rng):
    """Rows at and past the table's end (H, H + 7, 2**31 - 1) interleaved
    with real rows: pads, as the reference kernel masks them."""
    edges, bits, geom = _table(rng, 20, 64, 32)
    px, py = _points(rng, 2000)
    rows = rng.integers(0, 20, 2000).astype(np.int32)
    past = rng.random(2000) < 0.2
    rows[past] = rng.choice(np.array([20, 27, 2**31 - 1], np.int32), int(past.sum()))
    return px, py, rows, edges, bits, geom, np.float32(1e-3)


LAYOUTS = {f.__name__: f for f in (
    one_row, pads_interleaved, sparse_rows, reverse_rows, degenerate, band_clamp,
    wide_rows, rows_past_table,
)}


def heavy_layout(name, seed=5):
    """The named layout's inputs, made from ``seed``."""
    return LAYOUTS[name](np.random.default_rng(seed))
