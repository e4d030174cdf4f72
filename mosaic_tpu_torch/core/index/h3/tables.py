"""Geometric derivation of the H3 base-cell tables.

The H3 C library ships hand-laid lookup tables (baseCellData,
faceIjkBaseCells, baseCellNeighbors). We do NOT transcribe them: everything
is *derived* at import time from the published orientation constants in
`constants.py`:

- Res-0 cell positions: on each icosahedron face (maxDim 2 at res 0) the
  valid cells are the 10 normalized ijk with i+j+k <= 2 — 1 face center,
  3 interior cells, 3 edge midpoints (shared by 2 faces), 3 corners
  (icosahedron vertices, shared by 5 faces => pentagons).
  20 + 60 + 30 + 12 = 122 unique base cells.
- Numbering: H3 numbers base cells by descending latitude; we sort and
  verify the 12 pentagons land exactly at the published pentagon numbers
  {4,14,24,38,49,58,63,72,83,97,107,117} — a 12-point check that the
  derived numbering matches the spec.
- Home face: the lowest face index on which the cell appears.
- Per-appearance ccw 60-degree rotation: calibrated by projecting a small
  step along the home face's i-axis into the observed face's frame and
  quantizing the angle.

Derivation cost: ~200 projections — microseconds, done once lazily.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import constants as C
from . import hexmath as hm

PENTAGON_IDS = frozenset({4, 14, 24, 38, 49, 58, 63, 72, 83, 97, 107, 117})

# the 10 valid normalized res-0 ijk positions per face
_RES0_IJK = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 1, 0],
        [1, 0, 1],
        [0, 1, 1],
        [2, 0, 0],
        [0, 2, 0],
        [0, 0, 2],
    ],
    dtype=np.int64,
)


@dataclasses.dataclass(frozen=True)
class BaseCellTables:
    # per base cell (122,)
    home_face: np.ndarray  # int
    home_ijk: np.ndarray  # (122, 3)
    is_pentagon: np.ndarray  # bool
    center_geo: np.ndarray  # (122, 2) lat,lng radians
    # lookup (20, 3, 3, 3): base cell number or -1
    fijk_base_cell: np.ndarray
    # lookup (20, 3, 3, 3): ccw 60deg rotations home->face
    fijk_ccw_rot60: np.ndarray
    # pentagon cw-offset faces (122, 2): faces where the pentagon's grid is
    # clockwise-offset from the home system; -1 padding for hexagons
    pent_cw_faces: np.ndarray
    # per face, per edge e (between corner e and corner (e+1)%3):
    # neighboring face (20, 3), ccw rotation steps (20, 3), and res-0 hex2d
    # translation (20, 3, 2) of the rigid unfold transform f-frame -> g-frame
    edge_neighbor_face: np.ndarray = None
    edge_rot60: np.ndarray = None
    edge_translate: np.ndarray = None
    # (20, 3, 2): canonical corner index (0..2) on the NEIGHBOR face of edge
    # endpoints A (corner e) and B (corner (e+1)%3)
    edge_corner_idx: np.ndarray = None


def _appearance_geo():
    """All (face, ijk) res-0 appearances with their geo/vec3 positions."""
    faces = np.repeat(np.arange(C.NUM_FACES), len(_RES0_IJK))
    ijk = np.tile(_RES0_IJK, (C.NUM_FACES, 1))
    x, y = hm.ijk_to_hex2d(
        ijk[:, 0].astype(float), ijk[:, 1].astype(float), ijk[:, 2].astype(float)
    )
    lat, lng = hm.hex2d_to_geo(faces, x, y, res=0)
    vec = hm.geo_to_vec3(lat, lng)
    return faces, ijk, lat, lng, vec


@functools.lru_cache(maxsize=1)
def derive() -> BaseCellTables:
    faces, ijk, lat, lng, vec = _appearance_geo()
    n = len(faces)
    # cluster appearances into unique cells
    cell_of = np.full(n, -1)
    uniq_vec: list[np.ndarray] = []
    uniq_members: list[list[int]] = []
    for a in range(n):
        found = -1
        for u, uv in enumerate(uniq_vec):
            if float(vec[a] @ uv) > 1 - 1e-9:
                found = u
                break
        if found < 0:
            uniq_vec.append(vec[a])
            uniq_members.append([a])
            found = len(uniq_vec) - 1
        else:
            uniq_members[found].append(a)
        cell_of[a] = found
    assert len(uniq_vec) == C.NUM_BASE_CELLS, len(uniq_vec)

    # number by descending latitude (verified via the pentagon anchor check)
    uniq_lat = np.array([lat[m[0]] for m in uniq_members])
    order = np.argsort(-uniq_lat, kind="stable")
    renum = np.empty_like(order)
    renum[order] = np.arange(len(order))

    home_face = np.full(C.NUM_BASE_CELLS, -1, dtype=np.int64)
    home_ijk = np.zeros((C.NUM_BASE_CELLS, 3), dtype=np.int64)
    is_pent = np.zeros(C.NUM_BASE_CELLS, dtype=bool)
    center_geo = np.zeros((C.NUM_BASE_CELLS, 2))
    fijk_bc = np.full((C.NUM_FACES, 3, 3, 3), -1, dtype=np.int64)
    fijk_rot = np.zeros((C.NUM_FACES, 3, 3, 3), dtype=np.int64)

    for u, members in enumerate(uniq_members):
        b = int(renum[u])
        is_pent[b] = len(members) == 5
        # home face: lowest face index
        mf = [(int(faces[a]), a) for a in members]
        mf.sort()
        home_a = mf[0][1]
        home_face[b] = faces[home_a]
        home_ijk[b] = ijk[home_a]
        center_geo[b] = (lat[home_a], lng[home_a])

    pent_numbers = sorted(np.nonzero(is_pent)[0].tolist())
    if pent_numbers != sorted(PENTAGON_IDS):
        raise AssertionError(
            f"derived base-cell numbering does not match the H3 spec: "
            f"pentagons at {pent_numbers}"
        )

    # per-appearance rotation calibration
    step = 0.15
    for u, members in enumerate(uniq_members):
        b = int(renum[u])
        hf = int(home_face[b])
        hijk = home_ijk[b].astype(float)
        hx, hy = hm.ijk_to_hex2d(hijk[0], hijk[1], hijk[2])
        # geo of a small step along the home i-axis
        slat, slng = hm.hex2d_to_geo(np.int64(hf), hx + step, hy, res=0)
        for a in members:
            f = int(faces[a])
            i, j, k = (int(v) for v in ijk[a])
            ox, oy = hm.ijk_to_hex2d(float(i), float(j), float(k))
            _, px, py = hm.geo_to_hex2d(
                np.asarray(slat), np.asarray(slng), res=0, face=np.int64(f)
            )
            ang = np.arctan2(float(py) - oy, float(px) - ox)
            rot = int(np.round(ang / (np.pi / 3))) % 6
            fijk_bc[f, i, j, k] = b
            fijk_rot[f, i, j, k] = (6 - rot) % 6

    # pentagon corner entries: the angle calibration above is exact for
    # hexagon appearances but NOT around icosahedron vertices — five faces
    # meet there, one combinatorial ring step is 72 deg physically yet
    # exactly ONE digit-space rotation unit, so quantizing cumulative
    # gnomonic angles to 60 deg multiples misassigns some rotations (the
    # PR-3 triage bug: ~0.9% of uniform sphere points near vertices were
    # sent to a cell ~11 deg away). Recalibrate every pentagon corner
    # entry by cross-frame label agreement, and derive the cw-offset
    # faces from the same probes (replacing the round-1 "two largest
    # rotations" heuristic, which picked the wrong pair).
    pent_cw = _calibrate_pentagon_corners(is_pent, home_face, fijk_bc, fijk_rot)

    edge_nf, edge_rot, edge_t, edge_cidx = _add_overage_entries(
        faces, ijk, cell_of, renum, uniq_members, fijk_bc, fijk_rot
    )

    return BaseCellTables(
        home_face=home_face,
        home_ijk=home_ijk,
        is_pentagon=is_pent,
        center_geo=center_geo,
        fijk_base_cell=fijk_bc,
        fijk_ccw_rot60=fijk_rot,
        pent_cw_faces=pent_cw,
        edge_neighbor_face=edge_nf,
        edge_rot60=edge_rot,
        edge_translate=edge_t,
        edge_corner_idx=edge_cidx,
    )


#: pentagon-calibration resolution: fine enough that the narrow edge band
#: holds thousands of distinct cells, coarse enough to stay fast
_CAL_RES = 6


def _forced_face_digits(la, lng, res, f):
    """(digits, base i, j, k) of probe points evaluated in face ``f``'s
    frame (the geo_to_cell up-aggregation with the face forced — the
    calibration needs the SAME physical points described in two frames)."""
    face = np.full(la.shape, f, dtype=np.int64)
    _, x, y = hm.geo_to_hex2d(la, lng, res, face=face)
    i, j, k = hm.hex2d_to_ijk(x, y, np)
    digits = np.full(la.shape + (C.MAX_RES,), C.INVALID_DIGIT, dtype=np.int64)
    for r in range(res, 0, -1):
        li, lj, lk = i, j, k
        if hm.is_class_iii(r):
            i, j, k = hm.up_ap7(i, j, k, np)
            ci, cj, ck = hm.down_ap7(i, j, k, np)
        else:
            i, j, k = hm.up_ap7r(i, j, k, np)
            ci, cj, ck = hm.down_ap7r(i, j, k, np)
        di, dj, dk = hm.ijk_normalize(li - ci, lj - cj, lk - ck, np)
        digits[..., r - 1] = hm.unit_ijk_to_digit(di, dj, dk, np)
    return digits, i, j, k


def _pent_relabel(digits, res, rot, cw):
    """Digits -> canonical pentagon digits for a trial ``(rot, cw)``: the
    deleted-K-sector adjustment (cw/ccw 60 deg) where the leading digit is
    K, then ``rot`` pentagon rotations — exactly the geo_to_cell path."""
    lead = hm.leading_nonzero_digit(digits, res, np)
    need = lead == C.K_AXES_DIGIT
    adj = (
        hm.rotate60_cw(digits, res, np)
        if cw
        else hm.rotate60_ccw(digits, res, np)
    )
    d = np.where(need[:, None], adj, digits)
    for n in range(1, 6):
        if rot >= n:
            d = hm.rotate_pent60_ccw(d, res, np)
    return d


def _calibrate_pentagon_corners(is_pent, home_face, fijk_bc, fijk_rot):
    """Fix the pentagon corner-entry rotations in ``fijk_rot`` (in place)
    and return the derived ``pent_cw`` table.

    Method: adjacent appearance faces share a triangle edge whose
    gnomonic parametrization is IDENTICAL in both frames (the mirror
    isometry through the edge's great circle swaps the faces and fixes
    the edge), so in a narrow band (±5e-4 rad) along it the two frames'
    res-6 lattices coincide and the same physical point must get the
    same digit string after relabeling. Pass 1 pins each face's rotation
    against an already-calibrated neighbor (BFS from the home face,
    rot=0 by definition) using probes whose leading digit is not K in
    either frame (cw-independent). Pass 2 pins the cw-offset faces:
    probes K-leading in one frame only vote on that face's fold
    direction; a face is cw-offset only on strong evidence (its deleted
    sector hugs the shared edge, thousands of probes). Deterministic
    (fixed seed); raises if any pair calibrates below 60% agreement —
    the correct relabeling scores ~0.85+ (residual = cells straddling
    the band), wrong ones ~0.
    """
    rng = np.random.default_rng(20260804)
    pent_cw = np.full((C.NUM_BASE_CELLS, 2), -1, dtype=np.int64)

    def corner_cells(f):
        return {
            int(fijk_bc[f, c[0], c[1], c[2]]): tuple(int(v) for v in c)
            for c in _CORNER_IJK
        }

    def corner_geo(f, ijk):
        cx, cy = hm.ijk_to_hex2d(float(ijk[0]), float(ijk[1]), float(ijk[2]))
        la, lng = hm.hex2d_to_geo(
            np.int64(f), np.asarray(cx), np.asarray(cy), 0
        )
        return np.array([
            np.cos(la) * np.cos(lng), np.cos(la) * np.sin(lng), np.sin(la),
        ]).reshape(3)

    for b in np.nonzero(is_pent)[0]:
        b = int(b)
        hf = int(home_face[b])
        apps = {}
        for f in range(C.NUM_FACES):
            cc = corner_cells(f)
            if b in cc:
                apps[f] = cc[b]
        v = corner_geo(hf, apps[hf])
        edge2 = {}
        for f in apps:
            cf = corner_cells(f)
            for g in apps:
                if g == f:
                    continue
                shared = set(cf) & set(corner_cells(g))
                if b in shared and len(shared) == 2:
                    edge2[(f, g)] = (shared - {b}).pop()

        bands: dict = {}

        def band(f, g):
            """Masked digit strings of shared-edge-band probes in both
            frames (cached per unordered pair)."""
            if (f, g) in bands:
                return bands[(f, g)]
            if (g, f) in bands:
                dg, df = bands[(g, f)]
                return df, dg
            v2 = corner_geo(f, corner_cells(f)[edge2[(f, g)]])
            d = v2 - (v2 @ v) * v
            d /= np.linalg.norm(d)
            nrm = np.cross(v, d)
            n = 5000
            ts = rng.uniform(0.04, 0.30, n)
            hs = rng.uniform(-5e-4, 5e-4, n)
            p = (
                np.cos(ts)[:, None] * v
                + np.sin(ts)[:, None] * d
                + hs[:, None] * nrm
            )
            p /= np.linalg.norm(p, axis=1, keepdims=True)
            la = np.arcsin(p[:, 2])
            lng = np.arctan2(p[:, 1], p[:, 0])
            df, fi, fj, fk = _forced_face_digits(la, lng, _CAL_RES, f)
            dg, gi, gj, gk = _forced_face_digits(la, lng, _CAL_RES, g)
            cf, cg = apps[f], apps[g]
            m = (
                (fi == cf[0]) & (fj == cf[1]) & (fk == cf[2])
                & (gi == cg[0]) & (gj == cg[1]) & (gk == cg[2])
            )
            bands[(f, g)] = (df[m], dg[m])
            return bands[(f, g)]

        def neighbors(f):
            for (a, b2) in edge2:
                if a == f:
                    yield b2

        # pass 1: rotations, BFS out from home (rot 0 by definition)
        rots = {hf: 0}
        frontier = [hf]
        while frontier:
            nxt = []
            for g in frontier:
                for f in neighbors(g):
                    if f in rots:
                        continue
                    df, dg = band(f, g)
                    no_k = (
                        hm.leading_nonzero_digit(df, _CAL_RES, np)
                        != C.K_AXES_DIGIT
                    ) & (
                        hm.leading_nonzero_digit(dg, _CAL_RES, np)
                        != C.K_AXES_DIGIT
                    )
                    ref = _pent_relabel(dg[no_k], _CAL_RES, rots[g], False)
                    score, rot = max(
                        (
                            float(
                                (_pent_relabel(df[no_k], _CAL_RES, r, False)
                                 == ref).all(axis=1).mean()
                            ),
                            r,
                        )
                        for r in range(5)
                    )
                    if score < 0.6:
                        raise AssertionError(
                            f"pentagon {b}: face {f} vs {g} calibrated at "
                            f"{score:.2f} agreement — probe band too noisy"
                        )
                    rots[f] = rot
                    nxt.append(f)
            frontier = nxt
        for f, rot in rots.items():
            c = apps[f]
            fijk_rot[f, c[0], c[1], c[2]] = rot

        # pass 2: cw-offset faces from K-leading probes (one frame only)
        cw_faces = []
        for f in apps:
            for g in neighbors(f):
                df, dg = band(f, g)
                m = (
                    hm.leading_nonzero_digit(df, _CAL_RES, np)
                    == C.K_AXES_DIGIT
                ) & (
                    hm.leading_nonzero_digit(dg, _CAL_RES, np)
                    != C.K_AXES_DIGIT
                )
                # only a deleted sector hugging this edge yields a strong
                # probe population; scattered boundary rounding does not
                if int(m.sum()) < 500:
                    continue
                ref = _pent_relabel(dg[m], _CAL_RES, rots[g], False)
                cw_score = float(
                    (_pent_relabel(df[m], _CAL_RES, rots[f], True) == ref)
                    .all(axis=1).mean()
                )
                ccw_score = float(
                    (_pent_relabel(df[m], _CAL_RES, rots[f], False) == ref)
                    .all(axis=1).mean()
                )
                if cw_score > max(ccw_score, 0.6):
                    cw_faces.append(f)
                break
        if len(cw_faces) > 2:
            raise AssertionError(
                f"pentagon {b}: {len(cw_faces)} cw-offset faces {cw_faces}"
            )
        for slot, f in enumerate(sorted(cw_faces)):
            pent_cw[b, slot] = f
    return pent_cw


# overage res-0 positions: normalized ijk with min==0 and 2 < i+j+k <= 4 —
# cells whose hexagons straddle an icosahedron edge, reachable by rounding
# from points inside the face triangle
_OVERAGE_IJK = np.array(
    [
        [2, 1, 0],
        [2, 0, 1],
        [1, 2, 0],
        [0, 2, 1],
        [1, 0, 2],
        [0, 1, 2],
        [2, 2, 0],
        [2, 0, 2],
        [0, 2, 2],
    ],
    dtype=np.int64,
)

_CORNER_IJK = np.array([[2, 0, 0], [0, 2, 0], [0, 0, 2]], dtype=np.int64)


def _add_overage_entries(faces, ijk, cell_of, renum, uniq_members, fijk_bc, fijk_rot):
    """Fill table entries for positions past each face's triangle by planar
    unfolding across the shared edge (the role of the C library's
    faceNeighbors table, derived instead of transcribed), and record the
    per-edge rigid transforms for runtime lattice unfolding.

    The rigid transform f-frame -> g-frame is fixed by the two shared
    icosahedron vertices: both appear at known corner ijk on both faces.
    """

    def hex2d(v):
        x, y = hm.ijk_to_hex2d(float(v[0]), float(v[1]), float(v[2]))
        return np.array([x, y])

    app = {}
    for a in range(len(faces)):
        app[(int(faces[a]), tuple(int(v) for v in ijk[a]))] = int(cell_of[a])

    vert_faces: dict[int, list[tuple[int, np.ndarray]]] = {}
    for f in range(C.NUM_FACES):
        for cijk in _CORNER_IJK:
            u = app[(f, tuple(int(v) for v in cijk))]
            vert_faces.setdefault(u, []).append((f, cijk))

    valid_set = {tuple(int(v) for v in q) for q in _RES0_IJK}
    edge_nf = np.full((C.NUM_FACES, 3), -1, dtype=np.int64)
    edge_rot = np.zeros((C.NUM_FACES, 3), dtype=np.int64)
    edge_t = np.zeros((C.NUM_FACES, 3, 2))
    edge_cidx = np.zeros((C.NUM_FACES, 3, 2), dtype=np.int64)

    def corner_index(v):
        for m, cv in enumerate(_CORNER_IJK):
            if np.array_equal(v, cv):
                return m
        raise AssertionError(v)

    for f in range(C.NUM_FACES):
        corners = [
            (app[(f, tuple(int(v) for v in cijk))], cijk) for cijk in _CORNER_IJK
        ]
        for e in range(3):
            (ua, ijk_a), (ub, ijk_b) = corners[e], corners[(e + 1) % 3]
            shared = [
                g
                for g, _ in vert_faces[ua]
                if g != f and any(g2 == g for g2, _ in vert_faces[ub])
            ]
            if not shared:
                continue
            g = shared[0]
            gijk_a = next(v for g2, v in vert_faces[ua] if g2 == g)
            gijk_b = next(v for g2, v in vert_faces[ub] if g2 == g)
            a1, a2 = hex2d(ijk_a), hex2d(ijk_b)
            b1, b2 = hex2d(gijk_a), hex2d(gijk_b)
            ang = np.arctan2(*(b2 - b1)[::-1]) - np.arctan2(*(a2 - a1)[::-1])
            n_rot = int(np.round(ang / (np.pi / 3))) % 6
            th = n_rot * np.pi / 3
            R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            t = b1 - R @ a1
            edge_nf[f, e] = g
            edge_rot[f, e] = n_rot
            edge_t[f, e] = t
            edge_cidx[f, e, 0] = corner_index(gijk_a)
            edge_cidx[f, e, 1] = corner_index(gijk_b)
            for p in _OVERAGE_IJK:
                if fijk_bc[f, p[0], p[1], p[2]] >= 0:
                    continue
                pp = R @ hex2d(p) + t
                pi, pj, pk = hm.hex2d_to_ijk(
                    np.asarray(pp[0]), np.asarray(pp[1])
                )
                key = (g, (int(pi), int(pj), int(pk)))
                if key[1] in valid_set:
                    u = app[key]
                    b = int(renum[u])
                    base_rot = int(
                        fijk_rot[g, key[1][0], key[1][1], key[1][2]]
                    )
                    fijk_bc[f, p[0], p[1], p[2]] = b
                    fijk_rot[f, p[0], p[1], p[2]] = (n_rot + base_rot) % 6
    return edge_nf, edge_rot, edge_t, edge_cidx
