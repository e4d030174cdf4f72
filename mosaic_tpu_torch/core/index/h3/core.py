"""H3 cell construction/deconstruction from geo, vectorized host+device.

geo -> cell: nearest-face gnomonic projection, hex rounding at the target
resolution, aperture-7 up-aggregation collecting one digit per level, base
cell + rotation lookup from the geometrically derived tables, pentagon
adjustment, bit packing. The whole pipeline is array math (works under both
numpy and torch via the ``xp`` parameter) — this is the reference's
JNI `geoToH3` per-row call (`core/index/H3IndexSystem.scala:140-142`)
re-expressed as one fused program over millions of points.

cell -> geo: home-face descent (exact integer ijk), gnomonic unprojection,
then a snap-to-owning-face correction replacing the C library's
table-driven overage adjustment (`_adjustOverageClassII`): the approximate
center is re-projected on its true owning face and snapped to that face's
exact lattice. Verified by round-trip fuzz tests.

Port of ``mosaic_tpu/core/index/h3/core.py``: the host (numpy) path is a
copy; the device path (:func:`_geo_to_cell_device`) runs on torch tensors.
Cell centers and boundaries run on the host only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import constants as C
from . import hexmath as hm
from .tables import derive


def _tables_for(xp):
    t = derive()
    if xp is np:
        return t, t.fijk_base_cell, t.fijk_ccw_rot60, t.is_pentagon, t.pent_cw_faces
    return (
        t,
        xp.asarray(t.fijk_base_cell),
        xp.asarray(t.fijk_ccw_rot60),
        xp.asarray(t.is_pentagon),
        xp.asarray(t.pent_cw_faces),
    )


def _rel_margin(x, y, res: int, xp):
    """(..., 2) margins of the finest-res hex rounding (nearest and
    second-nearest boundary), relative to the coordinate noise scale
    (compare against k·eps(dtype); `sql.join` epsilon band).

    The geo→hex2d map magnifies angular noise (radians, O(1) magnitudes
    with relative rounding eps) by ~ √7^res / RES0_U_GNOMONIC, growing
    toward face edges — the |x|, |y| terms fold that in, and also cover
    noise from the hex-space arithmetic itself."""
    m1, m2 = hm.hex_round_margins(x, y, xp)
    s0 = float(C.SQRT7**res / C.RES0_U_GNOMONIC)
    s = xp.maximum(xp.maximum(xp.abs(x), xp.abs(y)), s0)
    return xp.stack([m1 / s, m2 / s], axis=-1)


def _alt_ijk(x, y, xp):
    """Runner-up finest-res rounding, normalized to ijk."""
    ii, jj = hm.hex_round_alt_axial(x, y, xp)
    return hm.ijk_normalize(ii, jj, xp.zeros_like(ii), xp)


def geo_to_cell(
    lat, lng, res: int, xp=np, with_margin: bool = False, alt: bool = False
):
    """(N,) lat/lng radians -> (N,) int64 H3 cell ids at ``res``.

    ``with_margin=True`` additionally returns the (..., 2) relative
    rounding margins (:func:`_rel_margin`) of each point's finest-res cell
    decision — the epsilon-band input for the f64 borderline recheck.
    ``alt=True`` resolves the RUNNER-UP finest-res rounding instead (the
    cell across the nearest boundary): everything after the rounding is
    exact integer math, so for a borderline point the true cell is the
    primary or this alternate (or, near a vertex, flagged by margin 2)."""
    if xp is not np:
        return _geo_to_cell_device(lat, lng, res, xp, with_margin, alt)
    t, fijk_bc, fijk_rot, is_pent, pent_cw = _tables_for(xp)
    face, x, y = hm.geo_to_hex2d(lat, lng, res, xp=xp)
    margin = _rel_margin(x, y, res, xp) if with_margin else None
    i, j, k = _alt_ijk(x, y, xp) if alt else hm.hex2d_to_ijk(x, y, xp)

    digits = xp.full(lat.shape + (C.MAX_RES,), C.INVALID_DIGIT, dtype=np.int64)
    for r in range(res, 0, -1):
        li, lj, lk = i, j, k
        if hm.is_class_iii(r):
            i, j, k = hm.up_ap7(i, j, k, xp)
            ci, cj, ck = hm.down_ap7(i, j, k, xp)
        else:
            i, j, k = hm.up_ap7r(i, j, k, xp)
            ci, cj, ck = hm.down_ap7r(i, j, k, xp)
        di, dj, dk = hm.ijk_normalize(li - ci, lj - cj, lk - ck, xp)
        digits[..., r - 1] = hm.unit_ijk_to_digit(di, dj, dk, xp)

    # the alt (runner-up) rounding can step outside the 3x3x3 base-cell
    # coverage of this face near overage regions, or hit a combo with no
    # base cell: those alts are reported as -1 (caller escalates to the
    # exact host path) rather than silently clipped to a wrong cell
    bad = ((i > 2) | (j > 2) | (k > 2)) if alt else None
    i = xp.clip(i, 0, 2)
    j = xp.clip(j, 0, 2)
    k = xp.clip(k, 0, 2)
    bc = fijk_bc[face, i, j, k]
    rot = fijk_rot[face, i, j, k]
    if alt:
        bad = bad | (bc < 0)
        bc = xp.maximum(bc, 0)

    pent = is_pent[bc]
    if xp is np and digits.ndim == 2:
        # host fast path: pentagons are 12 of 122 base cells — handle them
        # on the (usually empty) subset; hexagons take one composed-table
        # gather instead of the 5-iteration conditional rotation loop
        prows = np.nonzero(pent)[0]
        if prows.size:
            dsub = digits[prows]
            lead = hm.leading_nonzero_digit(dsub, res, np)
            cw_off = (pent_cw[bc[prows], 0] == face[prows]) | (
                pent_cw[bc[prows], 1] == face[prows]
            )
            need = lead == C.K_AXES_DIGIT
            adj = np.where(
                cw_off[:, None],
                hm.rotate60_cw(dsub, res, np),
                hm.rotate60_ccw(dsub, res, np),
            )
            dsub = np.where(need[:, None], adj, dsub)
            rsub = rot[prows]
            for n in range(1, 6):
                rotated = hm.rotate_pent60_ccw(dsub, res, np)
                dsub = np.where((rsub >= n)[:, None], rotated, dsub)
        digits = hm.ROT60_CCW_POW[np.where(pent, 0, rot)[:, None], digits]
        if prows.size:
            digits[prows] = dsub
        cells = hm.pack(bc, digits, res, np)
        if alt:
            cells = np.where(bad, np.int64(-1), cells)
        return (cells, margin) if with_margin else cells

    lead = hm.leading_nonzero_digit(digits, res, xp)
    cw_off = (pent_cw[bc, 0] == face) | (pent_cw[bc, 1] == face)
    need_adjust = pent & (lead == C.K_AXES_DIGIT)
    adj_cw = hm.rotate60_cw(digits, res, xp)
    adj_ccw = hm.rotate60_ccw(digits, res, xp)
    digits = xp.where(
        need_adjust[..., None],
        xp.where(cw_off[..., None], adj_cw, adj_ccw),
        digits,
    )

    # apply the base-cell rotation: rot in 0..5 ccw rotations
    for n in range(1, 6):
        hexrot = hm.rotate60_ccw(digits, res, xp)
        pentrot = hm.rotate_pent60_ccw(digits, res, xp)
        rotated = xp.where(pent[..., None], pentrot, hexrot)
        digits = xp.where((rot >= n)[..., None], rotated, digits)

    cells = hm.pack(bc, digits, res, xp)
    if alt:
        cells = xp.where(bad, xp.asarray(-1, dtype=cells.dtype), cells)
    return (cells, margin) if with_margin else cells


def _geo_to_cell_device(
    lat, lng, res: int, xp, with_margin: bool = False, alt: bool = False
):
    """Device geo_to_cell over torch tensors (``xp`` a
    :class:`~.hexmath.TorchNamespace`), eager, one torch op a step: the
    plain version of the CUDA kernel that assigns cells on the card
    (`kernels/h3.py`), and the path on the CPU. Int32 digit math of width
    ``res``, one gather from the composed (face, ijk) -> (base cell, rotation,
    pentagon, cw-offset face) table (:func:`_combo_table`), one for each
    row's count of digit rotations, the pentagon correction's included
    (:data:`_TURNS`), and one that applies them.
    Nothing in it reads a value back to the host, and its constant tables
    stay on the device after the first call, so a warm call queues its
    work without a host sync.

    Port of ``mosaic_tpu/core/index/h3/core.py _geo_to_cell_device``: the
    float arithmetic (projection and hex rounding, in ``hexmath``) is the
    same op for op; the TPU select-chains and the pentagon rotation loop
    become gathers, which give the same integers. Bit-identical to the
    numpy path in float64. ``with_margin`` and ``alt`` are
    :func:`geo_to_cell`'s.
    """
    face, x, y = hm.geo_to_hex2d(lat, lng, res, xp=xp)
    margin = _rel_margin(x, y, res, xp) if with_margin else None
    i, j, k = _alt_ijk(x, y, xp) if alt else hm.hex2d_to_ijk(x, y, xp)
    i = i.to(xp.int32)
    j = j.to(xp.int32)
    k = k.to(xp.int32)

    digit_list = [None] * res
    for r in range(res, 0, -1):
        li, lj, lk = i, j, k
        if hm.is_class_iii(r):
            i, j, k = hm.up_ap7(i, j, k, xp)
            ci, cj, ck = hm.down_ap7(i, j, k, xp)
        else:
            i, j, k = hm.up_ap7r(i, j, k, xp)
            ci, cj, ck = hm.down_ap7r(i, j, k, xp)
        di, dj, dk = hm.ijk_normalize(li - ci, lj - cj, lk - ck, xp)
        digit_list[r - 1] = hm.unit_ijk_to_digit_i32(di, dj, dk, xp)
    digits = (
        xp.stack(digit_list, axis=-1)
        if res
        else xp.zeros(tuple(lat.shape) + (0,), xp.int32)
    )  # (N, res) int32

    # alt roundings outside this face's 3x3x3 base-cell coverage (or on a
    # combo with no base cell, bc < 0 below) come back -1 — see geo_to_cell
    bad = ((i > 2) | (j > 2) | (k > 2)) if alt else None
    i = xp.clip(i, 0, 2)
    j = xp.clip(j, 0, 2)
    k = xp.clip(k, 0, 2)
    combo = xp.asarray(_combo_table())[face.long(), (i * 9 + j * 3 + k).long()]
    bc = (combo >> 5) - 1
    if alt:
        bad = bad | (bc < 0)
        bc = xp.maximum(bc, 0)

    # every row turns its digits by a count of ccw rotations, applied as
    # one gather from the composed powers: _TURNS reads the count off the
    # row's (rot, cw, pent) code and its lead digit
    turns = (combo >> 2) & 7
    if res:
        lead = _lead_digit(digits, xp)
        turns = xp.asarray(_TURNS)[((combo & 31) * 8 + lead).long()]
    pow_flat = xp.asarray(hm.ROT60_CCW_POW.astype(np.int32).reshape(-1))
    digits = pow_flat[(turns[..., None] * 8 + digits).long()]
    cells = hm.pack_packed(bc, digits, res, xp)
    if alt:
        cells = xp.where(bad, xp.asarray(-1, dtype=cells.dtype), cells)
    return (cells, margin) if with_margin else cells


@functools.lru_cache(maxsize=1)
def _combo_table() -> np.ndarray:
    """(20, 27) int32: the base cell, its rotation, whether it is a
    pentagon, and whether the face is one of the pentagon's cw-offset
    faces, for each (face, ijk), packed as
    ``(bc + 1) << 5 | rot << 2 | cw << 1 | pent`` (max 3959)."""
    t = derive()
    bc = np.asarray(t.fijk_base_cell).astype(np.int32)  # (20, 3, 3, 3)
    rot = np.asarray(t.fijk_ccw_rot60).astype(np.int32)
    safe = np.maximum(bc, 0)
    pent = np.asarray(t.is_pentagon)[safe] & (bc >= 0)
    face = np.arange(20).reshape(20, 1, 1, 1)
    cw_faces = np.asarray(t.pent_cw_faces)[safe]  # (20, 3, 3, 3, 2)
    cw = pent & ((cw_faces[..., 0] == face) | (cw_faces[..., 1] == face))
    combo = ((bc + 1) << 5) | (rot << 2) | (cw.astype(np.int32) << 1) | pent
    return combo.reshape(20, 27).astype(np.int32)


def _turns_table() -> np.ndarray:
    """(256,) int32: the ccw turns of a row, at ``code * 8 + lead`` for
    ``code = rot << 2 | cw << 1 | pent`` and the row's lead digit.

    A hexagon turns ``rot`` times. A pentagon whose lead digit is the
    k-axes digit first turns once cw (five ccw turns) on a cw-offset face,
    else once ccw; then it takes ``rot`` steps of the pentagon rotation
    (`hexmath.rotate_pent60_ccw`, :data:`_PENT_TURNS`)."""
    out = np.zeros(256, np.int32)
    for rot in range(6):
        for cw in range(2):
            for pent in range(2):
                code = rot << 2 | cw << 1 | pent
                for lead in range(8):
                    if not pent:
                        n = rot
                    else:
                        adj = (5 if cw else 1) if lead == C.K_AXES_DIGIT else 0
                        turned = int(hm.ROT60_CCW_POW[adj, lead])
                        n = (adj + int(_PENT_TURNS[turned, rot])) % 6
                    out[code * 8 + lead] = n
    return out


def _pent_turns() -> np.ndarray:
    """(8, 6) int32: the ccw turns that ``rot`` steps of the pentagon
    rotation (`hexmath.rotate_pent60_ccw`) make, by the digits' lead digit.

    Each step turns once, and once more when the turn lands the lead digit
    on the k-axes digit. A turn permutes the digit values 1..6 and keeps 0
    and 7, so it moves the lead digit's value but never its place: the
    count follows from the lead digit alone."""
    out = np.zeros((8, 6), np.int32)
    for lead0 in range(8):
        for rot in range(6):
            lead, n = lead0, 0
            for _ in range(rot):
                lead, n = int(C.ROT60_CCW[lead]), n + 1
                if lead == C.K_AXES_DIGIT:
                    lead, n = int(C.ROT60_CCW[lead]), n + 1
            out[lead0, rot] = n
    return out


_PENT_TURNS = _pent_turns()
_TURNS = _turns_table()


def _lead_digit(digits, xp):
    """First non-zero digit along the last axis of (N, res) digits."""
    lead = xp.zeros_like(digits[..., 0])
    for r in range(digits.shape[-1]):
        d = digits[..., r]
        lead = xp.where(lead != 0, lead, d)
    return lead


def cell_center_frame(cells, xp=np):
    """cells -> (face, x, y, res) CONTINUOUS hex2d coords of the cell
    center on its owning face (the face actually containing its center).

    Descends from the base cell's home face, applying one aperture-7 step +
    digit per level, then unfolds onto the owning face by planar triangle-
    edge transforms (replacing the C library's table-driven
    `_adjustOverageClassII`). On pentagon base cells the HOST (numpy) path
    repairs the unfold to round-trip exactly (`_pentagon_unfold_repair`);
    those centers are NOT lattice-aligned, which is why this returns
    continuous coords. `H3IndexSystem.cell_center`/`cell_boundary` route
    torch tensors through this host path.
    """
    if xp is np and np.ndim(cells) == 0:
        f, x, y, r = cell_center_frame(np.asarray(cells).reshape(1), xp)
        return f[0], x[0], y[0], r[0]
    t, *_ = _tables_for(xp)
    res, bc, digits = hm.unpack(cells, xp)
    home_face = (t.home_face if xp is np else xp.asarray(t.home_face))[bc]
    hijk = (t.home_ijk if xp is np else xp.asarray(t.home_ijk))[bc]
    is_pent = (t.is_pentagon if xp is np else xp.asarray(t.is_pentagon))[bc]

    lead = hm.leading_nonzero_digit(digits, res, xp)
    fix = is_pent & (lead == C.IK_AXES_DIGIT)
    digits = xp.where(fix[..., None], hm.rotate60_cw(digits, res, xp), digits)

    # exact integer descent in the home face frame (coords may overflow)
    face = home_face + xp.zeros_like(res)
    i, j, k = hijk[..., 0], hijk[..., 1], hijk[..., 2]
    max_res = int(np.max(res)) if (xp is np and np.size(res)) else C.MAX_RES
    for r in range(1, max_res + 1):
        active = r <= res
        if hm.is_class_iii(r):
            ni, nj, nk = hm.down_ap7(i, j, k, xp)
        else:
            ni, nj, nk = hm.down_ap7r(i, j, k, xp)
        d = xp.where(active, digits[..., r - 1], 0)
        ni, nj, nk = hm.ijk_add_digit(ni, nj, nk, d, xp)
        i = xp.where(active, ni, i)
        j = xp.where(active, nj, j)
        k = xp.where(active, nk, k)

    x, y = hm.ijk_to_hex2d(i.astype(float), j.astype(float), k.astype(float), xp)
    face, x, y = _unfold_to_owning_face(face, x, y, res, xp)

    if xp is np and np.ndim(cells) and is_pent.any():
        # pentagon base cells: the planar unfold does not model the deleted
        # K sector, so some children land one 60-degree sector off. Repair
        # by self-consistency: try +-60-degree rotations about the home
        # triangle's corners/center before unfolding, and keep the first
        # candidate whose center re-assigns (geo_to_cell) to the cell.
        face, x, y = _pentagon_unfold_repair(
            cells, bc, is_pent, home_face, digits, res, face, x, y
        )

    return face, x, y, res


def cell_to_owned_fijk(cells, xp=np):
    """cells -> (face, i, j, k, res) INTEGER lattice coords on the owning
    face. Note pentagon-distorted children are not exactly lattice-aligned;
    use :func:`cell_center_frame` for exact centers.

    A tensor goes through the host path (the pentagon repair is host
    numpy, as for `H3IndexSystem.cell_center`) and comes back as int64
    tensors on its device."""
    if isinstance(cells, torch.Tensor):
        out = cell_to_owned_fijk(cells.detach().cpu().numpy(), np)
        return tuple(
            torch.as_tensor(np.asarray(a, dtype=np.int64), device=cells.device)
            for a in out
        )
    face, x, y, res = cell_center_frame(cells, xp)
    i, j, k = hm.hex2d_to_ijk(x, y, xp)
    return face, i, j, k, res


def _unfold_to_owning_face(face, x, y, res, xp=np):
    """Unfold home-face hex2d coords onto the owning face by exact planar
    lattice transforms across triangle edges (replaces the C library's
    table-driven `_adjustOverageClassII` unfolding)."""
    t = derive()
    corners = _corners_by_res(xp)  # (16, 3, 2) canonical per-res triangle
    edge_nf = t.edge_neighbor_face if xp is np else xp.asarray(t.edge_neighbor_face)
    edge_cidx = t.edge_corner_idx if xp is np else xp.asarray(t.edge_corner_idx)

    cr = corners[res]  # (N, 3, 2)
    for _hop in range(4):
        # signed side test per edge: cross(B-A, p-A); inside >= 0 (CCW tri)
        A = cr
        B = cr[..., [1, 2, 0], :]
        ex = B[..., 0] - A[..., 0]
        ey = B[..., 1] - A[..., 1]
        px = x[..., None] - A[..., 0]
        py = y[..., None] - A[..., 1]
        side = ex * py - ey * px  # (N, 3)
        worst = xp.argmin(side, axis=-1)
        outside = xp.min(side, axis=-1) < -1e-9
        if xp is np and not np.any(outside):
            break
        g = edge_nf[face, worst]
        ma = edge_cidx[face, worst, 0]
        mb = edge_cidx[face, worst, 1]
        Af = _take2(cr, worst, xp)
        Bf = _take2(cr, (worst + 1) % 3, xp)
        Ag = _take2(cr, ma, xp)
        Bg = _take2(cr, mb, xp)
        va = Bf - Af
        vb = Bg - Ag
        ca = xp.arctan2(va[..., 1], va[..., 0])
        cb = xp.arctan2(vb[..., 1], vb[..., 0])
        ang = cb - ca
        cth, sth = xp.cos(ang), xp.sin(ang)
        rx = x - Af[..., 0]
        ry = y - Af[..., 1]
        nx2 = cth * rx - sth * ry + Ag[..., 0]
        ny2 = sth * rx + cth * ry + Ag[..., 1]
        x = xp.where(outside, nx2, x)
        y = xp.where(outside, ny2, y)
        face = xp.where(outside, g, face)
    return face, x, y


def _pentagon_unfold_repair(cells, bc, is_pent, home_face, digits, res, face, x, y):
    """Numpy-path repair of pentagon-child unfolds (see caller).

    For every cell on a pentagon base cell, verify geo_to_cell(center) ==
    cell; for failures, retry the unfold after rotating the descent point
    +-60 degrees about each home-triangle corner and the centroid, keeping
    the first self-consistent candidate. Exactness criterion = round-trip
    consistency with geo_to_cell (the forward assignment is the ground
    truth partition of the sphere in this framework).

    ``is_pent`` is already per-cell (indexed by base cell in the caller).
    """
    xp = np
    sel = np.nonzero(is_pent)[0]
    if sel.size == 0:
        return face, x, y
    sub_cells = cells[sel]
    sub_res = res[sel] if np.ndim(res) else np.full(sel.size, res)

    def verified(la, lo, res_of, cell_of):
        """Margin-verified assignment: the point AND four +-delta jitters
        all map to the expected cell. Rotated lattice candidates can land
        exactly on a hex-rounding tie, where any downstream ulp difference
        (e.g. the degrees round-trip in the public API) flips the cell —
        the jitter margin rejects such knife-edge centers."""
        d = 3e-8
        out = np.ones(la.shape[0], dtype=bool)
        for dla, dlo in ((0, 0), (d, 0), (-d, 0), (0, d), (0, -d)):
            for r in np.unique(res_of):
                m = res_of == r
                if not m.any():
                    continue
                got = geo_to_cell(la[m] + dla, lo[m] + dlo, int(r), xp)
                out[m] &= got == cell_of[m]
        return out

    def center_ok(f, cx, cy):
        la, lo = _per_res_geo(f, cx, cy, sub_res, xp)
        return verified(la, lo, sub_res, sub_cells)

    ok = center_ok(face[sel], x[sel], y[sel])
    if ok.all():
        return face, x, y
    bad = sel[~ok]
    bad_res = sub_res[~ok]
    hf = home_face[bad]
    corners = _corners_by_res(xp)
    # recompute the pre-unfold descent point from the digits (subset only)
    from . import hexmath as _hm

    t = derive()
    hijk = t.home_ijk[bc[bad]]
    fi = hijk[:, 0].astype(np.int64)
    fj = hijk[:, 1].astype(np.int64)
    fk = hijk[:, 2].astype(np.int64)
    max_r = int(bad_res.max(initial=0))
    dsub = digits[bad]
    for r in range(1, max_r + 1):
        active = r <= bad_res
        if _hm.is_class_iii(r):
            ni, nj, nk = _hm.down_ap7(fi, fj, fk, xp)
        else:
            ni, nj, nk = _hm.down_ap7r(fi, fj, fk, xp)
        d = np.where(active, dsub[..., r - 1], 0)
        ni, nj, nk = _hm.ijk_add_digit(ni, nj, nk, d, xp)
        fi = np.where(active, ni, fi)
        fj = np.where(active, nj, fj)
        fk = np.where(active, nk, fk)
    x0, y0 = _hm.ijk_to_hex2d(fi.astype(float), fj.astype(float), fk.astype(float), xp)

    fixed = np.zeros(bad.size, dtype=bool)
    bx, by, bf = x[bad].copy(), y[bad].copy(), face[bad].copy()
    cr = corners[bad_res]  # (B, 3, 2)
    centroid = cr.mean(axis=1)  # (B, 2)
    pivots = [cr[:, 0], cr[:, 1], cr[:, 2], centroid]
    angles = [np.pi / 3, -np.pi / 3, 2 * np.pi / 3, -2 * np.pi / 3]
    for pivot in pivots:
        for ang in angles:
            if fixed.all():
                break
            ca, sa = np.cos(ang), np.sin(ang)
            rx = x0 - pivot[:, 0]
            ry = y0 - pivot[:, 1]
            nx2 = ca * rx - sa * ry + pivot[:, 0]
            ny2 = sa * rx + ca * ry + pivot[:, 1]
            ff, xx, yy = _unfold_to_owning_face(hf.copy(), nx2, ny2, bad_res, xp)
            la, lo = _per_res_geo(ff, xx, yy, bad_res, xp)
            good = verified(la, lo, bad_res, cells[bad])
            take = good & ~fixed
            bx[take], by[take], bf[take] = xx[take], yy[take], ff[take]
            fixed |= good

    if not fixed.all():
        # last resort (a handful of coarse cells): estimate the center by
        # sampling around the parent cell's center and taking the spherical
        # centroid of the samples the forward assignment maps to this cell,
        # then refine once. Deterministic (fixed lattice), verified by
        # round-trip before acceptance.
        rem = np.nonzero(~fixed)[0]
        for q in rem:
            cell = cells[bad][q]
            r = int(bad_res[q])
            parent = _parent_cell(cell, r)
            pla, plo = cell_to_geo(np.asarray([parent]), np)
            rad = _circumradius_rad(max(r - 1, 0)) * 1.6
            est = None
            n_samp = 600
            for _round in range(6):
                sla, slo = _disk_lattice(float(pla[0]), float(plo[0]), rad, n_samp)
                hit = geo_to_cell(sla, slo, r, np) == cell
                if not hit.any():
                    # deleted-sector children can sit several parent radii
                    # away: widen (and densify) until the region is found
                    rad *= 1.8
                    n_samp = min(n_samp * 2, 6000)
                    continue
                v = np.stack(
                    [
                        np.cos(sla[hit]) * np.cos(slo[hit]),
                        np.cos(sla[hit]) * np.sin(slo[hit]),
                        np.sin(sla[hit]),
                    ],
                    -1,
                ).mean(0)
                v /= np.linalg.norm(v)
                est = (np.arcsin(v[2]), np.arctan2(v[1], v[0]))
                if (
                    geo_to_cell(np.asarray([est[0]]), np.asarray([est[1]]), r, np)[0]
                    != cell
                ):
                    # nonconvex region: the centroid fell outside — use the
                    # DEEPEST in-region sample (max distance to any non-hit
                    # sample), which stays robustly interior
                    if (~hit).any():
                        d2 = (
                            (sla[hit][:, None] - sla[~hit][None, :]) ** 2
                            + (slo[hit][:, None] - slo[~hit][None, :]) ** 2
                        ).min(axis=1)
                        kbest = int(np.argmax(d2))
                    else:
                        kbest = 0
                    est = (float(sla[hit][kbest]), float(slo[hit][kbest]))
                pla = np.asarray([est[0]])
                plo = np.asarray([est[1]])
                rad = _circumradius_rad(r) * 1.2
            if est is None:
                continue
            # express the center in the owning face's frame, then verify
            # the FINAL representation (re-projected through the same path
            # cell_to_geo will use) — an estimate near a cell boundary can
            # flip under the projection round-trip's ulp differences
            f1, _ = hm.nearest_face(np.asarray([est[0]]), np.asarray([est[1]]), np)
            _, xx, yy = hm.geo_to_hex2d(
                np.asarray([est[0]]), np.asarray([est[1]]), r, face=f1, xp=np
            )
            la2, lo2 = _per_res_geo(f1, xx, yy, np.asarray([r]), np)
            if not verified(la2, lo2, np.asarray([r]), np.asarray([cell]))[0]:
                continue
            bf[q], bx[q], by[q] = f1[0], xx[0], yy[0]
            fixed[q] = True

    x = x.copy()
    y = y.copy()
    face = face.copy()
    x[bad], y[bad], face[bad] = bx, by, bf
    return face, x, y


def _parent_cell(cell: int, res: int) -> int:
    """Parent id at res-1: bump the res field, pad the finest digit."""
    if res <= 0:
        return int(cell)
    h = int(cell)
    h &= ~(0xF << C.RES_OFFSET)
    h |= (res - 1) << C.RES_OFFSET
    h |= C.INVALID_DIGIT << ((C.MAX_RES - res) * C.PER_DIGIT_OFFSET)
    return h


def _circumradius_rad(res: int) -> float:
    return float(np.arctan(C.RES0_U_GNOMONIC / np.sqrt(3.0) / (C.SQRT7**res)))


def _disk_lattice(lat0: float, lng0: float, rad: float, n: int):
    """Deterministic Fibonacci lattice in a spherical cap around a point."""
    gold = (1 + 5**0.5) / 2
    ks = np.arange(n)
    rr = rad * np.sqrt((ks + 0.5) / n)
    th = 2 * np.pi * ks / gold
    lat = lat0 + rr * np.cos(th)
    lng = lng0 + rr * np.sin(th) / max(np.cos(lat0), 0.05)
    return np.clip(lat, -np.pi / 2, np.pi / 2), lng


def _take2(cr, idx, xp):
    """cr: (N,3,2), idx: (N,) -> (N,2) gather along axis 1."""
    if xp is np:
        return cr[np.arange(cr.shape[0]), idx]
    return xp.take_along_axis(cr, idx[:, None, None], axis=1)[:, 0, :]


_CORNERS_CACHE: dict = {}


def _corners_by_res(xp):
    """(16, 3, 2) canonical triangle corner hex2d positions per resolution
    (identical in every face's own frame; computed by exact projection)."""
    if "np" not in _CORNERS_CACHE:
        corner_ijk = np.array([[2, 0, 0], [0, 2, 0], [0, 0, 2]], dtype=float)
        cx, cy = hm.ijk_to_hex2d(corner_ijk[:, 0], corner_ijk[:, 1], corner_ijk[:, 2])
        lat0, lng0 = hm.hex2d_to_geo(np.zeros(3, dtype=np.int64), cx, cy, 0)
        out = np.zeros((C.MAX_RES + 1, 3, 2))
        for r in range(C.MAX_RES + 1):
            _, x, y = hm.geo_to_hex2d(lat0, lng0, r, face=np.zeros(3, np.int64))
            out[r, :, 0] = x
            out[r, :, 1] = y
        _CORNERS_CACHE["np"] = out
    if xp is np:
        return _CORNERS_CACHE["np"]
    return xp.asarray(_CORNERS_CACHE["np"])


def cell_to_geo(cells, xp=np):
    """(N,) int64 -> (lat, lng) radians of cell centers, lng in (-pi, pi]."""
    face, x, y, res_arr = cell_center_frame(cells, xp)
    lat, lng = _per_res_geo(face, x, y, res_arr, xp)
    lng = xp.where(lng > np.pi, lng - 2 * np.pi, lng)
    lng = xp.where(lng <= -np.pi, lng + 2 * np.pi, lng)
    return lat, lng


def _per_res_geo(face, x, y, res_arr, xp):
    """hex2d -> geo where each element may have its own resolution."""
    lat = xp.zeros(x.shape)
    lng = xp.zeros(x.shape)
    for r in range(C.MAX_RES + 1):
        sel = res_arr == r
        if xp is np and not np.any(sel):
            continue
        la, lo = hm.hex2d_to_geo(face, x, y, r, xp=xp)
        lat = xp.where(sel, la, lat)
        lng = xp.where(sel, lo, lng)
    return lat, lng


def cell_boundary(cells, xp=np):
    """(N,) -> (N, 6, 2) lat/lng radians of cell vertices (CCW).

    6 vertices at hex circumradius in the owning face's grid frame; H3's
    extra distortion vertices on icosahedron edge crossings are not
    emitted. Pentagon cells are overridden with their 5 true vertices at
    the `H3IndexSystem.cell_boundary` level (host path).
    """
    oface, cx, cy, res_arr = cell_center_frame(cells, xp)
    rad = 1.0 / np.sqrt(3.0)
    lats = []
    lngs = []
    for m in range(6):
        ang = np.pi / 6 + m * np.pi / 3
        vx = cx + rad * np.cos(ang)
        vy = cy + rad * np.sin(ang)
        la, lo = _per_res_geo(oface, vx, vy, res_arr, xp)
        lats.append(la)
        lngs.append(lo)
    return xp.stack(lats, -1), xp.stack(lngs, -1)


def resolution(cells, xp=np):
    """(N,) int64 resolution of each id; a tensor stays on its device."""
    return hm.astype((hm.astype(cells, np.int64) >> C.RES_OFFSET) & 0xF, np.int64)


def base_cell(cells, xp=np):
    """(N,) int64 base cell of each id; a tensor stays on its device."""
    return (hm.astype(cells, np.int64) >> C.BASE_CELL_OFFSET) & 0x7F


def is_pentagon_cell(cells, xp=np):
    t, *_ = _tables_for(xp)
    pent = t.is_pentagon if xp is np else xp.asarray(t.is_pentagon)
    res, bc, digits = hm.unpack(cells, xp)
    lead = hm.leading_nonzero_digit(digits, res, xp)
    return pent[bc] & (lead == 0)


def is_valid_cell(cells, xp=np):
    """(N,) bool: a cell-mode id with a real base cell, a resolution of
    at most 15, digits 0-6 up to its resolution and 7 past it (host
    numpy)."""
    cells = cells.astype(np.int64)
    mode = (cells >> C.MODE_OFFSET) & 0xF
    res, bc, digits = hm.unpack(cells, xp)
    ok = (mode == C.MODE_CELL) & (bc < C.NUM_BASE_CELLS) & (res <= C.MAX_RES)
    r_idx = np.arange(C.MAX_RES)
    used = r_idx[None, :] < res[..., None]
    dig_ok = xp.where(used, digits < 7, digits == 7)
    return ok & xp.all(dig_ok, axis=-1) & (cells >= 0)
