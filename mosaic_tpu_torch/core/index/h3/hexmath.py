"""Vectorized H3 core math: gnomonic face projections, aperture-7 hex grid.

Implements the published H3 grid algorithm (geo <-> face IJK <-> cell id)
from the spec's orientation constants, fully vectorized over numpy arrays
or torch tensors. Works identically under numpy (host, table derivation in
tables.py) and torch (device hot path, through :class:`TorchNamespace`) —
the array namespace is a parameter. Port of
``mosaic_tpu/core/index/h3/hexmath.py``: the arithmetic is unchanged;
``.astype`` calls go through :func:`astype`, which takes either kind.

Reference analog: the H3 C core the reference calls through JNI
(`core/index/H3IndexSystem.scala:27`, `pointToIndex` :140-142).
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C

_EPS = 1e-12

_TORCH_DTYPES = {
    "bool": torch.bool,
    "int32": torch.int32,
    "int64": torch.int64,
    "float32": torch.float32,
    "float64": torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype).name]


def astype(x, dtype):
    """``x.astype(dtype)`` for a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch_dtype(dtype))
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).removeprefix("torch.")
    return np.asarray(x).astype(dtype)


class TorchNamespace:
    """The numpy-style functions the device path of hexmath and ``core``
    calls (geo -> cell), over torch tensors on one device (constant tables
    are created there). The host-only functions stay numpy."""

    bool = torch.bool
    int32 = torch.int32
    int64 = torch.int64

    def __init__(self, device):
        self.device = torch.device(device)

    def asarray(self, x, dtype=None):
        dt = None if dtype is None else torch_dtype(dtype)
        if isinstance(x, torch.Tensor):
            return x if dt is None else x.to(dt)
        return torch.as_tensor(np.asarray(x), dtype=dt, device=self.device)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=torch_dtype(dtype or "float64"),
                           device=self.device)

    @staticmethod
    def maximum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, min=b)
        return torch.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, max=b)
        return torch.minimum(a, b)

    @staticmethod
    def stack(xs, axis=0):
        return torch.stack(list(xs), dim=axis)

    @staticmethod
    def sum(x, axis=None):
        return torch.sum(x) if axis is None else torch.sum(x, dim=axis)

    @staticmethod
    def max(x, axis):
        return torch.amax(x, dim=axis)

    @staticmethod
    def argmax(x, axis):
        return torch.argmax(x, dim=axis)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)
    ones_like = staticmethod(torch.ones_like)
    abs = staticmethod(torch.abs)
    round = staticmethod(torch.round)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)


def _f(table, like, xp):
    """Float constant table in the *input's* dtype on device.

    Host numpy stays f64; a float32 device batch gets float32 tables, so
    it is not promoted to float64."""
    if xp is np:
        return table
    if isinstance(like, torch.Tensor) and like.dtype.is_floating_point:
        return xp.asarray(table, dtype=like.dtype)
    return xp.asarray(table)


# --------------------------------------------------------------------- geo
def geo_to_vec3(lat, lng, xp=np):
    cl = xp.cos(lat)
    return xp.stack([cl * xp.cos(lng), cl * xp.sin(lng), xp.sin(lat)], axis=-1)


_FACE_CENTER_VEC3 = geo_to_vec3(
    C.FACE_CENTER_GEO[:, 0], C.FACE_CENTER_GEO[:, 1]
)  # (20, 3)


def geo_az_distance(lat, lng, az, r, xp=np):
    """Point at azimuth az and angular distance r from (lat, lng)."""
    sinlat = xp.sin(lat) * xp.cos(r) + xp.cos(lat) * xp.sin(r) * xp.cos(az)
    sinlat = xp.clip(sinlat, -1.0, 1.0)
    lat2 = xp.arcsin(sinlat)
    y = xp.sin(az) * xp.sin(r) * xp.cos(lat)
    x = xp.cos(r) - xp.sin(lat) * sinlat
    lng2 = lng + xp.arctan2(y, x)
    small = r < _EPS
    return xp.where(small, lat, lat2), xp.where(small, lng, lng2)


def pos_angle(a, xp=np):
    tau = 2.0 * np.pi
    return xp.where(a < 0, a + tau * xp.ceil(-a / tau), a % tau)


# --------------------------------------------------------------------- ijk
def ijk_normalize(i, j, k, xp=np):
    m = xp.minimum(xp.minimum(i, j), k)
    return i - m, j - m, k - m


def ijk_to_hex2d(i, j, k, xp=np):
    ii = i - k
    jj = j - k
    x = ii - 0.5 * jj
    y = jj * C.SIN60
    return x, y


def hex2d_to_ijk(x, y, xp=np):
    """Nearest hex center (cube-coordinate rounding). Returns normalized
    non-negative (i, j, k) int64.

    Basis care: in this lattice (x = ii - jj/2, y = jj·sin60) the six unit
    neighbors are (±1,0), (0,±1), ±(1,1) — so the cube embedding with
    neighbor-distance 1 is (q, r, s) = (ii, -jj, jj - ii), NOT the textbook
    (ii, jj, -ii-jj) (whose neighbor set contains (1,-1), which is NOT a
    lattice neighbor here — rounding in that basis misassigns ~1/6 of the
    plane)."""
    ii, jj = hex2d_to_axial(x, y, xp)
    return ijk_normalize(ii, jj, xp.zeros_like(ii), xp)


def hex2d_to_axial(x, y, xp=np):
    """Nearest hex center in *unnormalized* axial coords (ii, jj) — needed
    for grid distance where the k=0 plane offset matters. Same cube basis
    correction as :func:`hex2d_to_ijk`."""
    jj = y / C.SIN60
    ii = x + 0.5 * jj
    q, r, s = ii, -jj, jj - ii
    rq = xp.round(q)
    rr = xp.round(r)
    rs = xp.round(s)
    dq = xp.abs(rq - q)
    dr = xp.abs(rr - r)
    ds = xp.abs(rs - s)
    fix_q = (dq > dr) & (dq > ds)
    fix_r = ~fix_q & (dr > ds)
    rq = xp.where(fix_q, -rr - rs, rq)
    rr = xp.where(fix_r, -rq - rs, rr)
    return astype(rq, np.int64), astype(-rr, np.int64)


def _round_div7(n, xp):
    """Exact integer round-to-nearest(n / 7): floor((2n + 7) / 14).

    Ties are impossible (7 is odd), and staying in integers keeps the
    device path exact in int32 — a float32 quotient at res-15 magnitudes
    carries ~0.08 absolute error, more than the 1/14 rounding margin.
    """
    return (2 * n + 7) // 14


def up_ap7(i, j, k, xp=np):
    """Class III (ccw) aperture-7 parent."""
    ii = i - k
    jj = j - k
    ni = astype(_round_div7(3 * ii - jj, xp), i.dtype)
    nj = astype(_round_div7(ii + 2 * jj, xp), i.dtype)
    return ijk_normalize(ni, nj, xp.zeros_like(ni), xp)


def up_ap7r(i, j, k, xp=np):
    """Class II (cw) aperture-7 parent."""
    ii = i - k
    jj = j - k
    ni = astype(_round_div7(2 * ii + jj, xp), i.dtype)
    nj = astype(_round_div7(3 * jj - ii, xp), i.dtype)
    return ijk_normalize(ni, nj, xp.zeros_like(ni), xp)


def down_ap7(i, j, k, xp=np):
    """Scale finer, Class III: i->(3,0,1), j->(1,3,0), k->(0,1,3)."""
    ni = 3 * i + 1 * j + 0 * k
    nj = 0 * i + 3 * j + 1 * k
    nk = 1 * i + 0 * j + 3 * k
    return ijk_normalize(ni, nj, nk, xp)


def down_ap7r(i, j, k, xp=np):
    """Scale finer, Class II: i->(3,1,0), j->(0,3,1), k->(1,0,3)."""
    ni = 3 * i + 0 * j + 1 * k
    nj = 1 * i + 3 * j + 0 * k
    nk = 0 * i + 1 * j + 3 * k
    return ijk_normalize(ni, nj, nk, xp)


def ijk_add_digit(i, j, k, digit, xp=np):
    uv = C.UNIT_VECS if xp is np else xp.asarray(C.UNIT_VECS)
    step = uv[digit]
    return ijk_normalize(i + step[..., 0], j + step[..., 1], k + step[..., 2], xp)


def unit_ijk_to_digit(i, j, k, xp=np):
    """Normalized unit ijk -> digit 0..6 (7 if not a unit vector)."""
    digit = xp.full(i.shape, C.INVALID_DIGIT, dtype=np.int64)
    uv = C.UNIT_VECS if xp is np else xp.asarray(C.UNIT_VECS)
    for d in range(7):
        hit = (i == uv[d, 0]) & (j == uv[d, 1]) & (k == uv[d, 2])
        digit = xp.where(hit, d, digit)
    return digit


def unit_ijk_to_digit_i32(i, j, k, xp=np):
    """`unit_ijk_to_digit` in int32 — the device hot path avoids emulated
    int64 arithmetic on TPU (int64 only appears in the final bit packing).

    H3's unit vectors encode the digit directly in their components
    (UNIT_VECS[d] == (d>>2, (d>>1)&1, d&1), asserted in tests), so the
    digit is ``4i + 2j + k`` guarded by a unit-vector check — 8 fused
    VPU ops instead of the 7-way compare chain this replaced (which was
    the largest single term of the traced cell pipeline: 8.3 ms of a
    ~18 ms assignment at 4M points, 9 digit levels).
    """
    d = 4 * i + 2 * j + k
    # components all in {0,1} (negatives fail via sign-extended >> 1)
    # and not (1,1,1) — everything else is INVALID_DIGIT
    valid = (((i | j | k) >> 1) == 0) & ~((i & j & k) == 1)
    return xp.where(valid, astype(d, np.int32), C.INVALID_DIGIT)


def is_class_iii(res) -> bool:
    return bool(res % 2)


# ---------------------------------------------------------- face projection
def nearest_face(lat, lng, xp=np):
    """Face whose center is closest (max dot product). (...,) int."""
    v = geo_to_vec3(lat, lng, xp)  # (...,3)
    fc = _f(_FACE_CENTER_VEC3, lat, xp)
    if xp is np:
        dots = v @ fc.T  # (...,20)
    else:
        # explicit FMA broadcast instead of matmul: exact f32 on the VPU
        # (the MXU's default bf16 products would flip faces near the
        # face-boundary bisector) and fully fusable
        dots = (
            v[..., 0, None] * fc[None, :, 0]
            + v[..., 1, None] * fc[None, :, 1]
            + v[..., 2, None] * fc[None, :, 2]
        )
    return xp.argmax(dots, axis=-1), xp.clip(xp.max(dots, axis=-1), -1.0, 1.0)


_COS_AP7 = float(np.cos(C.AP7_ROT_RADS))
_SIN_AP7 = float(np.sin(C.AP7_ROT_RADS))

_FACE_BASIS_CACHE = None  # (20, 9) f64: [face center vec3, e_i, e_j]


def _face_basis() -> np.ndarray:
    """Per-face orthonormal tangent basis of the gnomonic plane, aligned
    with the face's class-II i-axis azimuth.

    Derived numerically in f64 from the azimuthal definition itself
    (a geodesic leaving the face center at azimuth ``az_i`` maps to the
    +x ray; gnomonic projection sends center geodesics to straight rays,
    so a single short arc fixes the direction exactly), keeping the
    convention consistent with :func:`geo_az_distance` / the polar inverse
    by construction."""
    global _FACE_BASIS_CACHE
    if _FACE_BASIS_CACHE is None:
        rows = []
        for f in range(20):
            flat = np.float64(C.FACE_CENTER_GEO[f, 0])
            flng = np.float64(C.FACE_CENTER_GEO[f, 1])
            azif = float(C.FACE_AXES_AZ_I[f])
            fv = geo_to_vec3(flat, flng)

            def ray(az):
                la, lo = geo_az_distance(
                    flat, flng, np.float64(az), np.float64(1e-3)
                )
                v = geo_to_vec3(la, lo)
                p = v / float(v @ fv) - fv
                return p / np.linalg.norm(p)

            e_i = ray(azif)
            # theta = az_i − az: a point at azimuth az_i − π/2 has θ=+π/2
            e_j = ray(azif - np.pi / 2.0)
            e_j = e_j - float(e_j @ e_i) * e_i
            e_j = e_j / np.linalg.norm(e_j)
            rows.append(np.concatenate([fv, e_i, e_j]))
        _FACE_BASIS_CACHE = np.asarray(rows)
    return _FACE_BASIS_CACHE


def geo_to_hex2d(lat, lng, res: int, face=None, xp=np):
    """Project geo onto a face's gnomonic plane in res-scaled hex units.

    If ``face`` is None the nearest face is used (returned alongside x, y).

    Vector form of the gnomonic: p = v/(v·fc) − fc dotted with the face's
    tangent basis. Numerically stable everywhere on the face — the polar
    form (azimuth → arccos → tan → cos/sin θ) carries ~eps of ABSOLUTE
    angle error per step, which the res scaling turns into hex-space
    displacement up to ~100·eps·coordinate-scale (arccos: eps/sin r near
    the face center; azimuth wraps: rr·Δθ near the edges), breaking the
    epsilon-band noise model the borderline recheck calibrates against.
    Here every operand is an O(1) vector difference: absolute error stays
    a few eps, and five transcendentals leave the hot path.
    """
    v = geo_to_vec3(lat, lng, xp)
    if face is None:
        face, _ = nearest_face(lat, lng, xp)
    basis = _face_basis()
    if xp is np:
        b = basis[face]
    else:
        b = xp.asarray(basis, dtype=lat.dtype)[face.long()]
    fv = b[..., 0:3]
    dot = xp.sum(v * fv, axis=-1)
    # nearest-face dot ≥ cos(face circumradius) ≈ 0.85; the floor only
    # guards exotic face-given calls from dividing by ~0
    p = v / xp.maximum(dot, 0.2)[..., None] - fv
    gx = xp.sum(p * b[..., 3:6], axis=-1)
    gy = xp.sum(p * b[..., 6:9], axis=-1)
    scale = float(C.SQRT7**res / C.RES0_U_GNOMONIC)
    x = gx * scale
    y = gy * scale
    if is_class_iii(res):  # θ −= AP7 rotation, applied as an exact 2x2
        x, y = x * _COS_AP7 + y * _SIN_AP7, y * _COS_AP7 - x * _SIN_AP7
    return face, x, y


def hex2d_to_geo(face, x, y, res: int, substrate: bool = False, xp=np):
    """Inverse gnomonic: res-scaled hex coords on a face -> (lat, lng)."""
    r = xp.sqrt(x * x + y * y)
    theta = xp.arctan2(y, x)
    r = r / (C.SQRT7 ** res)
    if substrate:
        r = r / 3.0
        if is_class_iii(res):
            r = r / C.SQRT7
    r = xp.arctan(r * C.RES0_U_GNOMONIC)
    if not substrate and is_class_iii(res):
        theta = pos_angle(theta + C.AP7_ROT_RADS, xp)
    az_i = _f(C.FACE_AXES_AZ_I, x, xp)
    fc_geo = _f(C.FACE_CENTER_GEO, x, xp)
    az = pos_angle(az_i[face] - pos_angle(theta, xp), xp)
    return geo_az_distance(fc_geo[face, 0], fc_geo[face, 1], az, r, xp)


# ----------------------------------------------------------- index packing
def pack(base_cell, digits, res: int, xp=np):
    """base_cell (N,), digits (N, 15) with INVALID(7) padding -> H3 ids."""
    h = (
        (np.int64(C.MODE_CELL) << C.MODE_OFFSET)
        | (astype(xp.asarray(res), np.int64) << C.RES_OFFSET)
        | (astype(base_cell, np.int64) << C.BASE_CELL_OFFSET)
    )
    for r in range(C.MAX_RES):
        shift = (C.MAX_RES - 1 - r) * C.PER_DIGIT_OFFSET
        h = h | (astype(digits[..., r], np.int64) << shift)
    return h


def pack_packed(base_cell, digits, res: int, xp=np):
    """`pack` for width-``res`` digit arrays (N, res).

    The unused finer levels are a compile-time INVALID(7) bit constant, and
    the digits are first packed into int32 words (10 levels of 3 bits per
    word) so the emulated-int64 work on TPU is at most two shift-ors per
    point instead of ``res``."""
    pad = 0
    for r in range(res, C.MAX_RES):
        pad |= C.INVALID_DIGIT << ((C.MAX_RES - 1 - r) * C.PER_DIGIT_OFFSET)
    const = (C.MODE_CELL << C.MODE_OFFSET) | (res << C.RES_OFFSET) | pad
    h = (astype(base_cell, np.int64) << C.BASE_CELL_OFFSET) | const
    # digit r sits at bit (MAX_RES-1-r)*3; group levels in int32 words
    for g0 in range(0, res, 10):
        g1 = min(g0 + 10, res)
        acc = None
        for r in range(g0, g1):
            d = astype(digits[..., r], np.int32) << ((g1 - 1 - r) * 3)
            acc = d if acc is None else acc | d
        shift = (C.MAX_RES - g1) * C.PER_DIGIT_OFFSET
        h = h | (astype(acc, np.int64) << shift)
    return h


def unpack(h, xp=np):
    """H3 ids -> (res, base_cell, digits (N,15))."""
    h = astype(h, np.int64)
    res = (h >> C.RES_OFFSET) & 0xF
    base_cell = (h >> C.BASE_CELL_OFFSET) & 0x7F
    digits = xp.stack(
        [
            (h >> ((C.MAX_RES - 1 - r) * C.PER_DIGIT_OFFSET)) & C.DIGIT_MASK
            for r in range(C.MAX_RES)
        ],
        axis=-1,
    )
    return res, base_cell, digits


def leading_nonzero_digit(digits, res, xp=np):
    """First non-CENTER digit among digits[..., :res] (0 if none)."""
    r_idx = xp.arange(C.MAX_RES)
    resb = xp.asarray(res)[..., None] if np.ndim(res) else res
    nz = (digits != 0) & (r_idx < resb)
    idx = xp.argmax(nz, axis=-1)
    d = xp.take_along_axis(digits, idx[..., None], axis=-1)[..., 0]
    return xp.where(nz.any(axis=-1), d, xp.zeros_like(d))


def rotate_digits(digits, res, table, xp=np):
    """Apply a digit-wise 60-degree rotation to digits[..., :res]."""
    tab = table if xp is np else xp.asarray(table)
    rotated = tab[digits]
    r_idx = np.arange(C.MAX_RES)
    mask = (r_idx[None, :] < xp.asarray(res)[..., None]) if np.ndim(res) else (
        r_idx < res
    )
    return xp.where(mask, rotated, digits)


# composed rotation powers: ROT60_CCW_POW[n] applies n ccw rotations in one
# digit-table gather (INVALID_DIGIT 7 maps to itself, so no res mask needed)
def _compose_rot_pow() -> np.ndarray:
    tabs = [np.arange(8, dtype=np.int64)]
    for _ in range(5):
        tabs.append(C.ROT60_CCW[tabs[-1]])
    return np.stack(tabs)


ROT60_CCW_POW = _compose_rot_pow()  # (6, 8)


def rotate60_ccw(digits, res, xp=np):
    return rotate_digits(digits, res, C.ROT60_CCW, xp)


def rotate60_cw(digits, res, xp=np):
    return rotate_digits(digits, res, C.ROT60_CW, xp)


def rotate_pent60_ccw(digits, res, xp=np):
    """Pentagon ccw rotation: rotate digits, skipping the K-axis 'deleted'
    subsequence — if the leading digit lands on K, rotate once more."""
    rotated = rotate60_ccw(digits, res, xp)
    lead = leading_nonzero_digit(rotated, res, xp)
    again = rotate60_ccw(rotated, res, xp)
    need = lead == C.K_AXES_DIGIT
    return xp.where(need[..., None], again, rotated)
