"""H3 grid system orientation constants (public H3 specification data).

The H3 discrete global grid is defined by (a) a fixed icosahedron orientation
(20 face center lat/lngs + the azimuth of each face's Class II i-axis) and
(b) an aperture-7 hexagon hierarchy on each face's gnomonic projection.
These orientation numbers are published constants of the open H3 spec
(uber/h3, Apache-2.0); everything *derived* from them here (base cell
positions, numbering, rotation tables) is computed geometrically in
`tables.py` rather than transcribed.

Reference analog: the reference consumes these via the H3 C core through JNI
(`core/index/H3IndexSystem.scala:27`).
"""

from __future__ import annotations

import numpy as np

# lat, lng in radians for each of the 20 icosahedron faces
FACE_CENTER_GEO = np.array(
    [
        [0.803582649718989942, 1.248397419617396099],
        [1.307747883455638156, 2.536945009877921159],
        [1.054751253523952054, -1.347517358900396623],
        [0.600191595538186799, -0.450603909469755746],
        [0.491715428198773866, 0.401988202911306943],
        [0.172745327415618701, 1.678146885280433686],
        [0.605929321571350690, 2.953923329812411617],
        [0.427370518328979641, -1.888876200336285401],
        [-0.079066118549212831, -0.733429513380867741],
        [-0.230961644455383637, 0.506495587332349035],
        [0.079066118549212831, 2.408163140208925497],
        [0.230961644455383637, -2.635097066257444203],
        [-0.172745327415618701, -1.463445768309359553],
        [-0.605929321571350690, -0.187669323777381622],
        [-0.427370518328979641, 1.252716453253507838],
        [-0.600191595538186799, 2.690988744120037492],
        [-0.491715428198773866, -2.739604450678486295],
        [-0.803582649718989942, -1.893195233972397139],
        [-1.307747883455638156, -0.604647643711872080],
        [-1.054751253523952054, 1.794075294689396615],
    ]
)

# azimuth (radians) from each face center to the Class II i-axis
FACE_AXES_AZ_I = np.array(
    [
        5.619958268523939882,
        5.760339081714187279,
        0.780213654393430055,
        0.430469363979999913,
        6.130269123335111400,
        2.692877706530642877,
        2.982963003477243874,
        3.532912002790141181,
        3.494305004259568154,
        3.003214169499538391,
        5.930472956509811562,
        0.138378484090254847,
        0.448714947059150361,
        0.158629650112549365,
        5.891865957979238535,
        2.711123289609793325,
        3.294508837434268316,
        3.804819692245439833,
        3.664438879055192436,
        2.361378999196363184,
    ]
)

# rotation between Class II and Class III resolutions: asin(sqrt(3/28))
AP7_ROT_RADS = 0.333473172251832115336090755351601070065900704
# scale: res-0 unit hex planar length -> gnomonic unit length
RES0_U_GNOMONIC = 0.38196601125010500003

SQRT7 = 7.0**0.5
SIN60 = float(np.sqrt(3.0) / 2.0)  # Python float: np.float64 scalars are
# strongly typed and would promote an f32 device batch to emulated f64
MAX_RES = 15
NUM_BASE_CELLS = 122
NUM_FACES = 20

# H3Index bit layout
MODE_CELL = 1
MODE_OFFSET = 59
RES_OFFSET = 52
BASE_CELL_OFFSET = 45
PER_DIGIT_OFFSET = 3
DIGIT_MASK = 0b111

# digit names
CENTER_DIGIT = 0
K_AXES_DIGIT = 1
J_AXES_DIGIT = 2
JK_AXES_DIGIT = 3
I_AXES_DIGIT = 4
IK_AXES_DIGIT = 5
IJ_AXES_DIGIT = 6
INVALID_DIGIT = 7

# unit ijk vector per digit (digit -> (i, j, k))
UNIT_VECS = np.array(
    [
        [0, 0, 0],  # center
        [0, 0, 1],  # k
        [0, 1, 0],  # j
        [0, 1, 1],  # jk
        [1, 0, 0],  # i
        [1, 0, 1],  # ik
        [1, 1, 0],  # ij
    ],
    dtype=np.int64,
)

# 60-degree digit rotations (index 7 = INVALID maps to itself)
ROT60_CCW = np.array([0, 5, 3, 1, 6, 4, 2, 7], dtype=np.int64)
# inverse
ROT60_CW = np.array([0, 3, 6, 2, 5, 1, 4, 7], dtype=np.int64)

EARTH_RADIUS_KM = 6371.007180918475
