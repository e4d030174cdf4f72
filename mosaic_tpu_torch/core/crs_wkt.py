"""OGC WKT1 CRS parser — `.prj` text -> :class:`~.crs_proj.ProjCRS`.

Port of ``mosaic_tpu/core/crs_wkt.py``: host numpy code,
kept as a copy so that the port never imports the JAX package.

The reference resolves arbitrary CRS text through proj4j
(`core/geometry/MosaicGeometry.scala:102-128` transforms between any
CRSs; OGR feeds it `.prj` WKT). This module gives this package the same
entry point WITHOUT a CRS library: the WKT tree is parsed directly and
lowered to a PROJ string for :func:`~.crs_proj.parse_proj`, so every
projection family implemented there (tmerc/utm, merc, lcc, aea, laea,
stere polar, sterea, somerc, omerc A/B, cass, eqdc, nzmg, krovak, poly,
cea, eqc, sinu, moll, longlat) is reachable from a shapefile sidecar.

Both WKT1-OGC and WKT1-ESRI spellings of projection/parameter names are
accepted (case-, space- and underscore-insensitive).
"""

from __future__ import annotations

import math
import re

from .crs_proj import ProjCRS, parse_proj, register_crs

__all__ = [
    "parse_wkt_tree",
    "wkt_to_proj_string",
    "parse_crs_wkt",
    "srid_of_wkt",
    "register_prj_text",
]


class _Node:
    __slots__ = ("name", "items")

    def __init__(self, name: str, items: list):
        self.name = name
        self.items = items  # str | float | _Node

    def first(self, name: str) -> "_Node | None":
        low = name.upper()
        for it in self.items:
            if isinstance(it, _Node) and it.name.upper() == low:
                return it
        return None

    def all(self, name: str) -> "list[_Node]":
        low = name.upper()
        return [
            it
            for it in self.items
            if isinstance(it, _Node) and it.name.upper() == low
        ]


def parse_wkt_tree(text: str) -> _Node:
    """WKT1 `NAME[...]` tree (both ``[]`` and ``()`` bracket styles)."""
    s = text.strip()
    pos = 0
    n = len(s)

    def skip_ws():
        nonlocal pos
        while pos < n and s[pos] in " \t\r\n,":
            pos += 1

    def parse_value():
        nonlocal pos
        skip_ws()
        if pos >= n:
            raise ValueError("truncated WKT")
        c = s[pos]
        if c == '"':
            j = s.index('"', pos + 1)
            v = s[pos + 1 : j]
            pos = j + 1
            return v
        m = re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s[pos:])
        if m and (s[pos].isdigit() or s[pos] in "+-."):
            pos += m.end()
            return float(m.group(0))
        m = re.match(r"[A-Za-z_][A-Za-z0-9_]*", s[pos:])
        if not m:
            raise ValueError(f"bad WKT at offset {pos}: {s[pos:pos+24]!r}")
        name = m.group(0)
        pos += m.end()
        skip_ws()
        if pos < n and s[pos] in "[(":
            close = "]" if s[pos] == "[" else ")"
            pos += 1
            items = []
            while True:
                skip_ws()
                if pos >= n:
                    raise ValueError(f"unclosed {name}[")
                if s[pos] == close:
                    pos += 1
                    break
                items.append(parse_value())
            return _Node(name, items)
        return _Node(name, [])

    node = parse_value()
    if not isinstance(node, _Node):
        raise ValueError("WKT does not start with a node")
    return node


def _norm(name: str) -> str:
    return re.sub(r"[ _()-]+", " ", str(name).strip().lower()).strip()


#: WKT1 PROJECTION name (OGC + ESRI spellings, normalized) -> +proj
_PROJ_OF = {
    "transverse mercator": "tmerc",
    "gauss kruger": "tmerc",
    "mercator": "merc",
    "mercator 1sp": "merc",
    "mercator 2sp": "merc",
    "mercator auxiliary sphere": "merc",
    "popular visualisation pseudo mercator": "merc",
    "lambert conformal conic": "lcc",
    "lambert conformal conic 1sp": "lcc",
    "lambert conformal conic 2sp": "lcc",
    "albers": "aea",
    "albers conic equal area": "aea",
    "lambert azimuthal equal area": "laea",
    "polar stereographic": "stere",
    "stereographic": "sterea",
    "oblique stereographic": "sterea",
    "double stereographic": "sterea",
    "stereographic north pole": "stere",
    "stereographic south pole": "stere",
    "hotine oblique mercator": "omerc",
    "hotine oblique mercator azimuth natural origin": "omerc_a",
    "hotine oblique mercator azimuth center": "omerc",
    "rectified skew orthomorphic natural origin": "omerc_a",
    "rectified skew orthomorphic center": "omerc",
    "swiss oblique mercator": "somerc",
    "swiss oblique cylindrical": "somerc",
    "hotine oblique mercator variant b": "omerc",
    "hotine oblique mercator variant a": "omerc_a",
    "cassini soldner": "cass",
    "cassini": "cass",
    "equidistant conic": "eqdc",
    "new zealand map grid": "nzmg",
    "krovak": "krovak",
    "american polyconic": "poly",
    "polyconic": "poly",
    "cylindrical equal area": "cea",
    "behrmann": "cea",
    "equirectangular": "eqc",
    "equidistant cylindrical": "eqc",
    "plate carree": "eqc",
    "sinusoidal": "sinu",
    "mollweide": "moll",
}

#: WKT1 PARAMETER name (normalized) -> PROJ key; lat_ts-style families
#: remap standard_parallel_1 below
_PARAM_OF = {
    "latitude of origin": "lat_0",
    "latitude of center": "lat_0",
    "latitude of natural origin": "lat_0",
    "central meridian": "lon_0",
    "longitude of center": "lon_0",
    "longitude of natural origin": "lon_0",
    "longitude of origin": "lon_0",
    "scale factor": "k_0",
    "scale factor at natural origin": "k_0",
    "scale factor on initial line": "k_0",
    "scale factor on pseudo standard parallel": "k_0",
    "false easting": "x_0",
    "false northing": "y_0",
    "standard parallel 1": "lat_1",
    "standard parallel 2": "lat_2",
    "azimuth": "alpha",
    "azimuth of initial line": "alpha",
    "rectified grid angle": "gamma",
    "angle from rectified to skew grid": "gamma",
    "pseudo standard parallel 1": "lat_1",
    "latitude of pseudo standard parallel": "lat_1",
    "latitude of standard parallel": "lat_ts",
    "standard parallel": "lat_ts",
    "latitude of 1st standard parallel": "lat_1",
    "latitude of 2nd standard parallel": "lat_2",
    "auxiliary sphere type": None,  # handled via sphere forcing
    "x scale": None,
    "y scale": None,
    "xy plane rotation": None,
}

#: families whose standard_parallel_1 means +lat_ts, not +lat_1
_LAT_TS_FAMILIES = {"merc", "cea", "eqc", "stere"}


def _geogcs_parts(geog: _Node) -> tuple[str, float]:
    """-> (proj fragments for datum/ellipsoid/prime meridian, angular unit
    in degrees-per-unit)."""
    datum = geog.first("DATUM")
    if datum is None:
        raise ValueError("GEOGCS without DATUM")
    sph = datum.first("SPHEROID") or datum.first("ELLIPSOID")
    if sph is None:
        raise ValueError("DATUM without SPHEROID")
    nums = [x for x in sph.items if isinstance(x, float)]
    if len(nums) < 2:
        raise ValueError("SPHEROID needs (a, rf)")
    a, rf = nums[0], nums[1]
    frag = f"+a={a!r} " + (f"+rf={rf!r} " if rf else f"+b={a!r} ")
    _geogcs_parts.last_a = a  # for sphere-forcing projections
    tw = datum.first("TOWGS84")
    if tw is not None:
        vals = [x for x in tw.items if isinstance(x, float)]
        if any(vals):
            frag += "+towgs84=" + ",".join(repr(v) for v in vals) + " "
    pm = geog.first("PRIMEM")
    if pm is not None:
        pmv = [x for x in pm.items if isinstance(x, float)]
        if pmv and pmv[0]:
            frag += f"+pm={pmv[0]!r} "
    unit = geog.first("UNIT")
    ang_deg = 1.0
    if unit is not None:
        uv = [x for x in unit.items if isinstance(x, float)]
        if uv and uv[0]:
            ang_deg = math.degrees(uv[0])  # radians-per-unit -> deg
    if abs(ang_deg - 1.0) < 1e-9:
        ang_deg = 1.0  # exact degrees: don't smear parameter values
    return frag, ang_deg


def wkt_to_proj_string(text: str) -> str:
    """Lower WKT1 CRS text to the equivalent PROJ string."""
    root = parse_wkt_tree(text)
    kind = root.name.upper()
    if kind in ("GEOGCS", "GEOGCRS", "GEODCRS"):
        frag, _ = _geogcs_parts(root)
        return "+proj=longlat " + frag
    if kind != "PROJCS":
        raise ValueError(f"unsupported WKT root {root.name!r}")
    geog = root.first("GEOGCS")
    if geog is None:
        raise ValueError("PROJCS without GEOGCS")
    frag, ang_deg = _geogcs_parts(geog)
    projection = root.first("PROJECTION")
    if projection is None or not projection.items:
        raise ValueError("PROJCS without PROJECTION")
    pname = _norm(projection.items[0])
    proj = _PROJ_OF.get(pname)
    if proj is None:
        raise ValueError(
            f"unsupported PROJECTION {projection.items[0]!r} "
            f"(known: {sorted(set(_PROJ_OF))})"
        )
    no_uoff = proj == "omerc_a"
    if no_uoff:
        proj = "omerc"
    if pname in (
        "mercator auxiliary sphere",
        "popular visualisation pseudo mercator",
    ):
        # Web Mercator is SPHERICAL mercator on the ellipsoid's a —
        # keeping the ellipsoid here would misplace latitudes by ~0.19°
        a = _geogcs_parts.last_a
        frag = re.sub(r"\+rf=\S+ ", f"+b={a!r} ", frag)

    # linear unit scales false eastings/northings (and coordinates)
    unit = None
    for it in root.items:  # the PROJCS-level UNIT, not the GEOGCS one
        if isinstance(it, _Node) and it.name.upper() == "UNIT":
            unit = it
    u = 1.0
    if unit is not None:
        uv = [x for x in unit.items if isinstance(x, float)]
        if uv and uv[0]:
            u = uv[0]

    params: dict[str, float] = {}
    for p in root.all("PARAMETER"):
        if len(p.items) < 2 or not isinstance(p.items[0], str):
            continue
        key = _PARAM_OF.get(_norm(p.items[0]), "_unknown")
        val = next((x for x in p.items if isinstance(x, float)), None)
        if key is None or val is None:
            continue
        if key == "_unknown":
            raise ValueError(f"unsupported PARAMETER {p.items[0]!r}")
        params[key] = val

    if proj in _LAT_TS_FAMILIES and "lat_1" in params and (
        "lat_ts" not in params
    ):
        params["lat_ts"] = params.pop("lat_1")
    if proj == "stere":
        # ESRI "Stereographic_North/South_Pole" carries the pole in
        # standard_parallel_1's sign; OGC Polar_Stereographic in lat_0.
        # Parameter values are still in the CRS's angular unit here (the
        # ``val *= ang_deg`` scaling below), so both the is-it-the-pole
        # test and the injected pole must be expressed in that unit — a
        # raw 90.0 in a grads .prj would scale to 81° and miss the pole.
        if (
            "lat_0" not in params
            or abs(params["lat_0"] * ang_deg) != 90.0
        ):
            ts = params.get("lat_ts", params.get("lat_0", 90.0))
            params["lat_0"] = math.copysign(90.0 / ang_deg, ts)
    if proj == "omerc":
        # omerc's center longitude rides +lonc
        if "lon_0" in params:
            params["lonc"] = params.pop("lon_0")
    if proj == "lcc" and "lat_1" not in params and "lat_0" in params:
        params["lat_1"] = params["lat_0"]  # 1SP form

    parts = [f"+proj={proj} ", frag]
    if no_uoff:
        parts.append("+no_uoff ")
    for key, val in params.items():
        if key in ("x_0", "y_0"):
            val *= u  # CRS linear units -> metres
        elif key not in ("k_0",):
            val *= ang_deg  # CRS angular units -> degrees
        parts.append(f"+{key}={val!r} ")
    if u != 1.0:
        parts.append(f"+to_meter={u!r} ")
    return "".join(parts).strip()


def parse_crs_wkt(text: str, area: tuple | None = None) -> ProjCRS:
    return parse_proj(wkt_to_proj_string(text), area)


def srid_of_wkt(text: str) -> int | None:
    """The top-level AUTHORITY["EPSG", code], if present."""
    try:
        root = parse_wkt_tree(text)
    except ValueError:
        return None
    auth = root.first("AUTHORITY") or root.first("ID")
    if auth is None:
        return None
    vals = [x for x in auth.items if not isinstance(x, _Node)]
    for v in vals[1:]:
        try:
            return int(float(v))
        except (TypeError, ValueError):
            continue
    return None


_SYNTHETIC_BASE = 900900
_synthetic = {}


def register_prj_text(text: str) -> int:
    """Resolve `.prj` WKT to a usable srid: the declared EPSG code when
    the WKT carries one (registering the parsed definition if the EPSG
    table lacks it), else a stable synthetic code in the 9009xx range —
    either way `st_transform`/`st_set_srid` work on the result."""
    proj_string = wkt_to_proj_string(text)
    srid = srid_of_wkt(text)
    if srid is not None:
        from .crs_proj import lookup

        if lookup(srid) is None:
            register_crs(srid, proj_string)
        return srid
    if proj_string in _synthetic:
        return _synthetic[proj_string]
    srid = _SYNTHETIC_BASE + len(_synthetic)
    register_crs(srid, proj_string)
    _synthetic[proj_string] = srid
    return srid
