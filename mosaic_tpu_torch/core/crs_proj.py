"""PROJ-string-driven CRS construction: arbitrary-EPSG support.

Port of ``mosaic_tpu/core/crs_proj.py``: host numpy code,
kept as a copy so that the port never imports the JAX package.

Reference analog: the reference reprojects any EPSG code its bundled
proj4j registry knows (`core/geometry/MosaicGeometry.scala:102-128`) and
validates against the 3,288-row `CRSBounds.csv`
(`core/crs/CRSBoundsProvider.scala:18-100`). Here the equivalent breadth
comes from a parameter-driven constructor instead of a static database:
any code whose definition maps onto the implemented projection families
(transverse Mercator / UTM, Lambert conformal conic 1SP+2SP, Albers,
Lambert azimuthal equal-area, polar stereographic, Mercator, geographic)
can be built from its PROJ.4 string — either from the built-in EPSG table
below or registered at runtime with :func:`register_crs`. Datum shifts
ride the 7-parameter position-vector Helmert (``+towgs84``), the same
convention and default-null behavior as proj4j.

Validity bounds derive from each definition's geographic area of use
(stored with the entry, or a family-default envelope), with the projected
envelope computed by transforming a densified boundary — replacing the
reference's static CSV rows.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .crs import (
    TMParams,
    _ecef_to_geodetic,
    _geodetic_to_ecef,
    _helmert,
    cass_forward,
    cass_inverse,
    cea_forward,
    cea_inverse,
    eqc_forward,
    eqc_inverse,
    moll_forward,
    moll_inverse,
    sinu_forward,
    sinu_inverse,
    eqdc_forward,
    eqdc_inverse,
    laea_forward,
    laea_inverse,
    nzmg_forward,
    nzmg_inverse,
    omerc_forward,
    omerc_inverse,
    tm_south_forward,
    tm_south_inverse,
    lcc2sp_forward,
    lcc2sp_inverse,
    albers_forward,
    albers_inverse,
    krovak_forward,
    krovak_inverse,
    poly_forward,
    poly_inverse,
    merc_forward,
    merc_inverse,
    somerc_forward,
    somerc_inverse,
    stere_polar_forward,
    stere_polar_inverse,
    sterea_forward,
    sterea_inverse,
    tm_forward,
    tm_inverse,
)

_R = math.radians

#: ellipsoid name -> (semi-major a, inverse flattening rf; rf=0 -> sphere)
ELLIPSOIDS: dict[str, tuple[float, float]] = {
    "WGS84": (6378137.0, 298.257223563),
    "GRS80": (6378137.0, 298.257222101),
    "airy": (6377563.396, 299.3249646),
    "bessel": (6377397.155, 299.1528128),
    "intl": (6378388.0, 297.0),
    "clrk66": (6378206.4, 294.9786982),
    "clrk80ign": (6378249.2, 293.4660213),
    "mod_airy": (6377340.189, 299.3249646),
    "krass": (6378245.0, 298.3),
    "WGS72": (6378135.0, 298.26),
    "aust_SA": (6378160.0, 298.25),
    "evrst30": (6377276.345, 300.8017),
    "sphere": (6370997.0, 0.0),
}

#: datum name -> (ellipsoid, towgs84 tuple of 3 or 7 published params)
DATUMS: dict[str, tuple[str, tuple[float, ...]]] = {
    "WGS84": ("WGS84", ()),
    "NAD83": ("GRS80", ()),
    "GGRS87": ("GRS80", (-199.87, 74.79, 246.62)),
    "potsdam": ("bessel", (598.1, 73.7, 418.2, 0.202, 0.045, -2.455, 6.7)),
    "OSGB36": (
        "airy",
        (446.448, -125.157, 542.06, 0.1502, 0.247, 0.8421, -20.4894),
    ),
    "carthage": ("clrk80ign", (-263.0, 6.0, 431.0)),
    "nzgd49": ("intl", (59.47, -5.04, 187.44, 0.47, -0.1, 1.024, -4.5993)),
}

#: +units= name -> meters per unit
UNITS: dict[str, float] = {
    "m": 1.0,
    "us-ft": 1200.0 / 3937.0,
    "ft": 0.3048,
    "km": 1000.0,
}

_SUPPORTED_PROJ = (
    "utm, tmerc (incl. +axis=wsu south-orientated), merc, lcc, aea, eqdc, "
    "laea, stere (polar), sterea, somerc, omerc (Hotine A/B), krovak, "
    "cass, poly, nzmg, cea, eqc, sinu, moll, longlat/latlong"
)


@dataclasses.dataclass(frozen=True)
class ProjCRS:
    """One parsed CRS: projection family + ellipsoid + datum + units."""

    kind: str  # "tm" | "lcc2sp" | "albers" | "laea" | "stere_polar"
    #          | "sterea" | "somerc" | "krovak" | "merc" | "longlat"
    params: object  # TMParams or the family's parameter tuple (None: longlat)
    a: float
    e2: float
    #: (translations m, scale unitless, rotations rad) source->WGS84, or None
    towgs84: tuple | None
    to_meter: float
    area: tuple | None  # geographic lon/lat area of use if known


def _parse_tokens(s: str) -> dict[str, str | bool]:
    kv: dict[str, str | bool] = {}
    for tok in s.split():
        if not tok.startswith("+"):
            raise ValueError(f"bad PROJ token {tok!r} in {s!r}")
        body = tok[1:]
        if "=" in body:
            k, v = body.split("=", 1)
            kv[k] = v
        else:
            kv[body] = True
    return kv


def _f(kv, key, default=None):
    v = kv.get(key)
    if v is None:
        return default
    return float(v)


def _ellipsoid(kv) -> tuple[float, float, tuple[float, ...]]:
    """Resolve (a, rf, datum-default towgs84) from +datum/+ellps/+a+b/+rf."""
    shift: tuple[float, ...] = ()
    name = kv.get("ellps")
    if "datum" in kv:
        d = kv["datum"]
        if d not in DATUMS:
            raise ValueError(
                f"unknown +datum={d}; known: {sorted(DATUMS)}"
            )
        name, shift = DATUMS[d]
    a = _f(kv, "a")
    b = _f(kv, "b")
    rf = _f(kv, "rf")
    if rf is None and _f(kv, "f") is not None:
        rf = 1.0 / _f(kv, "f")
    if a is not None:
        if b is not None:
            rf = 0.0 if b == a else a / (a - b)
        elif rf is None:
            rf = 0.0  # sphere
        return a, rf, shift
    if name is None:
        name = "WGS84"
    if name not in ELLIPSOIDS:
        raise ValueError(
            f"unknown +ellps={name}; known: {sorted(ELLIPSOIDS)}"
        )
    ea, erf = ELLIPSOIDS[name]
    return ea, erf, shift


def _towgs84(kv, datum_shift) -> tuple | None:
    raw = kv.get("towgs84")
    vals = (
        tuple(float(x) for x in raw.split(","))
        if isinstance(raw, str)
        else datum_shift
    )
    if not vals or not any(vals):
        return None
    if len(vals) == 3:
        vals = vals + (0.0, 0.0, 0.0, 0.0)
    if len(vals) != 7:
        raise ValueError(f"+towgs84 needs 3 or 7 values, got {len(vals)}")
    t = vals[:3]
    r = tuple(_R(sec / 3600.0) for sec in vals[3:6])
    s = vals[6] * 1e-6
    return (t, s, r)


def parse_proj(s: str, area: tuple | None = None) -> ProjCRS:
    """Parse a PROJ.4 string into a :class:`ProjCRS`.

    Supported projections: {supported}. Raises ``ValueError`` with the
    supported list for anything else (robin, tpeqd, ...).
    """
    kv = _parse_tokens(s)
    proj = kv.get("proj")
    if not isinstance(proj, str):
        raise ValueError(f"missing +proj= in {s!r}")
    if kv.get("pm") not in (None, "greenwich", "0"):
        raise ValueError(f"non-Greenwich prime meridian unsupported: {s!r}")
    a, rf, datum_shift = _ellipsoid(kv)
    f = 0.0 if rf == 0 else 1.0 / rf
    b = a * (1.0 - f)
    e2 = f * (2 - f)
    e = math.sqrt(e2)
    shift = _towgs84(kv, datum_shift)
    unit = kv.get("units", "m")
    if unit not in UNITS:
        raise ValueError(f"unknown +units={unit}; known: {sorted(UNITS)}")
    to_meter = _f(kv, "to_meter", UNITS[unit])

    lat0 = _R(_f(kv, "lat_0", 0.0))
    lon0 = _R(_f(kv, "lon_0", 0.0))
    fe = _f(kv, "x_0", 0.0)
    fn = _f(kv, "y_0", 0.0)
    k0 = _f(kv, "k_0", _f(kv, "k"))

    if proj in ("longlat", "latlong", "latlon", "lonlat"):
        return ProjCRS("longlat", None, a, e2, shift, 1.0, area)
    if proj == "utm":
        zone = int(kv.get("zone", 0))
        if not 1 <= zone <= 60:
            raise ValueError(f"+proj=utm needs +zone=1..60, got {zone}")
        south = bool(kv.get("south"))
        p = TMParams(
            a=a, b=b, f0=0.9996, lat0=0.0,
            lon0=_R(zone * 6.0 - 183.0), e0=500000.0,
            n0=10000000.0 if south else 0.0,
        )
        return ProjCRS("tm", p, a, e2, shift, to_meter, area)
    if proj == "tmerc":
        axis = kv.get("axis", "enu")
        if axis not in ("enu", "wsu"):
            raise ValueError(f"+axis={axis} unsupported for tmerc")
        p = TMParams(
            a=a, b=b, f0=k0 if k0 is not None else 1.0,
            lat0=lat0, lon0=lon0, e0=fe, n0=fn,
        )
        # +axis=wsu = EPSG 9808 TM South Orientated (South African Lo)
        kind = "tm_south" if axis == "wsu" else "tm"
        return ProjCRS(kind, p, a, e2, shift, to_meter, area)
    if proj == "merc":
        if k0 is None:
            lat_ts = _f(kv, "lat_ts", 0.0)
            s_ = math.sin(_R(lat_ts))
            k0 = math.cos(_R(lat_ts)) / math.sqrt(1 - e2 * s_ * s_)
        return ProjCRS(
            "merc", (a, e, k0, lon0, fe, fn), a, e2, shift, to_meter, area
        )
    if proj == "lcc":
        lat1 = _f(kv, "lat_1")
        lat2 = _f(kv, "lat_2")
        if lat1 is None:
            lat1 = math.degrees(lat0)  # 1SP centered on lat_0
        if lat2 is None:
            # 1SP: k_0 scales every radius; folding it into `a` is exact
            # because rho and rho0 are both linear in a
            lat2 = lat1
            a_eff = a * (k0 if k0 is not None else 1.0)
        else:
            if k0 not in (None, 1.0):
                raise ValueError("+k_0 with two-SP lcc is unsupported")
            a_eff = a
        p = (a_eff, e, lat0, lon0, _R(lat1), _R(lat2), fe, fn)
        return ProjCRS("lcc2sp", p, a, e2, shift, to_meter, area)
    if proj == "aea":
        lat1 = _f(kv, "lat_1", 0.0)
        lat2 = _f(kv, "lat_2", lat1)
        p = (a, e, lat0, lon0, _R(lat1), _R(lat2), fe, fn)
        return ProjCRS("albers", p, a, e2, shift, to_meter, area)
    if proj == "eqdc":
        lat1 = _f(kv, "lat_1", 0.0)
        lat2 = _f(kv, "lat_2", lat1)
        if abs(lat1 + lat2) < 1e-9:  # n = 0: the cone degenerates
            raise ValueError(
                "+proj=eqdc standard parallels must not be symmetric "
                f"about the equator (lat_1={lat1}, lat_2={lat2})"
            )
        p = (a, e, lat0, lon0, _R(lat1), _R(lat2), fe, fn)
        return ProjCRS("eqdc", p, a, e2, shift, to_meter, area)
    if proj == "cass":
        p = (a, e, lat0, lon0, fe, fn)
        return ProjCRS("cass", p, a, e2, shift, to_meter, area)
    if proj == "nzmg":
        # fixed published definition; parameters default to NZMG's own —
        # including the International 1924 ellipsoid the Reilly
        # polynomial was fitted for (a bare +proj=nzmg must not pick up
        # the global WGS84 default: ~4e-5 relative scale error)
        if not any(k in kv for k in ("a", "b", "rf", "ellps", "datum")):
            a, rf = ELLIPSOIDS["intl"]
            f_ = 1.0 / rf
            e2 = f_ * (2 - f_)
        p = (
            a,
            lat0 if _f(kv, "lat_0") is not None else _R(-41.0),
            lon0 if _f(kv, "lon_0") is not None else _R(173.0),
            fe if _f(kv, "x_0") is not None else 2510000.0,
            fn if _f(kv, "y_0") is not None else 6023150.0,
        )
        return ProjCRS("nzmg", p, a, e2, shift, to_meter, area)
    if proj == "omerc":
        lonc = _R(_f(kv, "lonc", math.degrees(lon0)))
        alpha = _f(kv, "alpha")
        if alpha is None:
            raise ValueError(
                "+proj=omerc needs +alpha (two-point form unsupported)"
            )
        gamma = _f(kv, "gamma", alpha)
        variant = "A" if kv.get("no_uoff") else "B"
        p = (
            a, e, lat0, lonc, _R(alpha), _R(gamma),
            k0 if k0 is not None else 1.0, fe, fn, variant,
        )
        return ProjCRS("omerc", p, a, e2, shift, to_meter, area)
    if proj == "laea":
        return ProjCRS(
            "laea", (a, e, lat0, lon0, fe, fn), a, e2, shift, to_meter, area
        )
    if proj == "cea":
        lat_ts = _R(_f(kv, "lat_ts", 0.0))
        if k0 is not None:
            raise ValueError("+proj=cea takes +lat_ts, not +k_0")
        p = (a, e, lat_ts, lon0, fe, fn)
        return ProjCRS("cea", p, a, e2, shift, to_meter, area)
    if proj == "eqc":
        lat_ts = _R(_f(kv, "lat_ts", 0.0))
        p = (a, e, lat_ts, lat0, lon0, fe, fn)
        return ProjCRS("eqc", p, a, e2, shift, to_meter, area)
    if proj == "sinu":
        p = (a, e, lon0, fe, fn)
        return ProjCRS("sinu", p, a, e2, shift, to_meter, area)
    if proj == "moll":
        # spherical formulation on radius a (PROJ behavior); validity
        # bounds still use the declared ellipsoid for the datum shift
        p = (a, lon0, fe, fn)
        return ProjCRS("moll", p, a, e2, shift, to_meter, area)
    if proj == "poly":
        p = (a, e, lat0, lon0, fe, fn)
        return ProjCRS("poly", p, a, e2, shift, to_meter, area)
    if proj == "krovak":
        # defaults are the S-JTSK definition (EPSG 9819); +alpha is the
        # cone-axis azimuth, the 78.5 deg pseudo standard parallel is
        # fixed unless +lat_1 overrides it
        alpha = _R(_f(kv, "alpha", 30.28813972222222))
        phi1 = _R(_f(kv, "lat_1", 78.5))
        lat0 = _R(_f(kv, "lat_0", 49.5))
        # PROJ's krovak lon_0 default is 24d50'E (S-JTSK), not Greenwich
        klon0 = _R(_f(kv, "lon_0", 24.833333333333332))
        p = (
            a, e, lat0, klon0, alpha, phi1,
            k0 if k0 is not None else 0.9999, fe, fn,
        )
        return ProjCRS("krovak", p, a, e2, shift, to_meter, area)
    if proj == "sterea":
        p = (a, e, lat0, lon0, k0 if k0 is not None else 1.0, fe, fn)
        return ProjCRS("sterea", p, a, e2, shift, to_meter, area)
    if proj == "somerc":
        p = (a, e, lat0, lon0, k0 if k0 is not None else 1.0, fe, fn)
        return ProjCRS("somerc", p, a, e2, shift, to_meter, area)
    if proj == "stere":
        if abs(abs(math.degrees(lat0)) - 90.0) > 1e-9:
            raise ValueError(
                "only polar +proj=stere (+lat_0=+-90) is implemented; "
                "use +proj=sterea for the oblique (double) stereographic"
            )
        south = lat0 < 0
        lat_ts = _f(kv, "lat_ts")
        lts = None if lat_ts is None else _R(lat_ts)
        kk = None if lat_ts is not None else (k0 if k0 is not None else 1.0)
        p = (a, e, south, lts, kk, lon0, fe, fn)
        return ProjCRS("stere_polar", p, a, e2, shift, to_meter, area)
    raise ValueError(
        f"unsupported +proj={proj}; implemented families: {_SUPPORTED_PROJ}"
    )


parse_proj.__doc__ = parse_proj.__doc__.format(supported=_SUPPORTED_PROJ)


_FWD = {
    "nzmg": nzmg_forward,
    "cass": cass_forward,
    "cea": cea_forward,
    "eqc": eqc_forward,
    "sinu": sinu_forward,
    "moll": moll_forward,
    "eqdc": eqdc_forward,
    "omerc": omerc_forward,
    "tm_south": tm_south_forward,
    "tm": tm_forward,
    "lcc2sp": lcc2sp_forward,
    "albers": albers_forward,
    "laea": laea_forward,
    "stere_polar": stere_polar_forward,
    "krovak": krovak_forward,
    "poly": poly_forward,
    "sterea": sterea_forward,
    "somerc": somerc_forward,
    "merc": merc_forward,
}
_INV = {
    "nzmg": nzmg_inverse,
    "cass": cass_inverse,
    "cea": cea_inverse,
    "eqc": eqc_inverse,
    "sinu": sinu_inverse,
    "moll": moll_inverse,
    "eqdc": eqdc_inverse,
    "omerc": omerc_inverse,
    "tm_south": tm_south_inverse,
    "tm": tm_inverse,
    "lcc2sp": lcc2sp_inverse,
    "albers": albers_inverse,
    "laea": laea_inverse,
    "stere_polar": stere_polar_inverse,
    "krovak": krovak_inverse,
    "poly": poly_inverse,
    "sterea": sterea_inverse,
    "somerc": somerc_inverse,
    "merc": merc_inverse,
}


def _shift_to_wgs84(crs: ProjCRS, lonlat, xp):
    t, s, r = crs.towgs84
    x, y, z = _geodetic_to_ecef(lonlat, crs.a, crs.e2, xp)
    x, y, z = _helmert(x, y, z, t, s, r, +1.0, xp)
    from .crs import WGS84_A, _WGS_E2

    return _ecef_to_geodetic(x, y, z, WGS84_A, _WGS_E2, xp)


def _shift_from_wgs84(crs: ProjCRS, lonlat, xp):
    t, s, r = crs.towgs84
    from .crs import WGS84_A, _WGS_E2

    x, y, z = _geodetic_to_ecef(lonlat, WGS84_A, _WGS_E2, xp)
    x, y, z = _helmert(x, y, z, t, s, r, -1.0, xp)
    return _ecef_to_geodetic(x, y, z, crs.a, crs.e2, xp)


def crs_to_wgs84(crs: ProjCRS, xy, xp=np):
    """(N,2) coords in ``crs`` -> (N,2) lon/lat degrees WGS84."""
    if crs.kind == "longlat":
        ll = xp.radians(xy)
    else:
        if crs.to_meter != 1.0:
            xy = xy * crs.to_meter
        ll = _INV[crs.kind](crs.params, xy, xp)
    if crs.towgs84 is not None:
        ll = _shift_to_wgs84(crs, ll, xp)
    return xp.degrees(ll)


def crs_from_wgs84(crs: ProjCRS, lonlat_deg, xp=np):
    """(N,2) lon/lat degrees WGS84 -> (N,2) coords in ``crs``."""
    ll = xp.radians(lonlat_deg)
    if crs.towgs84 is not None:
        ll = _shift_from_wgs84(crs, ll, xp)
    if crs.kind == "longlat":
        return xp.degrees(ll)
    en = _FWD[crs.kind](crs.params, ll, xp)
    if crs.to_meter != 1.0:
        en = en / crs.to_meter
    return en


def default_area(crs: ProjCRS) -> tuple[float, float, float, float]:
    """Family-default geographic envelope when no area of use is stored."""
    if crs.kind == "longlat":
        return (-180.0, -90.0, 180.0, 90.0)
    if crs.kind == "merc":
        return (-180.0, -85.06, 180.0, 85.06)
    if crs.kind in ("tm", "tm_south"):
        lon0 = math.degrees(crs.params.lon0)
        return (lon0 - 3.5, -80.0, lon0 + 3.5, 84.0)
    if crs.kind == "nzmg":
        return (166.37, -47.33, 178.63, -34.1)
    if crs.kind == "cass":
        _, _, lat0, lon0, _, _ = crs.params
        lat0, lon0 = math.degrees(lat0), math.degrees(lon0)
        return (lon0 - 3.0, max(lat0 - 4.0, -89.0), lon0 + 3.0, min(lat0 + 4.0, 89.0))
    if crs.kind == "omerc":
        _, _, lat0, lonc, _, _, _, _, _, _ = crs.params
        lat0, lonc = math.degrees(lat0), math.degrees(lonc)
        return (lonc - 8.0, max(lat0 - 8.0, -89.0), lonc + 8.0, min(lat0 + 8.0, 89.0))
    if crs.kind in ("lcc2sp", "albers", "eqdc"):
        _, _, _, lon0, lat1, lat2, _, _ = crs.params
        lo = min(math.degrees(lat1), math.degrees(lat2)) - 10.0
        hi = max(math.degrees(lat1), math.degrees(lat2)) + 10.0
        lon0 = math.degrees(lon0)
        return (lon0 - 30.0, max(lo, -89.0), lon0 + 30.0, min(hi, 89.0))
    if crs.kind == "laea":
        _, _, lat0, lon0, _, _ = crs.params
        lat0, lon0 = math.degrees(lat0), math.degrees(lon0)
        return (
            max(lon0 - 90.0, -180.0), max(lat0 - 45.0, -90.0),
            min(lon0 + 90.0, 180.0), min(lat0 + 45.0, 90.0),
        )
    if crs.kind == "poly":
        _, _, lat0, lon0, _, _ = crs.params
        lat0, lon0 = math.degrees(lat0), math.degrees(lon0)
        return (
            max(lon0 - 30.0, -180.0), max(lat0 - 30.0, -89.0),
            min(lon0 + 30.0, 180.0), min(lat0 + 30.0, 89.0),
        )
    if crs.kind == "krovak":
        return (12.0, 47.7, 22.6, 51.1)  # S-JTSK area of use
    if crs.kind in ("sterea", "somerc"):
        _, _, lat0, lon0, _, _, _ = crs.params
        lat0, lon0 = math.degrees(lat0), math.degrees(lon0)
        return (
            max(lon0 - 10.0, -180.0), max(lat0 - 8.0, -89.0),
            min(lon0 + 10.0, 180.0), min(lat0 + 8.0, 89.0),
        )
    if crs.kind == "stere_polar":
        south = crs.params[2]
        return (
            (-180.0, -90.0, 180.0, -60.0)
            if south
            else (-180.0, 60.0, 180.0, 90.0)
        )
    if crs.kind in ("cea", "eqc", "sinu", "moll"):  # world grids
        return (-180.0, -86.0, 180.0, 86.0)
    raise ValueError(f"no default area for projection kind {crs.kind!r}")


# --------------------------------------------------------------------------
# built-in EPSG table + runtime registry
# --------------------------------------------------------------------------
# Definitions authored from the published EPSG parameters (the same public
# registry both proj4j's database and the reference's CRSBounds.csv
# derive from); areas are each code's geographic area of use.

_GRS = "+ellps=GRS80"
_DHDN = (
    "+towgs84=598.1,73.7,418.2,0.202,0.045,-2.455,6.7 +ellps=bessel"
)

#: srid -> (proj string, geographic area of use)
_EPSG: dict[int, tuple[str, tuple[float, float, float, float]]] = {
    # ETRS89 / TM35FIN (Finland)
    3067: ("+proj=utm +zone=35 " + _GRS, (19.09, 59.30, 31.59, 70.13)),
    # SWEREF99 TM (Sweden)
    3006: ("+proj=utm +zone=33 " + _GRS, (10.03, 54.96, 24.17, 69.07)),
    # Estonian Coordinate System of 1997
    3301: (
        "+proj=lcc +lat_1=59.33333333333334 +lat_2=58 "
        "+lat_0=57.51755393055556 +lon_0=24 +x_0=500000 +y_0=6375000 " + _GRS,
        (21.84, 57.57, 28.00, 59.70),
    ),
    # ETRS89 / Portugal TM06
    3763: (
        "+proj=tmerc +lat_0=39.66825833333333 +lon_0=-8.133108333333334 "
        "+k=1 +x_0=0 +y_0=0 " + _GRS,
        (-9.50, 37.01, -6.19, 42.15),
    ),
    # Israeli TM Grid
    2039: (
        "+proj=tmerc +lat_0=31.73439361111111 +lon_0=35.20451694444445 "
        "+k=1.0000067 +x_0=219529.584 +y_0=626907.39 "
        "+towgs84=-24.0024,-17.1032,-17.8444,-0.33077,-1.85269,1.66969,5.4262 "
        + _GRS,
        (34.22, 29.49, 35.68, 33.27),
    ),
    # Belge 1972 / Belgian Lambert 72 (lat_0=90: 2SP conic through the pole)
    31370: (
        "+proj=lcc +lat_1=51.16666723333333 +lat_2=49.8333339 +lat_0=90 "
        "+lon_0=4.367486666666666 +x_0=150000.013 +y_0=5400088.438 "
        "+towgs84=-106.8686,52.2978,-103.7239,0.3366,-0.457,1.8422,-1.2747 "
        "+ellps=intl",
        (2.54, 49.51, 6.40, 51.50),
    ),
    # NAD83 / Quebec Lambert (+ the NAD83(CSRS) twin)
    32198: (
        "+proj=lcc +lat_1=60 +lat_2=46 +lat_0=44 +lon_0=-68.5 "
        "+x_0=0 +y_0=0 " + _GRS,
        (-79.76, 44.99, -57.10, 62.56),
    ),
    6622: (
        "+proj=lcc +lat_1=60 +lat_2=46 +lat_0=44 +lon_0=-68.5 "
        "+x_0=0 +y_0=0 " + _GRS,
        (-79.76, 44.99, -57.10, 62.56),
    ),
    # NAD83 / Maryland (m and ftUS)
    26985: (
        "+proj=lcc +lat_1=39.45 +lat_2=38.3 +lat_0=37.66666666666666 "
        "+lon_0=-77 +x_0=400000 +y_0=0 " + _GRS,
        (-79.49, 37.88, -74.98, 39.72),
    ),
    2248: (
        "+proj=lcc +lat_1=39.45 +lat_2=38.3 +lat_0=37.66666666666666 "
        "+lon_0=-77 +x_0=400000 +y_0=0 +units=us-ft " + _GRS,
        (-79.49, 37.88, -74.98, 39.72),
    ),
    # NAD83 / New York Long Island (m and ftUS)
    32118: (
        "+proj=lcc +lat_1=41.03333333333333 +lat_2=40.66666666666666 "
        "+lat_0=40.16666666666666 +lon_0=-74 +x_0=300000.0000000001 "
        "+y_0=0 " + _GRS,
        (-74.27, 40.47, -71.75, 41.31),
    ),
    2263: (
        "+proj=lcc +lat_1=41.03333333333333 +lat_2=40.66666666666666 "
        "+lat_0=40.16666666666666 +lon_0=-74 +x_0=300000.0000000001 "
        "+y_0=0 +units=us-ft " + _GRS,
        (-74.27, 40.47, -71.75, 41.31),
    ),
    # NAD83 / Illinois East (ftUS)
    3435: (
        "+proj=tmerc +lat_0=36.66666666666666 +lon_0=-88.33333333333333 "
        "+k=0.999975 +x_0=300000.0000000001 +y_0=0 +units=us-ft " + _GRS,
        (-89.28, 37.06, -87.02, 42.50),
    ),
    # ETRS89 / LCC Germany (N-E)
    5243: (
        "+proj=lcc +lat_1=48.66666666666666 +lat_2=53.66666666666666 "
        "+lat_0=51 +lon_0=10.5 +x_0=0 +y_0=0 " + _GRS,
        (5.87, 47.27, 15.04, 55.09),
    ),
    # WGS 84 / World Mercator (ellipsoidal, unlike spherical 3857)
    3395: (
        "+proj=merc +lon_0=0 +k=1 +x_0=0 +y_0=0 +ellps=WGS84",
        (-180.0, -80.0, 180.0, 84.0),
    ),
    # SAD69 / Brazil Polyconic (GRS67 "aust_SA" ellipsoid)
    29101: (
        "+proj=poly +lat_0=0 +lon_0=-54 +x_0=5000000 +y_0=10000000 "
        "+towgs84=-57,1,-41 +ellps=aust_SA",
        (-74.05, -35.89, -26.12, 7.25),
    ),
    # SIRGAS 2000 / Brazil Polyconic (same projection, GRS80, null shift)
    5880: (
        "+proj=poly +lat_0=0 +lon_0=-54 +x_0=5000000 +y_0=10000000 "
        + _GRS,
        (-74.05, -35.89, -26.12, 7.25),
    ),
    # S-JTSK / Krovak (Czechia + Slovakia): 5514 Greenwich-referenced,
    # 2065 the Ferro-referenced original (same projection, same axes here)
    5514: (
        "+proj=krovak +lat_0=49.5 +lon_0=24.83333333333333 "
        "+alpha=30.28813972222222 +k=0.9999 +x_0=0 +y_0=0 "
        "+towgs84=589,76,480 +ellps=bessel",
        (12.09, 47.74, 22.56, 51.05),
    ),
    # Amersfoort / RD New (Netherlands, oblique stereographic)
    28992: (
        "+proj=sterea +lat_0=52.15616055555555 +lon_0=5.38763888888889 "
        "+k=0.9999079 +x_0=155000 +y_0=463000 "
        "+towgs84=565.417,50.3319,465.552,-0.398957,0.343988,-1.8774,4.0725 "
        "+ellps=bessel",
        (3.37, 50.75, 7.21, 53.47),
    ),
    # CH1903 / LV03 and CH1903+ / LV95 (Swiss oblique Mercator)
    21781: (
        "+proj=somerc +lat_0=46.952405555555565 +lon_0=7.439583333333333 "
        "+k_0=1 +x_0=600000 +y_0=200000 "
        "+towgs84=674.374,15.056,405.346 +ellps=bessel",
        (5.97, 45.83, 10.49, 47.81),
    ),
    2056: (
        "+proj=somerc +lat_0=46.952405555555565 +lon_0=7.439583333333333 "
        "+k_0=1 +x_0=2600000 +y_0=1200000 "
        "+towgs84=674.374,15.056,405.346 +ellps=bessel",
        (5.97, 45.83, 10.49, 47.81),
    ),
    # geographic CRSs on non-WGS84 datums
    4277: ("+proj=longlat +datum=OSGB36", (-9.0, 49.75, 2.01, 61.01)),
    4314: ("+proj=longlat +datum=potsdam", (5.86, 47.27, 15.04, 55.09)),
    # ---- Hotine oblique Mercator (EPSG 9812 variant A / 9815 variant B)
    # NAD83 / Alaska zone 1 (variant A: +no_uoff)
    26931: (
        "+proj=omerc +lat_0=57 +lonc=-133.6666666666667 "
        "+alpha=323.1301023611111 +gamma=323.1301023611111 +k=0.9999 "
        "+x_0=5000000 +y_0=-5000000 +no_uoff " + _GRS,
        (-141.0, 54.61, -129.99, 60.35),
    ),
    # GDM2000 / Peninsular RSO (variant B, rectified skew != azimuth)
    3375: (
        "+proj=omerc +lat_0=4 +lonc=102.25 +alpha=323.0257964666666 "
        "+gamma=323.1301023611111 +k=0.99984 +x_0=804671 +y_0=0 " + _GRS,
        (99.59, 1.13, 104.60, 6.72),
    ),
    # GDM2000 / East Malaysia BRSO (variant B)
    3376: (
        "+proj=omerc +lat_0=4 +lonc=115 +alpha=53.31582047222222 "
        "+gamma=53.13010236111111 +k=0.99984 +x_0=0 +y_0=0 " + _GRS,
        (109.31, 0.85, 119.61, 7.67),
    ),
    # Timbalai 1948 / RSO Borneo (m) — the EPSG G7-2 worked example
    29873: (
        "+proj=omerc +lat_0=4 +lonc=115 +alpha=53.31582047222222 "
        "+gamma=53.13010236111111 +k=0.99984 +x_0=590476.87 "
        "+y_0=442857.65 +a=6377298.556 +rf=300.8017 +towgs84=-679,669,-48",
        (109.55, 0.85, 115.86, 7.35),
    ),
    # US National Atlas Equal Area (authalic sphere LAEA)
    2163: (
        "+proj=laea +lat_0=45 +lon_0=-100 +x_0=0 +y_0=0 +a=6370997 +b=6370997",
        (-130.0, 23.0, -65.0, 50.0),
    ),
    # NZGD49 / New Zealand Map Grid (EPSG 9811, complex polynomial)
    27200: (
        "+proj=nzmg +lat_0=-41 +lon_0=173 +x_0=2510000 +y_0=6023150 "
        "+datum=nzgd49",
        (166.37, -47.33, 178.63, -34.1),
    ),
    # ---- Cassini-Soldner (EPSG 9806)
    # Palestine 1923 / Palestine Grid (Clarke 1880 Benoit)
    28191: (
        "+proj=cass +lat_0=31.73409694444445 +lon_0=35.21208055555556 "
        "+x_0=170251.555 +y_0=126867.909 +a=6378300.789 +b=6356566.435 "
        "+towgs84=-275.722,94.7824,340.894,-8.001,-4.42,-11.821,1",
        (34.17, 29.18, 35.69, 33.38),
    ),
    # Kertau 1968 / Singapore Grid (Everest 1830 Modified)
    24500: (
        "+proj=cass +lat_0=1.287646666666667 +lon_0=103.8530022222222 "
        "+x_0=30000 +y_0=30000 +a=6377304.063 +b=6356103.038993155 "
        "+towgs84=-11,851,5",
        (103.59, 1.13, 104.07, 1.47),
    ),
    # ---- Equidistant conic (ESRI registry ids — the codes this family
    # actually travels under in the wild; resolvable like any EPSG int)
    102031: (
        "+proj=eqdc +lat_0=30 +lon_0=10 +lat_1=43 +lat_2=62 +x_0=0 +y_0=0 "
        "+towgs84=-87,-98,-121 +ellps=intl",
        (-10.67, 34.5, 31.55, 71.05),
    ),
    102026: (
        "+proj=eqdc +lat_0=30 +lon_0=95 +lat_1=15 +lat_2=65 +x_0=0 +y_0=0 "
        "+ellps=WGS84",
        (25.0, 10.0, 180.0, 84.0),
    ),
}

# POSGAR 2007 / Argentina fajas 1..7 (EPSG 5343..5349, faja z = 5342+z):
# Gauss-Krueger with lon_0 = -72 + 3(z-1), x_0 = z*1e6 + 500000, y_0 = 0,
# lat_0 = -90 (note the SOUTH-POLE origin: northings count from the pole)
for _z in range(1, 8):
    _EPSG[5342 + _z] = (
        f"+proj=tmerc +lat_0=-90 +lon_0={-72 + 3 * (_z - 1)} +k=1 "
        f"+x_0={_z}500000 +y_0=0 " + _GRS,
        (-73.6 + 3 * (_z - 1), -55.1, -70.5 + 3 * (_z - 1), -21.7),
    )

# Hartebeesthoek94 / Lo15..Lo33 (EPSG 2046..2055): south-orientated TM
# (EPSG method 9808) — westing/southing axes via +axis=wsu
for _z in range(10):
    _lo = 15 + 2 * _z
    _EPSG[2046 + _z] = (
        f"+proj=tmerc +lat_0=0 +lon_0={_lo} +k=1 +x_0=0 +y_0=0 "
        "+axis=wsu +ellps=WGS84",
        (_lo - 1.1, -34.9, _lo + 1.1, -22.1),
    )

# DHDN / 3-degree Gauss-Krueger zones 2..5 (Germany); zone 2 carries its
# published per-zone extent (west Germany only), the rest approximate
for _z in range(2, 6):
    _EPSG[31464 + _z] = (
        f"+proj=tmerc +lat_0=0 +lon_0={_z * 3} +k=1 "
        f"+x_0={_z}500000 +y_0=0 " + _DHDN,
        (
            (5.87, 49.10, 7.50, 53.75)
            if _z == 2
            else (_z * 3 - 1.65, 47.27, _z * 3 + 1.65, 55.09)
        ),
    )
# ETRS89 / Poland CS2000 zones 5..8 (srid 2176..2179, lon_0 = zone*3)
for _z in range(5, 9):
    _EPSG[2171 + _z] = (
        f"+proj=tmerc +lat_0=0 +lon_0={_z * 3} +k=0.999923 "
        f"+x_0={_z}500000 +y_0=0 " + _GRS,
        (
            (16.50, 49.33, 19.50, 54.83)
            if _z == 6
            else (_z * 3 - 1.5, 49.0, _z * 3 + 1.5, 54.9)
        ),
    )
# GDA94 / MGA zones 48..58 and GDA2020 / MGA zones 46..59 (Australia)
for _z in range(48, 59):
    _EPSG[28300 + _z] = (
        f"+proj=utm +zone={_z} +south " + _GRS,
        (_z * 6 - 186.0, -45.0, _z * 6 - 180.0, -8.0),
    )
for _z in range(46, 60):
    _EPSG[7800 + _z] = (
        f"+proj=utm +zone={_z} +south " + _GRS,
        (_z * 6 - 186.0, -45.0, _z * 6 - 180.0, -8.0),
    )
# SIRGAS 2000 / UTM zones 11N..22N (31965..31976) and 17S..25S (31977..31985)
for _z in range(11, 23):
    _EPSG[31954 + _z] = (
        f"+proj=utm +zone={_z} " + _GRS,
        (_z * 6 - 186.0, 0.0, _z * 6 - 180.0, 16.0),
    )
for _z in range(17, 26):
    _EPSG[31960 + _z] = (
        f"+proj=utm +zone={_z} +south " + _GRS,
        (_z * 6 - 186.0, -35.0, _z * 6 - 180.0, 5.0),
    )

# world cylindrical grids: equidistant (EPSG method 1028; 4087 ellipsoidal,
# 4088/32662 spherical twins) and NSIDC EASE-Grid 2.0 / original EASE (cea,
# standard parallel 30) — common raster/tile georeferencing codes
_EPSG[4087] = (
    "+proj=eqc +lat_ts=0 +lat_0=0 +lon_0=0 +x_0=0 +y_0=0 +ellps=WGS84",
    (-180.0, -90.0, 180.0, 90.0),
)
_EPSG[4088] = (
    "+proj=eqc +lat_ts=0 +lat_0=0 +lon_0=0 +x_0=0 +y_0=0 "
    "+a=6371007 +b=6371007",
    (-180.0, -90.0, 180.0, 90.0),
)
_EPSG[32662] = _EPSG[4087]  # deprecated "WGS 84 / Plate Carree" alias
_EPSG[6933] = (
    "+proj=cea +lat_ts=30 +lon_0=0 +x_0=0 +y_0=0 +ellps=WGS84",
    (-180.0, -86.0, 180.0, 86.0),
)
_EPSG[3410] = (
    "+proj=cea +lat_ts=30 +lon_0=0 +x_0=0 +y_0=0 +a=6371228 +b=6371228",
    (-180.0, -86.0, 180.0, 86.0),
)

# Pulkovo 1942 / Gauss-Krueger zones 2..32 (EPSG 28402..28432): 6-degree
# zones on Krassowsky 1940 with zone-prefixed false easting. Zones 31/32
# (Chukotka) sit past the antimeridian: their central meridian and area
# use wrapped (negative) longitudes so dl = lon - lon0 stays small.
for _z in range(2, 33):
    _wrap = 360.0 if _z * 6 - 3 > 180 else 0.0
    _EPSG[28400 + _z] = (
        f"+proj=tmerc +lat_0=0 +lon_0={_z * 6 - 3 - _wrap} +k=1 "
        f"+x_0={_z}500000 +y_0=0 "
        "+towgs84=23.92,-141.27,-80.9,0,0.35,0.82,-0.12 +ellps=krass",
        (_z * 6 - 6.0 - _wrap, 35.0, _z * 6.0 - _wrap, 81.0),
    )

# WGS 72 / UTM zones 1..60 N (32201..32260) and S (32301..32360)
for _z in range(1, 61):
    _EPSG[32200 + _z] = (
        f"+proj=utm +zone={_z} "
        "+towgs84=0,0,4.5,0,0,0.554,0.2263 +ellps=WGS72",
        (_z * 6 - 186.0, 0.0, _z * 6 - 180.0, 84.0),
    )
    _EPSG[32300 + _z] = (
        f"+proj=utm +zone={_z} +south "
        "+towgs84=0,0,4.5,0,0,0.554,0.2263 +ellps=WGS72",
        (_z * 6 - 186.0, -80.0, _z * 6 - 180.0, 0.0),
    )

# NAD27 / UTM zones 1..22 N (26701..26722), Clarke 1866
for _z in range(1, 23):
    _EPSG[26700 + _z] = (
        f"+proj=utm +zone={_z} +towgs84=-8,160,176 +ellps=clrk66",
        (_z * 6 - 186.0, 15.0, _z * 6 - 180.0, 84.0),
    )

# ED50 / UTM zones 28..38 (23028..23038), International 1924
for _z in range(28, 39):
    _EPSG[23000 + _z] = (
        f"+proj=utm +zone={_z} +towgs84=-87,-98,-121 +ellps=intl",
        (_z * 6 - 186.0, 25.0, _z * 6 - 180.0, 84.0),
    )

# AGD66 / AMG zones 48..58 (20248..20258) and AGD84 / AMG (20348..20358):
# the pre-GDA Australian Map Grid on the Australian National Spheroid
for _z in range(48, 59):
    _EPSG[20200 + _z] = (
        f"+proj=utm +zone={_z} +south +towgs84=-133,-48,148 +ellps=aust_SA",
        (_z * 6 - 186.0, -45.0, _z * 6 - 180.0, -8.0),
    )
    _EPSG[20300 + _z] = (
        f"+proj=utm +zone={_z} +south +towgs84=-134,-48,149 +ellps=aust_SA",
        (_z * 6 - 186.0, -45.0, _z * 6 - 180.0, -8.0),
    )

# SAD69 / UTM zones 18..22 N (29168..29172) and 17..25 S (29187..29195)
for _z in range(18, 23):
    _EPSG[29150 + _z] = (
        f"+proj=utm +zone={_z} +towgs84=-57,1,-41 +ellps=aust_SA",
        (_z * 6 - 186.0, 0.0, _z * 6 - 180.0, 13.0),
    )
for _z in range(17, 26):
    _EPSG[29170 + _z] = (
        f"+proj=utm +zone={_z} +south +towgs84=-57,1,-41 +ellps=aust_SA",
        (_z * 6 - 186.0, -35.0, _z * 6 - 180.0, 5.0),
    )

# Japan Plane Rectangular CS zones I..XIX: per-zone TM origins (published
# JGD survey law values), k = 0.9999. Three datum generations share the
# grid: Tokyo (30161+z), JGD2000 (2443+z), JGD2011 (6669+z).
_JPRCS = [
    (33.0, 129.5), (33.0, 131.0), (36.0, 132.0 + 1.0 / 6.0), (33.0, 133.5),
    (36.0, 134.0 + 1.0 / 3.0), (36.0, 136.0), (36.0, 137.0 + 1.0 / 6.0),
    (36.0, 138.5), (36.0, 139.0 + 5.0 / 6.0), (40.0, 140.0 + 5.0 / 6.0),
    (44.0, 140.25), (44.0, 142.25), (44.0, 144.25), (26.0, 142.0),
    (26.0, 127.5), (26.0, 124.0), (26.0, 131.0), (20.0, 136.0),
    (26.0, 154.0),
]
for _z, (_la, _lo) in enumerate(_JPRCS):
    _jp_area = (_lo - 2.0, max(_la - 4.0, 17.0), _lo + 2.0, min(_la + 4.0, 46.0))
    _tm = f"+proj=tmerc +lat_0={_la} +lon_0={_lo} +k=0.9999 +x_0=0 +y_0=0 "
    _EPSG[30161 + _z] = (
        _tm + "+towgs84=-146.414,507.337,680.507 +ellps=bessel", _jp_area
    )
    _EPSG[2443 + _z] = (_tm + _GRS, _jp_area)
    _EPSG[6669 + _z] = (_tm + _GRS, _jp_area)

# Irish grids: TM65/TM75 Irish Grid (Airy Modified) + IRENET95 ITM
_IRISH_GRID = (
    "+proj=tmerc +lat_0=53.5 +lon_0=-8 +k=1.000035 +x_0=200000 "
    "+y_0=250000 "
    "+towgs84=482.5,-130.6,564.6,-1.042,-0.214,-0.631,8.15 +ellps=mod_airy",
    (-10.93, 51.39, -5.34, 55.43),
)
_EPSG[29902] = _IRISH_GRID  # TM65 / Irish Grid
_EPSG[29903] = _IRISH_GRID  # TM75 / Irish Grid (same projection params)
_EPSG[29900] = _IRISH_GRID  # deprecated original code
_EPSG[2157] = (
    "+proj=tmerc +lat_0=53.5 +lon_0=-8 +k=0.99982 +x_0=600000 "
    "+y_0=750000 " + _GRS,
    (-10.93, 51.39, -5.34, 55.43),
)

# GGRS87 / Greek Grid (the +datum entry carries the published shift)
_EPSG[2100] = (
    "+proj=tmerc +lat_0=0 +lon_0=24 +k=0.9996 +x_0=500000 +y_0=0 "
    "+datum=GGRS87",
    (19.57, 34.88, 28.30, 41.75),
)

# world equal-area singles (ESRI codes, the ints the ecosystem uses):
# 54008 Sinusoidal, 54009 Mollweide, both on WGS84; and the MODIS
# sinusoidal sphere grid under its common SR-ORG id 6974
_EPSG[54008] = (
    "+proj=sinu +lon_0=0 +x_0=0 +y_0=0 +ellps=WGS84",
    (-180.0, -90.0, 180.0, 90.0),
)
_EPSG[54009] = (
    "+proj=moll +lon_0=0 +x_0=0 +y_0=0 +ellps=WGS84",
    (-180.0, -90.0, 180.0, 90.0),
)
_EPSG[6974] = (
    "+proj=sinu +lon_0=0 +x_0=0 +y_0=0 +a=6371007.181 +b=6371007.181",
    (-180.0, -90.0, 180.0, 90.0),
)

# the Ferro-referenced original S-JTSK code shares 5514's definition
_EPSG[2065] = _EPSG[5514]

_PARSED: dict[int, ProjCRS] = {}
_REGISTERED: dict[int, ProjCRS] = {}


def register_crs(
    srid: int, proj_string: str, area: tuple | None = None
) -> ProjCRS:
    """Register (or override) a CRS definition for ``srid`` at runtime.

    ``area`` is the geographic lon/lat area of use used for validity
    bounds; omitted, a family-default envelope applies.
    """
    crs = parse_proj(proj_string, area)
    _REGISTERED[int(srid)] = crs
    # invalidate any cached projected envelope for this code
    from .crs import _PROJ_BOUNDS_CACHE

    _PROJ_BOUNDS_CACHE.pop(int(srid), None)
    return crs


def lookup(srid: int) -> ProjCRS | None:
    """Resolve ``srid`` via the runtime registry, then the EPSG table."""
    crs = _REGISTERED.get(srid)
    if crs is not None:
        return crs
    if srid in _PARSED:
        return _PARSED[srid]
    ent = _EPSG.get(srid)
    if ent is None:
        return None
    crs = parse_proj(ent[0], ent[1])
    _PARSED[srid] = crs
    return crs
