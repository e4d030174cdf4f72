"""Map visualization: Kepler.gl when available, self-contained HTML fallback.

Port of ``mosaic_tpu/viz.py``: host code over the port's
``functions.grid.grid_boundary``, ``core.geometry.geojson`` and
``context.index_system_factory``. The same inputs give the same
FeatureCollection dict and the same HTML text as the reference (the page
keeps the reference's title). Reference analog: the `%%mosaic_kepler`
IPython magic (`python/mosaic/utils/kepler_magic.py:18-70`) which renders
H3/BNG cells and chip tables on Kepler maps, with its canned config
(`python/mosaic/utils/kepler_config.py`). keplergl and IPython are
optional: the same entry points render to (a) a keplergl map when the
package is importable, (b) otherwise a dependency-free HTML file that draws
the GeoJSON on a canvas — enough to eyeball tessellations and joins.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = [
    "to_feature_collection",
    "plot_cells",
    "plot_geometries",
    "mosaic_kepler",
    "register_kepler_magic",
]


def to_feature_collection(geom, properties: "dict | None" = None) -> dict:
    """Geometry column (+ parallel property columns) -> GeoJSON FC dict."""
    from .core.geometry.geojson import to_geojson_obj
    from .functions._coerce import to_packed

    col = to_packed(geom)
    objs = to_geojson_obj(col)
    feats = []
    for i, g in enumerate(objs):
        props = {}
        for k, v in (properties or {}).items():
            val = v[i]
            props[k] = val.item() if hasattr(val, "item") else val
        feats.append({"type": "Feature", "geometry": g, "properties": props})
    return {"type": "FeatureCollection", "features": feats}


def plot_cells(cells, index=None, values=None, path: "str | None" = None):
    """Render grid cells (optionally choropleth by ``values``).

    The reference magic's `mosaic_kepler cells cell_id h3` path."""
    from .functions.grid import grid_boundary

    col = grid_boundary(np.asarray(cells), fmt="packed", index=index)
    props = {"cell": [str(c) for c in np.asarray(cells)]}
    if values is not None:
        props["value"] = list(np.asarray(values))
    return plot_geometries(col, properties=props, path=path)


def plot_geometries(geom, properties=None, path: "str | None" = None):
    """Render a geometry column; returns the kepler map object or the HTML
    file path of the fallback renderer."""
    fc = to_feature_collection(geom, properties)
    try:
        import keplergl  # noqa: F401 — optional

        m = keplergl.KeplerGl(data={"mosaic": fc}, config=_KEPLER_CONFIG)
        if path:
            m.save_to_html(file_name=path)
        return m
    except ImportError:
        out = Path(path or "mosaic_map.html")
        out.write_text(_fallback_html(fc))
        return str(out)


def mosaic_kepler(geom_or_cells, kind: str = "geometry", **kw):
    """Loose analog of the `%%mosaic_kepler` magic's dispatch."""
    if kind in ("h3", "bng", "cell", "cells"):
        return plot_cells(geom_or_cells, **kw)
    return plot_geometries(geom_or_cells, **kw)


def _magic_render(user_ns: dict, line: str, cell: str = ""):
    """Shared implementation of the ``%%mosaic_kepler`` cell magic.

    Grammar mirrors the reference magic's
    ``<dataset> <column> <h3|bng|geometry> [<limit>]``
    (`python/mosaic/utils/kepler_magic.py:18-70`): ``dataset`` names a
    variable in the notebook namespace (a reader ``VectorTable``, a dict
    of columns, or the column itself), ``column`` picks the cell-id or
    geometry column, ``h3``/``bng`` render cell boundaries while
    ``geometry`` renders the geometries directly."""
    args = (line.strip() + " " + (cell or "").strip()).split()
    if len(args) < 3:
        raise ValueError(
            "usage: %%mosaic_kepler <dataset> <column> <h3|bng|geometry>"
            " [<limit>]"
        )
    name, colname, kind = args[0], args[1], args[2].lower()
    if kind in ("cell", "cells"):
        kind = "h3"
    if kind not in ("h3", "bng", "geometry"):
        raise ValueError(
            f"feature type must be h3, bng or geometry, got {args[2]!r}"
        )
    limit = int(args[3]) if len(args) > 3 else None
    if name not in user_ns:
        raise ValueError(f"no variable {name!r} in the notebook namespace")
    obj = user_ns[name]
    if hasattr(obj, "columns") and hasattr(obj, "geometry"):  # VectorTable
        col = obj.geometry if colname == "geometry" else obj.columns[colname]
    elif isinstance(obj, dict):
        col = obj[colname]
    else:
        col = obj  # the dataset IS the column
    if limit is not None:
        col = col.take(list(range(min(limit, len(col))))) if hasattr(
            col, "take"
        ) and hasattr(col, "geometry_type") else col[:limit]
    if kind in ("h3", "bng"):
        from .context import index_system_factory

        return plot_cells(col, index=index_system_factory(kind.upper()))
    return plot_geometries(col)


def register_kepler_magic(ipython=None):
    """Register ``%%mosaic_kepler`` with IPython (the reference wires this
    in ``enable_mosaic`` — `python/mosaic/api/enable.py:13-68`). Returns
    the magic function, or None outside IPython."""
    try:
        from IPython.core.getipython import get_ipython
    except ImportError:  # plain-python process: the magic has no host
        return None
    ip = ipython or get_ipython()
    if ip is None:
        return None

    def magic(line, cell=""):
        return _magic_render(ip.user_ns, line, cell)

    magic.__name__ = "mosaic_kepler"
    ip.register_magic_function(magic, magic_kind="cell",
                               magic_name="mosaic_kepler")
    return magic


_KEPLER_CONFIG = {
    "version": "v1",
    "config": {
        "mapState": {"latitude": 0, "longitude": 0, "zoom": 8},
        "mapStyle": {"styleType": "dark"},
    },
}


def _fallback_html(fc: dict) -> str:
    """Self-contained canvas renderer (no network, no deps)."""
    data = json.dumps(fc)
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mosaic_tpu map</title>
<style>body{{margin:0;background:#111;color:#eee;font:12px sans-serif}}
#c{{display:block}}</style></head>
<body><canvas id="c"></canvas><div id="info" style="position:fixed;top:4px;left:6px"></div>
<script>
const fc = {data};
const cv = document.getElementById('c');
const W = cv.width = window.innerWidth, H = cv.height = window.innerHeight;
const ctx = cv.getContext('2d');
let xs=[], ys=[];
function walk(c, f) {{
  if (typeof c[0] === 'number') f(c);
  else c.forEach(x => walk(x, f));
}}
fc.features.forEach(ft => walk(ft.geometry.coordinates, p => {{xs.push(p[0]); ys.push(p[1]);}}));
const x0=Math.min(...xs), x1=Math.max(...xs), y0=Math.min(...ys), y1=Math.max(...ys);
const s = 0.92*Math.min(W/(x1-x0||1), H/(y1-y0||1));
const tx = x => (x-x0)*s + 0.04*W, ty = y => H - ((y-y0)*s + 0.04*H);
const colors = ['#4cc9f0','#f72585','#b5e48c','#ffd166','#9b5de5','#00f5d4'];
fc.features.forEach((ft, i) => {{
  ctx.strokeStyle = colors[i % colors.length]; ctx.fillStyle = ctx.strokeStyle + '33';
  const g = ft.geometry;
  function ring(r) {{
    ctx.beginPath();
    r.forEach((p, j) => j ? ctx.lineTo(tx(p[0]), ty(p[1])) : ctx.moveTo(tx(p[0]), ty(p[1])));
    ctx.closePath(); ctx.fill(); ctx.stroke();
  }}
  if (g.type === 'Polygon') g.coordinates.forEach(ring);
  else if (g.type === 'MultiPolygon') g.coordinates.forEach(p => p.forEach(ring));
  else if (g.type === 'LineString') {{ ctx.beginPath(); g.coordinates.forEach((p,j)=> j?ctx.lineTo(tx(p[0]),ty(p[1])):ctx.moveTo(tx(p[0]),ty(p[1]))); ctx.stroke(); }}
  else if (g.type === 'Point') {{ ctx.beginPath(); ctx.arc(tx(g.coordinates[0]), ty(g.coordinates[1]), 2.5, 0, 7); ctx.fill(); }}
}});
document.getElementById('info').textContent = fc.features.length + ' features';
</script></body></html>"""
