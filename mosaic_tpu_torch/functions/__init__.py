"""Geometry functions of the port (``mosaic_tpu/functions``).

Only the pair programs the KNN slice runs are ported (`geometry.py`):
the row-pair distance and containment of two device columns, with the
two fused overlay frontends (`st_intersection_area`,
`st_overlap_fraction`, ``mesh=`` passed through), and the input coercion `_coerce.py to_packed` that the
resolution analyzer reads (a PackedGeometry only: the WKT, WKB and
GeoJSON readers come later). The SQL-style function surface is ROADMAP
queue 1 item 14.
"""
