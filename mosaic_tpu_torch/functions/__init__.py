"""Geometry functions of the port (``mosaic_tpu/functions``).

Only the pair programs the KNN slice runs are ported
(`geometry.py`): the row-pair distance and containment of two device
columns. The SQL-style function surface is ROADMAP queue 1 item 14.
"""
