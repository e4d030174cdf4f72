"""Tuning knobs of the port: the precedence resolver (`resolve.py`).
Tuning profiles and the rest of ``mosaic_tpu/tune`` come with ROADMAP
queue 1 item 13."""
