"""Measurement tools of the port: the epsilon-band calibration sweep."""
