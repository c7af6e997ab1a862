"""Measurement tools of the port that are not part of chip_smoke.py."""
