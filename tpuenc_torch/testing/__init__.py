"""Test inputs shared by the port's tests and ``chip_smoke.py``."""
