"""Operator-facing output of the port: the reference's stderr formats
(display.py) and JSON-lines metrics (metrics.py)."""
