"""Readers of the per-layer metrics, one module a metric, found by name:
each has ``UNIT`` and ``read(run)``, which returns the metric's value or
None when the run holds nothing to read it from."""
