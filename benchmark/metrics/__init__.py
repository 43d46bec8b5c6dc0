"""Per-layer metric readers: ``<metric>.py`` has ``read(run)``, which
returns the metric's value, or None where the run has nothing to read."""
