"""Metric readers, one file a metric (``<metric>.py``), named as in
``BENCHMARK.json``."""
