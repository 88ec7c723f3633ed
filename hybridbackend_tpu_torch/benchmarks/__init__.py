"""Benchmark harnesses of the port, run as modules (``python -m``)."""
