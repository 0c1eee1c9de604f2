"""Benchmark CLIs of the port and their shared runner."""
