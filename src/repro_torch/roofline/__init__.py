"""Roofline of the port: kernel costs, profiler traces, dry-run terms."""
