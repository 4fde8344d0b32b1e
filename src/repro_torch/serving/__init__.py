"""Serving engine, executors, workloads, admission and metrics."""
