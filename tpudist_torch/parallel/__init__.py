"""Parallelism helpers of the port (single-device attention so far)."""
