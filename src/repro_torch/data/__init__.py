"""Deterministic synthetic data streams of the port (numpy)."""
