"""Deterministic synthetic training data (src/repro/data/)."""
