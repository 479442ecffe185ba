"""Atomic, asynchronous training checkpoints (src/repro/checkpoint/)."""
