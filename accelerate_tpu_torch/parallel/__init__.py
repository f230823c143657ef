"""Parallel building blocks of the port (the single-device parts so far)."""
