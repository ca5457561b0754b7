"""Parallel attention of the port (dense reference only, so far)."""
