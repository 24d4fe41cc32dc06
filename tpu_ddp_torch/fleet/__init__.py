"""Serving fleet pieces of the port: the prefix index (fleet/prefix.py)."""
