"""Mesh construction for launches of the port (tests and the distributed solve)."""
