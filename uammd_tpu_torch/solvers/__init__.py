"""Solvers: immersed-boundary spread and interpolation (direct and pencil paths)."""
