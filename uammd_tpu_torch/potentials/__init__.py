"""Pair potentials: radial potentials and DPD."""
