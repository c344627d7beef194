"""Foundations: box, precision and flag structs, particle state, grid sizes."""
