"""Electrostatics: the triply periodic spectral Poisson solver."""
