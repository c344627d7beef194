"""Interactors: force functions of the particle state."""
