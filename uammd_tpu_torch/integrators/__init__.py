"""Integrators: the step-function base and the BDHI integrators."""
