"""Brownian dynamics with hydrodynamic interactions: FCM and its Euler-Maruyama integrators."""
