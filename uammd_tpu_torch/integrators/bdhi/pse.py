"""Radial functions of the Positively-Split Ewald RPY mobility (host numpy).

Port of ``_blob_fg`` and ``_rpy_fg`` from
``uammd_tpu/integrators/bdhi/pse.py:45-91`` (reference:
src/Integrator/BDHI/PSE/BDHI_PSE.cuh, NearField.cuh, FarField.cuh:82-115).
A pair mobility is M(r) = f(r) I + g(r) r^ r^. ``PSEGrid.create`` fits the
near-field remainder f_RPY - f_blob, g_RPY - g_blob with polynomials; the
list-based ``PSE`` backend (neighbour lists) comes with the general path.
"""

from __future__ import annotations

import math

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _blob_fg(r, sigma_c, eta, kmax_factor=12.0, nk=8192, a=None):
    """Open-space blob pair mobility radial functions f(r), g(r), by 1D
    Bessel quadratures of the transverse projector transform

      f(r) = (1/(2 pi^2 eta)) Int phi(k) [j0(kr) - j1(kr)/(kr)] dk
      g(r) = -(1/(2 pi^2 eta)) Int phi(k) [j0(kr) - 3 j1(kr)/(kr)] dk

    ``a=None``: the point Gaussian envelope phi(k) = exp(-Sigma^2 k^2 / 2).
    ``a`` set: the full PSE wave-space envelope
    phi(k) = sinc^2(ka) (1 + Sigma^2 k^2 / 2) exp(-Sigma^2 k^2 / 2), the RPY
    surface-sphere factor times the Hasimoto splitting polynomial."""
    r = np.atleast_1d(np.asarray(r, np.float64))
    kmax = kmax_factor / sigma_c
    k = np.linspace(1e-8, kmax, nk)
    phi = np.exp(-0.5 * (sigma_c * k) ** 2)
    if a is not None:
        phi = phi * np.square(np.sinc(k * a / math.pi))
        phi = phi * (1.0 + 0.5 * (sigma_c * k) ** 2)
    x = np.outer(r, k)  # [R, K]
    with np.errstate(invalid="ignore", divide="ignore"):
        j0 = np.where(x > 1e-8, np.sin(x) / x, 1.0 - x * x / 6.0)
        j1_over_x = np.where(
            x > 1e-4,
            (np.sin(x) / x**2 - np.cos(x) / x) / x,
            1.0 / 3.0 - x * x / 30.0,
        )
    pref = 1.0 / (2.0 * math.pi**2 * eta)
    f = pref * _trapezoid(phi * (j0 - j1_over_x), k, axis=1)
    g = -pref * _trapezoid(phi * (j0 - 3.0 * j1_over_x), k, axis=1)
    return f, g


def _rpy_fg(r, a, eta):
    """RPY radial functions (reference: BDHI.cuh:13-70)."""
    r = np.atleast_1d(np.asarray(r, np.float64))
    m0 = 1.0 / (6.0 * math.pi * eta * a)
    rs = np.maximum(r, 1e-14)
    far_f = m0 * (3.0 * a / (4.0 * rs)) * (1.0 + 2.0 * a**2 / (3.0 * rs**2))
    far_g = m0 * (3.0 * a / (4.0 * rs)) * (1.0 - 2.0 * a**2 / rs**2)
    near_f = m0 * (1.0 - 9.0 * r / (32.0 * a))
    near_g = m0 * (3.0 / (32.0 * a)) * r
    f = np.where(r >= 2 * a, far_f, near_f)
    g = np.where(r >= 2 * a, far_g, near_g)
    return f, g
