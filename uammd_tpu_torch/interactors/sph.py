"""Smoothed Particle Hydrodynamics: the cubic-spline kernel and parameters.

Port of part of ``uammd_tpu/interactors/sph.py`` (:29-59; reference:
src/Interactor/SPH/Kernel.cuh:18-45): the M4 cubic spline of support 2h,
its (1/r) dW/dr, and ``SPHParams``. The grid engine ``engine/sph.py`` uses
them; the neighbour-list interactor of that module is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def cubic_spline_w(r2, h):
    """M4 cubic spline, support 2h, 3D norm 1/(4 pi h^3) (Kernel.cuh:18-29)."""
    r = torch.sqrt(r2 + 1e-32)
    q = r / h
    twomq = torch.clamp(2.0 - q, min=0.0)
    onemq = torch.clamp(1.0 - q, min=0.0)
    w = twomq ** 3 - 4.0 * onemq ** 3
    return w / (4.0 * math.pi * h ** 3)


def cubic_spline_gradw_over_r(r2, h):
    """(1/r) dW/dr, so grad W = value * r_vec (Kernel.cuh:33-45)."""
    r = torch.sqrt(r2 + 1e-32)
    q = r / h
    twomq = torch.clamp(2.0 - q, min=0.0)
    onemq = torch.clamp(1.0 - q, min=0.0)
    dwdq = -3.0 * twomq ** 2 + 12.0 * onemq ** 2
    return dwdq / (4.0 * math.pi * h ** 4 * torch.clamp(r, min=1e-10))


@dataclasses.dataclass(frozen=True)
class SPHParams:
    support: float = 1.0  # h; kernel support radius = 2h
    viscosity: float = 50.0  # nu (artificial)
    gas_stiffness: float = 60.0  # K
    rest_density: float = 0.3  # rho0

    @property
    def max_cutoff(self) -> float:
        return 2.0 * self.support
