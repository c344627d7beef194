"""Smoothed Particle Hydrodynamics forces over a neighbour list.

Port of ``uammd_tpu/interactors/sph.py`` (reference: src/Interactor/SPH.cuh:44,
SPH.cu:7-27, SPH/Kernel.cuh):

    rho_i = sum_j m_j W(r_ij; h)
    P_i   = K (rho_i - rho0)                  (gas-stiffness EOS, SPH.cu:92-100)
    F_i   = -sum_j m_i m_j (P_i/rho_i^2 + P_j/rho_j^2 + Pi_ij) grad_i W
    Pi_ij = -nu (v_ij . r_ij) / (r_ij^2 + eps)   (artificial viscosity)

with the M4 cubic spline of support 2h (Kernel.cuh:18-45): two
``apply_pairs`` sweeps, as the reference's two transverser passes. The grid
engine ``engine/sph.py`` runs the same two sweeps as kernel #2's functors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.box import Box
from ..core.types import ForceEnergyVirial
from ..neighbors.neighbor_list import NeighborList, maybe_rebuild
from ..neighbors.pair_map import apply_pairs


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


def sph_density(params: SPHParams, pos, mass, nlist: NeighborList, box=None):
    """rho_i = m_i W(0) + sum_j m_j W(r_ij) over the list."""
    h = params.support

    def kernel(r2, dr, mi, mj, idx):
        return {"rho": torch.where(r2 < (2.0 * h) ** 2, mj * cubic_spline_w(r2, h), 0.0)}

    out = apply_pairs(kernel, nlist, pos, info=mass, box=box)
    return out["rho"] + mass * cubic_spline_w(torch.zeros_like(mass), h)


def sph_forces(params: SPHParams, pos, vel, mass, nlist: NeighborList, *,
               box: Box | None = None) -> ForceEnergyVirial:
    h = params.support
    rho = sph_density(params, pos, mass, nlist, box=box)
    pressure = params.gas_stiffness * (rho - params.rest_density)
    p_div_rho2 = pressure / (rho * rho)

    def kernel(r2, dr, info_i, info_j, idx):
        pi_, vi, mi = info_i
        pj_, vj, mj = info_j
        inside = (r2 < (2.0 * h) ** 2) & (r2 > 1e-12)
        visc = -params.viscosity * torch.sum((vi - vj) * (-dr), dim=-1) / (r2 + 1e-3)
        # grad_i W(r_i - r_j) = gw (r_i - r_j) = gw (-dr)
        gw = cubic_spline_gradw_over_r(r2, h)
        fmod = torch.where(inside, -mi * mj * (pi_ + pj_ + visc) * gw, 0.0)
        return {"force": fmod[..., None] * (-dr)}

    out = apply_pairs(kernel, nlist, pos, info=(p_div_rho2, vel, mass), box=box)
    return ForceEnergyVirial(force=out["force"])


def make_sph_force_fn(params: SPHParams):
    """force_fn(state, nlist) for VerletNVE (the reference runs SPH under
    VerletNVE, docs/SPH.rst); the list is rebuilt on drift."""

    def force_fn(state, nbrs):
        nbrs = maybe_rebuild(nbrs, state.pos)
        return sph_forces(params, state.pos, state.get_vel(), state.get_mass(), nbrs), nbrs

    return force_fn
