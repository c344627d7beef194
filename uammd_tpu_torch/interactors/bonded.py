"""Bonded interactions: 2-, 3- and 4-particle bonds and fixed-point bonds.

Port of ``uammd_tpu/interactors/bonded.py`` (reference:
src/Interactor/BondedForces.cuh:177, AngularBondedForces.cuh:148,
TorsionalBondedForces.cuh:245). A bond type is a vectorised energy

    energy_fn(r, params, box) -> [M] per-bond energies,  r: [M, p, 3]

and the force is minus the gradient of the summed energy through the
gather, by ``torch.autograd`` on a detached copy of the positions (the
state's tensors never require grad). Energies and virials per bond are
split evenly among the bond's members. Fixed-point bonds are p = 1 bonds
whose anchor is a parameter.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.box import Box
from ..core.types import Computables, ForceEnergyVirial
from ..device import resolve_device


@dataclasses.dataclass
class Bonds:
    """idx: [M, p] particle indices; params: dict of [M]-leading tensors."""

    idx: torch.Tensor
    params: dict

    @property
    def particles_per_bond(self) -> int:
        return self.idx.shape[1]


def bonds(idx, *, device=None, **params) -> Bonds:
    """Bonds on ``device`` (default the GPU); parameters keep their numpy
    dtype (Python floats become float64)."""
    dev = resolve_device(device)
    idx = torch.as_tensor(np.asarray(idx), device=dev).to(torch.int32)
    if idx.ndim == 1:
        idx = idx[:, None]

    def as_t(v):
        return v.to(dev) if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v),
                                                                             device=dev)

    return Bonds(idx=idx, params={k: as_t(v) for k, v in params.items()})


def _split(values: torch.Tensor, idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Each bond's value split evenly among its p members, summed per
    particle."""
    p = idx.shape[1]
    out = torch.zeros(n, dtype=dtype, device=values.device)
    return out.index_add_(0, idx.reshape(-1), torch.repeat_interleave(values / p, p).to(dtype))


def bonded_forces(energy_fn, b: Bonds, pos: torch.Tensor, box: Box | None = None,
                  computables: Computables = Computables()) -> ForceEnergyVirial:
    """Sum a bond energy over all bonds; forces by reverse-mode autodiff.

    ``energy_fn(r, params, box)`` gets the members' positions [M, p, 3] and
    must be translation invariant (``box.wrap`` the differences)."""
    n = pos.shape[0]
    idx = b.idx.long()
    force = energy = virial = None
    if computables.force or computables.virial:
        with torch.enable_grad():
            x = pos.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(energy_fn(x[idx], b.params, box).sum(), x)
        force = -grad
    if computables.energy:
        with torch.no_grad():
            e_b = energy_fn(pos[idx], b.params, box)
        energy = _split(e_b, idx, n, pos.dtype)
    if computables.virial:
        # a bond's virial: sum_m F_m . (r_m - r_com), split evenly
        with torch.enable_grad():
            r = pos.detach()[idx].requires_grad_(True)
            (grad,) = torch.autograd.grad(energy_fn(r, b.params, box).sum(), r)
        r = r.detach()
        r_rel = r - torch.mean(r, dim=1, keepdim=True)
        if box is not None:
            r_rel = box.wrap(r_rel)
        virial = _split(torch.sum(-grad * r_rel, dim=(1, 2)), idx, n, pos.dtype)
    return ForceEnergyVirial(force=force, energy=energy, virial=virial)


# ---------------------------------------------------------------- bond types
def _wrap(dr, box):
    return box.wrap(dr) if box is not None else dr


def harmonic(r, params, box=None):
    """U = 0.5 k (|r| - r0)^2 (reference: BondedForces.cuh:68 harmonicBond)."""
    dr = _wrap(r[:, 1] - r[:, 0], box)
    d = torch.sqrt(torch.sum(dr * dr, dim=-1) + 1e-32)
    return 0.5 * params["k"] * (d - params["r0"]) ** 2


def fene(r, params, box=None):
    """U = -0.5 k r0^2 log(1 - r^2/r0^2) (reference: BondedForces.cuh:133),
    the standard FENE form (factor 0.5)."""
    dr = _wrap(r[:, 1] - r[:, 0], box)
    r2 = torch.sum(dr * dr, dim=-1)
    r02 = params["r0"] ** 2
    x = torch.clamp(r2 / r02, 0.0, 1.0 - 1e-6)
    return -0.5 * params["k"] * r02 * torch.log1p(-x)


def harmonic_fixed_point(r, params, box=None):
    """p = 1 bond to a fixed anchor (reference: fixed-point BondedForces)."""
    dr = _wrap(r[:, 0] - params["point"], box)
    d = torch.sqrt(torch.sum(dr * dr, dim=-1) + 1e-32)
    return 0.5 * params["k"] * (d - params["r0"]) ** 2


def angular(r, params, box=None):
    """U = 2 k (sin(theta/2) - sin(theta0/2))^2 over the i-j-k angle
    (reference: AngularBondedForces.cuh:109-114)."""
    rij = _wrap(r[:, 0] - r[:, 1], box)
    rkj = _wrap(r[:, 2] - r[:, 1], box)
    c = torch.sum(rij * rkj, dim=-1) / torch.sqrt(
        torch.sum(rij * rij, dim=-1) * torch.sum(rkj * rkj, dim=-1) + 1e-32)
    theta = torch.arccos(torch.clamp(c, -1.0 + 1e-7, 1.0 - 1e-7))
    return 2.0 * params["k"] * (torch.sin(0.5 * theta) - torch.sin(0.5 * params["theta0"])) ** 2


def _dihedral_angle(r, box):
    r12 = _wrap(r[:, 1] - r[:, 0], box)
    r23 = _wrap(r[:, 2] - r[:, 1], box)
    r34 = _wrap(r[:, 3] - r[:, 2], box)
    n1 = torch.linalg.cross(r12, r23, dim=-1)
    n2 = torch.linalg.cross(r23, r34, dim=-1)
    m1 = torch.linalg.cross(n1, r23 / torch.linalg.norm(r23, dim=-1, keepdim=True), dim=-1)
    x = torch.sum(n1 * n2, dim=-1)
    y = torch.sum(m1 * n2, dim=-1)
    return torch.atan2(y, x)


def torsional_harmonic(r, params, box=None):
    """U = 0.5 k (phi - phi0)^2 (reference: TorsionalBondedForces.cuh:60-102)."""
    dphi = _dihedral_angle(r, box) - params["phi0"]
    dphi = dphi - 2.0 * math.pi * torch.round(dphi / (2.0 * math.pi))
    return 0.5 * params["k"] * dphi ** 2


def torsional_fourier(r, params, box=None):
    """LAMMPS-style U = k (1 + cos(phi - phi0)) (reference:
    TorsionalBondedForces.cuh:131-184 FourierLAMMPS)."""
    return params["k"] * (1.0 + torch.cos(_dihedral_angle(r, box) - params["phi0"]))
