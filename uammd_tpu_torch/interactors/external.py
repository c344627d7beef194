"""External (single-particle) potentials.

Port of ``uammd_tpu/interactors/external.py`` (reference:
src/Interactor/ExternalForces.cuh:84): a per-particle energy or force
function of the state; with only an energy, the force is its negative
gradient through ``torch.autograd.grad``.
"""

from __future__ import annotations

import torch

from ..core.state import SimState
from ..core.types import Computables, ForceEnergyVirial


def external_forces(state: SimState, energy_fn=None, force_fn=None,
                    computables: Computables = Computables()) -> ForceEnergyVirial:
    """``energy_fn(pos, state) -> [N]``; force = -grad if no force_fn."""
    assert energy_fn is not None or force_fn is not None
    force = energy = None
    if computables.force:
        if force_fn is not None:
            force = force_fn(state.pos, state)
        else:
            with torch.enable_grad():
                p = state.pos.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(torch.sum(energy_fn(p, state)), p)
            force = -g
    if computables.energy and energy_fn is not None:
        energy = energy_fn(state.pos, state)
    return ForceEnergyVirial(force=force, energy=energy)


def gravity(g=(0.0, 0.0, -1.0)):
    """Constant force field (the reference's canonical ExternalForces
    example, ExternalForces.cuh:20-40). Returns (energy_fn, force_fn)."""

    made = {}

    def g_of(pos):
        # made once per dtype and device: a copy to the card per step would
        # wait for it
        key = (pos.dtype, pos.device)
        if key not in made:
            made[key] = torch.tensor(g, dtype=pos.dtype, device=pos.device)
        return made[key]

    def force_fn(pos, state):
        return state.get_mass()[:, None] * g_of(pos)

    def energy_fn(pos, state):
        return -state.get_mass() * (pos @ g_of(pos))

    return energy_fn, force_fn


def harmonic_trap(k=1.0, center=(0.0, 0.0, 0.0)):
    def energy_fn(pos, state):
        d = pos - torch.tensor(center, dtype=pos.dtype, device=pos.device)
        return 0.5 * k * torch.sum(d * d, dim=-1)

    return energy_fn, None


def wall_lj93(z0=0.0, epsilon=1.0, sigma=1.0, side=+1):
    """9-3 LJ wall at z = z0 (standard confinement external potential)."""

    def energy_fn(pos, state):
        d = torch.clamp(side * (pos[:, 2] - z0), min=1e-3)
        s3 = (sigma / d) ** 3
        return epsilon * ((2.0 / 15.0) * s3**3 - s3)

    return energy_fn, None
