"""Dissipative Particle Dynamics pair forces over a neighbour list.

Port of ``uammd_tpu/potentials/dpd.py`` (reference:
src/Interactor/Potential/DPD.cuh:41-192): conservative, dissipative and
random pair forces

    F_ij = [ A w(r) - gamma w(r)^2 (v_ij . rhat) + sigma w(r) xi_ij / sqrt(dt) ] rhat
    w(r) = 1 - r/rc,   sigma = sqrt(2 kT gamma)

with xi_ij a per-pair, per-step standard normal symmetric in (i, j) from
``core.rng.pair_normal`` (bit-equal to the JAX package's hash), so the
random force conserves momentum exactly. This is the general path's hash,
not the grid engine's (``engine/dpd.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng as prng
from ..core.box import Box
from ..core.types import ForceEnergyVirial
from ..neighbors.neighbor_list import NeighborList, maybe_rebuild
from ..neighbors.pair_map import apply_pairs


@dataclasses.dataclass(frozen=True)
class DPD:
    cutoff: float = 1.0
    A: float = 1.0  # conservative strength
    gamma: float = 4.0
    temperature: float = 1.0
    dt: float = 0.01

    @property
    def max_cutoff(self) -> float:
        return self.cutoff


def dpd_forces(params: DPD, pos: torch.Tensor, vel: torch.Tensor, nlist: NeighborList,
               step, *, box: Box | None = None) -> ForceEnergyVirial:
    """Sum the DPD pair forces over the neighbour list at step ``step``."""
    rc = params.cutoff
    sigma = (2.0 * params.temperature * params.gamma) ** 0.5
    inv_sqrt_dt = 1.0 / params.dt ** 0.5
    dtype = pos.dtype

    def kernel(r2, dr, info_i, info_j, idx):
        vi, ii = info_i
        vj, jj = info_j
        inside = (r2 < rc * rc) & (r2 > 1e-12)
        r2s = torch.where(inside, r2, torch.ones((), dtype=r2.dtype, device=r2.device))
        w = torch.where(inside, 1.0 - torch.sqrt(r2s) / rc, 0.0)  # [N, K]
        rhat = dr * torch.rsqrt(r2s)[..., None]
        vdotr = torch.sum((vj - vi) * rhat, dim=-1)
        xi = prng.pair_normal(ii, jj, step, dtype)
        fmod = params.A * w - params.gamma * w * w * vdotr + sigma * w * xi * inv_sqrt_dt
        # rhat points from i to j: the repulsive A pushes i along -rhat
        return {"force": -fmod[..., None] * rhat}

    ids = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    out = apply_pairs(kernel, nlist, pos, info=(vel, ids), box=box)
    return ForceEnergyVirial(force=out["force"])


def make_dpd_force_fn(params: DPD):
    """force_fn(state, nlist) for ``integrators.verlet.nve``: the reference
    runs DPD under VerletNVE (DPD.cuh header example)."""

    def force_fn(state, nbrs):
        nbrs = maybe_rebuild(nbrs, state.pos)
        step = state.step if state.step is not None else 0
        return dpd_forces(params, state.pos, state.get_vel(), nbrs, step), nbrs

    return force_fn
