"""PairForces: radial potential -> per-particle force, energy, virial, stress.

Port of ``uammd_tpu/interactors/pair.py`` (reference:
src/Interactor/PairForces.cuh:23, PairForces.cu:43-78): a pair kernel built
from a radial potential, run over a neighbour list, or over all pairs (the
NBody path, PairForces.cu:50-53) when no list is given.
"""

from __future__ import annotations

import torch

from ..core.box import Box
from ..core.types import Computables, ForceEnergyVirial
from ..neighbors.neighbor_list import NeighborList
from ..neighbors.pair_map import apply_pairs, apply_pairs_dense


def make_pair_kernel(potential, computables: Computables):
    """pair_kernel(r2, dr, info_i, info_j, idx) -> dict of contributions;
    info is the per-particle type id, or None for one species."""

    def kernel(r2, dr, info_i, info_j, idx):
        ti = info_i if info_i is not None else 0
        tj = info_j if info_j is not None else 0
        rc2 = potential.cutoff2(ti, tj)
        inside = (r2 < rc2) & (r2 > 0)
        r2safe = torch.where(inside, r2, torch.ones((), dtype=r2.dtype, device=r2.device))
        out = {}
        if computables.force or computables.virial or computables.stress:
            g = torch.where(inside, potential.force_div_r(r2safe, ti, tj), 0)
            if computables.force:
                out["force"] = g[..., None] * dr
            if computables.virial:
                out["virial"] = -0.5 * g * r2
            if computables.stress:
                # packed symmetric stress (xx, xy, xz, yy, yz, zz); trace =
                # virial (reference: Interactor.cuh:98)
                hg = -0.5 * g
                out["stress"] = torch.stack(
                    [hg * dr[..., a] * dr[..., b]
                     for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))], dim=-1)
        if computables.energy:
            out["energy"] = 0.5 * torch.where(inside, potential.energy(r2safe, ti, tj), 0)
        return out

    return kernel


def pair_forces(potential, pos: torch.Tensor, nlist: NeighborList | None = None, *,
                box: Box | None = None, type_id: torch.Tensor | None = None,
                computables: Computables = Computables()) -> ForceEnergyVirial:
    """Sum the potential over pairs: the Verlet-list path with ``nlist``,
    else the dense O(N^2) path over ``box`` (reference: PairForces.cu:50-53)."""
    kernel = make_pair_kernel(potential, computables)
    if nlist is not None:
        out = apply_pairs(kernel, nlist, pos, info=type_id, box=box)
    else:
        if box is None:
            raise ValueError("the dense path needs a box")
        out = apply_pairs_dense(kernel, pos, box, info=type_id)
    return ForceEnergyVirial(force=out.get("force"), energy=out.get("energy"),
                             virial=out.get("virial"), stress=out.get("stress"))
