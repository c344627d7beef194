"""Deserno coarse-grained lipid membrane model.

Port of ``uammd_tpu/interactors/deserno.py`` (reference:
src/misc/Deserno.cuh:1-35, Deserno.cu: Cooke-Kremer-Deserno 3-bead
lipids), a composite interactor of

- WCA repulsion between all beads (heads sigma_h = 0.95 sigma_t);
- a broad cos^2 tail-tail attraction of range w_c, flat at -epsilon
  inside the WCA cutoff;
- FENE bonds along each lipid and a harmonic straightening bond between
  its beads 1 and 3 (``bonded.py``).

``deserno_forces`` sums them over a neighbour list; ``build_bilayer`` makes
a flat bilayer (host numpy, the JAX package's sites and bonds).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.box import Box
from ..core.types import Computables, ForceEnergyVirial
from ..neighbors.neighbor_list import NeighborList
from ..neighbors.pair_map import apply_pairs
from .bonded import Bonds, bonded_forces, bonds, fene, harmonic


@dataclasses.dataclass(frozen=True)
class DesernoParams:
    sigma: float = 1.0  # tail bead diameter
    epsilon: float = 1.0
    w_c: float = 1.6  # attraction range in sigma (~1.6: a fluid bilayer)

    @property
    def sigma_head(self) -> float:
        return 0.95 * self.sigma

    @property
    def max_cutoff(self) -> float:
        return 2 ** (1 / 6) * self.sigma + self.w_c * self.sigma


def _wca(r2, sig, eps):
    """((dE/dr)/r, E) of the WCA repulsion; ``sig`` a tensor or a float."""
    rc2 = (2 ** (1 / 6) * sig) ** 2
    inside = (r2 < rc2) & (r2 > 1e-12)
    r2s = torch.where(inside, r2, 1.0)
    inv6 = (sig * sig / r2s) ** 3
    g = torch.where(inside, -(24.0 * eps / r2s) * (2 * inv6 * inv6 - inv6), 0.0)
    e = torch.where(inside, 4 * eps * (inv6 * inv6 - inv6) + eps, 0.0)
    return g, e


def _tail_attraction(r2, sig, eps, wc):
    """((dE/dr)/r, E) of the cos^2 well from rc to rc + wc; E = -eps on the
    plateau r < rc (Deserno's tail-tail), where the force is 0."""
    rc = 2 ** (1 / 6) * sig
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    x = (r - rc) * (math.pi / (2 * wc))
    inside = (r >= rc) & (r < rc + wc)
    e = torch.where(inside, -eps * torch.cos(x) ** 2, 0.0)
    e = torch.where(r < rc, -eps, e)
    dedr = torch.where(inside, eps * (math.pi / wc) * torch.cos(x) * torch.sin(x), 0.0)
    return dedr / torch.clamp(r, min=1e-10), e


def deserno_pair_kernel(params: DesernoParams, computables: Computables):
    """The pair kernel over bead types 0 (head) and 1 (tail)."""
    sig, eps, wc = params.sigma, params.epsilon, params.w_c * params.sigma

    def kernel(r2, dr, ti, tj, idx):
        both_tail = (ti == 1) & (tj == 1)
        # the pair's sigma in r2's dtype, as JAX's weakly typed where gives
        # it (0-d fills: a copy from the host would wait for the device)
        sig_pair = torch.where(
            both_tail, r2.new_full((), sig),
            torch.where((ti == 0) & (tj == 0), r2.new_full((), params.sigma_head),
                        r2.new_full((), 0.5 * (sig + params.sigma_head))))
        g_rep, e_rep = _wca(r2, sig_pair, eps)
        g_att, e_att = _tail_attraction(r2, sig, eps, wc)
        out = {}
        if computables.force:
            out["force"] = (g_rep + torch.where(both_tail, g_att, 0.0))[..., None] * dr
        if computables.energy:
            out["energy"] = 0.5 * (e_rep + torch.where(both_tail, e_att, 0.0))
        return out

    return kernel


def deserno_forces(pos, type_id, lipid_bonds: Bonds, straight_bonds: Bonds,
                   params: DesernoParams, nlist: NeighborList, box: Box | None = None,
                   computables: Computables = Computables()) -> ForceEnergyVirial:
    out = apply_pairs(deserno_pair_kernel(params, computables), nlist, pos, info=type_id,
                      box=box)
    fev = ForceEnergyVirial(force=out.get("force"), energy=out.get("energy"))
    fev = fev + bonded_forces(fene, lipid_bonds, pos, box, computables)
    return fev + bonded_forces(harmonic, straight_bonds, pos, box, computables)


def build_bilayer(n_lipids_side: int, params: DesernoParams, area_per_lipid=1.2, device=None):
    """A flat bilayer: (pos [N, 3] numpy, type_id [N] int32 numpy,
    lipid_bonds, straight_bonds (on ``device``, default the GPU), L), with
    N = 2 side^2 lipids x 3 beads, the leaflets at z > 0 and z < 0 and the
    second offset by half a site in x and y."""
    sig = params.sigma
    a = math.sqrt(area_per_lipid) * sig
    side = n_lipids_side
    lipids, types = [], []
    for leaflet, zdir in ((0, 1.0), (1, -1.0)):
        for i in range(side):
            for j in range(side):
                x, y = (i + 0.5 * leaflet) * a, (j + 0.5 * leaflet) * a
                z0 = 0.5 * sig * zdir
                lipids.extend([[x, y, z0 + zdir * 2 * sig],  # head
                               [x, y, z0 + zdir * 1 * sig],  # tail 1
                               [x, y, z0]])  # tail 2
                types.extend([0, 1, 1])
    pos = np.asarray(lipids)
    L = side * a
    pos[:, :2] -= L / 2
    n_l = 2 * side * side
    idx = np.arange(n_l * 3).reshape(n_l, 3)
    fene_pairs = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]]], axis=0)
    lipid_bonds = bonds(fene_pairs, k=np.full(len(fene_pairs), 30.0 * params.epsilon / sig**2),
                        r0=np.full(len(fene_pairs), 1.5 * sig), device=device)
    straight = bonds(idx[:, [0, 2]], k=np.full(n_l, 10.0 * params.epsilon / sig**2),
                     r0=np.full(n_l, 4.0 * sig), device=device)
    return pos, np.asarray(types, np.int32), lipid_bonds, straight, L
