"""Multi-species / polydisperse LJ pair forces on the grid-resident engine.

Port of ``uammd_tpu/engine/mixtures.py`` (reference:
src/Interactor/Potential/ParameterHandler.cuh:8, NeighbourList/LBVH.cuh:652):
each particle carries (sqrt(eps_i), sigma_i / 2) as channels of the
27-stencil channel kernel #2, the pair reconstructs Lorentz-Berthelot
parameters in registers, and the per-pair cutoff cut_scale * sigma_ij masks
each candidate (the cell size is set by the largest pair cutoff).
``MixtureLJHierarchical`` splits extreme polydispersity over two grids: a
fine one for small-small pairs and a coarse one for the rest, with the
small-small pairs masked out there.

Positions are binned with ``layout.pack_channels`` and the slot forces
brought back to pid order with ``layout.unpack_values`` (a scatter by pid,
where JAX sorts). JAX's ``.at[idx].add`` is ``index_add_``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .layout import GridSpec, choose_spec, pack_channels, unpack_values
from .pair_kernel import (PAIR_CHANNEL_LJ_MIX, PAIR_CHANNEL_LJ_MIX_HALO,
                          PAIR_CHANNEL_LJ_MIX_MASKED, PAIR_CHANNEL_LJ_MIX_MASKED_HALO,
                          ChannelFunctor, LJMixParams, make_pair_channel_kernel)


class LJMixturePair(ChannelFunctor):
    """``lj_mixture_pair_fn`` (mixtures.py:40-71): channels (sqrt_eps,
    half_sigma), truncated LJ with Lorentz-Berthelot mixing and the per-pair
    cutoff cut_scale * sigma_ij, 3 sums out. Empty slots carry zero
    channels, so rc2 = 0 and they are never inside; the self pair fails
    r2 > 1e-10."""

    n_chan, n_out = 2, 3
    kernel = PAIR_CHANNEL_LJ_MIX
    kernel_halo = PAIR_CHANNEL_LJ_MIX_HALO

    def __init__(self, cut_scale: float = 2.5, clamp_lo: float = 4e-3):
        self.cs2 = float(np.float32(cut_scale * cut_scale))
        self.lo = float(np.float32(clamp_lo))

    def params(self) -> LJMixParams:
        return LJMixParams(self.cs2, self.lo)

    def reach(self, hs: float = 0.0) -> float:
        """The per-pair cutoff sqrt(cs2) (hs_i + hs_j) at ``hs`` = hs_i + hs_j."""
        return float(np.sqrt(np.float32(self.cs2))) * hs

    def __call__(self, r2, dxv, dyv, dzv, ch_i, ch_j):
        se_i, hs_i = ch_i[:2]
        se_j, hs_j = ch_j[:2]
        eps = se_i * se_j
        sig = hs_i + hs_j
        sig2 = sig * sig
        rc2 = self.cs2 * sig2
        inside = (r2 < rc2) & (r2 > 1e-10)
        t = sig2 / torch.maximum(r2, self.lo * sig2)
        t6 = t * t * t
        g = torch.where(inside, (-24.0 * eps / torch.clamp(r2, min=self.lo))
                        * (2.0 * t6 * t6 - t6), torch.zeros_like(r2))
        return g * dxv, g * dyv, g * dzv


class LJMixturePairMasked(LJMixturePair):
    """``lj_mixture_pair_fn_masked`` (mixtures.py:108-122): a third channel
    ``small_flag``; pairs whose two particles are both small are dropped
    (they belong to the fine grid)."""

    n_chan = 3
    kernel = PAIR_CHANNEL_LJ_MIX_MASKED
    kernel_halo = PAIR_CHANNEL_LJ_MIX_MASKED_HALO

    def __call__(self, r2, dxv, dyv, dzv, ch_i, ch_j):
        fx, fy, fz = super().__call__(r2, dxv, dyv, dzv, ch_i, ch_j)
        keep = 1.0 - ch_i[2] * ch_j[2]  # 0 iff both small
        return keep * fx, keep * fy, keep * fz


def _channels(epsilon, sigma, device, *extra):
    eps = torch.sqrt(torch.as_tensor(epsilon, dtype=torch.float32, device=device))
    hs = 0.5 * torch.as_tensor(sigma, dtype=torch.float32, device=device)
    return torch.stack([eps, hs, *extra], dim=-1)


@dataclasses.dataclass(frozen=True)
class MixtureLJ:
    """Grid-resident polydisperse / multi-species LJ front end."""

    spec: GridSpec
    cut_scale: float
    device: torch.device
    kern: object

    @staticmethod
    def create(box_size, n, epsilon, sigma, *, cut_scale=2.5, skin=1.0, cap=None,
               device=None) -> "MixtureLJ":
        """epsilon / sigma: per-particle arrays. The grid is sized by the
        largest pair cutoff cut_scale * max(sigma). On ``device`` (default:
        the GPU)."""
        rcut = cut_scale * float(np.max(np.asarray(sigma)))
        spec = choose_spec(box_size, n, rcut, skin=skin, cap=cap)
        return MixtureLJ(spec=spec, cut_scale=cut_scale, device=resolve_device(device),
                         kern=make_pair_channel_kernel(spec, LJMixturePair(cut_scale)))

    def forces(self, pos, epsilon, sigma):
        """([N, 3] forces, overflow) for per-particle (epsilon, sigma)."""
        pos = torch.as_tensor(pos, dtype=torch.float32, device=self.device)
        cg = pack_channels(self.spec, pos, _channels(epsilon, sigma, self.device))
        fx, fy, fz = self.kern(cg.x, cg.y, cg.z, *cg.channels)
        return unpack_values(cg, (fx, fy, fz)), cg.overflow


@dataclasses.dataclass(frozen=True)
class MixtureLJHierarchical:
    """Two-grid hierarchy for extreme polydispersity (LBVH.cuh:1-60's
    regime): particles with sigma <= ``sigma_split`` are small. A fine grid
    (cells from the largest small-small cutoff) holds the small particles
    and computes small-small pairs; a coarse grid (cells from the largest
    pair cutoff) holds everyone and computes the other pairs, small-small
    masked out in registers."""

    fine: MixtureLJ
    coarse_spec: GridSpec
    cut_scale: float
    small_idx: tuple
    device: torch.device
    kern_coarse: object

    @staticmethod
    def create(box_size, n, epsilon, sigma, *, sigma_split=None, cut_scale=2.5, skin=1.0,
               cap_fine=None, cap_coarse=None, device=None) -> "MixtureLJHierarchical":
        sig = np.asarray(sigma, np.float64)
        if sigma_split is None:
            sigma_split = float(np.sqrt(sig.min() * sig.max()))
        small = np.nonzero(sig <= sigma_split)[0]
        if not 0 < len(small) < n:
            raise ValueError("the split at sigma_split leaves one group empty")
        fine = MixtureLJ.create(box_size, len(small), epsilon=np.asarray(epsilon)[small],
                                sigma=sig[small], cut_scale=cut_scale, skin=skin, cap=cap_fine,
                                device=device)
        coarse_spec = choose_spec(box_size, n, cut_scale * float(sig.max()), skin=skin,
                                  cap=cap_coarse)
        return MixtureLJHierarchical(
            fine=fine, coarse_spec=coarse_spec, cut_scale=cut_scale,
            small_idx=tuple(int(i) for i in small), device=fine.device,
            kern_coarse=make_pair_channel_kernel(coarse_spec, LJMixturePairMasked(cut_scale)))

    def forces(self, pos, epsilon, sigma):
        """([N, 3] forces, overflow)."""
        dev = self.device
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        epsilon = torch.as_tensor(epsilon, dtype=torch.float32, device=dev)
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
        idx = torch.as_tensor(self.small_idx, dtype=torch.long, device=dev)
        flag = torch.zeros((pos.shape[0],), dtype=torch.float32, device=dev)
        flag[idx] = 1.0
        cg = pack_channels(self.coarse_spec, pos, _channels(epsilon, sigma, dev, flag))
        fx, fy, fz = self.kern_coarse(cg.x, cg.y, cg.z, *cg.channels)
        out = unpack_values(cg, (fx, fy, fz))
        f_small, ovf_f = self.fine.forces(pos[idx], epsilon[idx], sigma[idx])
        out.index_add_(0, idx, f_small)
        return out, cg.overflow | ovf_f
