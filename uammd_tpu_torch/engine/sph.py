"""SPH on the grid-resident engine.

Port of ``uammd_tpu/engine/sph.py`` (reference: src/Interactor/SPH.cuh:44,
SPH.cu:7-27): both SPH sweeps run over the 27-stencil channel kernel #2,

1. density: rho_i = sum_j m_j W(r_ij) with the mass riding as a channel
   (the self term m_i W(0) added outside the kernel);
2. force: pressure-gradient + artificial-viscosity pair force with
   (P/rho^2, velocity, mass) channels.

Integration: velocity Verlet with the half-kicked velocity entering the
viscous force, the DPD engine's step (``dpd.verlet_step``): one host read
of the drift per step and ``rebin_fast_noforce`` (kernel #3) on drift.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device
from ..interactors.sph import SPHParams, cubic_spline_gradw_over_r, cubic_spline_w
from .dpd import verlet_step
from .layout import GridSpec, GridState, choose_spec, pack
from .pair_kernel import (PAIR_CHANNEL_SPH_DENSITY, PAIR_CHANNEL_SPH_DENSITY_HALO,
                          PAIR_CHANNEL_SPH_FORCE, PAIR_CHANNEL_SPH_FORCE_HALO, ChannelFunctor,
                          SPHParams as _SPHStruct, make_pair_channel_kernel)


class _SPHPair(ChannelFunctor):
    """Constants as the JAX functors build them from ``np.float32(h)``."""

    def __init__(self, h: float, nu: float = 0.0):
        h32 = np.float32(h)
        self.h = torch.tensor(h32)  # the float32 h the JAX functors pass on
        self.cut2 = float(np.float32(4.0 * h * h))
        self.nu = float(np.float32(nu))
        self._struct = _SPHStruct(self.cut2, float(h32),
                                  float(np.float32(4.0 * math.pi) * h32 ** 3),
                                  float(np.float32(4.0 * math.pi) * h32 ** 4), self.nu)

    def params(self) -> _SPHStruct:
        return self._struct

    def reach(self, hs: float = 0.0) -> float:
        return math.sqrt(self.cut2)


class SPHDensityPair(_SPHPair):
    """``sph_density_pair_fn`` (sph.py:42-52): channel (mass), 1 sum out."""

    n_chan, n_out, disp = 1, 1, 0
    kernel = PAIR_CHANNEL_SPH_DENSITY
    kernel_halo = PAIR_CHANNEL_SPH_DENSITY_HALO

    def __call__(self, r2, dxv, dyv, dzv, ch_i, ch_j):
        (mj,) = ch_j
        inside = (r2 < self.cut2) & (r2 > 1e-12)
        r2s = torch.where(inside, r2, torch.ones_like(r2))
        w = cubic_spline_w(r2s, self.h)
        return (torch.where(inside, mj * w, torch.zeros_like(r2)),)


class SPHForcePair(_SPHPair):
    """``sph_force_pair_fn`` (sph.py:55-75): channels (P/rho^2, vx, vy, vz,
    mass), 3 sums out."""

    n_chan, n_out = 5, 3
    kernel = PAIR_CHANNEL_SPH_FORCE
    kernel_halo = PAIR_CHANNEL_SPH_FORCE_HALO

    def __init__(self, params: SPHParams):
        super().__init__(params.support, params.viscosity)

    def __call__(self, r2, dxv, dyv, dzv, ch_i, ch_j):
        p_i, vxi, vyi, vzi, mi = ch_i
        p_j, vxj, vyj, vzj, mj = ch_j
        inside = (r2 < self.cut2) & (r2 > 1e-12)
        r2s = torch.where(inside, r2, torch.ones_like(r2))
        dvdotdr = (vxj - vxi) * dxv + (vyj - vyi) * dyv + (vzj - vzi) * dzv
        visc = -self.nu * dvdotdr / (r2s + 1e-3)
        gw = cubic_spline_gradw_over_r(r2s, self.h)
        fmod = torch.where(inside, mi * mj * (p_i + p_j + visc) * gw, torch.zeros_like(r2))
        return fmod * dxv, fmod * dyv, fmod * dzv


@dataclasses.dataclass(frozen=True)
class GridSPH:
    """Slot-resident SPH engine (two #2 sweeps per force evaluation)."""

    spec: GridSpec
    params: SPHParams
    dt: float
    mass: float
    device: torch.device
    rho_kern: object
    f_kern: object

    @staticmethod
    def create(box_size, n, params: SPHParams = SPHParams(), *, dt=0.01, mass=1.0, skin=1.1,
               cap=None, pos=None, device=None) -> "GridSPH":
        """On ``device`` (default: the GPU)."""
        spec = choose_spec(box_size, n, params.max_cutoff, skin=skin, cap=cap, pos=pos)
        return GridSPH(
            spec=spec, params=params, dt=dt, mass=mass, device=resolve_device(device),
            rho_kern=make_pair_channel_kernel(spec, SPHDensityPair(params.support)),
            f_kern=make_pair_channel_kernel(spec, SPHForcePair(params)))

    def _mass_channel(self, gs: GridState) -> torch.Tensor:
        return torch.where(gs.mask, float(np.float32(self.mass)),
                           torch.zeros((), dtype=torch.float32, device=gs.device))

    def density(self, gs: GridState) -> torch.Tensor:
        """Slot-space rho (zero on empty slots)."""
        (rho,) = self.rho_kern(gs.x, gs.y, gs.z, self._mass_channel(gs))
        # W(0) = (2^3 - 4*1^3) / (4 pi h^3) = 1/(pi h^3)
        w0 = 1.0 / (math.pi * self.params.support ** 3)
        return (rho + float(np.float32(self.mass * w0))) * gs.mask

    def compute_forces(self, gs: GridState, vx, vy, vz) -> tuple:
        p = self.params
        m = gs.mask
        one = torch.ones((), dtype=torch.float32, device=gs.device)
        zero = torch.zeros((), dtype=torch.float32, device=gs.device)
        rho = self.density(gs)
        rho_s = torch.where(m, rho, one)
        pressure = float(np.float32(p.gas_stiffness)) * (
            rho_s - float(np.float32(p.rest_density)))
        p_div_rho2 = torch.where(m, pressure / (rho_s * rho_s), zero)
        return self.f_kern(gs.x, gs.y, gs.z, p_div_rho2, vx, vy, vz, self._mass_channel(gs))

    def init(self, pos, seed: int = 0, vel=None) -> GridState:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        gs = pack(self.spec, pos, vel=vel, gen=gen, device=self.device)
        fx, fy, fz = self.compute_forces(gs, gs.vx, gs.vy, gs.vz)
        return gs.replace(fx=fx, fy=fy, fz=fz)

    def step(self, gs: GridState) -> GridState:
        """Velocity Verlet; the t+dt force sees the half-kicked velocity.
        One host read: the drift against the half-slack threshold."""
        return verlet_step(self, gs)

    def run(self, gs: GridState, n_steps: int) -> GridState:
        for _ in range(n_steps):
            gs = self.step(gs)
        return gs
