"""Radial pair potentials.

Port of ``uammd_tpu/potentials/radial.py`` (reference:
src/Interactor/Potential/RadialPotential.cuh:18-53, Potential.cuh:25-85,
ParameterHandler.cuh:8). A radial potential exposes

    energy(r2, ti, tj)        -> per-pair energy
    force_div_r(r2, ti, tj)   -> g = (1/r) dE/dr
    cutoff2(ti, tj)           -> squared cutoff for that type pair
    max_cutoff                -> a host float that sizes neighbour lists

With dr = r_j - r_i the force on i from j is F_i = g(r) dr; the per-pair
virial is -g r^2, half to each particle. Per-type-pair parameters are
scalars or dense [T, T] tables. ``max_cutoff`` is taken once, when the
potential is made, from the host values; the JAX package reads it off
the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


def _table(x, dtype, device) -> torch.Tensor:
    """A scalar or [T, T] table as a tensor (0-d or 2-d)."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)


def _lookup(tab: torch.Tensor, ti, tj):
    if tab.ndim == 0:
        return tab
    return tab[ti, tj]


def _host_max(t: torch.Tensor) -> float:
    return float(t.detach().max().cpu())


@dataclasses.dataclass
class LennardJones:
    """12-6 LJ with per-type-pair epsilon, sigma and cutoff (reference:
    Potential.cuh:84 ``Potential::LJ``); ``shift`` subtracts E(rc)."""

    epsilon: torch.Tensor
    sigma: torch.Tensor
    cutoff: torch.Tensor
    shift: bool = False
    max_cutoff: float | None = None

    def __post_init__(self):
        if self.max_cutoff is None:
            self.max_cutoff = _host_max(self.cutoff)

    def cutoff2(self, ti, tj):
        rc = _lookup(self.cutoff, ti, tj)
        return rc * rc

    def _terms(self, r2, ti, tj):
        sigma = _lookup(self.sigma, ti, tj)
        eps = _lookup(self.epsilon, ti, tj)
        invr2 = sigma * sigma / r2
        invr6 = invr2 * invr2 * invr2
        return eps, sigma, invr2, invr6

    def energy(self, r2, ti, tj):
        eps, _, _, invr6 = self._terms(r2, ti, tj)
        e = 4.0 * eps * (invr6 * invr6 - invr6)
        if self.shift:
            rc2 = self.cutoff2(ti, tj)
            sigma = _lookup(self.sigma, ti, tj)
            ic2 = sigma * sigma / rc2
            ic6 = ic2 * ic2 * ic2
            e = e - 4.0 * eps * (ic6 * ic6 - ic6)
        return e

    def force_div_r(self, r2, ti, tj):
        eps, _, _, invr6 = self._terms(r2, ti, tj)
        # dE/dr / r = -(24 eps / r2)(2 invr12 - invr6)
        return -(24.0 * eps / r2) * (2.0 * invr6 * invr6 - invr6)


def lj(epsilon=1.0, sigma=1.0, cutoff=2.5, shift=False, dtype=torch.float32, device=None):
    """LJ from scalars or [T, T] tables on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    rc = _table(cutoff, dtype, "cpu")
    return LennardJones(epsilon=_table(epsilon, dtype, dev), sigma=_table(sigma, dtype, dev),
                        cutoff=rc.to(dev), shift=shift, max_cutoff=_host_max(rc))


def wca(epsilon=1.0, sigma=1.0, dtype=torch.float32, device=None):
    """Purely repulsive WCA: LJ cut and shifted at 2^(1/6) sigma (used by
    the Deserno membrane model, reference: src/misc/Deserno.cuh)."""
    dev = resolve_device(device)
    rc = 2.0 ** (1.0 / 6.0) * _table(sigma, dtype, "cpu")
    return LennardJones(epsilon=_table(epsilon, dtype, dev), sigma=_table(sigma, dtype, dev),
                        cutoff=rc.to(dev), shift=True, max_cutoff=_host_max(rc))


@dataclasses.dataclass
class Tabulated:
    """A potential from tabulated E and g = (1/r) dE/dr on a uniform r^2
    grid, interpolated linearly in r^2 (reference:
    src/misc/TabulatedFunction.cuh:78)."""

    r2_max: torch.Tensor  # scalar
    energy_table: torch.Tensor  # [M]
    g_table: torch.Tensor  # [M]
    cutoff: torch.Tensor  # scalar
    max_cutoff: float | None = None

    def __post_init__(self):
        if self.max_cutoff is None:
            self.max_cutoff = _host_max(self.cutoff)

    def cutoff2(self, ti, tj):
        return self.cutoff * self.cutoff

    def _interp(self, tab, r2):
        m = tab.shape[0]
        x = torch.clamp(r2 / self.r2_max, 0.0, 1.0) * (m - 1)
        i0 = torch.clamp(torch.floor(x).to(torch.int32), 0, m - 2)
        w = x - i0
        i0 = i0.long()
        return tab[i0] * (1 - w) + tab[i0 + 1] * w

    def energy(self, r2, ti, tj):
        return self._interp(self.energy_table, r2)

    def force_div_r(self, r2, ti, tj):
        return self._interp(self.g_table, r2)


def tabulate(potential, r_max: float, n: int = 4096, types=(0, 0), dtype=torch.float32):
    """Sample a radial potential onto a Tabulated one, on the potential's
    device."""
    dev = potential.cutoff.device
    r2 = torch.linspace(1e-6, r_max * r_max, n, dtype=dtype, device=dev)
    ti, tj = types
    return Tabulated(r2_max=torch.tensor(r_max * r_max, dtype=dtype, device=dev),
                     energy_table=potential.energy(r2, ti, tj).to(dtype),
                     g_table=potential.force_div_r(r2, ti, tj).to(dtype),
                     cutoff=torch.tensor(r_max, dtype=dtype, device=dev),
                     max_cutoff=float(torch.tensor(r_max, dtype=dtype)))
