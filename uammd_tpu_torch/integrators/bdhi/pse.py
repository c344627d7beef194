"""Positively-Split Ewald RPY over a neighbour list: near field + far field.

Port of ``uammd_tpu/integrators/bdhi/pse.py`` (reference:
src/Integrator/BDHI/PSE/BDHI_PSE.cuh, NearField.cuh, FarField.cuh:82-115).
The periodic RPY mobility is split at an inverse length ``xi`` into

- a far field: FCM with the split Gaussian sigma = 1 / (2 xi), the RPY
  surface-sphere factor sinc^2(ka) and the Hasimoto polynomial
  (``FCM.create(rpy_sinc_radius, hasimoto_k2)``); at N >= 4096 on a
  pencil-safe grid its spread and interpolation are kernels #13/#14;
- a near field: the remainder M_RPY(r) - M_blob(r), tabulated in float64
  on a uniform r^2 grid at setup (host numpy, as the JAX package does) and
  summed over a neighbour list with ``apply_pairs``; its noise is a
  Lanczos sqrt.

A pair mobility is M(r) = f(r) I + g(r) r^ r^ (``_blob_fg``, ``_rpy_fg``);
``PSEGrid.create`` (pse_engine.py) fits the same remainder with
polynomials for the grid engine.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core.box import Box
from ...neighbors.neighbor_list import NeighborList, build_neighbor_list
from ...neighbors.pair_map import apply_pairs
from ...solvers.lanczos import lanczos_sqrt_apply
from .fcm import FCM

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _blob_fg(r, sigma_c, eta, kmax_factor=12.0, nk=8192, a=None):
    """Open-space blob pair mobility radial functions f(r), g(r), by 1D
    Bessel quadratures of the transverse projector transform

      f(r) = (1/(2 pi^2 eta)) Int phi(k) [j0(kr) - j1(kr)/(kr)] dk
      g(r) = -(1/(2 pi^2 eta)) Int phi(k) [j0(kr) - 3 j1(kr)/(kr)] dk

    ``a=None``: the point Gaussian envelope phi(k) = exp(-Sigma^2 k^2 / 2).
    ``a`` set: the full PSE wave-space envelope
    phi(k) = sinc^2(ka) (1 + Sigma^2 k^2 / 2) exp(-Sigma^2 k^2 / 2), the RPY
    surface-sphere factor times the Hasimoto splitting polynomial."""
    r = np.atleast_1d(np.asarray(r, np.float64))
    kmax = kmax_factor / sigma_c
    k = np.linspace(1e-8, kmax, nk)
    phi = np.exp(-0.5 * (sigma_c * k) ** 2)
    if a is not None:
        phi = phi * np.square(np.sinc(k * a / math.pi))
        phi = phi * (1.0 + 0.5 * (sigma_c * k) ** 2)
    x = np.outer(r, k)  # [R, K]
    with np.errstate(invalid="ignore", divide="ignore"):
        j0 = np.where(x > 1e-8, np.sin(x) / x, 1.0 - x * x / 6.0)
        j1_over_x = np.where(
            x > 1e-4,
            (np.sin(x) / x**2 - np.cos(x) / x) / x,
            1.0 / 3.0 - x * x / 30.0,
        )
    pref = 1.0 / (2.0 * math.pi**2 * eta)
    f = pref * _trapezoid(phi * (j0 - j1_over_x), k, axis=1)
    g = -pref * _trapezoid(phi * (j0 - 3.0 * j1_over_x), k, axis=1)
    return f, g


def _rpy_fg(r, a, eta):
    """RPY radial functions (reference: BDHI.cuh:13-70)."""
    r = np.atleast_1d(np.asarray(r, np.float64))
    m0 = 1.0 / (6.0 * math.pi * eta * a)
    rs = np.maximum(r, 1e-14)
    far_f = m0 * (3.0 * a / (4.0 * rs)) * (1.0 + 2.0 * a**2 / (3.0 * rs**2))
    far_g = m0 * (3.0 * a / (4.0 * rs)) * (1.0 - 2.0 * a**2 / rs**2)
    near_f = m0 * (1.0 - 9.0 * r / (32.0 * a))
    near_g = m0 * (3.0 / (32.0 * a)) * r
    f = np.where(r >= 2 * a, far_f, near_f)
    g = np.where(r >= 2 * a, far_g, near_g)
    return f, g


@dataclasses.dataclass(frozen=True)
class PSE:
    """Split RPY backend for ``bdhi_euler_maruyama``."""

    box: Box
    far: FCM
    viscosity: float
    radius: float
    xi: float
    rcut: float
    r2_max: float
    # near-field tables on a uniform r^2 grid over [0, r2_max], float64
    f_table: torch.Tensor
    g_table: torch.Tensor
    self_f: float
    lanczos_iterations: int = 24

    @staticmethod
    def create(box: Box, viscosity=1.0, radius=1.0, xi: float | None = None,
               tolerance: float = 1e-4, points_per_width: float = 1.2, table_size: int = 4096,
               lanczos_iterations: int = 24, support: int = 10):
        if xi is None:
            xi = 0.5 / radius  # sigma_split = radius: the balanced default
        sigma_split = 0.5 / xi
        sigma_c = math.sqrt(2.0) * sigma_split
        # the remainder decays ~ erfc(r / (2 sigma_split)), shifted out by
        # ~2a by the surface-sphere convolutions: one radius of slack
        rcut = sigma_c * math.sqrt(2.0 * math.log(1.0 / tolerance)) + radius
        rcut = max(rcut, 2.0 * radius * 1.05)
        h = sigma_split / points_per_width
        far = FCM.create(box, viscosity=viscosity, radius=sigma_split * math.sqrt(math.pi),
                         points_per_radius=sigma_split * math.sqrt(math.pi) / h,
                         support=support, rpy_sinc_radius=radius,
                         hasimoto_k2=sigma_split * sigma_split)
        r = np.sqrt(np.linspace(1e-12, rcut * rcut, table_size))
        fb, gb = _blob_fg(r, sigma_c, viscosity, a=radius)
        fr, gr = _rpy_fg(r, radius, viscosity)
        f0b, _ = _blob_fg(np.array([0.0]), sigma_c, viscosity, a=radius)
        m0 = 1.0 / (6.0 * math.pi * viscosity * radius)
        dev = box.size.device
        return PSE(box=box, far=far, viscosity=viscosity, radius=radius, xi=xi,
                   rcut=float(rcut), r2_max=float(rcut * rcut),
                   f_table=torch.as_tensor(fr - fb, device=dev),
                   g_table=torch.as_tensor(gr - gb, device=dev),
                   self_f=float(m0 - f0b[0]), lanczos_iterations=lanczos_iterations)

    def _interp_tables(self, r2):
        """Linear interpolation of the tables at r2, computed in float64
        and cast to r2's dtype (the JAX package's ``.astype(r2.dtype)``)."""
        m = self.f_table.shape[0]
        x = torch.clamp(r2 / self.r2_max, 0.0, 1.0) * (m - 1)
        i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, m - 2)
        w = x - i0
        f = self.f_table[i0] * (1 - w) + self.f_table[i0 + 1] * w
        g = self.g_table[i0] * (1 - w) + self.g_table[i0 + 1] * w
        return f.to(r2.dtype), g.to(r2.dtype)

    def near_matvec(self, pos, forces, nlist: NeighborList):
        """M_near F over the neighbour list, plus the self term (NearField.cuh
        transverser over TabulatedFunction)."""

        def kernel(r2, dr, fi, fj, idx):
            inside = (r2 < self.r2_max) & (r2 > 1e-14)
            r2s = torch.where(inside, r2, 1.0)
            f, g = self._interp_tables(r2s)
            rhat = dr * torch.rsqrt(r2s)[..., None]
            fdotr = torch.sum(fj * rhat, dim=-1)
            out = f[..., None] * fj + g[..., None] * fdotr[..., None] * rhat
            return {"v": torch.where(inside[..., None], out, 0.0)}

        out = apply_pairs(kernel, nlist, pos, info=forces, box=self.box)
        return out["v"] + self.self_f * forces

    def compute_mf(self, pos, forces, nlist: NeighborList | None = None):
        if nlist is None:
            nlist = build_neighbor_list(pos, self.box, self.rcut)
        return self.far.compute_mf(pos, forces) + self.near_matvec(pos, forces, nlist)

    def compute_bdw(self, pos, gen, nlist: NeighborList | None = None):
        """Far noise (FCM, wave space) + near noise (Lanczos sqrt of M_near),
        both drawn from ``gen``."""
        if nlist is None:
            nlist = build_neighbor_list(pos, self.box, self.rcut)
        far_noise = self.far.compute_bdw(pos, gen)

        def mv(x):
            return self.near_matvec(pos, x.reshape(-1, 3), nlist).reshape(-1)

        z = torch.randn(3 * pos.shape[0], generator=gen, dtype=pos.dtype, device=pos.device)
        near_noise, _ = lanczos_sqrt_apply(mv, z, m=self.lanczos_iterations)
        return far_noise + near_noise.reshape(-1, 3)

    def divergence(self, pos):
        return torch.zeros_like(pos)


_FCM_FIELDS = ("viscosity", "radius", "shape", "support", "box_size", "rpy_sinc_radius",
               "hasimoto_k2", "kernel", "bm_beta")


def pse_from_numpy(fields: dict, box: Box) -> PSE:
    """A PSE from host values named as PSE's fields, with ``far`` a dict of
    the far FCM's (shape, support, radius, ...), as read off the JAX
    package's PSE; the tables go to the box's device as given (float64)."""
    far = FCM(box=box, **{k: (tuple(int(n) for n in v) if k == "shape"
                              else tuple(float(x) for x in v) if k == "box_size" else v)
                          for k, v in fields["far"].items() if k in _FCM_FIELDS})
    dev = box.size.device
    return PSE(box=box, far=far, viscosity=float(fields["viscosity"]),
               radius=float(fields["radius"]), xi=float(fields["xi"]),
               rcut=float(fields["rcut"]), r2_max=float(fields["r2_max"]),
               f_table=torch.tensor(np.asarray(fields["f_table"]), device=dev),
               g_table=torch.tensor(np.asarray(fields["g_table"]), device=dev),
               self_f=float(fields["self_f"]),
               lanczos_iterations=int(fields["lanczos_iterations"]))
