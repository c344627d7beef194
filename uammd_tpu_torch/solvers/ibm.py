"""Immersed-boundary spread / interpolate.

Port of ``uammd_tpu/solvers/ibm.py`` (reference: src/misc/IBM.cuh:101,
IBM_kernels.cuh): particle -> grid spreading S: f(x_i) -> sum_i f_i
phi(x - x_i) / dV and its adjoint interpolation J = S*: u(x_i) = sum_g
u(g) phi(g - x_i), with the window kernels Peskin 3-point and 4-point,
truncated Gaussian and Barnett-Magland "ES".

Convention: grid nodes at cell centres, node g at (g + 0.5) L / n - L/2;
phi takes distances in grid spacings h. Fields are [nx, ny, nz(, C)],
channel last, as in the JAX package.

Each kernel class also names its ``device_phi``: (kind, a, b), the
switch and parameters of the same phi inside the CUDA pencil kernels
(``engine/csrc/pencil_common.cuh``, shared by ``pencil_spread.cu`` and
``pencil_interp.cu``).

``spread_auto``/``interpolate_auto`` dispatch as the JAX package does: for
N >= threshold the pencil path on a pencil-safe grid, else the tiled path
(``solvers/tiled_ibm.py``, plain PyTorch) on a tile-safe one, else the
direct path. The pencil branch is kernels #13/#14
(``spread_pencil_fused``/``interpolate_pencil_fused``: CUDA on the card,
their plain versions on CPU tensors), the same functions as the JAX
package's XLA pencil path there. A bin overflow of either binned path
NaN-poisons the result.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.box import Box
from .pencil_ibm import (_node_constants, _node_coords, bin_pencils, interpolate_pencil_fused,
                         pencil_ok, spread_pencil_fused)
from .tiled_ibm import interpolate_tiled, pick_tile, spread_tiled, tile_shape_ok

# device_phi kinds, as switched on in the CUDA pencil kernels
PHI_GAUSSIAN, PHI_PESKIN3, PHI_PESKIN4, PHI_BM = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Peskin3pt:
    """Peskin 3-point kernel (reference: IBM_kernels.cuh:118)."""

    support: int = 3

    def phi(self, r):
        a = torch.abs(r)
        p1 = (1.0 + torch.sqrt(torch.clamp(1.0 - 3.0 * r * r, min=0.0))) / 3.0
        t = -2.0 + 6.0 * a - 3.0 * r * r
        p2 = (5.0 - 3.0 * a - torch.sqrt(torch.clamp(t, min=0.0))) / 6.0
        return torch.where(a <= 0.5, p1, torch.where((a > 0.5) & (a < 1.5), p2, 0.0))

    @property
    def device_phi(self):
        return (PHI_PESKIN3, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Peskin4pt:
    """Peskin 4-point kernel (reference: IBM_kernels.cuh:140)."""

    support: int = 4

    def phi(self, r):
        a = torch.abs(r)
        p1 = (3.0 - 2.0 * a + torch.sqrt(torch.clamp(1.0 + 4.0 * a - 4.0 * a * a, min=0.0))) / 8.0
        p2 = (5.0 - 2.0 * a
              - torch.sqrt(torch.clamp(-7.0 + 12.0 * a - 4.0 * a * a, min=0.0))) / 8.0
        return torch.where(a <= 1.0, p1, torch.where((a > 1.0) & (a < 2.0), p2, 0.0))

    @property
    def device_phi(self):
        return (PHI_PESKIN4, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class GaussianKernel:
    """Truncated Gaussian, width sigma in units of h, cut at |r| < support/2."""

    sigma: float
    support: int = 6

    def phi(self, r):
        w = torch.exp(-0.5 * (r / self.sigma) ** 2) / (self.sigma * math.sqrt(2.0 * math.pi))
        return torch.where(torch.abs(r) < self.support / 2.0, w, 0.0)

    @property
    def device_phi(self):
        return (PHI_GAUSSIAN, float(self.sigma),
                1.0 / (self.sigma * math.sqrt(2.0 * math.pi)))


@dataclasses.dataclass(frozen=True)
class BMKernel:
    """Barnett-Magland exp-of-semicircle kernel (reference:
    IBM_kernels.cuh:91): phi(r) = exp[beta (sqrt(1 - (2r/w)^2) - 1)]."""

    beta: float
    support: int = 6

    def phi(self, r):
        x = 2.0 * r / float(self.support)
        inside = torch.abs(x) < 1.0
        xs = torch.where(inside, x, 0.0)
        val = torch.exp(self.beta * (torch.sqrt(1.0 - xs * xs) - 1.0))
        return torch.where(inside, val, 0.0)

    @property
    def device_phi(self):
        return (PHI_BM, float(self.beta), 1.0)


# ------------------------------------------------------------- spread/interp
def _base_and_fracs(pos, box: Box, shape, support):
    """Nearest-node base index and node-space coordinates."""
    u = _node_coords(pos, shape, box)  # node g sits at (g + 0.5) h - L/2
    h = _node_constants(tuple(shape), box.lengths, pos.dtype, pos.device)[0]
    if support % 2 == 0:
        base = torch.floor(u).to(torch.int64) - (support // 2 - 1)
    else:
        base = torch.round(u).to(torch.int64) - (support // 2)
    return base, u, h


def _weights_and_indices(kernel, pos, box, shape):
    """Per-axis node indices [N, s] and weights [N, s] for the s^3 nodes."""
    s = kernel.support
    base, u, h = _base_and_fracs(pos, box, shape, s)
    off = torch.arange(s, device=pos.device)
    w_ax, g_ax = [], []
    for d in range(3):
        idx = base[:, d, None] + off[None, :]
        w_ax.append(kernel.phi((idx - u[:, d, None]).to(pos.dtype)))
        g_ax.append(torch.remainder(idx, shape[d]))
    w = (w_ax[0][:, :, None, None] * w_ax[1][:, None, :, None]
         * w_ax[2][:, None, None, :]).reshape(pos.shape[0], s**3)
    flat = ((g_ax[0][:, :, None, None] * shape[1] + g_ax[1][:, None, :, None]) * shape[2]
            + g_ax[2][:, None, None, :]).reshape(pos.shape[0], s**3)
    return flat, w, h


def spread(kernel, pos, values, shape, box: Box):
    """S: values [N] or [N, C] -> field [nx, ny, nz] or [nx, ny, nz, C],
    with the 1/h^3 density factor."""
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    flat, w, h = _weights_and_indices(kernel, pos, box, shape)
    C = values.shape[1]
    contrib = (w * (1.0 / torch.prod(h)))[:, :, None] * values[:, None, :]
    field = torch.zeros((math.prod(shape), C), dtype=values.dtype, device=values.device)
    field.index_add_(0, flat.reshape(-1), contrib.reshape(-1, C))
    field = field.reshape(tuple(shape) + (C,))
    return field[..., 0] if squeeze else field


def interpolate(kernel, pos, field, box: Box):
    """J = S*: field [nx, ny, nz(, C)] -> per-particle values [N(, C)]."""
    squeeze = field.ndim == 3
    if squeeze:
        field = field[..., None]
    shape = tuple(field.shape[:3])
    flat, w, _ = _weights_and_indices(kernel, pos, box, shape)
    vals = field.reshape(-1, field.shape[-1])[flat]  # [N, s^3, C]
    out = torch.sum(w[:, :, None] * vals, dim=1)
    return out[:, 0] if squeeze else out


def _poison(x, overflow):
    """NaN-poison on bin overflow: a dropped contribution is silent wrong
    physics; a NaN trips every downstream check. ``overflow`` is a 0-d
    bool tensor; no host read."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * torch.where(overflow, torch.full_like(one, float("nan")), one)


def spread_auto(kernel, pos, values, shape, box: Box, *, threshold=4096, cap=None):
    """Pencil path (kernel #13) for N >= threshold on pencil-safe grids,
    the tiled path on tile-safe ones, else direct. ``cap`` is in units of
    the chosen path's bin."""
    if pos.shape[0] >= threshold:
        if pencil_ok(shape, kernel.support):
            bins = bin_pencils(pos, shape, box, cap=cap)
            field, overflow = spread_pencil_fused(kernel, pos, values, shape, box, bins)
            return _poison(field, overflow)
        tile = pick_tile(shape, kernel.support)
        if tile_shape_ok(shape, kernel.support, tile):
            field, overflow = spread_tiled(kernel, pos, values, shape, box, cap=cap, tile=tile)
            return _poison(field, overflow)
    return spread(kernel, pos, values, shape, box)


def interpolate_auto(kernel, pos, field, box: Box, *, threshold=4096, cap=None):
    shape = tuple(field.shape[:3])
    if pos.shape[0] >= threshold:
        if pencil_ok(shape, kernel.support):
            bins = bin_pencils(pos, shape, box, cap=cap)
            out, overflow = interpolate_pencil_fused(kernel, pos, field, box, bins)
            return _poison(out, overflow)
        tile = pick_tile(shape, kernel.support)
        if tile_shape_ok(shape, kernel.support, tile):
            out, overflow = interpolate_tiled(kernel, pos, field, box, cap=cap, tile=tile)
            return _poison(out, overflow)
    return interpolate(kernel, pos, field, box)
