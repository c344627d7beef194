"""Short-range pair forces on the grid-resident layout.

Port of ``uammd_tpu/engine/pair_kernel.py:make_pair_force_kernel`` (the
force-only contract ``force(x, y, z) -> (fx, fy, fz)``; the energy, virial,
stress and non-periodic-z halo outputs are not ported yet). For every home
slot the force is the sum of ``g(r2) * d`` over all CAP slots of the 27
neighbor cells, with ``d = r_j - r_i`` after the periodic image shift,
``g = r2 < rc2 ? g_fn(max(r2, clamp_lo)) : 0``.

On CUDA tensors the wrapper launches the hand-written kernel
``csrc/pair_force.cu`` (which has the LJ radial compiled in, so ``g_fn``
must be ``md.lj_g``); on CPU tensors it runs ``pair_force_plain``, the
plain PyTorch version that the tests hold against the JAX kernel and that
``chip_smoke.py`` holds the CUDA kernel against.

Also the port of ``make_pair_channel_kernel`` (#2) and
``broadcast_strag_channels``: the 27-stencil transverser with
per-particle payload channels, with the PSE near-field functor
(``pse_near.PSENear``) on 1 or 2 stacked 3-vectors, periodic in z. CUDA
tensors launch ``csrc/pair_channel.cu``; CPU tensors run
``pair_channel_plain``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .layout import GridSpec, stencil_sources
from .pse_near import (
    PSENear,
    _strag_inv,
    _Struct,
    channel_launch_args,
    channel_launch_shape,
    check_cpu_inputs,
    strag_channel_block,
)

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p

# uammd_pair_force(x, y, z, fx, fy, fz, nx, nyb, nz, F, cap, Lx, Ly, Lz,
#                  rc2, clamp_lo, neg24eps, s2, stream)
PAIR_FORCE = _build.Kernel(
    "pair_force", "uammd_pair_force", [_P] * 6 + [_I] * 5 + [_F] * 7)

# uammd_pair_channel(x, y, z, ch, strag, out, spart, nv, nx, nyb, nz, F,
#                    cap, S, rows, kJ, Lx, Ly, Lz, iLx, iLy, iLz, near, stream)
PAIR_CHANNEL = _build.Kernel("pair_channel", "uammd_pair_channel",
                             [_P] * 7 + [_I] * 9 + [_F] * 6 + [_Struct])

# The kernel stages 9 * 8 candidate rows of NLANE floats in 48 KB of
# shared memory.
MAX_NLANE = 48 * 1024 // (9 * 8 * 4)


class LJRadial:
    """(dE/dr)/r of 12-6 LJ as ``md.lj_g`` computes it: one reciprocal
    t = 1/r2, then -24 eps t (2 (s2 t)^6 - (s2 t)^3) in float32. Called on
    a tensor it is the plain version; the CUDA kernel reads ``epsilon`` and
    ``sigma`` and evaluates the same expression in its device function."""

    def __init__(self, epsilon: float = 1.0, sigma: float = 1.0):
        self.epsilon = float(epsilon)
        self.sigma = float(sigma)
        self.neg24eps = float(np.float32(-24.0) * np.float32(epsilon))
        self.s2 = float(np.float32(sigma * sigma))

    def __call__(self, r2: torch.Tensor) -> torch.Tensor:
        t = 1.0 / r2
        inv2 = self.s2 * t
        inv6 = inv2 * inv2 * inv2
        return self.neg24eps * t * (2.0 * inv6 * inv6 - inv6)


def pair_force_plain(spec: GridSpec, g_fn, x, y, z, clamp_lo: float = 4e-3):
    """Plain PyTorch version of the kernel: for each of the 27 stencil cells,
    gather its CAP slots in home-cell order and form the all-pairs
    [nz, nyb, CAP_i, CAP_j, NLANE] block against the home slots, as the TPU
    kernel forms [CAP_i, CAP_j, NLANE] blocks from lane rolls."""
    dev = x.device
    cap = spec.cap
    rc2 = float(np.float32(spec.cutoff * spec.cutoff))
    lo = float(np.float32(clamp_lo))
    rows = torch.arange(cap, device=dev)[None, None, :, None]
    xi, yi, zi = (a[:, :, :, None, :] for a in (x, y, z))
    fx = torch.zeros_like(x)
    fy = torch.zeros_like(x)
    fz = torch.zeros_like(x)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, lane, (shx, shy, shz) = stencil_sources(spec, dz, dy, dx, dev)
                cx = x[zs, ybs, rows, lane] + shx
                cy = y[zs, ybs, rows, lane] + shy
                cz = z[zs, ybs, rows, lane] + shz
                dxv = cx[:, :, None, :, :] - xi
                dyv = cy[:, :, None, :, :] - yi
                dzv = cz[:, :, None, :, :] - zi
                r2 = dxv * dxv + dyv * dyv + dzv * dzv
                g = torch.where(r2 < rc2, g_fn(torch.clamp(r2, min=lo)), zero)
                fx = fx + (g * dxv).sum(dim=3)
                fy = fy + (g * dyv).sum(dim=3)
                fz = fz + (g * dzv).sum(dim=3)
    return fx, fy, fz


class PairForceKernel:
    """``force(x, y, z) -> (fx, fy, fz)`` for one ``GridSpec``.

    CPU tensors go to ``pair_force_plain``; CUDA tensors launch
    ``csrc/pair_force.cu`` (counted in ``PAIR_FORCE.launches``) or raise."""

    def __init__(self, spec: GridSpec, g_fn, clamp_lo: float = 4e-3):
        self.spec = spec
        self.g_fn = g_fn
        self.clamp_lo = clamp_lo

    def __call__(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
        shape = self.spec.array_shape
        if x.device.type == "cpu":
            for name, t in (("x", x), ("y", y), ("z", z)):
                if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shape:
                    raise ValueError(f"{name} must be a float32 CPU tensor of shape {shape}")
            return pair_force_plain(self.spec, self.g_fn, x, y, z, self.clamp_lo)
        for name, t in (("x", x), ("y", y), ("z", z)):
            _build.check_cuda_tensor(t, name, shape)
        if not isinstance(self.g_fn, LJRadial):
            raise TypeError("the CUDA pair kernel computes the LJ radial only (md.lj_g)")
        spec = self.spec
        if spec.nlane > MAX_NLANE:
            raise ValueError(f"NLANE {spec.nlane} exceeds the kernel's {MAX_NLANE}")
        nx, _, nz = spec.shape
        Lx, Ly, Lz = spec.box_size
        fx, fy, fz = (torch.empty_like(x) for _ in range(3))
        P = _build.ptr
        PAIR_FORCE(
            P(x), P(y), P(z), P(fx), P(fy), P(fz),
            nx, spec.nyb, nz, spec.fold, spec.cap,
            Lx, Ly, Lz,
            float(np.float32(spec.cutoff * spec.cutoff)),
            float(np.float32(self.clamp_lo)),
            self.g_fn.neg24eps, self.g_fn.s2,
        )
        return fx, fy, fz


def make_pair_force_kernel(spec: GridSpec, g_fn, *, clamp_lo: float = 4e-3):
    """Build ``force(x, y, z) -> (fx, fy, fz)`` on [nz, nyb, CAP, NLANE]
    float32 tensors (``layout.GridState`` fields)."""
    return PairForceKernel(spec, g_fn, clamp_lo)


def broadcast_strag_channels(spec: GridSpec, spos, schannels, spid):
    """[S, 3] straggler positions, [S] channels and validity -> the
    [3 + C + 1, S, NLANE] block (x, y, z, channels, valid) the channel
    kernels take (a broadcast view; the kernels read its first lane)."""
    val = (spid >= 0).to(torch.float32)
    stack = torch.stack([spos[:, 0], spos[:, 1], spos[:, 2], *schannels, val])
    return stack[:, :, None].expand(stack.shape[0], spec.n_strag, spec.nlane)


def pair_channel_plain(spec: GridSpec, fn: PSENear, nvec: int, x, y, z, channels,
                       strag=None):
    """Plain PyTorch version of the 27-stencil channel kernel (#2) with the
    PSE near-field functor ``fn``: every home slot sums ``fn``'s forward
    contributions over the 27 cells around it (``stencil_sources``, its
    own cell included) and the straggler rows. Returns ``(out (3 nvec
    grids), spart [3 nvec, S] or None)``: the straggler rows' reverse sums,
    which the JAX kernel returns as per-program partial grids."""
    dev = x.device
    rows = torch.arange(spec.cap, device=dev)[None, None, :, None]
    xi, yi, zi = (a[:, :, :, None, :] for a in (x, y, z))
    out = [torch.zeros_like(x) for _ in range(3 * nvec)]
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, lane, (shx, shy, shz) = stencil_sources(spec, dz, dy, dx, dev)
                dxv = (x[zs, ybs, rows, lane] + shx)[:, :, None] - xi
                dyv = (y[zs, ybs, rows, lane] + shy)[:, :, None] - yi
                dzv = (z[zs, ybs, rows, lane] + shz)[:, :, None] - zi
                ch_j = [c[zs, ybs, rows, lane][:, :, None] for c in channels]
                fwd = fn.pair(dxv * dxv + dyv * dyv + dzv * dzv, dxv, dyv, dzv, ch_j, nvec)
                out = [o + t.sum(dim=3) for o, t in zip(out, fwd)]
    spart = None
    if spec.n_strag:
        ch_i = [c[:, :, :, None, :] for c in channels]
        fwd, spart = strag_channel_block(spec, fn, nvec, xi, yi, zi, ch_i, strag[:, :, 0])
        out = [o + t for o, t in zip(out, fwd)]
    return tuple(out), spart


class PairChannelKernel:
    """``apply(x, y, z, *channels[, strag]) -> (3 nvec grids) [+ (3 nvec
    straggler totals [S])]`` for one ``GridSpec``, the PSE near-field
    functor ``fn`` and ``nvec`` (1 or 2) stacked 3-vectors: the 27-stencil
    channel kernel (#2). The JAX kernel returns the straggler rows as
    per-program partial grids that its caller sums over (z, yb, lane); here
    they come summed. CPU tensors run ``pair_channel_plain``; CUDA tensors
    launch ``csrc/pair_channel.cu`` (counted in ``PAIR_CHANNEL.launches``)
    or raise."""

    def __init__(self, spec: GridSpec, fn: PSENear, nvec: int = 1):
        if not isinstance(fn, PSENear):
            raise TypeError("the channel kernels take the PSE near-field functor "
                            "(engine.pse_near.PSENear)")
        if nvec not in (1, 2):
            raise ValueError(f"nvec must be 1 or 2, not {nvec}")
        self.spec = spec
        self.fn = fn
        self.nvec = nvec

    def __call__(self, x, y, z, *channels, strag=None):
        spec, nvec = self.spec, self.nvec
        S = spec.n_strag
        if S and strag is None:
            raise ValueError("a straggler-capable spec needs the strag block")
        if x.device.type == "cpu":
            check_cpu_inputs(spec, nvec, x, y, z, channels, "the channel kernel")
            out, spart = pair_channel_plain(spec, self.fn, nvec, x, y, z, channels, strag)
        else:
            ch, srows = channel_launch_args(spec, nvec, x, y, z, channels, strag,
                                            "the channel kernel")
            rows, kj = channel_launch_shape(spec, nvec)
            nc = 3 * nvec
            T = spec.n_slots
            buf = torch.zeros(nc * T + nc * S, dtype=torch.float32, device=x.device)
            out_t = buf[: nc * T].view((nc,) + spec.array_shape)
            spart = buf[nc * T:].view(nc, S)
            nx, _, nz = spec.shape
            P = _build.ptr
            PAIR_CHANNEL(
                P(x), P(y), P(z), P(ch), P(srows) if S else _P(0), P(out_t), P(spart),
                nvec, nx, spec.nyb, nz, spec.fold, spec.cap, S, rows, kj,
                *spec.box_size, *_strag_inv(spec), self.fn.struct(),
            )
            out = tuple(out_t)
        if S:
            return tuple(out) + tuple(spart)
        return tuple(out)


def make_pair_channel_kernel(spec: GridSpec, fn: PSENear, nvec: int = 1) -> PairChannelKernel:
    """Build the 27-stencil channel kernel (see ``PairChannelKernel``)."""
    return PairChannelKernel(spec, fn, nvec)
