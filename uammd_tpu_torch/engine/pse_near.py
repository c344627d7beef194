"""The pair functor of the channel kernels: the PSE near-field RPY remainder.

Port of ``uammd_tpu/integrators/bdhi/pse_engine.py:PSEGrid._radial_apply``
and ``_pair_fn`` (:263-335). For a pair at d = r_j - r_i with r2 = d.d:

    inside = (r2 < rc2) & (r2 > 1e-10)      (self pair and cutoff excluded)
    q = (r2 * rsqrt(r2)) / rcut,  piece 1 if q < qb else piece 2
    f = Horner(f-coefficients, u),  g = Horner(g-coefficients, u),
        u = a q + b of the piece
    v_i += f F_j + g / r2 (d . F_j) d

and the reverse contribution onto j is f F_i + g / r2 (d . F_i) d (the g
term is even in d). ``nvec`` 3-vectors ride on one radial evaluation.

``PSENear`` holds the fitted constants (two pieces, f and g each, as
power coefficients in the centred variable u) and is both the plain
PyTorch form of the functor and the source of the constant struct that
``csrc/pse_near.cuh`` reads. A degree below 12 is padded with leading
zeros, which leaves every Horner step bit-identical.

Also what the two channel kernels share (#2 in ``pair_kernel.py``, #10 in
``kernel2.py``): the straggler block of their plain versions and their
input checks.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build
from .layout import GridSpec

NCOEF = 13  # the highest fitted degree is 12


class _Struct(ctypes.Structure):
    """``struct PSENear`` of csrc/pse_near.cuh."""

    _fields_ = [("c", ctypes.c_float * (4 * NCOEF))] + [
        (k, ctypes.c_float) for k in ("a1", "b1", "a2", "b2", "qb", "rc2", "inv_rcut")]


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class PSENear:
    """coef = (f1, f2, g1, g2) power coefficients (lowest degree first),
    uscale = ((a1, b1), (a2, b2)), the piece split qb = r / rcut and the
    cutoff rcut, all as ``PSEGrid.create`` fits them."""

    coef: tuple
    uscale: tuple
    qb: float
    rcut: float

    # every sum carries all of d: f F + (g / r2)(d . F) d (``kDisp`` 2 of
    # the CUDA functor, ``pair_kernel.displacement_sums``)
    disp = 2

    @property
    def rc2(self) -> float:
        return _f32(self.rcut * self.rcut)

    def reach(self, hs: float = 0.0) -> float:
        """The cutoff: the CUDA kernel's cull radius."""
        return float(np.sqrt(self.rc2))

    def _consts(self):
        (a1, b1), (a2, b2) = self.uscale
        return (_f32(a1), _f32(b1), _f32(a2), _f32(b2), _f32(self.qb), self.rc2,
                _f32(1.0 / self.rcut))

    def padded(self):
        """The four coefficient lists as float32 values, padded to NCOEF."""
        out = []
        for cs in self.coef:
            if len(cs) > NCOEF:
                raise ValueError(f"degree {len(cs) - 1} is above the kernels' {NCOEF - 1}")
            out.append([_f32(c) for c in cs] + [0.0] * (NCOEF - len(cs)))
        return out

    def struct(self) -> _Struct:
        st = _Struct()
        st.c[:] = [c for cs in self.padded() for c in cs]
        st.a1, st.b1, st.a2, st.b2, st.qb, st.rc2, st.inv_rcut = self._consts()
        return st

    def radial(self, r2):
        """(f, g / r2), both 0 outside the cutoff and on the self pair."""
        a1, b1, a2, b2, qb, rc2, inv_rcut = self._consts()
        cf1, cf2, cg1, cg2 = self.padded()
        inside = (r2 < rc2) & (r2 > 1e-10)
        r2s = torch.where(inside, r2, torch.ones((), dtype=r2.dtype, device=r2.device))
        rinv = torch.rsqrt(r2s)
        q = r2s * rinv * inv_rcut
        near = q < qb
        u1 = a1 * q + b1
        u2 = a2 * q + b2

        def horner(cs, u):
            acc = torch.full_like(u, cs[-1])
            for c in cs[-2::-1]:
                acc = acc * u + c
            return acc

        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        f = torch.where(near, horner(cf1, u1), horner(cf2, u2))
        g = torch.where(near, horner(cg1, u1), horner(cg2, u2))
        f = torch.where(inside, f, zero)
        ginv2 = torch.where(inside, g * (rinv * rinv), zero)
        return f, ginv2

    @staticmethod
    def apply_dir(f, ginv2, dx, dy, dz, ch):
        fx, fy, fz = ch
        gc = ginv2 * (fx * dx + fy * dy + fz * dz)
        return f * fx + gc * dx, f * fy + gc * dy, f * fz + gc * dz

    def pair_fn(self, nvec: int):
        """The forward contributions as a JAX-signature ``pair_fn(r2, dxv,
        dyv, dzv, ch_i, ch_j)``."""
        return lambda r2, dx, dy, dz, ch_i, ch_j: self.pair(r2, dx, dy, dz, ch_j, nvec)

    def pair(self, r2, dx, dy, dz, ch_j, nvec: int):
        """The forward contributions (3 nvec of them) onto the home rows."""
        f, ginv2 = self.radial(r2)
        out = ()
        for k in range(nvec):
            out += self.apply_dir(f, ginv2, dx, dy, dz, ch_j[3 * k: 3 * k + 3])
        return out

    def pair_both(self, r2, dx, dy, dz, ch_i, ch_j, nvec: int):
        """(forward onto i, reverse onto j) off one radial evaluation."""
        f, ginv2 = self.radial(r2)
        fwd, bwd = (), ()
        for k in range(nvec):
            fwd += self.apply_dir(f, ginv2, dx, dy, dz, ch_j[3 * k: 3 * k + 3])
            bwd += self.apply_dir(f, ginv2, -dx, -dy, -dz, ch_i[3 * k: 3 * k + 3])
        return fwd, bwd


def _strag_inv(spec: GridSpec):
    """The straggler minimum image's float32 1/L, as the JAX channel
    kernels take it (``np.float32(1.0 / L)``)."""
    return tuple(float(np.float32(1.0 / L)) for L in spec.box_size)


def strag_channel_block(spec: GridSpec, pair_fn, n_chan: int, xi, yi, zi, ch_i, rows,
                        per_row: bool = False):
    """Home slots against the straggler rows, both directions: returns
    (forward, a list of [nz, nyb, CAP, NLANE] grids; reverse [n_out, S], or
    with ``per_row`` the reverse sums of each z row of home slots,
    [n_out, nz, S], as the JAX kernel's per-program partials summed over yb
    and lanes).
    ``pair_fn(r2, dx, dy, dz, ch_i, ch_j)`` gives the functor's terms onto
    i (the JAX signature); ``xi``.. are [nz, nyb, CAP, 1, NLANE] and
    ``rows`` the [3 + n_chan + 1, S] rows (x, y, z, channels, valid).
    Invalid rows and empty home slots go to r2 = 1e18.

    Each direction takes its displacement as the grid takes a candidate of
    an image cell (csrc/pse_near.cuh:image_pair): with the minimum image's
    shift L round((x_s - x_i) / L) (the float32 1/L), (x_s - shift) - x_i
    onto the home slot and (x_i + shift) - x_s onto the row, each with its
    own r2. A pair then rounds as it does when the row is a grid particle:
    the power-basis Horner sums of the fitted functors turn one ulp of r2
    into about 1e-6 of their value. (The JAX kernels round the difference
    first and negate it for the reverse.)"""
    home = (xi, yi, zi)
    d, e = [], []
    for k, (L, iL) in enumerate(zip(spec.box_size, _strag_inv(spec))):
        s = rows[k][None, None, None, :, None]
        shift = L * torch.round((s - home[k]) * iL)
        d.append((s - shift) - home[k])
        e.append((home[k] + shift) - s)
    ok = (rows[3 + n_chan][None, None, None, :, None] > 0.5) & (xi < 1.0e8)
    far = torch.full_like(d[0], 1.0e18)
    r2 = torch.where(ok, d[0] * d[0] + d[1] * d[1] + d[2] * d[2], far)
    r2e = torch.where(ok, e[0] * e[0] + e[1] * e[1] + e[2] * e[2], far)
    ch_s = [rows[3 + k][None, None, None, :, None] for k in range(n_chan)]
    fwd = pair_fn(r2, d[0], d[1], d[2], ch_i, ch_s)
    bwd = pair_fn(r2e, e[0], e[1], e[2], ch_s, ch_i)
    dims = (1, 2, 4) if per_row else (0, 1, 2, 4)
    return ([t.sum(dim=3) for t in fwd],
            torch.stack([t.expand(r2.shape).sum(dim=dims) for t in bwd]))


def strag_row_totals(part_rows, periodic_z: bool = True):
    """Per-row straggler partials [n_out, nz, S] -> the totals [n_out, S]:
    over every row, or in the halo mode over the slab's interior rows only,
    as the JAX callers sum the kernel's partials (``outs[3 + c][1:-1]``,
    uammd_tpu/parallel/pse_dd2.py:322, :344-347)."""
    return part_rows.sum(dim=1) if periodic_z else part_rows[:, 1:-1].sum(dim=1)


def channel_launch_args(spec: GridSpec, n_chan: int, x, y, z, channels, strag, what: str):
    """Check a channel kernel's CUDA inputs; returns (stacked channels,
    the [3 + n_chan + 1, S] straggler rows or None)."""
    shape = spec.array_shape
    if len(channels) != n_chan:
        raise ValueError(f"{what} takes {n_chan} channels, got {len(channels)}")
    for name, t in (("x", x), ("y", y), ("z", z)):
        _build.check_cuda_tensor(t, name, shape)
    for k, t in enumerate(channels):
        _build.check_cuda_tensor(t, f"channel {k}", shape)
    # a functor without channels reads none: any pointer will do
    ch = torch.stack(channels) if channels else x
    rows_s = None
    if spec.n_strag:
        rows_s = strag[:, :, 0].to(torch.float32).contiguous()
        _build.check_cuda_tensor(rows_s, "strag", (3 + n_chan + 1, spec.n_strag))
    return ch, rows_s


def check_cpu_inputs(spec: GridSpec, nvec: int, x, y, z, channels, what: str):
    shape = spec.array_shape
    if len(channels) != 3 * nvec:
        raise ValueError(f"{what} takes {3 * nvec} channels, got {len(channels)}")
    for t in (x, y, z, *channels):
        if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{what} inputs must be float32 CPU tensors of shape {shape}")
