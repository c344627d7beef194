"""Triply periodic spectral Poisson electrostatics.

Port of ``uammd_tpu/electrostatics/poisson.py`` (reference:
src/Interactor/SpectralEwaldPoisson.cuh:1-81): point charges are spread
onto a grid with a Gaussian envelope of width ``gw``, the periodic Poisson
equation is solved in Fourier space,

    phi(k) = rho(k) / (epsilon k^2),    phi(0) = 0   (tinfoil boundary)

the field E = -grad phi is obtained by ik multiplication, and forces
F_i = q_i E(x_i) and energies 0.5 q_i phi(x_i) are interpolated back: the
pair potential of two charges is erf(r / (2 gw)) / (4 pi eps r), charges
being Gaussian clouds of width gw (SpectralEwaldPoisson.cuh:22-30).

``Poisson`` is the no-split solver. ``PoissonSplit`` is the reference's
Ewald split mode: the spectral far field of widened Gaussians (width
ngw = sqrt(gw^2 + 1/(4 split^2)), a much coarser grid) plus the
short-range correction ``GaussianNearField`` over the 27-stencil channel
kernel #2 with the Poisson functor (``PoissonNear``; CUDA
``uammd_pair_channel_poisson`` on the card, its plain version on CPU
tensors), whose radial G and G'/r are two-piece polynomial fits made in
float64 numpy exactly as the JAX package makes them.

Spread and interpolation share one pencil binning per solve: with N >=
4096 on a pencil-safe grid they are kernels #13 and #14
(``pencil_ibm.spread_pencil_fused`` / ``interpolate_pencil_fused``, the
Gaussian window, one channel in and the four channels phi, Ex, Ey, Ez
out in one launch), else the direct path, as the JAX package's
``_spread_interp`` chooses. The fields are kept channel first ([4, nx, ny,
nz], as ``torch.fft`` writes them); the FFTs are ``torch.fft.rfftn`` /
``irfftn`` (cuFFT on the card).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.box import Box
from ..core.grid import next_fft_size
from ..core.types import Computables, ForceEnergyVirial
from ..engine.layout import choose_spec, pack_channels, unpack_values
from ..engine.pair_kernel import (PAIR_CHANNEL_POISSON, POISSON_NCOEF, ChannelFunctor,
                                  PoissonParams, broadcast_strag_channels,
                                  make_pair_channel_kernel)
from ..solvers.ibm import GaussianKernel, _poison, interpolate_auto, spread_auto
from ..solvers.pencil_ibm import (bin_pencils, interpolate_pencil_fused, pencil_ok,
                                  spread_pencil_fused)

PENCIL_THRESHOLD = 4096  # the JAX package's pencil path threshold


@dataclasses.dataclass(frozen=True)
class Poisson:
    box: Box
    epsilon: float = 1.0  # permittivity
    gw: float = 1.0  # Gaussian charge width
    shape: tuple = ()
    support: int = 12
    box_size: tuple = ()

    @staticmethod
    def create(box: Box, epsilon=1.0, gw=1.0, tolerance=1e-4, support=None,
               prefer_pow2=False) -> "Poisson":
        """Grid sized so h <= gw / max(1, log10(1/tol) / 3), every axis a
        multiple of 8 (the pencil path), as the JAX package sizes it."""
        Ls = [float(s) for s in box.lengths]
        h_target = gw / max(1.0, (math.log10(1.0 / tolerance) / 3.0))
        shape = tuple(
            next_fft_size(max(8, int(math.ceil(L / h_target))), prefer_pow2, pencil_safe=True)
            for L in Ls)
        if support is None:
            support = min(14, int(2 * math.ceil(3.0 * gw / (Ls[0] / shape[0]))) + 2)
        return Poisson(box=box, epsilon=epsilon, gw=gw, shape=shape, support=support,
                       box_size=tuple(Ls))

    def _kernel(self):
        h = self.box_size[0] / self.shape[0]
        return GaussianKernel(sigma=self.gw / h, support=self.support)

    def _spread_interp(self, pos):
        """(spread_fn, interp_fn) sharing one pencil binning for the whole
        solve (kernels #13/#14, NaN-poisoned on a bin overflow), or the
        direct path below the threshold or off pencil-safe grids."""
        if pos.shape[0] >= PENCIL_THRESHOLD and pencil_ok(self.shape, self.support):
            bins = bin_pencils(pos, self.shape, self.box)

            def sp(kern, p, vals):
                f, ovf = spread_pencil_fused(kern, p, vals, self.shape, self.box, bins)
                return _poison(f, ovf)

            def it(kern, p, field):
                v, ovf = interpolate_pencil_fused(kern, p, field, self.box, bins)
                return _poison(v, ovf)

            return sp, it
        return (lambda kern, p, vals: spread_auto(kern, p, vals, self.shape, self.box),
                lambda kern, p, field: interpolate_auto(kern, p, field, self.box))

    def _kspace(self, dtype, device):
        """(kx, ky, kz, 1 / (eps k^2) with 0 at k = 0) on the rfft grid,
        made once per (dtype, device)."""
        key = (dtype, device)
        cache = self.__dict__.setdefault("_kcache", {})
        if key not in cache:
            Ls = self.box_size
            ks = [2.0 * math.pi * torch.fft.fftfreq(n, d=L / n, dtype=torch.float64).to(dtype)
                  for n, L in zip(self.shape[:2], Ls[:2])]
            kz = 2.0 * math.pi * torch.fft.rfftfreq(self.shape[2], d=Ls[2] / self.shape[2],
                                                    dtype=torch.float64).to(dtype)
            kx, ky, kz = (k.to(device) for k in torch.meshgrid(ks[0], ks[1], kz, indexing="ij"))
            k2 = kx * kx + ky * ky + kz * kz
            k2s = torch.where(k2 > 0, k2, torch.ones_like(k2))
            inv = torch.where(k2 > 0, 1.0 / (self.epsilon * k2s), torch.zeros_like(k2))
            cache[key] = (kx, ky, kz, inv)
        return cache[key]

    def fields(self, pos, charge):
        """Return (phi_i, E_i): potential and field at particle positions."""
        kern = self._kernel()
        sp, it = self._spread_interp(pos)
        rho = sp(kern, pos, charge)
        rho_k = torch.fft.rfftn(rho)
        kx, ky, kz, inv = self._kspace(pos.dtype, pos.device)
        phi_k = rho_k * inv
        mi = -1j * phi_k
        # phi, Ex, Ey, Ez in one inverse transform, channel first
        fk = torch.stack([phi_k, kx * mi, ky * mi, kz * mi])
        f = torch.fft.irfftn(fk, s=self.shape, dim=(1, 2, 3))
        out = it(kern, pos, f.permute(1, 2, 3, 0))
        return out[:, 0], out[:, 1:4]

    def sum(self, pos, charge, computables: Computables = Computables()) -> ForceEnergyVirial:
        phi_i, E_i = self.fields(pos, charge)
        force = charge[:, None] * E_i if computables.force else None
        energy = 0.5 * charge * phi_i if computables.energy else None
        return ForceEnergyVirial(force=force, energy=energy)


# ---------------------------------------------------------------------------
# Ewald split mode (reference: SpectralEwaldPoisson.cuh:100 "split" parameter,
# near-field kernels SpectralEwaldPoisson.cu:15-59, :148-159)
# ---------------------------------------------------------------------------


def _erf_np(x):
    from scipy.special import erf

    return erf(x)


def _near_G_np(r, gw, ngw, eps):
    """Near-field Green's function G(r) = [erf(r/2gw) - erf(r/2ngw)]/(4 pi
    eps r) in float64 numpy, with the reference's small-r series
    (SpectralEwaldPoisson.cu:15-35) against the erf cancellation."""
    r = np.asarray(r, np.float64)
    pi32 = math.pi ** 1.5
    gw2 = gw * gw
    n2 = ngw * ngw
    small = r < 0.1 * gw
    rs = np.where(small, 1.0, r)
    G_far = (_erf_np(rs / (2 * gw)) - _erf_np(rs / (2 * ngw))) / (4 * math.pi * eps * rs)
    selfterm = 1.0 / (4 * pi32 * gw) - 1.0 / (4 * pi32 * ngw)
    r2term = 1.0 / (48.0 * pi32) * (1.0 / (n2 * ngw) - 1.0 / (gw2 * gw))
    r4term = 1.0 / (640.0 * pi32) * (1.0 / (gw2 * gw2 * gw) - 1.0 / (n2 * n2 * ngw))
    G_small = (selfterm + r * r * r2term + r**4 * r4term) / eps
    return np.where(small, G_small, G_far)


def _near_g_np(r, gw, ngw, eps):
    """g(r) = G'(r)/r (force on i = q_i q_j g . (r_j - r_i)), float64 numpy
    with the small-r series."""
    r = np.asarray(r, np.float64)
    pi32 = math.pi ** 1.5
    gw2 = gw * gw
    n2 = ngw * ngw
    small = r < 0.1 * gw
    rs = np.where(small, 1.0, r)
    e_diff = _erf_np(rs / (2 * gw)) - _erf_np(rs / (2 * ngw))
    gauss = (np.exp(-rs * rs / (4 * gw2)) / (gw * math.sqrt(math.pi))
             - np.exp(-rs * rs / (4 * n2)) / (ngw * math.sqrt(math.pi)))
    g_far = (gauss / rs - e_diff / (rs * rs)) / (4 * math.pi * eps) / rs
    # series: G = G0 + c2 r^2 + c4 r^4 -> g = G'/r = 2 c2 + 4 c4 r^2
    r2term = 1.0 / (48.0 * pi32) * (1.0 / (n2 * ngw) - 1.0 / (gw2 * gw))
    r4term = 1.0 / (640.0 * pi32) * (1.0 / (gw2 * gw2 * gw) - 1.0 / (n2 * n2 * ngw))
    g_small = (2.0 * r2term + 4.0 * r4term * r * r) / eps
    return np.where(small, g_small, g_far)


@dataclasses.dataclass(frozen=True)
class PoissonSplit:
    """Ewald-split triply periodic Poisson: the spectral far field of
    widened Gaussian charges plus the grid-resident near-field correction
    (the reference's split mode, SpectralEwaldPoisson.cuh:100)."""

    far: Poisson
    gw: float
    split: float
    ngw: float
    epsilon: float
    near: "GaussianNearField"

    @property
    def rcut(self) -> float:
        return self.near.rcut

    @property
    def fit_error(self) -> float:
        return self.near.fit_error

    @property
    def spec(self):
        return self.near.spec

    @staticmethod
    def create(box: Box, n: int, epsilon=1.0, gw=1.0, split=1.0, tolerance=1e-4,
               support=None, prefer_pow2=False, deg=20, pos=None, n_strag: int = 0,
               cap=None) -> "PoissonSplit":
        Ls = [float(s) for s in box.lengths]
        ngw = math.sqrt(gw * gw + 1.0 / (4.0 * split * split))
        far = Poisson.create(box, epsilon=epsilon, gw=ngw, tolerance=tolerance,
                             support=support, prefer_pow2=prefer_pow2)
        rcut = min(near_cutoff(ngw, tolerance), 0.45 * min(Ls))
        near = GaussianNearField.create(tuple(Ls), n, gw=gw, ngw=ngw, epsilon=epsilon,
                                        rcut=rcut, deg=deg, pos=pos, n_strag=n_strag, cap=cap)
        return PoissonSplit(far=far, gw=gw, split=split, ngw=ngw, epsilon=epsilon, near=near)

    def sum(self, pos, charge, computables: Computables = Computables()) -> ForceEnergyVirial:
        """Far (widened spectral) + near (grid-resident correction) + the
        near self-energy."""
        fev = self.far.sum(pos, charge, computables)
        nf = self.near.apply(pos, charge)
        force = energy = None
        if computables.force:
            force = (fev.force if fev.force is not None else 0.0) + charge[:, None] * nf[:, :3]
        if computables.energy:
            self_e = (0.5 * self.near.self_G) * charge * charge
            energy = ((fev.energy if fev.energy is not None else 0.0)
                      + (0.5 * charge * nf[:, 3] + self_e))
        return ForceEnergyVirial(force=force, energy=energy)


def near_cutoff(ngw: float, tolerance: float) -> float:
    """Near-field cutoff: the Gaussian envelope exp(-r^2/(4 ngw^2)) <= tol."""
    return 2.0 * ngw * math.sqrt(max(math.log(1.0 / tolerance), 1.0))


class PoissonNear(ChannelFunctor):
    """``GaussianNearField._pair_fn`` (poisson.py:350-384) as a functor of
    the channel kernel #2: one channel (the charge q), four sums out
    (sum_j q_j g(r) d, sum_j q_j G(r)), with the straggler block. For
    1e-10 < r2 < rc2: q = (r2 rsqrt(r2)) / rcut, piece 1 if q < qb else
    piece 2, u = a q + b of the piece, g and G by Horner in u. Calling it
    is the plain version (float32, as the JAX pair_fn); the CUDA
    instantiation reads ``params()`` (coefficients zero-padded to degree
    20 at the top, which leaves every Horner step exact)."""

    n_chan, n_out, strag = 1, 4, True
    kernel = PAIR_CHANNEL_POISSON

    def __init__(self, rcut: float, qb: float, e_coef, g_coef, uscale):
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        self.rc2 = f32(rcut * rcut)
        self.inv_rcut = f32(1.0 / rcut)
        self.qb = f32(qb)
        (self.a1, self.b1), (self.a2, self.b2) = ((f32(a), f32(b)) for a, b in uscale)
        self.coef = []  # e1, e2, g1, g2 as float32 values, lowest degree first
        for cs in (*e_coef, *g_coef):
            if len(cs) > POISSON_NCOEF:
                raise ValueError(f"degree {len(cs) - 1} is above the kernel's "
                                 f"{POISSON_NCOEF - 1}")
            self.coef.append([f32(c) for c in cs])

    def reach(self, hs: float = 0.0) -> float:
        return math.sqrt(self.rc2)

    def params(self) -> PoissonParams:
        p = PoissonParams()
        p.c[:] = [c for cs in self.coef for c in cs + [0.0] * (POISSON_NCOEF - len(cs))]
        p.a1, p.b1, p.a2, p.b2 = self.a1, self.b1, self.a2, self.b2
        p.qb, p.rc2, p.inv_rcut = self.qb, self.rc2, self.inv_rcut
        return p

    def __call__(self, r2, dxv, dyv, dzv, ch_i, ch_j):
        (qj,) = ch_j
        e1, e2, g1, g2 = self.coef
        inside = (r2 < self.rc2) & (r2 > 1e-10)
        r2s = torch.where(inside, r2, torch.ones_like(r2))
        rinv = torch.rsqrt(r2s)
        q = r2s * rinv * self.inv_rcut
        near = q < self.qb
        u1 = self.a1 * q + self.b1
        u2 = self.a2 * q + self.b2

        def horner(cs, u):
            acc = torch.full_like(u, cs[-1])
            for c in cs[-2::-1]:
                acc = acc * u + c
            return acc

        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        g = torch.where(inside, torch.where(near, horner(g1, u1), horner(g2, u2)), zero) * qj
        e = torch.where(inside, torch.where(near, horner(e1, u1), horner(e2, u2)), zero) * qj
        return g * dxv, g * dyv, g * dzv, e


@dataclasses.dataclass(frozen=True)
class GaussianNearField:
    """Short-range Gaussian-difference correction of the split Poisson
    solver (SpectralEwaldPoisson.cu:15-59). ``apply(pos, charge)`` returns
    [N, 4]: (sum_j q_j g(r) dr, sum_j q_j G(r)), field-like sums the caller
    turns into forces (x q_i) and energies (x q_i / 2, plus 0.5 q_i^2
    self_G). The overflow flag of the last ``apply``'s packing (a 0-d bool
    tensor, which the JAX package drops) is kept in ``last_overflow``."""

    gw: float
    ngw: float
    epsilon: float
    rcut: float
    spec: object  # engine GridSpec
    qb: float  # piece boundary in q = r / rcut
    e_coef: tuple  # (piece1, piece2) polynomial coefficients of G
    g_coef: tuple  # (piece1, piece2) of G'(r)/r
    uscale: tuple  # per-piece (a, b): u = a q + b maps the piece to [-1, 1]
    self_G: float
    fit_error: float

    @staticmethod
    def create(box_size, n: int, *, gw, ngw, epsilon=1.0, rcut, deg=20, pos=None,
               n_strag: int = 0, cap=None) -> "GaussianNearField":
        Ls = [float(s) for s in box_size]
        spec = choose_spec_near(Ls, n, rcut, cap=cap, pos=pos, n_strag=n_strag)
        # two-piece Chebyshev fits over q = r/rcut: piece 1 on [0, qb], piece
        # 2 on [qb, 1], power coefficients in the centred u
        qb = min(4.0 * gw / rcut, 0.5)
        coefs = []
        scales = []
        fit_err = 0.0
        scale0 = abs(_near_G_np(np.asarray([0.0]), gw, ngw, epsilon)[0])
        for lo, hi in ((1e-7, qb), (qb, 1.0)):
            q = np.linspace(lo, hi, 2500)
            r = q * rcut
            u = (2.0 * q - hi - lo) / (hi - lo)
            for y, sc in ((_near_G_np(r, gw, ngw, epsilon), scale0),
                          (_near_g_np(r, gw, ngw, epsilon), None)):
                ch = np.polynomial.chebyshev.Chebyshev.fit(u, y, deg, domain=[-1, 1])
                p = np.polynomial.chebyshev.cheb2poly(ch.coef)
                resid = np.abs(np.polynomial.polynomial.polyval(u, p) - y)
                fit_err = max(fit_err, float(
                    resid.max() / (sc if sc else max(np.abs(y).max(), 1e-300))))
                coefs.append(tuple(float(c) for c in p))
            scales.append((2.0 / (hi - lo), -(hi + lo) / (hi - lo)))
        self_G = float(_near_G_np(np.asarray([0.0]), gw, ngw, epsilon)[0])
        # collected (e1, g1, e2, g2) -> stored (e1, e2, g1, g2)
        return GaussianNearField(
            gw=gw, ngw=ngw, epsilon=epsilon, rcut=float(rcut), spec=spec, qb=float(qb),
            e_coef=(coefs[0], coefs[2]), g_coef=(coefs[1], coefs[3]),
            uscale=tuple(scales), self_G=self_G, fit_error=fit_err,
        )

    def apply(self, pos, charge):
        cg = pack_channels(self.spec, pos, charge[:, None])
        self.__dict__["last_overflow"] = cg.overflow
        kern = self._kernel()
        if self.spec.n_strag:
            blk = broadcast_strag_channels(self.spec, cg.spos, cg.schannels, cg.spid)
            outs = kern(cg.x, cg.y, cg.z, *cg.channels, strag=blk)
            # the straggler-straggler pairs in plain torch, as the JAX package
            ss = self._strag_pairs(cg.spos, cg.spid, cg.schannels[0])
            svals = tuple(s + e for s, e in zip(outs[4:8], ss))
            near = unpack_values(cg, outs[:4], svalues=svals)
        else:
            near = unpack_values(cg, kern(cg.x, cg.y, cg.z, *cg.channels)[:4])
        return near.to(pos.dtype)

    def pair_fn(self) -> PoissonNear:
        """The pair functor (``_pair_fn`` of the JAX package)."""
        fn = self.__dict__.get("_pair")
        if fn is None:
            fn = PoissonNear(self.rcut, self.qb, self.e_coef, self.g_coef, self.uscale)
            self.__dict__["_pair"] = fn
        return fn

    def _kernel(self):
        kern = self.__dict__.get("_kern")
        if kern is None:
            kern = make_pair_channel_kernel(self.spec, self.pair_fn())
            self.__dict__["_kern"] = kern
        return kern

    def _strag_pairs(self, spos, spid, sq):
        """The [S] straggler rows against each other (O(S^2), plain torch):
        the minimum image's shift taken off the partner's coordinate before
        the difference, as for a grid candidate of an image cell
        (``pse_near.strag_channel_block``); the self pair and empty rows
        pushed to r2 = 1e18."""
        pair_fn = self.pair_fn()
        Ls = torch.tensor(self.spec.box_size, dtype=torch.float32, device=spos.device)
        val = spid >= 0
        sj, si = spos[None, :, :], spos[:, None, :]
        d = (sj - Ls * torch.round((sj - si) / Ls)) - si
        r2 = torch.sum(d * d, dim=-1)
        eye = torch.eye(spos.shape[0], dtype=torch.bool, device=spos.device)
        ok = val[None, :] & val[:, None] & ~eye
        r2m = torch.where(ok, r2, torch.full_like(r2, 1.0e18))[:, :, None]
        out = pair_fn(r2m, d[:, :, 0:1], d[:, :, 1:2], d[:, :, 2:3],
                      (sq[:, None, None],), (sq[None, :, None],))
        return tuple(torch.sum(o, dim=1)[:, 0] for o in out)


def choose_spec_near(Ls, n, rcut, cap=None, pos=None, n_strag=0):
    """The near grid: cells of at least rcut (skin 1), the straggler list
    sized with headroom 1.5 and no per-cell bound (the JAX package's)."""
    return choose_spec(Ls, n, rcut, skin=1.0, cap=cap, pos=pos, n_strag=n_strag,
                       strag_cell_excess=1 << 30, strag_headroom=1.5, ocap=None)


def pair_potential_theory(r, gw, epsilon=1.0):
    """erf(r/(2 gw)) / (4 pi eps r): the exact interaction of two Gaussian
    charges of width gw (SpectralEwaldPoisson.cuh:25)."""
    r = torch.as_tensor(r)
    return torch.special.erf(r / (2.0 * gw)) / (4.0 * math.pi * epsilon * r)
