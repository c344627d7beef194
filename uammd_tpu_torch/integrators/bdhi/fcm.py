"""Force Coupling Method: spectral Stokes mobility on a periodic grid.

Port of ``uammd_tpu/integrators/bdhi/fcm.py`` (reference:
src/Integrator/BDHI/FCM/FCM_impl.cuh:36-693). Forces are spread with a
Gaussian envelope of width sigma = a / sqrt(pi) (or an h-locked Peskin or
ES kernel), the periodic Stokes problem is solved in Fourier space with
the transverse projector

    u(k) = (1 / (eta k^2)) (I - k^ k^) f(k),    u(0) = 0

and the grid velocity is interpolated back at the particles. Brownian
increments are sqrt(B) dW with white noise drawn directly in wave space
(``_sample_white_rfft``). FFTs are ``torch.fft.rfftn``/``irfftn`` (cuFFT
on the card) over the first three axes of channel-last [nx, ny, nz, 3]
fields, the JAX package's layout.

Spread and interpolation go through ``_spread_interp``: with pencil bins
(N >= 4096 on a pencil-safe grid) the pencil kernels #13/#14 of
``solvers/pencil_ibm.py`` (CUDA on the card, their plain versions on CPU
tensors), else the direct path. The wave-space factors are made once per
(grid, dtype, device) and kept (``_kspace_factors``). Torques
(``compute_hydrodynamic_displacements``, ``compute_mf_bdw_torques``)
enter as (i/2) k x tau(k), spread with the rotlet Gaussian
(``sigma_torque``) on the same pencil bins as the forces, and the angular
velocity is (1/2) curl u, interpolated with the same Gaussian
(FCM_impl.cuh:654-693).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ...core.box import Box
from ...core.grid import next_fft_size
from ...solvers.ibm import (
    PHI_BM,
    GaussianKernel,
    Peskin3pt,
    Peskin4pt,
    _poison,
    interpolate_auto,
    spread_auto,
)
from ...solvers.pencil_ibm import (
    bin_pencils,
    default_cap,
    interpolate_pencil_fused,
    pencil_ok,
    spread_pencil_fused,
)

# Effective hydrodynamic radius of the h-locked IBM kernels, in grid
# spacings, as measured on the JAX package's collocated solver
# (tests/test_fcm_accuracy_ladder.py).
PESKIN_RADIUS_PER_H = {"peskin3pt": 0.990, "peskin4pt": 1.311}

_BM_NORM_CACHE: dict = {}


def _bm_norm(beta: float, support: int) -> float:
    """Continuous integral of the un-normalised ES window over its support
    (in units of h); dividing by it makes spreading conserve the spread
    quantity."""
    key = (float(beta), int(support))
    if key not in _BM_NORM_CACHE:
        xs = np.linspace(-1.0, 1.0, 4001)
        val = np.exp(beta * (np.sqrt(np.maximum(1.0 - xs * xs, 0.0)) - 1.0))
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        _BM_NORM_CACHE[key] = float(trapezoid(val, xs) * support / 2.0)
    return _BM_NORM_CACHE[key]


@dataclasses.dataclass(frozen=True)
class _NormalizedBM:
    """BMKernel (solvers/ibm.py) with unit-sum normalisation for FCM use."""

    beta: float
    support: int = 6

    def phi(self, r):
        x = 2.0 * r / float(self.support)
        inside = torch.abs(x) < 1.0
        xs = torch.where(inside, x, 0.0)
        val = torch.exp(self.beta * (torch.sqrt(1.0 - xs * xs) - 1.0))
        return torch.where(inside, val, 0.0) / _bm_norm(self.beta, float(self.support))

    @property
    def device_phi(self):
        return (PHI_BM, float(self.beta), 1.0 / _bm_norm(self.beta, float(self.support)))


def _wavevectors(shape, box_size, dtype=torch.float32, device=None):
    """kx [nx, 1, 1], ky [1, ny, 1], kz [1, 1, nz//2 + 1]: the JAX
    package's meshgrid, as broadcastable factors."""
    kx, ky = (2.0 * math.pi * torch.fft.fftfreq(n, d=L / n, dtype=torch.float64)
              for n, L in zip(shape[:2], box_size[:2]))
    kz = 2.0 * math.pi * torch.fft.rfftfreq(shape[2], d=box_size[2] / shape[2],
                                            dtype=torch.float64)
    return (kx.to(dtype).reshape(-1, 1, 1).to(device), ky.to(dtype).reshape(1, -1, 1).to(device),
            kz.to(dtype).reshape(1, 1, -1).to(device))


def _sample_white_rfft(gen, shape, dV, dtype=torch.float32, device=None):
    """Draw rfftn(w) directly in wave space, equal in distribution to the
    transform of real white noise w ~ N(0, 1/dV) iid on the grid:

    - interior kz modes are free complex Gaussians with total variance
      Ngrid / dV;
    - the self-conjugate planes kz = 0 and, for even nz, kz = nz/2 are
      symmetrised c -> (c(k) + conj(c(-k))) / sqrt(2), exactly Hermitian
      under (kx, ky) -> (-kx, -ky) with the right variance everywhere.

    Returns [nx, ny, nz//2 + 1, 3] complex, drawn from ``gen``.
    """
    nx, ny, nz = shape
    nzr = nz // 2 + 1
    std = math.sqrt(nx * ny * nz / (2.0 * dV))
    # stored channel first, as torch.fft lays out the force spectrum
    re_im = torch.empty((3, nx, ny, nzr, 2), dtype=dtype, device=device)
    wk = torch.view_as_complex(re_im.normal_(0.0, std, generator=gen)).permute(1, 2, 3, 0)
    half = 1.0 / math.sqrt(2.0)
    for zp in [0] + ([nz // 2] if nz % 2 == 0 else []):
        c = wk[:, :, zp]
        cf = torch.roll(torch.flip(c, dims=(0, 1)), shifts=(1, 1), dims=(0, 1))
        wk[:, :, zp] = (c + torch.conj(cf)) * half
    return wk


@functools.lru_cache(maxsize=4)
def _kspace_factors(shape, box_size, viscosity, rpy_sinc_radius, hasimoto_k2, dtype, device):
    """Wave-space factors of one grid, made once: the wave vectors, 1/k^2,
    the mobility scale env2 / (eta k^2) and the noise scale
    sqrt(env2 / (eta k^2)), each 0 at k = 0."""
    kx, ky, kz = _wavevectors(shape, box_size, torch.float64, device)
    k2 = kx * kx + ky * ky + kz * kz
    k2s = torch.where(k2 > 0, k2, 1.0)
    env2 = _envelope2(rpy_sinc_radius, hasimoto_k2, k2)
    zero = k2 == 0
    inv_k2 = torch.where(zero, 0.0, 1.0 / k2s)
    mob = torch.where(zero, 0.0, env2 / (viscosity * k2s))
    noise = torch.where(zero, 0.0, torch.sqrt(env2 / (viscosity * k2s)))
    return tuple(t.to(dtype).contiguous() for t in (kx, ky, kz, inv_k2, mob, noise))


def _envelope2(rpy_sinc_radius, hasimoto_k2, k2):
    """sinc^2(k a) (1 + sigma_split^2 k^2), or 1 when both are off."""
    out = torch.ones_like(k2)
    if rpy_sinc_radius is not None:
        x = torch.sqrt(k2) * rpy_sinc_radius
        xs = torch.where(x > 1e-8, x, 1.0)
        sc = torch.where(x > 1e-8, torch.sin(xs) / xs, 1.0 - x * x / 6.0)
        out = out * (sc * sc)
    if hasimoto_k2 is not None:
        out = out * (1.0 + hasimoto_k2 * k2)
    return out


def _project(g, kx, ky, kz, inv_k2):
    """(I - k^ k^) g for g [nx, ny, nzr, 3] complex, in place."""
    t = (kx * g[..., 0] + ky * g[..., 1] + kz * g[..., 2]) * inv_k2
    for c, k in enumerate((kx, ky, kz)):
        g[..., c] -= k * t
    return g


@dataclasses.dataclass(frozen=True)
class FCM:
    """Spectral FCM mobility backend (plugs into bdhi_euler_maruyama and
    fcm_em). Grid spacing h <= a sqrt(pi) / 3 gives ~3-digit
    self-mobility with the truncated Gaussian."""

    box: Box
    viscosity: float = 1.0
    radius: float = 1.0
    shape: tuple = ()
    support: int = 12
    box_size: tuple = ()
    rpy_sinc_radius: float | None = None
    hasimoto_k2: float | None = None
    kernel: str = "gaussian"
    bm_beta: float | None = None

    @staticmethod
    def create(box: Box, viscosity=1.0, radius=1.0, points_per_radius=3.0, support=12,
               prefer_pow2=False, rpy_sinc_radius=None, hasimoto_k2=None,
               kernel="gaussian", bm_beta=None):
        Ls = list(box.lengths)
        common = dict(box=box, viscosity=viscosity, radius=radius, box_size=tuple(Ls),
                      rpy_sinc_radius=rpy_sinc_radius, hasimoto_k2=hasimoto_k2)
        if kernel in PESKIN_RADIUS_PER_H:
            # h-locked kernels: the radius picks h; the support is the kernel's
            h = radius / PESKIN_RADIUS_PER_H[kernel]
            shape = tuple(next_fft_size(max(8, int(math.ceil(L / h))), prefer_pow2,
                                        tile_safe_support=4, pencil_safe=True) for L in Ls)
            return FCM(shape=shape, support=3 if kernel == "peskin3pt" else 4,
                       kernel=kernel, **common)
        nominal = [max(8, int(math.ceil(L * points_per_radius / radius))) for L in Ls]
        shape = tuple(next_fft_size(n0, prefer_pow2,
                                    tile_safe_support=support if support <= 8 else None,
                                    pencil_safe=support <= 16) for n0 in nominal)
        if kernel == "bm":
            return FCM(shape=shape, support=support, kernel="bm",
                       bm_beta=float(bm_beta) if bm_beta is not None else 1.3267 * support,
                       **common)
        assert kernel == "gaussian", f"unknown FCM kernel {kernel!r}"
        # when FFT-friendliness rounds the grid up (finer h), scale the
        # support so the Gaussian is cut at the same physical radius
        ratio = max(n / n0 for n, n0 in zip(shape, nominal))
        support = int(2 * math.ceil(support * ratio / 2.0))
        return FCM(shape=shape, support=support, **common)

    @property
    def sigma(self) -> float:
        return self.radius / math.sqrt(math.pi)

    @property
    def sigma_torque(self) -> float:
        """Rotlet Gaussian width a / (6 sqrt(pi))^(1/3): the rotational
        self-mobility is then 1/(8 pi eta a^3) (FCM_kernels.cuh's torque
        kernel; Lomholt & Maxey)."""
        return self.radius / (6.0 * math.sqrt(math.pi)) ** (1.0 / 3.0)

    @property
    def dV(self) -> float:
        return float(np.prod(np.asarray(self.box_size)) / np.prod(self.shape))

    def _kernel(self, dtype=torch.float32):
        if self.kernel == "peskin3pt":
            return Peskin3pt()
        if self.kernel == "peskin4pt":
            return Peskin4pt()
        if self.kernel == "bm":
            return _NormalizedBM(beta=self.bm_beta, support=self.support)
        h = self.box_size[0] / self.shape[0]
        return GaussianKernel(sigma=self.sigma / h, support=self.support)

    def _kernel_torque(self, dtype=torch.float32):
        if self.kernel != "gaussian":
            raise NotImplementedError(
                "torque coupling needs the Gaussian rotlet envelope; "
                f"kernel={self.kernel!r} supports forces only (the reference limits the "
                "non-Gaussian FCM kernels the same way, FCM_kernels.cuh)")
        h = self.box_size[0] / self.shape[0]
        return GaussianKernel(sigma=self.sigma_torque / h, support=self.support)

    def _kspace(self, dtype, device):
        return _kspace_factors(tuple(self.shape), tuple(self.box_size), float(self.viscosity),
                       self.rpy_sinc_radius, self.hasimoto_k2, dtype, device)

    def pencil_bins(self, pos, slack: int = 0, cap_extra: int = 0):
        """Pencil bins for this grid, or None when the pencil path does not
        apply (N < 4096 or a pencil-unsafe grid). With ``slack`` > 0 they
        stay exact for up to slack * h of x/y drift; ``cap_extra`` adds
        rows to the per-pencil capacity."""
        if pos.shape[0] >= 4096 and pencil_ok(self.shape, self.support, slack):
            cap = None
            if cap_extra:
                cap = default_cap(pos.shape[0], self.shape) + int(cap_extra)
            return bin_pencils(pos, self.shape, self.box, cap=cap)
        return None

    def _spread_interp(self, pos, bins=None, slack: int = 0):
        """(spread_fn, interp_fn) sharing one pencil binning across a
        spectral pass: kernels #13/#14 (or, on CPU tensors, their plain
        versions), each NaN-poisoned by an overflow; the direct path when
        the pencil path does not apply. Pass persistent ``bins`` (from
        pencil_bins) to skip the per-call binning."""
        if bins is None:
            slack = 0
            bins = self.pencil_bins(pos)
        if bins is not None:
            def sp(kern, p, vals):
                f, ovf = spread_pencil_fused(kern, p, vals, self.shape, self.box, bins,
                                             slack=slack)
                return _poison(f, ovf)

            def it(kern, p, field):
                v, ovf = interpolate_pencil_fused(kern, p, field, self.box, bins, slack=slack)
                return _poison(v, ovf)

            return sp, it
        return (lambda kern, p, vals: spread_auto(kern, p, vals, self.shape, self.box),
                lambda kern, p, field: interpolate_auto(kern, p, field, self.box))

    def _mobility_k(self, fk, pos):
        """u(k) = env2 (I - k^k^) f(k) / (eta k^2), in place on fk."""
        kx, ky, kz, inv_k2, mob, _ = self._kspace(pos.dtype, pos.device)
        return _project(fk.mul_(mob[..., None]), kx, ky, kz, inv_k2)

    def _irfftn(self, uk):
        return torch.fft.irfftn(uk, s=self.shape, dim=(0, 1, 2))

    def grid_velocity(self, pos, forces):
        kern = self._kernel(pos.dtype)
        f_grid = spread_auto(kern, pos, forces, self.shape, self.box)
        fk = torch.fft.rfftn(f_grid, dim=(0, 1, 2))
        return self._irfftn(self._mobility_k(fk, pos)), kern

    def compute_mf(self, pos, forces, bins=None, slack: int = 0):
        """M F: one spread, one transform pair, one interpolation."""
        sp, it = self._spread_interp(pos, bins, slack)
        kern = self._kernel(pos.dtype)
        fk = torch.fft.rfftn(sp(kern, pos, forces), dim=(0, 1, 2))
        return it(kern, pos, self._irfftn(self._mobility_k(fk, pos)))

    def _kspace_combine(self, fk, wk, noise_amp, pos):
        """(I - k^k^) [env2 f(k) / (eta k^2) + noise_amp sqrt(env2 / (eta
        k^2)) w(k)]: the JAX package's mobility and noise terms, added
        before one shared projection (the projector is linear). In place
        on fk."""
        kx, ky, kz, inv_k2, mob, noise = self._kspace(pos.dtype, pos.device)
        g = fk.mul_(mob[..., None])
        g += wk.mul_((noise_amp * noise)[..., None])
        return _project(g, kx, ky, kz, inv_k2)

    def compute_mf_bdw(self, pos, forces, gen, noise_amp, bins=None, slack: int = 0):
        """M F + noise_amp * B^(1/2) dW in one spectral pass: one spread,
        one k-space combine with the noise drawn from ``gen`` in wave space,
        one inverse transform, one interpolation (reference:
        FCM_impl.cuh:654-693 with addBrownianNoise :437)."""
        kern = self._kernel(pos.dtype)
        sp, it = self._spread_interp(pos, bins, slack)
        fk = torch.fft.rfftn(sp(kern, pos, forces), dim=(0, 1, 2))
        wk = _sample_white_rfft(gen, self.shape, self.dV, pos.dtype, pos.device)
        return it(kern, pos, self._irfftn(self._kspace_combine(fk, wk, noise_amp, pos)))

    def _curl_half(self, gk, pos):
        """(i/2) k x g(k) for g [nx, ny, nzr, 3] complex."""
        kx, ky, kz = self._kspace(pos.dtype, pos.device)[:3]
        return 0.5j * torch.stack([ky * gk[..., 2] - kz * gk[..., 1],
                                   kz * gk[..., 0] - kx * gk[..., 2],
                                   kx * gk[..., 1] - ky * gk[..., 0]], dim=-1)

    def _torque_pass(self, pos, forces, torques, gen=None, noise_amp=0.0):
        """(v, omega) from one spectral pass: forces spread with the
        monopole Gaussian and torques with the rotlet one, on one shared
        binning; (i/2) k x tau(k) added to f(k); the mobility (and, with
        ``noise_amp``, noise drawn from ``gen``) applied; u interpolated with
        the monopole kernel and (1/2) curl u with the rotlet kernel."""
        kern = self._kernel(pos.dtype)
        kern_t = self._kernel_torque(pos.dtype)
        sp, it = self._spread_interp(pos)
        fk = torch.fft.rfftn(sp(kern, pos, forces), dim=(0, 1, 2))
        if torques is not None:
            tk = torch.fft.rfftn(sp(kern_t, pos, torques), dim=(0, 1, 2))
            fk = fk + self._curl_half(tk, pos)
        if noise_amp:
            wk = _sample_white_rfft(gen, self.shape, self.dV, pos.dtype, pos.device)
            uk = self._kspace_combine(fk, wk, noise_amp, pos)
        else:
            uk = self._mobility_k(fk, pos)
        omega = None
        if torques is not None:
            omega = it(kern_t, pos, self._irfftn(self._curl_half(uk, pos)))
        return it(kern, pos, self._irfftn(uk)), omega

    def compute_hydrodynamic_displacements(self, pos, forces, torques=None):
        """Linear and, with ``torques``, angular velocities (v, omega or
        None): the reference's curl construction (FCM_impl.cuh:670
        addSpreadTorquesFourier and the angular interpolation)."""
        return self._torque_pass(pos, forces, torques)

    def compute_mf_bdw_torques(self, pos, forces, torques, gen, noise_amp):
        """M [F; T] + noise_amp sqrt(M) dW for the coupled translation-
        rotation grid mobility in one spectral pass: the fluctuating grid
        velocity is interpolated with the monopole kernel (v) and through
        the half curl with the rotlet kernel (omega), so
        fluctuation-dissipation holds jointly (FCM_impl.cuh:654-693)."""
        return self._torque_pass(pos, forces, torques, gen, noise_amp)

    def compute_bdw(self, pos, gen):
        """sqrt(M) dW: white noise filtered through sqrt(B(k)) = (I - k^k^)
        sqrt(env2 / eta) / k (the projector is its own square root)."""
        kx, ky, kz, inv_k2, _, noise = self._kspace(pos.dtype, pos.device)
        wk = _sample_white_rfft(gen, self.shape, self.dV, pos.dtype, pos.device)
        bk = _project(wk.mul_(noise[..., None]), kx, ky, kz, inv_k2)
        _, it = self._spread_interp(pos)
        return it(self._kernel(pos.dtype), pos, self._irfftn(bk))

    def divergence(self, pos):
        return torch.zeros_like(pos)
