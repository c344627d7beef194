"""Sharded spectral FCM: an x-slab-sharded grid and a distributed FFT.

Port of ``uammd_tpu/parallel/spectral.py``: ``shard_particles_x``,
``gather_shards`` and ``make_sharded_fcm_mf`` (:39-282), the far field of
the composed multi-shard PSE steps (``pse_dd.py``, ``pse_dd2.py``). Each
shard of a ``parallel.mesh.Mesh`` owns the x-slab [nx_loc, ny, nz] of the
grid and the particles whose x falls in it:

- spread: a scatter-add (``index_add_``) of the local particles onto the
  slab extended by P = support planes at each end, then one ``ppermute``
  pair adds the pad planes into the neighbours' interiors;
- the distributed FFT: rfft(z) and fft(y) on the slab, kz padded to a
  multiple of the mesh size (``nzr_pad``), one ``all_to_all`` (kz split,
  x gathered), fft(x), the Stokes projector with the PSE envelope on the
  shard's kz chunk, and the mirror image back;
- interpolation: the velocity slab extended by P planes from each
  neighbour (``ppermute``), gathered at the local particles.

JAX computes all of it without Pallas, so it is ``index_add_``,
``torch.fft`` and indexing here, with no hand kernel (on the card cuFFT).
A shard's arrays match JAX's slot for slot, the kz pad included.

With ``noise=True`` the k-space fluctuation rides the same transform: the
caller's per-shard white noise [nx_loc, ny, nz, 3] (N(0, 1) draws, scaled
here by 1 / sqrt(dV)) is transformed beside the spread forces, filtered by
sqrt of the mobility and added before the inverse transform. JAX draws it
from ``fold_in(key, shard)``; ``ShardedFCM.draw`` takes a
``torch.Generator``, and ``__call__`` takes the draws themselves (the
``_z`` form), so a test can feed JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.box import Box
from ..solvers.ibm import GaussianKernel, _weights_and_indices
from .mesh import Mesh, all_to_all, perm_dn, perm_up, ppermute


def shard_particles_x(pos, values, n_dev: int, box: Box):
    """Assign particles to x-slabs (host side, off the hot path): returns
    (pos_sh [D, m, 3], val_sh [D, m, C], mask [D, m], order [D, m]
    original indices), m padded to the fullest shard, as tensors on
    ``pos``'s device (numpy input: the CPU)."""
    dev = pos.device if torch.is_tensor(pos) else torch.device("cpu")
    pos = pos.detach().cpu().numpy() if torch.is_tensor(pos) else np.asarray(pos)
    values = values.detach().cpu().numpy() if torch.is_tensor(values) else np.asarray(values)
    L = box.lengths[0]
    x = np.mod(pos[:, 0] / L + 0.5, 1.0)
    owner = np.clip((x * n_dev).astype(int), 0, n_dev - 1)
    m = max(int(np.bincount(owner, minlength=n_dev).max()), 1)
    pos_sh = np.zeros((n_dev, m, 3), pos.dtype)
    val_sh = np.zeros((n_dev, m) + values.shape[1:], values.dtype)
    mask = np.zeros((n_dev, m), bool)
    order = np.zeros((n_dev, m), np.int64)
    for d in range(n_dev):
        idx = np.nonzero(owner == d)[0]
        pos_sh[d, : len(idx)] = pos[idx]
        val_sh[d, : len(idx)] = values[idx]
        mask[d, : len(idx)] = True
        order[d, : len(idx)] = idx
    return tuple(torch.from_numpy(a).to(dev) for a in (pos_sh, val_sh, mask, order))


def gather_shards(out_sh, mask, order, n: int) -> torch.Tensor:
    """Inverse of ``shard_particles_x`` for per-particle outputs (a [D, m,
    ...] tensor or a list of per-shard tensors)."""
    if not torch.is_tensor(out_sh):
        out_sh = torch.stack([o.to(mask.device) for o in out_sh])
    out = torch.zeros((n,) + tuple(out_sh.shape[2:]), dtype=out_sh.dtype, device=mask.device)
    out[order[mask]] = out_sh[mask]
    return out


class ShardedFCM:
    """``mf(pos_sh, force_sh, mask[, noise, noise_amp]) -> vel_sh``: the FCM
    M F product (with the PSE envelope when ``rpy_sinc_radius`` /
    ``hasimoto_k2`` are set) with the grid x-sharded over ``mesh``. The
    per-shard inputs are indexable by shard (a [D, m, ...] tensor or a
    list of [m, ...] tensors, shard i on ``mesh.devices[i]``); the result is
    a list of [m, 3] velocities. With ``noise`` (built with noise=True)
    ``noise`` is the list of per-shard N(0, 1) draws [nx_loc, ny, nz, 3]
    and ``noise_amp`` their amplitude (a host number)."""

    def __init__(self, mesh: Mesh, box: Box, *, viscosity: float = 1.0, radius: float = 1.0,
                 shape: tuple, support: int = 6, rpy_sinc_radius: float | None = None,
                 hasimoto_k2: float | None = None, noise: bool = False):
        D = mesh.size
        nx, ny, nz = shape
        if nx % D:
            raise ValueError(f"shape[0] {nx} must divide the {D}-shard mesh")
        nx_loc = nx // D
        if support > nx_loc:
            raise ValueError(f"slab of {nx_loc} planes thinner than the kernel support {support}")
        self.mesh = mesh
        self.box = box
        self.shape = tuple(int(s) for s in shape)
        self.viscosity = float(viscosity)
        self.noise = bool(noise)
        self.nx_loc = nx_loc
        self.pad = support
        Ls = list(box.lengths)
        self.kern = GaussianKernel(sigma=radius / math.sqrt(math.pi) / (Ls[0] / nx),
                                   support=support)
        self.nzr = nz // 2 + 1
        self.nzr_pad = -(-self.nzr // D) * D
        self.kz_chunk = self.nzr_pad // D
        self.dV = float(np.prod([L / s for L, s in zip(Ls, shape)]))
        kzf = np.zeros(self.nzr_pad)
        kzf[: self.nzr] = 2.0 * math.pi * np.fft.rfftfreq(nz, d=Ls[2] / nz)
        kz_valid = np.zeros(self.nzr_pad, bool)
        kz_valid[: self.nzr] = True
        self._k_np = (2.0 * math.pi * np.fft.fftfreq(nx, d=Ls[0] / nx),
                      2.0 * math.pi * np.fft.fftfreq(ny, d=Ls[1] / ny), kzf, kz_valid)
        self.rpy_sinc_radius = rpy_sinc_radius
        self.hasimoto_k2 = hasimoto_k2
        self._kcache: dict = {}

    # ------------------------------------------------------------ k space
    def _kspace(self, i: int, dtype, device):
        """Shard i's wave-space factors on its kz chunk, in ``dtype`` as JAX
        computes them (kx, ky, kz, 1/k2s, the mobility scale and, with
        noise, the noise scale over sqrt(amp)), made once."""
        key = (i, dtype, device)
        if key not in self._kcache:
            kxf, kyf, kzf, kz_valid = self._k_np
            c0 = i * self.kz_chunk
            kx = torch.as_tensor(kxf, dtype=dtype, device=device)[:, None, None]
            ky = torch.as_tensor(kyf, dtype=dtype, device=device)[None, :, None]
            kz = torch.as_tensor(kzf[c0:c0 + self.kz_chunk], dtype=dtype,
                                 device=device)[None, None, :]
            valid = torch.as_tensor(kz_valid[c0:c0 + self.kz_chunk],
                                    device=device)[None, None, :]
            k2 = kx * kx + ky * ky + kz * kz
            one = torch.ones((), dtype=dtype, device=device)
            zero = torch.zeros((), dtype=dtype, device=device)
            k2s = torch.where(k2 > 0, k2, one)
            pref = valid & (k2 > 0)
            env2 = None
            if self.rpy_sinc_radius is not None or self.hasimoto_k2 is not None:
                env2 = one
                if self.rpy_sinc_radius is not None:
                    xk = torch.sqrt(k2) * self.rpy_sinc_radius
                    xs = torch.where(xk > 1e-8, xk, one)
                    sc = torch.where(xk > 1e-8, torch.sin(xs) / xs, 1.0 - xk * xk / 6.0)
                    env2 = env2 * (sc * sc)
                if self.hasimoto_k2 is not None:
                    env2 = env2 * (1.0 + self.hasimoto_k2 * k2)
            scale = torch.where(pref, 1.0 / (self.viscosity * k2s), zero)
            if env2 is not None:
                scale = scale * env2
            nscale = None
            if self.noise:
                # noise_amp / sqrt(eta k2s) * sqrt(env2), the amplitude applied per call
                nscale = torch.where(pref, 1.0 / torch.sqrt(self.viscosity * k2s), zero)
                if env2 is not None:
                    nscale = nscale * torch.sqrt(env2)
            self._kcache[key] = (kx, ky, kz, k2s, scale, nscale)
        return self._kcache[key]

    @staticmethod
    def _project(g, kx, ky, kz, k2s, scale):
        kdot = kx * g[..., 0] + ky * g[..., 1] + kz * g[..., 2]
        return torch.stack([scale * (g[..., 0] - kx * kdot / k2s),
                            scale * (g[..., 1] - ky * kdot / k2s),
                            scale * (g[..., 2] - kz * kdot / k2s)], dim=-1)

    # --------------------------------------------------------------- call
    def draw(self, gen: torch.Generator, dtype=torch.float32) -> list:
        """Per-shard N(0, 1) white noise [nx_loc, ny, nz, 3] from ``gen``."""
        _, ny, nz = self.shape
        return [torch.randn((self.nx_loc, ny, nz, 3), generator=gen, dtype=dtype, device=d)
                for d in self.mesh.devices]

    def __call__(self, pos_sh, force_sh, mask, noise=None, noise_amp=None) -> list:
        D = self.mesh.size
        nx, ny, nz = self.shape
        nx_loc, P = self.nx_loc, self.pad
        if self.noise and noise is None:
            raise ValueError("a noisy far field takes the per-shard white noise")
        # ---- local spread onto the slab extended by P planes each side
        local, exts = [], []
        for i in range(D):
            pos, force, m = pos_sh[i], force_sh[i], mask[i]
            flat, w, h = _weights_and_indices(self.kern, pos, self.box, self.shape)
            gx = torch.div(flat, ny * nz, rounding_mode="floor")
            gyz = flat - gx * (ny * nz)
            lx = torch.remainder(gx - i * nx_loc + P, nx)
            inside = (lx < nx_loc + 2 * P) & m[:, None]
            lx = torch.where(inside, lx, torch.zeros((), dtype=lx.dtype, device=lx.device))
            inv_dV = 1.0 / torch.prod(h)
            contrib = torch.where(inside[:, :, None],
                                  (w * inv_dV)[:, :, None] * force[:, None, :].to(w.dtype),
                                  torch.zeros((), dtype=w.dtype, device=w.device))
            ext = torch.zeros(((nx_loc + 2 * P) * ny * nz, 3), dtype=w.dtype, device=w.device)
            ext.index_add_(0, (lx * (ny * nz) + gyz).reshape(-1), contrib.reshape(-1, 3))
            exts.append(ext.reshape(nx_loc + 2 * P, ny, nz, 3))
            local.append((lx, gyz, w, inside))
        # ---- halo reduce: the pad planes add into the neighbours' interiors
        left = ppermute([e[:P] for e in exts], perm_dn(D))
        right = ppermute([e[-P:] for e in exts], perm_up(D))
        fk = []
        for i in range(D):
            f = exts[i][P:-P].clone()
            f[-P:] += left[i]
            f[:P] += right[i]
            if self.noise:
                f = torch.cat([f, noise[i].to(f.dtype) / math.sqrt(self.dV)], dim=-1)
            # ---- forward distributed FFT: rfft(z), fft(y), pad kz
            g = torch.fft.fft(torch.fft.rfft(f, dim=2), dim=1)
            g = torch.nn.functional.pad(g, (0, 0, 0, self.nzr_pad - self.nzr))
            fk.append(g)
        fk = all_to_all(fk, split_dim=2, concat_dim=0)  # [nx, ny, kz_chunk, C]
        uk = []
        for i in range(D):
            g = torch.fft.fft(fk[i], dim=0)
            rdt = g.real.dtype
            kx, ky, kz, k2s, scale, nscale = self._kspace(i, rdt, g.device)
            u = self._project(g[..., 0:3], kx, ky, kz, k2s, scale)
            if self.noise:
                u = u + self._project(g[..., 3:6], kx, ky, kz, k2s, float(noise_amp) * nscale)
            uk.append(torch.fft.ifft(u, dim=0))
        uk = all_to_all(uk, split_dim=0, concat_dim=2)  # [nx_loc, ny, nzr_pad, 3]
        us = [torch.fft.irfft(torch.fft.ifft(u[:, :, : self.nzr], dim=1), n=nz, dim=2)
              for u in uk]
        # ---- halo extend and local interpolation
        lo = ppermute([u[:P] for u in us], perm_dn(D))
        hi = ppermute([u[-P:] for u in us], perm_up(D))
        out = []
        for i in range(D):
            ue = torch.cat([hi[i], us[i], lo[i]], dim=0).reshape(-1, 3)
            lx, gyz, w, inside = local[i]
            vals = ue[lx * (ny * nz) + gyz]  # [m, s^3, 3]
            vel = torch.sum(torch.where(inside[:, :, None], w[:, :, None] * vals,
                                        torch.zeros((), dtype=w.dtype, device=w.device)), dim=1)
            out.append(vel * mask[i][:, None])
        return out


def make_sharded_fcm_mf(mesh: Mesh, box: Box, *, viscosity: float = 1.0, radius: float = 1.0,
                        shape: tuple, support: int = 6, rpy_sinc_radius: float | None = None,
                        hasimoto_k2: float | None = None, noise: bool = False) -> ShardedFCM:
    """Build the sharded FCM M F (see ``ShardedFCM``): the JAX package's
    ``make_sharded_fcm_mf`` with the mesh axis implied by ``mesh``."""
    return ShardedFCM(mesh, box, viscosity=viscosity, radius=radius, shape=shape,
                      support=support, rpy_sinc_radius=rpy_sinc_radius,
                      hasimoto_k2=hasimoto_k2, noise=noise)
