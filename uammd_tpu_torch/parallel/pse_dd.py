"""The composed multi-shard PSE step: near field on z-slabs, far field on
x-slabs.

Port of ``uammd_tpu/parallel/pse_dd.py``: the full Euler-Maruyama step of
the split-RPY (PSE) mobility over the shards of a ``parallel.mesh.Mesh``
(reference shape: src/Integrator/BDHI/BDHI_EulerMaruyama.cu:125-166, the
near/far split of BDHI_PSE.cuh:20-55). One step, as phases over the shards
with the collectives between them:

1. the replicated slot pack (``layout.pack_channels``, no straggler list:
   CAP covers the largest occupancy), split into z-slabs;
2. the ghost rows (``domain.halo_extend``: one row from each neighbour, z
   image-shifted across the global boundary);
3. the pair force: #1 in its halo mode with the fused LJ radial
   (``md.lj_g_fused``, ``PAIR_FORCE_FUSED_HALO``), ghost rows dropped;
4. the near-field matvec M_near F: #2 with the PSE functor in its halo mode
   (``PAIR_CHANNEL_HALO``), each matvec exchanging the channels' ghost rows;
5. at T > 0 the Brownian near noise by the distributed Lanczos
   (``lanczos_sqrt_apply_dd``: the Krylov vectors z-sharded, every dot
   product a ``psum``), m more matvecs;
6. the x-slab binning of the particles (``_bin_to_shards``, replicated,
   fixed per-shard capacity with an overflow latch);
7. the far field on x-slabs (``spectral.ShardedFCM``) with its k-space
   noise;
8. the EM update of the replicated positions.

On one card every shard lives on the same device: a mesh there measures
the halo and redistribution machinery, not interconnect traffic. Noise
comes from a ``torch.Generator``; ``step_z`` takes the draws (the near
block [3, nz, nyb, CAP, NLANE] and the far per-shard white noise), so a
test can feed JAX's (``k_far, k_near = split(key)``, pse_dd.py:257-274).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..engine.layout import pack_channels, recip32, unpack_values
from ..engine.pair_kernel import make_pair_channel_kernel, make_pair_force_kernel
from ..solvers.lanczos import _sqrt_e1
from .domain import halo_extend
from .mesh import Mesh, psum
from .spectral import make_sharded_fcm_mf


def _gdot(a, b) -> list:
    """The global dot product of two sharded vectors, one copy per shard."""
    return psum([torch.dot(x, y) for x, y in zip(a, b)])


def lanczos_sqrt_apply_dd(mv, v: list, m: int) -> list:
    """Distributed Lanczos sqrt(M) v (JAX ``lanczos_sqrt_apply_dd``,
    pse_dd.py:47-90): ``v`` is the list of the shards' slices of the global
    Krylov vector and ``mv`` the sharded operator (a list in, a list out,
    doing its own halo exchange). Dot products and norms are ``psum``'d, so
    every shard sees the same tridiagonal; full reorthogonalisation against
    the shard-local basis with the projections ``psum``'d. sqrt(T) e1 is
    ``solvers.lanczos._sqrt_e1`` on each shard (the Jacobi kernel on the
    card)."""
    D = len(v)
    dtype = v[0].dtype
    vnorm = [torch.sqrt(t) for t in _gdot(v, v)]
    V = [torch.zeros((m + 1, t.shape[0]), dtype=dtype, device=t.device) for t in v]
    for s in range(D):
        V[s][0] = v[s] / torch.where(vnorm[s] > 0, vnorm[s], torch.ones_like(vnorm[s]))
    alphas = [torch.zeros((m,), dtype=dtype, device=t.device) for t in v]
    betas = [torch.zeros((m + 1,), dtype=dtype, device=t.device) for t in v]
    for i in range(m):
        w = mv([V[s][i] for s in range(D)])
        if i > 0:
            w = [w[s] - betas[s][i] * V[s][i - 1] for s in range(D)]
        a = _gdot([V[s][i] for s in range(D)], w)
        w = [w[s] - a[s] * V[s][i] for s in range(D)]
        proj = psum([V[s][: i + 1] @ w[s] for s in range(D)])
        w = [w[s] - proj[s] @ V[s][: i + 1] for s in range(D)]
        b = [torch.sqrt(t) for t in _gdot(w, w)]
        for s in range(D):
            V[s][i + 1] = w[s] / torch.where(b[s] > 1e-30, b[s], torch.ones_like(b[s]))
            alphas[s][i] = a[s]
            betas[s][i + 1] = b[s]
    return [vnorm[s] * (_sqrt_e1(alphas[s], betas[s], m).to(dtype) @ V[s][:m])
            for s in range(D)]


def _bin_to_shards(pos, forces, n_dev: int, m: int, Lx: float):
    """The x-slab binning (JAX ``_bin_to_shards``, pse_dd.py:93-128):
    (pos_sh [D, m, 3], f_sh [D, m, 3], mask [D, m], order [D, m] original
    index, n on empties; overflow, a 0-d bool tensor). Each particle goes
    to its slab in index order; ranks past ``m`` are dropped and latch the
    overflow."""
    n = pos.shape[0]
    dev = pos.device
    xfrac = torch.remainder(pos[:, 0] * recip32(Lx) + 0.5, 1.0)
    owner = torch.clamp((xfrac * n_dev).to(torch.int64), 0, n_dev - 1)
    key_s, order = torch.sort(owner, stable=True)
    rank = torch.arange(n, device=dev) - torch.searchsorted(key_s, key_s, right=False)
    kept = rank < m
    slot = torch.where(kept, key_s * m + rank, torch.full_like(rank, n_dev * m))
    T = n_dev * m
    pos_sh = torch.zeros((T + 1, 3), dtype=pos.dtype, device=dev)
    f_sh = torch.zeros((T + 1, 3), dtype=forces.dtype, device=dev)
    idx = torch.full((T + 1,), n, dtype=torch.int64, device=dev)
    pos_sh[slot] = pos[order]
    f_sh[slot] = forces[order]
    idx[slot] = order
    idx = idx[:T].reshape(n_dev, m)
    return (pos_sh[:T].reshape(n_dev, m, 3), f_sh[:T].reshape(n_dev, m, 3), idx < n, idx,
            ~kept.all())


class ShardedPSEStep:
    """``step(pos, gen) -> (pos', forces, overflow)``: one composed PSE EM
    step over the mesh (see the module docstring). ``be`` is a ``PSEGrid``
    without a straggler list (``n_strag = 0``: size CAP from the
    positions) whose near nz divides the mesh (``PSEGrid.create(...,
    nz_multiple=D)``); ``g_pair``, the fused LJ radial, adds a short-range
    pair force (its cutoff at most ``be.rcut``)."""

    def __init__(self, mesh: Mesh, be, *, g_pair=None, dt: float, temperature: float, n: int,
                 far_m_cap: int | None = None):
        spec = be.spec
        if spec.n_strag:
            raise ValueError("the DD PSE near grid runs without stragglers (n_strag = 0)")
        D = mesh.size
        nz = spec.shape[2]
        if nz % D:
            raise ValueError(f"near-grid nz {nz} must divide the {D}-shard mesh")
        self.mesh, self.be, self.spec, self.n = mesh, be, spec, n
        self.nz_loc = nz // D
        self.dt = dt
        self.temperature = temperature
        self.amp = math.sqrt(2.0 * temperature / dt) if temperature > 0 else 0.0
        self.sf = float(np.float32(be.self_f))
        self.local_spec = dataclasses.replace(spec, shape=spec.shape[:2] + (self.nz_loc + 2,))
        self.nkern = make_pair_channel_kernel(self.local_spec, be.near_fn(), 1, periodic_z=False)
        self.fkern = (make_pair_force_kernel(self.local_spec, g_pair, periodic_z=False)
                      if g_pair is not None else None)
        far = be.far
        self.far_mf = make_sharded_fcm_mf(
            mesh, be.box, viscosity=far.viscosity, radius=far.radius, shape=far.shape,
            support=far.support, rpy_sinc_radius=far.rpy_sinc_radius,
            hasimoto_k2=far.hasimoto_k2, noise=temperature > 0)
        self.far_m_cap = (far_m_cap if far_m_cap is not None
                          else int(math.ceil(n / D * 1.8 / 8.0)) * 8)

    # ------------------------------------------------------------ pieces
    def slabs(self, a) -> list:
        """The shards' z-slabs of a [nz, ...] grid (fresh copies)."""
        nzl = self.nz_loc
        return [a[i * nzl:(i + 1) * nzl].to(d, copy=True) for i, d in enumerate(self.mesh.devices)]

    def ghosts(self, x, y, z):
        """Each shard's slab extended by its neighbours' boundary rows."""
        Lz = self.spec.box_size[2]
        return halo_extend(x), halo_extend(y), halo_extend(z, -Lz, Lz)

    def pair_force(self, ext, masks):
        """#1 (fused radial, halo mode) on every shard: 3 lists of
        [nz_loc, ...] masked forces."""
        D = self.mesh.size
        if self.fkern is None:
            return [[torch.zeros_like(m) for m in masks] for _ in range(3)]
        f = [[], [], []]
        for i in range(D):
            fo = self.fkern(ext[0][i], ext[1][i], ext[2][i])
            for c in range(3):
                f[c].append(fo[c][1:-1] * masks[i])
        return f

    def matvec(self, ext, masks, g3):
        """M_near on sharded slot vectors: ``g3`` a list of [3, nz_loc, ...]
        per shard; returns the same. One ghost exchange of the three
        channels, #2 (PSE, halo mode) once per shard, the self term."""
        hg = halo_extend(g3, dim=1)
        out = []
        for i in range(self.mesh.size):
            o = self.nkern(ext[0][i], ext[1][i], ext[2][i], hg[i][0], hg[i][1], hg[i][2])
            out.append(torch.stack([(o[c][1:-1] + self.sf * g3[i][c]) * masks[i]
                                    for c in range(3)]))
        return out

    def near(self, x, y, z, pidf, noise0=None):
        """The near field on the z-slabs: (velocity slots, force slots),
        lists of [3, nz_loc, ...] per shard. ``noise0`` is the list of the
        shards' [3, nz_loc, ...] N(0, 1) start blocks (T > 0)."""
        masks = [(p > 0.5).to(torch.float32) for p in pidf]
        ext = self.ghosts(x, y, z)
        f = self.pair_force(ext, masks)
        f3 = [torch.stack([f[0][i], f[1][i], f[2][i]]) for i in range(self.mesh.size)]
        v3 = self.matvec(ext, masks, f3)
        if self.temperature > 0:
            shp = [a.shape for a in f3]

            def mv_flat(vs):
                return [o.reshape(-1) for o in self.matvec(
                    ext, masks, [v.reshape(s) for v, s in zip(vs, shp)])]

            z0 = [(nz * m[None]).reshape(-1) for nz, m in zip(noise0, masks)]
            b = lanczos_sqrt_apply_dd(mv_flat, z0, self.be.lanczos_iterations)
            a = float(np.float32(self.amp))
            v3 = [v + a * bb.reshape(s) for v, bb, s in zip(v3, b, shp)]
        return v3, f3

    def draw(self, gen: torch.Generator):
        """(near start block [3, nz, nyb, CAP, NLANE], far per-shard white
        noise) from ``gen``."""
        dev = self.mesh.devices[0]
        noise0 = torch.randn((3,) + self.spec.array_shape, generator=gen, device=dev)
        return noise0, self.far_mf.draw(gen)

    # -------------------------------------------------------------- step
    def __call__(self, pos, gen: torch.Generator | None = None):
        if self.temperature > 0:
            return self.step_z(pos, *self.draw(gen))
        return self.step_z(pos)

    def step_z(self, pos, noise0=None, far_noise=None):
        """One step with the draws given (T > 0): ``noise0`` the near start
        block [3, nz, nyb, CAP, NLANE], ``far_noise`` the list of per-shard
        far white noise [nx_loc, ny, nz_far, 3]."""
        D = self.mesh.size
        n = self.n
        pos = torch.as_tensor(pos, dtype=torch.float32)
        cg = pack_channels(self.spec, pos, torch.zeros((n, 0), device=pos.device))
        x, y, z = self.slabs(cg.x), self.slabs(cg.y), self.slabs(cg.z)
        pidf = self.slabs((cg.pid + 1).to(torch.float32))
        nb = None
        if self.temperature > 0:
            nzl = self.nz_loc
            nb = [noise0[:, i * nzl:(i + 1) * nzl].to(d, copy=True)
                  for i, d in enumerate(self.mesh.devices)]
        v3, f3 = self.near(x, y, z, pidf, nb)
        dev0 = pos.device
        fs = [torch.cat([f[c].to(dev0) for f in f3]) for c in range(3)]
        vs = [torch.cat([v[c].to(dev0) for v in v3]) for c in range(3)]
        forces = unpack_values(cg, fs)
        near_v = unpack_values(cg, vs)
        pos_sh, f_sh, maskp, order, ovf_far = _bin_to_shards(
            pos, forces, D, self.far_m_cap, self.spec.box_size[0])
        devs = self.mesh.devices
        args = ([pos_sh[i].to(d) for i, d in enumerate(devs)],
                [f_sh[i].to(d) for i, d in enumerate(devs)],
                [maskp[i].to(d) for i, d in enumerate(devs)])
        if self.temperature > 0:
            vel_sh = self.far_mf(*args, far_noise, np.float32(self.amp))
        else:
            vel_sh = self.far_mf(*args)
        far_v = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev0)
        far_v[order.reshape(-1)] = torch.cat([v.to(dev0) for v in vel_sh]).to(torch.float32)
        dx = float(np.float32(self.dt)) * (near_v + far_v[:n])
        new_pos = self.be.box.wrap_position(pos + dx)
        return new_pos, forces, cg.overflow | ovf_far


def make_sharded_pse_em_step(mesh: Mesh, be, *, g_pair=None, dt: float, temperature: float,
                             n: int, far_m_cap: int | None = None) -> ShardedPSEStep:
    """Build the composed PSE EM step (``ShardedPSEStep``), the JAX
    package's ``make_sharded_pse_em_step`` with the mesh axis implied."""
    return ShardedPSEStep(mesh, be, g_pair=g_pair, dt=dt, temperature=temperature, n=n,
                          far_m_cap=far_m_cap)
