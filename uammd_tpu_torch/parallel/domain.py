"""Domain decomposition of the v1, DPD and SPH grid engines over a z-slab
mesh.

Port of ``uammd_tpu/parallel/domain.py``. The cell grid's z axis is split
over the shards of a ``parallel.mesh.Mesh``; each shard owns a slab of
cells [nz_loc, nyb, CAP, NLANE]. One step, as phases over the shards with
the collectives between them:

1. the shard-local integrator update;
2. (``make_domain_md_step2`` and the channel engines) ``pmax`` of the
   squared drift, the step's one host read, and on drift the shard-local
   rebin with migration (``_local_rebin``: each shard pulls the particles
   whose cell lands in its slab from its own slab and both neighbours'
   boundary rows, and bins them by two-sort; a ``psum`` count audit
   latches ``ovf``);
3. the halo exchange (``halo_extend``): each shard receives its neighbours'
   boundary rows, the ones across the global boundary image-shifted in z;
4. the force kernel in its halo mode (#1 for LJ, #2 with the DPD or SPH
   functors, ``periodic_z=False``) on the [nz_loc + 2, ...] slab, whose
   ghost rows of output are dropped. SPH exchanges its derived P / rho^2
   channel in a second halo round between its two sweeps.

On one card every shard lives on the same device: a mesh there measures
the halo machinery and the migration, not interconnect traffic.

State: ``GridShards``, per-shard lists of the JAX state tuple's fields in
its order. The v1 Langevin noise comes from one ``torch.Generator`` per
shard (``gens``, JAX's per-shard keys); at T = 0 the port and JAX compare
exactly. DPD's pair noise is the counter hash of ``engine/dpd.py``, so
both evaluations of a pair hash the same and the random force stays
antisymmetric across shard boundaries.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..engine.layout import EMPTY_POS, GridSpec, _bin_columns, recip32, wrap
from ..engine.md import lj_g
from ..engine.pair_kernel import make_pair_channel_kernel, make_pair_force_kernel
from .mesh import Mesh, perm_dn, perm_up, pmax, ppermute, psum


@dataclasses.dataclass
class GridShards:
    """A sharded grid state: each field a list with one tensor per shard.

    The JAX tuples' order: x, y, z, vx, vy, vz, fx, fy, fz, then (for the
    steps with a rebin) rx, ry, rz (positions at the last rebin), pidf
    (pid + 1 as float32, 0 = empty) and ovf (0-d float32, latching
    overflow / lost-particle flag), then the per-shard noise state: ``gens``
    (torch.Generator, the v1 engine's keys) or ``stepi`` (0-d int32 step
    counter, the channel engines')."""

    x: list
    y: list
    z: list
    vx: list
    vy: list
    vz: list
    fx: list
    fy: list
    fz: list
    rx: list | None = None
    ry: list | None = None
    rz: list | None = None
    pidf: list | None = None
    ovf: list | None = None
    gens: list | None = None
    stepi: list | None = None

    def replace(self, **kw) -> "GridShards":
        return dataclasses.replace(self, **kw)


def halo_extend(shards, shift_lo: float = 0.0, shift_hi: float = 0.0, dim: int = 0) -> list:
    """Attach the ring neighbours' boundary rows along ``dim``: below, the
    down neighbour's last row (+ ``shift_lo`` on shard 0); above, the up
    neighbour's first row (+ ``shift_hi`` on the last shard)."""
    n = len(shards)
    up = ppermute([t.narrow(dim, t.shape[dim] - 1, 1) for t in shards], perm_up(n))
    down = ppermute([t.narrow(dim, 0, 1) for t in shards], perm_dn(n))
    if shift_lo:
        up[0] = up[0] + shift_lo
    if shift_hi:
        down[n - 1] = down[n - 1] + shift_hi
    return [torch.cat([u, t, d], dim=dim) for u, t, d in zip(up, shards, down)]


def _halo_spec(spec: GridSpec, nz_loc: int) -> GridSpec:
    return dataclasses.replace(spec, shape=(spec.shape[0], spec.shape[1], nz_loc + 2))


def _nz_loc(mesh: Mesh, spec: GridSpec) -> int:
    nz = spec.shape[2]
    if nz % mesh.size:
        raise ValueError(f"nz {nz} must divide the {mesh.size}-shard mesh for z-sharding")
    return nz // mesh.size


class _GJ:
    """The Gronbech-Jensen first half of the v1 DD steps, with JAX's
    float32 constants and grouping (domain.py:96-111)."""

    def __init__(self, dt, temperature, friction):
        gdt = np.float32(0.5 * friction * dt)
        b = np.float32(1.0 / (1.0 + gdt))
        a = np.float32((1.0 - gdt) * b)
        h = np.float32(dt)
        self.amp = float(np.float32(math.sqrt(2.0 * temperature * friction * dt)))
        self.noisy = temperature > 0
        c_x = np.float32(0.5) * b * h
        hv = np.float32(0.5) * h
        self.bh, self.c_x, self.h, self.hva, self.a, self.b, self.hv = (
            float(v) for v in (b * h, c_x, h, hv * a, a, b, hv))

    def __call__(self, x, y, z, vx, vy, vz, fx, fy, fz, mask, gen):
        if self.noisy:
            noise = [self.amp * torch.randn(x.shape, generator=gen, device=x.device)
                     for _ in range(3)]
        else:
            noise = [torch.zeros_like(x)] * 3
        pos = [p + mask * (self.bh * v + self.c_x * (self.h * f + n_))
               for p, v, f, n_ in zip((x, y, z), (vx, vy, vz), (fx, fy, fz), noise)]
        vel = [mask * (self.a * v + self.hva * f + self.b * n_)
               for v, f, n_ in zip((vx, vy, vz), (fx, fy, fz), noise)]
        return pos, vel


def make_domain_md_step(mesh: Mesh, spec: GridSpec, *, epsilon: float = 1.0,
                        sigma: float = 1.0, dt: float = 0.005, temperature: float = 1.0,
                        friction: float = 1.0):
    """Build ``step(state: GridShards) -> GridShards`` over (x, y, z, vx, vy,
    vz, fx, fy, fz, gens): the v1 Langevin step without rebin (JAX's first
    DD step, domain.py:40)."""
    nz_loc = _nz_loc(mesh, spec)
    Lz = float(spec.box_size[2])
    kern = make_pair_force_kernel(_halo_spec(spec, nz_loc), lj_g(epsilon, sigma),
                                  periodic_z=False)
    gj = _GJ(dt, temperature, friction)

    def step(st: GridShards) -> GridShards:
        n = mesh.size
        pos, vel = [], []
        for i in range(n):
            mask = (torch.abs(st.x[i]) < EMPTY_POS / 2).to(torch.float32)
            p, v = gj(st.x[i], st.y[i], st.z[i], st.vx[i], st.vy[i], st.vz[i],
                      st.fx[i], st.fy[i], st.fz[i], mask, st.gens[i])
            pos.append(p)
            vel.append(v)
        x, y, z = ([p[c] for p in pos] for c in range(3))
        xe, ye, ze = halo_extend(x), halo_extend(y), halo_extend(z, -Lz, Lz)
        out = dict(x=x, y=y, z=z, vx=[], vy=[], vz=[], fx=[], fy=[], fz=[])
        for i in range(n):
            mask = (torch.abs(x[i]) < EMPTY_POS / 2).to(torch.float32)
            fl = kern(xe[i], ye[i], ze[i])
            for c, (fk, vk) in enumerate((("fx", "vx"), ("fy", "vy"), ("fz", "vz"))):
                f = fl[c][1:-1] * mask
                out[fk].append(f)
                out[vk].append(vel[i][c] + gj.hv * f)
        return st.replace(**out)

    return step


def _shard(a, mesh: Mesh, nz_loc: int) -> list:
    return [a[i * nz_loc:(i + 1) * nz_loc].to(d, copy=True) for i, d in enumerate(mesh.devices)]


def _gens(mesh: Mesh, seed: int) -> list:
    seeds = np.random.SeedSequence(seed).generate_state(mesh.size, dtype=np.uint64)
    return [torch.Generator(device=d).manual_seed(int(s) >> 1)
            for d, s in zip(mesh.devices, seeds)]


def shard_grid_state(gs, mesh: Mesh, seed: int = 0) -> GridShards:
    """A GridState's grids on the mesh (z-sliced) and one generator per
    shard, for ``make_domain_md_step``."""
    nz_loc = _nz_loc(mesh, gs.spec)
    f = {k: _shard(getattr(gs, k), mesh, nz_loc)
         for k in ("x", "y", "z", "vx", "vy", "vz", "fx", "fy", "fz")}
    return GridShards(**f, gens=_gens(mesh, seed))


# ---------------------------------------------------------------------------
# v2: with cross-shard rebinning (particle migration)


def _local_rebin(spec: GridSpec, nz_loc: int, shard: int, ext):
    """Shard-local rebin with migration of one shard: bin every particle of
    its halo-extended [7, nz_loc + 2, ...] stack ``ext`` (x, y, z, vx, vy,
    vz, pidf; own slab and both neighbours' boundary rows) whose current
    cell lands in its slab, by two-sort (``layout._bin_columns``).
    Particles move at most one cell between rebins (the half-skin trigger),
    so one halo row is enough. Returns (the 7 binned grids, count,
    overflow)."""
    nx, ny, nz = spec.shape
    F = spec.fold
    Ls = spec.box_size
    # n_strag 0: any entry past CAP latches overflow (a straggler list
    # here would be dropped, losing particles silently)
    local_spec = dataclasses.replace(spec, shape=(nx, ny, nz_loc), n_strag=0)
    valid = ext[6] > 0.5
    empty = torch.full_like(ext[0], EMPTY_POS)
    w = [torch.where(valid, wrap(ext[c], Ls[c]), empty) for c in range(3)]

    def cell_of(p, L, ncell):
        frac = p * recip32(L) + 0.5
        frac = frac - torch.floor(frac)
        return torch.clamp((frac * ncell).to(torch.int64), 0, ncell - 1)

    cx, cy, cz = (cell_of(w[c], Ls[c], m) for c, m in enumerate((nx, ny, nz)))
    z0 = shard * nz_loc
    mine = valid & (cz >= z0) & (cz < z0 + nz_loc)
    yb = cy // F
    lane = cx * F + (cy - yb * F)
    key = ((cz - z0) * local_spec.nyb + yb) * local_spec.nlane + lane
    key = torch.where(mine, key, torch.full_like(key, nz_loc * local_spec.nyb * local_spec.nlane))
    cols = tuple(a.reshape(-1) for a in (w[0], w[1], w[2], ext[3], ext[4], ext[5], ext[6]))
    binned, _, ovf = _bin_columns(local_spec, key.reshape(-1), cols,
                                  (None, None, None, 0.0, 0.0, 0.0, 0.0))
    return binned, (binned[6] > 0.5).sum(), ovf


def _drift_rebin(spec: GridSpec, nz_loc: int, n_total, x, y, z, vx, vy, vz, rx, ry, rz, pidf,
                 ovf):
    """The global squared-drift check (one host read) and, when it fires,
    the synchronized cross-shard rebin; returns the fields after it and
    whether it rebinned."""
    n = len(x)
    thr2 = float(np.float32(spec.drift_threshold ** 2))
    d2 = [((pidf[i] > 0.5) * ((x[i] - rx[i]) ** 2 + (y[i] - ry[i]) ** 2
                              + (z[i] - rz[i]) ** 2)).max() for i in range(n)]
    if not float(pmax(d2)[0]) > thr2:
        return (x, y, z, vx, vy, vz, rx, ry, rz, pidf, ovf), False
    ext = halo_extend([torch.stack([x[i], y[i], z[i], vx[i], vy[i], vz[i], pidf[i]])
                       for i in range(n)], dim=1)
    res = [_local_rebin(spec, nz_loc, i, ext[i]) for i in range(n)]
    totals = psum([r[1] for r in res])
    new_ovf = []
    for i in range(n):
        o = res[i][2].to(torch.float32)
        if n_total is not None:
            o = o + (totals[i] != n_total).to(torch.float32)
        new_ovf.append(ovf[i] + o)
    x, y, z, vx, vy, vz, pidf = ([r[0][k] for r in res] for k in range(7))
    return (x, y, z, vx, vy, vz, list(x), list(y), list(z), pidf, new_ovf), True


def make_domain_md_step2(mesh: Mesh, spec: GridSpec, *, epsilon: float = 1.0,
                         sigma: float = 1.0, dt: float = 0.005, temperature: float = 1.0,
                         friction: float = 1.0, n_total: int | None = None):
    """Build ``step(state: GridShards) -> GridShards`` over (x, y, z, vx, vy,
    vz, fx, fy, fz, rx, ry, rz, pidf, ovf, gens): the v1 Langevin step with
    the drift-triggered cross-shard rebin (JAX's domain.py:221). The drift
    is checked globally, so every shard rebins in the same step.
    ``step.rebins`` counts the steps that rebinned."""
    nz_loc = _nz_loc(mesh, spec)
    Lz = float(spec.box_size[2])
    kern = make_pair_force_kernel(_halo_spec(spec, nz_loc), lj_g(epsilon, sigma),
                                  periodic_z=False)
    gj = _GJ(dt, temperature, friction)

    def step(st: GridShards) -> GridShards:
        n = mesh.size
        pos, vel = [], []
        for i in range(n):
            mask = (st.pidf[i] > 0.5).to(torch.float32)
            p, v = gj(st.x[i], st.y[i], st.z[i], st.vx[i], st.vy[i], st.vz[i],
                      st.fx[i], st.fy[i], st.fz[i], mask, st.gens[i])
            pos.append(p)
            vel.append(v)
        fields, rebinned = _drift_rebin(
            spec, nz_loc, n_total, *([p[c] for p in pos] for c in range(3)),
            *([v[c] for v in vel] for c in range(3)), st.rx, st.ry, st.rz, st.pidf, st.ovf)
        step.rebins += int(rebinned)
        x, y, z, vx, vy, vz, rx, ry, rz, pidf, ovf = fields
        xe, ye, ze = halo_extend(x), halo_extend(y), halo_extend(z, -Lz, Lz)
        out = dict(fx=[], fy=[], fz=[], vx=[], vy=[], vz=[])
        for i in range(n):
            mask = (pidf[i] > 0.5).to(torch.float32)
            fl = kern(xe[i], ye[i], ze[i])
            for c, (fk, vk) in enumerate((("fx", "vx"), ("fy", "vy"), ("fz", "vz"))):
                f = fl[c][1:-1] * mask
                out[fk].append(f)
                out[vk].append((vx, vy, vz)[c][i] + gj.hv * f)
        return st.replace(x=x, y=y, z=z, rx=rx, ry=ry, rz=rz, pidf=pidf, ovf=ovf, **out)

    step.rebins = 0
    return step


def shard_grid_state2(gs, mesh: Mesh, seed: int = 0) -> GridShards:
    """GridState -> the state of ``make_domain_md_step2``."""
    nz_loc = _nz_loc(mesh, gs.spec)
    pidf = (gs.pid + 1).to(torch.float32)
    f = {k: _shard(getattr(gs, k), mesh, nz_loc)
         for k in ("x", "y", "z", "vx", "vy", "vz", "fx", "fy", "fz")}
    f.update(rx=_shard(gs.x, mesh, nz_loc), ry=_shard(gs.y, mesh, nz_loc),
             rz=_shard(gs.z, mesh, nz_loc), pidf=_shard(pidf, mesh, nz_loc),
             ovf=[torch.zeros((), dtype=torch.float32, device=d) for d in mesh.devices])
    return GridShards(**f, gens=_gens(mesh, seed))


def gather_grid_shards(st: GridShards, n: int):
    """Sharded state with ``pidf`` -> (pos, vel, force) [N, 3] in pid order
    (numpy)."""
    cols = torch.cat([torch.stack([getattr(st, k)[i].reshape(-1).cpu()
                                   for k in ("x", "y", "z", "vx", "vy", "vz", "fx", "fy", "fz")],
                                  dim=-1) for i in range(len(st.x))]).numpy()
    pid = np.rint(torch.cat([p.reshape(-1).cpu() for p in st.pidf]).numpy()).astype(np.int64) - 1
    keep = pid >= 0
    out = np.zeros((n, 9), np.float32)
    out[pid[keep]] = cols[keep]
    return out[:, :3], out[:, 3:6], out[:, 6:]


# ---------------------------------------------------------------------------
# v3: the channel-kernel engines (DPD, SPH)


def make_domain_channel_step(mesh: Mesh, spec: GridSpec, make_local_force, *, dt: float,
                             mass: float = 1.0, n_total: int | None = None):
    """The shared DD skeleton of the velocity-Verlet channel engines (JAX's
    domain.py:389).

    ``make_local_force(local_spec)`` returns ``force(halo_extend, xe, ye, ze,
    vxe, vye, vze, pe, stepi) -> (fx, fy, fz)``, each argument and result a
    list over the shards of halo-extended [nz_loc + 2, ...] grids (the
    ghost rows of the result are dropped), ``stepi`` the list of 0-d step
    counters. The velocity entering the force is the half-kicked one (the
    Groot-Warren lambda = 1/2 of ``engine/dpd.py``).

    State: ``GridShards`` over (x, y, z, vx, vy, vz, fx, fy, fz, rx, ry, rz,
    pidf, ovf, stepi). ``step.rebins`` counts the steps that rebinned."""
    nz_loc = _nz_loc(mesh, spec)
    Lz = float(spec.box_size[2])
    dt_ = float(np.float32(dt))
    hv = float(np.float32(0.5 * dt / mass))
    local_force = make_local_force(_halo_spec(spec, nz_loc))

    def step(st: GridShards) -> GridShards:
        n = mesh.size
        v, p = [[], [], []], [[], [], []]
        for i in range(n):
            mask = (st.pidf[i] > 0.5).to(torch.float32)
            zero = torch.zeros((), dtype=torch.float32, device=mask.device)
            for c, (pk, vk, fk) in enumerate((("x", "vx", "fx"), ("y", "vy", "fy"),
                                              ("z", "vz", "fz"))):
                vc = (getattr(st, vk)[i] + hv * getattr(st, fk)[i]) * mask
                v[c].append(vc)
                p[c].append(getattr(st, pk)[i] + torch.where(mask > 0, dt_ * vc, zero))
        stepi = [s + 1 for s in st.stepi]
        fields, rebinned = _drift_rebin(spec, nz_loc, n_total, *p, *v, st.rx, st.ry, st.rz,
                                        st.pidf, st.ovf)
        step.rebins += int(rebinned)
        x, y, z, vx, vy, vz, rx, ry, rz, pidf, ovf = fields
        ext = [halo_extend(a) for a in (x, y)] + [halo_extend(z, -Lz, Lz)] + [
            halo_extend(a) for a in (vx, vy, vz, pidf)]
        fl = local_force(halo_extend, *ext, stepi)
        out = dict(fx=[], fy=[], fz=[], vx=[], vy=[], vz=[])
        for i in range(n):
            mask = (pidf[i] > 0.5).to(torch.float32)
            for c, (fk, vk) in enumerate((("fx", "vx"), ("fy", "vy"), ("fz", "vz"))):
                f = fl[c][i][1:-1] * mask
                out[fk].append(f)
                out[vk].append(((vx, vy, vz)[c][i] + hv * f) * mask)
        return st.replace(x=x, y=y, z=z, rx=rx, ry=ry, rz=rz, pidf=pidf, ovf=ovf, stepi=stepi,
                          **out)

    step.rebins = 0
    return step


def make_domain_dpd_step(mesh: Mesh, spec: GridSpec, *, rc: float = 1.0, A: float = 25.0,
                         gamma: float = 4.5, temperature: float = 1.0, dt: float = 0.01,
                         mass: float = 1.0, n_total: int | None = None):
    """Domain-decomposed DPD (``engine/dpd.py`` over z-slabs) on #2's DPD
    functor in its halo mode. The pair noise is the symmetric (pid_lo,
    pid_hi, step) counter hash of the single-chip engine."""
    from ..engine.dpd import DPDPair

    sigma_dt = math.sqrt(2.0 * temperature * gamma / dt)

    def make_local_force(local_spec):
        kern = make_pair_channel_kernel(local_spec, DPDPair(rc, A, gamma, sigma_dt),
                                        periodic_z=False)

        def force(halo_extend, xe, ye, ze, vxe, vye, vze, pe, stepi):
            # engine/dpd.py's channels: (vx, vy, vz, pid_f, step_f), pid as a
            # raw float (empties -1; pe carries pid + 1) and the step uniform
            outs = [kern(xe[i], ye[i], ze[i], vxe[i], vye[i], vze[i], pe[i] - 1.0,
                         stepi[i].to(torch.float32)) for i in range(len(xe))]
            return tuple([o[c] for o in outs] for c in range(3))

        return force

    return make_domain_channel_step(mesh, spec, make_local_force, dt=dt, mass=mass,
                                    n_total=n_total)


def make_domain_sph_step(mesh: Mesh, spec: GridSpec, params, *, dt: float = 0.01,
                         mass: float = 1.0, n_total: int | None = None):
    """Domain-decomposed SPH (``engine/sph.py`` over z-slabs): the density
    sweep runs on the halo-extended slab (home rows exact), then the
    derived P/rho^2 channel is itself halo-exchanged so that the force
    sweep sees correct ghost-row pressures: two halo rounds per step."""
    from ..engine.sph import SPHDensityPair, SPHForcePair

    def make_local_force(local_spec):
        rho_kern = make_pair_channel_kernel(local_spec, SPHDensityPair(params.support),
                                            periodic_z=False)
        f_kern = make_pair_channel_kernel(local_spec, SPHForcePair(params), periodic_z=False)
        self_rho = float(np.float32(mass * (1.0 / (math.pi * params.support ** 3))))
        m32 = float(np.float32(mass))
        stiff = float(np.float32(params.gas_stiffness))
        rest = float(np.float32(params.rest_density))

        def force(halo_extend, xe, ye, ze, vxe, vye, vze, pe, stepi):
            n = len(xe)
            m = [(p > 0.5).to(torch.float32) for p in pe]
            mch = [mi * m32 for mi in m]
            # ghost-row densities are wrong (their neighbours lie outside
            # the halo): exchange the HOME rows' densities instead
            rho_home = []
            for i in range(n):
                (rho,) = rho_kern(xe[i], ye[i], ze[i], mch[i])
                rho_home.append(((rho + self_rho) * m[i])[1:-1])
            rho_e = halo_extend(rho_home)
            outs = []
            for i in range(n):
                one = torch.ones((), dtype=torch.float32, device=m[i].device)
                zero = torch.zeros((), dtype=torch.float32, device=m[i].device)
                rho_s = torch.where(m[i] > 0, rho_e[i], one)
                pressure = stiff * (rho_s - rest)
                p_div_rho2 = torch.where(m[i] > 0, pressure / (rho_s * rho_s), zero)
                outs.append(f_kern(xe[i], ye[i], ze[i], p_div_rho2, vxe[i], vye[i], vze[i],
                                   mch[i]))
            return tuple([o[c] for o in outs] for c in range(3))

        return force

    return make_domain_channel_step(mesh, spec, make_local_force, dt=dt, mass=mass,
                                    n_total=n_total)


def shard_channel_state(gs, mesh: Mesh) -> GridShards:
    """GridState -> the state of ``make_domain_channel_step``."""
    st = shard_grid_state2(gs, mesh)
    return st.replace(gens=None, stepi=[gs.step.to(d, dtype=torch.int32, copy=True)
                                        for d in mesh.devices])
