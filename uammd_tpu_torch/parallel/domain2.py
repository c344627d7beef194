"""Domain decomposition of the v2 MD engine over a z-slab mesh.

Port of ``uammd_tpu/parallel/domain2.py``: the production v2 engine
(``engine/md2.py``, unfused: the Newton pair kernel with straggler rows,
the fold, the Gronbech-Jensen update) with its cell grid's z axis split
over the shards of a ``parallel.mesh.Mesh``. Each shard owns a slab of
home rows [nz_loc, nyb, CAP, NLANE] and its own [S] straggler list.

One step, as phases over the shards with the collectives between them:

1. the G-J update #11 of every shard (grid and straggler rows in one
   launch, noise keyed by the shard's ``stepc``) and its drift, the
   straggler rows' own since the last rebin included;
2. ``pmax`` of the drift, the step's one host read, which decides the rebin
   for every shard at once;
3. on drift, the rebin: on a 1-shard mesh the separable rebin #5 with
   ``_compact_mini``; on more shards the two-sort rebin over the home slots,
   both neighbours' boundary rows and the own and neighbour straggler lists
   (each particle claimed by exactly one shard; a ``psum`` count audit
   latches ``ovf``);
4. the forces: the up neighbour's first home row comes down as a ghost row
   (one exchange of the three coordinates, z image-shifted at the wrap),
   the Newton kernel #6 runs in its ``halo_z`` mode, the reactions it puts
   on the ghost row (the (1, dyb) group rows at z = nz_loc - 1) go up in
   one exchange of nine rows, and the halo fold #8 adds them at row 0.
   Foreign stragglers meet the boundary rows in two small plain passes
   (``strag_row_pass``), and straggler pairs over the own and neighbour
   lists (``ss_forces``).

On a 1-shard mesh every exchange is a copy onto the same shard, so the run
is the single-chip engine (``_single_chip_md2``) plus the halo machinery.
On one card a 4-shard mesh measures that machinery and the migration, not
interconnect traffic: every shard lives on the same device.

The state (``MD2Shards``) holds per-shard lists of JAX's 21 fields in
JAX's order, less the last: JAX's per-shard PRNG key. The straggler rows
draw from #11's counter streams keyed by ``stepc``, as JAX's TPU path keys
its hardware PRNG, so the port needs no key. At T = 0 the port and JAX
compare exactly; at T > 0 only by statistics.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.kernel2 import _box, make_fold_kernel_halo, make_newton_pair_kernel
from ..engine.layout import EMPTY_POS, GridSpec, _bin_columns, choose_spec, recip32, wrap
from ..engine.md import lj_g, lj_g_fused
from ..engine.rebin_kernel import _compact_mini, make_separable_rebin
from ..engine.update_kernel import make_gj_update_kernel
from .mesh import Mesh, perm_dn, perm_up, pmax, ppermute, psum

_SEED_STRIDE = 99999989  # per-shard spacing of the update's noise seed

_CLAMP_LO = 4e-3


@dataclasses.dataclass
class MD2Shards:
    """The sharded v2 state: each field a list with one tensor per shard.

    JAX's 21-tuple order: x, y, z, wx, wy, wz (pre-half-kick velocities),
    fx, fy, fz (folded forces), rx, ry, rz (positions at the last rebin),
    pidf (pid + 1 as float32, 0 = empty), spos, svelw, sforce ([S, 3]),
    spidf ([S]), sref ([S, 3], straggler positions at the last rebin), ovf
    (0-d float32, latching overflow / lost-particle flag), stepc (0-d int32
    noise seed) and JAX's PRNG key, which the port does not carry (see the
    module docstring)."""

    x: list
    y: list
    z: list
    wx: list
    wy: list
    wz: list
    fx: list
    fy: list
    fz: list
    rx: list
    ry: list
    rz: list
    pidf: list
    spos: list
    svelw: list
    sforce: list
    spidf: list
    sref: list
    ovf: list
    stepc: list

    def replace(self, **kw) -> "MD2Shards":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(MD2Shards))


def _cell_of(p, L: float, ncell: int):
    frac = p * recip32(L) + 0.5
    frac = frac - torch.floor(frac)
    return torch.clamp((frac * ncell).to(torch.int64), 0, ncell - 1)


class DomainMD2Step:
    """``step(state: MD2Shards) -> MD2Shards``: one v2 step over the mesh
    (see the module docstring). ``rebins`` counts the steps that rebinned."""

    def __init__(self, mesh: Mesh, spec: GridSpec, *, dt: float, temperature: float,
                 friction: float = 1.0, mass: float = 1.0, epsilon: float = 1.0,
                 sigma: float = 1.0, fast_recip: bool = False, n_total: int | None = None):
        n_dev = mesh.size
        nx, ny, nz = spec.shape
        if nz % n_dev:
            raise ValueError(f"nz {nz} must divide the {n_dev}-shard mesh for z-sharding")
        nz_loc = nz // n_dev
        if n_dev > 1 and nz_loc < 2:
            raise ValueError("need >= 2 cell rows per shard")
        self.spec = spec
        self.n_dev = n_dev
        self.nz_loc = nz_loc
        self.S = spec.n_strag
        self.n_total = n_total
        self.Ls = tuple(float(v) for v in spec.box_size)
        self.rc2 = float(np.float32(spec.cutoff * spec.cutoff))
        self.thr = float(np.float32(spec.drift_threshold))
        self.g_fn = lj_g(epsilon, sigma)
        self.local_spec = dataclasses.replace(spec, shape=(nx, ny, nz_loc))
        gk = lj_g_fused(epsilon, sigma, rc2=spec.cutoff * spec.cutoff, approx=fast_recip)
        self.kern = make_newton_pair_kernel(self.local_spec, gk, halo_z=True, self_half=True)
        self.fold = make_fold_kernel_halo(self.local_spec)
        self.upd = make_gj_update_kernel(self.local_spec, dt, temperature, friction, mass)
        self.use_fast_rebin = n_dev == 1 and self.S > 0
        self.sep = make_separable_rebin(self.local_spec) if self.use_fast_rebin else None
        self.rebins = 0

    # ---------------------------------------------------------------- step
    def __call__(self, st: MD2Shards) -> MD2Shards:
        n, S = self.n_dev, self.S
        grids = {k: list(getattr(st, k)) for k in ("x", "y", "z", "wx", "wy", "wz")}
        spos, svelw = list(st.spos), list(st.svelw)
        dinfs = []
        for i in range(n):
            # the straggler rows by their pid + 1 (the state's form), and
            # their drift since the last rebin joined in the same launch
            strag = (st.spos[i], st.svelw[i], st.sforce[i], st.spidf[i]) if S else None
            res = self.upd(st.x[i], st.y[i], st.z[i], st.wx[i], st.wy[i], st.wz[i],
                           st.fx[i], st.fy[i], st.fz[i], st.rx[i], st.ry[i], st.rz[i],
                           st.stepc[i], strag, st.sref[i] if S else None)
            for k, v in zip(("x", "y", "z", "wx", "wy", "wz"), res[0]):
                grids[k][i] = v
            if S:
                spos[i], svelw[i] = res[2]
            dinfs.append(res[1])
        # the step's one host read: the drift, the same for every shard
        drift = float(pmax(dinfs)[0])
        pidf, spidf, ovf = list(st.pidf), list(st.spidf), list(st.ovf)
        rx, ry, rz, sref = list(st.rx), list(st.ry), list(st.rz), list(st.sref)
        if drift > self.thr:
            rebin = self._fast_rebin if self.use_fast_rebin else self._sort_rebin
            out = rebin(grids, pidf, spos, svelw, spidf)
            for k in ("x", "y", "z", "wx", "wy", "wz"):
                grids[k] = out[k]
            pidf, spos, svelw, spidf = out["pidf"], out["spos"], out["svelw"], out["spidf"]
            ovf = [a + b for a, b in zip(ovf, out["ovf"])]
            rx, ry, rz, sref = list(grids["x"]), list(grids["y"]), list(grids["z"]), list(spos)
            self.rebins += 1
        fx, fy, fz, sforce = self.compute_forces(grids["x"], grids["y"], grids["z"], pidf,
                                                 spos, spidf)
        return MD2Shards(**grids, fx=fx, fy=fy, fz=fz, rx=rx, ry=ry, rz=rz, pidf=pidf,
                         spos=spos, svelw=svelw, sforce=sforce, spidf=spidf, sref=sref,
                         ovf=ovf, stepc=[s + 1 for s in st.stepc])

    # -------------------------------------------------------------- forces
    def ghost_rows(self, x, y, z):
        """The up neighbour's first home row, z image-shifted at the wrap:
        one exchange of the three coordinates."""
        n = self.n_dev
        g = ppermute([torch.stack([x[i][:1], y[i][:1], z[i][:1]]) for i in range(n)],
                     perm_dn(n))
        Lz = self.Ls[2]
        return [(g[i][0], g[i][1], g[i][2] + Lz if i == n - 1 else g[i][2]) for i in range(n)]

    def strag_row_pass(self, xr, yr, zr, slist, sval):
        """Foreign stragglers against one boundary cell row (plain torch;
        small). Returns (the row's force [3, nyb, CAP, NLANE], the reaction
        on the stragglers [S, 3])."""
        d = []
        for c, r in enumerate((xr, yr, zr)):
            dv = slist[:, c][:, None, None, None] - r[None]
            d.append(dv - self.Ls[c] * torch.round(dv * recip32(self.Ls[c])))
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        ok = (r2 < self.rc2) & sval[:, None, None, None] & (xr[None] < 1.0e8)
        g = torch.where(ok, self.g_fn(torch.clamp(r2, min=float(np.float32(_CLAMP_LO)))),
                        torch.zeros((), device=xr.device))
        t = [g * dv for dv in d]
        f_row = torch.stack([tc.sum(dim=0) for tc in t])
        part = torch.stack([-tc.sum(dim=(1, 2, 3)) for tc in t], dim=-1)
        return f_row, part

    def ss_forces(self, own, own_val, comb, comb_val):
        """Straggler-straggler forces on the own rows (minimum image)."""
        Ls, iLs = _box(self.Ls, own.device)  # made once per device: no copy per step
        d = comb[None, :, :] - own[:, None, :]
        d = d - Ls * torch.round(d * iLs)
        r2 = torch.sum(d * d, dim=-1)
        ok = (r2 < self.rc2) & (r2 > 1e-10) & own_val[:, None] & comb_val[None, :]
        g = torch.where(ok, self.g_fn(torch.clamp(r2, min=float(np.float32(_CLAMP_LO)))),
                        torch.zeros((), device=own.device))
        return torch.sum(g[:, :, None] * d, dim=1)

    def compute_forces(self, x, y, z, pidf, spos, spidf):
        """Folded forces on every shard's home slots (masked) and its
        straggler forces: lists of ([nz_loc, ...] x 3) and [S, 3]."""
        n, S, nzl = self.n_dev, self.S, self.nz_loc
        nlane = self.local_spec.nlane
        ghosts = self.ghost_rows(x, y, z)
        outs = []
        for i in range(n):
            args = (x[i], y[i], z[i]) + ghosts[i]
            if S:
                sval = (spidf[i] > 0.5).to(torch.float32)
                block = torch.stack([spos[i][:, 0], spos[i][:, 1], spos[i][:, 2], sval])
                args = args + (block[:, :, None].expand(4, S, nlane),)
            outs.append(self.kern.stacked(*args))  # ([15, nz_loc, ...] buffer, sforce)
        # the reactions on my ghost row belong to the up neighbour: one
        # exchange of the nine group-component rows
        sends = [outs[i][0][3:12, nzl - 1].contiguous() for i in range(n)]
        rec = ppermute(sends, perm_up(n))
        folded = [list(self.fold.stacked(outs[i][0], rec[i])) for i in range(n)]
        if S:
            sval = [spidf[i] > 0.5 for i in range(n)]
            sf = [outs[i][1] for i in range(n)]
            if n > 1:
                sl = [torch.stack([spos[i][:, 0], spos[i][:, 1], spos[i][:, 2], spidf[i]], dim=-1)
                      for i in range(n)]
                dn_l = ppermute(sl, perm_up(n))
                up_l = ppermute(sl, perm_dn(n))
                p_dn, p_up = [], []
                for i in range(n):
                    f0, pd = self.strag_row_pass(x[i][0], y[i][0], z[i][0], dn_l[i][:, :3],
                                                 dn_l[i][:, 3] > 0.5)
                    fT, pu = self.strag_row_pass(x[i][nzl - 1], y[i][nzl - 1], z[i][nzl - 1],
                                                 up_l[i][:, :3], up_l[i][:, 3] > 0.5)
                    for c in range(3):  # the fold's outputs are fresh tensors
                        folded[i][c][0] += f0[c]
                        folded[i][c][nzl - 1] += fT[c]
                    p_dn.append(pd)
                    p_up.append(pu)
                back_dn = ppermute(p_dn, perm_dn(n))
                back_up = ppermute(p_up, perm_up(n))
                for i in range(n):
                    comb = [sl[i], dn_l[i], up_l[i]] if n > 2 else [sl[i], dn_l[i]]
                    comb = torch.cat(comb)
                    sf[i] = (sf[i] + back_dn[i] + back_up[i]
                             + self.ss_forces(spos[i], sval[i], comb[:, :3], comb[:, 3] > 0.5))
            else:
                sf[0] = sf[0] + self.ss_forces(spos[0], sval[0], spos[0], sval[0])
            sforce = [sf[i] * sval[i][:, None] for i in range(n)]
        else:
            sforce = [torch.zeros((0, 3), dtype=torch.float32, device=x[i].device)
                      for i in range(n)]
        fx, fy, fz = [], [], []
        for i in range(n):
            mask = (pidf[i] > 0.5).to(torch.float32)
            fx.append(folded[i][0] * mask)
            fy.append(folded[i][1] * mask)
            fz.append(folded[i][2] * mask)
        return fx, fy, fz, sforce

    # -------------------------------------------------------------- rebins
    def _sort_rebin(self, grids, pidf, spos, svelw, spidf):
        """Two-sort rebin with cross-shard migration and the straggler side
        list (``layout._bin_columns`` on a local spec)."""
        n, S, nzl = self.n_dev, self.S, self.nz_loc
        ls = self.local_spec
        nx, ny, nz = self.spec.shape
        F = self.spec.fold
        ncell_loc = nzl * ls.nyb * ls.nlane
        stacks = [torch.stack([grids[k][i] for k in ("x", "y", "z", "wx", "wy", "wz")]
                              + [pidf[i]]) for i in range(n)]
        slists = [torch.stack([spos[i][:, 0], spos[i][:, 1], spos[i][:, 2], svelw[i][:, 0],
                               svelw[i][:, 1], svelw[i][:, 2], spidf[i]]) for i in range(n)]
        pools = [[s.reshape(7, -1)] for s in stacks]
        extra = [[sl] for sl in slists]
        if n > 1:
            from_dn = ppermute([s[:, -1:] for s in stacks], perm_up(n))
            from_up = ppermute([s[:, :1] for s in stacks], perm_dn(n))
            dn_s = ppermute(slists, perm_up(n))
            up_s = ppermute(slists, perm_dn(n)) if n > 2 else None
            for i in range(n):
                pools[i] += [from_dn[i].reshape(7, -1), from_up[i].reshape(7, -1)]
                extra[i].append(dn_s[i])
                if up_s is not None:
                    extra[i].append(up_s[i])
        fills = (None, None, None, 0.0, 0.0, 0.0, 0.0)
        keys = {k: [] for k in ("x", "y", "z", "wx", "wy", "wz")}
        out = dict(keys, pidf=[], spos=[], svelw=[], spidf=[])
        counts, ovfs = [], []
        for i in range(n):
            pool = torch.cat(pools[i] + extra[i], dim=1)
            valid = pool[6] > 0.5
            empty = torch.full_like(pool[0], EMPTY_POS)
            w = [torch.where(valid, wrap(pool[c], self.Ls[c]), empty) for c in range(3)]
            cx = _cell_of(w[0], self.Ls[0], nx)
            cy = _cell_of(w[1], self.Ls[1], ny)
            cz = _cell_of(w[2], self.Ls[2], nz)
            z0 = i * nzl
            mine = valid & (cz >= z0) & (cz < z0 + nzl)
            yb = cy // F
            lane = cx * F + (cy - yb * F)
            key = ((cz - z0) * ls.nyb + yb) * ls.nlane + lane
            key = torch.where(mine, key, torch.full_like(key, ncell_loc))
            cols = (w[0], w[1], w[2], pool[3], pool[4], pool[5], pool[6])
            binned, strag, ovf = _bin_columns(ls, key, cols, fills)
            for k, b in zip(("x", "y", "z", "wx", "wy", "wz", "pidf"), binned):
                out[k].append(b)
            out["spos"].append(torch.stack(strag[0:3], dim=-1))
            out["svelw"].append(torch.stack(strag[3:6], dim=-1))
            out["spidf"].append(strag[6])
            counts.append((binned[6] > 0.5).sum() + (strag[6] > 0.5).sum())
            ovfs.append(ovf.to(torch.float32))
        totals = psum(counts)
        if self.n_total is not None:
            ovfs = [o + (t != self.n_total).to(torch.float32) for o, t in zip(ovfs, totals)]
        out["ovf"] = ovfs
        return out

    def _fast_rebin(self, grids, pidf, spos, svelw, spidf):
        """The separable rebin #5 (a 1-shard mesh only: the local grid is
        the global one)."""
        S = self.S
        stacked = torch.stack([grids[k][0] for k in ("x", "y", "z", "wx", "wy", "wz")]
                              + [pidf[0]])
        sstack = torch.stack([spos[0][:, 0], spos[0][:, 1], spos[0][:, 2], svelw[0][:, 0],
                              svelw[0][:, 1], svelw[0][:, 2], spidf[0]])
        o, mini, count, ovf = self.sep(stacked, sstack)
        spos2, svel2, spid2, s_count = _compact_mini(mini, S)
        flag = (ovf > 0).to(torch.float32) + (s_count > S).to(torch.float32)
        if self.n_total is not None:
            flag = flag + (count != self.n_total).to(torch.float32)
        out = {k: [o[c]] for c, k in enumerate(("x", "y", "z", "wx", "wy", "wz", "pidf"))}
        out.update(spos=[spos2], svelw=[svel2], spidf=[(spid2 + 1).to(torch.float32)],
                   ovf=[flag])
        return out


def make_domain_md2_step(mesh: Mesh, spec: GridSpec, *, dt: float, temperature: float,
                         friction: float = 1.0, mass: float = 1.0, epsilon: float = 1.0,
                         sigma: float = 1.0, fast_recip: bool = False,
                         n_total: int | None = None) -> DomainMD2Step:
    """Build the sharded v2 step. ``spec`` is the GLOBAL grid spec (its nz
    must divide the mesh; ``spec.n_strag`` is the PER-SHARD straggler
    budget). Use ``shard_md2_state`` to build the state from a single-chip
    GridState."""
    return DomainMD2Step(mesh, spec, dt=dt, temperature=temperature, friction=friction,
                         mass=mass, epsilon=epsilon, sigma=sigma, fast_recip=fast_recip,
                         n_total=n_total)


def _seeds(n_dev: int, seed: int) -> np.ndarray:
    base = int((seed * 2654435761 + 12345) % (1 << 31))
    return (np.arange(n_dev, dtype=np.int64) * _SEED_STRIDE + base) % (1 << 31)


def shard_md2_state(md, gs, mesh: Mesh, seed: int = 0) -> MD2Shards:
    """Single-chip GridState (from ``_single_chip_md2(...).init``) -> the
    sharded state. Forces are folded; stragglers go to the shard that owns
    their cell's z-slab (per-shard budget ``spec.n_strag``)."""
    spec = gs.spec
    n_dev = mesh.size
    nz = spec.shape[2]
    nzl = nz // n_dev
    S = spec.n_strag
    ffx, ffy, ffz = md.folded_forces(gs)
    mask = gs.mask.to(torch.float32)
    pidf = (gs.pid + 1).to(torch.float32)
    fields = {"x": gs.x, "y": gs.y, "z": gs.z, "wx": gs.vx, "wy": gs.vy, "wz": gs.vz,
              "fx": ffx * mask, "fy": ffy * mask, "fz": ffz * mask,
              "rx": gs.ref_x, "ry": gs.ref_y, "rz": gs.ref_z, "pidf": pidf}
    out = {k: [v[i * nzl:(i + 1) * nzl].to(mesh.devices[i], copy=True) for i in range(n_dev)]
           for k, v in fields.items()}
    # the stragglers to their slab's shard (host side, once)
    spos, svel = gs.spos.cpu().numpy(), gs.svel.cpu().numpy()
    sforce, spid = gs.sforce.cpu().numpy(), gs.spid.cpu().numpy()
    Lz = spec.box_size[2]
    spos_s = np.full((n_dev, S, 3), EMPTY_POS, np.float32)
    svel_s = np.zeros((n_dev, S, 3), np.float32)
    sf_s = np.zeros((n_dev, S, 3), np.float32)
    spidf_s = np.zeros((n_dev, S), np.float32)
    fill = [0] * n_dev
    for r in range(S):
        if spid[r] < 0:
            continue
        frac = (spos[r, 2] / Lz + 0.5) % 1.0
        sh = min(int(frac * nz), nz - 1) // nzl
        k = fill[sh]
        if k >= S:
            raise ValueError("per-shard straggler budget exceeded at init")
        spos_s[sh, k], svel_s[sh, k], sf_s[sh, k] = spos[r], svel[r], sforce[r]
        spidf_s[sh, k] = float(spid[r] + 1)
        fill[sh] = k + 1

    def put(a, i):
        return torch.from_numpy(np.array(a[i])).to(mesh.devices[i])

    seeds = _seeds(n_dev, seed)
    out.update(
        spos=[put(spos_s, i) for i in range(n_dev)], svelw=[put(svel_s, i) for i in range(n_dev)],
        sforce=[put(sf_s, i) for i in range(n_dev)], spidf=[put(spidf_s, i) for i in range(n_dev)],
        sref=[put(spos_s, i) for i in range(n_dev)],
        ovf=[torch.zeros((), dtype=torch.float32, device=d) for d in mesh.devices],
        stepc=[torch.tensor(int(seeds[i]), dtype=torch.int32, device=mesh.devices[i])
               for i in range(n_dev)])
    return MD2Shards(**out)


def md2_shards_from_numpy(arrays, mesh: Mesh) -> MD2Shards:
    """JAX's sharded state (its 21 arrays, or the first 20, gathered to
    numpy with the shard axis leading: [n_shards * nz_loc, ...] grids,
    [n_shards * S, ...] straggler rows, [n_shards] ovf and stepc) -> the
    port's state on ``mesh``. JAX's PRNG keys (the 21st array) are
    dropped."""
    n = mesh.size
    out = {}
    for name, a in zip(FIELDS, arrays):
        parts = np.split(np.asarray(a), n)
        dtype = torch.int32 if name == "stepc" else torch.float32
        ts = [torch.from_numpy(np.array(p)).to(device=mesh.devices[i], dtype=dtype)
              for i, p in enumerate(parts)]
        if name in ("ovf", "stepc"):
            ts = [t.reshape(()) for t in ts]
        out[name] = [t.contiguous() for t in ts]
    return MD2Shards(**out)


def md2_shards_to_numpy(state: MD2Shards) -> tuple:
    """The inverse of ``md2_shards_from_numpy``: the 20 arrays in JAX's
    order, each with the shards concatenated along axis 0."""
    return tuple(np.concatenate([np.atleast_1d(t.detach().cpu().numpy())
                                 for t in getattr(state, k)]) for k in FIELDS)


def gather_md2_state(state: MD2Shards, spec: GridSpec, n: int):
    """Sharded state -> (pos [N, 3], velw [N, 3]) in pid order (numpy)."""
    cols, pids = [], []
    for i in range(len(state.x)):
        grid = torch.stack([getattr(state, k)[i].reshape(-1)
                            for k in ("x", "y", "z", "wx", "wy", "wz")], dim=-1)
        cols += [grid, torch.cat([state.spos[i], state.svelw[i]], dim=-1)]
        pids += [state.pidf[i].reshape(-1), state.spidf[i]]
    allcols = torch.cat([c.cpu() for c in cols]).numpy()
    allpid = np.rint(torch.cat([p.cpu() for p in pids]).numpy()).astype(np.int64) - 1
    keep = allpid >= 0
    out = np.zeros((n, 6), np.float32)
    out[allpid[keep]] = allcols[keep]
    return out[:, :3], out[:, 3:]


def make_lj_domain2(mesh: Mesh, box_size, n: int, *, epsilon: float = 1.0, sigma: float = 1.0,
                    cutoff: float = 2.5, skin: float = 1.2, dt: float = 0.01,
                    temperature: float = 1.0, friction: float = 1.0, mass: float = 1.0,
                    cap: int | None = None, n_strag: int = 32, pos=None,
                    fast_recip: bool = False, seed: int = 0):
    """The reference benchmark system on the mesh: returns (step, state,
    spec, the single-chip engine used for the first forces)."""
    if pos is None:
        raise ValueError("pass initial positions (pos=[N, 3])")
    spec = choose_spec(box_size, n, cutoff, skin=skin, cap=cap, pos=pos, n_strag=n_strag,
                       nz_multiple=max(mesh.size, 1))
    md = _single_chip_md2(spec, epsilon, sigma, dt, temperature, friction, mass, fast_recip,
                          mesh.devices[0])
    gs = md.init(pos, seed=seed)
    step = make_domain_md2_step(mesh, spec, dt=dt, temperature=temperature, friction=friction,
                                mass=mass, epsilon=epsilon, sigma=sigma, fast_recip=fast_recip,
                                n_total=n)
    return step, shard_md2_state(md, gs, mesh, seed=seed), spec, md


def _single_chip_md2(spec, epsilon, sigma, dt, temperature, friction, mass, fast_recip,
                     device=None):
    """The single-chip engine with the DD step's settings: unfused (#7 +
    #11), stragglers min-imaged per pair, the self cell Newton-halved."""
    from ..engine.md2 import GridMD2

    gk = lj_g_fused(epsilon, sigma, rc2=spec.cutoff * spec.cutoff, approx=fast_recip)
    return GridMD2.create(spec, lj_g(epsilon, sigma), dt=dt, temperature=temperature,
                          friction=friction, mass=mass, g_fn_kernel=gk, fold_in_update=False,
                          self_half=True, strag_cellcenter=False, device=device)
