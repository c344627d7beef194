"""The composed multi-shard PSE step, v2: persistent sharded state.

Port of ``uammd_tpu/parallel/pse_dd2.py``. The near grid is the state:
each shard of a ``parallel.mesh.Mesh`` keeps its z-slab of slot positions
[nz_loc, nyb, CAP, NLANE] and its own [S] straggler list across steps
(``PSEDD2Shards``, JAX's 12-array state). One step, as phases over the
shards with the collectives between them:

1. the drift of every shard since its last rebin, ``pmax``'d: the step's
   one host read;
2. on drift, the shard-local two-sort rebin over the own slots, both
   neighbours' boundary rows and the own and neighbour straggler lists
   (``layout._bin_columns``; a ``psum`` count audit latches ``ovf``);
3. the ghost rows and the combined straggler list (own + distinct
   neighbours', ``combined_strag``);
4. the pair force: #2 with the fused LJ radial force functor
   (``pair_kernel.RadialForce``, halo mode, both directions over the
   combined rows), the partials on foreign stragglers routed home
   (``route_partials``), the straggler-straggler pairs in plain torch
   (``ss_apply``);
5. the near matvec: #2 with the PSE functor in the halo mode over the slots
   and the combined rows, the same routing and straggler pairs;
6. at T > 0 the distributed Lanczos (``pse_dd.lanczos_sqrt_apply_dd``)
   over the slots and the straggler rows;
7. the far bucketing: each z-shard sorts its particles into [D, m2]
   buckets by x-slab owner (overflow latches ``ovf``), one ``all_to_all``
   ships them to the x-shards of the far field (``spectral.ShardedFCM``)
   and a second brings the velocities back;
8. the EM update of the slots and straggler rows in place.

On one card every shard lives on the same device: a mesh there measures
the halo, routing and redistribution machinery, not interconnect traffic.
Noise comes from a ``torch.Generator``; ``step_z`` takes the draws
(``noise_g`` [3, nz, nyb, CAP, NLANE], ``noise_s`` [3, D S] and the far
per-shard white noise), so a test can feed JAX's (pse_dd2.py:493-508).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from ..engine.kernel2 import _box
from ..engine.layout import EMPTY_POS, _bin_columns, pack_channels, recip32, wrap
from ..engine.pair_kernel import RadialForce, make_pair_channel_kernel
from ..engine.pse_near import PSENear
from .domain import halo_extend
from .domain2 import _cell_of
from .mesh import Mesh, all_to_all, perm_dn, perm_up, pmax, ppermute, psum
from .pse_dd import lanczos_sqrt_apply_dd
from .spectral import make_sharded_fcm_mf


@dataclasses.dataclass
class PSEDD2Shards:
    """The sharded state: each field a list with one tensor per shard, in
    JAX's 12-tuple order: x, y, z (slot positions), pidf (pid + 1 as
    float32, 0 = empty), rx, ry, rz (slot positions at the last rebin),
    spos ([S, 3] straggler positions, EMPTY_POS on empties), spidf ([S]),
    sref ([S, 3] at the last rebin), ovf (0-d float32, latching overflow /
    lost-particle flag) and n_rebin (0-d int32)."""

    x: list
    y: list
    z: list
    pidf: list
    rx: list
    ry: list
    rz: list
    spos: list
    spidf: list
    sref: list
    ovf: list
    n_rebin: list

    def replace(self, **kw) -> "PSEDD2Shards":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(PSEDD2Shards))


def pse_dd2_state_from_numpy(arrays, mesh: Mesh) -> PSEDD2Shards:
    """JAX's state tuple (its 12 arrays gathered to numpy, the shard axis
    leading: [D nz_loc, ...] grids, [D S, 3] and [D S] straggler rows, [D]
    ovf and n_rebin) -> the port's state on ``mesh``."""
    n = mesh.size
    out = {}
    for name, a in zip(FIELDS, arrays):
        dtype = torch.int32 if name == "n_rebin" else torch.float32
        ts = [torch.from_numpy(np.array(p)).to(device=mesh.devices[i], dtype=dtype)
              for i, p in enumerate(np.split(np.asarray(a), n))]
        if name in ("ovf", "n_rebin"):
            ts = [t.reshape(()) for t in ts]
        out[name] = [t.contiguous() for t in ts]
    return PSEDD2Shards(**out)


def pse_dd2_state_to_numpy(state: PSEDD2Shards) -> tuple:
    """The inverse of ``pse_dd2_state_from_numpy``: JAX's 12 arrays, each
    with the shards concatenated along axis 0."""
    return tuple(np.concatenate([np.atleast_1d(t.detach().cpu().numpy())
                                 for t in getattr(state, k)]) for k in FIELDS)


def gather_positions(state: PSEDD2Shards, n: int) -> np.ndarray:
    """Sharded state -> [N, 3] positions in pid order (numpy, host side)."""
    cols, pids = [], []
    for i in range(len(state.x)):
        cols += [torch.stack([state.x[i].reshape(-1), state.y[i].reshape(-1),
                              state.z[i].reshape(-1)], dim=-1).cpu(), state.spos[i].cpu()]
        pids += [state.pidf[i].reshape(-1).cpu(), state.spidf[i].cpu()]
    allc = torch.cat(cols).numpy()
    allpid = np.rint(torch.cat(pids).numpy()).astype(np.int64) - 1
    keep = allpid >= 0
    out = np.zeros((n, 3), np.float32)
    out[allpid[keep]] = allc[keep]
    return out


class ShardedPSEStep2:
    """``step(state, gen) -> state``: one composed PSE v2 EM step over the
    mesh (see the module docstring); ``make_state(pos)`` builds the initial
    state. ``be`` is a ``PSEGrid`` created with ``nz_multiple = D`` and
    ``n_strag = S``, the PER-SHARD straggler budget. ``g_pair`` is the
    fused LJ radial (``md.lj_g_fused``) of the pair force, in the kernel and
    in the straggler-straggler pairs; ``rebins`` counts the steps that
    rebinned. ``span(name)`` opens a context around each named phase of a
    step (drift, rebin, halo, pair_force, matvec, lanczos, bucket, far,
    update): a no-op unless a profiler sets it."""

    span = staticmethod(lambda name: contextlib.nullcontext())

    def __init__(self, mesh: Mesh, be, *, g_pair, dt: float, temperature: float, n: int,
                 far_m2: int | None = None):
        spec = be.spec
        S = spec.n_strag
        if S <= 0:
            raise ValueError("the v2 composed PSE runs the straggler near grid (n_strag > 0)")
        D = mesh.size
        nx, ny, nz = spec.shape
        if nz % D:
            raise ValueError(f"near-grid nz {nz} must divide the {D}-shard mesh")
        nz_loc = nz // D
        if D > 1 and nz_loc < 2:
            raise ValueError("need >= 2 near-grid rows per shard")
        self.mesh, self.be, self.spec, self.n = mesh, be, spec, n
        self.D, self.S, self.nz_loc = D, S, nz_loc
        self.Ls = tuple(float(v) for v in spec.box_size)
        self.sf = float(np.float32(be.self_f))
        self.thr = float(np.float32(spec.drift_threshold))
        self.dt = dt
        self.temperature = temperature
        self.amp = math.sqrt(2.0 * temperature / dt) if temperature > 0 else 0.0
        self.g_pair = g_pair
        self.n_comb = S if D == 1 else (2 * S if D == 2 else 3 * S)
        # the kernels run on the halo-extended slab [nz_loc + 2, ...] with the
        # combined own + neighbour straggler lists
        self.local_spec = dataclasses.replace(spec, shape=(nx, ny, nz_loc + 2),
                                              n_strag=self.n_comb)
        self.rebin_spec = dataclasses.replace(spec, shape=(nx, ny, nz_loc))
        self.near_fn: PSENear = be.near_fn()
        self.nkern = make_pair_channel_kernel(self.local_spec, self.near_fn, 1, periodic_z=False)
        self.force_fn = RadialForce(g_pair)
        self.fkern = make_pair_channel_kernel(self.local_spec, self.force_fn, periodic_z=False)
        far = be.far
        self.far_mf = make_sharded_fcm_mf(
            mesh, be.box, viscosity=far.viscosity, radius=far.radius, shape=far.shape,
            support=far.support, rpy_sinc_radius=far.rpy_sinc_radius,
            hasimoto_k2=far.hasimoto_k2, noise=temperature > 0)
        # per (z-shard -> x-shard) bucket capacity
        self.far_m2 = (far_m2 if far_m2 is not None
                       else int(math.ceil(n / (D * D) * 2.5 / 8.0)) * 8 + 8)
        self.slots_loc = nz_loc * spec.nyb * spec.cap * spec.nlane
        self.m_loc = self.slots_loc + S
        self.rebins = 0

    # ------------------------------------------------------------- state
    def make_state(self, pos) -> PSEDD2Shards:
        """The initial sharded state from [N, 3] positions (host side, off
        the hot path): the global pack, its z-slabs, and the global
        straggler list dealt to the shards that own the rows' cells."""
        spec, D, S, nzl = self.spec, self.D, self.S, self.nz_loc
        dev0 = self.mesh.devices[0]
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev0)
        cg = pack_channels(spec, pos, torch.zeros((self.n, 0), device=dev0))
        nz = spec.shape[2]
        spos_np = cg.spos.cpu().numpy()
        spidf_np = (cg.spid + 1).to(torch.float32).cpu().numpy()
        spos_s = np.full((D, S, 3), EMPTY_POS, np.float32)
        spidf_s = np.zeros((D, S), np.float32)
        fill = [0] * D
        for r in range(S):
            if spidf_np[r] <= 0.5:
                continue
            frac = (spos_np[r, 2] / self.Ls[2] + 0.5) % 1.0
            sh = min(int(frac * nz), nz - 1) // nzl
            k = fill[sh]
            if k >= S:
                raise ValueError("per-shard straggler budget exceeded")
            spos_s[sh, k] = spos_np[r]
            spidf_s[sh, k] = spidf_np[r]
            fill[sh] = k + 1
        pidf = (cg.pid + 1).to(torch.float32)
        devs = self.mesh.devices

        def slabs(a):
            return [a[i * nzl:(i + 1) * nzl].to(d, copy=True) for i, d in enumerate(devs)]

        def rows(a):
            return [torch.from_numpy(np.array(a[i])).to(d) for i, d in enumerate(devs)]

        ovf = float(bool(cg.overflow))
        return PSEDD2Shards(
            x=slabs(cg.x), y=slabs(cg.y), z=slabs(cg.z), pidf=slabs(pidf),
            rx=slabs(cg.x), ry=slabs(cg.y), rz=slabs(cg.z),
            spos=rows(spos_s), spidf=rows(spidf_s), sref=rows(spos_s),
            ovf=[torch.tensor(ovf, dtype=torch.float32, device=d) for d in devs],
            n_rebin=[torch.zeros((), dtype=torch.int32, device=d) for d in devs])

    # ------------------------------------------------------------ pieces
    def drift(self, st: PSEDD2Shards) -> list:
        """Each shard's largest drift since its last rebin (slots and
        straggler rows), ``pmax``'d."""
        out = []
        for i in range(self.D):
            m = st.pidf[i] > 0.5
            d = torch.maximum(torch.abs(st.x[i] - st.rx[i]),
                              torch.maximum(torch.abs(st.y[i] - st.ry[i]),
                                            torch.abs(st.z[i] - st.rz[i])))
            zero = torch.zeros((), device=d.device)
            dinf = torch.where(m, d, zero).max()
            sm = (st.spidf[i] > 0.5)[:, None]
            dinf = torch.maximum(dinf, torch.where(sm, torch.abs(st.spos[i] - st.sref[i]),
                                                   zero).max())
            out.append(dinf)
        return pmax(out)

    def rebin(self, st: PSEDD2Shards):
        """The shard-local two-sort rebin (pse_dd2.py:204-290): returns
        (x, y, z, pidf, spos, spidf, ovf) lists."""
        D, S, nzl, spec = self.D, self.S, self.nz_loc, self.spec
        nx, ny, nz = spec.shape
        F, nyb, nlane = spec.fold, spec.nyb, spec.nlane
        stacks = [torch.stack([st.x[i], st.y[i], st.z[i], st.pidf[i]]) for i in range(D)]
        slists = [torch.cat([st.spos[i], st.spidf[i][:, None]], dim=1).T for i in range(D)]
        pools = [[s.reshape(4, -1)] for s in stacks]
        extra = [[sl] for sl in slists]
        if D > 1:
            from_dn = ppermute([s[:, -1:] for s in stacks], perm_up(D))
            from_up = ppermute([s[:, :1] for s in stacks], perm_dn(D))
            dn_s = ppermute(slists, perm_up(D))
            up_s = ppermute(slists, perm_dn(D)) if D > 2 else None
            for i in range(D):
                pools[i] += [from_dn[i].reshape(4, -1), from_up[i].reshape(4, -1)]
                extra[i].append(dn_s[i])
                if up_s is not None:
                    extra[i].append(up_s[i])
        ncell_loc = nzl * nyb * nlane
        out = {k: [] for k in ("x", "y", "z", "pidf", "spos", "spidf")}
        counts, ovfs = [], []
        for i in range(D):
            pool = torch.cat(pools[i] + extra[i], dim=1)
            valid = pool[3] > 0.5
            empty = torch.full_like(pool[0], EMPTY_POS)
            w = [torch.where(valid, wrap(pool[c], self.Ls[c]), empty) for c in range(3)]
            cx = _cell_of(w[0], self.Ls[0], nx)
            cy = _cell_of(w[1], self.Ls[1], ny)
            cz = _cell_of(w[2], self.Ls[2], nz)
            z0 = i * nzl
            mine = valid & (cz >= z0) & (cz < z0 + nzl)
            yb = cy // F
            lane = cx * F + (cy - yb * F)
            key = ((cz - z0) * nyb + yb) * nlane + lane
            key = torch.where(mine, key, torch.full_like(key, ncell_loc))
            binned, strag, o = _bin_columns(self.rebin_spec, key, (w[0], w[1], w[2], pool[3]),
                                            (None, None, None, 0.0))
            for k, b in zip(("x", "y", "z", "pidf"), binned):
                out[k].append(b)
            out["spos"].append(torch.stack(strag[0:3], dim=-1))
            out["spidf"].append(strag[3])
            counts.append((binned[3] > 0.5).sum() + (strag[3] > 0.5).sum())
            ovfs.append(o.to(torch.float32))
        totals = psum(counts)
        out["ovf"] = [st.ovf[i] + ovfs[i] + (totals[i] != self.n).to(torch.float32)
                      for i in range(D)]
        return out

    def combined_strag(self, spos, spidf) -> list:
        """Own + distinct neighbours' straggler lists [n_comb, 4] (x, y, z,
        valid). The minimum image puts each grid-straggler pair on exactly
        one shard; on 1 or 2 shards the aliased neighbour copies are left
        out."""
        D = self.D
        own = [torch.cat([spos[i], (spidf[i] > 0.5)[:, None].to(torch.float32)], dim=1)
               for i in range(D)]
        if D == 1:
            return own
        dn = ppermute(own, perm_up(D))
        if D == 2:
            return [torch.cat([own[i], dn[i]]) for i in range(D)]
        up = ppermute(own, perm_dn(D))
        return [torch.cat([own[i], dn[i], up[i]]) for i in range(D)]

    def comb_rows(self, sg3) -> list:
        """The own straggler channel rows [3, S] extended to the combined
        list [3, n_comb] (the neighbours' values ppermuted alongside)."""
        D = self.D
        if D == 1:
            return list(sg3)
        dn = ppermute(sg3, perm_up(D))
        if D == 2:
            return [torch.cat([sg3[i], dn[i]], dim=1) for i in range(D)]
        up = ppermute(sg3, perm_dn(D))
        return [torch.cat([sg3[i], dn[i], up[i]], dim=1) for i in range(D)]

    def route_partials(self, part) -> list:
        """[n_comb, 3] partials on the combined lists -> [S, 3] totals on
        each shard's own stragglers (its own segment plus the segments the
        neighbours computed, ppermuted home)."""
        D, S = self.D, self.S
        tot = [p[:S] for p in part]
        if D == 1:
            return tot
        back = ppermute([p[S:2 * S] for p in part], perm_dn(D))
        tot = [t + b for t, b in zip(tot, back)]
        if D == 2:
            return tot
        back = ppermute([p[2 * S:3 * S] for p in part], perm_up(D))
        return [t + b for t, b in zip(tot, back)]

    def ss_apply(self, pair_eval, own, own_val, comb, comb_val, ch_comb=()):
        """Straggler-straggler terms on the own rows (minimum image; the self
        pair masked by r2 > 1e-12): ``pair_eval(r2, dx, dy, dz, ch_j)`` on
        [S, n_comb, 1] blocks, summed over the combined list -> [S, 3]."""
        Ls, iLs = _box(self.Ls, own.device)
        d = comb[None, :, :] - own[:, None, :]
        d = d - Ls * torch.round(d * iLs)
        r2 = torch.sum(d * d, dim=-1)
        ok = own_val[:, None] & comb_val[None, :] & (r2 > 1e-12)
        r2m = torch.where(ok, r2, torch.full_like(r2, 1.0e18))[:, :, None]
        ch_j = [c[None, :, None] for c in ch_comb]
        out = pair_eval(r2m, d[:, :, 0:1], d[:, :, 1:2], d[:, :, 2:3], ch_j)
        return torch.stack([torch.sum(o, dim=1)[:, 0] for o in out], dim=-1)

    def bblock(self, comb, channels=()):
        """The broadcast straggler block of the halo kernels [3 + C + 1,
        n_comb, NLANE] (positions, channels, validity)."""
        stack = torch.stack([comb[:, 0], comb[:, 1], comb[:, 2], *channels, comb[:, 3]])
        return stack[:, :, None].expand(stack.shape[0], self.n_comb, self.local_spec.nlane)

    def pair_force(self, ext, masks, comb, spos, sm):
        """The pair force on the slots (lists of [nz_loc, ...] x 3) and the
        own straggler rows ([S, 3])."""
        D = self.D
        f, parts = [[], [], []], []
        for i in range(D):
            fo = self.fkern(ext[0][i], ext[1][i], ext[2][i], strag=self.bblock(comb[i]))
            for c in range(3):
                f[c].append(fo[c][1:-1] * masks[i])
            parts.append(torch.stack(fo[3:6], dim=-1))
        sp = self.route_partials(parts)
        g = self.g_pair

        def wca(r2, dx, dy, dz, ch_j):
            gv = g(r2)
            return gv * dx, gv * dy, gv * dz

        sforce = [(sp[i] + self.ss_apply(wca, spos[i], sm[i], comb[i][:, :3], comb[i][:, 3] > 0.5))
                  * sm[i][:, None] for i in range(D)]
        return f, sforce

    def matvec(self, ext, masks, comb, spos, sm, g3, sg3):
        """M_near on the sharded slot vectors ``g3`` ([3, nz_loc, ...] per
        shard) and straggler rows ``sg3`` ([3, S] per shard): returns the
        same structure."""
        with self.span("matvec"):
            D = self.D
            hg = halo_extend(g3, dim=1)
            cr = self.comb_rows(sg3)
            v, parts = [], []
            for i in range(D):
                o = self.nkern(ext[0][i], ext[1][i], ext[2][i], hg[i][0], hg[i][1], hg[i][2],
                               strag=self.bblock(comb[i], tuple(cr[i])))
                v.append(torch.stack([(o[c][1:-1] + self.sf * g3[i][c]) * masks[i]
                                      for c in range(3)]))
                parts.append(torch.stack(o[3:6], dim=-1))
            own = self.route_partials(parts)
            fn = self.near_fn
            sv = []
            for i in range(D):
                ss = self.ss_apply(lambda r2, dx, dy, dz, ch_j: fn.pair(r2, dx, dy, dz, ch_j, 1),
                                   spos[i], sm[i], comb[i][:, :3], comb[i][:, 3] > 0.5,
                                   tuple(cr[i]))
                sv.append(((own[i] + ss + self.sf * sg3[i].T) * sm[i][:, None]).T)
            return v, sv

    def bucket(self, x, y, z, mask, spos, sm, f3, sforce):
        """The far-bound bucketing of one shard (pse_dd2.py:390-451): [D, m2,
        7] buckets (x, y, z, fx, fy, fz, valid) by x-slab owner, the local
        row of each bucket entry ([D, m2], m_loc on empties), and the
        overflow (0-d float32)."""
        D, m2, m_loc = self.D, self.far_m2, self.m_loc
        dev = x.device
        lval = torch.cat([mask.reshape(-1) > 0.5, sm])
        lx = torch.cat([x.reshape(-1), spos[:, 0]])
        ly = torch.cat([y.reshape(-1), spos[:, 1]])
        lz = torch.cat([z.reshape(-1), spos[:, 2]])
        zero = torch.zeros((), device=dev)
        xw = wrap(lx, self.Ls[0])
        owner = torch.clamp((torch.remainder(xw * recip32(self.Ls[0]) + 0.5, 1.0) * D)
                            .to(torch.int64), 0, D - 1)
        owner = torch.where(lval, owner, torch.full_like(owner, D))
        cols = torch.stack([
            torch.where(lval, xw, zero), torch.where(lval, wrap(ly, self.Ls[1]), zero),
            torch.where(lval, wrap(lz, self.Ls[2]), zero),
            torch.cat([f3[0].reshape(-1), sforce[:, 0]]),
            torch.cat([f3[1].reshape(-1), sforce[:, 1]]),
            torch.cat([f3[2].reshape(-1), sforce[:, 2]]), lval.to(torch.float32)], dim=-1)
        key_s, order = torch.sort(owner, stable=True)
        rank = torch.arange(m_loc, device=dev) - torch.searchsorted(key_s, key_s, right=False)
        real = key_s < D
        kept = real & (rank < m2)
        ovf = (real & ~kept).any().to(torch.float32)
        slot = torch.where(kept, key_s * m2 + rank, torch.full_like(rank, D * m2))
        buckets = torch.zeros((D * m2 + 1, 7), dtype=torch.float32, device=dev)
        tags = torch.full((D * m2 + 1,), m_loc, dtype=torch.int64, device=dev)
        buckets[slot] = cols[order]
        tags[slot] = order
        return buckets[: D * m2].reshape(D, m2, 7), tags[: D * m2].reshape(D, m2), ovf

    # -------------------------------------------------------------- step
    def draw(self, gen: torch.Generator):
        """(noise_g [3, nz, nyb, CAP, NLANE], noise_s [3, D S], far per-shard
        white noise) from ``gen``."""
        dev = self.mesh.devices[0]
        ng = torch.randn((3,) + self.spec.array_shape, generator=gen, device=dev)
        ns = torch.randn((3, self.D * self.S), generator=gen, device=dev)
        return ng, ns, self.far_mf.draw(gen)

    def __call__(self, st: PSEDD2Shards, gen: torch.Generator | None = None) -> PSEDD2Shards:
        if self.temperature > 0:
            return self.step_z(st, *self.draw(gen))
        return self.step_z(st)

    def step_z(self, st: PSEDD2Shards, noise_g=None, noise_s=None, far_noise=None,
               force_rebin: bool = False) -> PSEDD2Shards:
        """One step with the draws given (T > 0); ``force_rebin`` rebins
        whatever the drift."""
        D, S, nzl = self.D, self.S, self.nz_loc
        devs = self.mesh.devices
        x, y, z, pidf = list(st.x), list(st.y), list(st.z), list(st.pidf)
        rx, ry, rz = list(st.rx), list(st.ry), list(st.rz)
        spos, spidf, sref = list(st.spos), list(st.spidf), list(st.sref)
        ovf, nreb = list(st.ovf), list(st.n_rebin)
        # ---- drift-triggered shard-local rebin: the step's one host read
        with self.span("drift"):
            rebin = force_rebin or float(self.drift(st)[0]) > self.thr
        if rebin:
            with self.span("rebin"):
                out = self.rebin(st)
            x, y, z, pidf = out["x"], out["y"], out["z"], out["pidf"]
            spos, spidf, ovf = out["spos"], out["spidf"], out["ovf"]
            rx, ry, rz, sref = list(x), list(y), list(z), list(spos)
            nreb = [r + 1 for r in nreb]
            self.rebins += 1
        with self.span("halo"):
            masks = [(p > 0.5).to(torch.float32) for p in pidf]
            sm = [s > 0.5 for s in spidf]
            Lz = self.Ls[2]
            ext = (halo_extend(x), halo_extend(y), halo_extend(z, -Lz, Lz))
            comb = self.combined_strag(spos, spidf)
        # ---- pair force, then M_near on it
        with self.span("pair_force"):
            f, sforce = self.pair_force(ext, masks, comb, spos, sm)
        f3 = [torch.stack([f[0][i], f[1][i], f[2][i]]) for i in range(D)]
        sfT = [s.T.contiguous() for s in sforce]
        v3, sv3 = self.matvec(ext, masks, comb, spos, sm, f3, sfT)
        if self.temperature > 0:
            T = self.slots_loc
            shp = f3[0].shape

            def mv_flat(vs):
                gg = [v[: 3 * T].reshape(shp) for v in vs]
                gs = [v[3 * T:].reshape(3, S) for v in vs]
                ov, osv = self.matvec(ext, masks, comb, spos, sm, gg, gs)
                return [torch.cat([a.reshape(-1), b.reshape(-1)]) for a, b in zip(ov, osv)]

            v0 = [torch.cat([(noise_g[:, i * nzl:(i + 1) * nzl].to(d) * masks[i][None])
                             .reshape(-1),
                             (noise_s[:, i * S:(i + 1) * S].to(d) * sm[i][None]).reshape(-1)])
                  for i, d in enumerate(devs)]
            with self.span("lanczos"):
                b = lanczos_sqrt_apply_dd(mv_flat, v0, self.be.lanczos_iterations)
            a = float(np.float32(self.amp))
            v3 = [v + a * bb[: 3 * T].reshape(shp) for v, bb in zip(v3, b)]
            sv3 = [s + a * bb[3 * T:].reshape(3, S) * smi[None]
                   for s, bb, smi in zip(sv3, b, sm)]
        # ---- far: bucket by x-slab owner, all_to_all there and back
        bks, tags = [], []
        with self.span("bucket"):
            for i in range(D):
                bk, tg, o = self.bucket(x[i], y[i], z[i], masks[i], spos[i], sm[i], f3[i],
                                        sforce[i])
                bks.append(bk)
                tags.append(tg)
                ovf[i] = ovf[i] + o
        with self.span("far"):
            far_in = [t.reshape(D * self.far_m2, 7) for t in all_to_all(bks, 0, 0)]
            mf_args = ([t[:, 0:3] for t in far_in], [t[:, 3:6] for t in far_in],
                       [t[:, 6] > 0.5 for t in far_in])
            if self.temperature > 0:
                vel = self.far_mf(*mf_args, far_noise, np.float32(self.amp))
            else:
                vel = self.far_mf(*mf_args)
            vb = all_to_all([v.reshape(D, self.far_m2, 3) for v in vel], 0, 0)
        with self.span("update"):
            return self._update(x, y, z, pidf, rx, ry, rz, spos, spidf, sref, ovf, nreb, masks,
                                sm, v3, sv3, tags, vb)

    def _update(self, x, y, z, pidf, rx, ry, rz, spos, spidf, sref, ovf, nreb, masks, sm, v3,
                sv3, tags, vb) -> PSEDD2Shards:
        """The far velocities scattered to their rows and the EM update of
        the slots and straggler rows."""
        D = self.D
        devs = self.mesh.devices
        dt = float(np.float32(self.dt))
        nx_, ny_, nz_, nsp = [], [], [], []
        for i in range(D):
            flat = torch.zeros((self.m_loc + 1, 3), dtype=torch.float32, device=devs[i])
            flat.index_add_(0, tags[i].reshape(-1), vb[i].reshape(-1, 3))
            slot_far = flat[: self.slots_loc].reshape(x[i].shape + (3,))
            strag_far = flat[self.slots_loc: self.m_loc]
            m = masks[i]
            nx_.append(x[i] + dt * m * (v3[i][0] + slot_far[..., 0]))
            ny_.append(y[i] + dt * m * (v3[i][1] + slot_far[..., 1]))
            nz_.append(z[i] + dt * m * (v3[i][2] + slot_far[..., 2]))
            zero = torch.zeros((), device=devs[i])
            nsp.append(spos[i] + dt * torch.where(sm[i][:, None], sv3[i].T + strag_far, zero))
        return PSEDD2Shards(x=nx_, y=ny_, z=nz_, pidf=pidf, rx=rx, ry=ry, rz=rz, spos=nsp,
                            spidf=spidf, sref=sref, ovf=ovf, n_rebin=nreb)


def make_sharded_pse_em_step2(mesh: Mesh, be, *, g_pair, dt: float, temperature: float, n: int,
                              far_m2: int | None = None) -> ShardedPSEStep2:
    """Build the composed PSE v2 step (``ShardedPSEStep2``; its
    ``make_state`` builds the state), the JAX package's
    ``make_sharded_pse_em_step2`` with the mesh axis implied."""
    return ShardedPSEStep2(mesh, be, g_pair=g_pair, dt=dt, temperature=temperature, n=n,
                           far_m2=far_m2)
