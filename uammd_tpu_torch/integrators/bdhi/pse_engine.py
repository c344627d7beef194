"""Grid-resident PSE: Ewald-split RPY Brownian dynamics at large N.

Port of ``uammd_tpu/integrators/bdhi/pse_engine.py`` (reference:
src/Integrator/BDHI/PSE/BDHI_PSE.cuh:1-70, NearField.cuh, FarField.cuh).
The periodic RPY mobility is split into

- a near field, the short-ranged remainder M_RPY(r) - M_blob(r) fitted with
  piecewise polynomials (``engine/pse_near.py``) and applied on the
  cell-resident layout of ``engine/layout.py`` (``pack_channels``): on CUDA
  tensors by the Newton channel kernel (#10) and its n-channel fold (#9),
  on CPU tensors by the 27-stencil kernel's plain version (#2), as the JAX
  package picks by backend; its Brownian noise is a Lanczos sqrt in slot
  space (the padded operator is block diagonal, [M, 0], so the Krylov
  space stays physical);
- a far field, FCM with the PSE envelope (``fcm.FCM`` with
  ``rpy_sinc_radius`` and ``hasimoto_k2``) over the pencil kernels
  #13/#14, with M F and the k-space noise in one spectral pass.

The persistent EM step (``displacement_with_pair_force_persistent``)
carries the near pid layout and the far pencil bins across steps
(``PSEStepState``) and rebins each on drift: the near grid with the
separable slot rebin (#5, n_q = 4, ocap 16), the far pencils with
``bin_pencils``. The JAX package decides both inside the compiled step
(``lax.cond``); here both drift flags come to the host in one transfer,
the step's one host read. The WCA pair force of ``make_pair_force_slots``
runs on the same pack (#6 + #7).

Noise comes from a ``torch.Generator`` instead of ``jax.random``; each
noisy entry point has a form that takes the drawn vectors (``*_z``), so a
test can feed JAX's draws. The JAX package's fallbacks have no
counterpart: the 6-channel fused pass runs or raises (no VMEM probe),
there is no environment switch for the Newton kernel, and the unfused
near pass is an explicit argument (``fused=False``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core.box import Box
from ...device import resolve_device
from ...engine.kernel2 import (
    _box,
    broadcast_stragglers,
    make_fold_kernel,
    make_newton_channel_kernel,
    make_newton_pair_kernel,
    straggler_pair_forces,
)
from ...engine.layout import (
    EMPTY_POS,
    ChannelGrid,
    choose_spec,
    pack_channels,
    unpack_values,
    wrap,
)
from ...engine.pair_kernel import broadcast_strag_channels, make_pair_channel_kernel
from ...engine.pse_near import PSENear
from ...engine.rebin_kernel import compact_mini_pids, make_separable_rebin
from ...solvers.lanczos import (
    lanczos_iterations_for_tolerance,
    lanczos_sqrt_apply,
    lanczos_tridiag,
)
from ...solvers.pencil_ibm import PencilBins
from .fcm import FCM
from .pse import _blob_fg, _rpy_fg


@dataclasses.dataclass
class PSEStepState:
    """Persistent binning state of the slot-resident EM loop: the near-grid
    pid layout, the far pencil bins and the positions each was built at.

    ``ovf_near`` (the near pack ran out of straggler rows, or a cell passed
    CAP + 16 in the rebin) and ``ovf_far`` (a far pencil passed its cap)
    are latching 0-d bool tensors; ``overflow`` combines them. The rebin
    counters are host integers (the JAX package keeps device int32)."""

    pid: torch.Tensor  # near grid [nz, nyb, CAP, NLANE] int32
    spid: torch.Tensor  # near stragglers [S] int32
    ref: torch.Tensor  # [N, 3] wrapped positions at near bin time
    far_pids: torch.Tensor  # pencil bins [npen, cap] int32
    far_slot_of_pid: torch.Tensor  # [N] int32
    far_ref: torch.Tensor  # [N, 2] xy at far bin time
    ovf_near: torch.Tensor
    ovf_far: torch.Tensor
    n_rebin_near: int = 0
    n_rebin_far: int = 0

    @property
    def overflow(self) -> torch.Tensor:
        return self.ovf_near | self.ovf_far


_STEP_ARRAYS = ("pid", "spid", "ref", "far_pids", "far_slot_of_pid", "far_ref",
                "ovf_near", "ovf_far")


def pse_step_state_from_numpy(fields: dict, device=None) -> PSEStepState:
    """A PSEStepState on ``device`` from numpy arrays, e.g. a JAX
    PSEStepState's fields."""
    dev = resolve_device(device)
    dtypes = {"pid": torch.int32, "spid": torch.int32, "far_pids": torch.int32,
              "far_slot_of_pid": torch.int32, "ovf_near": torch.bool, "ovf_far": torch.bool}
    kw = {k: torch.from_numpy(np.array(fields[k])).to(device=dev,
                                                       dtype=dtypes.get(k, torch.float32))
          for k in _STEP_ARRAYS}
    return PSEStepState(**kw, n_rebin_near=int(fields.get("n_rebin_near", 0)),
                        n_rebin_far=int(fields.get("n_rebin_far", 0)))


def pse_step_state_to_numpy(st: PSEStepState) -> dict:
    out = {k: getattr(st, k).detach().cpu().numpy() for k in _STEP_ARRAYS}
    out["n_rebin_near"] = st.n_rebin_near
    out["n_rebin_far"] = st.n_rebin_far
    return out


def _stack_flat(vs, svs=None):
    """(3 grids[, 3 straggler rows]) -> the flat Krylov vector [3 (T + S)]."""
    flat = torch.stack(list(vs)).reshape(3, -1)
    if svs is not None:
        flat = torch.cat([flat, torch.stack(list(svs)).reshape(3, -1)], dim=1)
    return flat.reshape(-1)


@dataclasses.dataclass(frozen=True)
class PSEGrid:
    """Grid-resident split-RPY backend (plugs into bdhi_euler_maruyama)."""

    box: Box
    far: FCM
    viscosity: float
    radius: float
    xi: float
    rcut: float
    spec: object  # engine GridSpec
    qb: float  # piecewise split r / rcut of the RPY kink
    coef: tuple  # (f1, f2, g1, g2) power coefficients
    uscale: tuple  # per piece (a, b): u = a q + b maps the piece to [-1, 1]
    self_f: float
    fit_error: float
    lanczos_iterations: int = 12
    # the shorter Horner of the Lanczos-only noise matvecs (None: ``coef``)
    coef_noise: tuple | None = None
    fit_error_noise: float = 0.0
    # far pencil-bin slack (grid points of x/y drift before a rebin)
    far_slack: int = 1
    # extra per-pencil capacity rows on top of pencil_ibm.default_cap
    far_cap_extra: int = 0

    # per-cell overflow depth of the near-grid slot rebin: a cell above
    # CAP + 16 latches ovf_near
    NEAR_REBIN_OCAP = 16

    @staticmethod
    def create(box: Box, n: int, viscosity=1.0, radius=1.0, xi: float | None = None,
               tolerance: float = 1e-4, points_per_width: float = 1.1, support: int | None = 8,
               deg: int = 12, noise_deg: int = 10, lanczos_iterations: int = 12,
               cap: int | None = None, prefer_pow2: bool = False, pos=None,
               far_grid: int | None = None, n_strag: int = 0, nz_multiple: int = 1,
               near_skin: float = 1.0):
        """The JAX package's ``PSEGrid.create`` (pse_engine.py:128-250): the
        same split, cutoff, grid spec, far FCM, Chebyshev -> power fits and
        self term for the same arguments. ``far_grid`` pins the far FFT size
        per axis and derives xi from it; ``pos`` sizes the near CAP from the
        measured occupancy; ``n_strag`` with ``pos`` moves the occupancy tail
        into a straggler list; ``nz_multiple`` floors the near grid's nz to a
        multiple of it, so that a z-slab mesh of that many shards divides
        it (``parallel/pse_dd.py``, ``pse_dd2.py``)."""
        if support is None:
            support = 2 * math.ceil(points_per_width * math.sqrt(2.0 * math.log(1.0 / tolerance)))
            support = int(min(16, max(6, support)))
        Ls = list(box.lengths)
        if far_grid is not None:
            xi = 0.5 * far_grid / (points_per_width * max(Ls))
        if xi is None:
            xi = 0.5 / radius
        sigma_split = 0.5 / xi
        sigma_c = math.sqrt(2.0) * sigma_split
        # +radius: the surface-sphere convolutions push the remainder's decay
        # outward by ~2a; one radius keeps its truncation below tolerance
        rcut = sigma_c * math.sqrt(2.0 * math.log(1.0 / tolerance)) + radius
        rcut = max(rcut, 2.0 * radius * 1.05)
        far = FCM.create(
            box, viscosity=viscosity, radius=sigma_split * math.sqrt(math.pi),
            points_per_radius=points_per_width * math.sqrt(math.pi),
            support=support, prefer_pow2=prefer_pow2,
            rpy_sinc_radius=radius, hasimoto_k2=sigma_split * sigma_split,
        )
        if torch.is_tensor(pos):
            pos = pos.detach().cpu().numpy()
        spec = choose_spec(Ls, n, rcut, skin=float(near_skin), cap=cap, pos=pos,
                           n_strag=n_strag, strag_cell_excess=1 << 30, strag_headroom=1.5,
                           ocap=None, nz_multiple=nz_multiple)

        qb = min(2.0 * radius / rcut, 1.0)
        m0 = 1.0 / (6.0 * math.pi * viscosity * radius)

        def near_fg(r):
            fb, gb = _blob_fg(r, sigma_c, viscosity, a=radius)
            fr, gr = _rpy_fg(r, radius, viscosity)
            return fr - fb, gr - gb

        # the remainder on each piece's sample points, shared by both fits
        pieces = []
        for lo, hi in ((1e-7, qb), (qb, 1.0)):
            q = np.linspace(lo, hi, 2500)
            pieces.append((lo, hi, (2.0 * q - hi - lo) / (hi - lo), near_fg(q * rcut)))

        # each piece as a power series in the centred u in [-1, 1] (from a
        # Chebyshev fit), so the float32 Horner stays well conditioned
        def fit_deg(d):
            coefs, scales, err = [], [], 0.0
            for lo, hi, u, (fv, gv) in pieces:
                for yv in (fv, gv):
                    ch = np.polynomial.chebyshev.Chebyshev.fit(u, yv, d, domain=[-1, 1])
                    pcs = np.polynomial.chebyshev.cheb2poly(ch.coef)
                    err = max(err, float(np.abs(
                        np.polynomial.polynomial.polyval(u, pcs) - yv).max() / m0))
                    coefs.append(tuple(float(c) for c in pcs))
                scales.append((2.0 / (hi - lo), -(hi + lo) / (hi - lo)))
            # collected (f1, g1, f2, g2) -> (f1, f2, g1, g2)
            return (coefs[0], coefs[2], coefs[1], coefs[3]), tuple(scales), err

        coef, uscale, fit_err = fit_deg(deg)
        # the noise matvecs' accuracy bar is the Lanczos residual (1e-3
        # class, LanczosAlgorithm.cuh:40-56): a shorter Horner serves them
        coef_noise, _, fit_err_noise = fit_deg(min(deg, noise_deg))
        f0b, _ = _blob_fg(np.array([0.0]), sigma_c, viscosity, a=radius)
        return PSEGrid(
            box=box, far=far, viscosity=viscosity, radius=radius, xi=xi, rcut=float(rcut),
            spec=spec, qb=float(qb), coef=coef, uscale=uscale, self_f=float(m0 - f0b[0]),
            fit_error=fit_err, lanczos_iterations=lanczos_iterations,
            coef_noise=coef_noise, fit_error_noise=fit_err_noise,
        )

    # ------------------------------------------------------------- kernels
    def near_fn(self, noise: bool = False) -> PSENear:
        """The near-field functor (``noise``: the shorter noise Horner)."""
        coef = self.coef_noise if noise and self.coef_noise is not None else self.coef
        return PSENear(coef=coef, uscale=self.uscale, qb=self.qb, rcut=self.rcut)

    def _cache(self, name: str) -> dict:
        return self.__dict__.setdefault(name, {})

    def _kernel(self, nvec: int = 1, newton: bool | None = None, noise: bool = False):
        """The near-field channel kernel on ``nvec`` 3-vectors: the Newton
        kernel #10 (with the fold #9) when ``newton``, else the 27-stencil
        kernel #2. ``newton=None`` picks #10 for CUDA tensors and #2 (its
        plain version) for CPU tensors, as the JAX package picks by
        backend."""
        if newton is None:
            k_newton = self._kernel(nvec, True, noise)
            k_27 = self._kernel(nvec, False, noise)
            return lambda x, *a, **kw: (k_newton if x.is_cuda else k_27)(x, *a, **kw)
        cache = self._cache("_kern_cache")
        key = (nvec, newton, noise)
        if key not in cache:
            make = make_newton_channel_kernel if newton else make_pair_channel_kernel
            cache[key] = make(self.spec, self.near_fn(noise), nvec)
        return cache[key]

    def _near_rebin(self):
        """The separable slot rebin (#5) of the near grid, n_q = 4."""
        cache = self._cache("_rebin_cache")
        if "k" not in cache:
            cache["k"] = make_separable_rebin(self.spec, ocap=self.NEAR_REBIN_OCAP)
        return cache["k"]

    # --------------------------------------------------------- slot space
    def _strag_radial(self, cg: ChannelGrid, noise: bool):
        """(f, g / r2, d) of every straggler-straggler pair (minimum image,
        invalid rows and the diagonal masked), made once per ChannelGrid
        and radial: a step applies M_near m + 1 times to the same rows."""
        cache = cg.__dict__.setdefault("_strag_radial", {})
        if noise not in cache:
            spos, spid = cg.spos, cg.spid
            Ls, iLs = _box(self.spec.box_size, spos.device)
            val = spid >= 0
            d = spos[None, :, :] - spos[:, None, :]
            d = d - Ls * torch.round(d * iLs)
            r2 = torch.sum(d * d, dim=-1)
            ok = val[None, :] & val[:, None]
            ok = ok & ~torch.eye(spos.shape[0], dtype=torch.bool, device=spos.device)
            r2m = torch.where(ok, r2, torch.full_like(r2, 1.0e18))[:, :, None]
            f, ginv2 = self.near_fn(noise).radial(r2m)
            cache[noise] = (f, ginv2, (d[:, :, 0:1], d[:, :, 1:2], d[:, :, 2:3]))
        return cache[noise]

    def _strag_pair_apply(self, cg: ChannelGrid, sf3, noise: bool = False):
        """O(S^2) straggler-straggler near-field contributions, 3 x [S]
        (the channel kernels cover grid <-> straggler)."""
        f, ginv2, (dx, dy, dz) = self._strag_radial(cg, noise)
        ch_j = [c[None, :, None] for c in sf3]
        out = PSENear.apply_dir(f, ginv2, dx, dy, dz, ch_j)
        return tuple(torch.sum(o, dim=1)[:, 0] for o in out)

    def _strag_rows(self, cg: ChannelGrid, outs, sfs, noise=False):
        """Straggler rows of M_near: grid -> straggler totals + the O(S^2)
        pairs + the self term, zero on empty rows."""
        sf = float(np.float32(self.self_f))
        smask = (cg.spid >= 0).to(torch.float32)
        ss = self._strag_pair_apply(cg, sfs, noise=noise)
        return tuple((p + s + sf * f) * smask for p, s, f in zip(outs, ss, sfs))

    def near_matvec_slots(self, cg: ChannelGrid, fx, fy, fz, sf3=None, noise: bool = False):
        """M_near on slot-space vectors (fx, fy, fz [nz, nyb, CAP, NLANE],
        plus sf3 = 3 x [S] with a straggler list): (vx, vy, vz[, sv3])."""
        sf = float(np.float32(self.self_f))
        if self.spec.n_strag == 0:
            vx, vy, vz = self._kernel(noise=noise)(cg.x, cg.y, cg.z, fx, fy, fz)
            return vx + sf * fx, vy + sf * fy, vz + sf * fz
        blk = broadcast_strag_channels(self.spec, cg.spos, tuple(sf3), cg.spid)
        outs = self._kernel(noise=noise)(cg.x, cg.y, cg.z, fx, fy, fz, strag=blk)
        vx, vy, vz = (o + sf * f for o, f in zip(outs[:3], (fx, fy, fz)))
        return vx, vy, vz, self._strag_rows(cg, outs[3:6], tuple(sf3), noise)

    def near_matvec2_slots(self, cg: ChannelGrid, f3a, f3b, sf3a=None, sf3b=None):
        """M_near on two slot-space 3-vectors in one 6-channel pass (the
        radial is shared): (v3a, v3b, sv3a, sv3b), the straggler outputs
        None without a straggler list."""
        sf = float(np.float32(self.self_f))
        ch = (*f3a, *f3b)
        if self.spec.n_strag == 0:
            outs = self._kernel(2)(cg.x, cg.y, cg.z, *ch)
            va = tuple(outs[k] + sf * ch[k] for k in range(3))
            vb = tuple(outs[3 + k] + sf * ch[3 + k] for k in range(3))
            return va, vb, None, None
        blk = broadcast_strag_channels(self.spec, cg.spos, (*sf3a, *sf3b), cg.spid)
        outs = self._kernel(2)(cg.x, cg.y, cg.z, *ch, strag=blk)
        va = tuple(outs[k] + sf * ch[k] for k in range(3))
        vb = tuple(outs[3 + k] + sf * ch[3 + k] for k in range(3))
        return (va, vb, self._strag_rows(cg, outs[6:9], tuple(sf3a)),
                self._strag_rows(cg, outs[9:12], tuple(sf3b)))

    def _krylov_mv(self, cg: ChannelGrid, noise: bool):
        """x -> M_near x on the flat [3 (T + S)] Krylov vector."""
        shape = cg.x.shape
        T = cg.x.numel()
        S = self.spec.n_strag

        def mv(v):
            g = v.reshape(3, -1)
            gg = g[:, :T].reshape((3,) + tuple(shape))
            if S:
                gs = g[:, T:]
                ox, oy, oz, sv3 = self.near_matvec_slots(cg, gg[0], gg[1], gg[2],
                                                         (gs[0], gs[1], gs[2]), noise=noise)
                return _stack_flat((ox, oy, oz), sv3)
            return _stack_flat(self.near_matvec_slots(cg, gg[0], gg[1], gg[2], noise=noise))

        return mv

    def _split_flat(self, cg: ChannelGrid, out):
        o = out.reshape(3, -1)
        T = cg.x.numel()
        og = o[:, :T].reshape((3,) + tuple(cg.x.shape))
        return (og[0], og[1], og[2]), (o[:, T:] if self.spec.n_strag else None)

    def draw_z(self, cg: ChannelGrid, gen: torch.Generator):
        """The noise start vector: 3 masked grids of N(0, 1) draws and, with
        a straggler list, [3, S] masked rows (None without one)."""
        mask = (cg.pid >= 0).to(torch.float32)
        z3 = tuple(torch.randn(cg.x.shape, generator=gen, device=cg.x.device) * mask
                   for _ in range(3))
        zs = None
        if self.spec.n_strag:
            smask = (cg.spid >= 0).to(torch.float32)
            zs = torch.randn((3, self.spec.n_strag), generator=gen, device=cg.x.device) * smask
        return z3, zs

    def _near_noise_slots_z(self, cg: ChannelGrid, z3, zs):
        """sqrt(M_near) z in slot space by Lanczos, z given: (bx, by, bz,
        straggler rows [3, S] or None, residual). The first matvec is peeled
        with the full-degree radial (the later ones run the noise Horner),
        the operator sequence of the fused pass."""
        zf = _stack_flat(z3, None if zs is None else tuple(zs))
        w0 = self._krylov_mv(cg, noise=False)(zf)
        out, res = lanczos_sqrt_apply(self._krylov_mv(cg, noise=True), zf,
                                      m=self.lanczos_iterations, w0=w0)
        b3, s3 = self._split_flat(cg, out)
        return b3[0], b3[1], b3[2], s3, res

    def _near_noise_slots(self, cg: ChannelGrid, gen: torch.Generator):
        z3, zs = self.draw_z(cg, gen)
        return self._near_noise_slots_z(cg, z3, zs)

    def _near_mf_and_noise_z(self, cg: ChannelGrid, fx, fy, fz, sf3, z3, zs,
                             fused: bool = True):
        """Near M F and sqrt(M_near) z, z given: (v3, sv3, b3, bs3, res).
        ``fused``: M F rides the first Lanczos matvec in one 6-channel pass
        (``near_matvec2_slots`` and the peeled ``w0``); ``fused=False``
        runs M F and the noise as separate passes (the same operators, one
        more pass)."""
        S = self.spec.n_strag
        if not fused:
            if S:
                vx, vy, vz, sv3 = self.near_matvec_slots(cg, fx, fy, fz, sf3=sf3)
            else:
                (vx, vy, vz), sv3 = self.near_matvec_slots(cg, fx, fy, fz), None
            bx, by, bz, bs3, res = self._near_noise_slots_z(cg, z3, zs)
            return (vx, vy, vz), sv3, (bx, by, bz), bs3, res
        va, vb, sv3a, sv3b = self.near_matvec2_slots(
            cg, (fx, fy, fz), z3, sf3a=sf3, sf3b=(zs[0], zs[1], zs[2]) if S else None)
        zf = _stack_flat(z3, None if zs is None else tuple(zs))
        w0 = _stack_flat(vb, sv3b)
        out, res = lanczos_sqrt_apply(self._krylov_mv(cg, noise=True), zf,
                                      m=self.lanczos_iterations, w0=w0)
        b3, bs3 = self._split_flat(cg, out)
        return va, sv3a, b3, bs3, res

    def _near_mf_and_noise(self, cg: ChannelGrid, fx, fy, fz, sf3, gen, fused: bool = True):
        z3, zs = self.draw_z(cg, gen)
        return self._near_mf_and_noise_z(cg, fx, fy, fz, sf3, z3, zs, fused=fused)

    def tuned_lanczos(self, pos, tol: float = 1e-3, gen: torch.Generator | None = None,
                      m_max: int = 16, z=None):
        """The smallest static Lanczos count whose successive-approximation
        residual ||B_j z - B_{j-1} z|| / ||B_j z|| is below ``tol`` on a
        probe draw at ``pos`` (the reference's adaptive loop,
        LanczosAlgorithm.cuh:40-56, moved to setup): one m_max-step pass
        records the tridiagonal, the sweep over j runs on the host. ``z``
        (the flat start vector) replaces the draw from ``gen`` (default:
        seeded 1234). Returns a retuned backend."""
        pos = torch.as_tensor(pos, dtype=torch.float32, device=self.box.size.device)
        cg = pack_channels(self.spec, pos, torch.zeros_like(pos))
        if z is None:
            if gen is None:
                gen = torch.Generator(device=pos.device)
                gen.manual_seed(1234)
            z3, zs = self.draw_z(cg, gen)
            z = _stack_flat(z3, None if zs is None else tuple(zs))
        _, alphas, betas = lanczos_tridiag(self._krylov_mv(cg, noise=True), z, m_max)
        m = lanczos_iterations_for_tolerance(alphas.cpu().numpy(), betas.cpu().numpy(), tol)
        return dataclasses.replace(self, lanczos_iterations=int(m))

    # -------------------------------------------- slot-space pair forces
    def make_pair_force_slots(self, g_fn):
        """Short-range pair forces on the step's own near-grid pack:
        ``force_slots(cg) -> ((fx, fy, fz), sf3)`` in slot order, through
        the Newton pair kernel (#6) and the fold (#7). ``g_fn`` is the
        fused LJ radial (``md.lj_g_fused``); its cutoff must not pass the
        near-field rcut."""
        spec = self.spec
        kern = make_newton_pair_kernel(spec, g_fn)
        fold = make_fold_kernel(spec)
        S = spec.n_strag

        def force_slots(cg: ChannelGrid):
            strag = broadcast_stragglers(spec, cg.spos, cg.spid) if S else None
            home, groups, sforce = kern(cg.x, cg.y, cg.z, strag)
            fx, fy, fz = fold(home, groups)
            sf3 = None
            if S:
                sf = sforce + straggler_pair_forces(spec, g_fn, cg.spos, cg.spid)
                sf = sf * (cg.spid >= 0)[:, None]
                sf3 = (sf[:, 0], sf[:, 1], sf[:, 2])
            return (fx, fy, fz), sf3

        return force_slots

    def _near_step(self, cg, fx, fy, fz, sf3, pos, forces, gen, dt, temperature, bins, slack):
        """dt (M_near F + M_far F) + sqrt(2 T dt) (B_near z + B_far w):
        the near pass (fused with the noise at T > 0), the far spectral
        pass, then unpack."""
        S = self.spec.n_strag
        if temperature > 0:
            amp = math.sqrt(2.0 * temperature / dt)
            (vx, vy, vz), sv3, b3, b3s, _ = self._near_mf_and_noise(cg, fx, fy, fz, sf3, gen)
            a = float(np.float32(amp))
            vx, vy, vz = vx + a * b3[0], vy + a * b3[1], vz + a * b3[2]
            sv3 = [s + a * b for s, b in zip(sv3, b3s)] if S else None
            far_v = self.far.compute_mf_bdw(pos, forces, gen, amp, bins=bins, slack=slack)
        else:
            if S:
                vx, vy, vz, sv3 = self.near_matvec_slots(cg, fx, fy, fz, sf3=sf3)
            else:
                (vx, vy, vz), sv3 = self.near_matvec_slots(cg, fx, fy, fz), None
            far_v = self.far.compute_mf(pos, forces, bins=bins, slack=slack)
        near = unpack_values(cg, (vx, vy, vz), svalues=(tuple(sv3) if S else None))
        return dt * (near.to(pos.dtype) + far_v)

    def displacement_with_pair_force(self, force_slots_fn, pos, gen, dt, temperature):
        """The EM displacement with the pair force evaluated on the step's
        own fresh pack: (dx, forces, overflow)."""
        cg = pack_channels(self.spec, pos, torch.zeros_like(pos))
        (fx, fy, fz), sf3 = force_slots_fn(cg)
        forces = unpack_values(cg, (fx, fy, fz), svalues=sf3).to(pos.dtype)
        dx = self._near_step(cg, fx, fy, fz, sf3, pos, forces, gen, dt, temperature, None, 0)
        return dx, forces, cg.overflow

    # ------------------------------------------- persistent-binning EM steps
    def em_state(self, pos, device=None) -> PSEStepState:
        """The initial persistent binning state: the near pid layout and the
        far pencil bins (reference analog: VerletList's skin criterion,
        VerletListBase.cuh:56-70, on both grids)."""
        dev = pos.device if torch.is_tensor(pos) else resolve_device(device)
        pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
        Ls = self.spec.box_size
        pos_w = torch.stack([wrap(pos[:, d], Ls[d]) for d in range(3)], -1)
        cg = pack_channels(self.spec, pos, torch.zeros((pos.shape[0], 0), device=dev))
        bins = self.far.pencil_bins(pos, slack=self.far_slack, cap_extra=self.far_cap_extra)
        if bins is None:
            raise ValueError("the far grid is not pencil-safe with this far_slack (or N < "
                             "4096): the persistent EM path needs the pencil spread")
        return PSEStepState(
            pid=cg.pid, spid=cg.spid, ref=pos_w, far_pids=bins.pids,
            far_slot_of_pid=bins.slot_of_pid, far_ref=pos[:, :2].clone(),
            ovf_near=cg.overflow, ovf_far=bins.overflow,
        )

    def _far_hmin(self) -> float:
        return min(self.far.box_size[d] / self.far.shape[d] for d in (0, 1))

    def _drift_flags(self, st: PSEStepState, pos):
        """(near, far) drift past the rebin thresholds, as one [2] bool
        tensor on the device."""
        Ls = self.spec.box_size

        def wmax(ref, d):
            return torch.max(torch.abs(wrap(pos[:, d] - ref[:, d], Ls[d])))

        dnear = torch.max(torch.stack([wmax(st.ref, d) for d in range(3)]))
        dfar = torch.max(torch.stack([wmax(st.far_ref, d) for d in range(2)]))
        return torch.stack([dnear > float(np.float32(self.spec.drift_threshold)),
                            dfar > float(np.float32(self.far_slack * self._far_hmin()))])

    def _near_rebin_inputs(self, st: PSEStepState, pos):
        """The slot rebin's (stacked [4, nz, nyb, CAP, NLANE], strag [4,
        S]) at ``pos``: x, y, z and pid + 1 of the current layout's slots
        and straggler rows."""
        Ls = self.spec.box_size
        # old slot coordinates in the OLD layout's image branch (ref +
        # min-image drift), as the LJ engine feeds the rebin between rebins
        po = [st.ref[:, d] + wrap(pos[:, d] - st.ref[:, d], Ls[d]) for d in range(3)]
        m_old = st.pid >= 0
        src = st.pid.clamp(min=0).long()
        empty = torch.full((), EMPTY_POS, dtype=torch.float32, device=pos.device)
        stacked = torch.stack([torch.where(m_old, p[src], empty) for p in po]
                              + [(st.pid + 1).to(torch.float32)])
        sm = st.spid >= 0
        ssrc = st.spid.clamp(min=0).long()
        sstack = torch.stack([torch.where(sm, p[ssrc], empty) for p in po]
                             + [(st.spid + 1).to(torch.float32)])
        return stacked, sstack

    def _near_repack(self, st: PSEStepState, pos, pos_w):
        """The near grid rebinned at ``pos``: the slot rebin (#5) with a
        straggler list, else a fresh pack. Returns (pid, spid, ref, ovf)."""
        spec = self.spec
        n = pos.shape[0]
        S = spec.n_strag
        if not S:
            cg = pack_channels(spec, pos, torch.zeros((n, 0), device=pos.device))
            return cg.pid, cg.spid, pos_w, cg.overflow
        out, mini, count, ovf = self._near_rebin()(*self._near_rebin_inputs(st, pos))
        pid = out[3].to(torch.int32) - 1
        spid, s_count = compact_mini_pids(mini, S)
        ovf_b = (ovf > 0) | (count != n) | (s_count > S)
        return pid, spid, pos_w, ovf_b

    def _refresh(self, st: PSEStepState, pos):
        """Drift-check both grids (one host read of both flags), rebin
        whichever passed its threshold, and gather the slot positions
        afresh from ``pos``: returns (cg, far bins, new state)."""
        spec = self.spec
        Ls = spec.box_size
        need_near, need_far = self._drift_flags(st, pos).tolist()
        pos_w = torch.stack([wrap(pos[:, d], Ls[d]) for d in range(3)], -1)
        no = torch.zeros((), dtype=torch.bool, device=pos.device)
        if need_near:
            pid, spid, ref, ovf_n = self._near_repack(st, pos, pos_w)
        else:
            pid, spid, ref, ovf_n = st.pid, st.spid, st.ref, no
        if need_far:
            bins = self.far.pencil_bins(pos, slack=self.far_slack, cap_extra=self.far_cap_extra)
            fpids, fslot, fref, ovf_f = (bins.pids, bins.slot_of_pid, pos[:, :2].clone(),
                                         bins.overflow)
        else:
            fpids, fslot, fref, ovf_f = st.far_pids, st.far_slot_of_pid, st.far_ref, no
        st2 = PSEStepState(
            pid=pid, spid=spid, ref=ref, far_pids=fpids, far_slot_of_pid=fslot, far_ref=fref,
            ovf_near=st.ovf_near | ovf_n, ovf_far=st.ovf_far | ovf_f,
            n_rebin_near=st.n_rebin_near + int(need_near),
            n_rebin_far=st.n_rebin_far + int(need_far),
        )
        overflow = st2.overflow
        # slot coordinate = bin-time wrapped ref + min-image drift, so a
        # particle that crossed the boundary stays in its cell's image
        # branch; empties keep EMPTY_POS
        p = [ref[:, d] + wrap(pos[:, d] - ref[:, d], Ls[d]) for d in range(3)]
        m = pid >= 0
        src = pid.clamp(min=0).long()
        empty = torch.full((), EMPTY_POS, dtype=torch.float32, device=pos.device)
        x, y, z = (torch.where(m, c[src], empty) for c in p)
        if spec.n_strag:
            sm = spid >= 0
            ssrc = spid.clamp(min=0).long()
            spos = torch.where(sm[:, None], torch.stack([c[ssrc] for c in p], -1), empty)
        else:
            spos = torch.full((0, 3), EMPTY_POS, dtype=torch.float32, device=pos.device)
        cg = ChannelGrid(spec=spec, n=pos.shape[0], x=x, y=y, z=z, channels=(), pid=pid,
                         overflow=overflow, spos=spos, schannels=(), spid=spid)
        bins = PencilBins(pids=fpids, slot_of_pid=fslot, overflow=overflow)
        return cg, bins, st2

    def displacement_with_pair_force_persistent(self, force_slots_fn, pos, gen, dt,
                                                temperature, st: PSEStepState):
        """``displacement_with_pair_force`` with both binnings carried
        across steps (rebinned on drift, else 4 gathers replace the pack).
        Returns (dx, forces, st'); the overflow latches live in st'."""
        cg, bins, st = self._refresh(st, pos)
        (fx, fy, fz), sf3 = force_slots_fn(cg)
        forces = unpack_values(cg, (fx, fy, fz), svalues=sf3).to(pos.dtype)
        dx = self._near_step(cg, fx, fy, fz, sf3, pos, forces, gen, dt, temperature, bins,
                             self.far_slack)
        return dx, forces, st

    # ------------------------------------------------- [N]-order interface
    def near_matvec(self, pos, forces):
        cg = pack_channels(self.spec, pos, forces)
        if self.spec.n_strag:
            *v, sv3 = self.near_matvec_slots(cg, *cg.channels, sf3=cg.schannels)
            return unpack_values(cg, v, svalues=sv3).to(pos.dtype)
        return unpack_values(cg, self.near_matvec_slots(cg, *cg.channels)).to(pos.dtype)

    def compute_mf(self, pos, forces):
        return self.far.compute_mf(pos, forces) + self.near_matvec(pos, forces)

    def compute_bdw(self, pos, gen):
        far_noise = self.far.compute_bdw(pos, gen)
        cg = pack_channels(self.spec, pos, torch.zeros_like(pos))
        nx_, ny_, nz_, s3, _ = self._near_noise_slots(cg, gen)
        near = unpack_values(cg, (nx_, ny_, nz_),
                             svalues=(tuple(s3) if s3 is not None else None))
        return far_noise + near.to(pos.dtype)

    def divergence(self, pos):
        return torch.zeros_like(pos)

    def displacement(self, pos, forces, gen, dt, temperature):
        """dt M F + sqrt(2 T dt) B dW with one binning pass and one far
        spectral pass (reference: BDHI_EulerMaruyama.cu:145-165 fused):
        (dx, overflow)."""
        cg = pack_channels(self.spec, pos, forces)
        sf3 = cg.schannels if self.spec.n_strag else None
        dx = self._near_step(cg, *cg.channels, sf3, pos, forces, gen, dt, temperature, None, 0)
        return dx, cg.overflow
