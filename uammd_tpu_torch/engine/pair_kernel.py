"""Short-range pair forces on the grid-resident layout.

Port of ``uammd_tpu/engine/pair_kernel.py:make_pair_force_kernel`` (#1):
``force(x, y, z) -> (fx, fy, fz[, energy][, virial][, stress x 6])``. For
every home slot the force is the sum of ``g(r2) * d`` over all CAP slots of
the 27 neighbor cells, with ``d = r_j - r_i`` after the periodic image
shift. Force only, ``g = r2 < rc2 ? g_fn(max(r2, clamp_lo)) : 0``; with any
of the energy (``e_fn``, half to each particle), virial and 6-component
stress outputs on, the clamp gives way to the mask
``inside = (r2 < rc2) & (r2 > 1e-10)``, as in the JAX kernel. With
``periodic_z=False`` (force only) it is the halo mode of
``parallel/domain.py``: the caller passes a z-slab extended by one ghost
row at each end, already image-shifted, and drops the ghost rows of the
output; the z index still wraps, but takes no Lz shift.

On CUDA tensors the wrapper launches the hand-written kernel
``csrc/pair_force.cu`` (which has the LJ radials and energy compiled in, so
``g_fn`` must be ``md.lj_g`` or, force only, ``md.lj_g_fused``, and
``e_fn`` ``md.lj_e``): ``uammd_pair_force`` (``_fused`` with the fused
radial) for the forces alone, ``uammd_pair_force_obs`` with every output;
on CPU tensors it runs ``pair_force_plain``, the plain PyTorch version that the
tests hold against the JAX kernel and that ``chip_smoke.py`` holds the CUDA
kernel against. The kernel runs one warp per cell in blocks of up to 16
cells; ``pair_launch_plan`` picks the blocks' shape from the spec
(``cell_block_plan``, shared with the Newton kernel of ``kernel2``).

Also the port of ``make_pair_channel_kernel`` (#2) and
``broadcast_strag_channels``: the 27-stencil transverser with n_chan
per-particle payload channels in and n_out sums out, periodic in z (or in
the halo mode as above, where the straggler rows' reverse sums cover the
slab's interior rows only), over a pair functor: the PSE near field
(``pse_near.PSENear``, on 1 or 2 stacked 3-vectors, with the straggler
block) or a ``ChannelFunctor`` (DPD, SPH density and force, the LJ
mixtures on straggler-free specs; the Poisson near field,
``electrostatics.poisson.PoissonNear``, and the fused LJ radial force
``RadialForce``, also with the straggler block). CUDA tensors launch
``csrc/pair_channel.cu`` instantiated for the functor, in blocks of cells whose shape
``channel_launch_plan`` picks (``cell_block_plan`` with the functor's
shared memory); CPU tensors run ``pair_channel_plain`` (PSE) or
``functor_plain`` (a functor's plain form, which has the JAX ``pair_fn``
signature).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _build
from .layout import GridSpec, stencil_sources
from .pse_near import (
    PSENear,
    _strag_inv,
    _Struct,
    channel_launch_args,
    check_cpu_inputs,
    strag_channel_block,
    strag_row_totals,
)

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p

# uammd_pair_force(x, y, z, fx, fy, fz, nx, nyb, nz, F, cap, Lx, Ly, Lz,
#                  rc2, clamp_lo, neg24eps, s2, cc, fc, occ_trim, stream)
PAIR_FORCE = _build.Kernel(
    "pair_force", "uammd_pair_force", [_P] * 6 + [_I] * 5 + [_F] * 7 + [_I] * 3)
# uammd_pair_force_halo: the same arguments, the halo mode (periodic_z=False)
PAIR_FORCE_HALO = _build.Kernel(
    "pair_force", "uammd_pair_force_halo", [_P] * 6 + [_I] * 5 + [_F] * 7 + [_I] * 3)

# uammd_pair_force_fused(x, y, z, fx, fy, fz, nx, nyb, nz, F, cap, Lx, Ly,
#                        Lz, rc2, clamp_lo, c1, c2, frc2, flo, approx, cc, fc,
#                        occ_trim, stream): the fused LJ radial (md.LJFused)
PAIR_FORCE_FUSED = _build.Kernel(
    "pair_force", "uammd_pair_force_fused", [_P] * 6 + [_I] * 5 + [_F] * 9 + [_I] * 4)
# uammd_pair_force_fused_halo: the same arguments, the halo mode
PAIR_FORCE_FUSED_HALO = _build.Kernel(
    "pair_force", "uammd_pair_force_fused_halo", [_P] * 6 + [_I] * 5 + [_F] * 9 + [_I] * 4)

# uammd_pair_force_obs(x, y, z, fx, fy, fz, obs, nx, nyb, nz, F, cap, Lx,
#                      Ly, Lz, rc2, neg24eps, s2, c4eps, e_shift, cc, fc,
#                      occ_trim, stream)
PAIR_FORCE_OBS = _build.Kernel(
    "pair_force", "uammd_pair_force_obs", [_P] * 7 + [_I] * 5 + [_F] * 8 + [_I] * 3)

# The launch shape of the cell-warp kernels (csrc/pair_force.cu and
# csrc/newton_pair.cu): a block is one (z, yb) and a rectangle of cc x fc
# cells along x and the fold, one warp per cell.
SM_COUNT = 132  # H100 SXM
MIN_BLOCKS = 2 * SM_COUNT
MAX_BLOCK_CELLS = 16  # warps, so at most 512 threads
MAX_SMEM = 232448  # bytes of shared memory a block may opt in to on sm_90


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of a cell-warp kernel: the block's cells along x (``cc``)
    and along the fold (``fc``), the grid (x and fold chunks, nyb, nz), the
    threads per block and its dynamic shared memory in bytes."""

    cc: int
    fc: int
    grid: tuple
    threads: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def as_dict(self) -> dict:
        return {"cc": self.cc, "fc": self.fc, "grid": list(self.grid), "blocks": self.blocks,
                "threads": self.threads, "smem_bytes": self.smem}


def cell_block_plan(spec: GridSpec, smem_of, max_cells: int = MAX_BLOCK_CELLS,
                    threads_of=None, key_of=None) -> LaunchPlan:
    """The block shape of a cell-warp kernel for ``spec``, ``smem_of(cc,
    fc)`` giving a block's shared memory and ``threads_of(cc, fc)`` its
    threads (default one warp per cell). It keeps to at least
    ``MIN_BLOCKS`` blocks (or one per cell on a grid with fewer cells),
    ``max_cells`` cells and ``MAX_SMEM`` bytes, and takes the shape of the
    smallest ``key_of(cc, fc, smem, blocks)``; by default it prefers blocks
    small enough for two to share an SM, and then the fewest staged columns
    over the launch (each block stages its cells with a one-cell halo).
    Raises ``ValueError`` when no shape fits."""
    nx, _, nz = spec.shape
    F, nyb = spec.fold, spec.nyb
    if spec.n_slots >= 2 ** 31:
        raise ValueError(f"{spec.n_slots} slots per grid exceed the kernels' 32-bit indices")
    if threads_of is None:
        threads_of = lambda cc, fc: 32 * cc * fc  # noqa: E731
    if key_of is None:
        def key_of(cc, fc, smem, blocks):
            return (smem > MAX_SMEM // 2, blocks * (cc + 2) * (fc + 2), -cc * fc)
    target = min(MIN_BLOCKS, spec.n_cells)
    best = None
    for cc in range(1, min(nx, max_cells) + 1):
        for fc in range(1, min(F, max_cells // cc) + 1):
            smem = int(smem_of(cc, fc))
            grid = (-(-nx // cc) * -(-F // fc), nyb, nz)
            blocks = grid[0] * nyb * nz
            if smem > MAX_SMEM or blocks < target:
                continue
            key = key_of(cc, fc, smem, blocks)
            if best is None or key < best[0]:
                best = (key, LaunchPlan(cc, fc, grid, threads_of(cc, fc), smem))
    if best is None:
        raise ValueError(f"no block of the cell-warp kernel fits the spec "
                         f"{spec.array_shape} (CAP {spec.cap}, S {spec.n_strag}) in "
                         f"{MAX_SMEM} bytes of shared memory")
    return best[1]


def pair_launch_plan(spec: GridSpec) -> LaunchPlan:
    """The launch of ``csrc/pair_force.cu`` (every mode) for ``spec``: per
    block, 3 z layers of W = (cc + 2) x (fc + 2) staged columns, each CAP
    float4 slots in rows W | 1 apart, plus a float4 shift and 3 ints
    (``smem_bytes`` there)."""
    def smem(cc, fc):
        w = (cc + 2) * (fc + 2)
        return 3 * (16 * spec.cap * (w | 1) + 28 * w)
    return cell_block_plan(spec, smem)


# uammd_pair_channel(x, y, z, ch, strag, out, spart, nv, nx, nyb, nz, F,
#                    cap, S, cc, fc, occ_trim, Lx, Ly, Lz, iLx, iLy, iLz,
#                    near, stream)
PAIR_CHANNEL = _build.Kernel("pair_channel", "uammd_pair_channel",
                             [_P] * 7 + [_I] * 10 + [_F] * 6 + [_Struct])
# uammd_pair_channel_halo: the same arguments, the halo mode (straggler
# partials over the slab's interior rows)
PAIR_CHANNEL_HALO = _build.Kernel("pair_channel", "uammd_pair_channel_halo",
                                  [_P] * 7 + [_I] * 10 + [_F] * 6 + [_Struct])

# The launch shape of the channel kernel #2 (csrc/pair_channel.cu): a block
# is one (z, yb) and a rectangle of cc x fc cells (at most 64) staged with a
# one-cell halo; its warps loop over chunks of the cells' occupied slots.
MAX_CHANNEL_CELLS = 64
MAX_CHANNEL_WARPS = 16
CHANNEL_RING = 128  # a warp's pairs waiting for a round (kRing)
CHANNEL_HDR = 16  # a block's scalars (kHdr)
SM_SMEM = 233472  # bytes of shared memory an SM holds, 1024 of them reserved a block
SM_WARPS = 32  # warps an SM holds at 64 registers a thread
SM_BLOCKS = 32  # blocks an SM holds


def channel_warps(cap: int, cc: int, fc: int) -> int:
    """The warps of a #2 block (``warps_of`` in the .cu): the chunks its
    cells should give at the mean occupancy cap^2 // (cap + 48) that CAP
    (the occupancy's high quantile) suggests; cells below 27 share chunks
    of ~26 lanes, larger ones take ceil(mean / 32) each; 1 to 16."""
    cells = cc * fc
    m = max(1, cap * cap // (cap + 48))
    w = -(-cells * m // 26) if m <= 26 else cells * -(-m // 32)
    return min(MAX_CHANNEL_WARPS, max(1, w))


def channel_smem_bytes(cap: int, cc: int, fc: int, ng: int, n_strag: int) -> int:
    """The dynamic shared memory of a #2 block (``smem_bytes`` in the .cu):
    3 z layers of W = (cc + 2) x (fc + 2) staged columns of CAP float4
    positions in rows W | 1 apart; a float4 shift and 3 ints a column; per
    warp a ring of 128 pairs (int2) and its chunk's box (8 floats); per home
    cell a count and CAP list entries; the chunk starts and 16 scalars; the
    straggler rows [ng + 4, S] and their kept list. The ``ng`` channels
    stay in device memory."""
    w = (cc + 2) * (fc + 2)
    cells = cc * fc
    npc = -(-cap // 32)
    per_warp = 8 * CHANNEL_RING + 32
    return (3 * cap * (w | 1) * 16 + 3 * w * 28 + 4 * cells * (1 + cap)
            + 4 * (cells * npc + 1 + CHANNEL_HDR) + per_warp * channel_warps(cap, cc, fc)
            + 4 * (ng + 5) * n_strag)


def channel_grid_channels(fn, nvec: int = 1) -> int:
    """The grid channels of ``fn`` on the card: 3 nvec for the PSE
    functor, a ``ChannelFunctor``'s channels less its uniform ones."""
    if isinstance(fn, PSENear):
        return 3 * nvec
    return fn.n_chan - fn.n_uniform


def channel_launch_plan(spec: GridSpec, fn, nvec: int = 1) -> LaunchPlan:
    """The launch of ``csrc/pair_channel.cu`` for ``spec`` and the functor
    ``fn`` (``PSENear`` at ``nvec`` vectors, or a ``ChannelFunctor``): the
    block shape from ``cell_block_plan`` over ``channel_smem_bytes`` (the
    straggler rows counted for a straggler-serving functor), up to 64 cells
    a block and ``channel_warps`` warps, preferring the most home slots
    resident on an SM at the mean occupancy that CAP suggests, then the
    fewest staged columns. Raises ``ValueError`` when no block fits or the
    channels pass the kernel's 32-bit indices."""
    ng = channel_grid_channels(fn, nvec)
    pse = isinstance(fn, PSENear)
    S = spec.n_strag if (pse or fn.strag) else 0
    n_out = 3 * nvec if pse else fn.n_out
    cap = spec.cap
    if cap > 65535:
        raise ValueError(f"CAP {cap} is above the channel kernel's 65535")
    if spec.n_slots * max(ng, n_out) >= 2 ** 31:
        raise ValueError(f"{spec.n_slots} slots x {max(ng, n_out)} channels exceed the channel "
                         f"kernel's 32-bit indices")

    m = max(1, cap * cap // (cap + 48))  # channel_warps' mean occupancy

    def key(cc, fc, smem, blocks):
        # the home slots an SM holds at once, at most 32 lanes a warp
        warps = channel_warps(cap, cc, fc)
        resident = min(SM_BLOCKS, SM_WARPS // warps, SM_SMEM // (smem + 1024))
        busy = min(SM_WARPS * 32, resident * min(32 * warps, cc * fc * m))
        return (-busy, blocks * (cc + 2) * (fc + 2), -cc * fc)

    return cell_block_plan(spec, lambda cc, fc: channel_smem_bytes(cap, cc, fc, ng, S),
                           max_cells=MAX_CHANNEL_CELLS,
                           threads_of=lambda cc, fc: 32 * channel_warps(cap, cc, fc),
                           key_of=key)


class DPDParams(ctypes.Structure):
    """``chan::DPDParams`` of csrc/channel_functors.cuh."""

    _fields_ = [(k, _F) for k in ("rc2", "inv_rc", "A", "gamma", "sigma", "sq6")]


class SPHParams(ctypes.Structure):
    """``chan::SPHParams`` of csrc/channel_functors.cuh."""

    _fields_ = [(k, _F) for k in ("cut2", "h", "norm3", "norm4", "nu")]


class LJMixParams(ctypes.Structure):
    """``chan::LJMixParams`` of csrc/channel_functors.cuh."""

    _fields_ = [(k, _F) for k in ("cs2", "lo")]


def _functor_kernel(symbol: str, params) -> _build.Kernel:
    # symbol(x, y, z, ch, uni, out, nx, nyb, nz, F, cap, cc, fc, occ_trim,
    #        Lx, Ly, Lz, params, stream)
    return _build.Kernel("pair_channel", symbol, [_P] * 6 + [_I] * 8 + [_F] * 3 + [params])


# one entry point, and one launch count, per functor instantiation of #2,
# and for the functors that parallel/domain.py runs one more each for the
# halo mode (the entry's name + "_halo")
PAIR_CHANNEL_DPD = _functor_kernel("uammd_pair_channel_dpd", DPDParams)
PAIR_CHANNEL_SPH_DENSITY = _functor_kernel("uammd_pair_channel_sph_density", SPHParams)
PAIR_CHANNEL_SPH_FORCE = _functor_kernel("uammd_pair_channel_sph_force", SPHParams)
PAIR_CHANNEL_LJ_MIX = _functor_kernel("uammd_pair_channel_lj_mix", LJMixParams)
PAIR_CHANNEL_LJ_MIX_MASKED = _functor_kernel("uammd_pair_channel_lj_mix_masked", LJMixParams)
PAIR_CHANNEL_DPD_HALO = _functor_kernel("uammd_pair_channel_dpd_halo", DPDParams)
PAIR_CHANNEL_SPH_DENSITY_HALO = _functor_kernel("uammd_pair_channel_sph_density_halo",
                                                SPHParams)
PAIR_CHANNEL_SPH_FORCE_HALO = _functor_kernel("uammd_pair_channel_sph_force_halo", SPHParams)
PAIR_CHANNEL_LJ_MIX_HALO = _functor_kernel("uammd_pair_channel_lj_mix_halo", LJMixParams)
PAIR_CHANNEL_LJ_MIX_MASKED_HALO = _functor_kernel("uammd_pair_channel_lj_mix_masked_halo",
                                                  LJMixParams)

POISSON_NCOEF = 21  # chan::kPoissonNCoef: polynomials up to degree 20


class PoissonParams(ctypes.Structure):
    """``chan::PoissonParams`` of csrc/channel_functors.cuh."""

    _fields_ = [("c", _F * (4 * POISSON_NCOEF))] + [
        (k, _F) for k in ("a1", "b1", "a2", "b2", "qb", "rc2", "inv_rcut")]


def _strag_functor_kernel(symbol: str, params) -> _build.Kernel:
    # symbol(x, y, z, ch, strag, out, spart, nx, nyb, nz, F, cap, S, cc, fc,
    #        occ_trim, Lx, Ly, Lz, iLx, iLy, iLz, params, stream)
    return _build.Kernel("pair_channel", symbol, [_P] * 7 + [_I] * 9 + [_F] * 6 + [params])


PAIR_CHANNEL_POISSON = _strag_functor_kernel("uammd_pair_channel_poisson", PoissonParams)


class RadialParams(ctypes.Structure):
    """``chan::RadialParams`` of csrc/channel_functors.cuh."""

    _fields_ = [(k, _F) for k in ("c1", "c2", "rc2", "lo")] + [("approx", _I)]


PAIR_CHANNEL_RADIAL = _strag_functor_kernel("uammd_pair_channel_radial", RadialParams)
PAIR_CHANNEL_RADIAL_HALO = _strag_functor_kernel("uammd_pair_channel_radial_halo",
                                                 RadialParams)


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


class LJEnergy:
    """12-6 LJ pair energy as ``md.lj_e`` computes it: inv6 = (s2 / r2)^3,
    4 eps (inv6^2 - inv6) - e_shift in float32, e_shift the energy at
    ``shift_rc`` (0 without). Called on a tensor it is the plain version;
    the CUDA kernel reads ``c4eps``, ``s2`` and ``e_shift``."""

    def __init__(self, epsilon: float = 1.0, sigma: float = 1.0, shift_rc=None):
        self.c4eps = float(np.float32(4.0) * np.float32(epsilon))
        self.s2 = float(np.float32(sigma * sigma))
        self.e_shift = 0.0
        if shift_rc is not None:
            ic6 = float(sigma * sigma / (shift_rc * shift_rc)) ** 3
            self.e_shift = float(np.float32(4.0 * epsilon * (ic6 * ic6 - ic6)))

    def __call__(self, r2: torch.Tensor) -> torch.Tensor:
        q = self.s2 / r2
        inv6 = q * q * q
        return self.c4eps * (inv6 * inv6 - inv6) - self.e_shift


def pair_force_plain(spec: GridSpec, g_fn, x, y, z, clamp_lo: float = 4e-3, e_fn=None,
                     compute_virial: bool = False, compute_stress: bool = False,
                     periodic_z: bool = True):
    """Plain PyTorch version of the kernel: for each of the 27 stencil cells,
    gather its CAP slots in home-cell order and form the all-pairs
    [nz, nyb, CAP_i, CAP_j, NLANE] block against the home slots, as the TPU
    kernel forms [CAP_i, CAP_j, NLANE] blocks from lane rolls. With
    ``e_fn``, ``compute_virial`` or ``compute_stress`` it also returns the
    energy (half of e_fn per pair), the virial (-g r2 / 2) and the stress
    (xx, xy, xz, yy, yz, zz of -g d_a d_b / 2) grids, masking with
    ``inside`` instead of clamping, as the JAX kernel does (:206-231).
    ``periodic_z=False`` (force only) takes no z image shift (halo mode)."""
    if e_fn is not None or compute_virial or compute_stress:
        if not periodic_z:
            raise ValueError("the halo mode computes the force alone")
        return _pair_obs_plain(spec, g_fn, e_fn, compute_virial, compute_stress, x, y, z)
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
                zs, ybs, lane, (shx, shy, shz) = stencil_sources(spec, dz, dy, dx, dev,
                                                                 periodic_z=periodic_z)
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


def _pair_obs_plain(spec: GridSpec, g_fn, e_fn, compute_virial, compute_stress, x, y, z):
    dev = x.device
    cap = spec.cap
    rc2 = float(np.float32(spec.cutoff * spec.cutoff))
    rows = torch.arange(cap, device=dev)[None, None, :, None]
    xi, yi, zi = (a[:, :, :, None, :] for a in (x, y, z))
    f = [torch.zeros_like(x) for _ in range(3)]
    en = torch.zeros_like(x)
    vir = torch.zeros_like(x)
    st = [torch.zeros_like(x) for _ in range(6)]
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    one = torch.ones((), dtype=x.dtype, device=dev)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, lane, (shx, shy, shz) = stencil_sources(spec, dz, dy, dx, dev)
                d = [(a[zs, ybs, rows, lane] + sh)[:, :, None] - h
                     for a, sh, h in zip((x, y, z), (shx, shy, shz), (xi, yi, zi))]
                r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                inside = (r2 < rc2) & (r2 > 1e-10)
                r2s = torch.where(inside, r2, one)
                g = torch.where(inside, g_fn(r2s), zero)
                f = [fc + (g * dc).sum(dim=3) for fc, dc in zip(f, d)]
                if e_fn is not None:
                    en = en + 0.5 * torch.where(inside, e_fn(r2s), zero).sum(dim=3)
                if compute_virial:
                    vir = vir + (-0.5 * g * r2s * inside).sum(dim=3)
                if compute_stress:
                    hg = -0.5 * g
                    for c, (a, b) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
                        st[c] = st[c] + (hg * d[a] * d[b]).sum(dim=3)
    out = tuple(f)
    if e_fn is not None:
        out += (en,)
    if compute_virial:
        out += (vir,)
    if compute_stress:
        out += tuple(st)
    return out


class PairForceKernel:
    """``force(x, y, z) -> (fx, fy, fz[, energy][, virial][, stress x 6])``
    for one ``GridSpec``.

    CPU tensors go to ``pair_force_plain``; CUDA tensors launch
    ``csrc/pair_force.cu`` (the force alone counted in
    ``PAIR_FORCE.launches``, its halo mode ``periodic_z=False`` in
    ``PAIR_FORCE_HALO.launches``, with the fused LJ radial ``md.LJFused`` in
    ``PAIR_FORCE_FUSED`` and ``PAIR_FORCE_FUSED_HALO``, the observable mode in
    ``PAIR_FORCE_OBS.launches``) with ``pair_launch_plan(spec)``, or raise
    (a spec the plan cannot fit raises ``ValueError`` before any launch).
    ``occ_trim`` is 0; a check's control sets 1, which stops every candidate
    loop of the kernel one row short of the cell's occupancy."""

    occ_trim = 0

    def __init__(self, spec: GridSpec, g_fn, clamp_lo: float = 4e-3, e_fn=None,
                 compute_virial: bool = False, compute_stress: bool = False,
                 periodic_z: bool = True):
        if not periodic_z and (e_fn is not None or compute_virial or compute_stress):
            raise ValueError("the halo mode computes the force alone")
        self.periodic_z = bool(periodic_z)
        self.spec = spec
        self.g_fn = g_fn
        self.clamp_lo = clamp_lo
        self.e_fn = e_fn
        self.compute_virial = bool(compute_virial)
        self.compute_stress = bool(compute_stress)
        self._plan = None

    @property
    def plan(self) -> LaunchPlan:
        """The CUDA launch for this spec (``pair_launch_plan``)."""
        if self._plan is None:
            self._plan = pair_launch_plan(self.spec)
        return self._plan

    @property
    def observables(self) -> bool:
        return self.e_fn is not None or self.compute_virial or self.compute_stress

    def __call__(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
        shape = self.spec.array_shape
        if x.device.type == "cpu":
            for name, t in (("x", x), ("y", y), ("z", z)):
                if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shape:
                    raise ValueError(f"{name} must be a float32 CPU tensor of shape {shape}")
            return pair_force_plain(self.spec, self.g_fn, x, y, z, self.clamp_lo, self.e_fn,
                                    self.compute_virial, self.compute_stress, self.periodic_z)
        for name, t in (("x", x), ("y", y), ("z", z)):
            _build.check_cuda_tensor(t, name, shape)
        from .md import LJFused

        fused = isinstance(self.g_fn, LJFused)
        if not (isinstance(self.g_fn, LJRadial) or (fused and not self.observables)):
            raise TypeError("the CUDA pair kernel computes the LJ radial (md.lj_g) or, force "
                            "only, the fused LJ radial (md.lj_g_fused)")
        if self.e_fn is not None and not isinstance(self.e_fn, LJEnergy):
            raise TypeError("the CUDA pair kernel computes the LJ energy only (md.lj_e)")
        spec = self.spec
        plan = self.plan
        launch = (plan.cc, plan.fc, int(self.occ_trim))
        nx, _, nz = spec.shape
        Lx, Ly, Lz = spec.box_size
        fx, fy, fz = (torch.empty_like(x) for _ in range(3))
        P = _build.ptr
        rc2 = float(np.float32(spec.cutoff * spec.cutoff))
        if fused:
            # the fused radial is 0 beyond its own cutoff, so the kernel's
            # cull and mask reach no further than the nearer of the two
            g = self.g_fn
            rc2 = min(rc2, g.rc2)
            (PAIR_FORCE_FUSED if self.periodic_z else PAIR_FORCE_FUSED_HALO)(
                P(x), P(y), P(z), P(fx), P(fy), P(fz),
                nx, spec.nyb, nz, spec.fold, spec.cap, Lx, Ly, Lz, rc2,
                float(np.float32(self.clamp_lo)), g.c1, g.c2, g.rc2, g.lo, int(g.approx),
                *launch,
            )
            return fx, fy, fz
        if not self.observables:
            (PAIR_FORCE if self.periodic_z else PAIR_FORCE_HALO)(
                P(x), P(y), P(z), P(fx), P(fy), P(fz),
                nx, spec.nyb, nz, spec.fold, spec.cap,
                Lx, Ly, Lz, rc2,
                float(np.float32(self.clamp_lo)),
                self.g_fn.neg24eps, self.g_fn.s2, *launch,
            )
            return fx, fy, fz
        # every output is computed; the ones not asked for are dropped
        e = self.e_fn or LJEnergy(self.g_fn.epsilon, self.g_fn.sigma)
        obs = torch.empty((8,) + shape, dtype=torch.float32, device=x.device)
        PAIR_FORCE_OBS(
            P(x), P(y), P(z), P(fx), P(fy), P(fz), P(obs),
            nx, spec.nyb, nz, spec.fold, spec.cap, Lx, Ly, Lz, rc2,
            self.g_fn.neg24eps, self.g_fn.s2, e.c4eps, e.e_shift, *launch,
        )
        out = (fx, fy, fz)
        if self.e_fn is not None:
            out += (obs[0],)
        if self.compute_virial:
            out += (obs[1],)
        if self.compute_stress:
            out += tuple(obs[2:])
        return out


def make_pair_force_kernel(spec: GridSpec, g_fn, e_fn=None, *, compute_virial: bool = False,
                           compute_stress: bool = False, clamp_lo: float = 4e-3,
                           periodic_z: bool = True):
    """Build ``force(x, y, z) -> (fx, fy, fz[, energy][, virial][, stress
    x 6])`` on [nz, nyb, CAP, NLANE] float32 tensors (``layout.GridState``
    fields); ``periodic_z=False`` is the force-only halo mode."""
    return PairForceKernel(spec, g_fn, clamp_lo, e_fn, compute_virial, compute_stress,
                           periodic_z)


def broadcast_strag_channels(spec: GridSpec, spos, schannels, spid):
    """[S, 3] straggler positions, [S] channels and validity -> the
    [3 + C + 1, S, NLANE] block (x, y, z, channels, valid) the channel
    kernels take (a broadcast view; the kernels read its first lane)."""
    val = (spid >= 0).to(torch.float32)
    stack = torch.stack([spos[:, 0], spos[:, 1], spos[:, 2], *schannels, val])
    return stack[:, :, None].expand(stack.shape[0], spec.n_strag, spec.nlane)


class ChannelFunctor:
    """A pair functor of the channel kernel other than the PSE near field.

    Calling it is its plain version, with the JAX ``pair_fn`` signature:
    ``fn(r2, dxv, dyv, dzv, ch_i, ch_j) -> n_out per-pair terms``, the home
    channels ``ch_i`` [nz, nyb, CAP, 1, NLANE] and the candidate channels
    ``ch_j`` [nz, nyb, 1, CAP, NLANE]. Subclasses set ``n_chan`` (channels
    in), ``n_out`` (sums out), ``n_uniform`` (how many trailing channels
    hold one value for the whole launch: 0-d tensors on both paths, read on
    the home side only), ``kernel`` (the ``_build.Kernel`` of their CUDA
    instantiation in csrc/pair_channel.cu), ``kernel_halo`` (that of its
    halo mode, straggler-free functors only) and ``params()`` (its
    parameter struct). A functor with ``strag = True`` (no uniform channels) also
    serves straggler-capable specs: its kernel entry takes the straggler
    rows, and the plain version evaluates it both ways
    (``pse_near.strag_channel_block``)."""

    n_chan: int
    n_out: int
    n_uniform: int = 0
    strag: bool = False
    kernel: _build.Kernel
    kernel_halo: _build.Kernel | None = None
    # which sums carry the displacement (``kDisp`` of the CUDA functor,
    # ``displacement_sums``): 0 none, 1 sum k < 3 carries d_k alone
    disp: int = 1

    def params(self) -> ctypes.Structure:
        raise NotImplementedError

    def reach(self, hs: float = 0.0) -> float:
        """The largest distance at which a pair can give a non-zero term:
        the CUDA kernel's cull radius (``reach`` of its functor). ``hs`` is
        the pair's sum of half_sigma channels, read by the mixtures."""
        raise NotImplementedError

    def __call__(self, r2, dxv, dyv, dzv, ch_i, ch_j):
        raise NotImplementedError


class RadialForce(ChannelFunctor):
    """The radial pair force g(r2) d of ``parallel/pse_dd2.py:115-127`` as a
    functor of #2: no channels, 3 sums, both directions over the straggler
    rows (``strag``), with ``g`` the fused LJ radial ``md.lj_g_fused``
    (``md.LJFused``: t = 1 / max(r2, lo), g = r2 < rc2 ? t^4 (c1 t^3 + c2)
    : 0) applied to r2 as it is, without the pair kernel's own cutoff and
    clamp. Calling it is the plain version (JAX's ``pair_force_fn``); the
    CUDA functor ``chan::RadialForceFn`` evaluates the same expression, with
    ``rcp.approx.ftz.f32`` when the radial's ``approx`` is set."""

    n_chan = 0
    n_out = 3
    strag = True
    disp = 1
    kernel = PAIR_CHANNEL_RADIAL
    kernel_halo = PAIR_CHANNEL_RADIAL_HALO

    def __init__(self, g):
        from .md import LJFused

        if not isinstance(g, LJFused):
            raise TypeError("RadialForce takes the fused LJ radial (md.lj_g_fused)")
        self.g = g

    def params(self) -> RadialParams:
        g = self.g
        return RadialParams(g.c1, g.c2, g.rc2, g.lo, int(g.approx))

    def reach(self, hs: float = 0.0) -> float:
        return float(np.sqrt(np.float32(self.g.rc2)))

    def __call__(self, r2, dxv, dyv, dzv, ch_i, ch_j):
        g = self.g(r2)
        return g * dxv, g * dyv, g * dzv


def displacement_sums(fn, nvec: int = 1) -> tuple:
    """For each sum of the functor ``fn`` (``PSENear`` at ``nvec`` vectors,
    or a ``ChannelFunctor``), the displacement components it carries: a
    pair outside the cutoff whose component d_a is not finite gives NaN in
    exactly the sums that carry a (the plain version's 0 * d). It mirrors
    the ``kDisp`` of the functor's CUDA form (csrc/channel_functors.cuh)."""
    n_out = 3 * nvec if isinstance(fn, PSENear) else fn.n_out
    if fn.disp == 2:
        return ((0, 1, 2),) * n_out
    if fn.disp == 1:
        return ((0,), (1,), (2,)) + ((),) * (n_out - 3)
    return ((),) * n_out


def channel_plain(spec: GridSpec, pair_fn, n_out: int, x, y, z, channels,
                  periodic_z: bool = True):
    """Plain PyTorch version of the 27-stencil channel kernel (#2) with a
    JAX-signature ``pair_fn``: every home slot sums ``pair_fn``'s terms over
    the CAP slots of the 27 cells around it (``stencil_sources``, its own
    cell included), in the stencil order dz, dy, dx. 0-d channels are
    uniform and go to ``pair_fn`` as they are on both sides.
    ``periodic_z=False`` is the halo mode (no z image shift)."""
    dev = x.device
    rows = torch.arange(spec.cap, device=dev)[None, None, :, None]
    xi, yi, zi = (a[:, :, :, None, :] for a in (x, y, z))
    ch_i = [c if c.dim() == 0 else c[:, :, :, None, :] for c in channels]
    out = [torch.zeros_like(x) for _ in range(n_out)]
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, lane, (shx, shy, shz) = stencil_sources(spec, dz, dy, dx, dev,
                                                                 periodic_z=periodic_z)
                dxv = (x[zs, ybs, rows, lane] + shx)[:, :, None] - xi
                dyv = (y[zs, ybs, rows, lane] + shy)[:, :, None] - yi
                dzv = (z[zs, ybs, rows, lane] + shz)[:, :, None] - zi
                ch_j = [c if c.dim() == 0 else c[zs, ybs, rows, lane][:, :, None]
                        for c in channels]
                terms = pair_fn(dxv * dxv + dyv * dyv + dzv * dzv, dxv, dyv, dzv, ch_i, ch_j)
                out = [o + t.sum(dim=3) for o, t in zip(out, terms)]
    return tuple(out)


def pair_channel_plain(spec: GridSpec, fn: PSENear, nvec: int, x, y, z, channels,
                       strag=None, periodic_z: bool = True):
    """Plain PyTorch version of the 27-stencil channel kernel (#2) with the
    PSE near-field functor ``fn``: ``channel_plain`` over its forward
    contributions, plus the straggler rows. Returns ``(out (3 nvec grids),
    spart or None)``: the straggler rows' reverse sums [3 nvec, S], which
    the JAX kernel returns as per-program partial grids; in the halo mode
    (``periodic_z=False``) over the slab's interior rows only, as the JAX
    callers sum them (``pse_near.strag_row_totals``)."""
    out = channel_plain(spec, fn.pair_fn(nvec), 3 * nvec, x, y, z, channels, periodic_z)
    spart = None
    if spec.n_strag:
        xi, yi, zi = (a[:, :, :, None, :] for a in (x, y, z))
        ch_i = [c[:, :, :, None, :] for c in channels]
        fwd, spart = strag_channel_block(spec, fn.pair_fn(nvec), 3 * nvec, xi, yi, zi,
                                         ch_i, strag[:, :, 0], per_row=not periodic_z)
        out = [o + t for o, t in zip(out, fwd)]
        if not periodic_z:
            spart = strag_row_totals(spart, False)
    return tuple(out), spart


def functor_plain(spec: GridSpec, fn: ChannelFunctor, x, y, z, channels, strag_rows=None,
                  periodic_z: bool = True):
    """Plain PyTorch version of #2 with a ``ChannelFunctor``: ``channel_plain``
    and, with the straggler rows [3 + n_chan + 1, S], their forward terms
    and reverse totals (``pse_near.strag_channel_block``; in the halo mode
    over the slab's interior rows). Returns (n_out grids) [+ (n_out
    straggler totals [S])], as the kernel's wrapper does."""
    out = channel_plain(spec, fn, fn.n_out, x, y, z, channels, periodic_z)
    if strag_rows is None:
        return out
    xi, yi, zi = (a[:, :, :, None, :] for a in (x, y, z))
    ch_i = [c[:, :, :, None, :] for c in channels]
    fwd, spart = strag_channel_block(spec, fn, fn.n_chan, xi, yi, zi, ch_i, strag_rows,
                                     per_row=not periodic_z)
    if not periodic_z:
        spart = strag_row_totals(spart, False)
    return tuple(o + t for o, t in zip(out, fwd)) + tuple(spart)


def _check_functor_inputs(spec: GridSpec, fn: ChannelFunctor, x, y, z, channels, cuda: bool):
    shape = spec.array_shape
    if len(channels) != fn.n_chan:
        raise ValueError(f"{type(fn).__name__} takes {fn.n_chan} channels, got {len(channels)}")
    ng = fn.n_chan - fn.n_uniform
    grids = (("x", x), ("y", y), ("z", z)) + tuple(
        (f"channel {k}", t) for k, t in enumerate(channels[:ng]))
    for k, t in enumerate(channels[ng:]):
        if not (torch.is_tensor(t) and t.dim() == 0 and t.dtype == torch.float32
                and t.device == x.device):
            raise ValueError(f"uniform channel {ng + k} must be a 0-d float32 tensor "
                             f"on {x.device}")
    for name, t in grids:
        if cuda:
            _build.check_cuda_tensor(t, name, shape)
        elif t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a float32 CPU tensor of shape {shape}")


class PairChannelKernel:
    """The 27-stencil channel kernel (#2) for one ``GridSpec`` and functor.

    With the PSE near-field functor ``fn`` and ``nvec`` (1 or 2) stacked
    3-vectors: ``apply(x, y, z, *channels[, strag]) -> (3 nvec grids) [+ (3
    nvec straggler totals [S])]``. The JAX kernel returns the straggler rows
    as per-program partial grids that its caller sums over (z, yb, lane);
    here they come summed. CPU tensors run ``pair_channel_plain``; CUDA
    tensors launch ``uammd_pair_channel`` (counted in
    ``PAIR_CHANNEL.launches``) or raise.

    With a ``ChannelFunctor``: ``apply(x, y, z, *channels[, strag]) ->
    (n_out grids) [+ (n_out straggler totals [S])]``, on a straggler-free
    spec unless the functor has ``strag``. CPU tensors run
    ``functor_plain``; CUDA tensors launch the functor's instantiation
    (counted in ``fn.kernel.launches``) or raise. ``periodic_z=False`` is
    the halo mode of a straggler-free functor (``fn.kernel_halo``): the
    caller passes a z-slab extended by image-shifted ghost rows and drops
    their outputs. The PSE functor and the straggler-serving functors take
    the halo mode too, at any ``n_strag`` (``PAIR_CHANNEL_HALO``,
    ``fn.kernel_halo``): their straggler totals then sum the reverse terms
    of the slab's interior rows only, as the JAX callers sum the kernel's
    partials (uammd_tpu/parallel/pse_dd2.py:322, :344-347).

    Every launch takes ``channel_launch_plan(spec, fn, nvec)`` (a spec the
    plan cannot fit raises ``ValueError`` before any launch). ``occ_trim``
    is 0; a check's control sets 1, which stops every candidate loop of the
    kernel one row short of the cell's occupancy."""

    occ_trim = 0

    def __init__(self, spec: GridSpec, fn, nvec: int = 1, periodic_z: bool = True):
        if not periodic_z and not (isinstance(fn, PSENear) or (
                isinstance(fn, ChannelFunctor) and fn.kernel_halo is not None)):
            raise ValueError("the halo mode takes the PSE functor or a ChannelFunctor with a "
                             "halo entry (kernel_halo)")
        if isinstance(fn, ChannelFunctor):
            if spec.n_strag and not fn.strag:
                raise ValueError(f"{type(fn).__name__} runs on straggler-free specs "
                                 f"(n_strag = 0), not {spec.n_strag}")
        elif not isinstance(fn, PSENear):
            raise TypeError("the channel kernel takes the PSE near-field functor "
                            "(engine.pse_near.PSENear) or a pair_kernel.ChannelFunctor")
        elif nvec not in (1, 2):
            raise ValueError(f"nvec must be 1 or 2, not {nvec}")
        self.spec = spec
        self.fn = fn
        self.nvec = nvec
        self.periodic_z = bool(periodic_z)
        self._plan = None

    @property
    def plan(self) -> LaunchPlan:
        """The CUDA launch for this spec and functor (``channel_launch_plan``)."""
        if self._plan is None:
            self._plan = channel_launch_plan(self.spec, self.fn, self.nvec)
        return self._plan

    def __call__(self, x, y, z, *channels, strag=None):
        spec, fn, nvec = self.spec, self.fn, self.nvec
        S = spec.n_strag
        if S and strag is None:
            raise ValueError("a straggler-capable spec needs the strag block")
        if isinstance(fn, ChannelFunctor) and not fn.strag:
            return self._functor(x, y, z, channels)
        pse = isinstance(fn, PSENear)
        n_chan = 3 * nvec if pse else fn.n_chan
        if x.device.type == "cpu":
            if pse:
                check_cpu_inputs(spec, nvec, x, y, z, channels, "the channel kernel")
                out, spart = pair_channel_plain(spec, fn, nvec, x, y, z, channels, strag,
                                                self.periodic_z)
                return tuple(out) + (tuple(spart) if S else ())
            _check_functor_inputs(spec, fn, x, y, z, channels, False)
            return functor_plain(spec, fn, x, y, z, channels, strag[:, :, 0] if S else None,
                                 self.periodic_z)
        # PSE, or a straggler-serving functor: one entry signature
        ch, srows = channel_launch_args(spec, n_chan, x, y, z, channels, strag,
                                        "the channel kernel")
        n_out = n_chan if pse else fn.n_out
        plan = self.plan
        T = spec.n_slots
        buf = torch.zeros(n_out * (T + S), dtype=torch.float32, device=x.device)
        out = buf[: n_out * T].view((n_out,) + spec.array_shape)
        spart = buf[n_out * T:].view(n_out, S)
        nx, _, nz = spec.shape
        P = _build.ptr
        if pse:
            kernel, lead, params = (PAIR_CHANNEL if self.periodic_z else PAIR_CHANNEL_HALO,
                                    (nvec,), fn.struct())
        else:
            kernel = fn.kernel if self.periodic_z else fn.kernel_halo
            lead, params = (), fn.params()
        kernel(P(x), P(y), P(z), P(ch), P(srows) if S else _P(0), P(out), P(spart), *lead,
               nx, spec.nyb, nz, spec.fold, spec.cap, S, plan.cc, plan.fc, int(self.occ_trim),
               *spec.box_size, *_strag_inv(spec), params)
        return tuple(out) + (tuple(spart) if S else ())

    def _functor(self, x, y, z, channels):
        """A straggler-free functor's launch (its entry takes no rows)."""
        spec, fn = self.spec, self.fn
        cuda = x.device.type != "cpu"
        _check_functor_inputs(spec, fn, x, y, z, channels, cuda)
        if not cuda:
            return channel_plain(spec, fn, fn.n_out, x, y, z, channels, self.periodic_z)
        ng = fn.n_chan - fn.n_uniform
        ch = torch.stack(channels[:ng])
        uni = torch.stack(channels[ng:]) if fn.n_uniform else None
        plan = self.plan
        out = torch.empty((fn.n_out,) + spec.array_shape, dtype=torch.float32, device=x.device)
        nx, _, nz = spec.shape
        P = _build.ptr
        kernel = fn.kernel if self.periodic_z else fn.kernel_halo
        kernel(P(x), P(y), P(z), P(ch), P(uni) if uni is not None else _P(0), P(out),
               nx, spec.nyb, nz, spec.fold, spec.cap, plan.cc, plan.fc, int(self.occ_trim),
               *spec.box_size, fn.params())
        return tuple(out)


def make_pair_channel_kernel(spec: GridSpec, fn, nvec: int = 1,
                             periodic_z: bool = True) -> PairChannelKernel:
    """Build the 27-stencil channel kernel (see ``PairChannelKernel``)."""
    return PairChannelKernel(spec, fn, nvec, periodic_z)
