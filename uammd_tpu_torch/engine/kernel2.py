"""Newton's-third-law pair force with straggler rows, and the reaction fold.

Port of ``uammd_tpu/engine/kernel2.py``: ``make_newton_pair_kernel`` (with
its ``halo_z`` mode), ``make_fold_kernel`` (with ``fold_reactions_jnp``),
``make_fold_kernel_halo`` (with ``fold_reactions_halo_jnp``), ``broadcast_stragglers``
and ``straggler_pair_forces``; and the channel forms of the PSE near field,
``make_newton_channel_kernel`` (#10) with ``make_fold_kernel_n`` (#9).

Each unordered pair of cells is visited once: the self cell plus the 13
lexicographically positive offsets ``POS_OFFSETS``. The force on the home
particle adds to ``home``; the equal and opposite reaction on the candidate
goes to the candidate's own slot (its row and lane) of ``home`` when the
candidate's (z, y-block) is the home block, else of one of the four
reaction-group grids keyed by the candidate block's displacement
``REACTION_GROUPS``, stored at the *home* block index. The fold then adds
each group at its shifted block:

    f[z, yb] = home[z, yb] + sum_g G_g[(z - dz_g) % nz, (yb - dyb_g) % nyb]

Stragglers (``GridSpec.n_strag``) are a candidate list seen by every home
slot; their forces come back reduced to [S, 3] (the JAX kernel returns
per-program partials that its caller sums). Straggler-straggler pairs are
O(S^2) plain torch (``straggler_pair_forces``).

The halo mode (``halo_z``) is the z-slab of ``parallel/domain2.py``: the
spec counts one slab's home rows, z is not periodic, and the top home row
takes its dz = +1 candidates from a ghost row (the up neighbour's first
home row, z image-shifted by the caller). Its reactions onto the ghost row
come back in the (1, dyb) groups at z = nz - 1; the caller sends them up,
where the halo fold adds them at row 0 from nine ``recv`` blocks.

The Newton channel kernel does the same for per-particle payload channels
with a pair functor that returns a forward and a reverse contribution (the
PSE near-field RPY remainder, ``pse_near.PSENear``, the only functor so
far): the self cell gives every ordered pair forward only, each positive
offset gives the forward sum to home and the reverse to home or a group,
and the straggler list goes both ways; the n-channel fold then gives n
grids.

On CUDA tensors the wrappers launch ``csrc/newton_pair.cu``,
``csrc/fold.cu`` and ``csrc/newton_channel.cu``; on CPU tensors they run
``newton_pair_plain``, ``fold_reactions_plain`` /
``fold_reactions_halo_plain`` / ``fold_reactions_n_plain`` and
``newton_channel_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .layout import GridSpec, recip32, stencil_sources
from .md import LJFused
from .pair_kernel import MAX_CHANNEL_CELLS, SM_BLOCKS, SM_SMEM, LaunchPlan, cell_block_plan
from .pse_near import (
    PSENear,
    _strag_inv,
    _Struct,
    channel_launch_args,
    check_cpu_inputs,
    strag_channel_block,
)

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)

# positive (lexicographic) stencil offsets (dz, dy, dx): every unordered
# cell pair appears exactly once across {self} + POS_OFFSETS
POS_OFFSETS = (
    [(1, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    + [(0, 1, dx) for dx in (-1, 0, 1)]
    + [(0, 0, 1)]
)
# reaction groups: (dz, dyb) displacement of the candidate *block*
REACTION_GROUPS = ((1, -1), (1, 0), (1, 1), (0, 1))

# uammd_newton_pair(x, y, z, strag, out, sforce, nx, nyb, nz, F, cap, S,
#                   self_half, cellcenter, approx, Lx, Ly, Lz, c1, c2, rc2,
#                   lo, cc, fc, occ_trim, stream)
NEWTON_PAIR = _build.Kernel(
    "newton_pair", "uammd_newton_pair", [_P] * 6 + [_I] * 9 + [_F] * 7 + [_I] * 3)
# uammd_newton_pair_halo(x, y, z, gx, gy, gz, strag, out, sforce, nx, nyb,
#                        nz, F, cap, S, self_half, approx, Lx, Ly, Lz, c1,
#                        c2, rc2, lo, cc, fc, occ_trim, stream): the halo_z mode
NEWTON_PAIR_HALO = _build.Kernel(
    "newton_pair", "uammd_newton_pair_halo", [_P] * 9 + [_I] * 8 + [_F] * 7 + [_I] * 3)
# uammd_fold(ins[15], out[3], nz, nyb, plane, stream)
FOLD = _build.Kernel("fold", "uammd_fold", [_PP, _PP, _I, _I, _I])
# uammd_fold_n(raw [5, n, ...], out [n, ...], n, nz, nyb, plane, stream): the
# same source
FOLD_N = _build.Kernel("fold", "uammd_fold_n", [_P, _P, _I, _I, _I, _I])
# uammd_fold_halo(in [15, ...], recv [9, nyb, CAP, NLANE], out [3, ...], nz,
#                 nyb, plane, stream)
FOLD_HALO = _build.Kernel("fold", "uammd_fold_halo", [_P, _P, _P, _I, _I, _I])
# uammd_newton_channel(x, y, z, ch, strag, raw, spart, nv, nx, nyb, nz, F,
#                      cap, S, cc, fc, occ_trim, Lx, Ly, Lz, iLx, iLy, iLz,
#                      near, stream)
NEWTON_CHANNEL = _build.Kernel("newton_channel", "uammd_newton_channel",
                               [_P] * 7 + [_I] * 10 + [_F] * 6 + [_Struct])
NEWTON_CHANNEL_RING = 128  # a warp's pairs waiting for a round (kRing)
NEWTON_CHANNEL_WARPS = 10  # a block's warps at most (kMaxWarps)
NEWTON_CHANNEL_SM_WARPS = 21  # warps an SM holds at the kernel's 96 registers
NEWTON_CHANNEL_HDR = 16  # a block's scalars (kHdr)


def newton_channel_warps(cap: int, cc: int, fc: int) -> int:
    """The warps of a #10 block (``warps_of`` in the .cu): one a cell, at
    most 10, so that two blocks an SM keep 96 registers a thread
    (``__launch_bounds__(320, 2)``), at which ptxas spills nothing.
    ``cap`` is unused: chunks come about a cell each at the PSE grid's
    occupancy (~20 of CAP 32)."""
    return min(NEWTON_CHANNEL_WARPS, cc * fc)


def newton_channel_smem_bytes(cap: int, cc: int, fc: int, nc: int, n_strag: int) -> int:
    """The dynamic shared memory of a #10 block (``smem_bytes`` in
    csrc/newton_channel.cu): 2 z layers of W = (cc + 2) x (fc + 2) staged
    columns of CAP float4 positions in rows W | 1 apart and a float4 shift
    a column; per warp a ring of 128 pairs (int2), its chunk's box (8
    floats) and home channels [32][nc]; the reverse table [nc][2][CAP][W];
    3 ints a column; per home cell a count and CAP list entries; the chunk
    starts and 16 scalars; the straggler rows' kept list [S] (the rows stay
    in device memory)."""
    w = (cc + 2) * (fc + 2)
    cells = cc * fc
    npc = -(-cap // 32)
    per_warp = 8 * NEWTON_CHANNEL_RING + 32 + 128 * nc
    return (2 * cap * (w | 1) * 16 + 2 * w * 16 + per_warp * newton_channel_warps(cap, cc, fc)
            + 4 * nc * 2 * cap * w + 2 * w * 12 + 4 * cells * (1 + cap)
            + 4 * (cells * npc + 1 + NEWTON_CHANNEL_HDR) + 4 * n_strag)


def newton_channel_plan(spec: GridSpec, nvec: int) -> LaunchPlan:
    """The launch of ``csrc/newton_channel.cu`` (#10) for ``spec`` at
    ``nvec`` stacked 3-vectors: the block shape from ``cell_block_plan``
    over ``newton_channel_smem_bytes``, up to 64 cells and 10 warps a
    block (``newton_channel_warps``), preferring blocks of which two fit an
    SM, a warp for every cell, the fewest staged columns, then the most
    warps resident on an SM. Raises ``ValueError`` when no block fits or
    the outputs pass the kernel's 32-bit indices."""
    nc = 3 * nvec
    cap = spec.cap
    if spec.n_slots * 5 * nc >= 2 ** 31:
        raise ValueError(f"{spec.n_slots} slots x 5 x {nc} outputs exceed the Newton channel "
                         f"kernel's 32-bit indices")

    def key(cc, fc, smem, blocks):
        if 2 * cap * ((cc + 2) * (fc + 2) | 1) > 65535:  # 16-bit staged indices
            return (1,)
        warps = newton_channel_warps(cap, cc, fc)
        resident = min(SM_BLOCKS, NEWTON_CHANNEL_SM_WARPS // warps, SM_SMEM // (smem + 1024))
        # two blocks an SM at least, so that one's staging and flush overlap
        # the other's walk; a warp for every cell; the fewest staged columns
        # (chip runs of the shapes on the PSE grid, PERF.md section 6)
        return (int(resident < 2), int(cc * fc > warps), blocks * (cc + 2) * (fc + 2),
                -resident * warps, -cc)

    plan = cell_block_plan(
        spec, lambda cc, fc: newton_channel_smem_bytes(cap, cc, fc, nc, spec.n_strag),
        max_cells=MAX_CHANNEL_CELLS,
        threads_of=lambda cc, fc: 32 * newton_channel_warps(cap, cc, fc),
        key_of=key)
    if 2 * cap * ((plan.cc + 2) * (plan.fc + 2) | 1) > 65535:
        raise ValueError(f"CAP {cap} is too deep for the Newton channel kernel's staging")
    return plan


def newton_launch_plan(spec: GridSpec) -> LaunchPlan:
    """The launch of ``csrc/newton_pair.cu`` (both modes) for ``spec``: per
    block, 2 z layers of W = (cc + 2) x (fc + 2) staged columns, each CAP
    float4 slots and 3 reaction floats in rows W | 1 apart, plus a float4
    shift and 2 ints; the [4, S] stragglers with an index each, and 8 ints
    (``smem_bytes`` there)."""
    def smem(cc, fc):
        w = (cc + 2) * (fc + 2)
        return 2 * (28 * spec.cap * (w | 1) + 24 * w) + 20 * spec.n_strag + 32
    return cell_block_plan(spec, smem)


def broadcast_stragglers(spec: GridSpec, spos, spid):
    """[S, 3] straggler positions + validity -> the [4, S, NLANE] block
    (x, y, z, valid) that the pair kernel takes (a broadcast view)."""
    val = (spid >= 0).to(torch.float32)
    stack = torch.stack([spos[:, 0], spos[:, 1], spos[:, 2], val])
    return stack[:, :, None].expand(4, spec.n_strag, spec.nlane)


@functools.lru_cache(maxsize=None)
def _box(box_size: tuple, device: torch.device):
    """The box lengths and their float32 reciprocals as [3] tensors on
    ``device``, made once (a copy to the card per step would sync it)."""
    return (torch.tensor(box_size, dtype=torch.float32, device=device),
            torch.tensor([recip32(L) for L in box_size], dtype=torch.float32, device=device))


def straggler_pair_forces(spec: GridSpec, g_fn, spos, spid, clamp_lo: float = 4e-3):
    """O(S^2) straggler-straggler forces (minimum image), [S, 3]."""
    Ls, iLs = _box(spec.box_size, spos.device)
    rc2 = float(np.float32(spec.cutoff * spec.cutoff))
    val = spid >= 0
    d = spos[None, :, :] - spos[:, None, :]
    d = d - Ls * torch.round(d * iLs)
    r2 = torch.sum(d * d, dim=-1)
    ok = (r2 < rc2) & (r2 > 1e-10) & val[None, :] & val[:, None]
    g = torch.where(ok, g_fn(torch.clamp(r2, min=float(np.float32(clamp_lo)))),
                    torch.zeros((), dtype=r2.dtype, device=r2.device))
    return torch.sum(g[:, :, None] * d, dim=1)


def _straggler_block(spec: GridSpec, g_fn: LJFused, xi, yi, zi, strag,
                     strag_cellcenter: bool):
    """Forces between every home slot and the straggler list:
    returns (t_x, t_y, t_z) of shape [nz, nyb, CAP, S, NLANE]."""
    nz = spec.shape[2]
    F = spec.fold
    Lx, Ly, Lz = spec.box_size
    iLx, iLy, iLz = (recip32(L) for L in spec.box_size)
    dev = xi.device
    sx, sy, sz, sval = (strag[k][None, None, None, :, None] for k in range(4))
    if strag_cellcenter:
        # min-image the stragglers once per home cell against the cell
        # centre (kernel2.py:314-352): any pair inside the cutoff has its
        # other image far outside it, and the fused radial fails every
        # pair outside the cutoff whatever image was picked
        cs = [float(np.float32(v)) for v in spec.cell_size]
        lane = torch.arange(spec.nlane, device=dev)
        cxf = (lane // F).to(torch.float32)
        ff = (lane % F).to(torch.float32)
        ccx = ((cxf + 0.5) * cs[0] - 0.5 * Lx)[None, None, None, None, :]
        yrow = torch.arange(spec.nyb, device=dev).to(torch.float32)[:, None] * F + ff
        ccy = ((yrow + 0.5) * cs[1] - 0.5 * Ly)[None, :, None, None, :]
        zrow = torch.arange(nz, device=dev).to(torch.float32)
        ccz = ((zrow + 0.5) * cs[2] - 0.5 * Lz)[:, None, None, None, None]
        dxv = (sx - Lx * torch.round((sx - ccx) * iLx)) - xi
        dyv = (sy - Ly * torch.round((sy - ccy) * iLy)) - yi
        dzv = (sz - Lz * torch.round((sz - ccz) * iLz)) - zi
        g = g_fn(dxv * dxv + dyv * dyv + dzv * dzv) * sval
    else:
        dxv = sx - xi
        dyv = sy - yi
        dzv = sz - zi
        dxv = dxv - Lx * torch.round(dxv * iLx)
        dyv = dyv - Ly * torch.round(dyv * iLy)
        dzv = dzv - Lz * torch.round(dzv * iLz)
        # an empty home slot sits far outside the box, where the minimum
        # image would bring it back: mask it out
        ok = (sval > 0.5) & (xi < 1.0e8)
        g = torch.where(ok, g_fn(dxv * dxv + dyv * dyv + dzv * dzv),
                        torch.zeros((), dtype=xi.dtype, device=dev))
    return g * dxv, g * dyv, g * dzv


def newton_pair_plain(spec: GridSpec, g_fn: LJFused, x, y, z, strag=None, *,
                      strag_cellcenter: bool = False, ghost=None):
    """Plain PyTorch version of the Newton pair kernel.

    The self block is the full all-pairs block (both directions), as the
    JAX kernel computes it off the TPU (kernel2.py:188-196). Each positive
    offset gathers the candidate cell's slots into home order
    (``stencil_sources``), forms the [nz, nyb, CAP_i, CAP_j, NLANE] pair
    block, adds its sum over candidates to the home force and scatters the
    reaction (its sum over home rows) by candidate lane into ``home`` or the
    candidate block's group. Returns ``(home (fx, fy, fz), groups (4 x
    (gx, gy, gz)), sforce [S, 3] or None)``; ``strag`` is the [4, S, NLANE]
    block of ``broadcast_stragglers`` (its first lane is read). ``g_fn``
    is the fused LJ radial (``md.lj_g_fused``), which applies the cutoff
    and the clamp itself. With ``ghost = (gx, gy, gz)`` ([1, nyb, CAP,
    NLANE] each) it is the halo mode: the dz = +1 candidates of the top row
    come from the ghost row, and z takes no image shift."""
    dev = x.device
    cap, F = spec.cap, spec.fold
    nz = spec.shape[2]
    # the candidates' source: the slab itself, or the slab with the ghost
    # row appended as row nz (reached only by the top row's dz = +1)
    src = (x, y, z) if ghost is None else tuple(
        torch.cat([a, g]) for a, g in zip((x, y, z), ghost))
    halo = dict(periodic_z=True) if ghost is None else dict(periodic_z=False, z_rows=nz + 1)
    rows = torch.arange(cap, device=dev)[None, None, :, None]
    xi, yi, zi = (a[:, :, :, None, :] for a in (x, y, z))

    # self block: all ordered pairs of the home cell; d = 0 on the diagonal
    dxv = x[:, :, None, :, :] - xi
    dyv = y[:, :, None, :, :] - yi
    dzv = z[:, :, None, :, :] - zi
    g = g_fn(dxv * dxv + dyv * dyv + dzv * dzv)
    home = [(g * dxv).sum(dim=3), (g * dyv).sum(dim=3), (g * dzv).sum(dim=3)]
    grp = {key: [torch.zeros_like(x) for _ in range(3)] for key in REACTION_GROUPS}

    f_lane = torch.arange(spec.nlane, device=dev) % F
    for (dz, dy, dx) in POS_OFFSETS:
        zs, ybs, lane, (shx, shy, shz) = stencil_sources(spec, dz, dy, dx, dev, **halo)
        cx = src[0][zs, ybs, rows, lane] + shx
        cy = src[1][zs, ybs, rows, lane] + shy
        cz = src[2][zs, ybs, rows, lane] + shz
        dxv = cx[:, :, None, :, :] - xi
        dyv = cy[:, :, None, :, :] - yi
        dzv = cz[:, :, None, :, :] - zi
        g = g_fn(dxv * dxv + dyv * dyv + dzv * dzv)
        # the candidate lane of every home lane: a permutation, the same for
        # every y-block
        sl = lane[0, 0, 0, :]
        infold = ((f_lane + dy >= 0) & (f_lane + dy < F))[None, None, None, :]
        target_in = home if dz == 0 else grp[(dz, 0)]
        for c, dv in enumerate((dxv, dyv, dzv)):
            t = g * dv
            home[c] = home[c] + t.sum(dim=3)
            r = -t.sum(dim=2)  # [nz, nyb, CAP_j, NLANE] in home-lane order
            zero = torch.zeros((), dtype=r.dtype, device=dev)
            target_in[c].index_add_(3, sl, torch.where(infold, r, zero))
            if dy != 0:
                grp[(dz, dy)][c].index_add_(3, sl, torch.where(infold, zero, r))

    sforce = None
    if spec.n_strag:
        t = _straggler_block(spec, g_fn, xi, yi, zi, strag[:, :, 0], strag_cellcenter)
        home = [h + tc.sum(dim=3) for h, tc in zip(home, t)]
        sforce = torch.stack([-tc.sum(dim=(0, 1, 2, 4)) for tc in t], dim=-1)
    groups = tuple(tuple(grp[key]) for key in REACTION_GROUPS)
    return tuple(home), groups, sforce


class NewtonPairKernel:
    """``force(x, y, z[, strag]) -> (home, groups, sforce)`` for one
    ``GridSpec`` (see ``newton_pair_plain`` for the contract); with
    ``halo_z``, ``force(x, y, z, gx, gy, gz[, strag])`` with the ghost row.

    ``g_fn`` is the fused LJ radial (``md.lj_g_fused``), whose constants
    the CUDA kernel reads. CPU tensors go to ``newton_pair_plain``; CUDA
    tensors launch ``csrc/newton_pair.cu`` (counted in
    ``NEWTON_PAIR.launches``, the halo mode in ``NEWTON_PAIR_HALO``) or
    raise. The CUDA kernel honours ``self_half`` (the self cell
    Newton-halved: each in-cell pair once) and ``strag_cellcenter`` (not
    in the halo mode, as in JAX), and takes the approximate reciprocal when
    the radial's ``approx`` is set. It launches with
    ``newton_launch_plan(spec)``; a spec the plan cannot fit raises
    ``ValueError`` before any launch. ``occ_trim`` is 0; a check's control
    sets 1, which stops every candidate loop of the kernel one row short of
    the cell's occupancy."""

    occ_trim = 0

    def __init__(self, spec: GridSpec, g_fn: LJFused, *, self_half: bool = False,
                 strag_cellcenter: bool = False, halo_z: bool = False):
        if not isinstance(g_fn, LJFused):
            raise TypeError("the Newton pair kernel takes the fused LJ radial "
                            "(md.lj_g_fused)")
        if halo_z and strag_cellcenter:
            raise ValueError("strag_cellcenter needs global cell centres; the halo mode "
                             "min-images the stragglers per pair")
        self.spec = spec
        self.g_fn = g_fn
        self.self_half = bool(self_half)
        self.strag_cellcenter = bool(strag_cellcenter)
        self.halo_z = bool(halo_z)
        self._plan = None

    @property
    def plan(self) -> LaunchPlan:
        """The CUDA launch for this spec (``newton_launch_plan``)."""
        if self._plan is None:
            self._plan = newton_launch_plan(self.spec)
        return self._plan

    def __call__(self, x, y, z, *rest):
        out, sforce = self.stacked(x, y, z, *rest)
        home = (out[0], out[1], out[2])
        groups = tuple((out[3 + 3 * i], out[4 + 3 * i], out[5 + 3 * i]) for i in range(4))
        return home, groups, sforce

    def stacked(self, x, y, z, *rest):
        """The same arguments; returns ``(out [15, nz, nyb, CAP, NLANE],
        sforce)``: home x, y, z, then group g channel c at 3 + 3 g + c, one
        buffer (the kernel's own output; stacked from the plain version's on
        CPU tensors), as the halo fold's stacked entry takes it."""
        spec = self.spec
        shape = spec.array_shape
        S = spec.n_strag
        ghost = None
        if self.halo_z:
            if len(rest) < 3:
                raise ValueError("the halo mode takes the ghost row gx, gy, gz")
            ghost, rest = rest[:3], rest[3:]
        strag = rest[0] if rest else None
        if S and strag is None:
            raise ValueError("a straggler-capable spec needs the strag block")
        gshape = (1,) + shape[1:]
        if x.device.type == "cpu":
            named = [("x", x, shape), ("y", y, shape), ("z", z, shape)]
            if ghost is not None:
                named += [(n, t, gshape) for n, t in zip(("gx", "gy", "gz"), ghost)]
            for name, t, shp in named:
                if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shp:
                    raise ValueError(f"{name} must be a float32 CPU tensor of shape {shp}")
            home, groups, sforce = newton_pair_plain(
                spec, self.g_fn, x, y, z, strag, strag_cellcenter=self.strag_cellcenter,
                ghost=ghost)
            return torch.stack(list(home) + [c for g in groups for c in g]), sforce
        for name, t in (("x", x), ("y", y), ("z", z)):
            _build.check_cuda_tensor(t, name, shape)
        if ghost is not None:
            for name, t in zip(("gx", "gy", "gz"), ghost):
                _build.check_cuda_tensor(t, name, gshape)
        plan = self.plan
        launch = (plan.cc, plan.fc, int(self.occ_trim))
        T = spec.n_slots
        buf = torch.zeros(15 * T + 3 * S, dtype=torch.float32, device=x.device)
        out = buf[: 15 * T].view((15,) + shape)
        sforce = buf[15 * T:].view(S, 3)
        if S:
            s = strag[:, :, 0].to(torch.float32).contiguous()
            _build.check_cuda_tensor(s, "strag", (4, S))
            sp = _build.ptr(s)
        else:
            sp = _P(0)
        nx, _, nz = spec.shape
        g = self.g_fn
        P = _build.ptr
        if ghost is None:
            NEWTON_PAIR(
                P(x), P(y), P(z), sp, P(out), P(sforce),
                nx, spec.nyb, nz, spec.fold, spec.cap, S,
                int(self.self_half), int(self.strag_cellcenter), int(g.approx),
                *spec.box_size, g.c1, g.c2, g.rc2, g.lo, *launch,
            )
        else:
            NEWTON_PAIR_HALO(
                P(x), P(y), P(z), *(P(t) for t in ghost), sp, P(out), P(sforce),
                nx, spec.nyb, nz, spec.fold, spec.cap, S, int(self.self_half), int(g.approx),
                *spec.box_size, g.c1, g.c2, g.rc2, g.lo, *launch,
            )
        return out, (sforce if S else None)


def make_newton_pair_kernel(spec: GridSpec, g_fn: LJFused, *, self_half: bool = False,
                            strag_cellcenter: bool = False,
                            halo_z: bool = False) -> NewtonPairKernel:
    """Build ``force(x, y, z[, strag]) -> (home[3], groups[4][3], sforce)``
    on [nz, nyb, CAP, NLANE] float32 tensors; with ``halo_z``,
    ``force(x, y, z, gx, gy, gz[, strag])``."""
    return NewtonPairKernel(spec, g_fn, self_half=self_half,
                            strag_cellcenter=strag_cellcenter, halo_z=halo_z)


def fold_reactions_plain(home, groups):
    """Plain version of the fold: ``home + roll(G_g, (dz_g, dyb_g))`` added
    in ``REACTION_GROUPS`` order (bit-equal to ``fold_reactions_jnp``)."""
    out = list(home)
    for (dz, dyb), g in zip(REACTION_GROUPS, groups):
        for c in range(3):
            out[c] = out[c] + torch.roll(g[c], shifts=(dz, dyb), dims=(0, 1))
    return tuple(out)


class FoldKernel:
    """``fold(home[3], groups[4][3]) -> (fx, fy, fz)`` for one ``GridSpec``.

    CPU tensors go to ``fold_reactions_plain``; CUDA tensors launch
    ``csrc/fold.cu`` (counted in ``FOLD.launches``) or raise."""

    def __init__(self, spec: GridSpec):
        self.spec = spec

    def __call__(self, home, groups):
        ins = list(home) + [c for g in groups for c in g]
        if len(ins) != 15:
            raise ValueError("fold takes 3 home grids and 4 x 3 group grids")
        shape = self.spec.array_shape
        if ins[0].device.type == "cpu":
            for t in ins:
                if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shape:
                    raise ValueError(f"fold inputs must be float32 CPU tensors of shape {shape}")
            return fold_reactions_plain(home, groups)
        for k, t in enumerate(ins):
            _build.check_cuda_tensor(t, f"fold input {k}", shape)
        out = torch.empty((3,) + shape, dtype=torch.float32, device=ins[0].device)
        nz, nyb, cap, nlane = shape
        FOLD((_P * 15)(*(t.data_ptr() for t in ins)),
             (_P * 3)(*(o.data_ptr() for o in out)), nz, nyb, cap * nlane)
        return out[0], out[1], out[2]


def make_fold_kernel(spec: GridSpec) -> FoldKernel:
    """Build ``fold(home, groups) -> (fx, fy, fz)``."""
    return FoldKernel(spec)


def fold_reactions_halo_plain(home, groups, recvs):
    """Plain version of the halo fold (bit-equal to
    ``fold_reactions_halo_jnp``): z is a non-periodic slab, and the (1, dyb)
    groups' row 0 comes from ``recvs`` (9 [1, nyb, CAP, NLANE] blocks,
    ``REACTION_GROUPS[:3]`` x (x, y, z)); added in ``REACTION_GROUPS``
    order."""
    out = list(home)
    for gi, ((dz, dyb), g) in enumerate(zip(REACTION_GROUPS, groups)):
        for c in range(3):
            arr = g[c]
            if dz == 1:
                arr = torch.cat([recvs[3 * gi + c], arr[:-1]])
            out[c] = out[c] + torch.roll(arr, shifts=dyb, dims=1)
    return tuple(out)


class FoldHaloKernel:
    """``fold(home[3], groups[4][3], recvs[9]) -> (fx, fy, fz)`` for one
    z-slab ``GridSpec`` (the spec's nz counts the slab's home rows), and
    ``fold.stacked(buf [15, nz, nyb, CAP, NLANE], recv [9, nyb, CAP,
    NLANE])``, the same on stacked buffers: the Newton halo kernel's output
    (``NewtonPairKernel.stacked``) and the reactions' exchange as it
    arrives.

    CPU tensors go to ``fold_reactions_halo_plain``; CUDA tensors launch
    ``uammd_fold_halo`` of ``csrc/fold.cu`` (counted in
    ``FOLD_HALO.launches``; the list form stacks its grids first) or
    raise."""

    def __init__(self, spec: GridSpec):
        self.spec = spec
        self._shape = spec.array_shape

    def __call__(self, home, groups, recvs):
        ins = list(home) + [c for g in groups for c in g]
        recvs = list(recvs)
        if len(ins) != 15 or len(recvs) != 9:
            raise ValueError("the halo fold takes 3 home grids, 4 x 3 group grids and "
                             "9 recv blocks")
        shape = self.spec.array_shape
        rshape = (1,) + shape[1:]
        if ins[0].device.type == "cpu":
            named = [(f"fold input {k}", t, shape) for k, t in enumerate(ins)] + [
                (f"recv {k}", t, rshape) for k, t in enumerate(recvs)]
            for name, t, shp in named:
                if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shp:
                    raise ValueError(f"{name} must be a float32 CPU tensor of shape {shp}")
            return fold_reactions_halo_plain(home, groups, recvs)
        return self.stacked(torch.stack(ins), torch.cat(recvs))

    def stacked(self, buf: torch.Tensor, recv: torch.Tensor):
        shape = self._shape
        bshape, rshape = (15,) + shape, (9,) + shape[1:]
        if buf.device.type == "cpu":
            for name, t, shp in (("buf", buf, bshape), ("recv", recv, rshape)):
                if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shp:
                    raise ValueError(f"{name} must be a float32 CPU tensor of shape {shp}")
            return fold_reactions_halo_plain(
                buf[:3], [buf[3 + 3 * g:6 + 3 * g] for g in range(4)], recv[:, None])
        nz, nyb, cap, nlane = shape
        if cap * nlane % 4:
            raise ValueError(f"the halo fold reads 4 slots at a time: CAP x NLANE = "
                             f"{cap * nlane} is not a multiple of 4")
        _build.check_cuda_tensor(buf, "buf", bshape)
        _build.check_cuda_tensor(recv, "recv", rshape)
        out = torch.empty((3,) + shape, dtype=torch.float32, device=buf.device)
        FOLD_HALO(_build.ptr(buf), _build.ptr(recv), _build.ptr(out), nz, nyb, cap * nlane)
        return out.unbind(0)


def make_fold_kernel_halo(spec: GridSpec) -> FoldHaloKernel:
    """Build ``fold(home, groups, recvs) -> (fx, fy, fz)`` for a z-slab."""
    return FoldHaloKernel(spec)


def fold_reactions_n_plain(home, groups):
    """Plain version of the n-channel fold (bit-equal to
    ``fold_reactions_n_jnp``): ``home[c] + roll(G_g[c], (dz_g, dyb_g))``."""
    out = list(home)
    for (dz, dyb), g in zip(REACTION_GROUPS, groups):
        for c in range(len(out)):
            out[c] = out[c] + torch.roll(g[c], shifts=(dz, dyb), dims=(0, 1))
    return tuple(out)


class FoldNKernel:
    """``fold(home[n], groups[4][n]) -> n grids`` for one ``GridSpec``, the
    fold of the Newton channel kernel (n <= 6), and ``fold.stacked(raw [5,
    n, nz, nyb, CAP, NLANE]) -> [n, nz, nyb, CAP, NLANE]``, the same on the
    Newton channel kernel's buffer as it comes (home channel c at [0, c],
    group g channel c at [1 + g, c]).

    CPU tensors go to ``fold_reactions_n_plain``; CUDA tensors launch
    ``uammd_fold_n`` of ``csrc/fold.cu`` (counted in ``FOLD_N.launches``;
    the list form stacks its grids first) or raise."""

    def __init__(self, spec: GridSpec, n: int):
        if not 1 <= n <= 6:
            raise ValueError(f"the fold takes 1 to 6 channels, not {n}")
        self.spec = spec
        self.n = n
        self._raw_shape = torch.Size((5, n) + spec.array_shape)
        nz, nyb, cap, nlane = spec.array_shape
        self._args = (n, nz, nyb, cap * nlane)

    def __call__(self, home, groups):
        n = self.n
        ins = list(home) + [c for g in groups for c in g]
        if len(home) != n or len(groups) != 4 or len(ins) != 5 * n:
            raise ValueError(f"fold takes {n} home grids and 4 x {n} group grids")
        shape = self.spec.array_shape
        if ins[0].device.type == "cpu":
            for t in ins:
                if t.device.type != "cpu" or t.dtype != torch.float32 or tuple(t.shape) != shape:
                    raise ValueError(f"fold inputs must be float32 CPU tensors of shape {shape}")
            return fold_reactions_n_plain(home, groups)
        _build.check_cuda_tensors(ins, "fold input", shape)
        return tuple(self.stacked(torch.stack(ins).view(self._raw_shape)).unbind(0))

    def stacked(self, raw: torch.Tensor) -> torch.Tensor:
        if raw.device.type == "cpu":
            if raw.dtype != torch.float32 or raw.shape != self._raw_shape:
                raise ValueError(f"raw must be a float32 CPU tensor of shape "
                                 f"{tuple(self._raw_shape)}")
            return torch.stack(fold_reactions_n_plain(raw[0], raw[1:]))
        if self._args[3] % 4:
            raise ValueError(f"the n-channel fold reads 4 slots at a time: CAP x NLANE = "
                             f"{self._args[3]} is not a multiple of 4")
        _build.check_cuda_tensor(raw, "raw", self._raw_shape)
        out = torch.empty(self._raw_shape[1:], dtype=torch.float32, device=raw.device)
        FOLD_N(raw.data_ptr(), out.data_ptr(), *self._args)
        return out


def make_fold_kernel_n(spec: GridSpec, n: int) -> FoldNKernel:
    """Build ``fold(home[n], groups[4][n]) -> n grids``."""
    return FoldNKernel(spec, n)


def newton_channel_plain(spec: GridSpec, fn: PSENear, nvec: int, x, y, z, channels,
                         strag=None):
    """Plain PyTorch version of the Newton channel kernel (#10) with the PSE
    near-field functor ``fn`` on ``nvec`` stacked 3-vectors.

    The self cell gives every ordered pair, forward only; each positive
    offset gathers the candidate cell into home order
    (``stencil_sources``), adds the forward sum over candidates to home and
    scatters the reverse (its sum over home rows) by candidate lane into
    home or the candidate block's group, as ``newton_pair_plain`` does for
    forces. Returns ``(home (3 nvec grids), groups (4 x 3 nvec), spart
    [3 nvec, S] or None)``: the straggler rows' reverse sums, which the JAX
    kernel returns as per-program partials. ``strag`` holds the rows of
    ``broadcast_strag_channels`` (its first lane is read)."""
    dev = x.device
    nc = 3 * nvec
    rows = torch.arange(spec.cap, device=dev)[None, None, :, None]
    xi, yi, zi = (a[:, :, :, None, :] for a in (x, y, z))
    ch_i = [c[:, :, :, None, :] for c in channels]

    # self block: all ordered pairs of the home cell; d = 0 on the diagonal
    dxv = x[:, :, None, :, :] - xi
    dyv = y[:, :, None, :, :] - yi
    dzv = z[:, :, None, :, :] - zi
    ch_j = [c[:, :, None, :, :] for c in channels]
    home = [t.sum(dim=3) for t in fn.pair(dxv * dxv + dyv * dyv + dzv * dzv, dxv, dyv, dzv,
                                         ch_j, nvec)]
    grp = {key: [torch.zeros_like(x) for _ in range(nc)] for key in REACTION_GROUPS}

    f_lane = torch.arange(spec.nlane, device=dev) % spec.fold
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    for (dz, dy, dx) in POS_OFFSETS:
        zs, ybs, lane, (shx, shy, shz) = stencil_sources(spec, dz, dy, dx, dev)
        cx = x[zs, ybs, rows, lane] + shx
        cy = y[zs, ybs, rows, lane] + shy
        cz = z[zs, ybs, rows, lane] + shz
        ch_j = [c[zs, ybs, rows, lane][:, :, None] for c in channels]
        dxv = cx[:, :, None, :, :] - xi
        dyv = cy[:, :, None, :, :] - yi
        dzv = cz[:, :, None, :, :] - zi
        fwd, bwd = fn.pair_both(dxv * dxv + dyv * dyv + dzv * dzv, dxv, dyv, dzv, ch_i, ch_j,
                                nvec)
        sl = lane[0, 0, 0, :]
        infold = ((f_lane + dy >= 0) & (f_lane + dy < spec.fold))[None, None, None, :]
        target_in = home if dz == 0 else grp[(dz, 0)]
        for c in range(nc):
            home[c] = home[c] + fwd[c].sum(dim=3)
            r = bwd[c].sum(dim=2)  # [nz, nyb, CAP_j, NLANE] in home-lane order
            target_in[c].index_add_(3, sl, torch.where(infold, r, zero))
            if dy != 0:
                grp[(dz, dy)][c].index_add_(3, sl, torch.where(infold, zero, r))

    spart = None
    if spec.n_strag:
        fwd, spart = strag_channel_block(spec, fn.pair_fn(nvec), 3 * nvec, xi, yi, zi,
                                         ch_i, strag[:, :, 0])
        home = [h + t for h, t in zip(home, fwd)]
    groups = tuple(tuple(grp[key]) for key in REACTION_GROUPS)
    return tuple(home), groups, spart


class NewtonChannelKernel:
    """``apply(x, y, z, *channels[, strag]) -> (3 nvec folded grids) [+ (3
    nvec straggler totals [S])]`` for one ``GridSpec``, the PSE near-field
    functor ``fn`` and ``nvec`` (1 or 2) stacked 3-vectors: the Newton
    channel kernel (#10) followed by the n-channel fold (#9), as the JAX
    kernel's ``apply`` returns them; ``raw`` gives the unfolded (home,
    groups, spart), ``raw_stacked`` the same as the kernel's one buffer.
    The JAX kernel returns the straggler rows as per-program partial grids
    that its caller sums over (z, yb, lane); here they come summed. CPU
    tensors run ``newton_channel_plain`` and ``fold_reactions_n_plain``;
    CUDA tensors launch ``csrc/newton_channel.cu`` (counted in
    ``NEWTON_CHANNEL.launches``) and ``uammd_fold_n`` on its buffer as it
    is (``FoldNKernel.stacked``) or raise."""

    # 0; a check's control sets 1 on an instance to stop every candidate
    # loop one row short (the CPU path ignores it)
    occ_trim = 0

    def __init__(self, spec: GridSpec, fn: PSENear, nvec: int = 1):
        if not isinstance(fn, PSENear):
            raise TypeError("the channel kernels take the PSE near-field functor "
                            "(engine.pse_near.PSENear)")
        if nvec not in (1, 2):
            raise ValueError(f"nvec must be 1 or 2, not {nvec}")
        self.spec = spec
        self.fn = fn
        self.nvec = nvec
        self.fold = FoldNKernel(spec, 3 * nvec)
        self.plan = None  # newton_channel_plan, at the first launch

    def raw(self, x, y, z, *channels, strag=None):
        if x.device.type == "cpu":
            if self.spec.n_strag and strag is None:
                raise ValueError("a straggler-capable spec needs the strag block")
            check_cpu_inputs(self.spec, self.nvec, x, y, z, channels,
                             "the Newton channel kernel")
            return newton_channel_plain(self.spec, self.fn, self.nvec, x, y, z, channels,
                                        strag)
        raw, spart = self.raw_stacked(x, y, z, *channels, strag=strag)
        home = tuple(raw[0])
        groups = tuple(tuple(raw[1 + g]) for g in range(4))
        return home, groups, spart

    def raw_stacked(self, x, y, z, *channels, strag=None):
        """``raw`` as the kernel writes it: ``(raw [5, 3 nvec, nz, nyb, CAP,
        NLANE], spart [3 nvec, S] or None)``, home channel c at [0, c] and
        group g channel c at [1 + g, c] (stacked from the plain version's on
        CPU tensors), as ``FoldNKernel.stacked`` takes it."""
        spec, nvec = self.spec, self.nvec
        S = spec.n_strag
        if S and strag is None:
            raise ValueError("a straggler-capable spec needs the strag block")
        if x.device.type == "cpu":
            home, groups, spart = self.raw(x, y, z, *channels, strag=strag)
            return torch.stack([torch.stack(home)] + [torch.stack(g) for g in groups]), spart
        ch, srows = channel_launch_args(spec, 3 * nvec, x, y, z, channels, strag,
                                        "the Newton channel kernel")
        if self.plan is None:
            self.plan = newton_channel_plan(spec, nvec)
        plan = self.plan
        nc = 3 * nvec
        T = spec.n_slots
        buf = torch.zeros(5 * nc * T + nc * S, dtype=torch.float32, device=x.device)
        raw = buf[: 5 * nc * T].view((5, nc) + spec.array_shape)
        spart = buf[5 * nc * T:].view(nc, S)
        nx, _, nz = spec.shape
        P = _build.ptr
        NEWTON_CHANNEL(
            P(x), P(y), P(z), P(ch), P(srows) if S else _P(0), P(raw), P(spart),
            nvec, nx, spec.nyb, nz, spec.fold, spec.cap, S, plan.cc, plan.fc, self.occ_trim,
            *spec.box_size, *_strag_inv(spec), self.fn.struct(),
        )
        return raw, (spart if S else None)

    def __call__(self, x, y, z, *channels, strag=None):
        raw, spart = self.raw_stacked(x, y, z, *channels, strag=strag)
        folded = self.fold.stacked(raw).unbind(0)
        if self.spec.n_strag:
            return folded + spart.unbind(0)
        return folded


def make_newton_channel_kernel(spec: GridSpec, fn: PSENear, nvec: int = 1) -> NewtonChannelKernel:
    """Build the Newton channel kernel with its fold (see
    ``NewtonChannelKernel``)."""
    return NewtonChannelKernel(spec, fn, nvec)
