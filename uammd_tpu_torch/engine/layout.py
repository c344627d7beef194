"""Grid-resident particle layout (PyTorch port of uammd_tpu/engine/layout.py).

Every per-particle quantity is stored as ``[nz, nyb, CAP, NLANE]`` float32,
slot for slot the same as the JAX package:

- cells: the box is split into (nx, ny, nz) cells with edge >= cutoff*skin.
- fold: F consecutive y-rows are folded into the lane dimension, so lane
  ``l`` encodes ``(cx = l // F, f = l % F)`` and the row is ``y = yb*F + f``
  with ``yb`` the second array axis (``nyb = ny / F``).
- CAP: fixed per-cell capacity; empty slots hold position ``EMPTY_POS`` so
  every pair involving them fails the cutoff test; their pid is -1.

Binning from canonical order (``pack``) and the reference rebin (``rebin``)
use a stable sort; they are off the hot path. The hot-path rebin is the
kernel in ``rebin_kernel.py``. Cell overflow latches a flag on the device
(reference error-flag idiom, CellListBase.cuh:82-85).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device

EMPTY_POS = 1.0e9


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static geometry of the grid-resident layout."""

    box_size: tuple  # (Lx, Ly, Lz) floats
    shape: tuple  # (nx, ny, nz) cells
    cap: int
    fold: int
    cutoff: float
    skin: float  # rl = cutoff*skin; cells are >= rl on each axis
    # Straggler capacity (used by the v2 engine): when > 0, CAP covers the
    # occupancy quantile and the particles ranked >= CAP in an overflowing
    # cell ride in a dense [n_strag] side list.
    n_strag: int = 0

    @property
    def nyb(self) -> int:
        return self.shape[1] // self.fold

    @property
    def nlane(self) -> int:
        return self.shape[0] * self.fold

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    @property
    def n_slots(self) -> int:
        return self.n_cells * self.cap

    @property
    def cell_size(self) -> tuple:
        return tuple(L / n for L, n in zip(self.box_size, self.shape))

    @property
    def array_shape(self) -> tuple:
        return (self.shape[2], self.nyb, self.cap, self.nlane)

    @property
    def drift_threshold(self) -> float:
        """Half the true cell slack: pairs within cutoff stay inside the
        one-cell stencil as long as every particle drifted less than
        (cell - cutoff)/2."""
        slack = min(self.cell_size) - self.cutoff
        return 0.5 * max(slack, 1e-6)


# depth of the separable rebin's per-cell overflow mini-grid (ranks CAP ..
# CAP+OCAP-1), which holds the stragglers of a cell
OCAP = 8


def choose_spec(
    box_size,
    n: int,
    cutoff: float,
    skin: float = 1.2,
    max_lanes: int = 128,
    cap: int | None = None,
    pos=None,
    n_strag: int = 0,
    strag_cell_excess: int = 6,
    strag_headroom: float = 3.0,
    ocap: int | None = OCAP,
    nz_multiple: int = 1,
) -> GridSpec:
    """Pick (nx, ny, nz), fold F and CAP for a target box/density.

    The same search as the JAX package (so both build identical grids):
    cells >= cutoff*skin on each axis, (nx, ny, F) minimizing the cost model
    nz * nyb * CAP_est^2 with a penalty for NLANE != max_lanes, and CAP from
    a Poisson margin or, given ``pos``, from the measured occupancy. With
    a straggler list, ``strag_cell_excess`` (at most ``ocap``, the depth
    of the separable rebin's overflow mini-grid; None: unchecked, as the
    PSE near grid, whose rebin latches a deeper cell) bounds the stragglers
    per cell and ``strag_headroom`` the list's fill. ``nz_multiple`` floors
    nz to a multiple of it (a z-slab mesh of that many shards then divides
    the grid; larger cells stay stencil-correct) and raises below 3.
    """
    if n_strag > 0 and ocap is not None and strag_cell_excess > ocap:
        raise ValueError(f"strag_cell_excess {strag_cell_excess} exceeds the separable "
                         f"rebin's {ocap}-deep overflow mini-grid")
    Ls = [float(s) for s in np.broadcast_to(np.asarray(box_size, float), (3,))]
    rl = cutoff * skin
    nx_nat = max(3, int(Ls[0] / rl))
    nz = max(3, int(Ls[2] / rl))
    ny_nat = max(3, int(Ls[1] / rl))
    if nz_multiple > 1:
        nz = (nz // nz_multiple) * nz_multiple
        if nz < 3:
            raise ValueError(f"box z ({Ls[2]}) too small for nz multiple {nz_multiple} "
                             f"at cutoff*skin {rl}")
    best = None
    for nx in range(3, nx_nat + 1):
        for F in range(1, max(1, max_lanes // nx) + 1):
            ny = (ny_nat // F) * F
            if ny < 3 or ny // F < 3:
                continue
            lam = n / float(nx * ny * nz)
            cap_est = int(math.ceil(
                (lam + 4.0 * math.sqrt(lam) + 2.0) / 8.0)) * 8
            cost = nz * (ny // F) * cap_est * cap_est
            # the JAX package's lane-alignment penalty; kept so both
            # packages pick the same geometry
            if nx * F != max_lanes:
                cost = cost * 1.85
            key_ = (cost, -(nx * F))
            if best is None or key_ < best[0]:
                best = (key_, nx, ny, F)
    _, nx, ny, F = best
    if cap is None:
        lam = (
            n / (Ls[0] * Ls[1] * Ls[2])
            * (Ls[0] / nx) * (Ls[1] / ny) * (Ls[2] / nz)
        )
        cap = int(math.ceil((lam + 4.0 * math.sqrt(lam) + 2.0) / 8.0)) * 8
        if pos is not None:
            # the measured occupancy (with a fluctuation margin) replaces
            # the Poisson estimate
            p = np.asarray(pos)
            idx = [
                np.clip(
                    ((p[:, d] / Ls[d] + 0.5) % 1.0 * nd).astype(np.int64),
                    0, nd - 1,
                )
                for d, nd in enumerate((nx, ny, nz))
            ]
            flat = (idx[2] * ny + idx[1]) * nx + idx[0]
            counts = np.bincount(flat, minlength=nx * ny * nz)
            occ = int(counts.max())
            cap = (occ + max(2, occ // 8) + 7) // 8 * 8
            if n_strag > 0:
                # the smallest CAP whose excess fits the side list with
                # ``strag_headroom`` headroom and at most ``strag_cell_excess``
                # stragglers per cell (6 fits the separable rebin's OCAP = 8
                # overflow mini-grid)
                for c in range(8, cap + 1, 8):
                    excess = np.maximum(counts - c, 0)
                    if (excess.sum() * strag_headroom <= n_strag
                            and excess.max() <= strag_cell_excess):
                        cap = c
                        break
    return GridSpec(
        box_size=tuple(Ls), shape=(nx, ny, nz), cap=cap, fold=F,
        cutoff=float(cutoff), skin=float(skin), n_strag=int(n_strag),
    )


@dataclasses.dataclass
class GridState:
    """Grid-resident MD state. All grid tensors are [nz, nyb, CAP, NLANE].

    ``gen`` is the ``torch.Generator`` that draws the v1 engine's Langevin
    noise (it advances in place). The straggler fields ``spos``/``svel``/
    ``sforce`` ([S, 3]) and ``spid`` ([S]) are empty unless
    ``spec.n_strag > 0``. ``fgrp`` holds the v2 engine's unfolded Newton
    reaction groups (12 grid tensors, ``kernel2.REACTION_GROUPS`` x 3
    components) while the fused update folds them in, else ``()``; the
    physical force is then fx + the shifted groups (``GridMD2.folded_forces``).
    ``fstack`` is then the Newton pair kernel's [15, nz, nyb, CAP, NLANE]
    output that fx, fy, fz and ``fgrp`` are views of, else None. Those
    four fields are the forces; ``fstack`` only saves restacking them:
    ``replace`` drops it when any of them is replaced without it, and
    ``force_stack`` hands it out only while they are still its views.
    """

    spec: GridSpec
    n: int
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    fz: torch.Tensor
    pid: torch.Tensor  # int32, -1 = empty
    ref_x: torch.Tensor  # positions at last rebin (drift check)
    ref_y: torch.Tensor
    ref_z: torch.Tensor
    gen: torch.Generator | None
    overflow: torch.Tensor  # 0-d bool, latching
    step: torch.Tensor  # 0-d int32 step counter
    spos: torch.Tensor
    svel: torch.Tensor
    sforce: torch.Tensor
    spid: torch.Tensor
    fgrp: tuple = ()
    fstack: torch.Tensor | None = None

    @property
    def mask(self) -> torch.Tensor:
        return self.pid >= 0

    @property
    def device(self) -> torch.device:
        return self.x.device

    def replace(self, **kw) -> "GridState":
        if "fstack" not in kw and not _FORCE_FIELDS.isdisjoint(kw):
            kw["fstack"] = None  # the buffer no longer holds the forces
        return dataclasses.replace(self, **kw)

    def force_stack(self) -> torch.Tensor:
        """fx, fy, fz and then ``fgrp`` as one [3 + len(fgrp), nz, nyb, CAP,
        NLANE] tensor: ``fstack`` while they are its views in that order,
        else a new stack of them."""
        forces = (self.fx, self.fy, self.fz) + tuple(self.fgrp)
        f = self.fstack
        if f is not None and f.shape[0] == len(forces):
            base, stride = f.data_ptr(), f.stride(0) * f.element_size()
            if all(t.data_ptr() == base + k * stride for k, t in enumerate(forces)):
                return f
        return torch.stack(forces)


_FORCE_FIELDS = frozenset(("fx", "fy", "fz", "fgrp"))


def recip32(L: float) -> float:
    """The float32 reciprocal of a box length, as a Python float.

    XLA rewrites division by a constant into a multiply by the constant's
    float32 reciprocal, so the JAX package computes ``p / L`` as
    ``p * recip32(L)``; the port (plain versions and CUDA kernels alike)
    does the same so that cell assignment and wrapping agree bit for bit."""
    return float(np.float32(1.0) / np.float32(L))


def wrap(p: torch.Tensor, L: float) -> torch.Tensor:
    """Into the primary box [-L/2, L/2]: ``p - L*round(p/L)``, with
    round-half-to-even as ``jnp.round`` and CUDA's ``rintf``."""
    return p - L * torch.round(p * recip32(L))


def _cell_key(spec: GridSpec, x, y, z, valid) -> torch.Tensor:
    """Memory-order cell key of positions: ((cz*nyb + yb)*NLANE + lane).

    Matches the flat order of [nz, nyb, NLANE]; invalid entries get key
    n_cells (sorts last)."""
    nx, ny, nz = spec.shape
    F = spec.fold

    def cell_of(p, L, ncell):
        frac = p * recip32(L) + 0.5
        frac = frac - torch.floor(frac)
        return torch.clamp((frac * ncell).to(torch.int64), 0, ncell - 1)

    cx = cell_of(x, spec.box_size[0], nx)
    cy = cell_of(y, spec.box_size[1], ny)
    cz = cell_of(z, spec.box_size[2], nz)
    yb = cy // F
    f = cy - yb * F
    lane = cx * F + f
    key = (cz * spec.nyb + yb) * spec.nlane + lane
    return torch.where(valid, key, torch.full_like(key, spec.n_cells))


def _fill_value(col: torch.Tensor, fill):
    if fill is None:
        return -1 if not col.dtype.is_floating_point else EMPTY_POS
    return fill


def _bin_columns(spec: GridSpec, key, cols, fills):
    """Place entries with cell ``key`` into the padded grid.

    Entries of one cell keep their input order (stable sort) and take the
    slots 0, 1, ...; ranks >= CAP become stragglers (the first ``S`` of
    them, in sorted order) or overflow. ``fills`` gives the empty-slot value
    per column (None: -1 for ints, EMPTY_POS for floats). Returns
    (binned_cols [nz, nyb, CAP, NLANE], strag_cols [S], overflow 0-d bool).
    """
    nz_, nyb, cap, nlane = spec.array_shape
    T = spec.n_slots
    S = spec.n_strag
    ncell = nz_ * nyb * nlane
    m = key.shape[0]

    key_s, order = torch.sort(key, stable=True)
    first = torch.searchsorted(key_s, key_s, right=False)
    rank = torch.arange(m, device=key.device) - first
    real = key_s < ncell
    kept = real & (rank < cap)
    is_strag = real & (rank >= cap)
    n_over = is_strag.sum()
    # memory order of a slot is [cell, rank]; to_grid swaps to [rank, lane]
    slot = (key_s * cap + rank)[kept]

    def to_grid(c, fill):
        g = torch.full((T,), _fill_value(c, fill), dtype=c.dtype, device=c.device)
        g[slot] = c[order][kept]
        return g.reshape(nz_, nyb, nlane, cap).transpose(2, 3).contiguous()

    def to_strag(c, fill):
        if not c.dtype.is_floating_point:
            f = -1
        else:
            f = 0.0 if fill == 0.0 else EMPTY_POS
        s = torch.full((S,), f, dtype=c.dtype, device=c.device)
        rows = c[order][is_strag][:S]
        s[: rows.shape[0]] = rows
        return s

    binned = tuple(to_grid(c, f) for c, f in zip(cols, fills))
    strag = tuple(to_strag(c, f) for c, f in zip(cols, fills))
    overflow = n_over > S
    return binned, strag, overflow


_FILLS = (None, None, None, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, None)


def _state(spec, n, binned, strag, overflow, gen, step):
    gx, gy, gz, gvx, gvy, gvz, gfx, gfy, gfz, gpid = binned
    return GridState(
        spec=spec, n=n,
        x=gx, y=gy, z=gz, vx=gvx, vy=gvy, vz=gvz, fx=gfx, fy=gfy, fz=gfz,
        pid=gpid, ref_x=gx, ref_y=gy, ref_z=gz,
        gen=gen, overflow=overflow, step=step,
        spos=torch.stack(strag[0:3], dim=-1),
        svel=torch.stack(strag[3:6], dim=-1),
        sforce=torch.stack(strag[6:9], dim=-1),
        spid=strag[9],
    )


def pack(
    spec: GridSpec,
    pos,  # [N, 3]
    vel=None,
    force=None,
    gen: torch.Generator | None = None,
    pid=None,
    device=None,
) -> GridState:
    """Build a GridState on ``device`` (default: the GPU) from canonical
    [N]-order arrays (numpy or tensors)."""
    dev = resolve_device(device)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    n = pos.shape[0]
    Ls = spec.box_size
    x, y, z = (wrap(pos[:, d], Ls[d]) for d in range(3))
    zeros = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    vel = zeros if vel is None else torch.as_tensor(vel, dtype=torch.float32, device=dev)
    force = zeros if force is None else torch.as_tensor(force, dtype=torch.float32, device=dev)
    pid = (torch.arange(n, dtype=torch.int32, device=dev) if pid is None
           else torch.as_tensor(pid, dtype=torch.int32, device=dev))
    ck = _cell_key(spec, x, y, z, torch.ones((n,), dtype=torch.bool, device=dev))
    cols = (x, y, z, vel[:, 0], vel[:, 1], vel[:, 2],
            force[:, 0], force[:, 1], force[:, 2], pid)
    binned, strag, ovf = _bin_columns(spec, ck, cols, fills=_FILLS)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    return _state(spec, n, binned, strag, ovf, gen, step)


def rebin(gs: GridState) -> GridState:
    """Re-sort all slots (plus the straggler side list, when enabled) into
    their current cells; the reference that the rebin kernel is held to."""
    spec = gs.spec
    Ls = spec.box_size
    valid = gs.pid >= 0
    empty = torch.full_like(gs.x, EMPTY_POS)
    x, y, z = (torch.where(valid, wrap(p, Ls[d]), empty)
               for d, p in enumerate((gs.x, gs.y, gs.z)))
    keys = _cell_key(spec, x, y, z, valid).reshape(-1)
    cols = [a.reshape(-1) for a in (x, y, z, gs.vx, gs.vy, gs.vz,
                                    gs.fx, gs.fy, gs.fz, gs.pid)]
    if spec.n_strag > 0:
        sv = gs.spid >= 0
        sp = [
            torch.where(sv, wrap(gs.spos[:, d], Ls[d]),
                        torch.full_like(gs.spos[:, d], EMPTY_POS))
            for d in range(3)
        ]
        keys = torch.cat([keys, _cell_key(spec, sp[0], sp[1], sp[2], sv)])
        extra = sp + [gs.svel[:, d] for d in range(3)] + [
            gs.sforce[:, d] for d in range(3)] + [gs.spid]
        cols = [torch.cat([c, e.to(c.dtype)]) for c, e in zip(cols, extra)]
    binned, strag, ovf = _bin_columns(spec, keys, tuple(cols), fills=_FILLS)
    return _state(spec, gs.n, binned, strag, gs.overflow | ovf, gs.gen, gs.step)


def needs_rebin(gs: GridState) -> torch.Tensor:
    """Half-skin drift criterion on the squared Euclidean drift (reference:
    VerletListBase.cuh:56-70). A 0-d bool tensor on the state's device."""
    thr2 = float(np.float32(gs.spec.drift_threshold ** 2))
    d2 = (gs.x - gs.ref_x) ** 2 + (gs.y - gs.ref_y) ** 2 + (gs.z - gs.ref_z) ** 2
    d2 = torch.where(gs.mask, d2, torch.zeros_like(d2))
    return d2.max() > thr2


def maybe_rebin(gs: GridState) -> GridState:
    """Sort rebin when the drift check fires (one host sync per call)."""
    return rebin(gs) if bool(needs_rebin(gs)) else gs


def unpack(gs: GridState):
    """Back to canonical [N]-order (pos, vel, force), including the
    straggler side list when enabled. Off the hot path."""
    valid = gs.pid >= 0
    pid = torch.where(valid, gs.pid, torch.full_like(gs.pid, gs.n)).reshape(-1)
    cols = [a.reshape(-1) for a in (gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz,
                                    gs.fx, gs.fy, gs.fz)]
    if gs.spec.n_strag > 0:
        spid = torch.where(gs.spid >= 0, gs.spid, torch.full_like(gs.spid, gs.n))
        pid = torch.cat([pid, spid])
        extra = [gs.spos[:, d] for d in range(3)] + [
            gs.svel[:, d] for d in range(3)] + [gs.sforce[:, d] for d in range(3)]
        cols = [torch.cat([c, e]) for c, e in zip(cols, extra)]
    order = torch.sort(pid, stable=True).indices[: gs.n]
    s = [c[order] for c in cols]
    return (torch.stack(s[0:3], dim=-1), torch.stack(s[3:6], dim=-1),
            torch.stack(s[6:9], dim=-1))


@dataclasses.dataclass
class ChannelGrid:
    """Cell-resident positions plus payload channels, without integrator
    state: the layout of the grid-resident solvers (the PSE near field).

    All grid tensors are [nz, nyb, CAP, NLANE]; ``channels`` is a tuple of
    them (zero on empty slots). With ``spec.n_strag > 0`` the straggler
    side list is ``spos`` [S, 3] (EMPTY_POS on empties), ``schannels`` (a
    tuple of [S], zero on empties) and ``spid`` [S] int32 (-1 = empty)."""

    spec: GridSpec
    n: int
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    channels: tuple
    pid: torch.Tensor  # int32, -1 = empty
    overflow: torch.Tensor  # 0-d bool
    spos: torch.Tensor
    schannels: tuple
    spid: torch.Tensor

    @property
    def mask(self) -> torch.Tensor:
        return self.pid >= 0

    @property
    def smask(self) -> torch.Tensor:
        return self.spid >= 0

    def replace(self, **kw) -> "ChannelGrid":
        return dataclasses.replace(self, **kw)


def pack_channels(spec: GridSpec, pos, channels, device=None) -> ChannelGrid:
    """Bin [N, 3] positions plus an [N, C] channel payload into the grid,
    slot for slot as the JAX package's ``pack_channels``. Channel empties
    are 0, so payload-linear kernels see exact zeros from empty slots; with
    ``spec.n_strag > 0`` the occupancy tail past CAP lands in the
    straggler list. Tensors stay on their device; numpy input goes to
    ``device`` (default: the GPU)."""
    dev = pos.device if torch.is_tensor(pos) else resolve_device(device)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    n = pos.shape[0]
    channels = torch.as_tensor(channels, dtype=torch.float32, device=dev)
    if channels.dim() == 1:
        channels = channels[:, None]
    C = channels.shape[1]
    Ls = spec.box_size
    x, y, z = (wrap(pos[:, d], Ls[d]) for d in range(3))
    pid = torch.arange(n, dtype=torch.int32, device=dev)
    ck = _cell_key(spec, x, y, z, torch.ones((n,), dtype=torch.bool, device=dev))
    cols = (x, y, z) + tuple(channels[:, c] for c in range(C)) + (pid,)
    fills = (None, None, None) + (0.0,) * C + (None,)
    binned, strag, ovf = _bin_columns(spec, ck, cols, fills)
    return ChannelGrid(
        spec=spec, n=n, x=binned[0], y=binned[1], z=binned[2],
        channels=tuple(binned[3:3 + C]), pid=binned[3 + C], overflow=ovf,
        spos=torch.stack(strag[0:3], dim=-1), schannels=tuple(strag[3:3 + C]),
        spid=strag[3 + C],
    )


def unpack_values(cg: ChannelGrid, values, svalues=None) -> torch.Tensor:
    """Slot-space values (a tuple of [nz, nyb, CAP, NLANE]) -> [N, k] in
    pid order; ``svalues`` (a tuple of [S]) adds the straggler rows. JAX
    sorts by pid; every pid occurs once, so a scatter by pid is the same
    function (empty slots go to a dropped row N)."""
    n = cg.n
    idx = torch.where(cg.pid >= 0, cg.pid, n).reshape(-1).long()
    vals = torch.stack([torch.as_tensor(v).reshape(-1) for v in values], dim=-1)
    if svalues is not None and cg.spid.shape[0] > 0:
        idx = torch.cat([idx, torch.where(cg.spid >= 0, cg.spid, n).long()])
        svals = torch.stack([torch.as_tensor(s).reshape(-1) for s in svalues], dim=-1)
        vals = torch.cat([vals, svals.to(vals.dtype)])
    out = torch.zeros((n + 1, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    out.index_put_((idx,), vals)
    return out[:n]


def channel_grid_from_numpy(spec: GridSpec, fields: dict, device=None) -> ChannelGrid:
    """A ChannelGrid on ``device`` from numpy arrays, e.g. a JAX
    ChannelGrid's fields (``x, y, z, channels, pid, overflow, spos,
    schannels, spid`` and ``n``)."""
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype).contiguous()

    return ChannelGrid(
        spec=spec, n=int(fields["n"]), x=t(fields["x"]), y=t(fields["y"]), z=t(fields["z"]),
        channels=tuple(t(c) for c in fields["channels"]), pid=t(fields["pid"], torch.int32),
        overflow=t(fields["overflow"], torch.bool), spos=t(fields["spos"]),
        schannels=tuple(t(c) for c in fields["schannels"]), spid=t(fields["spid"], torch.int32),
    )


def channel_grid_to_numpy(cg: ChannelGrid) -> dict:
    """The inverse of ``channel_grid_from_numpy``."""
    out = {k: getattr(cg, k).detach().cpu().numpy()
           for k in ("x", "y", "z", "pid", "overflow", "spos", "spid")}
    out["channels"] = tuple(c.detach().cpu().numpy() for c in cg.channels)
    out["schannels"] = tuple(c.detach().cpu().numpy() for c in cg.schannels)
    out["n"] = cg.n
    return out

# Fields of GridState that hold arrays, in the JAX package's names.
STATE_FIELDS = (
    "x", "y", "z", "vx", "vy", "vz", "fx", "fy", "fz", "pid",
    "ref_x", "ref_y", "ref_z", "overflow", "step",
    "spos", "svel", "sforce", "spid",
)


def grid_state_from_numpy(spec: GridSpec, fields: dict, device=None,
                          seed: int = 0) -> GridState:
    """A GridState on ``device`` from numpy arrays, e.g. the fields of the
    JAX package's GridState (``STATE_FIELDS`` plus ``n`` and, optionally,
    ``fgrp``: a sequence of 12 grids or empty). The JAX PRNG key does not
    carry over: the new state's generator is seeded with ``seed``."""
    dev = resolve_device(device)
    arrays = {}
    for name in STATE_FIELDS:
        a = np.array(fields[name])  # a writable copy
        if name in ("pid", "spid", "step"):
            dtype = torch.int32
        elif name == "overflow":
            dtype = torch.bool
        else:
            dtype = torch.float32
        arrays[name] = torch.from_numpy(a).to(device=dev, dtype=dtype).contiguous()
    fgrp = tuple(torch.from_numpy(np.array(a)).to(device=dev, dtype=torch.float32)
                 .contiguous() for a in fields.get("fgrp", ()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return GridState(spec=spec, n=int(fields["n"]), gen=gen, fgrp=fgrp, **arrays)


def grid_state_to_numpy(gs: GridState) -> dict:
    """The array fields of ``gs`` (``STATE_FIELDS``) as numpy arrays, plus
    ``n`` and ``fgrp`` (a tuple of numpy grids); the inverse of
    ``grid_state_from_numpy``."""
    out = {name: getattr(gs, name).detach().cpu().numpy() for name in STATE_FIELDS}
    out["n"] = gs.n
    out["fgrp"] = tuple(a.detach().cpu().numpy() for a in gs.fgrp)
    return out


def stencil_sources(spec: GridSpec, dz: int, dy: int, dx: int, device, *,
                    periodic_z: bool = True, z_rows: int | None = None):
    """Index tensors of the (dz, dy, dx) neighbor cell of every home cell.

    Returns ``(zi [nz,1,1,1], ybi [1,nyb,1,NLANE], lane [1,nyb,1,NLANE],
    shifts)``, so that ``a[zi, ybi, rows, lane]`` gathers the neighbor
    cell's slots into home-cell order (``rows`` [1,1,CAP,1]), and
    ``shifts`` = (sx, sy, sz) are the periodic image offsets to add to the
    gathered positions: nonzero only where that axis index wrapped, each
    broadcastable to [nz, nyb, 1, NLANE]. Used by the plain versions of the
    pair-force and rebin kernels.

    ``periodic_z=False`` is the z-slab halo mode: no z image shift (the
    caller's ghost rows carry it), and the z index wraps modulo ``z_rows``
    (default nz; the Newton kernel's halo mode passes nz + 1, so that the
    top row's dz = +1 neighbour is row nz of a ghost-extended array).
    """
    nx, ny, nz = spec.shape
    F = spec.fold
    Lx, Ly, Lz = spec.box_size
    lane = torch.arange(spec.nlane, device=device)
    cx = lane // F
    f = lane - cx * F
    cy = torch.arange(spec.nyb, device=device)[:, None] * F + f[None, :]
    cz = torch.arange(nz, device=device)
    sx, sy, sz = cx + dx, cy + dy, cz + dz

    def image(s, n, L):
        return torch.where(s < 0, -L, torch.where(s >= n, L, 0.0)).to(torch.float32)

    shx = image(sx, nx, Lx)[None, None, None, :]
    shy = image(sy, ny, Ly)[None, :, None, :]
    if periodic_z:
        shz = image(sz, nz, Lz)[:, None, None, None]
        sz = sz % nz
    else:
        shz = torch.zeros((nz, 1, 1, 1), dtype=torch.float32, device=device)
        sz = sz % (nz if z_rows is None else z_rows)
    sx, sy = sx % nx, sy % ny
    syb = sy // F
    src_lane = sx[None, :] * F + (sy - syb * F)  # [nyb, nlane]
    return (sz[:, None, None, None], syb[None, :, None, :],
            src_lane[None, :, None, :], (shx, shy, shz))
