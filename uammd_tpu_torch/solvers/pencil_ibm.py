"""Pencil-decomposed spread / interpolate over shared xy-pencil bins.

Port of ``uammd_tpu/solvers/pencil_ibm.py``. Particles are binned by
8 x 8 xy-pencil spanning the whole z axis (``bin_pencils``: ids only, so
one binning serves every spread and interpolation of a step). Each pencil
owns a patch of P = 8 + 2 halo nodes per axis, halo = ceil(support / 2) +
slack; a particle's x/y weights are taken over its pencil's patch and its
z weights over the whole axis. ``slack`` lets bins built at older
positions stay exact while every particle's x/y drift is below slack * h.

Two implementations of each direction:

- ``spread_pencil`` / ``interpolate_pencil``: plain PyTorch, the JAX XLA
  path's per-pencil contraction ``[P^2, cap] x [cap, nz C]`` (dense z) in
  chunks of pencils. The patches are added into the field with
  ``index_add_`` at their wrapped nodes (the XLA path's two roll-and-pad
  folds), and the interpolation gathers the same patch windows.
  ``spread_pencil_fused_plain`` / ``interpolate_pencil_fused_plain`` are
  these, as the plain versions of the two kernels below.
- ``spread_pencil_fused`` / ``interpolate_pencil_fused``: the TPU kernels
  #13 (pencil_ibm.py:450) and #14 (:572) of the JAX package. On CUDA
  tensors they launch ``engine/csrc/pencil_spread.cu`` /
  ``pencil_interp.cu`` (counted in ``SPREAD.launches`` /
  ``INTERP.launches``) or raise; on CPU tensors they run the plain
  versions. The CUDA kernels take only each particle's support window in
  z, not all nz nodes: the same function, since phi vanishes outside
  |r| < support/2.

The CUDA kernels are owner-computed: a block owns a tile, one pencil's
8 x 8 columns times tz z nodes (``pencil_launch_plan``: 32 where that
gives enough blocks and the block fits in 48 KB of shared memory, else
16), and gathers the particles of the pencils whose patch covers those
columns (``pencil_neighbours``, the 3 x 3 pencils around it, each listed
once) whose z window meets the tile, with the weights each one's own
pencil gives those nodes. The spread sums them in registers and writes
each node once (no atomics, no zeroed field, the same bits on every
call); the interpolation reads its tile once and adds each particle's
sums to its slot with one atomic per channel.

Where a NaN lands. The kernels' tile products are dense, so a weight of 0
times a NaN is NaN, as in the plain versions' dense contractions (which
spread a particle's NaN over its whole patch and every z node), but over
other nodes than those. A thread owns one x row of the tile at one z node
and a warp one x row (tz 32) or two (tz 16) at every z node of the tile.
A particle whose value in channel c is NaN (at a finite position) puts NaN
into channel c of every node of each warp's rows of each tile in which it
has a nonzero x weight on one of that warp's rows and a nonzero y weight
on some column, the nodes of zero weight in those rows included. A NaN
node of a field, in channel c, puts NaN into channel c of every particle
that the node's warp takes with such weights, whether or not its own
weight at that node is 0. Non-finite positions give no defined result:
the callers NaN-poison on a bins overflow instead (``ibm._poison``).

Fields are [nx, ny, nz, C] at every function, as in the JAX package. The
CUDA kernels store them channel first ([C, nx, ny, nz] in memory, a
permuted view at the interface): the layout in which ``torch.fft`` reads
and writes the three spatial axes of each channel without a copy. An
overflow of the bins is returned with the result; NaN-poisoning is the
caller's (``ibm._poison``). Custom z weights (the JAX package's
``z_weights``, for the doubly periodic solvers) are not ported yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..core.box import Box
from ..device import resolve_device
from ..engine import _build

PENCIL = 8
MAX_CHANNELS = 8  # the CUDA kernels keep C sums in registers

_I = ctypes.c_int
_F = ctypes.c_float
_P = ctypes.c_void_p
# uammd_pencil_spread(u, vals, pids, nbr, field, nx, ny, nz, npy, halo,
#                     support, cap, npen, C, kind, tz, a, b, scale, stream)
SPREAD = _build.Kernel("pencil_spread", "uammd_pencil_spread", [_P] * 5 + [_I] * 11 + [_F] * 3)
# uammd_pencil_interp(u, field, pids, nbr, out, nx, ny, nz, npy, halo,
#                     support, cap, npen, C, kind, tz, a, b, stream)
INTERP = _build.Kernel("pencil_interp", "uammd_pencil_interp", [_P] * 5 + [_I] * 11 + [_F] * 2)

# The launch of the two kernels (csrc/pencil_common.cuh): a block owns one
# pencil's 8 x 8 columns times tz z nodes, with 8 tz threads, and reads its
# candidate slots SCAN a thread at a time.
SCAN = 2
NBR = 9  # the neighbour pencils of a tile, -1 padded
TILE_MIN_BLOCKS = 16 * 132  # 16 blocks an SM on an H100 SXM's 132 SMs
MAX_SMEM = 48 * 1024  # bytes of shared memory a block takes without an opt-in

def _halo(support: int) -> int:
    return (support + 1) // 2


def pencil_ok(shape, support, slack: int = 0, custom_z: bool = False) -> bool:
    """Whether the pencil path takes this grid: x, y multiples of 8 and at
    least one patch wide, halo <= 8, nz >= support (unless ``custom_z``)."""
    h = _halo(support) + slack
    return (
        h <= PENCIL
        and shape[0] % PENCIL == 0
        and shape[1] % PENCIL == 0
        and shape[0] >= PENCIL + 2 * h
        and shape[1] >= PENCIL + 2 * h
        and (custom_z or shape[2] >= support)
    )


@dataclasses.dataclass
class PencilBins:
    """xy-pencil assignment of N particles: ids only, kernel-independent.

    pids: [npencils, cap] int32, 1-based particle ids, 0 = empty slot.
    slot_of_pid: [N] int32, flat slot of each particle (stale, pointing at
        pencil 0 slot 0, for particles dropped by an overflow).
    overflow: 0-d bool tensor.
    """

    pids: torch.Tensor
    slot_of_pid: torch.Tensor
    overflow: torch.Tensor


def default_cap(n, shape) -> int:
    """Pencil capacity: mean load + 6 sigma Poisson + 16, rounded up to a
    multiple of 8 (see the JAX package's note on structured starts)."""
    npen = (shape[0] // PENCIL) * (shape[1] // PENCIL)
    lam = n / npen
    cap = max(4, int(math.ceil(lam + 6.0 * math.sqrt(lam))) + 16)
    return (cap + 7) // 8 * 8


def pencil_of(pos, shape, box: Box):
    """The xy-pencil index (x-pencil * npy + y-pencil) of each particle,
    int64 [N]; ``torch.bincount`` of it gives the pencils' loads."""
    npx, npy = shape[0] // PENCIL, shape[1] // PENCIL
    L = box.size.to(pos.dtype)
    frac = pos[:, :2] / L[:2] + 0.5
    frac = frac - torch.floor(frac)
    ix = torch.clamp((frac[:, 0] * npx).to(torch.int64), max=npx - 1)
    iy = torch.clamp((frac[:, 1] * npy).to(torch.int64), max=npy - 1)
    return ix * npy + iy


def bin_pencils(pos, shape, box: Box, *, cap=None) -> PencilBins:
    """Assign particles to xy-pencils with the two-sort filler algorithm:
    every pencil gets ``cap`` filler entries that sort after its
    particles, so rank < cap names a slot. Particles of one pencil keep
    their index order (stable sort), slot for slot as in the JAX package."""
    npen = (shape[0] // PENCIL) * (shape[1] // PENCIL)
    n = pos.shape[0]
    dev = pos.device
    if cap is None:
        cap = default_cap(n, shape)
    key = pencil_of(pos, shape, box)
    filler = torch.arange(npen, device=dev).repeat_interleave(cap)
    key2 = torch.cat([key * 2, filler * 2 + 1])
    pid = torch.cat([torch.arange(1, n + 1, dtype=torch.int32, device=dev),
                     torch.zeros(npen * cap, dtype=torch.int32, device=dev)])
    s_key, order = torch.sort(key2, stable=True)
    s_pid = pid[order]
    cell = s_key >> 1
    m = n + npen * cap
    first = torch.searchsorted(cell, cell, right=False)
    rank = torch.arange(m, device=dev) - first
    kept = rank < cap
    overflow = torch.any(((s_key & 1) == 0) & ~kept)
    # scatters with a dropped dump entry instead of boolean masks, so
    # binning makes no host read
    slots = npen * cap
    pids = torch.zeros(slots + 1, dtype=torch.int32, device=dev)
    pids[torch.where(kept, cell * cap + rank, slots)] = s_pid
    pids = pids[:slots]
    slot_of_pid = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    slot_of_pid[torch.where(pids > 0, pids.long() - 1, n)] = torch.arange(
        slots, dtype=torch.int32, device=dev)
    return PencilBins(pids=pids.reshape(npen, cap), slot_of_pid=slot_of_pid[:n],
                      overflow=overflow)


def pencil_bins_from_numpy(fields: dict, device=None) -> PencilBins:
    """PencilBins from numpy arrays ``pids``, ``slot_of_pid``, ``overflow``
    (for example a JAX PencilBins' fields)."""
    dev = resolve_device(device)
    return PencilBins(
        pids=torch.as_tensor(np.asarray(fields["pids"], np.int32), device=dev),
        slot_of_pid=torch.as_tensor(np.asarray(fields["slot_of_pid"], np.int32), device=dev),
        overflow=torch.as_tensor(bool(np.asarray(fields["overflow"])), device=dev))


def pencil_bins_to_numpy(bins: PencilBins) -> dict:
    return {"pids": bins.pids.cpu().numpy(), "slot_of_pid": bins.slot_of_pid.cpu().numpy(),
            "overflow": bool(bins.overflow)}


@functools.lru_cache(maxsize=None)
def _node_constants(shape, lengths, dtype, device):
    """h = L / n and n/2 - 0.5 per axis as [3] tensors on ``device``, made
    once (a copy to the card per call would wait for it)."""
    n = torch.tensor(shape, dtype=dtype)
    h = torch.tensor(lengths, dtype=dtype) / n
    return h.to(device), (0.5 * n - 0.5).to(device)


def _node_coords(pos, shape, box: Box):
    """Node-space coordinate u = pos / h + n/2 - 0.5: node g sits at
    (g + 0.5) h - L/2."""
    h, off = _node_constants(tuple(shape), box.lengths, pos.dtype, pos.device)
    return pos / h + off


def _wrap_nodes(d, n):
    return d - n * torch.round(d / n)


def _axis_weights(kernel, u_ax, origin, width, n_ax):
    """phi at patch nodes origin + j (j < width) against coords u_ax [..., 1]."""
    j = torch.arange(width, dtype=u_ax.dtype, device=u_ax.device)
    return kernel.phi(_wrap_nodes(origin + j - u_ax, float(n_ax)))


def _geometry(shape, support, slack, device):
    """P, the pencil origins ox, oy [npen] and the flat xy node index
    (x * ny + y) of every patch node of every pencil [npen, P * P]."""
    halo = _halo(support) + slack
    P = PENCIL + 2 * halo
    npy = shape[1] // PENCIL
    npen = (shape[0] // PENCIL) * npy
    pen = torch.arange(npen, device=device)
    ox = (pen // npy) * PENCIL - halo
    oy = (pen % npy) * PENCIL - halo
    j = torch.arange(P, device=device)
    gx = torch.remainder(ox[:, None] + j[None, :], shape[0])
    gy = torch.remainder(oy[:, None] + j[None, :], shape[1])
    nodes = (gx[:, :, None] * shape[1] + gy[:, None, :]).reshape(npen, P * P)
    return P, ox, oy, nodes


def _pencil_weights(kernel, pu, ox, oy, P, shape):
    """wxy [c, cap, P^2] over the patches and dense wz [c, cap, nz]."""
    dt = pu.dtype
    wx = _axis_weights(kernel, pu[:, :, 0:1], ox[:, None, None].to(dt), P, shape[0])
    wy = _axis_weights(kernel, pu[:, :, 1:2], oy[:, None, None].to(dt), P, shape[1])
    wz = _axis_weights(kernel, pu[:, :, 2:3], 0.0, shape[2], shape[2])
    wxy = (wx[:, :, :, None] * wy[:, :, None, :]).reshape(pu.shape[0], pu.shape[1], P * P)
    return wxy, wz


def _inv_dv(box: Box, shape, density_scale):
    if density_scale is not None:
        return float(density_scale)
    return float(np.prod([n / L for n, L in zip(shape, box.lengths)]))


def spread_pencil(kernel, pos, values, shape, box: Box, bins: PencilBins, *,
                  chunk=64, slack=0, density_scale=None):
    """S: values [N] or [N, C] -> field [nx, ny, nz(, C)] over shared bins.
    Returns (field, overflow); same 1/dV density as ``ibm.spread``
    (``density_scale`` overrides it)."""
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    C = values.shape[1]
    shape = tuple(shape)
    assert pencil_ok(shape, kernel.support, slack), (
        f"shape {shape} unsuitable for the pencil path with support "
        f"{kernel.support} + slack {slack}: use spread_auto")
    P, ox, oy, nodes = _geometry(shape, kernel.support, slack, pos.device)
    npen, nz = nodes.shape[0], shape[2]
    u = _node_coords(pos, shape, box).to(values.dtype)
    src = torch.clamp(bins.pids.long() - 1, min=0)
    pu = u[src]                                                   # [npen, cap, 3]
    pv = torch.where((bins.pids > 0)[..., None], values[src], 0)  # [npen, cap, C]
    field = torch.zeros((shape[0] * shape[1], nz * C), dtype=values.dtype,
                        device=values.device)
    for s in range(0, npen, chunk):
        sl = slice(s, s + chunk)
        wxy, wz = _pencil_weights(kernel, pu[sl], ox[sl], oy[sl], P, shape)
        q = (wz[:, :, :, None] * pv[sl, :, None, :]).reshape(wz.shape[0], -1, nz * C)
        patch = torch.bmm(wxy.transpose(1, 2), q)                 # [c, P^2, nz C]
        field.index_add_(0, nodes[sl].reshape(-1), patch.reshape(-1, nz * C))
    field = field.reshape(shape + (C,)) * _inv_dv(box, shape, density_scale)
    return (field[..., 0] if squeeze else field), bins.overflow


def interpolate_pencil(kernel, pos, field, box: Box, bins: PencilBins, *, chunk=64, slack=0):
    """J = S*: field [nx, ny, nz(, C)] -> [N(, C)] over shared bins; returns
    (values, overflow). Particles dropped by an overflow read a stale slot."""
    squeeze = field.ndim == 3
    if squeeze:
        field = field[..., None]
    C = field.shape[-1]
    shape = tuple(field.shape[:3])
    assert pencil_ok(shape, kernel.support, slack), (
        f"shape {shape} unsuitable for the pencil path with support "
        f"{kernel.support} + slack {slack}: use interpolate_auto")
    P, ox, oy, nodes = _geometry(shape, kernel.support, slack, pos.device)
    npen, nz = nodes.shape[0], shape[2]
    u = _node_coords(pos, shape, box).to(field.dtype)
    pu = u[torch.clamp(bins.pids.long() - 1, min=0)]
    flat = field.reshape(shape[0] * shape[1], nz * C)
    v = []
    for s in range(0, npen, chunk):
        sl = slice(s, s + chunk)
        wxy, wz = _pencil_weights(kernel, pu[sl], ox[sl], oy[sl], P, shape)
        a = torch.bmm(wxy, flat[nodes[sl]])                       # [c, cap, nz C]
        a = a.reshape(a.shape[0], a.shape[1], nz, C)
        v.append(torch.einsum("scz,sczk->sck", wz, a))
    out = torch.cat(v).reshape(-1, C)[bins.slot_of_pid.long()]
    return (out[:, 0] if squeeze else out), bins.overflow


def spread_pencil_fused_plain(kernel, pos, values, shape, box: Box, bins: PencilBins, *,
                              slack=0, density_scale=None):
    """Plain version of kernel #13: ``spread_pencil``."""
    return spread_pencil(kernel, pos, values, shape, box, bins, slack=slack,
                         density_scale=density_scale)


def interpolate_pencil_fused_plain(kernel, pos, field, box: Box, bins: PencilBins, *, slack=0):
    """Plain version of kernel #14: ``interpolate_pencil``."""
    return interpolate_pencil(kernel, pos, field, box, bins, slack=slack)


@dataclasses.dataclass(frozen=True)
class PencilPlan:
    """One launch of kernel #13 or #14: ``tz`` z nodes a tile, ``chunk``
    candidates a block takes at a time, the grid (z tiles, pencils), the
    threads of a block (8 tz: one a z node and x row of the tile) and its
    dynamic shared memory in bytes."""

    tz: int
    chunk: int
    grid: tuple
    threads: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def as_dict(self) -> dict:
        return {"tz": self.tz, "chunk": self.chunk, "grid": list(self.grid),
                "blocks": self.blocks, "threads": self.threads, "smem_bytes": self.smem}


def pencil_smem_bytes(C: int, tz: int, chunk: int, interp: bool) -> int:
    """A block's dynamic shared memory (``smem_bytes`` in
    csrc/pencil_common.cuh): 32 header ints, a ring of chunk + SCAN x 8 tz
    candidates (16 bytes each), 8 + 8 + tz weights, the 64 products of the
    x- and y-weights and a flag a chunk entry, and C floats an entry (the
    spread's values) or an entry and warp (the interpolation's partial
    sums)."""
    threads = 8 * tz
    return (4 * 32 + 16 * (chunk + SCAN * threads) + 4 * chunk * (16 + 64 + tz + 1)
            + 4 * chunk * C * (threads // 32 if interp else 1))


def chunk_of(tz: int) -> int:
    """The candidates a block takes at a time (``chunk_of`` in
    csrc/pencil_common.cuh): 64 with 32-node tiles, 32 with 16-node ones,
    whose smaller blocks need the smaller shared memory to fill an SM."""
    return 64 if tz == 32 else 32


def pencil_launch_plan(shape, support, slack, C, cap, *, interp=False) -> PencilPlan:
    """The launch of kernel #13 (or #14 with ``interp``) on grid ``shape``
    with ``C`` channels and bins of ``cap`` slots a pencil: tiles of 32 z
    nodes when that gives at least ``TILE_MIN_BLOCKS`` blocks (each tile
    then scans the 9 x cap slots of its neighbour pencils for fewer
    outputs) and the block fits in ``MAX_SMEM`` (not the interpolation's
    at C above 5), else of 16; ``chunk_of(tz)`` candidates at a time.
    Raises ``ValueError`` for a grid off the pencil path or C above 8."""
    shape = tuple(shape)
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"the CUDA pencil kernels take 1 to {MAX_CHANNELS} channels, got {C}")
    if not pencil_ok(shape, support, slack):
        raise ValueError(f"shape {shape} unsuitable for the pencil path with support "
                         f"{support} + slack {slack}")
    if not 0 < cap * NBR < 2 ** 30:
        raise ValueError(f"pencil capacity {cap} out of range")
    npen = (shape[0] // PENCIL) * (shape[1] // PENCIL)
    nz = shape[2]
    tz = 32 if (npen * -(-nz // 32) >= TILE_MIN_BLOCKS
                and pencil_smem_bytes(C, 32, chunk_of(32), interp) <= MAX_SMEM) else 16
    chunk = chunk_of(tz)
    return PencilPlan(tz, chunk, (-(-nz // tz), npen), 8 * tz,
                      pencil_smem_bytes(C, tz, chunk, interp))


def pencil_neighbours_table(npx: int, npy: int) -> np.ndarray:
    """[npx * npy, 9] int32: for each pencil, the pencils whose patch (8 +
    2 halo nodes a side, 1 <= halo <= 8) covers one of its columns, each
    once (on a grid 2 pencils wide p - 1 and p + 1 are one pencil), in
    ascending order and padded with -1."""
    out = np.full((npx * npy, NBR), -1, np.int32)
    for px in range(npx):
        for py in range(npy):
            q = sorted({((px + dx) % npx) * npy + (py + dy) % npy
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)})
            out[px * npy + py, :len(q)] = q
    return out


@functools.lru_cache(maxsize=None)
def pencil_neighbours(shape_xy, device) -> torch.Tensor:
    """``pencil_neighbours_table`` for the grid's x and y sizes, on
    ``device``, made once per shape."""
    npx, npy = shape_xy[0] // PENCIL, shape_xy[1] // PENCIL
    return torch.as_tensor(pencil_neighbours_table(npx, npy), device=device)


def _kernel_args(kernel, shape, bins: PencilBins, slack, C, plan: PencilPlan):
    """The integer and phi arguments shared by both CUDA kernels."""
    _build.check_cuda_tensor(bins.pids, "bins.pids", dtype=torch.int32)
    npen, cap = bins.pids.shape
    npy = shape[1] // PENCIL
    if npen != (shape[0] // PENCIL) * npy:
        raise ValueError(f"bins have {npen} pencils, the grid {tuple(shape)} needs "
                         f"{(shape[0] // PENCIL) * npy}")
    kind, a, b = kernel.device_phi
    ints = (shape[0], shape[1], shape[2], npy, _halo(kernel.support) + slack,
            kernel.support, cap, npen, C, kind, plan.tz)
    return ints, (a, b)


def spread_launch(kernel, u, vals, shape, bins: PencilBins, slack, scale):
    """Launch kernel #13 on node coordinates ``u`` [N, 3] and values
    [N, C] (CUDA, float32, contiguous); returns the field [C, nx, ny, nz]
    (made with ``torch.empty``: the kernel writes every node)."""
    C = vals.shape[1]
    plan = pencil_launch_plan(shape, kernel.support, slack, C, bins.pids.shape[1])
    field = torch.empty((C,) + tuple(shape), dtype=torch.float32, device=u.device)
    ints, ab = _kernel_args(kernel, shape, bins, slack, C, plan)
    P = _build.ptr
    SPREAD(P(u), P(vals), P(bins.pids), P(pencil_neighbours(tuple(shape[:2]), u.device)),
           P(field), *ints, *ab, scale)
    return field


def interp_launch(kernel, u, f, bins: PencilBins, slack):
    """Launch kernel #14 on node coordinates ``u`` [N, 3] and a channel-first
    field ``f`` [C, nx, ny, nz] (CUDA, float32, contiguous); returns the
    slots' values [npen * cap, C] (0 in empty slots)."""
    C, shape = f.shape[0], tuple(f.shape[1:])
    npen, cap = bins.pids.shape
    plan = pencil_launch_plan(shape, kernel.support, slack, C, cap, interp=True)
    ints, ab = _kernel_args(kernel, shape, bins, slack, C, plan)
    slots = torch.zeros((npen * cap, C), dtype=torch.float32, device=u.device)
    P = _build.ptr
    INTERP(P(u), P(f), P(bins.pids), P(pencil_neighbours(shape[:2], u.device)), P(slots),
           *ints, *ab)
    return slots


def spread_pencil_fused(kernel, pos, values, shape, box: Box, bins: PencilBins, *,
                        slack=0, density_scale=None):
    """Kernel #13: values [N(, C)] -> field [nx, ny, nz(, C)] with the 1/dV
    density (or ``density_scale``); returns (field, overflow). CUDA
    tensors launch ``csrc/pencil_spread.cu``; CPU tensors run
    ``spread_pencil_fused_plain``."""
    shape = tuple(shape)
    if pos.device.type == "cpu":
        return spread_pencil_fused_plain(kernel, pos, values, shape, box, bins, slack=slack,
                                         density_scale=density_scale)
    squeeze = values.ndim == 1
    vals = (values[:, None] if squeeze else values).contiguous()
    n, C = vals.shape
    _build.check_cuda_tensor(vals, "values", (pos.shape[0], C))
    _build.check_cuda_tensor(pos, "pos", (n, 3))
    u = _node_coords(pos, shape, box).contiguous()
    field = spread_launch(kernel, u, vals, shape, bins, slack, _inv_dv(box, shape, density_scale))
    return (field[0] if squeeze else field.permute(1, 2, 3, 0)), bins.overflow


def interpolate_pencil_fused(kernel, pos, field, box: Box, bins: PencilBins, *, slack=0):
    """Kernel #14: field [nx, ny, nz(, C)] -> [N(, C)]; returns (values,
    overflow). CUDA tensors launch ``csrc/pencil_interp.cu`` (one value
    per pencil slot, then gathered by ``slot_of_pid``; empty slots hold
    0); CPU tensors run ``interpolate_pencil_fused_plain``."""
    if pos.device.type == "cpu":
        return interpolate_pencil_fused_plain(kernel, pos, field, box, bins, slack=slack)
    squeeze = field.ndim == 3
    f = field[..., None] if squeeze else field
    shape, C = tuple(f.shape[:3]), f.shape[3]
    f = f.permute(3, 0, 1, 2).contiguous()  # no copy for a channel-first field
    _build.check_cuda_tensor(f, "field", (C,) + shape)
    _build.check_cuda_tensor(pos, "pos", (pos.shape[0], 3))
    u = _node_coords(pos, shape, box).contiguous()
    out = interp_launch(kernel, u, f, bins, slack)[bins.slot_of_pid.long()]
    return (out[:, 0] if squeeze else out), bins.overflow
