"""Tiled spread / interpolate: the auto dispatch's middle path.

Port of ``uammd_tpu/solvers/tiled_ibm.py`` (reference: src/misc/IBM.cuh;
the same function as ``solvers/ibm.py``'s spread and interpolation). The
JAX package built it for the TPU, where scatters are slow; it has no
Pallas kernel, so here it is plain PyTorch:

1. particles are binned into tile^3-node grid tiles by the two-sort filler
   algorithm (``_bin_by_tile``): each tile holds ``cap`` slots, empty ones
   at a far sentinel position with zero values; a particle past ``cap``
   sets ``overflow``, which the callers turn into NaN (``ibm._poison``);
2. the spread: each tile pulls the sources of its 27-tile neighbourhood
   (rolls over the tile axes), weighs them separably against its tile
   nodes, relative to the tile's centre with the source min-imaged once,
   and sums its tile^3 patch with one batched contraction, in chunks of
   tiles;
3. the interpolation is the adjoint: per each of the 27 offsets, the
   particles' separable weights against one rolled copy of the tiled
   field, then the results un-binned by particle id.

A particle's stencil may not reach past the neighbouring tile:
ceil(support / 2) <= tile, and a partial trailing tile at least that wide
(``tile_shape_ok``).
"""

from __future__ import annotations

import math

import torch

from ..core.box import Box
from ..device import device_vector

TILE = 8  # the largest tile (kernels up to support 16)
EMPTY = 1.0e9


def _tile_counts(shape, tile):
    return tuple((s + tile - 1) // tile for s in shape)


def pick_tile(shape, support) -> int:
    """The smallest legal tile for (shape, support): 4 when the half
    support fits and the shape allows it, else 8."""
    for t in (4, 8):
        if (support + 1) // 2 <= t and tile_shape_ok(shape, support, t):
            return t
    return TILE


def tile_shape_ok(shape, support, tile=TILE) -> bool:
    """True iff the 27-tile neighbourhood reaches every wrap image: the
    half support fits a tile, a partial trailing tile (w = n % tile nodes)
    is either absent or at least ceil(support / 2) wide on every axis, and
    every axis has at least 3 tiles."""
    half = (support + 1) // 2
    if half > tile:
        return False
    for s in shape:
        w = s % tile
        if w != 0 and w < half:
            return False
    return min(_tile_counts(shape, tile)) >= 3


def _default_cap(n, shape, tile):
    """Slots a tile: mean occupancy + 6 sigma Poisson + 8 (the structured
    starts' margin of ``pencil_ibm.default_cap``)."""
    lam = n * tile ** 3 / float(shape[0] * shape[1] * shape[2])
    return max(4, int(math.ceil(lam + 6.0 * math.sqrt(lam))) + 8)


def _bin_by_tile(pos, values, shape, box: Box, cap: int, tile, *, with_pid=False):
    """-> (sources [ntiles, cap, 3 + C] (xyz, then values), tile-major,
    [pids [ntiles, cap] int32, 1-based, 0 = empty, with ``with_pid``,]
    overflow). One stable sort of particle keys 2 t and filler keys
    2 t + 1 (``cap`` fillers a tile) ranks each particle in its tile; slot
    t cap + rank for rank < cap, written by one scatter with a dump slot
    (the JAX package's second sort places the same rows)."""
    nt = _tile_counts(shape, tile)
    ntiles = nt[0] * nt[1] * nt[2]
    n = pos.shape[0]
    dev = pos.device
    frac = pos / box.size.to(pos.dtype) + 0.5
    frac = frac - torch.floor(frac)
    u = frac * device_vector(shape, pos.dtype, dev)
    tidx = [torch.clamp((u[:, d] / tile).to(torch.int64), max=nt[d] - 1) for d in range(3)]
    key = (tidx[0] * nt[1] + tidx[1]) * nt[2] + tidx[2]
    filler = torch.arange(ntiles, device=dev).repeat_interleave(cap)
    s_key, order = torch.sort(torch.cat([key * 2, filler * 2 + 1]), stable=True)
    cols = torch.cat([pos, values], dim=1)
    fill = torch.zeros((ntiles * cap, cols.shape[1]), dtype=cols.dtype, device=dev)
    fill[:, :3] = EMPTY
    s_cols = torch.cat([cols, fill])[order]
    cell = s_key >> 1
    m = n + ntiles * cap
    rank = torch.arange(m, device=dev) - torch.searchsorted(cell, cell, right=False)
    kept = rank < cap
    overflow = torch.any(((s_key & 1) == 0) & ~kept)
    T = ntiles * cap
    slot = torch.where(kept, cell * cap + rank, T)
    out = torch.empty((T + 1, cols.shape[1]), dtype=cols.dtype, device=dev)
    out[slot] = s_cols
    out = out[:T].reshape(ntiles, cap, -1)
    if not with_pid:
        return out, overflow
    pid = torch.cat([torch.arange(1, n + 1, dtype=torch.int32, device=dev),
                     torch.zeros(T, dtype=torch.int32, device=dev)])
    pids = torch.empty(T + 1, dtype=torch.int32, device=dev)
    pids[slot] = pid[order]
    return out, pids[:T].reshape(ntiles, cap), overflow


def _tile_centers(shape, Ls, dtype, tile, device):
    """The physical centre of each tile along each axis, [nt_d] tensors.
    Kernel displacements are taken from the tile centre with the source
    min-imaged once per (tile, source): wrapping per node would alias a
    tile's ghost nodes onto real nodes."""
    return [(torch.arange(_tile_counts(shape, tile)[d], dtype=dtype, device=device) * tile
             + tile / 2.0) * (Ls[d] / shape[d]) - Ls[d] / 2.0 for d in range(3)]


def _local_offsets(dtype, tile, device):
    """Node offsets from the tile centre, in units of h."""
    return torch.arange(tile, dtype=dtype, device=device) - (tile - 1) / 2.0


def _wrap1(dx, L):
    return dx - L * torch.round(dx / L)


def _gather_neighborhood(bins, nt):
    """bins [ntiles, cap, C] -> [ntiles, 27 cap, C] by rolls over the tile axes."""
    b = bins.reshape(*nt, *bins.shape[1:])
    parts = [torch.roll(b, (dx, dy, dz), dims=(0, 1, 2))
             for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    return torch.cat(parts, dim=3).reshape(nt[0] * nt[1] * nt[2], -1, bins.shape[-1])


def _check_tile(shape, support, tile, what):
    if (support + 1) // 2 > tile:
        raise ValueError(f"the kernel's half support ({support}) must fit one tile ({tile})")
    if not tile_shape_ok(shape, support, tile):
        raise ValueError(
            f"grid shape {tuple(shape)} has a partial trailing tile narrower than the "
            f"kernel half support (support {support}, tile {tile}): wrap contributions "
            f"would be dropped; use ibm.{what}")


def _tile_coords(ntiles, nt, device):
    t = torch.arange(ntiles, device=device)
    return t // (nt[1] * nt[2]), (t // nt[2]) % nt[1], t % nt[2]


def spread_tiled(kernel, pos, values, shape, box: Box, *, cap=None, chunk=1024, tile=None):
    """S: values [N] or [N, C] -> (field [nx, ny, nz(, C)], overflow), the
    semantics of ``ibm.spread`` (the 1/dV density factor)."""
    shape = tuple(shape)
    tile = pick_tile(shape, kernel.support) if tile is None else tile
    _check_tile(shape, kernel.support, tile, "spread")
    squeeze = values.ndim == 1
    if squeeze:
        values = values[:, None]
    C = values.shape[1]
    nt = _tile_counts(shape, tile)
    ntiles = nt[0] * nt[1] * nt[2]
    cap = _default_cap(pos.shape[0], shape, tile) if cap is None else cap
    dtype, dev = values.dtype, values.device
    Ls = box.lengths
    h = [Ls[d] / shape[d] for d in range(3)]
    bins, overflow = _bin_by_tile(pos, values, shape, box, cap, tile)
    src = _gather_neighborhood(bins, nt)  # [ntiles, 27 cap, 3 + C]
    centers = _tile_centers(shape, Ls, dtype, tile, dev)
    loc = _local_offsets(dtype, tile, dev)
    tcoord = _tile_coords(ntiles, nt, dev)
    S = src.shape[1]
    patches = []
    for lo in range(0, ntiles, chunk):
        s_c = src[lo:lo + chunk]
        w = [kernel.phi(loc - (_wrap1(s_c[:, :, d] - centers[d][tcoord[d][lo:lo + chunk]][:, None],
                                      Ls[d]) / h[d])[:, :, None]) for d in range(3)]
        wxy = (w[0][:, :, :, None] * w[1][:, :, None, :]).reshape(-1, S, tile * tile)
        b = (w[2][:, :, :, None] * s_c[:, :, None, 3:]).reshape(-1, S, tile * C)
        patches.append(torch.einsum("tsk,tsm->tkm", wxy, b))  # [Ct, t*t, t*C]
    field = torch.cat(patches).reshape(*nt, tile, tile, tile, C)
    field = field.permute(0, 3, 1, 4, 2, 5, 6).reshape(nt[0] * tile, nt[1] * tile,
                                                       nt[2] * tile, C)
    # every real node belongs to one tile, which pulls every source in reach,
    # so the tile padding is dropped, not folded back
    field = field[:shape[0], :shape[1], :shape[2]] * (1.0 / (h[0] * h[1] * h[2]))
    return (field[..., 0] if squeeze else field), overflow


def _pad_field_tiles(field, shape, tile):
    """Zero-pad the field to whole tiles. The ghost nodes are zero, not
    periodic copies: each real node is read through its own tile's block
    only."""
    nt = _tile_counts(shape, tile)
    out = field.new_zeros((nt[0] * tile, nt[1] * tile, nt[2] * tile, field.shape[-1]))
    out[:shape[0], :shape[1], :shape[2]] = field
    return out


def interpolate_tiled(kernel, pos, field, box: Box, *, cap=None, chunk=512, tile=None):
    """J = S*: field [nx, ny, nz(, C)] -> (values [N(, C)], overflow), the
    adjoint of ``spread_tiled``."""
    squeeze = field.ndim == 3
    if squeeze:
        field = field[..., None]
    C = field.shape[-1]
    shape = tuple(field.shape[:3])
    tile = pick_tile(shape, kernel.support) if tile is None else tile
    _check_tile(shape, kernel.support, tile, "interpolate")
    nt = _tile_counts(shape, tile)
    ntiles = nt[0] * nt[1] * nt[2]
    n = pos.shape[0]
    cap = _default_cap(n, shape, tile) if cap is None else cap
    dtype, dev = field.dtype, field.device
    Ls = box.lengths
    h = [Ls[d] / shape[d] for d in range(3)]
    bins, pid_bins, overflow = _bin_by_tile(pos, pos.new_zeros((n, 0)), shape, box, cap, tile,
                                            with_pid=True)
    ft = _pad_field_tiles(field, shape, tile).reshape(
        nt[0], tile, nt[1], tile, nt[2], tile, C).permute(0, 2, 4, 1, 3, 5, 6)
    centers = _tile_centers(shape, Ls, dtype, tile, dev)
    loc = _local_offsets(dtype, tile, dev)
    tcoord = _tile_coords(ntiles, nt, dev)

    def weights(lo, d, off):
        """[Ct, cap, tile] weights of the chunk's particles against the
        nodes of tile t + off along axis d."""
        cb = centers[d][(tcoord[d][lo:lo + chunk] + off) % nt[d]]
        r = _wrap1(bins[lo:lo + chunk, :, d] - cb[:, None], Ls[d]) / h[d]
        return kernel.phi(loc - r[:, :, None])

    outs = torch.zeros((ntiles, cap, C), dtype=dtype, device=dev)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                w_roll = torch.roll(ft, (-dx, -dy, -dz), dims=(0, 1, 2)).reshape(
                    ntiles, tile, tile, tile, C)
                for lo in range(0, ntiles, chunk):
                    t1 = torch.einsum("tpz,txyzc->tpxyc", weights(lo, 2, dz),
                                      w_roll[lo:lo + chunk])
                    t2 = torch.einsum("tpy,tpxyc->tpxc", weights(lo, 1, dy), t1)
                    outs[lo:lo + chunk] += torch.einsum("tpx,tpxc->tpc", weights(lo, 0, dx), t2)
    # un-bin: a stable sort by particle id (empty slots, id 0, first)
    order = torch.argsort(pid_bins.reshape(-1), stable=True)
    result = outs.reshape(-1, C)[order][-n:]
    return (result[:, 0] if squeeze else result), overflow
