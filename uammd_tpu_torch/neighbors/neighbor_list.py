"""Verlet neighbour list: a fixed-capacity [N, K] index table with a skin.

Port of ``uammd_tpu/neighbors/neighbor_list.py`` (reference:
src/Interactor/NeighbourList/VerletList/VerletListBase.cuh:56-73,
BasicList/BasicListBase.cuh:32-41). The list holds up to ``max_neighbors``
indices per particle inside ``cutoff * skin_multiplier``, in the order of
the 27-cell stencil and of each cell's table, and is rebuilt only when some
particle has drifted more than half the skin since the last build
(checkMaximumDrift). A full table sets ``overflow``; ``ensure_capacity``
regrows it outside the step.

The sizes (grid, cell capacity, K) are chosen from host floats (the box's
``lengths``, the cutoff) and the rebuild runs on the device with no host
read, in row chunks of ``chunk`` so the [chunk, 27 x capacity] candidate
tensors stay small. ``maybe_rebuild`` reads the drift test once: the one
host read of a step that uses it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.box import Box
from ..core.grid import Grid, grid_from_cutoff
from .cell_list import build_cell_list, neighbor_cell_indices


@dataclasses.dataclass
class NeighborList:
    """idx[i, k] = index of the k-th neighbour of i, or N (sentinel) if unused."""

    idx: torch.Tensor  # [N, K] int32
    ref_pos: torch.Tensor  # [N, 3] positions at build time (drift check)
    overflow: torch.Tensor  # bool: K or cell capacity exceeded at a build
    box: Box
    cutoff: float
    skin_multiplier: float
    grid_shape: tuple
    cell_capacity: int
    chunk: int = 32768
    include_self: bool = False

    @property
    def max_neighbors(self) -> int:
        return self.idx.shape[1]

    @property
    def n(self) -> int:
        return self.idx.shape[0]

    def needs_rebuild(self, pos: torch.Tensor) -> torch.Tensor:
        """True (a 0-d tensor, not read) if some particle moved more than
        skin/2 since the build (VerletListBase.cuh:56-70)."""
        skin = (self.skin_multiplier - 1.0) * self.cutoff
        dr = self.box.wrap(pos - self.ref_pos)
        max_d2 = torch.max(torch.sum(dr * dr, dim=-1))
        return max_d2 > _as_dtype((0.5 * skin) ** 2, pos.dtype)


def _as_dtype(x: float, dtype) -> float:
    """A host float rounded to ``dtype`` (a CPU op: no device read)."""
    return float(torch.tensor(x, dtype=dtype))


def _auto_max_neighbors(n, volume, r, safety=1.25, minimum=16):
    rho = n / volume
    est = rho * (4.0 / 3.0) * math.pi * r**3 * safety + 8
    k = max(minimum, int(math.ceil(est)))
    return (k + 7) // 8 * 8


def pair_r2(box: Box, p_j: torch.Tensor, p_i: torch.Tensor) -> tuple:
    """The minimum-image displacement r_j - r_i and its square, summed in a
    fixed order ((x + y) + z) whatever the shape, so that a brute-force
    check gets the same bits as the list's build."""
    dr = box.wrap(p_j - p_i)
    d2 = dr * dr
    return dr, d2[..., 0] + d2[..., 1] + d2[..., 2]


def _rebuild(pos, box, cutoff, skin_multiplier, grid_shape, cell_capacity, max_neighbors,
             chunk, include_self) -> NeighborList:
    """Rebuild with the given sizes, on the device with no host read."""
    n = pos.shape[0]
    dev = pos.device
    K = max_neighbors
    grid = Grid(box=box, shape=grid_shape)
    rl = cutoff * skin_multiplier
    cl = build_cell_list(pos, grid, cell_capacity)
    cell_coords = grid.cell_coords(torch.arange(grid.n_cells, device=dev))
    stencil = neighbor_cell_indices(grid, cell_coords).long()  # [n_cells, 27]
    rl2 = _as_dtype(rl * rl, pos.dtype)
    pos_pad = torch.cat([pos, torch.zeros((1, 3), dtype=pos.dtype, device=dev)])
    chunk = min(chunk, n)
    idx_rows, nv_rows = [], []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = torch.arange(lo, hi, device=dev)
        cand = cl.cell_grid[stencil[cl.particle_cell[lo:hi].long()]]  # [C, 27, cap]
        cand = cand.reshape(hi - lo, -1).long()  # [C, S]
        _, r2 = pair_r2(box, pos_pad[cand], pos[lo:hi, None, :])
        valid = (cand < n) & (r2 <= rl2)
        if not include_self:
            valid &= cand != rows[:, None]
        # compact: the valid candidates first, in stencil order (the JAX
        # package's stable argsort of ~valid), by a running count
        rank = torch.cumsum(valid, dim=1) - 1
        dest = torch.where(valid & (rank < K), rank, K)
        out = torch.full((hi - lo, K + 1), n, dtype=torch.int32, device=dev)
        out.scatter_(1, dest, torch.where(valid, cand, n).to(torch.int32))
        idx_rows.append(out[:, :K])
        nv_rows.append(rank[:, -1] + 1)
    idx = torch.cat(idx_rows)
    overflow = cl.overflow | (torch.cat(nv_rows) > K).any()
    return NeighborList(idx=idx, ref_pos=pos, overflow=overflow, box=box, cutoff=cutoff,
                        skin_multiplier=skin_multiplier, grid_shape=tuple(grid_shape),
                        cell_capacity=cell_capacity, chunk=chunk, include_self=include_self)


def build_neighbor_list(pos: torch.Tensor, box: Box, cutoff: float, *,
                        skin_multiplier: float = 1.2, max_neighbors: int | None = None,
                        cell_capacity: int | None = None, chunk: int = 32768,
                        include_self: bool = False) -> NeighborList:
    """Build an [N, K] neighbour list, sizes chosen from host floats
    (reference: CellList::update + fillBasicNeighbourList with the Verlet
    skin of VerletList.cuh:83). Later rebuilds (``maybe_rebuild``) keep
    these sizes."""
    n = pos.shape[0]
    rl = cutoff * skin_multiplier
    grid_shape = grid_from_cutoff(box, rl)
    # the box volume in the box's dtype, as the JAX package's device product
    np_dtype = torch.empty((), dtype=box.size.dtype).numpy().dtype
    volume = float(np.prod(np.asarray(box.lengths, dtype=np_dtype)))
    if cell_capacity is None:
        n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]
        cell_capacity = max(4, int(math.ceil(n / n_cells * 2.0)) + 4)
    if max_neighbors is None:
        max_neighbors = _auto_max_neighbors(n, volume, rl)
    return _rebuild(pos, box, cutoff, skin_multiplier, grid_shape, cell_capacity,
                    max_neighbors, chunk, include_self)


def rebuild_neighbor_list(nlist: NeighborList, pos: torch.Tensor) -> NeighborList:
    """Unconditional rebuild with the list's sizes; ``overflow`` stays set
    once set."""
    new = _rebuild(pos, nlist.box, nlist.cutoff, nlist.skin_multiplier, nlist.grid_shape,
                   nlist.cell_capacity, nlist.max_neighbors, nlist.chunk, nlist.include_self)
    return dataclasses.replace(new, overflow=new.overflow | nlist.overflow)


def maybe_rebuild(nlist: NeighborList, pos: torch.Tensor) -> NeighborList:
    """Rebuild iff some particle drifted past half the skin (VerletList.cuh:83):
    one host read of the drift test."""
    if bool(nlist.needs_rebuild(pos)):
        return rebuild_neighbor_list(nlist, pos)
    return nlist


def ensure_capacity(nlist: NeighborList, pos: torch.Tensor) -> NeighborList:
    """Outside the step: double K and the cell capacity until no overflow
    (docs/NeighbourList.rst:244)."""
    while bool(nlist.overflow):
        nlist = _rebuild(pos, nlist.box, nlist.cutoff, nlist.skin_multiplier,
                         nlist.grid_shape, nlist.cell_capacity * 2, nlist.max_neighbors * 2,
                         nlist.chunk, nlist.include_self)
    return nlist


_STATIC = ("cutoff", "skin_multiplier", "grid_shape", "cell_capacity", "chunk", "include_self")


def neighbor_list_from_numpy(fields: dict, box: Box, device=None) -> NeighborList:
    """A NeighborList from numpy ``idx``, ``ref_pos``, ``overflow`` and the
    static sizes (as ``neighbor_list_to_numpy`` gives them, or as read off
    the JAX package's list), on ``device`` (default: the box's)."""
    dev = box.size.device if device is None else device
    return NeighborList(
        idx=torch.tensor(np.asarray(fields["idx"], dtype=np.int32), device=dev),
        ref_pos=torch.tensor(np.asarray(fields["ref_pos"]), device=dev),
        overflow=torch.as_tensor(bool(fields["overflow"]), device=dev), box=box,
        **{k: (tuple(int(v) for v in fields[k]) if k == "grid_shape" else fields[k])
           for k in _STATIC})


def neighbor_list_to_numpy(nlist: NeighborList) -> dict:
    """The list's tensors as numpy arrays and its static sizes."""
    return {"idx": nlist.idx.cpu().numpy(), "ref_pos": nlist.ref_pos.cpu().numpy(),
            "overflow": bool(nlist.overflow), **{k: getattr(nlist, k) for k in _STATIC}}
