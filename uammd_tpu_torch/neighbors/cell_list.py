"""Cell list: sort-based spatial binning into a dense table.

Port of ``uammd_tpu/neighbors/cell_list.py`` (reference:
src/Interactor/NeighbourList/CellList/CellListBase.cuh:30-230): an
``[n_cells, capacity]`` int32 table of particle indices with the sentinel
N in empty slots, filled from one stable argsort of the particles' flat
cells. Overflow (a cell holding more than ``capacity`` particles) sets a
flag instead of raising (CellListBase.cuh:82-85); the overflowing
particles are left out of the table. Nothing here reads the device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.box import Box
from ..core.grid import Grid, grid_from_cutoff
from ..device import device_vector


@dataclasses.dataclass
class CellList:
    """Binned particles. ``cell_grid[c, k]`` = index of the k-th particle of
    cell c, or ``n_particles`` (sentinel) if the slot is empty."""

    grid: Grid
    cell_grid: torch.Tensor  # [n_cells, capacity] int32
    cell_count: torch.Tensor  # [n_cells] int32
    particle_cell: torch.Tensor  # [N] int32 flat cell index of each particle
    overflow: torch.Tensor  # bool scalar: some cell exceeded capacity

    @property
    def capacity(self) -> int:
        return self.cell_grid.shape[1]

    @property
    def n_particles(self) -> int:
        return self.particle_cell.shape[0]


def build_cell_list(pos: torch.Tensor, grid: Grid, capacity: int) -> CellList:
    """Bin particles into the grid: a particle's rank in its cell is its
    place in a stable sort by cell, so each cell lists its particles in
    index order (as the JAX package's argsort + searchsorted ranks do)."""
    n = pos.shape[0]
    dev = pos.device
    ci = grid.cell_index(grid.cell_of(pos)).to(torch.int32)  # [N]
    order = torch.argsort(ci, stable=True)
    ci_sorted = ci[order].long()
    # counts by scatter (bincount would read its maximum on the host)
    count = torch.zeros(grid.n_cells, dtype=torch.int64, device=dev)
    count.scatter_add_(0, ci_sorted, torch.ones_like(ci_sorted))
    first = torch.cumsum(count, 0) - count  # a cell's first sorted position
    rank = torch.arange(n, device=dev) - first[ci_sorted]
    overflow = (rank >= capacity).any()
    # overflowing particles go to a dump slot past the table, then dropped
    size = grid.n_cells * capacity
    slot = torch.where(rank < capacity, ci_sorted * capacity + rank, size)
    table = torch.full((size + 1,), n, dtype=torch.int32, device=dev)
    table.scatter_(0, slot, order.to(torch.int32))
    return CellList(grid=grid, cell_grid=table[:size].reshape(grid.n_cells, capacity),
                    cell_count=count.to(torch.int32), particle_cell=ci, overflow=overflow)


def stencil_offsets(radius: int = 1, device=None) -> torch.Tensor:
    """[(2r+1)^3, 3] integer offsets of the neighbour-cell stencil, z
    fastest (``meshgrid(..., indexing="ij")``)."""
    ax = torch.arange(-radius, radius + 1, dtype=torch.int32, device=device)
    ox, oy, oz = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], dim=-1)


def neighbor_cell_indices(grid: Grid, cells: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Flat indices of the (2r+1)^3 cells around cell coords [..., 3].

    Periodic axes wrap; on aperiodic axes out-of-range cells are clamped
    onto the edge cell (their occupants are distance-masked downstream)."""
    dev = cells.device
    nbr = cells[..., None, :] + stencil_offsets(radius, dev)  # [..., S, 3]
    n = device_vector(grid.shape, torch.int32, dev)
    periodic = device_vector(grid.box.periodic, torch.bool, dev)
    wrapped = torch.remainder(nbr, n)
    clamped = torch.minimum(torch.clamp(nbr, min=0), n - 1)
    return grid.cell_index(torch.where(periodic, wrapped, clamped))  # [..., S]


def make_grid(box: Box, cutoff: float, min_cells: int = 3) -> Grid:
    return Grid(box=box, shape=grid_from_cutoff(box, cutoff, min_cells))
