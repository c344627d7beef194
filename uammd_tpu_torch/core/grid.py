"""Regular grids over a periodic box, and FFT-friendly grid sizes.

Port of ``uammd_tpu/core/grid.py`` (reference: src/utils/Grid.cuh:21-142):
the cell-index math of ``Grid`` for binning, ``grid_from_cutoff``, and
``next_fft_size`` (nextFFTWiseSize3D). Grid dimensions are Python ints;
``grid_from_cutoff`` reads the box's host lengths, never the device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device import device_vector
from .box import Box


@dataclasses.dataclass
class Grid:
    box: Box
    shape: tuple  # (nx, ny, nz)

    @property
    def n_cells(self) -> int:
        return int(self.shape[0] * self.shape[1] * self.shape[2])

    @property
    def cell_size(self) -> torch.Tensor:
        return self.box.size / device_vector(self.shape, self.box.size.dtype,
                                             self.box.size.device)

    def _n(self, device) -> torch.Tensor:
        return device_vector(self.shape, torch.int32, device)

    def cell_of(self, pos: torch.Tensor) -> torch.Tensor:
        """Integer cell coordinates [..., 3] (int32) of positions (box
        centred at 0): floor(frac * n) of the fractional coordinates,
        clipped to [0, n - 1] against frac rounding to 1."""
        n = self._n(pos.device)
        frac = self.box.to_fractional(pos)
        cell = torch.floor(frac * n.to(frac.dtype)).to(torch.int32)
        return torch.minimum(torch.clamp(cell, min=0), n - 1)

    def cell_index(self, cell: torch.Tensor) -> torch.Tensor:
        """Flat index with x fastest (reference Grid.cuh:106 getCellIndex)."""
        nx, ny, _ = self.shape
        return cell[..., 0] + nx * (cell[..., 1] + ny * cell[..., 2])

    def cell_coords(self, flat: torch.Tensor) -> torch.Tensor:
        """Inverse of ``cell_index`` (x fastest): flat [...] -> coords [..., 3]."""
        nx, ny, _ = self.shape
        x = flat % nx
        y = (flat // nx) % ny
        z = flat // (nx * ny)
        return torch.stack([x, y, z], dim=-1).to(torch.int32)

    def wrap_cell(self, cell: torch.Tensor) -> torch.Tensor:
        return torch.remainder(cell, self._n(cell.device))

    def cell_centers(self, dtype=None) -> torch.Tensor:
        """[nx, ny, nz, 3] coordinates of cell centres."""
        dtype = dtype or self.box.size.dtype
        dev = self.box.size.device
        axes = [(torch.arange(n, dtype=dtype, device=dev) + 0.5) / n - 0.5 for n in self.shape]
        fx, fy, fz = torch.meshgrid(*axes, indexing="ij")
        return torch.stack([fx, fy, fz], dim=-1) * self.box.size.to(dtype)


def next_fft_size(n: int, prefer_pow2: bool = False, tile_safe_support: int | None = None,
                  pencil_safe: bool = False) -> int:
    """Smallest m >= n with only factors {2, 3, 5, 7}.

    ``prefer_pow2`` returns the next power of two instead.
    ``tile_safe_support`` also requires the size to suit the tiled
    spread/interpolate path for that kernel support (m % 8 == 0 or
    m % 8 >= ceil(support / 2); a multiple of 4 for supports <= 8), and
    ``pencil_safe`` requires m % 8 == 0 (the pencil path)."""
    def tile_ok(m):
        if pencil_safe and m % 8 != 0:
            return False
        if tile_safe_support is None:
            return True
        half = (tile_safe_support + 1) // 2
        if half <= 4:
            return m % 4 == 0
        w = m % 8
        return w == 0 or w >= half

    if prefer_pow2:
        return 1 << max(0, (n - 1)).bit_length()
    m = max(1, n)
    while True:
        k = m
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        if k == 1 and tile_ok(m):
            return m
        m += 1


def grid_from_cutoff(box: Box, cutoff: float, min_cells: int = 3) -> tuple:
    """Cell counts so that each cell edge >= cutoff (for 27-stencil search)."""
    return tuple(max(min_cells, int(math.floor(s / cutoff))) for s in box.lengths)
