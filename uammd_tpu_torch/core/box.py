"""Periodic simulation box.

Port of ``uammd_tpu/core/box.py`` (reference: src/utils/Box.cuh:16-60): an
orthorhombic box with a per-axis periodicity mask. ``size`` is a [3]
tensor on the box's device; ``lengths`` keeps the same lengths as Python
floats, taken once when the box is made, so code that needs them on the
host (grid sizes, kernel arguments) never reads the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .types import default_real


@dataclasses.dataclass
class Box:
    size: torch.Tensor  # [3] box lengths
    periodic: tuple = (True, True, True)
    lengths: tuple = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.lengths is None:
            self.lengths = tuple(float(s) for s in self.size.detach().cpu().tolist())

    @property
    def volume(self):
        return torch.prod(self.size)

    def _mask_size(self, x):
        # made once per (dtype, device): a copy to the card per call would
        # wait for it
        key = (x.dtype, x.device)
        cache = self.__dict__.setdefault("_masks", {})
        if key not in cache:
            cache[key] = (torch.tensor(self.periodic, dtype=x.dtype, device=x.device),
                          self.size.to(x.dtype))
        return cache[key]

    def wrap(self, dr: torch.Tensor) -> torch.Tensor:
        """Minimum-image displacement (reference: Box.cuh apply_pbc)."""
        mask, size = self._mask_size(dr)
        return dr - size * mask * torch.round(dr / size)

    def wrap_position(self, pos: torch.Tensor) -> torch.Tensor:
        """Fold positions into [-L/2, L/2) on periodic axes."""
        mask, size = self._mask_size(pos)
        return pos - size * mask * torch.round(pos / size)

    def to_fractional(self, pos: torch.Tensor) -> torch.Tensor:
        """Map positions to [0, 1) fractional coordinates."""
        frac = pos / self.size.to(pos.dtype) + 0.5
        return frac - torch.floor(frac)


def box(size, periodic=(True, True, True), dtype=None, device=None) -> Box:
    """A box of lengths ``size`` (a scalar gives a cube) on ``device``
    (default the GPU, see ``resolve_device``)."""
    dtype = dtype or default_real
    dev = resolve_device(device)
    s = np.atleast_1d(np.asarray(size, dtype=np.float64))
    if s.shape == (1,):
        s = np.full((3,), s[0])
    t = torch.tensor(s, dtype=dtype, device=dev)
    return Box(size=t, periodic=tuple(bool(p) for p in periodic),
               lengths=tuple(float(x) for x in t.cpu().tolist()))
