"""Initial conditions: Bravais lattice generators (pure numpy).

Same sites as ``uammd_tpu/utils/lattices.py:lattice`` (reference:
src/utils/InitialConditions.cuh:17): the box spans [-L/2, L/2) and surplus
sites are dropped by the same seeded permutation, so both packages start
from identical positions.
"""

from __future__ import annotations

import math

import numpy as np

_BASES = {
    "sc": np.array([[0.0, 0.0, 0.0]]),
    "bcc": np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]),
    "fcc": np.array(
        [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]
    ),
    "dia": np.array(
        [
            [0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5],
            [0.25, 0.25, 0.25], [0.75, 0.75, 0.25],
            [0.75, 0.25, 0.75], [0.25, 0.75, 0.75],
        ]
    ),
}


def lattice(n: int, box_size, kind: str = "fcc", dim: int = 3) -> np.ndarray:
    """Positions [n, 3] on the requested lattice inside the box.

    2D kinds: "sq" (square), "tri" (triangular) place particles in z=0.
    """
    L = np.broadcast_to(np.asarray(box_size, dtype=np.float64), (3,)).copy()
    if kind in ("sq", "tri") or dim == 2:
        return _lattice_2d(n, L, kind if kind in ("sq", "tri") else "sq")
    basis = _BASES[kind]
    per_cell = len(basis)
    cells = int(math.ceil((n / per_cell) ** (1.0 / 3.0)))
    while cells**3 * per_cell < n:
        cells += 1
    ix = np.arange(cells)
    gx, gy, gz = np.meshgrid(ix, ix, ix, indexing="ij")
    corners = np.stack([gx, gy, gz], axis=-1).reshape(-1, 1, 3)
    sites = (corners + basis[None, :, :]).reshape(-1, 3) / cells  # in [0,1)
    if len(sites) > n:
        # drop surplus sites uniformly (deterministic) so the occupied
        # fraction stays homogeneous instead of truncating one corner
        keep = np.random.default_rng(1234).permutation(len(sites))[:n]
        sites = sites[np.sort(keep)]
    return (sites - 0.5) * L


def _lattice_2d(n: int, L, kind: str) -> np.ndarray:
    cells = int(math.ceil(math.sqrt(n)))
    ix = np.arange(cells)
    gx, gy = np.meshgrid(ix, ix, indexing="ij")
    x = gx.astype(np.float64)
    y = gy.astype(np.float64)
    if kind == "tri":
        x = x + 0.5 * (gy % 2)
    pts = np.stack([x / cells, y / cells, np.zeros_like(x)], axis=-1).reshape(-1, 3)
    pts = pts[:n]
    out = (pts - np.array([0.5, 0.5, 0.0])) * L
    out[:, 2] = 0.0
    return out
