"""Pair-interaction combinator: the Transverser executor.

Port of ``uammd_tpu/neighbors/pair_map.py`` (reference:
src/utils/TransverserUtils.cuh:34-200, src/Interactor/PairForces.cu:43-68,
NBody.cuh:29). A pair kernel is a function

    pair_kernel(r2, dr, info_i, info_j, (i, j)) -> dict of per-pair values

summed over a fixed-capacity neighbour list (``apply_pairs``) or over all
pairs (``apply_pairs_dense``, the NBody path, in row chunks). ``info`` is
None, a tensor of per-particle values or a tuple, list or dict of them,
gathered for i and j; ``dr`` is the minimum-image r_j - r_i.
"""

from __future__ import annotations

import torch

from ..core.box import Box
from .neighbor_list import NeighborList


def _map(f, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    return type(tree)(_map(f, v) for v in tree)


def _mask(tree, mask):
    def f(x):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))

    return _map(f, tree)


def apply_pairs(pair_kernel, nlist: NeighborList, pos: torch.Tensor, info=None, *,
                box: Box | None = None):
    """Sum ``pair_kernel`` over each particle's list entries: per-particle
    sums with leading dim N."""
    box = nlist.box if box is None else box
    n = pos.shape[0]
    j = nlist.idx  # [N, K]
    jm = torch.clamp(j, max=n - 1).long()
    dr = box.wrap(pos[jm] - pos[:, None, :])  # [N, K, 3]
    r2 = torch.sum(dr * dr, dim=-1)
    info_i = _map(lambda a: a[:, None, ...], info)
    info_j = _map(lambda a: a[jm], info)
    i_idx = torch.arange(n, dtype=torch.int32, device=pos.device)[:, None]
    out = _mask(pair_kernel(r2, dr, info_i, info_j, (i_idx, j)), j < n)
    return _map(lambda x: torch.sum(x, dim=1), out)


def apply_pairs_dense(pair_kernel, pos: torch.Tensor, box: Box, info=None, *,
                      include_self: bool = False, chunk: int = 4096):
    """All pairs, O(N^2) (reference NBody.cuh:29), over row chunks of
    ``chunk``."""
    n = pos.shape[0]
    j_idx = torch.arange(n, dtype=torch.int32, device=pos.device)
    parts = []
    for lo in range(0, n, chunk):
        rows = j_idx[lo:lo + chunk]
        dr = box.wrap(pos[None, :, :] - pos[rows][:, None, :])  # [C, N, 3]
        r2 = torch.sum(dr * dr, dim=-1)
        info_i = _map(lambda a: a[rows][:, None, ...], info)
        info_j = _map(lambda a: a[None, ...], info)
        out = pair_kernel(r2, dr, info_i, info_j, (rows[:, None], j_idx[None, :]))
        if not include_self:
            out = _mask(out, rows[:, None] != j_idx[None, :])
        parts.append(_map(lambda x: torch.sum(x, dim=1), out))
    first = parts[0]
    if isinstance(first, dict):
        return {k: torch.cat([p[k] for p in parts]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    return type(first)(torch.cat(list(v)) for v in zip(*parts))
