"""Rotne-Prager-Yamakawa mobility and the dense backends' algebra.

Port of ``uammd_tpu/integrators/bdhi/rpy.py`` (reference:
src/Integrator/BDHI/BDHI.cuh:13-70 RotnePragerYamakawa,
BDHI_Cholesky.cuh:33-45, BDHI_Lanczos.cuh:25-40). The RPY tensor, open
boundaries, regularised for overlaps:

  r >= 2a:  M(r) = M0 3a/(4r) [ (1 + 2a^2/(3r^2)) I + (1 - 2a^2/r^2) rr^ ]
  r <  2a:  M(r) = M0 [ (1 - 9r/(32a)) I + (3r/(32a)) rr^ ]
  self:     M0 I,   M0 = 1/(6 pi eta a)

``dense_mobility`` builds the 3N x 3N matrix (the Cholesky backend);
``rpy_matvec`` applies it matrix-free in row chunks (the Lanczos backend).
Plain PyTorch, as the JAX package's is plain ``jnp``.
"""

from __future__ import annotations

import math

import torch


def _rpy_coeffs(dr, a, m0):
    """(c1, c2, rhat) with M(dr) = c1 I + c2 rhat rhat^T, and the self
    block M0 I where |dr|^2 <= 1e-24."""
    r2 = torch.sum(dr * dr, dim=-1)
    r = torch.sqrt(r2 + 1e-32)
    far = r >= 2.0 * a
    rs = torch.clamp(r, min=1e-16)
    c1f = m0 * (3.0 * a / (4.0 * rs)) * (1.0 + 2.0 * a * a / (3.0 * r2 + 1e-32))
    c2f = m0 * (3.0 * a / (4.0 * rs)) * (1.0 - 2.0 * a * a / (r2 + 1e-32))
    c1n = m0 * (1.0 - 9.0 * r / (32.0 * a))
    c2n = m0 * (3.0 / (32.0 * a)) * r
    pair = r2 > 1e-24
    c1 = torch.where(pair, torch.where(far, c1f, c1n), m0)
    c2 = torch.where(pair, torch.where(far, c2f, c2n), 0.0)
    return c1, c2, dr / rs[..., None]


def rpy_pair_blocks(dr, a, m0):
    """RPY 3 x 3 blocks [..., 3, 3] for displacements dr [..., 3]."""
    c1, c2, rhat = _rpy_coeffs(dr, a, m0)
    eye = torch.eye(3, dtype=dr.dtype, device=dr.device)
    return (c1[..., None, None] * eye
            + c2[..., None, None] * (rhat[..., :, None] * rhat[..., None, :]))


def _m0(viscosity, radius) -> float:
    return 1.0 / (6.0 * math.pi * viscosity * radius)


def dense_mobility(pos, *, viscosity=1.0, radius=1.0, box=None):
    """[3N, 3N] RPY mobility, open or minimum-image periodic (``box``)."""
    n = pos.shape[0]
    dr = pos[None, :, :] - pos[:, None, :]
    if box is not None:
        dr = box.wrap(dr)
    blocks = rpy_pair_blocks(dr, radius, _m0(viscosity, radius))  # [N, N, 3, 3]
    return blocks.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)


def rpy_matvec(pos, f, *, viscosity=1.0, radius=1.0, box=None, chunk=1024):
    """Matrix-free M f, f [N, 3], in O(N^2) over row chunks of ``chunk``
    (the NBody RPY sweep of BDHI_Lanczos.cu). The JAX package maps over
    chunks padded with rows i % N; a loop over the real rows computes the
    same rows."""
    n = pos.shape[0]
    m0 = _m0(viscosity, radius)
    out = []
    for lo in range(0, n, min(chunk, n)):
        dr = pos[None, :, :] - pos[lo:lo + chunk][:, None, :]  # [C, N, 3]
        if box is not None:
            dr = box.wrap(dr)
        c1, c2, rhat = _rpy_coeffs(dr, radius, m0)
        fdotr = torch.sum(rhat * f[None, :, :], dim=-1)
        out.append(c1 @ f + torch.sum((c2 * fdotr)[..., None] * rhat, dim=1))
    return torch.cat(out)


def cholesky_sqrt_dot(M, z):
    """B z with B B^T = M, B the lower Cholesky factor (BDHI_Cholesky.cuh
    uses cuSOLVER potrf). Raises when M is not positive definite (one host
    read of the factorisation's status)."""
    L, info = torch.linalg.cholesky_ex(M)
    if int(info) != 0:
        raise torch.linalg.LinAlgError(
            f"the mobility is not positive definite (cholesky info {int(info)})")
    return L @ z
