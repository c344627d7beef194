"""Lanczos Krylov solver for sqrt(M) @ v with a matrix-free M.

Port of ``uammd_tpu/solvers/lanczos.py`` (reference:
src/misc/LanczosAlgorithm.cuh:32-56): B v = sqrt(M) v for a symmetric
positive-(semi)definite operator given only ``mv(x) -> M x``, as m steps of
Lanczos tridiagonalisation with full reorthogonalisation, then
B v ~ |v| V sqrt(T) e1. Plain PyTorch (the JAX package needed no Pallas
here); the fixed-count loop is a Python loop.

sqrt(T) e1 of the small tridiagonal T is taken without a host read: a
``torch.linalg.eigh`` on a CUDA tensor checks its error flag on the host,
which waits for the card. ``_sqrt_e1`` runs the coupled Newton-Schulz
iteration (Higham, Functions of Matrices, (6.35)) in float64 on T scaled by
its Gershgorin bound, a fixed ``NS_ITERS`` times: the same square root as
JAX's eigendecomposition to float64 round-off for condition numbers up to
~1e8, and an eigenvalue of exactly 0 stays 0 (JAX clamps negative ones to
0; Lanczos on a positive operator gives none).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

# Newton-Schulz steps: an eigenvalue lambda of the scaled T converges in
# about log(1 / lambda) / log(2.25) + 6 steps
NS_ITERS = 30


def _tridiag(alphas, betas, m: int, dtype=torch.float64):
    a = alphas[:m].to(dtype)
    b = betas[1:m].to(dtype)
    return torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)


def _sqrt_e1(alphas, betas, m: int):
    """sqrt(T) e1 (float64) for T = tridiag(alphas[:m], betas[1:m])."""
    T = _tridiag(alphas, betas, m)
    s = T.abs().sum(dim=1).max()
    s = torch.where(s > 0, s, torch.ones_like(s))
    eye = torch.eye(m, dtype=T.dtype, device=T.device)
    Y, Z = T / s, eye
    for _ in range(NS_ITERS):
        H = torch.addmm(eye, Z, Y, beta=1.5, alpha=-0.5)
        Y, Z = Y @ H, H @ Z
    return torch.sqrt(s) * Y[:, 0]


def _lanczos_step(mv, V, alphas, betas, i: int, w=None):
    """Iteration i in place on (V, alphas, betas); ``w`` = M V[i] if given."""
    if w is None:
        w = mv(V[i])
    if i > 0:
        w = w - betas[i] * V[i - 1]
    a = torch.dot(V[i], w)
    w = w - a * V[i]
    # full reorthogonalisation against V[0..i] (cheap at small m,
    # stabilises float32)
    w = w - (V[: i + 1] @ w) @ V[: i + 1]
    b = torch.linalg.vector_norm(w)
    V[i + 1] = w / torch.where(b > 1e-30, b, torch.ones_like(b))
    alphas[i] = a
    betas[i + 1] = b


def _start(v, m: int):
    vnorm = torch.linalg.vector_norm(v)
    safe = torch.where(vnorm > 0, vnorm, torch.ones_like(vnorm))
    V = torch.zeros((m + 1, v.shape[0]), dtype=v.dtype, device=v.device)
    V[0] = v / safe
    alphas = torch.zeros((m,), dtype=v.dtype, device=v.device)
    betas = torch.zeros((m + 1,), dtype=v.dtype, device=v.device)  # betas[0] unused
    return vnorm, safe, V, alphas, betas


def lanczos_sqrt_apply(mv, v: torch.Tensor, m: int = 32, w0=None):
    """Return (sqrt(M) v approximation, residual estimate).

    ``mv``: x -> M x on flat vectors; ``v``: [K]. ``w0`` optionally gives
    the first matvec M v (of the unnormalised v): iteration 0 then skips
    its ``mv`` call, so a caller can batch M v with another matvec (the PSE
    near field fuses M F with the first noise matvec)."""
    vnorm, safe, V, alphas, betas = _start(v, m)
    first = 0
    if w0 is not None:
        _lanczos_step(mv, V, alphas, betas, 0, w=w0 / safe)  # M v0 = M v / |v|
        first = 1
    for i in range(first, m):
        _lanczos_step(mv, V, alphas, betas, i)
    sq = _sqrt_e1(alphas, betas, m).to(v.dtype)
    result = vnorm * (sq @ V[:m])
    # residual estimate: the weight of the last Krylov direction
    res = torch.abs(vnorm * sq[-1]) / safe
    return result, res


def make_sqrt_m_dot(mv, m: int = 32):
    return partial(lanczos_sqrt_apply, mv, m=m)


def lanczos_tridiag(mv, v: torch.Tensor, m: int):
    """One m-step Lanczos pass returning (vnorm, alphas[m], betas[m+1]).
    With full reorthogonalisation V is orthonormal, so the host can judge
    every intermediate iteration count from the tridiagonal alone
    (``lanczos_iterations_for_tolerance``)."""
    vnorm, _, V, alphas, betas = _start(v, m)
    for i in range(m):
        _lanczos_step(mv, V, alphas, betas, i)
    return vnorm, alphas, betas


def lanczos_iterations_for_tolerance(alphas, betas, tol: float, m_min: int = 3) -> int:
    """Smallest j with ||B_j v - B_{j-1} v|| / ||B_j v|| < tol, from a
    recorded tridiagonal (host numpy; the j x j eigh is negligible) — the
    reference's a-posteriori loop (LanczosAlgorithm.cuh:40-56)."""
    alphas = np.asarray(alphas, np.float64)
    betas = np.asarray(betas, np.float64)
    m = alphas.shape[0]

    def sq_e1(j):
        T = np.diag(alphas[:j]) + np.diag(betas[1:j], 1) + np.diag(betas[1:j], -1)
        evals, evecs = np.linalg.eigh(T)
        return evecs @ (np.sqrt(np.maximum(evals, 0.0)) * evecs[0, :])

    prev = None
    for j in range(1, m + 1):
        cur = sq_e1(j)
        if prev is not None and j >= m_min:
            d = np.linalg.norm(np.concatenate([prev, [0.0]]) - cur)
            if d / max(np.linalg.norm(cur), 1e-30) < tol:
                return j
        prev = cur
    return m
