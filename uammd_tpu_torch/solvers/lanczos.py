"""Lanczos Krylov solver for sqrt(M) @ v with a matrix-free M.

Port of ``uammd_tpu/solvers/lanczos.py`` (reference:
src/misc/LanczosAlgorithm.cuh:32-56): B v = sqrt(M) v for a symmetric
positive-(semi)definite operator given only ``mv(x) -> M x``, as m steps of
Lanczos tridiagonalisation with full reorthogonalisation, then
B v ~ |v| V sqrt(T) e1. Plain PyTorch (the JAX package needed no Pallas
here); the fixed-count loop is a Python loop.

sqrt(T) e1 of the small tridiagonal T is taken as JAX takes it, from the
eigendecomposition with the eigenvalues clamped at 0 (an indefinite T from
float32 round-off gives finite numbers), without a host read on the card:
``torch.linalg.eigh`` on a CUDA tensor checks its error flag on the host,
which waits for the card. ``_sqrt_e1`` launches the one-block Jacobi kernel
``engine/csrc/lanczos_sqrt.cu`` (float64) on CUDA tensors and runs its
plain version, ``torch.linalg.eigh`` with the same clamp, on CPU tensors.
"""

from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch

from ..engine import _build

# uammd_lanczos_sqrt_e1(alphas, betas, out, m, stream)
LANCZOS_SQRT = _build.Kernel("lanczos_sqrt", "uammd_lanczos_sqrt_e1",
                             [ctypes.c_void_p] * 3 + [ctypes.c_int])
# the kernel keeps A and V ([m, m] float64 each) in 48 KB of shared memory
MAX_M = 48


def _tridiag(alphas, betas, m: int, dtype=torch.float64):
    a = alphas[:m].to(dtype)
    b = betas[1:m].to(dtype)
    return torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)


def sqrt_e1_plain(alphas, betas, m: int):
    """sqrt(T) e1 (float64) for T = tridiag(alphas[:m], betas[1:m]) by
    ``torch.linalg.eigh``, eigenvalues clamped at 0 (JAX's
    ``uammd_tpu/solvers/lanczos.py:74-75``)."""
    evals, evecs = torch.linalg.eigh(_tridiag(alphas, betas, m))
    return evecs @ (torch.sqrt(torch.clamp(evals, min=0.0)) * evecs[0, :])


def _sqrt_e1(alphas, betas, m: int):
    """sqrt(T) e1 (float64): the plain version on CPU tensors, the Jacobi
    kernel (counted in ``LANCZOS_SQRT.launches``) on CUDA tensors."""
    if alphas.device.type == "cpu":
        return sqrt_e1_plain(alphas, betas, m)
    if not 1 <= m <= MAX_M:
        raise ValueError(f"the sqrt kernel takes 1 <= m <= {MAX_M}, got {m}")
    a = alphas[:m].to(torch.float64).contiguous()
    b = betas[:m].to(torch.float64).contiguous()
    _build.check_cuda_tensor(a, "alphas", (m,), torch.float64)
    _build.check_cuda_tensor(b, "betas", (m,), torch.float64)
    out = torch.empty(m, dtype=torch.float64, device=a.device)
    LANCZOS_SQRT(_build.ptr(a), _build.ptr(b), _build.ptr(out), m)
    return out


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
