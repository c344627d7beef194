"""The port's Lanczos solver (uammd_tpu_torch.solvers.lanczos) against the
JAX package's, float64 on both sides, on tests/test_solvers.py:74's dense
SPD matrix (k 60, M = A A^T + k I) and its m 8/16/32 variant (:86). The
port takes sqrt(T) e1 by a Newton-Schulz iteration (no host read on the
card) where JAX takes an eigendecomposition: both agree to float64
round-off, held here to 1e-10 relative; the tridiagonal to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.solvers import lanczos as jlz
from uammd_tpu_torch.solvers import lanczos as tlz


def _case(k, shift, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(k, k))
    M = A @ A.T + shift * np.eye(k)
    v = rng.normal(size=k)
    return M, v


def _jax_sqrt(M, v, m, w0):
    Mj = jnp.asarray(M)
    fn = jax.jit(lambda vv, ww: jlz.lanczos_sqrt_apply(lambda x: Mj @ x, vv, m=m, w0=ww))
    out, res = fn(jnp.asarray(v), None if w0 is None else jnp.asarray(w0))
    return np.asarray(out), float(res)


@pytest.mark.parametrize("peel", [False, True])
@pytest.mark.parametrize("k,shift,seed,m", [(60, 60.0, 3, 40), (80, 5.0, 4, 8),
                                            (80, 5.0, 4, 16)])
def test_sqrt_apply_matches_jax(k, shift, seed, m, peel):
    M, v = _case(k, shift, seed)
    w0 = M @ v if peel else None
    want, res_j = _jax_sqrt(M, v, m, w0)
    Mt = torch.tensor(M)
    got, res_t = tlz.lanczos_sqrt_apply(lambda x: Mt @ x, torch.tensor(v), m=m,
                                        w0=None if w0 is None else torch.tensor(w0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(float(res_t), res_j, rtol=1e-6, atol=1e-14)
    if m == 40:  # converged: the dense square root (tests/test_solvers.py:74)
        evals, evecs = np.linalg.eigh(M)
        exact = evecs @ (np.sqrt(evals) * (evecs.T @ v))
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-8)


def test_tridiag_and_iterations_for_tolerance_match_jax():
    M, v = _case(80, 5.0, 4)
    Mj = jnp.asarray(M)
    vn_j, a_j, b_j = jax.jit(lambda vv: jlz.lanczos_tridiag(lambda x: Mj @ x, vv, 16))(
        jnp.asarray(v))
    Mt = torch.tensor(M)
    vn_t, a_t, b_t = tlz.lanczos_tridiag(lambda x: Mt @ x, torch.tensor(v), 16)
    np.testing.assert_allclose(float(vn_t), float(vn_j), rtol=1e-14)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-12)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-12, atol=1e-12)
    for tol in (3e-2, 1e-3, 1e-6):
        assert (tlz.lanczos_iterations_for_tolerance(a_t.numpy(), b_t.numpy(), tol)
                == jlz.lanczos_iterations_for_tolerance(np.asarray(a_j), np.asarray(b_j), tol))


@pytest.mark.parametrize("cond", [1.0, 1e3, 1e7])
def test_sqrt_e1_matches_eigh(cond):
    """The Newton-Schulz sqrt(T) e1 against numpy's eigendecomposition on
    tridiagonals of growing condition number, and a zero block (an
    exhausted Krylov space) stays finite."""
    rng = np.random.default_rng(1)
    m = 16
    Q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    M = Q @ np.diag(np.geomspace(2.0, 2.0 / cond, m)) @ Q.T
    _, a, b = tlz.lanczos_tridiag(lambda x: torch.tensor(M) @ x,
                                  torch.tensor(rng.normal(size=m)), m)
    a, b = a.numpy(), b.numpy()
    T = np.diag(a) + np.diag(b[1:m], 1) + np.diag(b[1:m], -1)
    w, V = np.linalg.eigh(T)
    want = V @ (np.sqrt(np.maximum(w, 0.0)) * V[0])
    got = tlz._sqrt_e1(torch.tensor(a), torch.tensor(b), m).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
    z = tlz._sqrt_e1(torch.tensor([2.0, 1.0, 0.0, 0.0]), torch.tensor([0.0, 0.5, 0.0, 0.0]), 4)
    assert bool(torch.isfinite(z).all()) and float(z[2].abs() + z[3].abs()) == 0.0
