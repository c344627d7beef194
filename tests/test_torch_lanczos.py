"""The port's Lanczos solver (uammd_tpu_torch.solvers.lanczos) against the
JAX package's, float64 on both sides, on tests/test_solvers.py:74's dense
SPD matrix (k 60, M = A A^T + k I) and its m 8/16/32 variant (:86). Both
take sqrt(T) e1 from an eigendecomposition with the eigenvalues clamped at
0 (on the card the port's is a one-block Jacobi kernel, held to this plain
version by chip_smoke.py and the ``gpu`` test): they agree to float64
round-off, held here to 1e-10 relative; the tridiagonal to 1e-12. An
indefinite T gives JAX's finite answer."""

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
    """sqrt(T) e1 against numpy's eigendecomposition on
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


@pytest.mark.parametrize("e", [1e-7, 1e-4])
def test_indefinite_t_matches_jax(e):
    """T = [[0.5, 0.5 + e], [0.5 + e, 0.5]] has the eigenvalue -e: JAX clamps
    it and returns [0.5, 0.5] (to O(e)); so must the port, finite."""
    T = np.array([[0.5, 0.5 + e], [0.5 + e, 0.5]])
    v = np.array([1.0, 0.0])
    want, _ = _jax_sqrt(T, v, 2, None)
    Tt = torch.tensor(T)
    got, _ = tlz.lanczos_sqrt_apply(lambda x: Tt @ x, torch.tensor(v), m=2)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), [0.5, 0.5], atol=2 * e)
    sq = tlz._sqrt_e1(torch.tensor([0.5, 0.5], dtype=torch.float64),
                      torch.tensor([0.0, 0.5 + e], dtype=torch.float64), 2)
    np.testing.assert_allclose(sq.numpy(), want, rtol=1e-12, atol=1e-14)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 5, 16, 48])
def test_cuda_sqrt_e1_matches_plain(cuda, m):
    """The Jacobi kernel against ``torch.linalg.eigh`` with the clamp, on an
    indefinite tridiagonal; one launch."""
    rng = np.random.default_rng(m)
    a, b = torch.tensor(rng.normal(size=m)), torch.tensor(rng.normal(size=m))
    want = tlz.sqrt_e1_plain(a, b, m)
    before = tlz.LANCZOS_SQRT.launches
    got = tlz._sqrt_e1(a.to(cuda), b.to(cuda), m)
    torch.cuda.synchronize()
    assert tlz.LANCZOS_SQRT.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-10 * float(want.abs().max()))
