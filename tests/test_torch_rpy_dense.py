"""The port's dense RPY backends (uammd_tpu_torch.integrators.bdhi.rpy,
``CholeskyBDHI``, ``LanczosBDHI``) against the JAX package's, float64.

- ``rpy_pair_blocks`` (far, near-overlap and self pairs), ``dense_mobility``
  open and periodic, within 1e-10 of max|ref|;
- ``rpy_matvec`` with N not a multiple of ``chunk`` (JAX pads its row
  chunks with rows i % N, the port loops over the real rows);
- ``cholesky_sqrt_dot`` and the Lanczos sqrt(M) z on the same z; a
  matrix that is not positive definite raises;
- three T = 0 steps of ``bdhi_euler_maruyama`` with each backend;
- the noise covariance E[b b^T] = M of tests/test_bdhi.py:48 for each
  backend (atol 0.2 of max|M|, that test's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.core.state import make_state as j_make_state
from uammd_tpu.core.types import ForceEnergyVirial as JFEV
from uammd_tpu.integrators.bdhi import euler_maruyama as jem
from uammd_tpu.integrators.bdhi import rpy as jrpy
from uammd_tpu.solvers.lanczos import lanczos_sqrt_apply as j_lanczos
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.core.state import make_state
from uammd_tpu_torch.core.types import ForceEnergyVirial
from uammd_tpu_torch.integrators.bdhi import euler_maruyama as tem
from uammd_tpu_torch.integrators.bdhi import rpy as trpy
from uammd_tpu_torch.solvers.lanczos import lanczos_sqrt_apply

TOL = 1e-10
KW = dict(viscosity=1.3, radius=0.8)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _pos(n, L, seed):
    return (np.random.default_rng(seed).random((n, 3)) - 0.5) * L


def test_rpy_pair_blocks_match_jax():
    rng = np.random.default_rng(0)
    dr = rng.normal(size=(40, 3)) * rng.choice([0.3, 1.0, 4.0], size=(40, 1))
    dr[0] = 0.0  # self
    dr[1] = [1e-13, 0.0, 0.0]  # inside the self threshold
    m0 = 1.0 / (6.0 * np.pi * 1.3 * 0.8)
    want = jax.jit(jrpy.rpy_pair_blocks, static_argnums=(1, 2))(jnp.asarray(dr), 0.8, m0)
    _close(trpy.rpy_pair_blocks(torch.as_tensor(dr), 0.8, m0), want)


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_dense_mobility_matches_jax(periodic):
    L = 6.0
    pos = _pos(24, L, 1)
    jb = jbox(L, dtype=jnp.float64) if periodic else None
    tb = tbox(L, dtype=torch.float64, device="cpu") if periodic else None
    want = jax.jit(lambda p: jrpy.dense_mobility(p, box=jb, **KW))(jnp.asarray(pos))
    got = trpy.dense_mobility(torch.as_tensor(pos), box=tb, **KW)
    _close(got, want)
    if not periodic:  # the minimum-image RPY matrix need not be positive
        assert np.linalg.eigvalsh(got.numpy()).min() > 0


def test_rpy_matvec_ragged_chunks_match_jax():
    n, L = 30, 8.0
    pos = _pos(n, L, 2)
    f = np.random.default_rng(3).normal(size=(n, 3))
    jb, tb = jbox(L, dtype=jnp.float64), tbox(L, dtype=torch.float64, device="cpu")
    want = jax.jit(lambda p, q: jrpy.rpy_matvec(p, q, box=jb, chunk=7, **KW))(
        jnp.asarray(pos), jnp.asarray(f))
    got = trpy.rpy_matvec(torch.as_tensor(pos), torch.as_tensor(f), box=tb, chunk=7, **KW)
    _close(got, want)
    dense = trpy.dense_mobility(torch.as_tensor(pos), box=tb, **KW) @ torch.as_tensor(f).reshape(-1)
    _close(got, dense.reshape(-1, 3))


def test_cholesky_and_lanczos_sqrt_on_one_z():
    n = 20
    pos = _pos(n, 7.0, 4)
    z = np.random.default_rng(5).normal(size=3 * n)
    M = trpy.dense_mobility(torch.as_tensor(pos), **KW)
    jM = jrpy.dense_mobility(jnp.asarray(pos), **KW)
    _close(trpy.cholesky_sqrt_dot(M, torch.as_tensor(z)),
           jax.jit(jrpy.cholesky_sqrt_dot)(jM, jnp.asarray(z)))

    def t_mv(x):
        return trpy.rpy_matvec(torch.as_tensor(pos), x.reshape(-1, 3), **KW).reshape(-1)

    def j_mv(x):
        return jrpy.rpy_matvec(jnp.asarray(pos), x.reshape(-1, 3), **KW).reshape(-1)

    got, res = lanczos_sqrt_apply(t_mv, torch.as_tensor(z), m=24)
    want, jres = jax.jit(lambda v: j_lanczos(j_mv, v, m=24))(jnp.asarray(z))
    _close(got, want, 1e-9)
    assert float(res) == pytest.approx(float(jres), rel=1e-6, abs=1e-12)
    with pytest.raises(torch.linalg.LinAlgError):
        trpy.cholesky_sqrt_dot(-M, torch.as_tensor(z))


BACKENDS = {"cholesky": (jem.CholeskyBDHI, tem.CholeskyBDHI, {}),
            "lanczos": (jem.LanczosBDHI, tem.LanczosBDHI, {"iterations": 24})}


@pytest.mark.parametrize("name", list(BACKENDS))
def test_three_t0_steps_match_jax(name):
    jcls, tcls, extra = BACKENDS[name]
    n, L, k = 16, 9.0, 0.7
    pos = _pos(n, L, 6)
    jb, tb = jbox(L, dtype=jnp.float64), tbox(L, dtype=torch.float64, device="cpu")

    def jforce(state, aux):
        return JFEV(force=-k * state.pos), aux

    def tforce(state, aux):
        return ForceEnergyVirial(force=-k * state.pos), aux

    jint = jem.bdhi_euler_maruyama(jforce, jcls(box=jb, **KW, **extra), dt=0.05)
    tint = tem.bdhi_euler_maruyama(tforce, tcls(box=tb, **KW, **extra), dt=0.05)
    js, _ = jint.init(j_make_state(jnp.asarray(pos), dtype=jnp.float64), None)
    ts, _ = tint.init(make_state(pos, dtype=torch.float64, device="cpu"), None)
    jstep = jax.jit(jint.step)
    for _ in range(3):
        js, _ = jstep(js, None)
        ts, _ = tint.step(ts, None)
    _close(ts.pos, js.pos, 1e-12)
    assert float(ts.time) == pytest.approx(0.15)


@pytest.mark.parametrize("name", list(BACKENDS))
def test_noise_covariance_is_the_mobility(name):
    """tests/test_bdhi.py:48 for the port: 1200 draws of B dW at 8
    particles, E[b b^T] within 0.2 max|M| of M."""
    _, tcls, extra = BACKENDS[name]
    pos = torch.as_tensor(np.random.default_rng(2).random((8, 3)) * 6)
    be = tcls(viscosity=1.0, radius=0.6, **({"iterations": 30} if extra else {}))
    gen = torch.Generator().manual_seed(0)
    bs = torch.stack([be.compute_bdw(pos, gen).reshape(-1) for _ in range(1200)]).numpy()
    M = trpy.dense_mobility(pos, viscosity=1.0, radius=0.6).numpy()
    cov = np.cov(bs.T, bias=True)
    scale = np.abs(M).max()
    np.testing.assert_allclose(cov / scale, M / scale, atol=0.2)
