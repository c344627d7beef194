"""The port's FCM torque paths and rotational BDHI
(uammd_tpu_torch.integrators.bdhi.fcm, .rotational) against the JAX
package's, float64.

- ``sigma_torque`` equal to JAX's; ``_kernel_torque`` refuses the
  non-Gaussian kernels;
- ``compute_hydrodynamic_displacements`` with and without torques, on the
  direct path (n 60) and on the pencil path (tests/test_bdhi.py:187's n
  4200 system: the force and torque spreads share one binning), within
  1e-9 of max|ref|;
- three T = 0 steps of ``bdhi_fcm_rotational``: positions and
  orientations within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.core.state import make_state as j_make_state
from uammd_tpu.integrators.bdhi.fcm import FCM as JFCM
from uammd_tpu.integrators.bdhi.rotational import bdhi_fcm_rotational as j_rot
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.core.state import make_state
from uammd_tpu_torch.integrators.bdhi.fcm import FCM as TFCM
from uammd_tpu_torch.integrators.bdhi.rotational import bdhi_fcm_rotational

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_ibm.py

SYSTEMS = {"direct": (60, 16.0, dict(radius=1.0, points_per_radius=2.0, support=8)),
           "pencil": (4200, 40.0, dict(radius=1.0, points_per_radius=1.2, support=8))}


def _close(got, want, tol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _fcms(L, kw):
    return (JFCM.create(jbox(L, dtype=jnp.float64), **kw),
            TFCM.create(tbox(L, dtype=torch.float64, device="cpu"), **kw))


def _inputs(n, L, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, 3)) - 0.5) * L, rng.normal(size=(n, 3)), rng.normal(size=(n, 3)))


def test_sigma_torque_and_refusal():
    jf, tf = _fcms(20.0, dict(radius=1.3, points_per_radius=2.0, support=8))
    assert tf.sigma_torque == pytest.approx(jf.sigma_torque, rel=1e-15)
    assert tf._kernel_torque().sigma == pytest.approx(jf._kernel_torque().sigma, rel=1e-15)
    _, tp = _fcms(20.0, dict(radius=1.0, kernel="peskin3pt"))
    with pytest.raises(NotImplementedError, match="Gaussian rotlet"):
        tp._kernel_torque()


@pytest.mark.parametrize("torques", [True, False], ids=["torques", "forces_only"])
@pytest.mark.parametrize("case", list(SYSTEMS))
def test_hydrodynamic_displacements_match_jax(case, torques):
    n, L, kw = SYSTEMS[case]
    jf, tf = _fcms(L, kw)
    pos, f, t = _inputs(n, L)
    tpos = torch.as_tensor(pos)
    assert (tf.pencil_bins(tpos) is not None) == (case == "pencil")
    if torques:
        v, w = jax.jit(jf.compute_hydrodynamic_displacements)(*map(jnp.asarray, (pos, f, t)))
        tv, tw = tf.compute_hydrodynamic_displacements(tpos, torch.as_tensor(f),
                                                       torch.as_tensor(t))
        _close(tw, w)
    else:
        v = jax.jit(lambda p, q: jf.compute_hydrodynamic_displacements(p, q)[0])(
            jnp.asarray(pos), jnp.asarray(f))
        tv, tw = tf.compute_hydrodynamic_displacements(tpos, torch.as_tensor(f))
        assert tw is None
    _close(tv, v)


def test_three_t0_rotational_steps_match_jax():
    n, L, kw = SYSTEMS["direct"]
    jf, tf = _fcms(L, kw)
    pos, f, t = _inputs(n, L, seed=1)

    def jft(state, aux):
        return jnp.asarray(f) - 0.3 * state.pos, jnp.asarray(t), aux

    def tft(state, aux):
        return torch.as_tensor(f) - 0.3 * state.pos, torch.as_tensor(t), aux

    jint, tint = j_rot(jft, jf, dt=0.05), bdhi_fcm_rotational(tft, tf, dt=0.05)
    js, _ = jint.init(j_make_state(jnp.asarray(pos), dtype=jnp.float64), None)
    ts, _ = tint.init(make_state(pos, dtype=torch.float64, device="cpu"), None)
    jstep = jax.jit(jint.step)
    for _ in range(3):
        js, _ = jstep(js, None)
        ts, _ = tint.step(ts, None)
    _close(ts.pos, js.pos)
    _close(ts.dir, js.dir)
    assert float((ts.dir - torch.tensor([1.0, 0, 0, 0], dtype=torch.float64)).abs().max()) > 1e-3
    np.testing.assert_allclose(torch.linalg.vector_norm(ts.dir, dim=1).numpy(), 1.0, atol=1e-14)
