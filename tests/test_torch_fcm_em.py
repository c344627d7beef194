"""The port's BDHI Euler-Maruyama integrators and the modules under them
(uammd_tpu_torch.integrators.bdhi.euler_maruyama, integrators.base,
interactors.external, core.*) against the JAX package's.

- ``fcm_em`` against JAX ``fcm_em`` at T = 0 over 5 steps at dt 0.4 that
  cross rebins of the persistent pencil bins (tests/test_bdhi.py:187's
  system with a 4x stronger force), float64, atol 1e-9 (that test's); and
  against the port's generic ``bdhi_euler_maruyama`` the same way;
- external forces (autograd of the energy when no force is given), the
  state carry, Box, ForceEnergyVirial and next_fft_size against JAX to
  1e-12 or exactly;
- ``run`` with observe and guard; entry points default to the GPU;
- ``gpu``: fcm_em steps on the card through the pencil kernels.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.core.grid import next_fft_size as j_next_fft_size
from uammd_tpu.core.state import make_state as j_make_state
from uammd_tpu.core.types import ForceEnergyVirial as JFEV
from uammd_tpu.integrators.bdhi import euler_maruyama as jem
from uammd_tpu.integrators.bdhi.fcm import FCM as JFCM
from uammd_tpu.interactors import external as jext
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.core.grid import next_fft_size
from uammd_tpu_torch.core.state import (make_state, next_key, sim_state_from_numpy,
                                        sim_state_to_numpy)
from uammd_tpu_torch.core.types import Computables, ForceEnergyVirial, zeros_fev
from uammd_tpu_torch.integrators import base
from uammd_tpu_torch.integrators.bdhi import euler_maruyama as tem
from uammd_tpu_torch.integrators.bdhi.fcm import FCM
from uammd_tpu_torch.interactors import external as text
from uammd_tpu_torch.solvers import pencil_ibm as tp

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_ibm.py

N, L, DT, STEPS = 4200, 40.0, 0.4, 5
# tests/test_bdhi.py:187's force, 4x stronger: at 1x the largest x/y drift
# over the 5 steps is 0.58, below the slack h = 0.83, so no rebin happens
FORCE_SCALE = 4.0
FCM_KW = dict(viscosity=1.0, radius=1.0, points_per_radius=1.2, support=8)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(9)
    return (rng.random((N, 3)) - 0.5) * L, rng.normal(size=(N, 3))


@pytest.fixture(scope="module")
def jax_trajectory(system):
    """JAX fcm_em positions after each of STEPS steps (one jitted step)."""
    pos, drift = system
    fcm = JFCM.create(jbox(L, dtype=jnp.float64), **FCM_KW)

    def force_fn(state, aux):
        f = FORCE_SCALE * (0.6 * jnp.sin(2.0 * jnp.pi * state.pos / L)
                           + 0.4 * jnp.asarray(drift))
        return JFEV(force=f), aux

    integ = jem.fcm_em(force_fn, fcm, dt=DT, temperature=0.0)
    st, aux = integ.init(j_make_state(jnp.asarray(pos), seed=0, dtype=jnp.float64), None)
    step = jax.jit(integ.step)
    out = []
    for _ in range(STEPS):
        st, aux = step(st, aux)
        out.append(np.asarray(st.pos))
    return out


def _port_force(drift):
    d = torch.as_tensor(drift)

    def force_fn(state, aux):
        f = FORCE_SCALE * (0.6 * torch.sin(2.0 * math.pi * state.pos / L) + 0.4 * d)
        return ForceEnergyVirial(force=f), aux

    return force_fn


def test_fcm_em_matches_jax_at_t0(system, jax_trajectory):
    pos, drift = system
    fcm = FCM.create(tbox(L, dtype=torch.float64, device="cpu"), **FCM_KW)
    integ = tem.fcm_em(_port_force(drift), fcm, dt=DT, temperature=0.0)
    st, aux = integ.init(make_state(pos, dtype=torch.float64, device="cpu"), None)
    assert aux[0] is not None, "the pencil path must engage at this N"
    rebins = 0
    for want in jax_trajectory:
        prev = aux[0]
        st, aux = integ.step(st, aux)
        rebins += aux[0] is not prev
        np.testing.assert_allclose(st.pos.numpy(), want, atol=1e-9)
    assert rebins >= 1, "the steps must cross a rebin"
    assert int(st.step) == STEPS and float(st.time) == pytest.approx(STEPS * DT)


def test_fcm_em_matches_generic_at_t0(system):
    """fcm_em (fused pass, persistent bins) equals the generic integrator with
    the FCM backend (per-call bins), as tests/test_bdhi.py:187 holds JAX's."""
    pos, drift = system
    fcm = FCM.create(tbox(L, dtype=torch.float64, device="cpu"), **FCM_KW)
    ia = tem.bdhi_euler_maruyama(_port_force(drift), fcm, dt=DT, temperature=0.0)
    ib = tem.fcm_em(_port_force(drift), fcm, dt=DT, temperature=0.0)
    sa, aa = ia.init(make_state(pos, dtype=torch.float64, device="cpu"), None)
    sb, ab = ib.init(make_state(pos, dtype=torch.float64, device="cpu"), None)
    for _ in range(3):
        sa, aa = ia.step(sa, aa)
        sb, ab = ib.step(sb, ab)
        np.testing.assert_allclose(sb.pos.numpy(), sa.pos.numpy(), atol=1e-9)


@pytest.mark.parametrize("over", [False, True])
def test_fcm_em_drift_threshold_in_state_dtype(over):
    """fcm_em rebins when the x/y drift passes the threshold compared in the
    state's dtype, as JAX compares it (``jnp.asarray(thr, state.dtype)``):
    a float32 drift equal to float32(thr), which lies above the float64
    thr, does not rebin; the next float32 value up does."""
    L32 = next(Lb for Lb in np.arange(40.0, 48.0, 0.25)
               if float(np.float32(thr_of(Lb))) > thr_of(Lb))
    fcm = FCM.create(tbox(L32, dtype=torch.float32, device="cpu"), **FCM_KW)
    thr32 = np.float32(thr_of(L32))
    assert float(thr32) > thr_of(L32)

    def zero_force(state, aux):
        return ForceEnergyVirial(force=torch.zeros_like(state.pos)), aux

    integ = tem.fcm_em(zero_force, fcm, dt=DT, temperature=0.0)
    pos = torch.tensor((np.random.default_rng(9).random((N, 3)) - 0.5) * L32,
                       dtype=torch.float32)
    pos[0, 0] = 0.0
    st, carry = integ.init(make_state(pos, dtype=torch.float32, device="cpu"), None)
    assert carry[0] is not None, "the pencil path must engage at this N"
    moved = pos.clone()
    moved[0, 0] = float(np.nextafter(thr32, np.float32(1.0))) if over else float(thr32)
    _, new = integ.step(st.replace(pos=moved), carry)
    assert (new[0] is not carry[0]) == over


def thr_of(Lb):
    """fcm_em's threshold, slack 1 x the grid spacing, at box size ``Lb``."""
    fcm = FCM.create(tbox(Lb, dtype=torch.float32, device="cpu"), **FCM_KW)
    return min(fcm.box_size[0] / fcm.shape[0], fcm.box_size[1] / fcm.shape[1])


def test_external_forces_match_jax():
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(50, 3)) * 3.0
    js = j_make_state(jnp.asarray(pos), dtype=jnp.float64)
    ts = make_state(pos, dtype=torch.float64, device="cpu")
    for name, args in (("gravity", ((0.0, 0.5, -1.0),)), ("harmonic_trap", (1.7, (0.5, 0, 0))),
                       ("wall_lj93", (-6.0, 1.0, 1.0, 1))):
        j_e, j_f = getattr(jext, name)(*args)
        t_e, t_f = getattr(text, name)(*args)
        c = Computables(force=True, energy=True)
        want = jext.external_forces(js, j_e, j_f, c)
        got = text.external_forces(ts, t_e, t_f, c)
        np.testing.assert_allclose(got.force.numpy(), np.asarray(want.force), atol=1e-12)
        np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy), atol=1e-12)
        # the force from autograd of the energy alone
        auto = text.external_forces(ts, t_e, None)
        np.testing.assert_allclose(auto.force.numpy(), np.asarray(want.force), atol=1e-12)


def test_state_box_types_and_grid():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(20, 3)) * 10.0
    js = j_make_state(jnp.asarray(pos), seed=3, mass=np.arange(20.0), dtype=jnp.float64)
    fields = {k: np.asarray(getattr(js, k)) for k in ("pos", "mass", "id", "time", "step")}
    ts = sim_state_from_numpy(fields, seed=3, device="cpu")
    back = sim_state_to_numpy(ts)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    assert ts.dtype == torch.float64 and ts.get_vel().shape == (20, 3)
    st, gen = next_key(ts)
    assert isinstance(gen, torch.Generator) and st is ts
    jb, tb = jbox([7.0, 9.0, 11.0], dtype=jnp.float64), tbox([7.0, 9.0, 11.0],
                                                             dtype=torch.float64, device="cpu")
    for fn in ("wrap", "wrap_position", "to_fractional"):
        np.testing.assert_allclose(getattr(tb, fn)(torch.as_tensor(pos)).numpy(),
                                   np.asarray(getattr(jb, fn)(jnp.asarray(pos))), atol=1e-12)
    assert float(tb.volume) == pytest.approx(float(jb.volume))
    a = ForceEnergyVirial(force=torch.ones(2, 3))
    b = zeros_fev(2, torch.float32, Computables(force=True, energy=True))
    s = a + b
    assert torch.equal(s.force, torch.ones(2, 3)) and s.energy.shape == (2,) and s.virial is None
    for n in (1, 7, 97, 130, 222, 376, 383):
        for kw in ({}, {"prefer_pow2": True}, {"pencil_safe": True},
                   {"tile_safe_support": 6, "pencil_safe": False}, {"tile_safe_support": 12}):
            assert next_fft_size(n, **kw) == j_next_fft_size(n, **kw)


def test_run_observe_and_guard():
    def force_fn(state, aux):
        return ForceEnergyVirial(force=-state.pos), aux

    def step(state, aux):
        fev, aux = force_fn(state, aux)
        return base.advance_time(state.replace(pos=state.pos + 0.1 * fev.force), 0.1), aux

    integ = base.Integrator(init=lambda s, a: (s, a), step=step)
    st = make_state(np.ones((4, 3)), device="cpu")
    st, _, obs = base.run(integ, st, None, 6, observe=lambda s: float(s.pos[0, 0]),
                          observe_every=2, guard=True)
    assert obs == pytest.approx([0.9**2, 0.9**4, 0.9**6], rel=1e-6)
    assert int(st.step) == 6
    combined = base.combine_interactors(force_fn, force_fn)
    assert torch.equal(combined(st, None)[0].force, -2 * st.pos)
    bad = base.Integrator(init=lambda s, a: (s, a),
                          step=lambda s, a: (s.replace(pos=s.pos * float("nan")), a))
    with pytest.raises(base.SimulationError):
        base.run(bad, st, None, 1, guard=True)
    assert float(base.temperature(st)) == 0.0


def test_entry_points_default_to_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbox(10.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_state(np.zeros((3, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.pencil_bins_from_numpy({"pids": np.zeros((4, 8)), "slot_of_pid": np.zeros(3),
                                   "overflow": False})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_fcm_em_steps(cuda, system):
    """fcm_em on the card goes through both pencil kernels every step and
    follows the plain path on the CPU (float32, T = 0) to 1e-5 of the
    largest displacement."""
    pos, drift = system
    fcm_c = FCM.create(tbox(L, device=cuda), **FCM_KW)
    fcm_h = FCM.create(tbox(L, device="cpu"), **FCM_KW)
    d = torch.as_tensor(drift, dtype=torch.float32)

    def forces(state, aux):
        return ForceEnergyVirial(force=0.4 * d.to(state.device)), aux

    ic = tem.fcm_em(forces, fcm_c, dt=DT)
    ih = tem.fcm_em(forces, fcm_h, dt=DT)
    sc, ac = ic.init(make_state(pos, device=cuda), None)
    sh, ah = ih.init(make_state(pos, device="cpu"), None)
    n0, n1 = tp.SPREAD.launches, tp.INTERP.launches
    for _ in range(3):
        sc, ac = ic.step(sc, ac)
        sh, ah = ih.step(sh, ah)
    torch.cuda.synchronize()
    assert tp.SPREAD.launches - n0 >= 3 and tp.INTERP.launches - n1 >= 3
    moved = float((sh.pos - torch.as_tensor(pos, dtype=torch.float32)).abs().max())
    assert float((sc.pos.cpu() - sh.pos).abs().max()) <= 1e-5 * moved
