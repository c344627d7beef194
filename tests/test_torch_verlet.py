"""The port's Verlet integrators (uammd_tpu_torch.integrators.verlet) on
the general pair path, against the JAX package's.

- ``nve`` from given velocities for 50 steps of a shifted-LJ liquid, with
  a neighbour-list rebuild inside the window, positions within 1e-9 of
  the box of JAX's (float64; JAX's ``run`` under ``jax.jit``).
- ``nvt_basic`` and ``nvt_gronbech_jensen`` at T = 0 with friction (no
  noise: deterministic) against JAX's, the same bound.
- At T > 0 the noise streams differ (``jax.random`` against a
  ``torch.Generator``), so the port alone: equipartition within 8 % and
  NVE energy drift below 1e-3, the bounds of tests/test_md.py:59-89, at
  its n 256 (equipartition after 300 + 700 steps, not 500 + 1000: the
  mean of 70 samples of T at n 256 has a ~1.5 % standard error).
- ``initialize_velocities``: the temperature within 3 % and zero net
  momentum, with per-particle masses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as j_box
from uammd_tpu.core.grid import grid_from_cutoff as j_grid_from_cutoff
from uammd_tpu.core.state import make_state as j_make_state
from uammd_tpu.integrators import base as jbase
from uammd_tpu.integrators import verlet as jv
from uammd_tpu.interactors.pair import pair_forces as j_pair_forces
from uammd_tpu.neighbors import neighbor_list as jnl
from uammd_tpu.potentials.radial import lj as j_lj
from uammd_tpu.utils.lattices import lattice
from uammd_tpu_torch.core.box import box
from uammd_tpu_torch.core.state import make_state
from uammd_tpu_torch.core.types import Computables
from uammd_tpu_torch.integrators import base
from uammd_tpu_torch.integrators import verlet as tv
from uammd_tpu_torch.interactors.pair import pair_forces
from uammd_tpu_torch.neighbors import neighbor_list as tnl
from uammd_tpu_torch.potentials.radial import lj


def _start(n=256, rho=0.4, seed=0, vscale=1.5):
    L = (n / rho) ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    pos = lattice(n, L, "fcc") + rng.uniform(-0.1, 0.1, (n, 3))
    vel = rng.normal(0.0, vscale, (n, 3))
    return pos, vel - vel.mean(0), L


def _port_system(pos, L, vel=None, seed=0, shift=True):
    b = box(L, dtype=torch.float64, device="cpu")
    st = make_state(pos, vel=vel, seed=seed, dtype=torch.float64, device="cpu")
    pot = lj(cutoff=2.5, shift=shift, dtype=torch.float64, device="cpu")
    nl = tnl.ensure_capacity(tnl.build_neighbor_list(st.pos, b, pot.max_cutoff), st.pos)
    rebuilds = []

    def force_fn(state, nbrs, computables=Computables()):
        new = tnl.maybe_rebuild(nbrs, state.pos)
        if new is not nbrs:
            rebuilds.append(int(state.step))
        return pair_forces(pot, state.pos, new, computables=computables), new

    return st, nl, pot, force_fn, rebuilds


def _jax_run(make, pos, vel, L, steps, **kw):
    b = j_box(L, dtype=jnp.float64)
    st = j_make_state(pos, vel=vel, dtype=jnp.float64)
    pot = j_lj(cutoff=2.5, shift=True, dtype=jnp.float64)
    n, rl = len(pos), pot.max_cutoff * 1.2
    shape = j_grid_from_cutoff(b, rl)  # JAX's build_neighbor_list sizes, jitted
    cap = max(4, int(np.ceil(n / (shape[0] * shape[1] * shape[2]) * 2.0)) + 4)
    k = jnl._auto_max_neighbors(n, float(jnp.prod(b.size)), rl)
    nl = jax.jit(jnl._rebuild, static_argnums=tuple(range(2, 9)))(
        st.pos, b, pot.max_cutoff, 1.2, shape, cap, k, 32768, False)

    def force_fn(state, nbrs):
        nbrs = jnl.maybe_rebuild(nbrs, state.pos)
        return j_pair_forces(pot, state.pos, nbrs), nbrs

    integ = make(force_fn, **kw)
    out, nl, _ = jax.jit(lambda s, a: jbase.run(integ, s, a, steps))(st, nl)
    return out, nl


@pytest.mark.parametrize("which", ["nve", "nvt_basic", "nvt_gronbech_jensen"])
def test_deterministic_trajectories_match_jax(which):
    pos, vel, L = _start(vscale=2.0)
    kw = {"dt": 0.005} if which == "nve" else {"dt": 0.005, "temperature": 0.0,
                                               "friction": 1.3}
    want, jl = _jax_run(getattr(jv, which), pos, vel, L, 50, **kw)
    st, nl, _, force_fn, rebuilds = _port_system(pos, L, vel)
    st, nl, _ = base.run(getattr(tv, which)(force_fn, **kw), st, nl, 50)
    assert rebuilds, "a rebuild inside the window"
    assert not np.array_equal(np.asarray(jl.ref_pos), pos)
    for k in ("pos", "vel", "force"):
        a, b = getattr(st, k).numpy(), np.asarray(getattr(want, k))
        assert np.abs(a - b).max() <= 1e-9 * max(L, np.abs(b).max()), k
    assert int(st.step) == int(want.step) == 50
    assert float(st.time) == pytest.approx(float(want.time), rel=1e-12)


def total_energy(state, nl, pot):
    fev = pair_forces(pot, state.pos, nl, computables=Computables(force=False, energy=True))
    return float(base.kinetic_energy(state) + fev.energy.sum())


def test_nve_energy_conservation():
    pos = lattice(256, (256 / 0.4) ** (1 / 3), "fcc")
    st, nl, pot, force_fn, rebuilds = _port_system(pos, (256 / 0.4) ** (1 / 3))
    st = tv.initialize_velocities(st, 1.0)
    integ = tv.nve(force_fn, dt=0.002)
    st, nl = integ.init(st, nl)
    e0 = total_energy(st, nl, pot)
    st, nl, _ = base.run(integ, st, nl, 1000, initialize=False)
    assert rebuilds and not bool(nl.overflow)
    assert abs(total_energy(st, nl, pot) - e0) / abs(e0) < 1e-3


@pytest.mark.parametrize("which", ["nvt_basic", "nvt_gronbech_jensen"])
def test_nvt_equipartition(which):
    T0 = 2.0
    pos = lattice(256, (256 / 0.4) ** (1 / 3), "fcc")
    st, nl, pot, force_fn, _ = _port_system(pos, (256 / 0.4) ** (1 / 3), seed=3)
    integ = getattr(tv, which)(force_fn, dt=0.005, temperature=T0, friction=1.0)
    st, nl = integ.init(st, nl)
    st, nl, _ = base.run(integ, st, nl, 300, initialize=False)
    st, nl, obs = base.run(integ, st, nl, 700, observe=base.temperature, observe_every=10,
                           initialize=False)
    t_meas = float(torch.stack(obs).mean())
    assert abs(t_meas - T0) / T0 < 0.08, t_meas


def test_initialize_velocities_statistics():
    n, T = 20000, 1.5
    rng = np.random.default_rng(2)
    mass = rng.uniform(0.5, 2.0, n)
    st = make_state(np.zeros((n, 3)), mass=mass, seed=4, dtype=torch.float64, device="cpu")
    st = tv.initialize_velocities(st, T)
    p = (st.vel * st.mass[:, None]).sum(0)
    assert float(p.abs().max()) < 1e-9
    t_meas = float((st.mass[:, None] * st.vel ** 2).sum() / (3 * n))
    assert abs(t_meas - T) / T < 0.03, t_meas
    flat = tv.initialize_velocities(st, T, is2D=True)
    assert float(flat.vel[:, 2].abs().max()) == 0.0
