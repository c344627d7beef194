"""The port's v1 engine (uammd_tpu_torch.engine.md.GridMD) against the JAX
package's GridMD: the whole slice (pack, G-J steps through drift-triggered
rebins and the pair force, unpack) from one carried state.

At T = 0 the two trajectories are deterministic and compared through
``unpack`` (canonical pid order): atol 1e-4 on positions over 8 steps of
dt 0.01 (a drift-triggered rebin fires at step 6), for float32 sums taken
in another order and amplified by the chaotic dynamics. At T > 0 the noise streams differ
(jax.random vs torch.Generator), so the thermostat is checked by its
temperature, as tests/test_engine.py:98-111 does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine.md import make_lj_md as j_make_lj_md
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.md import make_lj_md
from uammd_tpu_torch.utils.lattices import lattice

# the fewest steps that cross one rebin (step 6) and recompute forces after it
STEPS = 8


@pytest.fixture(scope="module")
def trajectories():
    """STEPS T = 0 steps of the n 1500, L 24 LJ system on both packages from
    one state: a perturbed fcc lattice with random velocities (|v| ~ 2, so
    the drift check fires within the run)."""
    n, L = 1500, 24.0
    rng = np.random.default_rng(5)
    pos = lattice(n, L, "fcc") + rng.normal(0.0, 0.05, (n, 3))
    vel = rng.normal(0.0, 1.2, (n, 3))
    md_j = j_make_lj_md(L, n, dt=0.01, temperature=0.0, pos=pos)
    md_t = make_lj_md(L, n, dt=0.01, temperature=0.0, pos=pos, device="cpu")
    assert dataclasses.asdict(md_t.spec) == dataclasses.asdict(md_j.spec)
    # the port packs and computes the initial forces (both held to the JAX
    # package by the layout and pair-kernel tests); the JAX side starts from
    # the carried state
    gt0 = md_t.compute_forces(tl.pack(md_t.spec, pos, vel=vel, device="cpu"))
    fields = tl.grid_state_to_numpy(gt0)
    gj0 = jl.GridState(spec=md_j.spec, n=n, key=jax.random.key(0, impl="rbg"),
                       **{k: jnp.asarray(fields[k]) for k in tl.STATE_FIELDS})
    return gj0, md_j.run(gj0, STEPS), gt0, md_t.run(gt0, STEPS)


def test_t0_trajectory_follows_jax(trajectories):
    gj0, gj, gt0, gt = trajectories
    # at least one drift-triggered rebin happened on both sides
    assert not np.array_equal(np.asarray(gj.ref_x), np.asarray(gj0.ref_x))
    assert not torch.equal(gt.ref_x, gt0.ref_x)
    pj, vj, _ = (np.asarray(a) for a in jl.unpack(gj))
    pt, vt, _ = (a.numpy() for a in tl.unpack(gt))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-3)
    assert int((gt.pid >= 0).sum()) == gt.n
    assert not bool(gt.overflow)


def test_thermostat_keeps_particles_and_temperature():
    n, L, T = 1024, 16.0, 1.3
    rng = np.random.default_rng(5)
    pos = lattice(n, L, "fcc") + rng.normal(0.0, 0.05, (n, 3))
    # CAP 24 instead of the occupancy-derived 16: at mean occupancy 8 a
    # liquid cell reaches 17 within 100 steps for some noise streams, which
    # latches overflow in both packages
    md = make_lj_md(L, n, dt=0.005, temperature=T, pos=pos, cap=24, device="cpu")
    gs = md.init(pos, seed=4)
    for _ in range(4):
        gs = md.run(gs, 25)
    assert int((gs.pid >= 0).sum()) == n
    assert not bool(gs.overflow)
    t_meas = float(md.temperature_of(gs))
    assert abs(t_meas - T) / T < 0.25, t_meas


def test_nve_conserves_momentum():
    """Pair forces are antisymmetric, so NVE steps (run(..., nve=True))
    keep the total momentum at its initial zero through a rebin (at step
    15)."""
    n, L = 1024, 16.0
    rng = np.random.default_rng(6)
    pos = lattice(n, L, "fcc") + rng.normal(0.0, 0.05, (n, 3))
    vel = rng.normal(0.0, 1.5, (n, 3))
    vel -= vel.mean(axis=0)
    md = make_lj_md(L, n, dt=0.004, temperature=0.0, pos=pos, cap=24, device="cpu")
    gs0 = md.compute_forces(tl.pack(md.spec, pos, vel=vel, device="cpu"))
    gs = md.run(gs0, 20, nve=True)
    assert not torch.equal(gs.ref_x, gs0.ref_x)  # a rebin happened
    assert int((gs.pid >= 0).sum()) == n
    assert not bool(gs.overflow)
    p_tot = torch.stack([gs.vx.sum(), gs.vy.sum(), gs.vz.sum()])
    # float32 sums of 1024 velocities (sum |v| ~ 1e3) round at ~1e-4; a
    # force that broke antisymmetry would move the total by O(1)
    assert float(p_tot.abs().max()) < 1e-2, p_tot


def test_make_lj_md_defaults_to_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lj_md(24.0, 1500)
