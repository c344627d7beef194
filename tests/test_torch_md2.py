"""The port's v2 engine (uammd_tpu_torch.engine.md2.GridMD2) against the
JAX package's GridMD2: the whole slice (Newton pair force with stragglers,
fused fold + G-J update, drift-triggered separable rebin, unpack) from one
carried state.

At T = 0 both trajectories are deterministic and are compared through
``unpack`` at atol 2e-4 on positions (the tolerance of
tests/test_engine2.py:82): float32 sums in another order, amplified by the
dynamics. The run crosses one drift-triggered rebin on both sides. At
T > 0 the noise streams differ (the TPU kernel's hardware PRNG, jax.random
in the JAX mirror, the port's counter hash), so the thermostat is checked
by its temperature, as tests/test_engine2.py:128 does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine.md2 import make_lj_md2 as j_make_lj_md2
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.md2 import make_lj_md2
from uammd_tpu_torch.utils.lattices import lattice

N, L = 600, 12.0
STEPS = 6  # the drift check fires at step 5, so a rebin is crossed


def _pos(seed, jitter):
    rng = np.random.default_rng(seed)
    return lattice(N, L, "fcc") + jitter * rng.standard_normal((N, 3)), rng


@pytest.fixture(scope="module")
def trajectories():
    """STEPS T = 0 steps at dt 0.01 from a gently jittered lattice with
    velocities of |v| ~ 2.6 (CAP 8, 128-row straggler list)."""
    pos, rng = _pos(3, 0.08)
    vel = rng.normal(0.0, 1.5, (N, 3))
    md_t = make_lj_md2(L, N, dt=0.01, temperature=0.0, cap=8, n_strag=128, pos=pos,
                       device="cpu")
    md_j = j_make_lj_md2(L, N, dt=0.01, temperature=0.0, cap=8, n_strag=128, pos=pos)
    assert dataclasses.asdict(md_t.spec) == dataclasses.asdict(md_j.spec)
    gt0 = md_t.init(pos, vel=vel)
    assert int((gt0.spid >= 0).sum()) > 0
    # the JAX engine off the TPU keeps folded forces and no groups
    fields = tl.grid_state_to_numpy(gt0)
    fields["fx"], fields["fy"], fields["fz"] = (a.numpy() for a in md_t.folded_forces(gt0))
    gj0 = jl.GridState(spec=md_j.spec, n=N, key=jax.random.key(0, impl="rbg"),
                       **{k: jnp.asarray(fields[k]) for k in tl.STATE_FIELDS})
    return gj0, md_j.run(gj0, STEPS), gt0, md_t.run(gt0, STEPS), md_t


def test_t0_trajectory_follows_jax(trajectories):
    gj0, gj, gt0, gt, md_t = trajectories
    assert not np.array_equal(np.asarray(gj.ref_x), np.asarray(gj0.ref_x))
    assert not torch.equal(gt.ref_x, gt0.ref_x)
    pj = np.asarray(jl.unpack(gj)[0])
    pt = tl.unpack(gt)[0].numpy()
    d = pt - pj
    d -= L * np.round(d / L)  # wrap-insensitive
    assert np.abs(d).max() < 2e-4, np.abs(d).max()
    assert int((gt.pid >= 0).sum()) + int((gt.spid >= 0).sum()) == N
    assert not bool(gt.overflow)
    assert int(gt.step - gt0.step) == STEPS


def test_langevin_equipartition():
    pos, _ = _pos(5, 0.05)
    md = make_lj_md2(L, N, dt=0.005, temperature=1.3, friction=1.0, cap=16, n_strag=128,
                     pos=pos, device="cpu")
    gs = md.run(md.init(pos, seed=2), 200)
    t = float(md.temperature_of(gs))
    assert not bool(gs.overflow)
    assert int((gs.pid >= 0).sum()) + int((gs.spid >= 0).sum()) == N
    assert abs(t - 1.3) < 0.15, t


def test_straggler_overflow_latches():
    """More coincident particles than CAP + S can hold -> flag."""
    n = 256
    md = make_lj_md2(9.0, n, dt=0.001, temperature=0.0, cap=8, n_strag=16, device="cpu")
    gs = md.init(np.zeros((n, 3)), seed=0)
    assert bool(gs.overflow)


def test_make_lj_md2_defaults_to_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_lj_md2(L, N)
    md = make_lj_md2(L, N, device="cpu")
    assert md.device.type == "cpu"
