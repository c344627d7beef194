"""The port's bonded forces (uammd_tpu_torch.interactors.bonded) and
general-path DPD (potentials.dpd) against the JAX package's, in float64.

- Every bond type (harmonic, FENE, fixed point, angular, torsional
  harmonic and Fourier) on random chains in a periodic box whose bonds
  partly cross a face: force, energy and virial within 1e-10 of max|ref|
  (the virial of the scale-free angle and dihedral energies is round-off,
  held to max|F| x a unit bond length);
  the state's positions never left requiring grad.
- ``dpd_forces`` at a fixed step within 1e-10 of max|ref| (its pair noise
  is a counter hash, equal to JAX's bit for bit); the total force zero
  and another step giving another force, as tests/test_interactors.py:134
  checks JAX's; DPD under ``nve`` through ``make_dpd_force_fn`` for 10
  steps (a rebuild inside) against JAX's trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as j_box
from uammd_tpu.core.grid import grid_from_cutoff as j_grid_from_cutoff
from uammd_tpu.core.state import make_state as j_make_state
from uammd_tpu.core.types import Computables as JComputables
from uammd_tpu.integrators import base as jbase
from uammd_tpu.integrators.verlet import nve as j_nve
from uammd_tpu.interactors import bonded as jbd
from uammd_tpu.neighbors import neighbor_list as jnl
from uammd_tpu.potentials import dpd as jdpd
from uammd_tpu_torch.core.box import box
from uammd_tpu_torch.core.state import make_state
from uammd_tpu_torch.core.types import Computables
from uammd_tpu_torch.integrators import base
from uammd_tpu_torch.integrators.verlet import nve
from uammd_tpu_torch.interactors import bonded as tbd
from uammd_tpu_torch.neighbors import neighbor_list as tnl
from uammd_tpu_torch.potentials import dpd as tdpd

L = 6.0
_j_rebuild = jax.jit(jnl._rebuild, static_argnums=tuple(range(2, 9)))


def j_build(pos, jb, cutoff, sm):
    """JAX's build_neighbor_list (neighbor_list.py:173-181), its rebuild jitted."""
    n = pos.shape[0]
    shape = j_grid_from_cutoff(jb, cutoff * sm)
    cap = max(4, int(np.ceil(n / (shape[0] * shape[1] * shape[2]) * 2.0)) + 4)
    k = jnl._auto_max_neighbors(n, float(jnp.prod(jb.size)), cutoff * sm)
    return _j_rebuild(jnp.asarray(pos), jb, cutoff, sm, shape, cap, k, 32768, False)


def _chains(n_chains=12, length=8, seed=0):
    """Random walks of step ~1 starting near the +x face, wrapped into the box."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform(-L / 2, L / 2, (n_chains, 3))
    starts[:, 0] = L / 2 - rng.uniform(0, 1.5, n_chains)
    steps = rng.normal(0, 1, (n_chains, length - 1, 3))
    steps *= rng.uniform(0.8, 1.2, (n_chains, length - 1, 1)) / np.linalg.norm(
        steps, axis=-1, keepdims=True)
    pos = np.concatenate([starts[:, None], starts[:, None] + np.cumsum(steps, 1)], 1)
    pos = pos.reshape(-1, 3)
    return pos - L * np.round(pos / L), length


def _bond_sets(n, length, rng):
    chains = np.arange(n).reshape(-1, length)

    def runs(p):
        return np.concatenate([np.stack([c[k:k + p] for k in range(length - p + 1)])
                               for c in chains])

    two, three, four = runs(2), runs(3), runs(4)
    m2, m3, m4 = len(two), len(three), len(four)
    return {
        "harmonic": (tbd.harmonic, jbd.harmonic, two,
                     dict(k=rng.uniform(5, 20, m2), r0=rng.uniform(0.8, 1.2, m2))),
        "fene": (tbd.fene, jbd.fene, two,
                 dict(k=rng.uniform(5, 20, m2), r0=rng.uniform(1.6, 2.0, m2))),
        "harmonic_fixed_point": (tbd.harmonic_fixed_point, jbd.harmonic_fixed_point,
                                 np.arange(0, n, 5),
                                 dict(k=rng.uniform(1, 3, len(range(0, n, 5))),
                                      r0=rng.uniform(0, 0.5, len(range(0, n, 5))),
                                      point=rng.uniform(-L / 2, L / 2,
                                                        (len(range(0, n, 5)), 3)))),
        "angular": (tbd.angular, jbd.angular, three,
                    dict(k=rng.uniform(1, 5, m3), theta0=rng.uniform(0, 3, m3))),
        "torsional_harmonic": (tbd.torsional_harmonic, jbd.torsional_harmonic, four,
                               dict(k=rng.uniform(1, 5, m4), phi0=rng.uniform(-3, 3, m4))),
        "torsional_fourier": (tbd.torsional_fourier, jbd.torsional_fourier, four,
                              dict(k=rng.uniform(1, 5, m4), phi0=rng.uniform(-3, 3, m4))),
    }


@pytest.mark.parametrize("name", ["harmonic", "fene", "harmonic_fixed_point", "angular",
                                  "torsional_harmonic", "torsional_fourier"])
def test_bond_types_match_jax(name):
    pos, length = _chains()
    rng = np.random.default_rng(1)
    t_fn, j_fn, idx, params = _bond_sets(len(pos), length, rng)[name]
    if idx.ndim == 2 and idx.shape[1] > 1:  # some bonds cross a face
        d = pos[idx[:, 1]] - pos[idx[:, 0]]
        assert (np.abs(d) > L / 2).any()
    jb = j_box(L, dtype=jnp.float64)
    tb = box(L, dtype=torch.float64, device="cpu")
    jbonds = jbd.bonds(idx, **params)
    want = jax.jit(lambda p: jbd.bonded_forces(j_fn, jbonds, p, jb, JComputables(True, True,
                                                                                 True)))(
        jnp.asarray(pos))
    p = torch.as_tensor(pos)
    got = tbd.bonded_forces(t_fn, tbd.bonds(idx, device="cpu", **params), p, tb,
                            Computables(True, True, True))
    assert not p.requires_grad and not got.force.requires_grad
    fscale = np.abs(np.asarray(want.force)).max()
    for k in ("force", "energy", "virial"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        # angle and dihedral energies are scale-free, so their virial (and a
        # one-member bond's, about its centre) is zero up to round-off: it
        # is held to the forces' scale x a bond length of 1
        scale = max(np.abs(b).max(), fscale) if k == "virial" else np.abs(b).max()
        assert scale > 0, k
        assert np.abs(a - b).max() <= 1e-10 * scale, (k, np.abs(a - b).max() / scale)


def _dpd_system(seed=0, n=200, Ld=6.0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) - 0.5) * Ld
    vel = rng.normal(0, 1, (n, 3))
    return pos, vel, Ld


def test_dpd_forces_match_jax_and_conserve_momentum():
    pos, vel, Ld = _dpd_system()
    prm = dict(cutoff=1.0, A=25.0, gamma=4.0, temperature=1.0, dt=0.01)
    jb = j_box(Ld, dtype=jnp.float64)
    tb = box(Ld, dtype=torch.float64, device="cpu")
    jl = j_build(pos, jb, 1.0, 1.0)
    want = jax.jit(lambda p, v, nl, s: jdpd.dpd_forces(jdpd.DPD(**prm), p, v, nl, s, box=jb))(
        jnp.asarray(pos), jnp.asarray(vel), jl, jnp.int32(7))
    p, v = torch.as_tensor(pos), torch.as_tensor(vel)
    tl = tnl.build_neighbor_list(p, tb, 1.0, skin_multiplier=1.0)
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    got = tdpd.dpd_forces(tdpd.DPD(**prm), p, v, tl, torch.tensor(7, dtype=torch.int32), box=tb)
    ref = np.asarray(want.force)
    assert np.abs(got.force.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    np.testing.assert_allclose(got.force.sum(0).numpy(), 0.0, atol=1e-8)
    other = tdpd.dpd_forces(tdpd.DPD(**prm), p, v, tl, 8, box=tb)
    assert float((got.force - other.force).abs().max()) > 1e-6
    assert tdpd.DPD(**prm).max_cutoff == 1.0


def test_dpd_under_nve_matches_jax():
    pos, vel, Ld = _dpd_system(seed=1, n=300, Ld=5.0)
    prm = dict(cutoff=1.0, A=25.0, gamma=4.5, temperature=1.0, dt=0.02)
    jb = j_box(Ld, dtype=jnp.float64)
    tb = box(Ld, dtype=torch.float64, device="cpu")
    jst = j_make_state(pos, vel=vel, dtype=jnp.float64)
    integ = j_nve(jdpd.make_dpd_force_fn(jdpd.DPD(**prm)), dt=0.02)
    want, jl, _ = jax.jit(lambda s, a: jbase.run(integ, s, a, 10))(jst, j_build(pos, jb, 1.0,
                                                                               1.3))
    st = make_state(pos, vel=vel, dtype=torch.float64, device="cpu")
    tl = tnl.build_neighbor_list(st.pos, tb, 1.0, skin_multiplier=1.3)
    got, tl2, _ = base.run(nve(tdpd.make_dpd_force_fn(tdpd.DPD(**prm)), dt=0.02), st, tl, 10)
    assert not torch.equal(tl2.ref_pos, tl.ref_pos)  # a rebuild inside
    for k in ("pos", "vel"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert np.abs(a - b).max() <= 1e-9 * max(Ld, np.abs(b).max()), k
