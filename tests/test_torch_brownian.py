"""The port's Brownian dynamics integrators (uammd_tpu_torch.integrators.
brownian) against the JAX package's.

- At T = 0 the four schemes are deterministic: 10 steps in a harmonic trap
  (the ported ``interactors.external.harmonic_trap``) with a shear matrix
  and per-particle radii, in float64, against JAX's to 1e-10 of the
  largest displacement.
- At T > 0 the noise streams differ (``jax.random`` against a
  ``torch.Generator``), so free diffusion is checked by its statistics:
  the mean squared displacement of 20000 free particles after t = 1
  against 6 D t, D = T M from ``self_mobility``, within 5 % (the estimate's
  own relative standard deviation is sqrt(2/3) / sqrt(20000) = 0.6 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.state import make_state as j_make_state
from uammd_tpu.integrators import base as jbase
from uammd_tpu.integrators import brownian as jb
from uammd_tpu.interactors.external import external_forces as j_external
from uammd_tpu.interactors.external import harmonic_trap as j_trap
from uammd_tpu_torch.core.state import make_state
from uammd_tpu_torch.core.types import ForceEnergyVirial
from uammd_tpu_torch.integrators import base
from uammd_tpu_torch.integrators import brownian as tb
from uammd_tpu_torch.interactors.external import external_forces, harmonic_trap

SCHEMES = ("euler_maruyama", "midpoint", "adams_bashforth", "leimkuhler")
K = [[0.0, 0.3, 0.0], [0.0, 0.0, 0.0], [0.1, 0.0, 0.0]]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_t0_schemes_match_jax(scheme):
    rng = np.random.default_rng(1)
    n = 64
    pos = rng.uniform(-3, 3, (n, 3))
    radius = rng.uniform(0.5, 1.5, n)
    kw = dict(dt=0.01, temperature=0.0, viscosity=0.7, K=K)

    e_j, _ = j_trap(k=2.0, center=(0.5, 0.0, -0.5))
    e_t, _ = harmonic_trap(k=2.0, center=(0.5, 0.0, -0.5))
    integ_j = getattr(jb, scheme)(lambda s, a: (j_external(s, e_j), a), **kw)
    integ_t = getattr(tb, scheme)(lambda s, a: (external_forces(s, e_t), a), **kw)
    sj = j_make_state(pos, radius=radius, dtype=jnp.float64)
    st = make_state(pos, radius=radius, dtype=torch.float64, device="cpu")
    sj, _, _ = jbase.run(integ_j, sj, None, 10)
    st, _, _ = base.run(integ_t, st, None, 10)
    want = np.asarray(sj.pos)
    got = st.pos.numpy()
    scale = np.abs(want - pos).max()
    assert scale > 1e-3
    assert np.abs(got - want).max() <= 1e-10 * scale
    np.testing.assert_allclose(st.force.numpy(), np.asarray(sj.force), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(sj.force)).max())
    assert int(st.step) == int(sj.step) == 10
    assert float(st.time) == pytest.approx(float(sj.time), rel=1e-12)


def test_self_mobility_matches_jax():
    pos = np.zeros((5, 3))
    radius = np.linspace(0.5, 2.5, 5)
    sj = j_make_state(pos, radius=radius, dtype=jnp.float64)
    st = make_state(pos, radius=radius, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tb.self_mobility(st, 0.7).numpy(),
                               np.asarray(jb.self_mobility(sj, 0.7)), rtol=1e-14)
    np.testing.assert_allclose(tb.self_mobility(st, 0.7, 2.0).numpy(),
                               np.asarray(jb.self_mobility(sj, 0.7, 2.0)), rtol=1e-14)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_free_diffusion_msd(scheme):
    n, dt, steps, temp = 20000, 0.01, 100, 1.0
    st = make_state(np.zeros((n, 3)), seed=7, dtype=torch.float64, device="cpu")

    def free(s, a):
        return ForceEnergyVirial(force=torch.zeros_like(s.pos)), a

    integ = getattr(tb, scheme)(free, dt=dt, temperature=temp, viscosity=1.0,
                                hydrodynamic_radius=1.0)
    st, _, _ = base.run(integ, st, None, steps)
    D = temp * float(tb.self_mobility(st, 1.0, 1.0)[0])
    msd = float((st.pos ** 2).sum(dim=1).mean())
    assert msd == pytest.approx(6.0 * D * dt * steps, rel=0.05)
