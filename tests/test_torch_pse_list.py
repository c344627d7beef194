"""The port's list-based PSE (uammd_tpu_torch.integrators.bdhi.pse.PSE)
against the JAX package's, float64.

- ``PSE.create``: rcut, xi, self term, the far FCM's grid and envelope and
  the near tables within 1e-12 of JAX's; ``pse_from_numpy`` carries JAX's
  fields over unchanged;
- ``near_matvec`` on JAX's neighbour list carried across
  (``neighbor_list_from_numpy``), within 1e-10 of max|ref|;
- ``compute_mf`` (far field on the direct path at this N) within 1e-9,
  and with the port's own list the same as with the carried one;
- the near Lanczos sqrt(M_near) z on one z within 1e-9;
- tests/test_pse.py:26 at one xi: the port's self-mobility within 2e-3 of
  Hashimoto's and its pair mobility against JAX's at another xi within
  that test's split-invariance bound.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.core.grid import grid_from_cutoff as j_grid_from_cutoff
from uammd_tpu.integrators.bdhi.pse import PSE as JPSE
from uammd_tpu.neighbors import neighbor_list as jnl
from uammd_tpu.solvers.lanczos import lanczos_sqrt_apply as j_lanczos
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.integrators.bdhi.pse import PSE as TPSE
from uammd_tpu_torch.integrators.bdhi.pse import pse_from_numpy
from uammd_tpu_torch.neighbors import neighbor_list as tnl
from uammd_tpu_torch.solvers.lanczos import lanczos_sqrt_apply

L, N = 30.0, 200
_j_rebuild = jax.jit(jnl._rebuild, static_argnums=tuple(range(2, 9)))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def j_list(pos, jb, cutoff, sm=1.2):
    """JAX's build_neighbor_list (neighbor_list.py:173-181), its rebuild jitted."""
    n = pos.shape[0]
    shape = j_grid_from_cutoff(jb, cutoff * sm)
    cap = max(4, int(math.ceil(n / (shape[0] * shape[1] * shape[2]) * 2.0)) + 4)
    k = jnl._auto_max_neighbors(n, float(jnp.prod(jb.size)), cutoff * sm)
    return _j_rebuild(jnp.asarray(pos), jb, cutoff, sm, shape, cap, k, 32768, False)


def carry_list(jl, tb):
    return tnl.neighbor_list_from_numpy(
        {"idx": np.asarray(jl.idx), "ref_pos": np.asarray(jl.ref_pos),
         "overflow": bool(jl.overflow), **{k: getattr(jl, k) for k in tnl._STATIC}}, tb)


def j_fields(jp):
    far = jp.far
    return {"viscosity": jp.viscosity, "radius": jp.radius, "xi": jp.xi, "rcut": jp.rcut,
            "r2_max": jp.r2_max, "f_table": np.asarray(jp.f_table),
            "g_table": np.asarray(jp.g_table), "self_f": jp.self_f,
            "lanczos_iterations": jp.lanczos_iterations,
            "far": {k: getattr(far, k) for k in ("viscosity", "radius", "shape", "support",
                                                 "box_size", "rpy_sinc_radius",
                                                 "hasimoto_k2", "kernel", "bm_beta")}}


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    pos = (rng.random((N, 3)) - 0.5) * L
    f = rng.normal(size=(N, 3))
    jb, tb = jbox(L, dtype=jnp.float64), tbox(L, dtype=torch.float64, device="cpu")
    jp = JPSE.create(jb, viscosity=1.0, radius=1.0, tolerance=1e-4)
    tp = TPSE.create(tb, viscosity=1.0, radius=1.0, tolerance=1e-4)
    jl = j_list(pos, jb, jp.rcut)
    return dict(pos=pos, f=f, jb=jb, tb=tb, jp=jp, tp=tp, jl=jl, tl=carry_list(jl, tb))


def test_create_matches_jax(system):
    jp, tp = system["jp"], system["tp"]
    for k in ("xi", "rcut", "r2_max", "self_f"):
        assert getattr(tp, k) == pytest.approx(getattr(jp, k), rel=1e-12), k
    assert tp.far.shape == jp.far.shape and tp.far.support == jp.far.support
    for k in ("radius", "rpy_sinc_radius", "hasimoto_k2"):
        assert getattr(tp.far, k) == pytest.approx(getattr(jp.far, k), rel=1e-12), k
    assert tp.f_table.dtype == torch.float64
    _close(tp.f_table, jp.f_table, 1e-12)
    _close(tp.g_table, jp.g_table, 1e-12)
    carried = pse_from_numpy(j_fields(jp), system["tb"])
    assert carried.far == tp.far and carried.rcut == jp.rcut
    np.testing.assert_array_equal(carried.f_table.numpy(), np.asarray(jp.f_table))


def test_near_matvec_on_a_carried_list(system):
    s = system
    assert not bool(s["tl"].overflow) and int((s["tl"].idx < N).sum()) > 10 * N
    want = jax.jit(s["jp"].near_matvec)(jnp.asarray(s["pos"]), jnp.asarray(s["f"]), s["jl"])
    got = s["tp"].near_matvec(torch.as_tensor(s["pos"]), torch.as_tensor(s["f"]), s["tl"])
    _close(got, want, 1e-10)


def test_compute_mf_matches_jax(system):
    s = system
    pos, f = torch.as_tensor(s["pos"]), torch.as_tensor(s["f"])
    want = jax.jit(s["jp"].compute_mf)(jnp.asarray(s["pos"]), jnp.asarray(s["f"]), s["jl"])
    got = s["tp"].compute_mf(pos, f, s["tl"])
    _close(got, want, 1e-9)
    _close(s["tp"].compute_mf(pos, f), got, 1e-12)  # the port's own list


def test_near_lanczos_on_one_z(system):
    s = system
    z = np.random.default_rng(1).normal(size=3 * N)
    pos = torch.as_tensor(s["pos"])

    def t_mv(x):
        return s["tp"].near_matvec(pos, x.reshape(-1, 3), s["tl"]).reshape(-1)

    def j_mv(x):
        return s["jp"].near_matvec(jnp.asarray(s["pos"]), x.reshape(-1, 3), s["jl"]).reshape(-1)

    m = s["tp"].lanczos_iterations
    got, _ = lanczos_sqrt_apply(t_mv, torch.as_tensor(z), m=m)
    want, _ = jax.jit(lambda v: j_lanczos(j_mv, v, m=m))(jnp.asarray(z))
    _close(got, want, 1e-9)


def test_hashimoto_and_split_invariance_against_jax():
    """tests/test_pse.py:26: two spheres 5 apart in a box of 32; the port at
    xi 0.5, JAX at xi 1.0."""
    Lh, r = 32.0, 5.0
    pos = np.array([[0.0, 0, 0], [r, 0, 0]])
    f = np.array([[1.0, 0, 0], [0, 0, 0]])
    tp = TPSE.create(tbox(Lh, dtype=torch.float64, device="cpu"), xi=0.5, tolerance=1e-5)
    jp = JPSE.create(jbox(Lh, dtype=jnp.float64), xi=1.0, tolerance=1e-5)
    v = tp.compute_mf(torch.as_tensor(pos), torch.as_tensor(f)).numpy()
    jv = np.asarray(jax.jit(jp.compute_mf)(jnp.asarray(pos), jnp.asarray(f),
                                           j_list(pos, jp.box, jp.rcut)))
    m0 = 1.0 / (6.0 * math.pi)
    want_self = m0 * (1.0 - 2.83729748 / Lh + (4.0 * math.pi / 3.0) / Lh ** 3)
    np.testing.assert_allclose(v[0, 0], want_self, rtol=2e-3)
    pairs = (v[1, 0], jv[1, 0])
    assert abs(pairs[0] - pairs[1]) < 2e-3 * abs(np.mean(pairs)) * 10
