"""The port's list interactors SPH and Deserno
(uammd_tpu_torch.interactors.sph, .deserno) against the JAX package's,
float64, on JAX's neighbour lists carried across.

- ``sph_density`` and ``sph_forces`` within 1e-10 of max|ref| at
  examples/dambreak.py's fluid (support 1, skin 1.3); ``make_sph_force_fn``
  the same forces, and its list rebuilt on drift as JAX's;
- ``deserno_pair_kernel`` force and energy, ``deserno_forces`` with the
  FENE and straightening bonds (forces and energies), within 1e-10;
- ``build_bilayer``'s positions, types, bonds and box equal to JAX's;
- three T = 0 ``leimkuhler`` steps of the bilayer within 1e-10.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.core.grid import grid_from_cutoff as j_grid_from_cutoff
from uammd_tpu.core.state import make_state as j_make_state
from uammd_tpu.core.types import Computables as JComputables
from uammd_tpu.integrators.brownian import leimkuhler as j_leimkuhler
from uammd_tpu.interactors import deserno as jd
from uammd_tpu.interactors import sph as jsph
from uammd_tpu.neighbors import neighbor_list as jnl
from uammd_tpu.neighbors.pair_map import apply_pairs as j_apply_pairs
from uammd_tpu.utils.lattices import lattice
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.core.state import make_state
from uammd_tpu_torch.core.types import Computables
from uammd_tpu_torch.integrators.brownian import leimkuhler
from uammd_tpu_torch.interactors import deserno as td
from uammd_tpu_torch.interactors import sph as tsph
from uammd_tpu_torch.neighbors import neighbor_list as tnl
from uammd_tpu_torch.neighbors.pair_map import apply_pairs

_j_rebuild = jax.jit(jnl._rebuild, static_argnums=tuple(range(2, 9)))
BOTH = dict(force=True, energy=True)


def _close(got, want, tol=1e-10):
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


# ------------------------------------------------------------------- SPH
SPH_KW = dict(support=1.0, viscosity=20.0, gas_stiffness=15.0, rest_density=1.2)


@pytest.fixture(scope="module")
def sph_system():
    n, spacing = 864, 0.8
    L = (n * spacing ** 3) ** (1.0 / 3.0)
    rng = np.random.default_rng(0)
    pos = lattice(n, L, "sc") + rng.uniform(-0.1, 0.1, (n, 3))
    vel = 0.3 * rng.normal(size=(n, 3))
    mass = 1.0 + 0.1 * rng.random(n)
    jb, tb = jbox(L, dtype=jnp.float64), tbox(L, dtype=torch.float64, device="cpu")
    params = (jsph.SPHParams(**SPH_KW), tsph.SPHParams(**SPH_KW))
    jl = j_list(pos, jb, params[0].max_cutoff, 1.3)
    return dict(pos=pos, vel=vel, mass=mass, jb=jb, tb=tb, params=params, jl=jl,
                tl=carry_list(jl, tb))


def test_sph_density_and_forces_match_jax(sph_system):
    s = sph_system
    jp, tp = s["params"]
    jargs = tuple(map(jnp.asarray, (s["pos"], s["vel"], s["mass"])))
    targs = tuple(map(torch.as_tensor, (s["pos"], s["vel"], s["mass"])))
    rho = jax.jit(lambda p, m, nl: jsph.sph_density(jp, p, m, nl))(jargs[0], jargs[2], s["jl"])
    _close(tsph.sph_density(tp, targs[0], targs[2], s["tl"]), rho)
    want = jax.jit(lambda p, v, m, nl: jsph.sph_forces(jp, p, v, m, nl).force)(*jargs, s["jl"])
    got = tsph.sph_forces(tp, *targs, s["tl"]).force
    _close(got, want)
    assert float(got.abs().max()) > 1.0


def test_make_sph_force_fn_matches_jax_and_rebuilds(sph_system):
    s = sph_system
    jp, tp = s["params"]
    jfn, tfn = jsph.make_sph_force_fn(jp), tsph.make_sph_force_fn(tp)
    shift = np.zeros_like(s["pos"])
    shift[0] = [0.35, 0.0, 0.0]  # past half the skin (0.3): a rebuild
    for moved in (s["pos"], s["pos"] + shift):
        js = j_make_state(jnp.asarray(moved), vel=jnp.asarray(s["vel"]),
                          mass=jnp.asarray(s["mass"]), dtype=jnp.float64)
        ts = make_state(moved, vel=s["vel"], mass=s["mass"], dtype=torch.float64, device="cpu")
        jfev, jl2 = jax.jit(jfn)(js, s["jl"])
        tfev, tl2 = tfn(ts, s["tl"])
        _close(tfev.force, jfev.force)
        assert (tl2 is s["tl"]) == (moved is s["pos"])
        np.testing.assert_array_equal(tl2.idx.numpy(), np.asarray(jl2.idx))


# --------------------------------------------------------------- Deserno
@pytest.fixture(scope="module")
def bilayer():
    jpar, tpar = jd.DesernoParams(), td.DesernoParams()
    jout = jd.build_bilayer(8, jpar)
    tout = td.build_bilayer(8, tpar, device="cpu")
    pos = jout[0] + np.random.default_rng(1).uniform(-0.05, 0.05, jout[0].shape)
    L = jout[4]
    jb = jbox([L, L, 6 * L], dtype=jnp.float64)
    tb = tbox([L, L, 6 * L], dtype=torch.float64, device="cpu")
    jl = j_list(pos, jb, jpar.max_cutoff)
    return dict(jout=jout, tout=tout, pos=pos, jb=jb, tb=tb, params=(jpar, tpar), jl=jl,
                tl=carry_list(jl, tb))


def test_build_bilayer_matches_jax(bilayer):
    (jpos, jtyp, jlip, jstr, jL), (tpos, ttyp, tlip, tstr, tL) = bilayer["jout"], bilayer["tout"]
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(ttyp, np.asarray(jtyp))
    assert tL == jL and tpos.shape == (2 * 8 * 8 * 3, 3)
    for tb_, jb_ in ((tlip, jlip), (tstr, jstr)):
        np.testing.assert_array_equal(tb_.idx.numpy(), np.asarray(jb_.idx))
        for k in ("k", "r0"):
            np.testing.assert_array_equal(tb_.params[k].numpy(), np.asarray(jb_.params[k]))


def test_deserno_pair_kernel_and_forces_match_jax(bilayer):
    b = bilayer
    jpar, tpar = b["params"]
    jtyp, ttyp = jnp.asarray(b["jout"][1]), torch.as_tensor(b["tout"][1])
    pos = b["pos"]
    jpair = jax.jit(lambda p, t, nl: j_apply_pairs(
        jd.deserno_pair_kernel(jpar, JComputables(**BOTH)), nl, p, info=t, box=b["jb"]))(
        jnp.asarray(pos), jtyp, b["jl"])
    tpair = apply_pairs(td.deserno_pair_kernel(tpar, Computables(**BOTH)), b["tl"],
                        torch.as_tensor(pos), info=ttyp, box=b["tb"])
    for k in ("force", "energy"):
        _close(tpair[k], jpair[k])
    _, _, jlip, jstr, _ = b["jout"]
    _, _, tlip, tstr, _ = b["tout"]
    jfev = jax.jit(lambda p, t, nl: jd.deserno_forces(
        p, t, jlip, jstr, jpar, nl, box=b["jb"], computables=JComputables(**BOTH)))(
        jnp.asarray(pos), jtyp, b["jl"])
    tfev = td.deserno_forces(torch.as_tensor(pos), ttyp, tlip, tstr, tpar, b["tl"], box=b["tb"],
                             computables=Computables(**BOTH))
    _close(tfev.force, jfev.force)
    _close(tfev.energy, jfev.energy)
    # the plateau: a tail pair inside the WCA cutoff sits at -epsilon
    _, e = td._tail_attraction(torch.tensor([1.0, 9.0], dtype=torch.float64), 1.0, 1.0, 1.6)
    assert e.tolist() == [-1.0, 0.0]


def test_three_t0_deserno_steps_match_jax(bilayer):
    b = bilayer
    jpar, tpar = b["params"]
    _, jtyp, jlip, jstr, _ = b["jout"]
    _, ttyp, tlip, tstr, _ = b["tout"]

    def jforce(state, nl):
        nl = jnl.maybe_rebuild(nl, state.pos)
        return jd.deserno_forces(state.pos, state.type_id, jlip, jstr, jpar, nl,
                                 box=b["jb"]), nl

    def tforce(state, nl):
        nl = tnl.maybe_rebuild(nl, state.pos)
        return td.deserno_forces(state.pos, state.type_id, tlip, tstr, tpar, nl,
                                 box=b["tb"]), nl

    jint = j_leimkuhler(jforce, dt=2e-4, temperature=0.0)
    tint = leimkuhler(tforce, dt=2e-4, temperature=0.0)
    js, jaux = jint.init(j_make_state(jnp.asarray(b["pos"]), type_id=jnp.asarray(jtyp),
                                      dtype=jnp.float64), b["jl"])
    ts, taux = tint.init(make_state(b["pos"], type_id=ttyp, dtype=torch.float64, device="cpu"),
                         b["tl"])
    jstep = jax.jit(jint.step)
    for _ in range(3):
        js, jaux = jstep(js, jaux)
        ts, taux = tint.step(ts, taux)
    _close(ts.pos - torch.as_tensor(b["pos"]), np.asarray(js.pos) - b["pos"])
