"""The port's grid-resident PSE (uammd_tpu_torch.integrators.bdhi.pse_engine)
against the JAX package's on the CPU (its near field through the 27-stencil
channel kernel in Pallas interpret mode, the port's through that kernel's
plain version, as both packages pick off the card).

System: tests/test_pse_engine.py:319's n 4096 fcc suspension in a box of
64 (tolerance 1e-3, 64 straggler rows) with a far grid of 48 instead of 24
(cells of 9 instead of 21, CAP 20 below the fcc occupancy, so stragglers
ride from the start and the JAX kernels compile in seconds, not a
minute), marched by a fixed random flow of 0.2 sigma per step so cells are
crossed and both rebins fire. JAX is compiled once per function at XLA backend
optimisation level 0 (the interpret-mode compiles are what these tests
cost). Tolerances, float32 on both sides (the sums run in other orders):

- ``create``'s constants (spec, rcut, xi, qb, coefficients, scales,
  self_f, fit errors, far grid) equal JAX's exactly;
- the persistent T = 0 steps: displacement and forces per step within
  1e-4 of the step's largest, the rebin cadence equal;
- near M F and the near noise with JAX's draw injected: 2e-5 x max|ref|
  (the bar of tests/test_pse_engine.py:573), compute_mf 1e-4 x max|ref|
  (the far field's 1/k^2 lifts low-k rounding);
- the fused near pass bit-equal to the unfused one on the CPU; the sqrt
  identity ||B z||^2 = z.M z within 5e-3 (test_pse_engine.py:87).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as j_box
from uammd_tpu.engine.layout import pack_channels as j_pack_channels
from uammd_tpu.engine.md import lj_g_fused as j_lj_g_fused
from uammd_tpu.integrators.bdhi.pse_engine import PSEGrid as JPSEGrid
from uammd_tpu.solvers import lanczos as jlz
from uammd_tpu.utils.lattices import lattice
from uammd_tpu_torch.core.box import box as t_box
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.md import lj_g_fused
from uammd_tpu_torch.integrators.bdhi import pse_engine as tpe

N, L, STEPS = 4096, 64.0, 6
KW = dict(viscosity=1.0, radius=1.0, far_grid=48, tolerance=1e-3, lanczos_iterations=4, cap=20,
          n_strag=64)
RC2 = (2.0 ** (1.0 / 6.0) * 2.0) ** 2


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


@pytest.fixture(scope="module")
def system():
    pos = np.asarray(lattice(N, L, "fcc"), np.float32)
    drift = np.random.default_rng(5).normal(size=(N, 3)).astype(np.float32)
    be_j = JPSEGrid.create(j_box(L), N, pos=jnp.asarray(pos), **KW)
    be_t = tpe.PSEGrid.create(t_box(L, device="cpu"), N, pos=pos, **KW)
    return pos, drift, be_j, be_t


def test_create_constants_match_jax(system):
    _, _, be_j, be_t = system
    for f in ("box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag"):
        assert getattr(be_t.spec, f) == getattr(be_j.spec, f), f
    for f in ("rcut", "xi", "qb", "coef", "uscale", "self_f", "fit_error", "coef_noise",
              "fit_error_noise", "lanczos_iterations", "viscosity", "radius"):
        assert getattr(be_t, f) == getattr(be_j, f), f
    assert tuple(be_t.far.shape) == tuple(be_j.far.shape)
    assert be_t.far.support == be_j.far.support
    assert be_t.far.rpy_sinc_radius == be_j.far.rpy_sinc_radius
    assert be_t.far.hasimoto_k2 == be_j.far.hasimoto_k2


def test_em_state_matches_jax_and_carries(system):
    """``em_state`` equals JAX's field for field (the near pid layout and
    stragglers from the same pack, the far pencil bins, the references),
    and a JAX state carries into the port and back."""
    pos, _, be_j, be_t = system
    st_j = jax.jit(be_j.em_state)(jnp.asarray(pos))
    fields = {k: np.asarray(getattr(st_j, k)) for k in tpe._STEP_ARRAYS}
    st_t = be_t.em_state(torch.tensor(pos))
    assert int((st_t.spid >= 0).sum()) > 0, "want stragglers"
    for k, want in fields.items():
        np.testing.assert_array_equal(getattr(st_t, k).numpy(), want, err_msg=k)
    back = tpe.pse_step_state_to_numpy(tpe.pse_step_state_from_numpy(fields, device="cpu"))
    for k, want in fields.items():
        np.testing.assert_array_equal(back[k], want, err_msg=k)
    assert (back["n_rebin_near"], back["n_rebin_far"]) == (0, 0)


@pytest.fixture(scope="module")
def jax_steps(system):
    """JAX's persistent T = 0 steps under the fixed flow (one scan)."""
    pos, drift, be_j, _ = system
    fs = be_j.make_pair_force_slots(j_lj_g_fused(1.0, 2.0, rc2=RC2, approx=False))
    b = j_box(L)
    key = jax.random.key(0)

    def run(p, dr):
        st = be_j.em_state(p)

        def body(carry, _):
            p, st = carry
            dx, f, st = be_j.displacement_with_pair_force_persistent(fs, p, key, 0.01, 0.0, st)
            return (b.wrap_position(p + 0.2 * dr), st), (
                dx, f, st.n_rebin_near, st.n_rebin_far, st.overflow, jnp.sum(st.spid >= 0))

        return jax.lax.scan(body, (p, st), None, length=STEPS)

    args = (jnp.asarray(pos), jnp.asarray(drift))
    (p_end, _), outs = _jit0(run, *args)(*args)
    return np.asarray(p_end), [np.asarray(o) for o in outs]


def test_persistent_steps_match_jax(system, jax_steps):
    """``displacement_with_pair_force_persistent`` at T = 0 step by step,
    with the same rebin cadence, crossing near rebins with stragglers in
    flight."""
    pos, drift, _, be_t = system
    p_end_j, (dx_j, f_j, rn_j, rf_j, ovf_j, ns_j) = jax_steps
    assert rn_j[-1] >= 1 and rf_j[-1] >= 1 and ns_j.max() > 0 and not ovf_j.any()
    fs = be_t.make_pair_force_slots(lj_g_fused(1.0, 2.0, rc2=RC2, approx=False))
    b = t_box(L, device="cpu")
    p = torch.tensor(pos)
    st = be_t.em_state(p)
    gen = torch.Generator()
    for k in range(STEPS):
        dx, f, st = be_t.displacement_with_pair_force_persistent(fs, p, gen, 0.01, 0.0, st)
        scale = np.abs(dx_j[k]).max()
        np.testing.assert_allclose(dx.numpy(), dx_j[k], rtol=0, atol=1e-4 * scale,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(f.numpy(), f_j[k], rtol=0,
                                   atol=1e-4 * (np.abs(f_j[k]).max() + 1.0), err_msg=f"step {k}")
        assert (st.n_rebin_near, st.n_rebin_far) == (int(rn_j[k]), int(rf_j[k])), k
        assert int((st.spid >= 0).sum()) == int(ns_j[k]), k
        assert not bool(st.overflow)
        p = b.wrap_position(p + 0.2 * torch.tensor(drift))
    np.testing.assert_allclose(p.numpy(), p_end_j, rtol=0, atol=1e-4)


def _jax_z(be_j, cg_j, key):
    """The start vector JAX's noise paths draw from ``key`` on ``cg_j``."""
    mask = (cg_j.pid >= 0).astype(jnp.float32)
    z3 = [jax.random.normal(k, cg_j.x.shape, jnp.float32) * mask
          for k in jax.random.split(key, 3)]
    smask = (cg_j.spid >= 0).astype(jnp.float32)
    zs = jax.random.normal(jax.random.fold_in(key, 7), (3, be_j.spec.n_strag),
                           jnp.float32) * smask
    return z3, zs


@pytest.fixture(scope="module")
def end_state(system, jax_steps):
    """The flow's end positions (stragglers in flight), a force payload and
    JAX's near M F, far M F and near noise on its own draw there; and the
    Lanczos tridiagonal that JAX's ``tuned_lanczos`` records at the start
    positions (its probe draw, key 1234, and its operator), in one
    compiled function."""
    pos, _, be_j, be_t = system
    p = jax_steps[0]
    F = np.random.default_rng(9).normal(size=(N, 3)).astype(np.float32)
    key = jax.random.key(5)

    def extras(p, F, p0):
        cg = j_pack_channels(be_j.spec, p, jnp.zeros_like(p))
        bx, by, bz, s3, _ = be_j._near_noise_slots(cg, key)
        # tuned_lanczos's probe (pse_engine.py:663-720), spelled out so it
        # compiles with the rest
        cg0 = j_pack_channels(be_j.spec, p0, jnp.zeros_like(p0))
        z3, zs = _jax_z(be_j, cg0, jax.random.key(1234))
        shape, T = cg0.x.shape, cg0.x.size

        def mv(v):
            g = v.reshape(3, -1)
            gg = g[:, :T].reshape((3,) + shape)
            gs = g[:, T:]
            ox, oy, oz, sv3 = be_j.near_matvec_slots(cg0, gg[0], gg[1], gg[2],
                                                     (gs[0], gs[1], gs[2]), noise=True)
            flat = jnp.stack([ox, oy, oz]).reshape(3, -1)
            return jnp.concatenate([flat, jnp.stack(sv3)], axis=1).reshape(-1)

        z0 = jnp.concatenate([jnp.stack(z3).reshape(3, -1), zs], axis=1).reshape(-1)
        _, alphas, betas = jlz.lanczos_tridiag(mv, z0, 16)
        return (be_j.near_matvec(p, F), be_j.far.compute_mf(p, F), (bx, by, bz, s3), cg,
                z0, alphas, betas)

    args = (jnp.asarray(p), jnp.asarray(F), jnp.asarray(pos))
    near, far, noise, cg_j, z0, alphas, betas = _jit0(extras, *args)(*args)
    z3, zs = _jax_z(be_j, cg_j, key)
    cg_t = tl.channel_grid_from_numpy(be_t.spec, {
        k: np.asarray(getattr(cg_j, k)) for k in
        ("x", "y", "z", "pid", "overflow", "spos", "spid")} | {
        "channels": [], "schannels": [], "n": N}, device="cpu")
    return {"p": p, "F": F, "near": np.asarray(near), "far": np.asarray(far),
            "noise": [np.asarray(a) for a in noise], "cg": cg_t,
            "z3": [np.asarray(z) for z in z3], "zs": np.asarray(zs),
            "probe": (np.asarray(z0), np.asarray(alphas), np.asarray(betas))}


def test_near_matvec_and_compute_mf_match_jax(system, end_state):
    _, _, _, be_t = system
    p, F = torch.tensor(end_state["p"]), torch.tensor(end_state["F"])
    assert int((end_state["cg"].spid >= 0).sum()) > 0, "want stragglers"
    near = be_t.near_matvec(p, F).numpy()
    want = end_state["near"]
    np.testing.assert_allclose(near, want, rtol=0, atol=2e-5 * np.abs(want).max())
    mf = be_t.compute_mf(p, F).numpy()
    want = end_state["near"] + end_state["far"]
    np.testing.assert_allclose(mf, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_near_noise_with_jax_draw_matches_jax(system, end_state):
    _, _, _, be_t = system
    cg = end_state["cg"]
    z3 = tuple(torch.tensor(z) for z in end_state["z3"])
    zs = torch.tensor(end_state["zs"])
    bx, by, bz, s3, _ = be_t._near_noise_slots_z(cg, z3, zs)
    want = end_state["noise"]
    scale = max(np.abs(a).max() for a in want)
    for got, ref in zip((bx, by, bz, s3), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5 * scale)


def test_tuned_lanczos_from_the_same_draw(system, end_state):
    """The port's ``tuned_lanczos`` on JAX's probe draw picks the count that
    JAX's tridiagonal gives (``lanczos_iterations_for_tolerance`` as JAX's
    ``tuned_lanczos`` applies it), for two tolerances."""
    pos, _, _, be_t = system
    z0, alphas, betas = end_state["probe"]
    for tol in (3e-2, 1e-3):
        m_j = jlz.lanczos_iterations_for_tolerance(alphas, betas, tol)
        got = be_t.tuned_lanczos(torch.tensor(pos), tol=tol, z=torch.tensor(z0))
        assert got.lanczos_iterations == m_j, tol


def test_fused_near_pass_equals_unfused(system, end_state):
    """M F riding the first noise matvec (one 6-channel pass) equals M F and
    the noise as separate passes, bit for bit on the CPU."""
    _, _, _, be_t = system
    p, F = torch.tensor(end_state["p"]), torch.tensor(end_state["F"])
    cg = tl.pack_channels(be_t.spec, p, F)
    gen = torch.Generator()
    gen.manual_seed(3)
    z3, zs = be_t.draw_z(cg, gen)
    a = be_t._near_mf_and_noise_z(cg, *cg.channels, cg.schannels, z3, zs, fused=True)
    b = be_t._near_mf_and_noise_z(cg, *cg.channels, cg.schannels, z3, zs, fused=False)
    for x, y in zip([*a[0], *a[1], *a[2], a[3]], [*b[0], *b[1], *b[2], b[3]]):
        assert torch.equal(x, y)


def test_near_noise_sqrt_identity(system, end_state):
    _, _, _, be_t = system
    be = dataclasses.replace(be_t, lanczos_iterations=16)
    cg = end_state["cg"]
    gen = torch.Generator()
    gen.manual_seed(1)
    for _ in range(1):
        z3, zs = be.draw_z(cg, gen)
        bx, by, bz, s3, _ = be._near_noise_slots_z(cg, z3, zs)
        lhs = float(sum((v.double() ** 2).sum() for v in (bx, by, bz, s3)))
        vx, vy, vz, sv3 = be.near_matvec_slots(cg, *z3, sf3=(zs[0], zs[1], zs[2]))
        rhs = float(sum((a.double() * c.double()).sum()
                        for a, c in zip((*z3, *zs), (vx, vy, vz, *sv3))))
        assert rhs > 0
        np.testing.assert_allclose(lhs, rhs, rtol=5e-3)


def test_refresh_rebins_on_drift_and_keeps_cells(system):
    """tests/test_pse_engine.py:372: a move past both thresholds rebins both
    grids, no move keeps the state; and after the near rebin every grid
    particle sits in the cell a fresh pack puts it in."""
    pos, _, _, be_t = system
    b = t_box(L, device="cpu")
    p0 = torch.tensor(pos)
    st0 = be_t.em_state(p0)
    p2 = b.wrap_position(p0 + torch.tensor([5.0, 5.0, 5.0]))
    cg, _, st1 = be_t._refresh(st0, p2)
    assert (st1.n_rebin_near, st1.n_rebin_far) == (1, 1)
    assert not torch.equal(st1.ref, st0.ref) and not torch.equal(st1.far_ref, st0.far_ref)
    _, _, st2 = be_t._refresh(st0, p0)
    assert torch.equal(st2.pid, st0.pid) and (st2.n_rebin_near, st2.n_rebin_far) == (0, 0)
    # a move below a cell: the separable rebin, checked cell by cell
    small = torch.tensor(np.random.default_rng(2).uniform(-1.0, 1.0, (N, 3)), dtype=torch.float32)
    p3 = b.wrap_position(p0 + small)
    cg3, _, st3 = be_t._refresh(st0, p3)
    assert st3.n_rebin_near == 1 and not bool(st3.overflow)
    fresh = tl.pack_channels(be_t.spec, p3, torch.zeros((N, 0)))
    spec = be_t.spec

    def cells(pid):
        idx = torch.nonzero(pid >= 0)
        keyed = torch.full((N,), -1, dtype=torch.int64)
        keyed[pid[pid >= 0].long()] = (idx[:, 0] * spec.nyb + idx[:, 1]) * spec.nlane + idx[:, 3]
        return keyed

    c3, cf = cells(cg3.pid), cells(fresh.pid)
    both = (c3 >= 0) & (cf >= 0)
    assert int(both.sum()) > N - 2 * spec.n_strag
    assert torch.equal(c3[both], cf[both])
    assert int((c3 >= 0).sum()) + int((cg3.spid >= 0).sum()) == N
    # the refreshed slot coordinates are the particles' positions (image
    # branch of the rebin), empties at EMPTY_POS
    m = cg3.pid >= 0
    got = cg3.x[m]
    want = p3[cg3.pid[m].long(), 0]
    d = got - want
    assert float((d - L * torch.round(d / L)).abs().max()) < 1e-4
    assert bool((cg3.x[~m] == tl.EMPTY_POS).all())


def test_entry_points_default_to_gpu(system):
    pos, _, _, be_t = system
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        t_box(L)
    with pytest.raises(RuntimeError):
        be_t.em_state(pos)  # numpy positions go to the default device
    assert be_t.em_state(pos, device="cpu").pid.device.type == "cpu"


def test_fresh_pack_paths_agree(system, end_state):
    """At the flow's end: the fused ``displacement`` at T = 0 equals
    dt x ``compute_mf`` (test_pse_engine.py:69's rtol 2e-4), the fresh-pack
    pair-force step equals the persistent one on a new state (JAX's
    persistent-vs-fresh bar, 5e-3 of the largest), and the noisy step and
    ``compute_bdw`` are finite and of the right size."""
    _, _, _, be_t = system
    p, F = torch.tensor(end_state["p"]), torch.tensor(end_state["F"])
    gen = torch.Generator()
    gen.manual_seed(4)
    d0, ovf = be_t.displacement(p, F, gen, 0.01, 0.0)
    assert not bool(ovf)
    np.testing.assert_allclose(d0.numpy(), 0.01 * be_t.compute_mf(p, F).numpy(), rtol=2e-4,
                               atol=1e-9)
    fs = be_t.make_pair_force_slots(lj_g_fused(1.0, 2.0, rc2=RC2, approx=False))
    dx_f, f_f, ovf = be_t.displacement_with_pair_force(fs, p, gen, 0.01, 0.0)
    dx_p, f_p, _ = be_t.displacement_with_pair_force_persistent(fs, p, gen, 0.01, 0.0,
                                                                be_t.em_state(p))
    assert not bool(ovf) and float(f_f.abs().max()) > 0, "want WCA contacts"
    scale = float(dx_f.abs().max())
    np.testing.assert_allclose(dx_p.numpy(), dx_f.numpy(), rtol=0, atol=5e-3 * scale)
    np.testing.assert_allclose(f_p.numpy(), f_f.numpy(), rtol=1e-4, atol=1e-4)
    d1, _ = be_t.displacement(p, F, gen, 0.01, 1.0)
    bdw = be_t.compute_bdw(p, gen)
    assert bool(d1.isfinite().all()) and bool(bdw.isfinite().all())
    assert 1e-3 < float((d1 - d0).pow(2).mean().sqrt()) < 1.0
    assert tuple(bdw.shape) == (N, 3) and torch.equal(be_t.divergence(p), torch.zeros_like(p))
