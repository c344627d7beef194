"""The port's composed multi-shard PSE step (uammd_tpu_torch.parallel.pse_dd)
against the JAX package's (uammd_tpu/parallel/pse_dd.py, Pallas kernels in
interpret mode on 4 of the 8 virtual CPU devices), on tests/test_pse_dd.py's
192-particle dimer system (every particle inside the WCA cutoff of its
partner, so the pair force and the T = 0 step are not zero):

- #1 in the halo mode with the fused LJ radial, and #2 with the PSE functor
  in the halo mode without straggler rows, on every shard's ghost-extended
  slab, against the JAX kernels: #1 within 1e-5 of max|f|, #2 within 2e-5
  of max|out| (tests/test_pse_engine.py:573's bar);
- ``lanczos_sqrt_apply_dd`` against JAX's on tests/test_pse_dd.py:91's
  sharded SPD operator (1e-6, as there);
- the whole step against JAX's at T = 0 and at T = 1, JAX's own draws
  (``split(key)``, ``fold_in(k_far, shard)``) fed to the port's ``step_z``
  (forces within 1e-4 max(fscale, 1), positions within 2e-4 max(dscale,
  1): tests/test_pse_dd.py:80-88's bars), and at T = 0 against the port's
  single-grid step, as test_pse_dd.py holds JAX's.

The JAX backend is built from the port's constants (``PSEGrid.create``'s
parity is tests/test_torch_pse_engine.py's business). The WCA takes the
exact reciprocal on both sides.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uammd_tpu.core.box import box as j_box
from uammd_tpu.engine.layout import GridSpec as JGridSpec
from uammd_tpu.engine.md import lj_g_fused as j_lj_g_fused
from uammd_tpu.engine.pair_kernel import make_pair_channel_kernel as j_make_channel
from uammd_tpu.engine.pair_kernel import make_pair_force_kernel as j_make_force
from uammd_tpu.integrators.bdhi.fcm import FCM as JFCM
from uammd_tpu.integrators.bdhi.pse_engine import PSEGrid as JPSEGrid
from uammd_tpu.parallel import pse_dd as jdd
from uammd_tpu.solvers.lanczos import lanczos_sqrt_apply as j_lanczos
from uammd_tpu.utils.lattices import lattice
from uammd_tpu_torch.core.box import box as t_box
from uammd_tpu_torch.engine import pair_kernel as tp
from uammd_tpu_torch.engine.layout import pack_channels
from uammd_tpu_torch.engine.md import lj_g_fused
from uammd_tpu_torch.integrators.bdhi.pse_engine import PSEGrid
from uammd_tpu_torch.parallel import pse_dd
from uammd_tpu_torch.parallel.mesh import make_mesh

N, L, D = 192, 64.0, 4
SIGMA = 2.0
RC2 = (2.0 ** (1.0 / 6.0) * SIGMA) ** 2
DT = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def dimer_positions(n, Lb):
    """tests/test_pse_dd.py:24-36: n / 2 fcc sites, each with a partner 1.5
    along x."""
    sites = np.asarray(lattice(n // 2, Lb, "fcc"))
    pos = np.concatenate([sites, sites + np.array([1.5, 0.0, 0.0])])
    pos -= Lb * np.round(pos / Lb)
    return pos.astype(np.float32)


def jax_backend(be_t, Lb, lanczos_iterations=None):
    """A JAX PSEGrid with the port's constants (no JAX fit)."""
    spec_j = JGridSpec(**{f: getattr(be_t.spec, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")})
    far = be_t.far
    b = j_box(Lb)
    far_j = JFCM(box=b, viscosity=far.viscosity, radius=far.radius, shape=far.shape,
                 support=far.support, box_size=far.box_size,
                 rpy_sinc_radius=far.rpy_sinc_radius, hasimoto_k2=far.hasimoto_k2)
    return JPSEGrid(box=b, far=far_j, viscosity=1.0, radius=1.0, xi=be_t.xi,
                    rcut=be_t.rcut, spec=spec_j, qb=be_t.qb, coef=be_t.coef,
                    uscale=be_t.uscale, self_f=be_t.self_f, fit_error=be_t.fit_error,
                    lanczos_iterations=lanczos_iterations or be_t.lanczos_iterations,
                    coef_noise=be_t.coef_noise)


@pytest.fixture(scope="module")
def system():
    pos = dimer_positions(N, L)
    be_t = PSEGrid.create(t_box(L, device="cpu"), N, viscosity=1.0, radius=1.0, far_grid=64,
                          tolerance=1e-3, lanczos_iterations=6, pos=pos, n_strag=0, support=8,
                          nz_multiple=D)
    assert be_t.spec.shape[2] % D == 0 and be_t.far.shape[0] % D == 0
    be_j = jax_backend(be_t, L)
    mesh_j = Mesh(np.array(jax.devices()[:D]), ("d",))
    mesh_t = make_mesh(D, devices=["cpu"] * D)
    return pos, be_t, be_j, mesh_j, mesh_t


def test_halo_kernel_modes_match_jax(system):
    """#1 fused (halo) and #2 PSE (halo, no straggler rows) on every shard's
    slab: the port's wrappers (plain versions on CPU tensors) against the
    JAX kernels in interpret mode."""
    pos, be_t, be_j, _, mesh_t = system
    step = pse_dd.make_sharded_pse_em_step(mesh_t, be_t, g_pair=lj_g_fused(
        1.0, SIGMA, rc2=RC2), dt=DT, temperature=0.0, n=N)
    cg = pack_channels(be_t.spec, torch.from_numpy(pos), torch.zeros((N, 0)))
    ext = step.ghosts(step.slabs(cg.x), step.slabs(cg.y), step.slabs(cg.z))
    rng = np.random.default_rng(1)
    masks = [(p > 0.5).to(torch.float32) for p in step.slabs((cg.pid + 1).to(torch.float32))]
    g3 = [torch.from_numpy(rng.normal(size=(3,) + tuple(m.shape)).astype(np.float32)) * m
          for m in masks]
    from uammd_tpu_torch.parallel.domain import halo_extend

    hg = halo_extend(g3, dim=1)
    local_j = JGridSpec(**{f: getattr(step.local_spec, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")})
    jf = j_make_force(local_j, j_lj_g_fused(1.0, SIGMA, rc2=RC2, approx=False),
                      interpret=True, periodic_z=False)
    pf, pbf = be_j._pair_fn()
    jn = j_make_channel(local_j, pf, 3, 3, pair_both_fn=pbf, interpret=True, periodic_z=False)
    a0 = [jnp.asarray(ext[c][0].numpy()) for c in range(3)]
    h0 = [jnp.asarray(hg[0][c].numpy()) for c in range(3)]
    jf = _jit0(jf, *a0)
    jn = _jit0(jn, *a0, *h0)
    fmax = 0.0
    for i in range(D):
        xyz = [ext[c][i] for c in range(3)]
        want = [np.asarray(a) for a in jf(*[jnp.asarray(t.numpy()) for t in xyz])]
        got = [a.numpy() for a in step.fkern(*xyz)]
        scale = max(max(np.abs(a).max() for a in want), 1.0)
        fmax = max(fmax, scale)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0)
        ch = [hg[i][c] for c in range(3)]
        want = [np.asarray(a) for a in jn(*[jnp.asarray(t.numpy()) for t in xyz + ch])]
        got = [a.numpy() for a in step.nkern(*xyz, *ch)]
        scale = max(np.abs(a).max() for a in want)
        assert scale > 0
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=2e-5 * scale, rtol=0)
    assert fmax > 100.0, "the dimers feel the WCA"


def test_distributed_lanczos_matches_jax():
    """tests/test_pse_dd.py:91-133's operator: a diagonal plus a symmetric
    nearest-neighbour coupling inside each shard block (no halo), m = 12."""
    k_loc = 96
    rng = np.random.default_rng(0)
    diag = 1.0 + rng.random(k_loc * D)
    v = rng.normal(size=k_loc * D)

    def mv_loc_j(d_loc, x):
        y = d_loc * x
        y = y + 0.3 * jnp.concatenate([x[1:], jnp.zeros((1,))])
        return y + 0.3 * jnp.concatenate([jnp.zeros((1,)), x[:-1]])

    mesh = Mesh(np.array(jax.devices()[:D]), ("d",))
    body = jax.shard_map(
        lambda d_loc, v_loc: jdd.lanczos_sqrt_apply_dd(lambda x: mv_loc_j(d_loc, x), v_loc,
                                                       12, "d"),
        mesh=mesh, in_specs=(P("d"), P("d")), out_specs=P("d"), check_vma=False)
    want = np.asarray(jax.jit(body)(jnp.asarray(diag), jnp.asarray(v)))
    ref, _ = jax.jit(lambda x: j_lanczos(
        lambda y: jnp.concatenate([mv_loc_j(jnp.asarray(diag[k_loc * s:k_loc * (s + 1)]),
                                            y[k_loc * s:k_loc * (s + 1)]) for s in range(D)]),
        x, m=12))(jnp.asarray(v))

    d_sh = [torch.from_numpy(a) for a in np.split(diag, D)]

    def mv(xs):
        out = []
        for d_loc, x in zip(d_sh, xs):
            y = d_loc * x
            y = y + 0.3 * torch.cat([x[1:], torch.zeros(1, dtype=x.dtype)])
            out.append(y + 0.3 * torch.cat([torch.zeros(1, dtype=x.dtype), x[:-1]]))
        return out

    got = np.concatenate([t.numpy() for t in pse_dd.lanczos_sqrt_apply_dd(
        mv, [torch.from_numpy(a) for a in np.split(v, D)], 12)])
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6)


def test_step_t0_matches_single_grid(system):
    """T = 0: the composed step against the port's single-grid step on the
    same pack (tests/test_pse_dd.py:52-88, which holds JAX's the same way;
    the T = 1 test below holds the port's composed step to JAX's)."""
    pos, be_t, _, _, mesh_t = system
    g = lj_g_fused(1.0, SIGMA, rc2=RC2)
    step = pse_dd.make_sharded_pse_em_step(mesh_t, be_t, g_pair=g, dt=DT, temperature=0.0, n=N)
    p_t, f_t, ovf_t = step(torch.from_numpy(pos))
    assert not bool(ovf_t)
    dx_ref, f_ref, ovf = be_t.displacement_with_pair_force(
        be_t.make_pair_force_slots(g), torch.from_numpy(pos), torch.Generator(), DT, 0.0)
    assert not bool(ovf)
    fscale = float(f_ref.abs().max())
    assert fscale > 1.0, "dimers in contact"
    np.testing.assert_allclose(f_t.numpy(), f_ref.numpy(), atol=1e-4 * max(fscale, 1.0), rtol=0)
    d = p_t - be_t.box.wrap_position(torch.from_numpy(pos) + dx_ref)
    d = d - L * torch.round(d / L)
    assert float(d.abs().max()) < 2e-4 * max(float(dx_ref.abs().max()), 1.0)


def test_step_t0_matches_jax(system):
    """T = 0: JAX's composed step (one compile at backend optimisation
    level 0) and the port's, from the same positions: forces within 1e-4
    max(fscale, 1), positions within 2e-4 max(dscale, 1)."""
    pos, be_t, be_j, mesh_j, mesh_t = system
    key = jax.random.key(0)
    g_j = j_lj_g_fused(1.0, SIGMA, rc2=RC2, approx=False)
    j_step = jdd.make_sharded_pse_em_step(mesh_j, be_j, g_pair=g_j, dt=DT, temperature=0.0,
                                          n=N, axis="d")
    p_in = jnp.asarray(pos)
    p_j, f_j, ovf_j = (np.asarray(a) for a in _jit0(j_step, p_in, key)(p_in, key))
    assert not bool(ovf_j)
    step = pse_dd.make_sharded_pse_em_step(mesh_t, be_t, g_pair=lj_g_fused(1.0, SIGMA, rc2=RC2),
                                           dt=DT, temperature=0.0, n=N)
    p_t, f_t, ovf_t = step(torch.from_numpy(pos))
    assert not bool(ovf_t)
    fscale = np.abs(f_j).max()
    assert fscale > 1.0, "dimers in contact"
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=1e-4 * max(fscale, 1.0), rtol=0)
    dx_j = p_j - pos
    dx_j -= L * np.round(dx_j / L)
    d = p_t.numpy() - p_j
    d -= L * np.round(d / L)
    assert np.abs(dx_j).max() > 1e-3, "the dimers move"
    assert np.abs(d).max() < 2e-4 * max(np.abs(dx_j).max(), 1.0), np.abs(d).max()


def test_step_t1_matches_jax_with_its_draws(system):
    """T = 1: JAX's step (one compile at backend optimisation level 0)
    against the port's ``step_z`` fed JAX's near start block and far white
    noise (``split(key)``, ``fold_in(k_far, shard)``): forces within 1e-4
    max(fscale, 1), positions within 2e-4 max(dscale, 1); then one step
    with draws from a generator lands in test_pse_dd.py:158-164's band."""
    pos, be_t, be_j, mesh_j, mesh_t = system
    key = jax.random.key(3)
    g_j = j_lj_g_fused(1.0, SIGMA, rc2=RC2, approx=False)
    j_step = jdd.make_sharded_pse_em_step(mesh_j, be_j, g_pair=g_j, dt=DT, temperature=1.0,
                                          n=N, axis="d")
    p_in = jnp.asarray(pos)
    p_j, f_j, ovf_j = (np.asarray(a) for a in _jit0(j_step, p_in, key)(p_in, key))
    assert not bool(ovf_j)
    nx, ny, nz = be_t.far.shape
    shape = (3,) + be_t.spec.array_shape

    def draws(k):
        k_far, k_near = jax.random.split(k)
        far = [jax.random.normal(jax.random.fold_in(k_far, i), (nx // D, ny, nz, 3),
                                 jnp.float32) for i in range(D)]
        return jax.random.normal(k_near, shape, jnp.float32), jnp.stack(far)

    n0, far = (np.array(a) for a in jax.jit(draws)(key))
    step = pse_dd.make_sharded_pse_em_step(mesh_t, be_t, g_pair=lj_g_fused(1.0, SIGMA, rc2=RC2),
                                           dt=DT, temperature=1.0, n=N)
    p_t, f_t, ovf_t = step.step_z(torch.from_numpy(pos), torch.from_numpy(n0),
                                  [torch.from_numpy(a) for a in far])
    assert not bool(ovf_t) and bool(torch.isfinite(p_t).all())
    fscale = np.abs(f_j).max()
    assert fscale > 1.0, "dimers in contact"
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=1e-4 * max(fscale, 1.0), rtol=0)
    dx_j = p_j - pos
    dx_j -= L * np.round(dx_j / L)
    d = p_t.numpy() - p_j
    d -= L * np.round(d / L)
    assert np.abs(d).max() < 2e-4 * max(np.abs(dx_j).max(), 1.0), np.abs(d).max()
    # the step with draws from a generator moves the particles by the
    # Brownian scale (test_pse_dd.py:158-164's band, for one step)
    p, _, ovf = step(torch.from_numpy(pos), torch.Generator().manual_seed(5))
    assert not bool(ovf)
    disp = (p - torch.from_numpy(pos)).numpy()
    disp -= L * np.round(disp / L)
    expected = math.sqrt(2.0 * 1.0 / (6.0 * math.pi) * DT)
    rms = float(np.sqrt((disp ** 2).sum(axis=1).mean()))
    assert 0.2 * expected < rms < 8.0 * expected, (rms, expected)


def test_step_checks_its_backend(system):
    _, be_t, _, _, mesh_t = system
    import dataclasses

    with pytest.raises(ValueError, match="without stragglers"):
        pse_dd.ShardedPSEStep(mesh_t, dataclasses.replace(
            be_t, spec=dataclasses.replace(be_t.spec, n_strag=4)), dt=DT, temperature=0.0, n=N)
    with pytest.raises(ValueError, match="must divide"):
        pse_dd.ShardedPSEStep(make_mesh(3, devices=["cpu"] * 3), be_t, dt=DT, temperature=0.0,
                              n=N)
    with pytest.raises(TypeError, match="fused LJ radial"):
        tp.RadialForce(tp.LJRadial())
