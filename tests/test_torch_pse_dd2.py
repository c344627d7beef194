"""The port's composed multi-shard PSE step v2 (uammd_tpu_torch.parallel.
pse_dd2) against the JAX package's (uammd_tpu/parallel/pse_dd2.py), on
__graft_entry__.py strategy 8's system at n 2048: fcc sites at volume
fraction 0.05 and 18 particles 1.5 apart in the near grid's centre cell,
which overfills it past CAP, so real straggler rows ride every pass (the
per-shard budget S is 16 here, against strategy 8's 64: 10 rows are used,
and the plain versions' cost grows with the combined list).

- #2 in the halo mode with the combined own + neighbour straggler rows, with
  the PSE functor (pse_dd2.py:110-113) and with the radial WCA force
  (pse_dd2.py:119-127), on every shard of a 4-shard mesh, against the JAX
  kernels in interpret mode: the grids and the straggler totals over the
  slab's interior rows within 2e-5 of max|out| (tests/test_pse_engine.py:573's
  bar), and the straggler block's per-row partials against JAX's
  per-program partials;
- ``pse_dd2_state_from_numpy`` of JAX's ``make_state`` equal to the port's
  ``make_state``, and the round trip;
- the T = 0 trajectory through a forced shard-local rebin on 4 and 2
  shards against the port's single-grid PSE step (2 + 2 steps: positions
  within 1e-4, tests/test_pse_dd2.py:113-115), as test_pse_dd2.py holds
  JAX's; the single-grid step is held to JAX by test_torch_pse_engine.py;
- a far bucket far below its load latches ``ovf`` (test_pse_dd2.py:136-148);
- one T = 1 step against JAX's from JAX's ``make_state``, JAX's own draws
  (``split(key, 3)`` into the far key, ``noise_g`` and ``noise_s``;
  ``fold_in(k_far, shard)`` for the far white noise, pse_dd2.py:493-508 and
  spectral.py:155) fed to the port's ``step_z``: positions and straggler
  rows within 2e-4 max(dscale, 1) (tests/test_pse_dd.py:80-88's bar), so
  the straggler noise rows, the Lanczos over slots and rows, the routed
  partials and the noisy far field are all held to JAX.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from uammd_tpu.engine.layout import GridSpec as JGridSpec
from uammd_tpu.engine.md import lj_g_fused as j_lj_g_fused
from uammd_tpu.engine.pair_kernel import make_pair_channel_kernel as j_make_channel
from uammd_tpu.parallel import pse_dd2 as jdd2
from uammd_tpu.utils.lattices import lattice
from uammd_tpu_torch.core.box import box as t_box
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import pair_kernel as tp
from uammd_tpu_torch.engine.md import lj_g_fused
from uammd_tpu_torch.engine.pse_near import strag_channel_block, strag_row_totals
from uammd_tpu_torch.integrators.bdhi.pse_engine import PSEGrid
from uammd_tpu_torch.parallel import pse_dd2
from uammd_tpu_torch.parallel.domain import halo_extend
from uammd_tpu_torch.parallel.mesh import make_mesh

from test_torch_pse_dd import _jit0, jax_backend

N, S, FAR, TOL_NEAR = 2048, 16, 120, 1e-2
L = (N * (4.0 / 3.0) * math.pi / 0.05) ** (1.0 / 3.0)
RC2 = (2.0 ** (1.0 / 6.0) * 2.0) ** 2
DT = 1e-4
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _backend(pos, n_strag=S):
    return PSEGrid.create(t_box(L, device="cpu"), N, viscosity=1.0, radius=1.0, far_grid=FAR,
                          tolerance=TOL_NEAR, lanczos_iterations=4, pos=pos, n_strag=n_strag,
                          nz_multiple=4)


def clump_system(shape):
    """__graft_entry__.py strategy 8: the clump sits inside the centre cell
    of the near grid ``shape`` (the one the fcc sites give)."""
    sites = np.asarray(lattice(N, L, "fcc"))
    sh = np.asarray(shape)
    center = (sh // 2 + 0.5) / sh * L - 0.5 * L
    gx, gy, gz = np.meshgrid(*[np.arange(3) * 1.5] * 2, np.arange(2) * 1.5)
    clump = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    clump = clump - clump.mean(axis=0) + center
    lo, hi = clump.min(axis=0) - 2.4, clump.max(axis=0) + 2.4
    sites = sites[~np.all((sites > lo) & (sites < hi), axis=1)][: N - len(clump)]
    pos = np.concatenate([sites, clump]).astype(np.float32)
    return pos - np.float32(L) * np.round(pos / np.float32(L))


@pytest.fixture(scope="module")
def system():
    probe = _backend(np.asarray(lattice(N, L, "fcc"), np.float32))
    pos = clump_system(probe.spec.shape)
    # PSEGrid.create's near spec for these positions (pse_engine.py:197-199),
    # without a second fit of the same constants
    spec = tl.choose_spec(probe.spec.box_size, N, probe.rcut, skin=1.0, pos=pos, n_strag=S,
                          strag_cell_excess=1 << 30, strag_headroom=1.5, ocap=None,
                          nz_multiple=4)
    assert spec.shape == probe.spec.shape
    be = dataclasses.replace(probe, spec=spec)
    assert be.spec.shape[2] % 4 == 0 and be.spec.shape[2] // 4 >= 2
    return pos, be


@pytest.fixture(scope="module")
def jax_state(system):
    """JAX's ``make_state`` of the system on a 4-device mesh: (the JAX
    backend, the mesh, the 12 state arrays)."""
    pos, be = system
    be_j = jax_backend(be, L)
    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    _, make_state = jdd2.make_sharded_pse_em_step2(
        mesh, be_j, g_pair=j_lj_g_fused(1.0, 2.0, rc2=RC2, approx=False), dt=DT,
        temperature=0.0, n=N, axis="d")
    return be_j, mesh, make_state(jnp.asarray(pos))


@pytest.fixture(scope="module")
def single_grid_trajectory(system):
    """The port's single-grid T = 0 step, 4 steps from the system."""
    pos, be = system
    fs = be.make_pair_force_slots(lj_g_fused(1.0, 2.0, rc2=RC2))
    p = torch.from_numpy(pos)
    for _ in range(4):
        dx, _, ovf = be.displacement_with_pair_force(fs, p, torch.Generator(), DT, 0.0)
        assert not bool(ovf)
        p = be.box.wrap_position(p + dx)
    return p.numpy()


def _step(be, n_dev, temperature=0.0, **kw):
    return pse_dd2.make_sharded_pse_em_step2(
        make_mesh(n_dev, devices=["cpu"] * n_dev), be, g_pair=lj_g_fused(1.0, 2.0, rc2=RC2),
        dt=DT, temperature=temperature, n=N, **kw)


def test_halo_modes_with_combined_rows_match_jax(system):
    pos, be = system
    step = _step(be, 4)
    st = step.make_state(pos)
    assert sum(int((s > 0.5).sum()) for s in st.spidf) > 0, "want straggler rows"
    Lz = be.spec.box_size[2]
    ext = [halo_extend(st.x), halo_extend(st.y), halo_extend(st.z, -Lz, Lz)]
    comb = step.combined_strag(st.spos, st.spidf)
    rng = np.random.default_rng(2)
    masks = [(p > 0.5).to(torch.float32) for p in st.pidf]
    g3 = [torch.from_numpy(rng.normal(size=(3,) + tuple(m.shape)).astype(np.float32)) * m
          for m in masks]
    sg3 = [torch.from_numpy(rng.normal(size=(3, S)).astype(np.float32)) * (s > 0.5)
           for s in st.spidf]
    hg = halo_extend(g3, dim=1)
    cr = step.comb_rows(sg3)
    local_j = JGridSpec(**{f: getattr(step.local_spec, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")})
    be_j = jax_backend(be, L)
    pf, pbf = be_j._pair_fn()
    g_j = j_lj_g_fused(1.0, 2.0, rc2=RC2, approx=False)

    def force_fn(r2, dx, dy, dz, ci, cj):
        g = g_j(r2)
        return g * dx, g * dy, g * dz

    def force_both(r2, dx, dy, dz, ci, cj):
        g = g_j(r2)
        return (g * dx, g * dy, g * dz), (-g * dx, -g * dy, -g * dz)

    kern = {"pse": j_make_channel(local_j, pf, 3, 3, pair_both_fn=pbf, interpret=True,
                                  periodic_z=False),
            "radial": j_make_channel(local_j, force_fn, 0, 3, pair_both_fn=force_both,
                                     interpret=True, periodic_z=False)}
    compiled = {}
    for i in range(4):
        xyz = [a[i] for a in ext]
        for mode in ("pse", "radial"):
            ch = [hg[i][c] for c in range(3)] if mode == "pse" else []
            blk = step.bblock(comb[i], tuple(cr[i]) if mode == "pse" else ())
            args = [jnp.asarray(t.numpy()) for t in xyz + ch]
            sj = jnp.asarray(blk.contiguous().numpy())
            if mode not in compiled:
                compiled[mode] = _jit0(lambda *a, k=kern[mode]: k(*a[:-1], strag=a[-1]),
                                       *args, sj)
            want = [np.asarray(a) for a in compiled[mode](*args, sj)]
            fn = step.near_fn if mode == "pse" else step.force_fn
            got = tp.make_pair_channel_kernel(step.local_spec, fn, periodic_z=False)(
                *xyz, *ch, strag=blk)
            scale = max(max(np.abs(a).max() for a in want[:3]), 1e-30)
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_allclose(a.numpy(), b, atol=TOL * scale, rtol=0)
            for a, b in zip(got[3:], want[3:]):
                np.testing.assert_allclose(a.numpy(), b[1:-1].sum(axis=(0, 1, 3)),
                                           atol=TOL * scale, rtol=0)
            if mode == "pse":  # the straggler block's per-row partials
                xi, yi, zi = (a[:, :, :, None, :] for a in xyz)
                _, rows = strag_channel_block(step.local_spec, fn.pair_fn(1), 3, xi, yi, zi,
                                              [c[:, :, :, None, :] for c in ch], blk[:, :, 0],
                                              per_row=True)
                for c in range(3):
                    np.testing.assert_allclose(rows[c].numpy(), want[3 + c].sum(axis=(1, 3)),
                                               atol=TOL * scale, rtol=0)
                np.testing.assert_allclose(strag_row_totals(rows, False).numpy(),
                                           np.stack([got[3 + c].numpy() for c in range(3)]),
                                           atol=TOL * scale, rtol=0)
            if mode == "radial" and i == 2:
                assert scale > 100.0, "the clump feels the WCA"


def test_state_from_numpy_matches_jax_make_state(system, jax_state):
    """JAX's ``make_state`` carried into the port: the 12 arrays round-trip
    exactly and gather to JAX's positions; the port's own ``make_state``
    deals the same straggler rows to the same shards and holds the same
    positions. (The fcc sites of this system lie on cell boundaries, where
    JAX's eager pack and the jitted one put a few particles in the
    neighbouring cell, so the slot layouts are compared through a step:
    one T = 0 step from each state lands the particles at the same
    positions.)"""
    pos, be = system
    be_j, _, state_j = jax_state
    arrays = [np.asarray(a) for a in state_j]
    step = _step(be, 4)
    st_j = pse_dd2.pse_dd2_state_from_numpy(arrays, step.mesh)
    for a, b in zip(pse_dd2.pse_dd2_state_to_numpy(st_j), arrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    p_j = pse_dd2.gather_positions(st_j, N)
    np.testing.assert_array_equal(p_j, jdd2.gather_positions(arrays, be_j.spec, N))
    st_t = step.make_state(pos)
    for k in ("spos", "spidf", "sref", "ovf", "n_rebin"):
        for a, b in zip(getattr(st_j, k), getattr(st_t, k)):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    np.testing.assert_allclose(pse_dd2.gather_positions(st_t, N), p_j, atol=1e-5, rtol=0)
    q_j = pse_dd2.gather_positions(step(st_j), N)
    q_t = pse_dd2.gather_positions(step(st_t), N)
    np.testing.assert_allclose(q_t, q_j, atol=1e-5, rtol=0)
    assert np.abs(q_t - p_j).max() > 1e-4, "the step moves the clump"


@pytest.mark.parametrize("n_dev", [4, 2])
def test_t0_trajectory_through_a_forced_rebin(system, single_grid_trajectory, n_dev):
    pos, be = system
    p = single_grid_trajectory
    step = _step(be, n_dev)
    st = step.make_state(pos)
    assert sum(int((s > 0.5).sum()) for s in st.spidf) > 0
    for _ in range(2):
        st = step(st)
    st = st.replace(rx=[r + 10.0 * be.spec.drift_threshold for r in st.rx])
    for _ in range(2):
        st = step(st)
    assert max(float(o) for o in st.ovf) == 0.0, "overflow/lost"
    assert min(int(r) for r in st.n_rebin) >= 1, "rebin never fired"
    assert sum(int((a > 0.5).sum()) + int((b > 0.5).sum())
               for a, b in zip(st.pidf, st.spidf)) == N
    d = pse_dd2.gather_positions(st, N) - p
    d -= L * np.round(d / L)
    assert np.abs(d).max() < 1e-4, np.abs(d).max()
    assert np.abs(p - pos).max() > 1e-3, "the clump moves"


def test_far_bucket_overflow_latches(system):
    pos, be = system
    step = _step(be, 4, far_m2=8)  # ~2048 / 16 = 128 needed per bucket on average
    st = step(step.make_state(pos))
    assert max(float(o) for o in st.ovf) > 0.0, "ovf should have latched"


def test_t1_step_with_given_draws(system, jax_state):
    """T = 1: JAX's step (one compile at backend optimisation level 0) from
    JAX's ``make_state``, and the port's ``step_z`` from the same 12 arrays
    fed JAX's draws: positions within 2e-4 max(dscale, 1), the straggler
    rows among them."""
    pos, be = system
    be_j, mesh, state_j = jax_state
    j_step, _ = jdd2.make_sharded_pse_em_step2(
        mesh, be_j, g_pair=j_lj_g_fused(1.0, 2.0, rc2=RC2, approx=False), dt=DT,
        temperature=1.0, n=N, axis="d")
    key = jax.random.key(7)
    out_j = [np.asarray(a) for a in _jit0(j_step, state_j, key)(state_j, key)]
    nx, ny, nz = be.far.shape
    shape = (3,) + be.spec.array_shape

    def draws(k):
        k_far, k_g, k_s = jax.random.split(k, 3)
        far = [jax.random.normal(jax.random.fold_in(k_far, i), (nx // 4, ny, nz, 3),
                                 jnp.float32) for i in range(4)]
        return (jax.random.normal(k_g, shape, jnp.float32),
                jax.random.normal(k_s, (3, 4 * S), jnp.float32), jnp.stack(far))

    ng, ns, far = (torch.from_numpy(np.array(a)) for a in jax.jit(draws)(key))
    step = _step(be, 4, temperature=1.0)
    st0 = pse_dd2.pse_dd2_state_from_numpy([np.asarray(a) for a in state_j], step.mesh)
    st1 = step.step_z(st0, ng, ns, list(far))
    assert max(float(o) for o in st1.ovf) == 0.0 and float(out_j[10].max()) == 0.0
    p0 = pse_dd2.gather_positions(st0, N)
    p_j = jdd2.gather_positions(out_j, be_j.spec, N)
    p_t = pse_dd2.gather_positions(st1, N)
    assert np.isfinite(p_t).all()
    dx_j = p_j - p0
    dx_j -= L * np.round(dx_j / L)
    bar = 2e-4 * max(np.abs(dx_j).max(), 1.0)
    assert np.abs(dx_j).max() > 1e-3, "the step moves the particles"
    d = p_t - p_j
    d -= L * np.round(d / L)
    assert np.abs(d).max() < bar, np.abs(d).max()
    # the straggler rows, slot for slot
    rows = out_j[8] > 0.5
    assert rows.sum() > 0, "want straggler rows"
    st_t = pse_dd2.pse_dd2_state_to_numpy(st1)
    np.testing.assert_array_equal(st_t[8], out_j[8])
    ds = st_t[7][rows] - out_j[7][rows]
    assert np.abs(ds).max() < bar, np.abs(ds).max()
    assert np.abs(out_j[7][rows] - np.asarray(state_j[7])[rows]).max() > 1e-4, \
        "the straggler rows move"
