"""The port's domain-decomposed v1, DPD and SPH engines
(uammd_tpu_torch.parallel.domain) on an 8-shard CPU mesh against the
port's own single-chip engines, at the tolerances of the JAX package's
tests of the same pairing (tests/test_parallel.py, test_parallel_channel.py;
float32 sums in another order). Each kernel's halo mode is held against
the JAX kernel in tests/test_torch_halo_kernels.py."""

import numpy as np
import pytest
import torch

from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.dpd import GridDPD
from uammd_tpu_torch.engine.md import make_lj_md
from uammd_tpu_torch.engine.sph import GridSPH
from uammd_tpu_torch.interactors.sph import SPHParams
from uammd_tpu_torch.parallel import domain as dd
from uammd_tpu_torch.parallel.mesh import make_mesh
from uammd_tpu_torch.utils.lattices import lattice

N_DEV = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small plain-torch runs gain nothing from more threads, and the
    test tier runs files in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, devices=["cpu"] * N_DEV)


def _unshard(gs, st):
    """A single-chip GridState holding the sharded grids (the same spec)."""
    cat = {k: torch.cat(getattr(st, k)) for k in ("x", "y", "z", "vx", "vy", "vz",
                                                   "fx", "fy", "fz")}
    if st.pidf is not None:
        cat["pid"] = torch.cat(st.pidf).to(torch.int32) - 1
    return gs.replace(**cat)


def _lj_system(seed):
    rng = np.random.default_rng(seed)
    n, L = 1200, 24.0  # 8^3 cells: nz = 8 divides the 8-shard mesh
    pos = lattice(n, L, "fcc") + rng.normal(0, 0.05, (n, 3))
    md = make_lj_md(L, n, dt=0.004, temperature=0.0, device="cpu")
    assert md.spec.shape[2] % N_DEV == 0
    return md, md.init(pos, seed=0)


def test_domain_v1_matches_single_chip_nve(mesh):
    """T = 0, friction 0: three halo-exchange steps reproduce GridMD.step_nve
    (test_parallel.py:23-66, atol 1e-5)."""
    md, gs = _lj_system(0)
    gen = torch.Generator().manual_seed(5)
    vel = [0.3 * torch.randn(gs.x.shape, generator=gen) * gs.mask for _ in range(3)]
    gs = md.compute_forces(gs.replace(vx=vel[0], vy=vel[1], vz=vel[2]))
    g1 = gs
    for _ in range(3):
        g1 = md.step_nve(g1)
    p1, v1, _ = (t.numpy() for t in tl.unpack(g1))
    step = dd.make_domain_md_step(mesh, md.spec, dt=0.004, temperature=0.0, friction=0.0)
    st = dd.shard_grid_state(gs, mesh)
    for _ in range(3):
        st = step(st)
    p2, v2, _ = (t.numpy() for t in tl.unpack(_unshard(gs, st)))
    np.testing.assert_allclose(p2, p1, atol=1e-5)
    np.testing.assert_allclose(v2, v1, atol=1e-5)


def test_domain_v1_rebin_matches_single_chip_rebin(mesh):
    """A drift under one cell, then one step at dt 0: the cross-shard rebin
    puts every particle where layout.rebin does (test_parallel.py:85-141),
    and the run with the rebin follows GridMD.step_nve."""
    md, gs = _lj_system(1)
    gen = torch.Generator().manual_seed(9)
    d = [torch.clamp(1.2 * torch.randn(gs.x.shape, generator=gen), -1.4, 1.4) * gs.mask
         for _ in range(3)]
    vel = [0.5 * torch.randn(gs.x.shape, generator=gen) * gs.mask for _ in range(3)]
    moved = gs.replace(x=gs.x + d[0], y=gs.y + d[1], z=gs.z + d[2], vx=vel[0], vy=vel[1],
                       vz=vel[2])
    pr, vr, _ = (t.numpy() for t in tl.unpack(tl.rebin(moved)))
    step = dd.make_domain_md_step2(mesh, md.spec, dt=0.0, temperature=0.0, friction=0.0,
                                   n_total=gs.n)
    st = dd.shard_grid_state2(moved, mesh)
    st = st.replace(rx=[a.clone() for a in dd.shard_grid_state2(gs, mesh).x],
                    ry=dd.shard_grid_state2(gs, mesh).y, rz=dd.shard_grid_state2(gs, mesh).z)
    st = step(st)
    assert step.rebins == 1
    assert max(float(o) for o in st.ovf) == 0.0, "overflow/lost particles"
    p2, v2, _ = dd.gather_grid_shards(st, gs.n)
    np.testing.assert_allclose(p2, pr, atol=1e-5)
    np.testing.assert_allclose(v2, vr, atol=1e-6)


def _dpd_system(seed=0):
    rng = np.random.default_rng(seed)
    n, L = 1200, 24.0
    pos = np.asarray(lattice(n, L, "fcc")) + 0.03 * rng.standard_normal((n, 3))
    vel = 0.5 * rng.standard_normal((n, 3))
    # rc 2.5 x skin 1.1 = 2.75: nz = 8 cells
    md = GridDPD.create(L, n, rc=2.5, A=10.0, gamma=2.0, temperature=1.0, dt=0.01,
                        device="cpu")
    assert md.spec.shape[2] % N_DEV == 0
    return md, md.init(pos.astype(np.float32), vel=vel.astype(np.float32))


DPD_KW = dict(rc=2.5, A=10.0, gamma=2.0, temperature=1.0)


def test_domain_dpd_matches_single_chip():
    """Three steps on 4 shards without a rebin reproduce GridDPD (the same
    counter hash): test_parallel_channel.py:41-70's tolerances."""
    md, gs = _dpd_system()
    mesh = make_mesh(4, devices=["cpu"] * 4)
    g1 = md.run(gs, 3)
    p1, v1, f1 = (t.numpy() for t in tl.unpack(g1))
    step = dd.make_domain_dpd_step(mesh, md.spec, dt=0.01, n_total=gs.n, **DPD_KW)
    st = dd.shard_channel_state(gs, mesh)
    for _ in range(3):
        st = step(st)
    assert max(float(o) for o in st.ovf) == 0.0
    p2, v2, f2 = dd.gather_grid_shards(st, gs.n)
    np.testing.assert_allclose(p2, p1, atol=1e-5)
    np.testing.assert_allclose(v2, v1, atol=1e-5)
    np.testing.assert_allclose(f2, f1, atol=1e-4)


def test_domain_dpd_migrations_conserve_momentum():
    """3 steps at dt 0.05 on 4 shards, through a cross-shard rebin: no
    particle lost, and the total momentum kept to 1e-4 of sum |v| (the pair
    force, noise included, is antisymmetric across shard boundaries too;
    test_parallel_channel.py:73-110 runs 40 steps at dt 0.02 on 8)."""
    md, gs = _dpd_system(seed=3)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    step = dd.make_domain_dpd_step(mesh, md.spec, dt=0.05, n_total=gs.n, **DPD_KW)
    st = dd.shard_channel_state(gs, mesh)

    def momentum(s):
        return np.array([float(sum(a.sum() for a in getattr(s, k))) for k in ("vx", "vy", "vz")])

    p0 = momentum(st)
    for _ in range(3):
        st = step(st)
    assert step.rebins >= 1
    assert max(float(o) for o in st.ovf) == 0.0
    assert sum(int((p > 0.5).sum()) for p in st.pidf) == gs.n
    vscale = sum(float(sum(a.abs().sum() for a in getattr(st, k))) for k in ("vx", "vy", "vz"))
    assert np.abs(momentum(st) - p0).max() < 1e-4 * vscale
    assert all(bool(a.isfinite().all()) for a in st.x)


def test_domain_sph_matches_single_chip(mesh):
    """Two halo rounds per step (density, then the exchanged P/rho^2):
    three steps reproduce GridSPH (test_parallel_channel.py:120-147)."""
    rng = np.random.default_rng(1)
    n, L = 1024, 24.0
    pos = np.asarray(lattice(n, L, "sc")) + 0.02 * rng.standard_normal((n, 3))
    vel = 0.1 * rng.standard_normal((n, 3))
    params = SPHParams(support=1.5, viscosity=5.0, gas_stiffness=10.0, rest_density=0.08)
    md = GridSPH.create(L, n, params, dt=0.005, skin=1.0, device="cpu")
    assert md.spec.shape[2] % N_DEV == 0
    gs = md.init(pos.astype(np.float32), vel=vel.astype(np.float32))
    p1, v1, f1 = (t.numpy() for t in tl.unpack(md.run(gs, 3)))
    step = dd.make_domain_sph_step(mesh, md.spec, params, dt=0.005, n_total=n)
    st = dd.shard_channel_state(gs, mesh)
    for _ in range(3):
        st = step(st)
    assert max(float(o) for o in st.ovf) == 0.0
    p2, v2, f2 = dd.gather_grid_shards(st, n)
    np.testing.assert_allclose(p2, p1, atol=1e-5)
    np.testing.assert_allclose(v2, v1, atol=1e-5)
    np.testing.assert_allclose(f2, f1, atol=1e-4)


def test_bin_columns_serves_the_domain_rebins():
    """``layout._bin_columns`` as the DD rebins use it (domain.py:207,
    domain2.py:338): an entry keyed at or past ``ncell`` ("not mine") is
    dropped, and with ``n_strag`` 0 any entry past CAP latches overflow."""
    spec = tl.GridSpec(box_size=(9.0, 9.0, 9.0), shape=(3, 3, 3), cap=2, fold=1, cutoff=2.5,
                       skin=1.2)
    ncell = spec.n_cells
    key = torch.tensor([0, 0, ncell, ncell + 5, 4])
    col = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    binned, strag, ovf = tl._bin_columns(spec, key, (col,), (0.0,))
    assert not bool(ovf) and strag[0].numel() == 0
    assert sorted(binned[0][binned[0] > 0].tolist()) == [1.0, 2.0, 5.0]
    _, _, ovf = tl._bin_columns(spec, torch.tensor([4, 4, 4]), (col[:3],), (0.0,))
    assert bool(ovf)
