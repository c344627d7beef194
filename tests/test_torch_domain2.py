"""The port's domain-decomposed v2 engine (uammd_tpu_torch.parallel.domain2)
against the JAX package's (uammd_tpu/parallel/domain2.py, Pallas kernels in
interpret mode on 4 of the 8 virtual CPU devices) and against the port's
single-chip engine, on tests/test_domain2.py:25's clump system (n 2400,
L 48, 24 straggler rows per shard).

- JAX and the port, 4 shards, 2 steps at T = 0 from one state: positions
  and velocities by pid within 1e-5 (tests/test_domain2.py:115-116);
- the port on 2 and 8 shards against ``_single_chip_md2`` through a
  drift-triggered cross-shard rebin (6 steps): positions within 1e-4,
  velocities within 5e-4 (tests/test_domain2.py:93-94: the clump is
  chaotic and amplifies float32 ordering differences);
- a T = 1 run on 4 shards conserves the particles and stays finite;
- ``choose_spec(nz_multiple=...)`` builds JAX's spec.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from uammd_tpu.engine import layout as jl
from uammd_tpu.parallel import domain2 as jdd
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.parallel import domain2 as dd
from uammd_tpu_torch.parallel.mesh import make_mesh

from test_torch_halo_kernels import clump_system

N, L = 2400, 48.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small plain-torch runs gain nothing from more threads, and the
    test tier runs files in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(n_dev, dt, temperature=0.0):
    pos, vel = clump_system(N, L)
    spec = tl.choose_spec((L, L, L), N, 2.5, skin=1.2, pos=pos, n_strag=24,
                          nz_multiple=n_dev)
    assert spec.shape[2] % n_dev == 0 and spec.shape[2] // n_dev >= 2
    md = dd._single_chip_md2(spec, 1.0, 1.0, dt, temperature, 1.0, 1.0, False, "cpu")
    gs = md.init(pos, vel=vel)
    assert int((gs.spid >= 0).sum()) > 0, "want stragglers"
    return md, gs, spec, pos


def test_dd2_matches_jax_two_steps():
    n_dev, dt = 4, 0.05
    md, gs, spec, _ = _setup(n_dev, dt)
    mesh = make_mesh(n_dev, devices=["cpu"] * n_dev)
    arrays = dd.md2_shards_to_numpy(dd.shard_md2_state(md, gs, mesh))
    st = dd.md2_shards_from_numpy(arrays, mesh)
    np.testing.assert_array_equal(dd.md2_shards_to_numpy(st)[0], arrays[0])
    step = dd.make_domain_md2_step(mesh, spec, dt=dt, temperature=0.0, n_total=N)
    st = step(step(st))
    p2, v2 = dd.gather_md2_state(st, spec, N)

    jmesh = Mesh(np.array(jax.devices()[:n_dev]), ("z",))
    sharding = NamedSharding(jmesh, P("z"))
    keys = jax.vmap(jax.random.key_data)(jax.random.split(jax.random.key(0), n_dev))
    jstate = tuple(jax.device_put(jnp.asarray(a), sharding) for a in arrays) + (
        jax.device_put(keys, sharding),)
    jspec = jl.GridSpec(**{f: getattr(spec, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")})
    jstep, _ = jdd.make_domain_md2_step(jmesh, jspec, dt=dt, temperature=0.0, friction=1.0,
                                        n_total=N)
    jstate = jstep(*jstep(*jstate))
    p1, v1 = jdd.gather_md2_state(jstate, jspec, N)
    assert float(np.asarray(jstate[18]).max()) == 0.0
    assert max(float(o) for o in st.ovf) == 0.0
    np.testing.assert_allclose(p2, p1, atol=1e-5)
    np.testing.assert_allclose(v2, v1, atol=1e-5)


@pytest.mark.parametrize("n_dev", [8, 2])
def test_dd2_matches_single_chip_through_rebin(n_dev):
    """n_dev == 2 takes its own branch (the up and down neighbour are one
    shard: its straggler list enters the straggler pairs once)."""
    dt, steps = 0.05, 6
    md, gs, spec, pos = _setup(n_dev, dt)
    g1 = md.run(gs, steps)
    assert not bool(g1.overflow)
    p1, v1, _ = (t.numpy() for t in tl.unpack(g1))
    mesh = make_mesh(n_dev, devices=["cpu"] * n_dev)
    step = dd.make_domain_md2_step(mesh, spec, dt=dt, temperature=0.0, n_total=N)
    st = dd.shard_md2_state(md, gs, mesh)
    for _ in range(steps):
        st = step(st)
    assert max(float(o) for o in st.ovf) == 0.0, "overflow/lost"
    assert step.rebins >= 1
    p2, v2 = dd.gather_md2_state(st, spec, N)
    np.testing.assert_allclose(p2, p1, atol=1e-4)
    np.testing.assert_allclose(v2, v1, atol=5e-4)
    # the run crossed the drift threshold (unwrapped displacement)
    d = p2 - pos
    d -= L * np.round(d / L)
    assert np.abs(d).max() > spec.drift_threshold


def test_dd2_single_shard_matches_single_chip():
    """A 1-shard mesh rebins with the separable kernel's plain version:
    the single-chip engine plus the halo machinery."""
    dt, steps = 0.05, 6
    md, gs, spec, _ = _setup(1, dt)
    p1, v1, _ = (t.numpy() for t in tl.unpack(md.run(gs, steps)))
    mesh = make_mesh(1, devices=["cpu"])
    step = dd.make_domain_md2_step(mesh, spec, dt=dt, temperature=0.0, n_total=N)
    st = dd.shard_md2_state(md, gs, mesh)
    for _ in range(steps):
        st = step(st)
    assert step.rebins >= 1 and float(st.ovf[0]) == 0.0
    p2, v2 = dd.gather_md2_state(st, spec, N)
    np.testing.assert_allclose(p2, p1, atol=1e-4)
    np.testing.assert_allclose(v2, v1, atol=5e-4)


def test_dd2_thermal_run_conserves_particles():
    """T = 1 on 4 shards for 20 steps (tests/test_domain2.py:119-143 runs
    40): every particle kept across rebins, the state finite, the
    w-velocities in the test's thermal band."""
    n_dev, dt = 4, 0.02
    md, gs, spec, _ = _setup(n_dev, dt, temperature=1.0)
    mesh = make_mesh(n_dev, devices=["cpu"] * n_dev)
    step = dd.make_domain_md2_step(mesh, spec, dt=dt, temperature=1.0, n_total=N)
    st = dd.shard_md2_state(md, gs, mesh, seed=3)
    assert len({int(s) for s in st.stepc}) == n_dev  # decorrelated noise seeds
    for _ in range(20):
        st = step(st)
    assert step.rebins >= 1
    assert max(float(o) for o in st.ovf) == 0.0
    total = sum(int((p > 0.5).sum()) + int((s > 0.5).sum()) for p, s in zip(st.pidf, st.spidf))
    assert total == N
    p2, v2 = dd.gather_md2_state(st, spec, N)
    assert np.isfinite(p2).all() and np.isfinite(v2).all()
    assert 0.4 < float((v2 ** 2).mean()) < 2.5


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_choose_spec_nz_multiple_matches_jax(n_dev):
    pos, _ = clump_system(N, L)
    kw = dict(skin=1.2, pos=pos, n_strag=24, nz_multiple=n_dev)
    t = tl.choose_spec((L, L, L), N, 2.5, **kw)
    j = jl.choose_spec((L, L, L), N, 2.5, **kw)
    assert t == tl.GridSpec(**{f: getattr(j, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")})
    assert t.shape[2] % n_dev == 0
    # bench.py's box on 4 shards: nz 42 -> 40
    assert tl.choose_spec(128.0, 1 << 20, 2.5, nz_multiple=4).shape[2] == 40
    with pytest.raises(ValueError, match="too small"):
        tl.choose_spec(8.0, 100, 2.5, nz_multiple=4)
