"""The port's SPH engine (uammd_tpu_torch.engine.sph) and cubic-spline
kernel (uammd_tpu_torch.interactors.sph) against the JAX package's (the
channel kernel #2 in Pallas interpret mode on the CPU).

- ``cubic_spline_w`` and ``cubic_spline_gradw_over_r`` against JAX's at
  float32 round-off;
- density and force of tests/test_engine_sph.py:17's system (n 320, L 10,
  CAP 8) with that test's parameters: density within rtol 2e-5, atol 1e-6,
  force within 1e-4 of max|f| (test_engine_sph.py:55-63); both sides get
  the port's packed slots;
- momentum conserved over 5 port steps (test_engine_sph.py:66-79);
- ``gpu``: both CUDA functors against their plain versions, one launch each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine import sph as js
from uammd_tpu.interactors import sph as jsph
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import pair_kernel as tp
from uammd_tpu_torch.engine import sph as ts
from uammd_tpu_torch.interactors import sph as tsph
from uammd_tpu_torch.utils.lattices import lattice

N, L = 320, 10.0
PARAMS = dict(support=1.0, viscosity=10.0, gas_stiffness=30.0, rest_density=0.3)


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    pos = np.asarray(lattice(N, L, "fcc"))
    pos = pos + 0.05 * rng.standard_normal(pos.shape)
    return pos.astype(np.float32), (0.3 * rng.standard_normal((N, 3))).astype(np.float32)


def test_cubic_spline_matches_jax():
    """At float32 round-off; (1/r) dW/dr cancels to O(q) as r -> 0
    (-3 (2-q)^2 + 12 (1-q)^2), which amplifies a rounding difference (JAX
    contracts FMAs) by 1/q: from r = 0.1 on, within 1e-5."""
    r2 = np.linspace(1e-2, 4.5, 2001, dtype=np.float32)
    for h in (1.0, 0.7):
        hj = np.float32(h)
        want_w, want_g = jax.jit(lambda r: (jsph.cubic_spline_w(r, hj),
                                            jsph.cubic_spline_gradw_over_r(r, hj)))(r2)
        ht = torch.tensor(np.float32(h))
        got_w = tsph.cubic_spline_w(torch.from_numpy(r2), ht).numpy()
        got_g = tsph.cubic_spline_gradw_over_r(torch.from_numpy(r2), ht).numpy()
        np.testing.assert_allclose(got_w, np.asarray(want_w), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5, atol=1e-6)
    assert tsph.SPHParams(support=1.5).max_cutoff == jsph.SPHParams(support=1.5).max_cutoff


@pytest.fixture(scope="module")
def system():
    pos, vel = _setup()
    md_t = ts.GridSPH.create(L, N, ts.SPHParams(**PARAMS), dt=0.005, device="cpu")
    md_j = js.GridSPH.create(L, N, jsph.SPHParams(**PARAMS), dt=0.005, interpret=True)
    assert md_t.spec == tl.GridSpec(**{f: getattr(md_j.spec, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")})
    gt = tl.pack(md_t.spec, pos, vel=vel, device="cpu")
    fields = tl.grid_state_to_numpy(gt)
    gj = jl.GridState(spec=md_j.spec, n=N, key=jax.random.key(0),
                      **{k: jnp.asarray(fields[k]) for k in tl.STATE_FIELDS})
    rho_j, f_j = _jit0(lambda g: (md_j.density(g), md_j.compute_forces(g, g.vx, g.vy, g.vz)),
                       gj)(gj)
    return md_t, gt, np.asarray(rho_j), [np.asarray(a) for a in f_j]


def test_density_matches_jax(system):
    md_t, gt, rho_j, _ = system
    rho_t = md_t.density(gt).numpy()
    m = gt.mask.numpy()
    assert rho_j[m].min() > 0
    np.testing.assert_allclose(rho_t[m], rho_j[m], rtol=2e-5, atol=1e-6)
    assert np.all(rho_t[~m] == 0.0)


def test_force_matches_jax(system):
    md_t, gt, _, f_j = system
    f_t = md_t.compute_forces(gt, gt.vx, gt.vy, gt.vz)
    m = gt.mask.numpy()
    scale = max(np.abs(a[m]).max() for a in f_j)
    err = max(np.abs(a.numpy()[m] - b[m]).max() for a, b in zip(f_t, f_j))
    assert err / scale < 1e-4, err / scale


def test_momentum_conserved():
    pos, vel = _setup(seed=1)
    vel = vel - vel.mean(axis=0, keepdims=True)
    md = ts.GridSPH.create(L, N, ts.SPHParams(**PARAMS), dt=0.002, device="cpu")
    gs = md.run(md.init(pos, vel=vel), 5)
    assert not bool(gs.overflow)
    for comp in (gs.vx, gs.vy, gs.vz):
        assert abs(float(comp.sum())) < 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_sph_functors_match_plain(cuda):
    pos, vel = _setup()
    md = ts.GridSPH.create(L, N, ts.SPHParams(**PARAMS), dt=0.005, device=cuda)
    gs = tl.pack(md.spec, pos, vel=vel, device=cuda)
    cpu = tl.grid_state_from_numpy(md.spec, tl.grid_state_to_numpy(gs), device="cpu")
    counts = (tp.PAIR_CHANNEL_SPH_DENSITY.launches, tp.PAIR_CHANNEL_SPH_FORCE.launches)
    got = md.compute_forces(gs, gs.vx, gs.vy, gs.vz)
    torch.cuda.synchronize()
    assert (tp.PAIR_CHANNEL_SPH_DENSITY.launches, tp.PAIR_CHANNEL_SPH_FORCE.launches) == (
        counts[0] + 1, counts[1] + 1)
    want = md.compute_forces(cpu, cpu.vx, cpu.vy, cpu.vz)
    scale = max(float(a.abs().max()) for a in want)
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want)) < 2e-5 * scale
    rho_c, rho_p = md.density(gs).cpu(), md.density(cpu)
    assert float((rho_c - rho_p).abs().max()) < 2e-5 * float(rho_p.abs().max())
