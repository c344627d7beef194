"""The port's triply periodic Poisson electrostatics
(uammd_tpu_torch.electrostatics.poisson) against the JAX package.

- ``GaussianNearField``'s fitted constants (qb, the two pieces' G and G'/r
  coefficients, the u scaling, self_G, the fit error) to 1e-12: the same
  float64 numpy fits on both sides.
- The Poisson functor's plain version (``PoissonNear``) against JAX's
  ``_pair_fn`` on random pairs in float32, within 1e-6 of max|ref|
  (``torch.rsqrt`` against ``jax.lax.rsqrt``: an ulp on q moves the
  degree-20 Horner sums by a few ulps of their largest terms).
- ``PoissonSplit.sum`` on 600 charges, without and with a straggler list
  (the JAX near field in the Pallas channel kernel, interpret mode):
  forces and energies within 2e-5 of max|ref| (float32 sums in another
  order).
- ``Poisson.sum`` on the direct path (N < 4096) in float64 to 1e-10 of
  max|ref|, and on the pencil path (N = 4096, 32^3, Gaussian support 10)
  in float32 within 2e-5 of max|ref|.
- tests/test_electrostatics.py's check against the exact k-space sum of
  Gaussian charges, on the port (rtol 2e-3 for phi, 5e-3 for E).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as j_box
from uammd_tpu.core.types import Computables as JComputables
from uammd_tpu.electrostatics import poisson as jp
from uammd_tpu_torch.core.box import box as t_box
from uammd_tpu_torch.core.types import Computables
from uammd_tpu_torch.electrostatics import poisson as tp
from uammd_tpu_torch.engine import pair_kernel as tk

N, L, GW, SPLIT = 600, 12.0, 0.4, 1.0
FE = (True, True)


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _charges(n, L, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)
    q = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    return pos, q


def _max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def split_pair():
    pos, _ = _charges(N, L, 0)
    ps_j = jp.PoissonSplit.create(j_box(L, dtype=jnp.float32), N, gw=GW, split=SPLIT, pos=pos)
    ps_t = tp.PoissonSplit.create(t_box(L, device="cpu"), N, gw=GW, split=SPLIT, pos=pos)
    return ps_j, ps_t


def test_near_field_constants_match(split_pair):
    ps_j, ps_t = split_pair
    nj, nt = ps_j.near, ps_t.near
    assert nt.spec.array_shape == nj.spec.array_shape and ps_t.far.shape == ps_j.far.shape
    assert ps_t.far.support == ps_j.far.support
    for k in ("qb", "self_G", "fit_error", "rcut", "ngw"):
        assert getattr(nt, k) == pytest.approx(getattr(nj, k), rel=1e-12, abs=1e-12), k
    for k in ("e_coef", "g_coef", "uscale"):
        for a, b in zip(getattr(nt, k), getattr(nj, k)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())


def test_functor_plain_matches_jax_pair_fn(split_pair):
    ps_j, ps_t = split_pair
    rc = ps_t.rcut
    rng = np.random.default_rng(3)
    k = 20000
    d = rng.standard_normal((k, 3))
    d *= (rng.uniform(0.0, 1.1 * rc, k) / np.linalg.norm(d, axis=1))[:, None]
    d[:5] = 0.0  # self pairs
    d = d.astype(np.float32)
    r2 = (d * d).sum(1)
    qi, qj = (rng.standard_normal(k).astype(np.float32) for _ in range(2))
    args = [jnp.asarray(a) for a in (r2, d[:, 0], d[:, 1], d[:, 2], qi, qj)]
    pair_j = ps_j.near._pair_fn()
    want = _jit0(lambda r, x, y, z, a, b: pair_j(r, x, y, z, (a,), (b,)), *args)(*args)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (r2, d[:, 0], d[:, 1], d[:, 2])]
    got = ps_t.near.pair_fn()(*t, (torch.from_numpy(qi),), (torch.from_numpy(qj),))
    for a, b in zip(got, want):
        assert _max_rel(a.numpy(), b) < 1e-6
    assert (np.asarray(want[3]) != 0).sum() > k // 2


@pytest.mark.parametrize("n_strag", [0, 32])
def test_split_sum_matches_jax(n_strag):
    pos, q = _charges(N, L, 1)
    kw = dict(gw=GW, split=SPLIT, pos=pos, n_strag=n_strag)
    ps_j = jp.PoissonSplit.create(j_box(L, dtype=jnp.float32), N, **kw)
    ps_t = tp.PoissonSplit.create(t_box(L, device="cpu"), N, **kw)
    assert ps_t.spec.array_shape == ps_j.spec.array_shape
    pj, qj = jnp.asarray(pos), jnp.asarray(q)
    want = _jit0(lambda p, c: ps_j.sum(p, c, JComputables(*FE)), pj, qj)(pj, qj)
    got = ps_t.sum(torch.from_numpy(pos), torch.from_numpy(q), Computables(*FE))
    assert _max_rel(got.force.numpy(), want.force) < 2e-5
    assert _max_rel(got.energy.numpy(), want.energy) < 2e-5
    assert not bool(ps_t.near.last_overflow)
    if n_strag:
        from uammd_tpu_torch.engine.layout import pack_channels

        cg = pack_channels(ps_t.spec, torch.from_numpy(pos), torch.from_numpy(q)[:, None])
        assert int((cg.spid >= 0).sum()) > 1  # straggler-straggler pairs too


def test_straggler_rows_round_as_grid_pairs():
    """A straggler's near-field pairs round as the same pairs between grid
    particles: charges within 4 of the x faces of a (192, 12, 12) box, so
    most pairs cross the box edge at coordinates near 96, and CAP 32 sends
    about 50 of them to the straggler rows. The straggler spec's field is
    within 1e-6 of max|ref| of the straggler-free one (float32 summation
    order; a straggler displacement rounded as the difference's minimum
    image, as the JAX kernel takes it, puts it 2.7e-6 away)."""
    Ls, n = (192.0, 12.0, 12.0), 600
    rng = np.random.default_rng(7)
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(-6, 6, n), rng.uniform(-6, 6, n)], 1)
    pos[:, 0] += np.where(pos[:, 0] < 0, 96.0, -96.0)
    pos = torch.from_numpy(pos.astype(np.float32))
    q = torch.from_numpy(np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32))
    ngw = (GW * GW + 1 / (4 * SPLIT * SPLIT)) ** 0.5
    kw = dict(gw=GW, ngw=ngw, rcut=tp.near_cutoff(ngw, 1e-4), pos=pos.numpy())
    free = tp.GaussianNearField.create(Ls, n, **kw)
    strag = tp.GaussianNearField.create(Ls, n, n_strag=64, cap=32, **kw)
    want, got = free.apply(pos, q), strag.apply(pos, q)
    assert not bool(strag.last_overflow)
    from uammd_tpu_torch.engine.layout import pack_channels

    assert int((pack_channels(strag.spec, pos, q[:, None]).spid >= 0).sum()) > 30
    assert float((got - want).abs().max()) < 1e-6 * float(want.abs().max())


def test_straggler_functor_refuses_other_functors():
    pos, _ = _charges(N, L, 1)
    ps = tp.PoissonSplit.create(t_box(L, device="cpu"), N, gw=GW, split=SPLIT, pos=pos,
                                n_strag=32)
    with pytest.raises(ValueError, match="straggler-free"):
        tk.make_pair_channel_kernel(ps.spec, tk.ChannelFunctor())


def test_direct_path_float64_matches_jax():
    Lb, n = 20.0, 6
    rng = np.random.default_rng(3)
    pos = (rng.random((n, 3)) - 0.5) * Lb
    q = rng.normal(size=n)
    q -= q.mean()
    p_j = jp.Poisson.create(j_box(Lb, dtype=jnp.float64), gw=1.0, tolerance=1e-5)
    p_t = tp.Poisson.create(t_box(Lb, dtype=torch.float64, device="cpu"), gw=1.0,
                            tolerance=1e-5)
    assert p_t.shape == p_j.shape and p_t.support == p_j.support
    pj, qj = jnp.asarray(pos), jnp.asarray(q)
    want = jax.jit(lambda p, c: p_j.sum(p, c, JComputables(*FE)))(pj, qj)
    got = p_t.sum(torch.from_numpy(pos), torch.from_numpy(q), Computables(*FE))
    assert got.force.dtype == torch.float64
    assert _max_rel(got.force.numpy(), want.force) < 1e-10
    assert _max_rel(got.energy.numpy(), want.energy) < 1e-10


def test_pencil_path_float32_matches_jax():
    Lb, n = 24.0, 4096
    pos, q = _charges(n, Lb, 4)
    p_j = jp.Poisson.create(j_box(Lb, dtype=jnp.float32), gw=1.0)
    p_t = tp.Poisson.create(t_box(Lb, device="cpu"), gw=1.0)
    assert p_t.shape == p_j.shape == (32, 32, 32) and p_t.support == 10
    pj, qj = jnp.asarray(pos), jnp.asarray(q)
    want = jax.jit(lambda p, c: p_j.sum(p, c, JComputables(*FE)))(pj, qj)
    got = p_t.sum(torch.from_numpy(pos), torch.from_numpy(q), Computables(*FE))
    assert _max_rel(got.force.numpy(), want.force) < 2e-5
    assert _max_rel(got.energy.numpy(), want.energy) < 2e-5


def _direct_k_sum(pos, q, L, gw, eps=1.0, kmax=14):
    """Exact periodic fields of Gaussian charges by a brute-force k sum
    (tests/test_electrostatics.py:direct_k_sum)."""
    m = np.arange(-kmax, kmax + 1)
    kx, ky, kz = np.meshgrid(m, m, m, indexing="ij")
    k = 2 * np.pi / L * np.stack([kx, ky, kz], -1).reshape(-1, 3)
    k2 = (k**2).sum(-1)
    k, k2 = k[k2 > 0], k2[k2 > 0]
    rho_k = (q[:, None] * np.exp(-1j * pos @ k.T)).sum(0) * np.exp(-k2 * gw**2)
    phi_k = rho_k / (eps * k2)
    e = np.exp(1j * pos @ k.T)
    phi = (e * phi_k[None, :]).real.sum(1) / L**3
    E = (e[:, :, None] * (-1j * k)[None] * phi_k[None, :, None]).real.sum(1) / L**3
    return phi, E


def test_fields_match_direct_k_sum():
    Lb, gw = 20.0, 1.0
    p = tp.Poisson.create(t_box(Lb, dtype=torch.float64, device="cpu"), gw=gw, tolerance=1e-5)
    rng = np.random.default_rng(3)
    pos = (rng.random((6, 3)) - 0.5) * Lb
    q = rng.normal(size=6)
    q -= q.mean()
    phi, E = p.fields(torch.from_numpy(pos), torch.from_numpy(q))
    phi_ref, E_ref = _direct_k_sum(pos, q, Lb, gw)
    np.testing.assert_allclose(phi.numpy(), phi_ref, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(E.numpy(), E_ref, rtol=5e-3, atol=1e-5)


def test_isolated_charge_wigner_energy():
    """tests/test_electrostatics.py:81-91: Gaussian self energy plus the
    jellium correction, rtol 2e-3."""
    Lb, gw = 40.0, 1.2
    p = tp.Poisson.create(t_box(Lb, dtype=torch.float64, device="cpu"), gw=gw, tolerance=1e-5)
    fev = p.sum(torch.zeros((1, 3), dtype=torch.float64), torch.ones(1, dtype=torch.float64),
                Computables(False, True))
    want = 1.0 / (8.0 * math.pi**1.5 * gw) - 2.83729748 / (8.0 * math.pi * Lb)
    assert float(fev.energy.sum()) == pytest.approx(want, rel=2e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_strag", [0, 32])
def test_cuda_functor_matches_plain(cuda, n_strag):
    pos, q = _charges(N, L, 1)
    ps = tp.PoissonSplit.create(t_box(L, device="cpu"), N, gw=GW, split=SPLIT, pos=pos,
                                n_strag=n_strag)
    launches = tk.PAIR_CHANNEL_POISSON.launches
    got = ps.near.apply(torch.from_numpy(pos).to(cuda), torch.from_numpy(q).to(cuda))
    torch.cuda.synchronize()
    assert tk.PAIR_CHANNEL_POISSON.launches == launches + 1
    want = ps.near.apply(torch.from_numpy(pos), torch.from_numpy(q))
    assert _max_rel(got.cpu().numpy(), want.numpy()) < 2e-5
