"""The port's FCM mobility (uammd_tpu_torch.integrators.bdhi.fcm) against
the JAX package's (uammd_tpu.integrators.bdhi.fcm) and against theory.

- ``FCM.create``: shape, support, sigma and window function equal to JAX's
  for the four kernels and for the 131072-particle path's configuration;
- ``compute_mf`` and ``grid_velocity`` against JAX at tests/test_bdhi.py:187's
  system (n 4200, L 40, points_per_radius 1.2, support 8: the pencil path),
  float64, atol 1e-9 (that test's);
- the Hashimoto self-mobility (tests/test_bdhi.py:67, rtol 1e-3);
- the wave-space white-noise sampler: Hermitian round trip and variance
  (tests/test_bdhi.py:152's bounds);
- fluctuation-dissipation at tests/test_bdhi.py:105's system (atol 0.2 of
  max|M|, that test's bound);
- ``gpu``: ``grid_velocity`` and ``interpolate_auto`` on the card through
  kernels #13/#14 against their plain versions (skips without a GPU).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.integrators.bdhi.fcm import FCM as JFCM
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.integrators.bdhi.fcm import FCM as TFCM
from uammd_tpu_torch.integrators.bdhi.fcm import _sample_white_rfft

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_ibm.py

PATH_L = (131072 * (4.0 / 3.0) * math.pi / 0.05) ** (1.0 / 3.0)  # bench.py:117-118

CREATE_CASES = {
    "gaussian": dict(L=40.0, kw=dict(radius=1.0, points_per_radius=1.2, support=8)),
    "peskin3pt": dict(L=20.0, kw=dict(radius=1.0, kernel="peskin3pt")),
    "peskin4pt": dict(L=20.0, kw=dict(radius=1.3, kernel="peskin4pt")),
    "bm": dict(L=24.0, kw=dict(radius=1.0, points_per_radius=2.0, support=6, kernel="bm")),
    "path": dict(L=PATH_L, kw=dict(radius=1.0, points_per_radius=3.0 / math.sqrt(math.pi))),
}


@pytest.mark.parametrize("case", list(CREATE_CASES))
def test_create_matches_jax(case):
    c = CREATE_CASES[case]
    jf = JFCM.create(jbox(c["L"]), **c["kw"])
    tf = TFCM.create(tbox(c["L"], device="cpu"), **c["kw"])
    assert tf.shape == jf.shape and tf.support == jf.support and tf.kernel == jf.kernel
    assert tf.box_size == pytest.approx(jf.box_size, rel=1e-15)
    assert tf.sigma == pytest.approx(jf.sigma, rel=1e-15)
    jk, tk = jf._kernel(), tf._kernel()
    assert type(tk).__name__ == type(jk).__name__ and tk.support == jk.support
    r = np.linspace(-8.0, 8.0, 1601)
    np.testing.assert_allclose(tk.phi(torch.as_tensor(r)).numpy(),
                               np.asarray(jk.phi(jnp.asarray(r))), rtol=1e-6, atol=1e-7)
    if case == "path":  # the grid and support the path's kernels run at
        assert tf.shape == (384, 384, 384) and tf.support == 14


MF_L = 40.0
MF_KW = dict(viscosity=1.0, radius=1.0, points_per_radius=1.2, support=8)


def mf_system():
    """tests/test_bdhi.py:187's system: n 4200 at L 40, on the pencil path."""
    rng = np.random.default_rng(9)
    pos = (rng.random((4200, 3)) - 0.5) * MF_L
    return pos, rng.normal(size=(4200, 3))


def test_compute_mf_matches_jax():
    pos, f = mf_system()
    jf = JFCM.create(jbox(MF_L, dtype=jnp.float64), **MF_KW)
    tf = TFCM.create(tbox(MF_L, dtype=torch.float64, device="cpu"), **MF_KW)
    assert tf.pencil_bins(torch.as_tensor(pos)) is not None  # the pencil path engages
    want = np.asarray(jax.jit(jf.compute_mf)(jnp.asarray(pos), jnp.asarray(f)))
    got = tf.compute_mf(torch.as_tensor(pos), torch.as_tensor(f)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_grid_velocity_matches_jax():
    """The port spreads through spread_auto (here the plain version of
    kernel #13), JAX through the direct spread: the same field."""
    pos, f = mf_system()
    jf = JFCM.create(jbox(MF_L, dtype=jnp.float64), **MF_KW)
    tf = TFCM.create(tbox(MF_L, dtype=torch.float64, device="cpu"), **MF_KW)
    want = np.asarray(jax.jit(lambda p, q: jf.grid_velocity(p, q)[0])(jnp.asarray(pos),
                                                                      jnp.asarray(f)))
    got, kern = tf.grid_velocity(torch.as_tensor(pos), torch.as_tensor(f))
    assert type(kern).__name__ == "GaussianKernel" and got.shape == tf.shape + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)


@pytest.mark.gpu
def test_cuda_grid_velocity_matches_plain():
    """On the card grid_velocity and interpolate_auto launch kernels #13
    and #14; both within 2e-5 x max of their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from uammd_tpu_torch.solvers import ibm as ti
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    dev = torch.device("cuda")
    pos_np, f_np = mf_system()
    pos = torch.as_tensor(pos_np, dtype=torch.float32, device=dev)
    f = torch.as_tensor(f_np, dtype=torch.float32, device=dev)
    tf = TFCM.create(tbox(MF_L, device=dev), **MF_KW)
    n0, n1 = tp.SPREAD.launches, tp.INTERP.launches
    got, kern = tf.grid_velocity(pos, f)
    v_k = ti.interpolate_auto(kern, pos, got, tf.box)
    torch.cuda.synchronize()
    assert (tp.SPREAD.launches, tp.INTERP.launches) == (n0 + 1, n1 + 1)
    bins = tp.bin_pencils(pos, tf.shape, tf.box)
    field, _ = tp.spread_pencil_fused_plain(kern, pos, f, tf.shape, tf.box, bins)
    want = tf._irfftn(tf._mobility_k(torch.fft.rfftn(field, dim=(0, 1, 2)), pos))
    v_p, _ = tp.interpolate_pencil_fused_plain(kern, pos, got, tf.box, bins)
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert float((v_k - v_p).abs().max()) <= 2e-5 * float(v_p.abs().max())


def test_self_mobility_hashimoto():
    eta, a = 1.0, 2.0
    m0 = 1.0 / (6.0 * math.pi * eta * a)
    for L in (24.0, 36.0):
        fcm = TFCM.create(tbox(L, dtype=torch.float64, device="cpu"), viscosity=eta, radius=a,
                          points_per_radius=3.0, support=12)
        v = fcm.compute_mf(torch.zeros((1, 3), dtype=torch.float64),
                           torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64))
        want = m0 * (1.0 - 2.83729748 * (a / L) + (4.0 * math.pi / 3.0) * (a / L) ** 3)
        np.testing.assert_allclose(float(v[0, 0]), want, rtol=1e-3)


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 10, 9)])
def test_white_noise_sampler(shape):
    dV = 0.37
    gen = torch.Generator().manual_seed(0)
    wk = _sample_white_rfft(gen, shape, dV, torch.float64)
    rt = torch.fft.rfftn(torch.fft.irfftn(wk, s=shape, dim=(0, 1, 2)), dim=(0, 1, 2))
    np.testing.assert_allclose(rt.numpy(), wk.numpy(), rtol=2e-4,
                               atol=2e-4 * float(wk.abs().max()))
    w = torch.stack([torch.fft.irfftn(_sample_white_rfft(gen, shape, dV, torch.float64),
                                      s=shape, dim=(0, 1, 2)) for _ in range(60)]).numpy()
    assert abs(w.var() * dV - 1.0) < 0.05, w.var() * dV
    assert abs(w.mean()) < 0.02 / math.sqrt(dV)
    cov = (w * np.roll(w, 1, axis=1)).mean()
    assert abs(cov * dV) < 0.03, cov * dV


def test_fluctuation_dissipation():
    """E[bdw bdw^T] equals the mobility from compute_mf."""
    fcm = TFCM.create(tbox(16.0, dtype=torch.float64, device="cpu"), viscosity=1.0,
                      radius=1.5, points_per_radius=2.5, support=10)
    pos = torch.tensor([[0.0, 0, 0], [4.0, 0, 0]], dtype=torch.float64)
    cols = []
    for i in range(2):
        for d in range(3):
            f = torch.zeros((2, 3), dtype=torch.float64)
            f[i, d] = 1.0
            cols.append(fcm.compute_mf(pos, f).reshape(-1).numpy())
    M = np.stack(cols, axis=1)
    gen = torch.Generator().manual_seed(1)
    bs = np.stack([fcm.compute_bdw(pos, gen).reshape(-1).numpy() for _ in range(600)])
    cov = np.cov(bs.T, bias=True)
    scale = np.abs(M).max()
    np.testing.assert_allclose(cov / scale, M / scale, atol=0.2)
    # with the same noise, compute_mf_bdw = compute_mf + amp * compute_bdw
    f = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 3)))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    both = fcm.compute_mf_bdw(pos, f, g1, 0.7)
    np.testing.assert_allclose(both.numpy(), (fcm.compute_mf(pos, f)
                                              + 0.7 * fcm.compute_bdw(pos, g2)).numpy(),
                               atol=1e-12)
