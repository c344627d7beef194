"""The port's pencil spread/interpolate (uammd_tpu_torch.solvers.pencil_ibm)
against the JAX package's (uammd_tpu.solvers.pencil_ibm).

- ``pencil_ok``/``default_cap`` equal over a table of shapes;
- ``bin_pencils`` equal slot for slot (pids, slot_of_pid, overflow),
  including an overflow;
- the XLA-path ``spread_pencil``/``interpolate_pencil`` equal to the
  port's direct path within 1e-12 in float64 (tests/test_pencil_ibm.py's
  atol), with and without slack;
- the plain versions of kernels #13/#14 against JAX
  ``spread_pencil_fused``/``interpolate_pencil_fused`` (Pallas, interpret
  mode) at tests/test_pencil_ibm.py:210's float32 system, slack 0 and 1,
  within 2e-6 x max (that test's tolerance);
- ``gpu``: the CUDA kernels against their plain versions (skip without a GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.solvers import ibm as ji
from uammd_tpu.solvers import pencil_ibm as jp
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.integrators.bdhi.fcm import _NormalizedBM
from uammd_tpu_torch.solvers import ibm as ti
from uammd_tpu_torch.solvers import pencil_ibm as tp

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_ibm.py

FUSED_N, FUSED_L, FUSED_SHAPE = 5000, 24.0, (32, 32, 32)


def test_pencil_ok_and_default_cap():
    shapes = [(16, 16, 8), (16, 16, 7), (12, 16, 8), (8, 16, 8), (24, 24, 24), (48, 40, 17),
              (384, 384, 384)]
    for shape in shapes:
        for support in (3, 8, 12, 14, 16, 18):
            for slack in (0, 1):
                for custom_z in (False, True):
                    assert (tp.pencil_ok(shape, support, slack, custom_z)
                            == jp.pencil_ok(shape, support, slack, custom_z))
        if shape[0] % 8 == 0 and shape[1] % 8 == 0:
            for n in (1, 300, 5000, 131072):
                assert tp.default_cap(n, shape) == jp.default_cap(n, shape)
    # the full FCM path: 48 x 48 pencils of cap 120
    assert tp.default_cap(131072, (384, 384, 384)) == 120


def _bins_equal(jb, tb_):
    np.testing.assert_array_equal(tb_.pids.numpy(), np.asarray(jb.pids))
    np.testing.assert_array_equal(tb_.slot_of_pid.numpy(), np.asarray(jb.slot_of_pid))
    assert bool(tb_.overflow) == bool(jb.overflow)


@pytest.mark.parametrize("case", ["uniform", "outside_box", "overflow"])
def test_bin_pencils_slot_for_slot(case):
    rng = np.random.default_rng(11)
    shape, L = (32, 24, 16), [20.0, 15.0, 10.0]
    if case == "overflow":  # piled into one pencil with a tiny cap
        pos, cap = rng.normal(scale=0.05, size=(40, 3)), 8
    else:
        scale = 1.0 if case == "uniform" else 3.0
        pos, cap = (rng.random((900, 3)) - 0.5) * np.asarray(L) * scale, None
    jb = jax.jit(jp.bin_pencils, static_argnums=1, static_argnames="cap")(
        jnp.asarray(pos), shape, jbox(L, dtype=jnp.float64), cap=cap)
    tb_ = tp.bin_pencils(torch.as_tensor(pos), shape, tbox(L, dtype=torch.float64,
                                                          device="cpu"), cap=cap)
    _bins_equal(jb, tb_)
    assert bool(tb_.overflow) == (case == "overflow")
    back = tp.pencil_bins_from_numpy(tp.pencil_bins_to_numpy(tb_), device="cpu")
    _bins_equal(jb, back)


@pytest.mark.parametrize("slack", [0, 1])
@pytest.mark.parametrize("m,support", [((32, 40, 36), 8), ((40, 32, 20), 12), ((16, 16, 9), 3)])
def test_xla_path_matches_direct(m, support, slack):
    """The port's XLA-path spread/interpolate equal its direct path within
    1e-12 in float64 (tests/test_pencil_ibm.py:36 holds the JAX pair the
    same way; tests/test_torch_ibm.py holds the port's direct path to
    JAX's), with bins built before a drift below slack * h in x/y."""
    assert tp.pencil_ok(m, support, slack)
    kern = ti.Peskin3pt() if support == 3 else ti.GaussianKernel(sigma=1.2, support=support)
    rng = np.random.default_rng(0)
    n, Ls = 500, [mm * 0.61 for mm in m]
    b = tbox(Ls, dtype=torch.float64, device="cpu")
    pos = torch.as_tensor((rng.random((n, 3)) - 0.5) * np.asarray(Ls))
    q = torch.as_tensor(rng.normal(size=(n, 3)))
    bins = tp.bin_pencils(pos, m, b)
    h = min(Ls[0] / m[0], Ls[1] / m[1])
    pos1 = pos + slack * torch.as_tensor(rng.uniform(-0.99, 0.99, (n, 3))) * h
    f_p, _ = tp.spread_pencil(kern, pos1, q, m, b, bins, slack=slack, chunk=7)
    f_d = ti.spread(kern, pos1, q, m, b)
    np.testing.assert_allclose(f_p.numpy(), f_d.numpy(), atol=1e-12)
    u = torch.as_tensor(rng.normal(size=m + (3,)))
    v_p, _ = tp.interpolate_pencil(kern, pos1, u, b, bins, slack=slack, chunk=7)
    np.testing.assert_allclose(v_p.numpy(), ti.interpolate(kern, pos1, u, b).numpy(),
                               atol=1e-12)
    # adjointness: <S q, u> dV = <q, J u>
    dV = float(np.prod([Ls[d] / m[d] for d in range(3)]))
    lhs = float(torch.sum(f_p * u)) * dV
    rhs = float(torch.sum(q * v_p))
    assert abs(lhs - rhs) <= 1e-10 * abs(rhs)


@pytest.fixture(scope="module")
def fused_system():
    """tests/test_pencil_ibm.py:210's float32 system, made with numpy."""
    rng = np.random.default_rng(0)
    pos = ((rng.random((FUSED_N, 3)) - 0.5) * FUSED_L).astype(np.float32)
    vals = rng.normal(size=(FUSED_N, 3)).astype(np.float32)
    bins = jp.bin_pencils(jnp.asarray(pos), FUSED_SHAPE, jbox(FUSED_L))
    return pos, vals, bins


@pytest.fixture(scope="module")
def jax_fused(fused_system):
    """JAX's fused spread of the values and fused interpolation of a random
    field, slack 0 and 1, each under one jax.jit (interpret mode)."""
    pos, vals, bins = fused_system
    field = np.random.default_rng(1).normal(size=FUSED_SHAPE + (3,)).astype(np.float32)
    kern, b = ji.GaussianKernel(sigma=1.1, support=8), jbox(FUSED_L)
    out = {}
    for slack in (0, 1):
        @jax.jit
        def both(p, v, u):
            f1, _ = jp.spread_pencil_fused(kern, p, v, FUSED_SHAPE, b, bins, slack=slack,
                                           interpret=True)
            v1, _ = jp.interpolate_pencil_fused(kern, p, u, b, bins, slack=slack,
                                                interpret=True)
            return f1, v1

        out[slack] = [field] + [np.asarray(a) for a in both(
            jnp.asarray(pos), jnp.asarray(vals), jnp.asarray(field))]
    return out


@pytest.mark.parametrize("slack", [0, 1])
def test_fused_plain_matches_jax_fused(fused_system, jax_fused, slack):
    pos, vals, bins_j = fused_system
    f0, f1, v1 = jax_fused[slack]
    kern, b = ti.GaussianKernel(sigma=1.1, support=8), tbox(FUSED_L, device="cpu")
    bins = tp.pencil_bins_from_numpy(
        {"pids": bins_j.pids, "slot_of_pid": bins_j.slot_of_pid, "overflow": bins_j.overflow},
        device="cpu")
    f_t, ovf = tp.spread_pencil_fused(kern, torch.as_tensor(pos), torch.as_tensor(vals),
                                      FUSED_SHAPE, b, bins, slack=slack)
    assert not bool(ovf)
    s = np.abs(f1).max()
    np.testing.assert_allclose(f_t.numpy(), f1, atol=2e-6 * s, rtol=0)
    v_t, _ = tp.interpolate_pencil_fused(kern, torch.as_tensor(pos), torch.as_tensor(f0), b,
                                         bins, slack=slack)
    np.testing.assert_allclose(v_t.numpy(), v1, atol=2e-6 * np.abs(v1).max(), rtol=0)


def test_wrappers_reject_bad_inputs():
    kern = ti.GaussianKernel(sigma=1.1, support=8)
    b = tbox(8.0, device="cpu")
    pos = torch.zeros(10, 3)
    bins = tp.bin_pencils(pos, (16, 16, 16), b)
    with pytest.raises(AssertionError):  # halo 9 > 8: off the pencil path
        tp.spread_pencil_fused(ti.GaussianKernel(sigma=2.0, support=18), pos, torch.ones(10, 3),
                               (16, 16, 16), b, bins)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gaussian", "peskin3", "peskin4", "bm"])
@pytest.mark.parametrize("slack", [0, 1])
def test_cuda_pencil_kernels_match_plain(cuda, fused_system, name, slack):
    kern = {"gaussian": ti.GaussianKernel(sigma=1.1, support=8), "peskin3": ti.Peskin3pt(),
            "peskin4": ti.Peskin4pt(), "bm": _NormalizedBM(beta=7.96, support=6)}[name]
    pos_np, vals_np, _ = fused_system
    b = tbox(FUSED_L, device=cuda)
    pos, vals = torch.as_tensor(pos_np, device=cuda), torch.as_tensor(vals_np, device=cuda)
    bins = tp.bin_pencils(pos, FUSED_SHAPE, b)
    n0, n1 = tp.SPREAD.launches, tp.INTERP.launches
    f_k, _ = tp.spread_pencil_fused(kern, pos, vals, FUSED_SHAPE, b, bins, slack=slack)
    f_p, _ = tp.spread_pencil_fused_plain(kern, pos, vals, FUSED_SHAPE, b, bins, slack=slack)
    v_k, _ = tp.interpolate_pencil_fused(kern, pos, f_p, b, bins, slack=slack)
    v_p, _ = tp.interpolate_pencil_fused_plain(kern, pos, f_p, b, bins, slack=slack)
    torch.cuda.synchronize()
    assert (tp.SPREAD.launches, tp.INTERP.launches) == (n0 + 1, n1 + 1)
    assert float((f_k - f_p).abs().max()) <= 2e-5 * float(f_p.abs().max())
    assert float((v_k - v_p).abs().max()) <= 2e-5 * float(v_p.abs().max())
