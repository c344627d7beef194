"""The port's fused fold + Gronbech-Jensen update
(uammd_tpu_torch.engine.update_kernel) against the JAX package.

At T = 0 the update is deterministic: the plain version is held to JAX's
``gj_update_jnp(fold_reactions_jnp(...))`` (update_kernel.py:322, the mirror
the JAX tests use for the TPU-only fused kernel) within 1e-6 absolute on x
and w (positions ~6, velocities ~1: a few float32 ulps, where XLA contracts
a multiply-add into an FMA) and on the drift.

At T > 0 the JAX kernel draws from the TPU's hardware PRNG, which nothing
reproduces; the port's counter hash (Philox-4x32-10) is checked against
Random123's known answers, for determinism in (seed, counter), and for the
moments of its two generators over 10^6 draws.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import kernel2 as jk
from uammd_tpu.engine.update_kernel import gj_update_jnp
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import update_kernel as tu

DT, FRICTION, MASS = 0.01, 1.0, 1.0


@pytest.fixture(scope="module")
def inputs():
    """A [4, 4, 8, 16] grid with a quarter of its slots empty, random
    w, home force, 12 group grids and positions 0.1 from their reference."""
    spec = tl.GridSpec(box_size=(12.0, 12.0, 12.0), shape=(4, 16, 4), cap=8, fold=4,
                       cutoff=2.5, skin=1.2, n_strag=16)
    rng = np.random.default_rng(7)
    shape = spec.array_shape
    empty = rng.random(shape) < 0.25

    def grid(scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    x, y, z = ((rng.random(shape) * 12 - 6).astype(np.float32) for _ in range(3))
    x[empty] = y[empty] = z[empty] = tl.EMPTY_POS
    w = [np.where(empty, 0, grid(1.0)).astype(np.float32) for _ in range(3)]
    home = [grid(5.0) for _ in range(3)]
    groups = [grid(5.0) for _ in range(12)]
    ref = [np.where(empty, p, p - grid(0.1)).astype(np.float32) for p in (x, y, z)]
    return spec, [x, y, z] + w + home + groups + ref


def test_t0_matches_jax_mirror(inputs):
    spec, arrs = inputs
    t = [torch.from_numpy(a) for a in arrs]
    kern = tu.make_gj_fold_update_kernel(spec, DT, 0.0, FRICTION, MASS, noise="clt")
    launches = tu.GJ_FOLD_UPDATE.launches
    out, drift = kern(*t[:9], t[9:21], *t[21:], torch.tensor(123, dtype=torch.int32))
    assert tu.GJ_FOLD_UPDATE.launches == launches  # the CPU path launches nothing
    j = [jnp.asarray(a) for a in arrs]
    groups = [j[9 + 3 * i: 12 + 3 * i] for i in range(4)]
    fx, fy, fz = jk.fold_reactions_jnp(j[6:9], groups)
    out_j, drift_j = jax.jit(
        lambda *a: gj_update_jnp(spec, DT, 0.0, FRICTION, MASS, *a, jax.random.key(0))
    )(*j[0:6], fx, fy, fz, *j[21:24])
    for a, b in zip(out, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert abs(float(drift) - float(drift_j)) < 1e-6
    assert float(drift) > 0.1  # the reference offsets are seen
    empty = arrs[0] >= 1e8
    assert (out[0].numpy()[empty] == tl.EMPTY_POS).all()
    assert (out[3].numpy()[empty] == 0).all()


def test_straggler_rows_match_jax_at_t0(inputs):
    """The straggler rows ride in the same update: at T = 0 they follow
    the JAX engine's separate straggler update (md2.py:190-213)."""
    import types

    from uammd_tpu.engine.md2 import GridMD2 as JGridMD2

    spec, arrs = inputs
    rng = np.random.default_rng(8)
    S = spec.n_strag
    spos, svel, sforce = ((scale * rng.standard_normal((S, 3))).astype(np.float32)
                          for scale in (5.0, 1.0, 5.0))
    spid = np.where(rng.random(S) < 0.5, np.arange(S), -1).astype(np.int32)
    t = [torch.from_numpy(a) for a in arrs]
    kern = tu.make_gj_fold_update_kernel(spec, DT, 0.0, FRICTION, MASS)
    strag = tuple(torch.from_numpy(a) for a in (spos, svel, sforce, spid))
    *_, (spos_t, svel_t) = kern(*t[:9], t[9:21], *t[21:], 5, strag)
    eng = types.SimpleNamespace(spec=spec, dt=DT, temperature=0.0, friction=FRICTION,
                                mass=MASS)
    gs = types.SimpleNamespace(spos=jnp.asarray(spos), svel=jnp.asarray(svel),
                               sforce=jnp.asarray(sforce), spid=jnp.asarray(spid),
                               replace=lambda **kw: kw)
    want = JGridMD2._strag_update(eng, gs, jax.random.key(0))
    np.testing.assert_allclose(spos_t.numpy(), np.asarray(want["spos"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(svel_t.numpy(), np.asarray(want["svel"]), rtol=0, atol=1e-6)
    assert (svel_t.numpy()[spid < 0] == 0).all()


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32_10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = tu.philox4x32(ctr, key)
        assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("noise", tu.NOISES)
def test_counter_noise_is_a_function_of_seed_and_slot(noise):
    idx = torch.arange(4096, dtype=torch.int64)
    a = tu.normals(tu.counter_bits(17, idx), noise, 1.0)
    b = tu.normals(tu.counter_bits(torch.tensor(17, dtype=torch.int32), idx), noise, 1.0)
    c = tu.normals(tu.counter_bits(18, idx), noise, 1.0)
    d = tu.normals(tu.counter_bits(17, idx, stream=1), noise, 1.0)
    for u, v, w, s in zip(a, b, c, d):
        assert torch.equal(u, v)
        assert not torch.equal(u, w)
        assert not torch.equal(u, s)
    # the three components are not copies of each other
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])


@pytest.mark.parametrize("noise", tu.NOISES)
def test_noise_moments(noise):
    amp = 0.3
    idx = torch.arange(350_000, dtype=torch.int64)
    n = torch.cat(tu.normals(tu.counter_bits(99, idx), noise, amp)).double() / amp
    assert n.numel() > 1_000_000
    assert abs(float(n.mean())) < 0.01
    assert abs(float(n.var()) - 1.0) < 0.01
    if noise == "clt":
        # four 16-bit uniforms: bounded at 2 sqrt(3) sigma
        assert float(n.abs().max()) <= 2.0 * math.sqrt(3.0) * (1.0 + 1e-6)
    else:
        assert float(n.abs().max()) > 4.0  # Gaussian tails


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("noise", tu.NOISES)
def test_cuda_kernel_matches_plain(cuda, inputs, noise):
    spec, arrs = inputs
    kern = tu.make_gj_fold_update_kernel(spec, DT, 1.5, FRICTION, MASS, noise=noise)
    seed = torch.tensor(4242, dtype=torch.int32)
    t = [torch.from_numpy(a) for a in arrs]
    S = spec.n_strag
    strag = (torch.randn(S, 3) * 5, torch.randn(S, 3), torch.randn(S, 3) * 5,
             torch.where(torch.arange(S) % 3 == 0, -1, torch.arange(S)).to(torch.int32))
    out_p, drift_p, sout_p = kern(*t[:9], t[9:21], *t[21:], seed, strag)
    c = [a.to(cuda) for a in t]
    launches = tu.GJ_FOLD_UPDATE.launches
    out_c, drift_c, sout_c = kern(*c[:9], c[9:21], *c[21:], seed.to(cuda),
                                  tuple(a.to(cuda) for a in strag))
    torch.cuda.synchronize()
    assert tu.GJ_FOLD_UPDATE.launches == launches + 1
    for a, b in zip(list(out_c) + list(sout_c), list(out_p) + list(sout_p)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert abs(float(drift_c) - float(drift_p)) < 1e-5
