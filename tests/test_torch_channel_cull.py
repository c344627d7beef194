"""The channel kernel #2's cutoff cull and its NaN placement, held on the CPU
through the functors' plain versions: no Pallas kernel, no JAX engine.

The CUDA kernel (``csrc/pair_channel.cu``) skips every candidate beyond a
functor's reach (``reach``), and for a pair whose displacement is not
finite it adds the plain version's 0 * d to the sums that carry it
(``pair_kernel.displacement_sums``, the CUDA functor's ``kDisp``). Here:

1. each plain functor gives exactly 0 for finite pairs beyond its reach;
2. each plain functor puts NaN in the same terms as the JAX pair function
   it ports, called under ``jax.jit`` on small numpy arrays, when one
   displacement component is NaN or infinite;
3. the declared displacement sums are those that the plain version turns
   NaN.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from uammd_tpu.electrostatics.poisson import GaussianNearField as JaxNear
from uammd_tpu.engine import dpd as jdpd
from uammd_tpu.engine import mixtures as jmix
from uammd_tpu.engine import sph as jsph
from uammd_tpu.integrators.bdhi.pse_engine import PSEGrid as JaxPSE
from uammd_tpu.interactors.sph import SPHParams as JaxSPHParams
from uammd_tpu_torch.electrostatics.poisson import PoissonNear
from uammd_tpu_torch.engine import pair_kernel
from uammd_tpu_torch.engine.dpd import DPDPair
from uammd_tpu_torch.engine.mixtures import LJMixturePair, LJMixturePairMasked
from uammd_tpu_torch.engine.pse_near import PSENear
from uammd_tpu_torch.engine.sph import SPHDensityPair, SPHForcePair
from uammd_tpu_torch.interactors.sph import SPHParams

N_PAIRS = 96
RCUT = 2.0  # Poisson and PSE
QB = 0.4
USCALE = ((2.0 / QB, -1.0), (2.0 / (1.0 - QB), -(1.0 + QB) / (1.0 - QB)))
# power coefficients in u, lowest degree first: (e1, e2), (g1, g2) for
# Poisson; (f1, f2, g1, g2) for PSE
E_COEF = ((0.5, -0.2, 0.03, 0.01), (0.1, -0.05, 0.01))
G_COEF = ((-0.3, 0.1, -0.02, 0.004), (-0.05, 0.02, -0.003))
PSE_COEF = ((0.8, -0.3, 0.05, 0.01), (0.2, -0.1, 0.02), (0.1, 0.05, -0.02, 0.004),
            (0.03, -0.01, 0.002))


def _dpd():
    sigma_dt = math.sqrt(2.0 * 1.0 * 4.5 / 0.01)
    return (DPDPair(1.0, 25.0, 4.5, sigma_dt), jdpd.dpd_pair_fn(1.0, 25.0, 4.5, sigma_dt), 1)


def _sph_density():
    return SPHDensityPair(1.0), jsph.sph_density_pair_fn(1.0), 1


def _sph_force():
    kw = dict(support=1.0, viscosity=20.0, gas_stiffness=15.0, rest_density=1.2)
    return SPHForcePair(SPHParams(**kw)), jsph.sph_force_pair_fn(JaxSPHParams(**kw)), 1


def _lj_mix():
    return LJMixturePair(2.5), jmix.lj_mixture_pair_fn(2.5), 1


def _lj_mix_masked():
    return LJMixturePairMasked(2.5), jmix.lj_mixture_pair_fn_masked(2.5), 1


def _poisson():
    jax_near = JaxNear(gw=0.25, ngw=0.5, epsilon=1.0, rcut=RCUT, spec=None, qb=QB,
                       e_coef=E_COEF, g_coef=G_COEF, uscale=USCALE, self_G=0.0, fit_error=0.0)
    return PoissonNear(RCUT, QB, E_COEF, G_COEF, USCALE), jax_near._pair_fn(), 1


def _pse(nvec):
    def make():
        jax_pse = JaxPSE(box=None, far=None, viscosity=1.0, radius=1.0, xi=1.0, rcut=RCUT,
                         spec=None, qb=QB, coef=PSE_COEF, uscale=USCALE, self_f=0.0,
                         fit_error=0.0)
        return PSENear(coef=PSE_COEF, uscale=USCALE, qb=QB, rcut=RCUT), \
            jax_pse._pair_fn(nvec)[0], nvec
    return make


FUNCTORS = {
    "dpd": _dpd, "sph_density": _sph_density, "sph_force": _sph_force, "lj_mix": _lj_mix,
    "lj_mix_masked": _lj_mix_masked, "poisson": _poisson, "pse_nvec1": _pse(1),
    "pse_nvec2": _pse(2),
}


def _channels(name, nvec, rng, n):
    """(ch_i, ch_j) as float32 numpy arrays of [n] per channel: occupied,
    distinct particles (pid, mass, charges and sigmas as the engines set
    them)."""
    def u(lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)

    def pair(make):
        return make(), make()

    if name == "dpd":
        ci, cj = ([u(-1, 1) for _ in range(3)] for _ in range(2))
        ci += [np.arange(n, dtype=np.float32), np.full(n, 7.0, np.float32)]
        cj += [np.arange(n, 2 * n, dtype=np.float32), np.full(n, 7.0, np.float32)]
        return ci, cj
    if name == "sph_density":
        return pair(lambda: [np.ones(n, np.float32)])
    if name == "sph_force":
        return pair(lambda: [u(0.5, 2.0), u(-1, 1), u(-1, 1), u(-1, 1), np.ones(n, np.float32)])
    if name == "lj_mix":
        return pair(lambda: [u(0.7, 1.0), u(0.3, 0.8)])
    if name == "lj_mix_masked":
        return pair(lambda: [u(0.7, 1.0), u(0.3, 0.8), (rng.random(n) < 0.5).astype(np.float32)])
    if name == "poisson":
        return pair(lambda: [np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)])
    return pair(lambda: [u(-1, 1) for _ in range(3 * nvec)])


def _reach(fn, ci, cj):
    """Each pair's reach (numpy [n]): the mixtures' depends on the pair's
    half_sigma channels."""
    if isinstance(fn, LJMixturePair):
        return np.array([fn.reach(float(a) + float(b)) for a, b in zip(ci[1], cj[1])])
    return np.full(len(ci[0]), fn.reach())


def _torch_terms(fn, nvec, d, ci, cj):
    t = [torch.from_numpy(a) for a in d]
    r2 = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
    ci_t = [torch.from_numpy(a) for a in ci]
    cj_t = [torch.from_numpy(a) for a in cj]
    if isinstance(fn, PSENear):
        return [a.numpy() for a in fn.pair_fn(nvec)(r2, *t, ci_t, cj_t)]
    return [a.numpy() for a in fn(r2, *t, ci_t, cj_t)]


def _displacements(rng, n, lo, hi):
    """[3] float32 arrays of n displacements of length uniform in (lo, hi)."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = rng.uniform(lo, hi)[:, None] if np.ndim(lo) else rng.uniform(lo, hi, n)[:, None]
    return [np.ascontiguousarray(c) for c in (v * r).astype(np.float32).T]


@pytest.mark.parametrize("name", sorted(FUNCTORS))
def test_plain_terms_vanish_beyond_the_reach(name):
    """A candidate the kernel culls gives exactly 0 in every sum of the
    plain version: finite pairs at distances in (R, 2R) of the functor's
    reach R (the mixtures' per pair, from random half_sigma)."""
    fn, _, nvec = FUNCTORS[name]()
    rng = np.random.default_rng(11)
    ci, cj = _channels(name, nvec, rng, 4096)
    R = _reach(fn, ci, cj)
    d = _displacements(rng, 4096, R * (1 + 1e-5), 2 * R)
    for k, t in enumerate(_torch_terms(fn, nvec, d, ci, cj)):
        assert np.all(t == 0.0), f"{name}: sum {k} is not 0 beyond the reach"
    # and the same functor does give terms inside it
    d_in = _displacements(rng, 4096, 0.2 * R, 0.9 * R)
    assert any(np.any(t != 0.0) for t in _torch_terms(fn, nvec, d_in, ci, cj))


def _nonfinite_batch(rng, R):
    """N_PAIRS displacements, a third inside the reach, with one component
    of most pairs set to NaN, +inf or -inf; returns (d, which component
    and value each pair carries, or None)."""
    d = _displacements(rng, N_PAIRS, 0.1 * R, 1.6 * R)
    marks = []
    for i in range(N_PAIRS):
        if i % 8 == 7:
            marks.append(None)
            continue
        a = i % 3
        v = (np.nan, np.inf, -np.inf)[(i // 3) % 3]
        d[a][i] = v
        marks.append((a, v))
    return d, marks


@pytest.mark.parametrize("name", sorted(FUNCTORS))
def test_plain_nan_matches_jax(name):
    """The plain functor and the JAX pair function put NaN in the same
    terms of the same pairs when a displacement component is NaN or
    infinite; their finite terms agree."""
    fn, jfn, nvec = FUNCTORS[name]()
    rng = np.random.default_rng(12)
    ci, cj = _channels(name, nvec, rng, N_PAIRS)
    d, _ = _nonfinite_batch(rng, float(np.max(_reach(fn, ci, cj))))
    got = _torch_terms(fn, nvec, d, ci, cj)

    def jax_terms(dx, dy, dz, ci_, cj_):
        return jfn(dx * dx + dy * dy + dz * dz, dx, dy, dz, ci_, cj_)

    want = [np.asarray(a, np.float32) for a in jax.jit(jax_terms)(*d, ci, cj)]
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(np.isnan(a), np.isnan(b)), f"{name}: NaN of sum {k}"
        assert np.isnan(b).any() or k in _dispfree(fn, nvec)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=2e-5, atol=1e-5 * np.abs(b[fin]).max(),
                                   err_msg=f"{name}: sum {k}")


def _dispfree(fn, nvec):
    return {k for k, c in enumerate(pair_kernel.displacement_sums(fn, nvec)) if not c}


@pytest.mark.parametrize("name", sorted(FUNCTORS))
def test_declared_displacement_sums(name):
    """``displacement_sums`` (the CUDA functor's kDisp) names exactly the
    sums that the plain version turns NaN, component by component."""
    fn, _, nvec = FUNCTORS[name]()
    rng = np.random.default_rng(13)
    ci, cj = _channels(name, nvec, rng, N_PAIRS)
    d, marks = _nonfinite_batch(rng, float(np.max(_reach(fn, ci, cj))))
    terms = _torch_terms(fn, nvec, d, ci, cj)
    declared = pair_kernel.displacement_sums(fn, nvec)
    assert len(declared) == len(terms)
    for i, mark in enumerate(marks):
        for k, t in enumerate(terms):
            expect = mark is not None and mark[0] in declared[k]
            assert bool(np.isnan(t[i])) == expect, (name, i, mark, k)
