"""The port's LJ mixtures (uammd_tpu_torch.engine.mixtures) against the JAX
package's (the channel kernel #2 in Pallas interpret mode on the CPU).

- both pair functors against JAX's ``lj_mixture_pair_fn`` and
  ``lj_mixture_pair_fn_masked`` on random pairs (float32 round-off);
- ``MixtureLJ.forces`` on tests/test_mixtures.py:32's binary mixture (n 300,
  L 14, eps 1.0 / 0.5, sigma 1.0 / 1.6, cut_scale 2.5, CAP 32) and
  ``MixtureLJHierarchical.forces`` on test_mixtures.py:67's size-ratio-8
  mixture, each within 5e-5 of max|f| of JAX's (test_mixtures.py's bar):
  float32 sums in another order;
- ``gpu``: both CUDA functors against their plain versions, one launch each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import mixtures as jm
from uammd_tpu_torch.engine import mixtures as tm
from uammd_tpu_torch.engine import pair_kernel as tp

TOL = 5e-5


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _binary():
    rng = np.random.default_rng(0)
    n, L = 300, 14.0
    pos = ((rng.random((n, 3)) - 0.5) * L).astype(np.float32)
    t = rng.integers(0, 2, n)
    return pos, np.where(t == 0, 1.0, 0.5), np.where(t == 0, 1.0, 1.6), L


def _hierarchy():
    rng = np.random.default_rng(11)
    L, n_small, n_large = 36.0, 300, 16
    sigma = np.concatenate([np.full(n_small, 0.5), np.full(n_large, 4.0)])
    epsilon = np.concatenate([np.full(n_small, 1.0), np.full(n_large, 0.6)])
    pos = ((rng.random((n_small + n_large, 3)) - 0.5) * L).astype(np.float32)
    return pos, epsilon, sigma, L


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(np.asarray(got) - want).max() / scale
    assert err < TOL, err


def test_functors_match_jax():
    rng = np.random.default_rng(2)
    shape = (64, 64)
    d = [rng.normal(0.0, 1.5, shape).astype(np.float32) for _ in range(3)]
    r2 = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).astype(np.float32)
    ch_i = [np.sqrt(rng.uniform(0.2, 1.0, shape)).astype(np.float32),
            rng.uniform(0.2, 1.0, shape).astype(np.float32),
            rng.integers(0, 2, shape).astype(np.float32)]
    ch_j = [np.roll(c, 1, axis=1) for c in ch_i]
    ch_i[0][0, :8] = 0.0  # empty slots: zero channels
    ch_i[1][0, :8] = 0.0
    for t_fn, j_fn, nc in ((tm.LJMixturePair(2.5), jm.lj_mixture_pair_fn(2.5), 2),
                           (tm.LJMixturePairMasked(2.5), jm.lj_mixture_pair_fn_masked(2.5), 3)):
        want = jax.jit(lambda *a: j_fn(a[0], a[1], a[2], a[3], a[4:4 + nc], a[4 + nc:]))(
            r2, *d, *ch_i[:nc], *ch_j[:nc])
        tt = [torch.from_numpy(a) for a in [r2, *d]]
        got = t_fn(*tt, [torch.from_numpy(c) for c in ch_i[:nc]],
                   [torch.from_numpy(c) for c in ch_j[:nc]])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6 * np.abs(np.asarray(b)).max())
            assert np.all(a.numpy()[0, :8] == 0.0)


def test_binary_mixture_matches_jax():
    pos, eps, sig, L = _binary()
    mt = tm.MixtureLJ.create(L, len(pos), eps, sig, cut_scale=2.5, device="cpu")
    mj = jm.MixtureLJ.create(L, len(pos), eps, sig, cut_scale=2.5, interpret=True)
    assert mt.spec.cap == mj.spec.cap and mt.spec.shape == mj.spec.shape
    out_t, ovf_t = mt.forces(pos, eps, sig)
    args = (jnp.asarray(pos), jnp.asarray(eps, jnp.float32), jnp.asarray(sig, jnp.float32))
    out_j, ovf_j = _jit0(mj.forces, *args)(*args)
    assert not bool(ovf_t) and not bool(ovf_j)
    _close(out_t.numpy(), out_j)


def test_hierarchical_matches_jax():
    pos, eps, sig, L = _hierarchy()
    n = len(pos)
    mt = tm.MixtureLJHierarchical.create(L, n, eps, sig, cut_scale=2.5, device="cpu")
    mj = jm.MixtureLJHierarchical.create(L, n, eps, sig, cut_scale=2.5, interpret=True)
    assert mt.small_idx == mj.small_idx and mt.fine.spec.cutoff < 2.0
    out_t, ovf_t = mt.forces(pos, eps, sig)
    args = (jnp.asarray(pos), jnp.asarray(eps, jnp.float32), jnp.asarray(sig, jnp.float32))
    out_j, ovf_j = _jit0(mj.forces, *args)(*args)
    assert not bool(ovf_t) and not bool(ovf_j)
    _close(out_t.numpy(), out_j)


def test_hierarchical_rejects_an_empty_group():
    pos, eps, sig, L = _binary()
    with pytest.raises(ValueError, match="empty"):
        tm.MixtureLJHierarchical.create(L, len(pos), eps, sig, sigma_split=0.5, device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_mixture_functors_match_plain(cuda):
    pos, eps, sig, L = _hierarchy()
    n = len(pos)
    m_c = tm.MixtureLJHierarchical.create(L, n, eps, sig, cut_scale=2.5, device=cuda)
    m_p = tm.MixtureLJHierarchical.create(L, n, eps, sig, cut_scale=2.5, device="cpu")
    counts = (tp.PAIR_CHANNEL_LJ_MIX.launches, tp.PAIR_CHANNEL_LJ_MIX_MASKED.launches)
    got, _ = m_c.forces(pos, eps, sig)
    torch.cuda.synchronize()
    assert (tp.PAIR_CHANNEL_LJ_MIX.launches, tp.PAIR_CHANNEL_LJ_MIX_MASKED.launches) == (
        counts[0] + 1, counts[1] + 1)
    want, _ = m_p.forces(pos, eps, sig)
    assert float((got.cpu() - want).abs().max()) < 2e-5 * float(want.abs().max())
