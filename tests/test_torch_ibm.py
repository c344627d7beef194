"""The port's immersed-boundary kernels and direct spread/interpolate
(uammd_tpu_torch.solvers.ibm) against the JAX package's (uammd_tpu.solvers.ibm).

Tolerances: phi to 1e-12 and the direct spread/interpolate to 1e-12 (both
sides in float64, the atol of tests/test_pencil_ibm.py); the dispatch of
spread_auto to the pencil path to the same 1e-12 against the direct path.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.integrators.bdhi.fcm import _NormalizedBM as JNormBM
from uammd_tpu.solvers import ibm as ji
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.integrators.bdhi.fcm import _NormalizedBM as TNormBM
from uammd_tpu_torch.solvers import ibm as ti

REPO = Path(__file__).resolve().parents[1]

# The first multi-threaded float32 torch.exp of a process on some CPU
# builds can be off by ~1e-4 (a race in PyTorch's vectorised-math
# dispatch); one call up front settles it.
torch.exp(torch.zeros(1 << 20))

KERNELS = {
    "peskin3": (ji.Peskin3pt(), ti.Peskin3pt()),
    "peskin4": (ji.Peskin4pt(), ti.Peskin4pt()),
    "gaussian": (ji.GaussianKernel(sigma=1.1, support=8), ti.GaussianKernel(sigma=1.1, support=8)),
    "bm": (ji.BMKernel(beta=7.96, support=6), ti.BMKernel(beta=7.96, support=6)),
    "bm_normalized": (JNormBM(beta=7.96, support=6), TNormBM(beta=7.96, support=6)),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_phi_matches_jax(name):
    jk, tk = KERNELS[name]
    r = np.linspace(-5.0, 5.0, 4001)
    want = np.asarray(jk.phi(jnp.asarray(r)))
    got = tk.phi(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert tk.support == jk.support


@pytest.mark.parametrize("name", ["peskin3", "gaussian"])  # odd and even support
def test_direct_spread_interpolate_match_jax(name):
    jk, tk = KERNELS[name]
    rng = np.random.default_rng(3)
    shape, n = (12, 10, 9), 200
    Ls = [m * 0.7 for m in shape]
    pos = (rng.random((n, 3)) - 0.5) * np.asarray(Ls) * 1.3  # some outside the box
    q = rng.normal(size=(n, 3))
    u = rng.normal(size=shape + (3,))
    jb, tb = jbox(Ls, dtype=jnp.float64), tbox(Ls, dtype=torch.float64, device="cpu")
    f_j, v_j = (np.asarray(a) for a in jax.jit(
        lambda p, q, u: (ji.spread(jk, p, q, shape, jb), ji.interpolate(jk, p, u, jb)))(
            jnp.asarray(pos), jnp.asarray(q), jnp.asarray(u)))
    f_t = ti.spread(tk, torch.as_tensor(pos), torch.as_tensor(q), shape, tb).numpy()
    np.testing.assert_allclose(f_t, f_j, atol=1e-12)
    v_t = ti.interpolate(tk, torch.as_tensor(pos), torch.as_tensor(u), tb).numpy()
    np.testing.assert_allclose(v_t, v_j, atol=1e-12)
    # scalar values keep the squeezed shape
    s_t = ti.spread(tk, torch.as_tensor(pos), torch.as_tensor(q[:, 0]), shape, tb)
    assert tuple(s_t.shape) == shape
    np.testing.assert_allclose(s_t.numpy(), f_t[..., 0], atol=1e-12)


def test_auto_dispatch_pencil_matches_direct():
    """spread_auto / interpolate_auto over the threshold on a pencil-safe
    grid take the pencil path and equal the direct path (as
    tests/test_pencil_ibm.py:136 holds the JAX dispatch)."""
    rng = np.random.default_rng(4)
    shape, kern = (24, 24, 20), ti.GaussianKernel(sigma=1.2, support=8)
    n, Ls = 600, [m * 0.5 for m in shape]
    tb = tbox(Ls, dtype=torch.float64, device="cpu")
    pos = torch.as_tensor((rng.random((n, 3)) - 0.5) * np.asarray(Ls))
    q = torch.as_tensor(rng.normal(size=(n, 3)))
    f_auto = ti.spread_auto(kern, pos, q, shape, tb, threshold=500)
    np.testing.assert_allclose(f_auto.numpy(), ti.spread(kern, pos, q, shape, tb).numpy(),
                               atol=1e-12)
    u = torch.as_tensor(rng.normal(size=shape + (3,)))
    v_auto = ti.interpolate_auto(kern, pos, u, tb, threshold=500)
    np.testing.assert_allclose(v_auto.numpy(), ti.interpolate(kern, pos, u, tb).numpy(),
                               atol=1e-12)


def test_poison():
    x = torch.ones(4, 3)
    assert torch.equal(ti._poison(x, torch.tensor(False)), x)
    assert bool(ti._poison(x, torch.tensor(True)).isnan().all())


def test_cuda_sources_share_phi():
    """pencil_spread.cu and pencil_interp.cu take phi, the tile's candidates
    and their weights from one shared header (the tile loop), so the spread
    and the interpolation cannot drift apart."""
    csrc = REPO / "uammd_tpu_torch" / "engine" / "csrc"
    common = (csrc / "pencil_common.cuh").read_text()
    for name in ("float phi(", "void tile_loop("):
        assert name in common
    for src in ("pencil_spread.cu", "pencil_interp.cu"):
        text = (csrc / src).read_text()
        assert '#include "pencil_common.cuh"' in text
        assert "float phi(" not in text and "void tile_loop(" not in text
        assert "phi(k," not in text  # no weight of its own
        assert "tile_loop<TZ>(" in text
