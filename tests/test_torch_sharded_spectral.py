"""The port's sharded spectral FCM (uammd_tpu_torch.parallel.spectral)
against the JAX package's (uammd_tpu/parallel/spectral.py) on a 4-device
mesh: the PSE far field (the sinc^2 / Hasimoto envelope) of
tests/test_sharded_spectral.py:73-118, on a grid whose kz needs no pad and
on one whose nz / 2 + 1 is padded to the mesh (test_sharded_spectral.py:43),
at T = 0 and with the k-space noise fed with JAX's own draws
(``fold_in(key, shard)``) to the port's ``_z`` form. Both sides in float64;
the JAX tests hold the sharded path to the single-device one within 1e-10
of max|ref|, and the port to JAX is held to the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from uammd_tpu.core.box import box as j_box
from uammd_tpu.integrators.bdhi.fcm import FCM as JFCM
from uammd_tpu.parallel import spectral as js
from uammd_tpu_torch.core.box import box as t_box
from uammd_tpu_torch.parallel import spectral as ts
from uammd_tpu_torch.parallel.mesh import make_mesh

D = 4
TOL = 1e-10
CASES = {  # name: (n, L, viscosity, shape, support, sigma_split)
    "pse_48": (200, 16.0, 1.1, (48, 48, 48), 6, 0.8),
    "kz_pad_36": (128, 14.0, 1.0, (40, 36, 36), 4, 0.5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name):
    n, L, eta, shape, support, sig = CASES[name]
    rng = np.random.default_rng(3)
    pos = (rng.random((n, 3)) - 0.5) * L
    F = rng.normal(size=(n, 3))
    kw = dict(viscosity=eta, radius=sig * np.sqrt(np.pi), shape=shape, support=support,
              rpy_sinc_radius=1.0, hasimoto_k2=sig ** 2)
    return n, L, pos, F, kw


def _port(L, pos, F, kw, noise=None, amp=None):
    b = t_box(L, dtype=torch.float64, device="cpu")
    mesh = make_mesh(D, devices=["cpu"] * D)
    pos_sh, f_sh, mask, order = ts.shard_particles_x(torch.from_numpy(pos), torch.from_numpy(F),
                                                     D, b)
    mf = ts.make_sharded_fcm_mf(mesh, b, noise=noise is not None, **kw)
    out = mf(pos_sh, f_sh, mask, noise, amp)
    return ts.gather_shards(out, mask, order, pos.shape[0]).numpy(), mf


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_fcm_mf_matches_jax(name):
    n, L, pos, F, kw = _setup(name)
    jmesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    b = j_box(L)
    mf = js.make_sharded_fcm_mf(jmesh, b, axis="x", **kw)
    pos_sh, f_sh, mask, order = js.shard_particles_x(jnp.asarray(pos), jnp.asarray(F), D, b)
    want = np.asarray(js.gather_shards(mf(pos_sh, f_sh, mask), mask, order, n))
    got, _ = _port(L, pos, F, kw)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err
    # and the single-device FCM (tests/test_sharded_spectral.py:94-102)
    one = JFCM(box=b, box_size=(L, L, L), **kw)
    ref = np.asarray(one.compute_mf(jnp.asarray(pos), jnp.asarray(F)))
    assert np.abs(got - ref).max() / np.abs(ref).max() < TOL


def test_sharded_fcm_noise_z_matches_jax():
    """The fused k-space noise with JAX's per-shard draws fed to the port."""
    n, L, pos, F, kw = _setup("pse_48")
    jmesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    b = j_box(L)
    mf = js.make_sharded_fcm_mf(jmesh, b, axis="x", noise=True, **kw)
    pos_sh, f_sh, mask, order = js.shard_particles_x(jnp.asarray(pos), jnp.asarray(F), D, b)
    key, amp = jax.random.key(5), 0.7
    want = np.asarray(js.gather_shards(mf(pos_sh, f_sh, mask, key, amp), mask, order, n))
    nx, ny, nz = kw["shape"]
    draw = jax.jit(lambda k: jnp.stack([
        jax.random.normal(jax.random.fold_in(k, i), (nx // D, ny, nz, 3), jnp.float64)
        for i in range(D)]))
    noise = [torch.from_numpy(np.array(w)) for w in np.asarray(draw(key))]
    got, port_mf = _port(L, pos, F, kw, noise=noise, amp=amp)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err
    # the noise moves the result (amp 0 is the T = 0 product)
    got0, _ = _port(L, pos, F, kw, noise=noise, amp=0.0)
    assert np.abs(got - got0).max() > 1e-3 * np.abs(got0).max()
    assert len(port_mf.draw(torch.Generator().manual_seed(0), torch.float64)) == D
