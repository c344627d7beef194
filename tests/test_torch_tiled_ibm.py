"""The port's tiled spread / interpolate (uammd_tpu_torch.solvers.tiled_ibm)
and the auto dispatch's tiled branch, against the port's direct path and
the JAX package's tiled path, float64 (the cases of tests/test_tiled_ibm.py).

- tile 4 and 8, whole and padded tiles, Gaussian and Peskin 3-point:
  within 1e-12 of the direct path and of JAX's ``spread_tiled`` /
  ``interpolate_tiled``; partial tiles, particles on the box's faces and on
  tile seams; the overflow flag; ``tile_shape_ok`` / ``pick_tile`` equal to
  JAX's over a sweep; an unsafe shape refused;
- the auto dispatch: pencil -> tiled -> direct as JAX's. On a tile-safe,
  pencil-unsafe grid at N >= 4096 it bins by tile (counted) and gives
  JAX's ``spread_auto`` / ``interpolate_auto``; a tile overflow
  NaN-poisons it (tests/test_tiled_ibm.py:96 holds JAX's to the same); an
  unsafe grid falls back to the direct path.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.solvers import ibm as jibm
from uammd_tpu.solvers import tiled_ibm as jt
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.solvers import ibm as tibm
from uammd_tpu_torch.solvers import tiled_ibm as tt

KERNELS = {"gauss": (jibm.GaussianKernel(sigma=1.2, support=8),
                     tibm.GaussianKernel(sigma=1.2, support=8)),
           "peskin3": (jibm.Peskin3pt(), tibm.Peskin3pt())}


def _boxes(L):
    return jbox(L, dtype=jnp.float64), tbox(L, dtype=torch.float64, device="cpu")


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("tile", [4, 8], ids=["tile4", "tile8"])
@pytest.mark.parametrize("m", [36, 40], ids=["padded", "exact-tiles"])
@pytest.mark.parametrize("kname", list(KERNELS))
def test_tiled_matches_direct_and_jax(kname, m, tile):
    jk, tk = KERNELS[kname]
    rng = np.random.default_rng(0)
    n, L = 500, float(m) * 0.61
    jb, tb = _boxes(L)
    pos = (rng.random((n, 3)) - 0.5) * L
    q = rng.normal(size=(n, 3))
    u = rng.normal(size=(m, m, m, 3))
    tpos = torch.as_tensor(pos)
    f_t, ovf = tt.spread_tiled(tk, tpos, torch.as_tensor(q), (m, m, m), tb, tile=tile)
    assert not bool(ovf)
    _close(f_t, tibm.spread(tk, tpos, torch.as_tensor(q), (m, m, m), tb))
    v_t, _ = tt.interpolate_tiled(tk, tpos, torch.as_tensor(u), tb, tile=tile)
    _close(v_t, tibm.interpolate(tk, tpos, torch.as_tensor(u), tb))
    if kname == "gauss" and (m == 36) == (tile == 4):  # JAX's tiled path (a compile a case)
        f_j, _ = jax.jit(lambda p, v: jt.spread_tiled(jk, p, v, (m, m, m), jb, tile=tile))(
            jnp.asarray(pos), jnp.asarray(q))
        v_j, _ = jax.jit(lambda p, w: jt.interpolate_tiled(jk, p, w, jb, tile=tile))(
            jnp.asarray(pos), jnp.asarray(u))
        _close(f_t, f_j)
        _close(v_t, v_j)


def test_tile_predicates_match_jax():
    for shape in itertools.product((16, 24, 25, 26, 35, 36, 40), (36, 40)):
        shape = shape + (40,)
        for support in (3, 4, 6, 8, 10, 16):
            assert tt.pick_tile(shape, support) == jt.pick_tile(shape, support)
            for tile in (4, 8):
                assert tt.tile_shape_ok(shape, support, tile) == jt.tile_shape_ok(
                    shape, support, tile), (shape, support, tile)
    # tests/test_tiled_ibm.py's cases
    assert tt.tile_shape_ok((35, 40, 40), 6) and not tt.tile_shape_ok((26, 40, 40), 6)
    assert tt.tile_shape_ok((36, 40, 40), 8) and not tt.tile_shape_ok((35, 40, 40), 8)
    assert not tt.tile_shape_ok((16, 40, 40), 6)
    with pytest.raises(ValueError, match="partial trailing tile"):
        tt.spread_tiled(tibm.GaussianKernel(sigma=1.0, support=6),
                        torch.zeros((10, 3), dtype=torch.float64),
                        torch.ones((10, 1), dtype=torch.float64), (26, 26, 26), _boxes(26.0)[1])


def test_partial_tiles_boundary_particles_and_overflow():
    rng = np.random.default_rng(5)
    m, n = 35, 600
    L = float(m) * 0.61
    _, tb = _boxes(L)
    kern = tibm.GaussianKernel(sigma=1.0, support=6)
    pos = torch.as_tensor((rng.random((n, 3)) - 0.5) * L)
    q = torch.as_tensor(rng.normal(size=(n, 2)))
    f, ovf = tt.spread_tiled(kern, pos, q, (m, m, m), tb, cap=24)
    assert not bool(ovf)
    _close(f, tibm.spread(kern, pos, q, (m, m, m), tb))
    u = torch.as_tensor(rng.normal(size=(m, m, m, 2)))
    _close(tt.interpolate_tiled(kern, pos, u, tb, cap=24)[0], tibm.interpolate(kern, pos, u, tb))
    # the box's faces and a tile seam (8 nodes x h 0.5 = 4.0)
    m, L = 40, 20.0
    _, tb = _boxes(L)
    edge = torch.tensor([[-10.0, -10.0, -10.0], [9.999, 9.999, 9.999], [0.0, 0.0, 0.0],
                         [-6.0, 0.0, 0.0]], dtype=torch.float64)
    ones = torch.ones(4, dtype=torch.float64)
    f, _ = tt.spread_tiled(tibm.Peskin3pt(), edge, ones, (m, m, m), tb)
    _close(f, tibm.spread(tibm.Peskin3pt(), edge, ones, (m, m, m), tb), 1e-13)
    assert float(f.sum() * (L / m) ** 3) == pytest.approx(4.0, rel=1e-12)
    # all in one tile past the capacity: the flag, as JAX's
    _, tb = _boxes(30.0)
    _, ovf = tt.spread_tiled(tibm.Peskin3pt(), torch.zeros((200, 3), dtype=torch.float64),
                             torch.ones((200, 1), dtype=torch.float64), (32, 32, 32), tb, cap=8)
    assert bool(ovf)


def test_auto_dispatch_takes_the_tiled_path_as_jax(monkeypatch):
    """A tile-safe, pencil-unsafe grid (36 % 8 != 0) at N = 4500: the port's
    auto dispatch bins by tile, as JAX's does, and gives JAX's result; with
    a clustered state and cap 8 it NaN-poisons, as JAX's does (the direct
    path would not)."""
    m, n = 36, 4500
    L = m * 0.61
    jb, tb = _boxes(L)
    jk, tk = KERNELS["gauss"]
    assert not tibm.pencil_ok((m, m, m), tk.support)
    assert tt.tile_shape_ok((m, m, m), tk.support, tt.pick_tile((m, m, m), tk.support))
    calls = []
    real = tt._bin_by_tile
    monkeypatch.setattr(tt, "_bin_by_tile", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    pos = (rng.random((n, 3)) - 0.5) * L
    q = rng.normal(size=(n, 3))
    u = rng.normal(size=(m, m, m, 3))
    f = tibm.spread_auto(tk, torch.as_tensor(pos), torch.as_tensor(q), (m, m, m), tb)
    v = tibm.interpolate_auto(tk, torch.as_tensor(pos), torch.as_tensor(u), tb)
    assert len(calls) == 2
    _close(f, jax.jit(lambda p, w: jibm.spread_auto(jk, p, w, (m, m, m), jb))(
        jnp.asarray(pos), jnp.asarray(q)))
    _close(v, jax.jit(lambda p, w: jibm.interpolate_auto(jk, p, w, jb))(
        jnp.asarray(pos), jnp.asarray(u)))
    clump = torch.full((5000, 3), 0.1, dtype=torch.float64)
    ones = torch.ones((5000, 3), dtype=torch.float64)
    assert bool(tibm.spread_auto(tk, clump, ones, (m, m, m), tb, cap=8).isnan().any())
    assert bool(tibm.interpolate_auto(tk, clump, torch.as_tensor(u), tb, cap=8).isnan().any())


def test_auto_falls_back_to_direct_on_an_unsafe_shape():
    rng = np.random.default_rng(3)
    m, n = 26, 4500
    L = float(m) * 0.7
    _, tb = _boxes(L)
    kern = tibm.GaussianKernel(sigma=1.1, support=6)
    pos = torch.as_tensor((rng.random((n, 3)) - 0.5) * L)
    q = torch.as_tensor(rng.normal(size=(n, 3)))
    assert torch.equal(tibm.spread_auto(kern, pos, q, (m, m, m), tb),
                       tibm.spread(kern, pos, q, (m, m, m), tb))
    u = torch.as_tensor(rng.normal(size=(m, m, m)))
    assert torch.equal(tibm.interpolate_auto(kern, pos, u, tb), tibm.interpolate(kern, pos, u, tb))
