"""The port's Verlet neighbour list (uammd_tpu_torch.neighbors.neighbor_list)
against the JAX package's.

- ``idx`` equal to JAX's row for row (the valid candidates in stencil
  order, then the sentinel N) at n 500 and 2000 on jittered fcc liquids at
  rho 0.5, in float64 and float32; with ``include_self``; with an
  aperiodic z axis. JAX's ``_rebuild`` runs under ``jax.jit`` with the
  sizes its ``build_neighbor_list`` picks, which the port must pick too.
- Every pair within the cutoff found, none beyond it (brute force, as
  tests/test_neighbors.py:39 checks the JAX list).
- ``needs_rebuild`` / ``maybe_rebuild`` after displacements below and
  above half the skin, the rebuilt list equal to JAX's.
- ``ensure_capacity`` from too small a K and cell capacity reaching JAX's
  sizes and table.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as j_box
from uammd_tpu.core.grid import grid_from_cutoff as j_grid_from_cutoff
from uammd_tpu.neighbors import neighbor_list as jnl
from uammd_tpu.utils.lattices import lattice
from uammd_tpu_torch.core.box import box
from uammd_tpu_torch.neighbors import neighbor_list as tnl

DT = {"float32": (np.float32, jnp.float32, torch.float32),
      "float64": (np.float64, jnp.float64, torch.float64)}
_j_rebuild = jax.jit(jnl._rebuild, static_argnums=tuple(range(2, 9)))


def _liquid(n, rho=0.5, jitter=0.35, seed=0, np_dt=np.float64):
    L = (n / rho) ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    pos = lattice(n, L, "fcc") + rng.uniform(-jitter, jitter, (n, 3))
    return (pos - L * np.round(pos / L)).astype(np_dt), L


def j_sizes(pos, jb, cutoff, sm=1.2):
    """The sizes JAX's build_neighbor_list picks (neighbor_list.py:173-181)."""
    n = pos.shape[0]
    shape = j_grid_from_cutoff(jb, cutoff * sm)
    cap = max(4, int(math.ceil(n / (shape[0] * shape[1] * shape[2]) * 2.0)) + 4)
    k = jnl._auto_max_neighbors(n, float(jnp.prod(jb.size)), cutoff * sm)
    return shape, cap, k


def j_build(pos, jb, cutoff, sm=1.2, include_self=False, sizes=None):
    shape, cap, k = sizes or j_sizes(pos, jb, cutoff, sm)
    return _j_rebuild(jnp.asarray(pos), jb, cutoff, sm, shape, cap, k, 32768, include_self)


def _boxes(L, dt, periodic=(True, True, True)):
    _, jd, td = DT[dt]
    return j_box(L, periodic=periodic, dtype=jd), box(L, periodic=periodic, dtype=td,
                                                      device="cpu")


def _same(got, want):
    assert got.max_neighbors == want.max_neighbors
    assert got.cell_capacity == want.cell_capacity
    assert got.grid_shape == want.grid_shape
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert bool(got.overflow) == bool(want.overflow)


@pytest.mark.parametrize("dt", sorted(DT))
@pytest.mark.parametrize("n", [500, 2000])
def test_idx_matches_jax_row_for_row(n, dt):
    pos, L = _liquid(n, np_dt=DT[dt][0])
    jb, tb = _boxes(L, dt)
    want = j_build(pos, jb, 2.5)
    got = tnl.build_neighbor_list(torch.as_tensor(pos), tb, 2.5)
    _same(got, want)
    assert not bool(got.overflow)
    assert (got.idx < n).sum(1).min() > 20  # a liquid's rows are full
    back = tnl.neighbor_list_from_numpy(tnl.neighbor_list_to_numpy(got), tb)
    assert torch.equal(back.idx, got.idx) and back.grid_shape == got.grid_shape


def test_include_self_and_aperiodic_axis_match_jax():
    pos, L = _liquid(700, seed=1)
    jb, tb = _boxes(L, "float64")
    want = j_build(pos, jb, 2.0, include_self=True)
    got = tnl.build_neighbor_list(torch.as_tensor(pos), tb, 2.0, include_self=True)
    _same(got, want)
    assert bool((got.idx.long() == torch.arange(700)[:, None]).any(1).all())
    jb, tb = _boxes(L, "float64", (True, True, False))
    want = j_build(pos, jb, 2.0)
    got = tnl.build_neighbor_list(torch.as_tensor(pos), tb, 2.0)
    _same(got, want)


def brute_pairs(pos, L, rc):
    dr = pos[None] - pos[:, None]
    dr -= L * np.round(dr / L)
    r2 = (dr ** 2).sum(-1)
    np.fill_diagonal(r2, np.inf)
    return set(zip(*np.nonzero(r2 <= rc * rc)))


@pytest.mark.parametrize("n,L", [(200, 8.0), (400, 10.0)])
def test_list_matches_bruteforce(n, L):
    rng = np.random.default_rng(42)
    pos = (rng.random((n, 3)) - 0.5) * L
    rc = 2.0
    tb = box(L, dtype=torch.float64, device="cpu")
    p = torch.as_tensor(pos)
    nl = tnl.ensure_capacity(tnl.build_neighbor_list(p, tb, rc, skin_multiplier=1.0), p)
    idx = nl.idx.numpy()
    got = {(i, j) for i in range(n) for j in idx[i] if j < n}
    assert got == brute_pairs(pos, L, rc)


def test_needs_rebuild_and_maybe_rebuild_match_jax():
    pos, L = _liquid(500, seed=3)
    rc, sm = 2.0, 1.5
    jb, tb = _boxes(L, "float64")
    p = torch.as_tensor(pos)
    nl = tnl.build_neighbor_list(p, tb, rc, skin_multiplier=sm)
    assert not bool(nl.needs_rebuild(p))
    half = 0.5 * (sm - 1.0) * rc
    small = p.clone()
    small[0, 0] += 0.9 * half
    assert not bool(nl.needs_rebuild(small))
    assert tnl.maybe_rebuild(nl, small) is nl
    big = p.clone()
    big[0, 0] += 1.1 * half
    big[17] += torch.as_tensor(np.random.default_rng(4).normal(0, 0.4, 3))
    assert bool(nl.needs_rebuild(big))
    got = tnl.maybe_rebuild(nl, big)
    assert torch.equal(got.ref_pos, big)
    jl = j_build(pos, jb, rc, sm)
    want = jax.jit(jnl.maybe_rebuild)(jl, jnp.asarray(big.numpy()))
    _same(got, want)
    np.testing.assert_array_equal(got.ref_pos.numpy(), np.asarray(want.ref_pos))


def test_ensure_capacity_reaches_jax_sizes():
    rng = np.random.default_rng(5)
    n, L = 600, 8.0
    pos = (rng.random((n, 3)) - 0.5) * L
    jb, tb = _boxes(L, "float64")
    sizes = (j_grid_from_cutoff(jb, 2.4), 4, 8)
    jl = j_build(pos, jb, 2.0, sizes=sizes)
    assert bool(jl.overflow)
    while bool(jl.overflow):  # jnl.ensure_capacity, its rebuild jitted
        sizes = (sizes[0], 2 * jl.cell_capacity, 2 * jl.max_neighbors)
        jl = j_build(pos, jb, 2.0, sizes=sizes)
    p = torch.as_tensor(pos)
    tl = tnl.build_neighbor_list(p, tb, 2.0, max_neighbors=8, cell_capacity=4)
    assert bool(tl.overflow)
    tl2 = tnl.rebuild_neighbor_list(tl, p)
    assert bool(tl2.overflow)  # once set, kept
    got = tnl.ensure_capacity(tl, p)
    _same(got, jl)
    assert (got.max_neighbors, got.cell_capacity) != (8, 4)
    assert dataclasses.replace(got).chunk == 600
