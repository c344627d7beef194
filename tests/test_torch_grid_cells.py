"""The port's Grid and cell list (uammd_tpu_torch.core.grid,
uammd_tpu_torch.neighbors.cell_list) against the JAX package's.

- ``Grid.cell_of`` equal to JAX's on seeded positions and on every face
  value (-L/2, +L/2 and the floats 1 ulp inside each), in float32 and
  float64; ``cell_index``/``cell_coords`` a round trip.
- ``build_cell_list``: table, counts, particle cells and overflow equal
  to JAX's slot for slot, with a crammed case that sets the flag.
- ``neighbor_cell_indices`` on periodic and aperiodic axes, in JAX's
  stencil order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as j_box
from uammd_tpu.core.grid import Grid as JGrid
from uammd_tpu.core.grid import grid_from_cutoff as j_grid_from_cutoff
from uammd_tpu.neighbors import cell_list as jcl
from uammd_tpu_torch.core.box import box
from uammd_tpu_torch.core.grid import Grid, grid_from_cutoff
from uammd_tpu_torch.neighbors import cell_list as tcl

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "float64": (np.float64, jnp.float64, torch.float64)}
L = (7.3, 9.1, 11.0)
SHAPE = (5, 6, 7)


def _boxes(dt, periodic=(True, True, True)):
    _, jd, td = DTYPES[dt]
    return (j_box(L, periodic=periodic, dtype=jd),
            box(L, periodic=periodic, dtype=td, device="cpu"))


def _face_positions(np_dt):
    """Each axis on -L/2, +L/2 and 1 ulp inside each, the other axes at
    seeded values."""
    rng = np.random.default_rng(3)
    rows = []
    for ax in range(3):
        h = np_dt(L[ax]) / np_dt(2)
        for v in (-h, h, np.nextafter(-h, np_dt(0)), np.nextafter(h, np_dt(0))):
            p = rng.uniform(-3, 3, 3).astype(np_dt)
            p[ax] = v
            rows.append(p)
    return np.asarray(rows, dtype=np_dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_cell_of_matches_jax_including_faces(dt):
    np_dt, _, _ = DTYPES[dt]
    jb, tb = _boxes(dt)
    rng = np.random.default_rng(0)
    pos = np.concatenate([rng.uniform(-6, 6, (500, 3)).astype(np_dt), _face_positions(np_dt)])
    want = np.asarray(jax.jit(lambda b, p: JGrid(box=b, shape=SHAPE).cell_of(p))(jb, pos))
    got = Grid(box=tb, shape=SHAPE).cell_of(torch.as_tensor(pos))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and (got.numpy() < np.asarray(SHAPE)).all()


def test_cell_index_round_trip_and_grid_sizes():
    jb, tb = _boxes("float32")
    g = Grid(box=tb, shape=SHAPE)
    flat = torch.arange(g.n_cells)
    coords = g.cell_coords(flat)
    np.testing.assert_array_equal(g.cell_index(coords).numpy(), flat.numpy())
    assert coords[1].tolist() == [1, 0, 0]  # x fastest
    np.testing.assert_array_equal(g.wrap_cell(coords - 2).numpy(),
                                  np.asarray(JGrid(box=jb, shape=SHAPE).wrap_cell(
                                      jnp.asarray(coords.numpy() - 2))))
    jg = JGrid(box=jb, shape=SHAPE)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(jg.cell_coords(jnp.arange(210))))
    np.testing.assert_allclose(g.cell_size.numpy(), np.asarray(jg.cell_size), rtol=1e-7)
    np.testing.assert_allclose(g.cell_centers().numpy(), np.asarray(jg.cell_centers()),
                               rtol=1e-6, atol=1e-6)
    for rc in (0.9, 2.5, 3.0, 4.0):
        assert grid_from_cutoff(tb, rc) == j_grid_from_cutoff(jb, rc)


@pytest.mark.parametrize("case", ["liquid", "crammed"])
def test_build_cell_list_matches_jax_slot_for_slot(case):
    jb, tb = _boxes("float64")
    rng = np.random.default_rng(1)
    pos = rng.uniform(-0.5, 0.5, (400, 3)) * np.asarray(L)
    cap = 8
    if case == "crammed":
        pos[:40] = rng.uniform(-0.2, 0.2, (40, 3))
    want = jax.jit(lambda b, p: jcl.build_cell_list(p, JGrid(box=b, shape=SHAPE), cap))(jb, pos)
    got = tcl.build_cell_list(torch.as_tensor(pos), Grid(box=tb, shape=SHAPE), cap)
    np.testing.assert_array_equal(got.cell_grid.numpy(), np.asarray(want.cell_grid))
    np.testing.assert_array_equal(got.cell_count.numpy(), np.asarray(want.cell_count))
    np.testing.assert_array_equal(got.particle_cell.numpy(), np.asarray(want.particle_cell))
    assert bool(got.overflow) == bool(want.overflow) == (case == "crammed")
    assert got.capacity == cap and got.n_particles == 400


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, True),
                                      (False, False, False)])
def test_neighbor_cell_indices_match_jax(periodic):
    jb, tb = _boxes("float32", periodic)
    cells = np.array([[0, 0, 0], [4, 5, 6], [2, 3, 0], [0, 5, 3]], dtype=np.int32)
    want = np.asarray(jcl.neighbor_cell_indices(JGrid(box=jb, shape=SHAPE), jnp.asarray(cells)))
    got = tcl.neighbor_cell_indices(Grid(box=tb, shape=SHAPE), torch.as_tensor(cells))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tcl.stencil_offsets(2).numpy(),
                                  np.asarray(jcl.stencil_offsets(2)))
    assert tcl.make_grid(tb, 1.5).shape == jcl.make_grid(jb, 1.5).shape
