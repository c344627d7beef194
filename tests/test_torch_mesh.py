"""The port's in-process mesh and its collectives
(uammd_tpu_torch.parallel.mesh), against what ``jax.lax.ppermute``,
``psum`` and ``pmax`` compute under ``shard_map`` on 4 virtual devices.
Exact: the collectives only copy, add small integers and take maxima."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from uammd_tpu_torch.parallel import mesh as tm

N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small plain-torch runs gain nothing from more threads, and the
    test tier runs files in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_collective(fn, a):
    mesh = Mesh(np.array(jax.devices()[:N]), ("z",))
    return np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("z"),
                                            out_specs=P("z")))(a))


@pytest.mark.parametrize("ring", ["up", "dn"])
def test_ppermute_rings_match_jax(ring):
    a = np.arange(N * 6, dtype=np.float32).reshape(N * 2, 3)
    perm = tm.perm_up(N) if ring == "up" else tm.perm_dn(N)
    want = _jax_collective(lambda x: jax.lax.ppermute(x, "z", perm), a)
    shards = [torch.from_numpy(p.copy()) for p in np.split(a, N)]
    got = tm.ppermute(shards, perm)
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got]), want)
    # fresh copies: writing into a result leaves the sender's tensor alone
    got[1][0, 0] = -1.0
    assert all(float(s.min()) >= 0 for s in shards)


def test_ppermute_partial_perm_gives_zeros():
    shards = [torch.full((2,), float(i + 1)) for i in range(N)]
    got = tm.ppermute(shards, [(0, 1)])
    assert got[1].tolist() == [1.0, 1.0]
    assert all(g.abs().sum() == 0 for i, g in enumerate(got) if i != 1)


def test_psum_pmax_axis_index_match_jax():
    a = np.array([3.0, -1.0, 7.0, 2.0], np.float32)
    want_sum = _jax_collective(lambda x: jax.lax.psum(x, "z"), a)
    want_max = _jax_collective(lambda x: jax.lax.pmax(x, "z"), a)
    want_idx = _jax_collective(lambda x: x * 0 + jax.lax.axis_index("z"), a)
    shards = [torch.tensor(v) for v in a]
    np.testing.assert_array_equal([float(t) for t in tm.psum(shards)], want_sum)
    np.testing.assert_array_equal([float(t) for t in tm.pmax(shards)], want_max)
    mesh = tm.make_mesh(N, devices=["cpu"] * N)
    np.testing.assert_array_equal(list(tm.axis_index(mesh)), want_idx)


def test_make_mesh_checks_devices():
    mesh = tm.make_mesh(3, devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.axis == "z"
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError, match="needs 4 devices"):
        tm.make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="at least one"):
        tm.make_mesh(0, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tm.make_mesh(2)


@pytest.mark.parametrize("split_dim,concat_dim", [(0, 0), (2, 0), (0, 2), (1, 2)])
def test_all_to_all_matches_jax(split_dim, concat_dim):
    """The tiled ``jax.lax.all_to_all`` of spectral.py's distributed FFT
    (kz split, x gather, and back) and pse_dd2.py's bucket exchange."""
    rng = np.random.default_rng(split_dim * 3 + concat_dim)
    shape = [N * N, 4, 8]  # the leading axis holds the N shards
    a = rng.normal(size=shape).astype(np.float32)
    want = _jax_collective(lambda x: jax.lax.all_to_all(
        x, "z", split_axis=split_dim, concat_axis=concat_dim, tiled=True), a)
    shards = [torch.from_numpy(p.copy()) for p in np.split(a, N)]
    got = tm.all_to_all(shards, split_dim, concat_dim)
    np.testing.assert_array_equal(np.concatenate([g.numpy() for g in got]), want)
    got[0].zero_()  # fresh copies
    assert all(float(s.abs().sum()) > 0 for s in shards)


def test_all_to_all_needs_equal_chunks():
    with pytest.raises(ValueError, match="does not split"):
        tm.all_to_all([torch.zeros(3, 2) for _ in range(N)], 0, 0)
