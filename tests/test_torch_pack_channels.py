"""The port's channel layout (``layout.ChannelGrid``, ``pack_channels``,
``unpack_values``) and ``rebin_kernel.compact_mini_pids`` against the JAX
package's: equal slot for slot, stragglers included (no Pallas here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine.rebin_kernel import compact_mini_pids as j_compact
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.rebin_kernel import compact_mini_pids

N, L = 600, 26.0
FIELDS = ("x", "y", "z", "pid", "overflow", "spos", "spid")


def _spec_args():
    # tests/test_pse_engine.py:107's straggler system at the PSE engine's
    # spec options (cells of rcut 6, CAP below the fullest cell)
    rng = np.random.default_rng(7)
    pos = ((rng.random((N, 3)) - 0.5) * L).astype(np.float32)
    chans = rng.normal(size=(N, 4)).astype(np.float32)
    kw = dict(skin=1.0, cap=12, pos=pos, n_strag=128, strag_cell_excess=1 << 30,
              strag_headroom=1.5)
    return pos, chans, kw


@pytest.fixture(scope="module")
def packed():
    pos, chans, kw = _spec_args()
    spec_j = jl.choose_spec(L, N, 6.0, **kw)
    spec_t = tl.choose_spec(L, N, 6.0, ocap=None, **kw)
    cg_j = jax.jit(lambda p, c: jl.pack_channels(spec_j, p, c))(jnp.asarray(pos),
                                                              jnp.asarray(chans))
    cg_t = tl.pack_channels(spec_t, pos, chans, device="cpu")
    return spec_j, spec_t, cg_j, cg_t


def test_pack_channels_matches_jax(packed):
    _, spec_t, cg_j, cg_t = packed
    assert int((cg_t.spid >= 0).sum()) > 0, "want stragglers"
    assert not bool(cg_t.overflow)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(cg_t, k).numpy(), np.asarray(getattr(cg_j, k)),
                                      err_msg=k)
    assert len(cg_t.channels) == len(cg_j.channels) == 4
    for a, b in zip(cg_t.channels + cg_t.schannels, cg_j.channels + cg_j.schannels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tuple(cg_t.x.shape) == spec_t.array_shape


def test_pack_channels_without_stragglers_or_channels():
    pos, _, _ = _spec_args()
    spec_j = jl.choose_spec(L, N, 6.0, skin=1.0, pos=pos)
    spec_t = tl.choose_spec(L, N, 6.0, skin=1.0, pos=pos)
    empty = np.zeros((N, 0), np.float32)
    cg_j = jax.jit(lambda p, c: jl.pack_channels(spec_j, p, c))(jnp.asarray(pos),
                                                              jnp.asarray(empty))
    cg_t = tl.pack_channels(spec_t, torch.tensor(pos), torch.tensor(empty))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(cg_t, k).numpy(), np.asarray(getattr(cg_j, k)),
                                      err_msg=k)
    assert cg_t.channels == () and tuple(cg_t.spos.shape) == (0, 3)


def test_unpack_values_matches_jax(packed):
    _, _, cg_j, cg_t = packed
    vals_t = cg_t.channels[:3]
    svals_t = cg_t.schannels[:3]
    got = tl.unpack_values(cg_t, vals_t, svalues=svals_t).numpy()
    want = jax.jit(lambda c: jl.unpack_values(c, c.channels[:3], svalues=c.schannels[:3]))(cg_j)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the channels come back in pid order: the packed payload itself
    _, chans, _ = _spec_args()
    np.testing.assert_array_equal(got, chans[:, :3])


def test_channel_grid_numpy_carry(packed):
    _, spec_t, _, cg_t = packed
    back = tl.channel_grid_from_numpy(spec_t, tl.channel_grid_to_numpy(cg_t), device="cpu")
    for k in FIELDS:
        assert torch.equal(getattr(back, k), getattr(cg_t, k)), k
    assert all(torch.equal(a, b) for a, b in zip(back.channels, cg_t.channels))
    assert back.n == cg_t.n


@pytest.mark.parametrize("occupied", [5, 40])
def test_compact_mini_pids_matches_jax(occupied):
    """Occupied mini-grid entries in flat index order, the first S of them,
    as JAX's top_k gives them (fewer and more occupied entries than S)."""
    rng = np.random.default_rng(occupied)
    S = 24
    mini = np.zeros((4, 3, 2, 16, 10), np.float32)
    flat = mini[3].reshape(-1)
    where = rng.choice(flat.size, occupied, replace=False)
    flat[where] = rng.permutation(np.arange(1, occupied + 1)).astype(np.float32)
    mini[3] = flat.reshape(mini[3].shape)
    spid_j, count_j = jax.jit(lambda m: j_compact(m, S))(jnp.asarray(mini))
    spid_t, count_t = compact_mini_pids(torch.tensor(mini), S)
    np.testing.assert_array_equal(spid_t.numpy(), np.asarray(spid_j))
    assert int(count_t) == int(count_j) == occupied
    assert spid_t.dtype == torch.int32
