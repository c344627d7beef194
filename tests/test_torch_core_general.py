"""The port's general-path foundations against the JAX package's: the
counter RNG (uammd_tpu_torch.core.rng), ``SimState.permute`` and
``spatial_sort`` (core.state), the groups (core.groups) and
``core.types.real_dtype``.

- ``hash_u32``, ``pair_counter`` and the uniform bits bit-equal to JAX's
  on seeded int32 words (negative ones too) and on extreme words;
  ``pair_uniform`` exactly, ``pair_normal`` within 1e-6 (float32) and
  1e-12 (float64): it passes through log1p and cos.
- ``permute`` and ``spatial_sort`` equal to JAX's, every property and the
  ``extra`` fields carried, ids kept.
- each selector's mask and ``apply_masked`` equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core import groups as jg
from uammd_tpu.core import rng as jrng
from uammd_tpu.core.box import box as j_box
from uammd_tpu.core.state import make_state as j_make_state
from uammd_tpu.core.state import spatial_sort as j_spatial_sort
from uammd_tpu_torch.core import groups as tg
from uammd_tpu_torch.core import rng as trng
from uammd_tpu_torch.core.box import box
from uammd_tpu_torch.core.state import make_state, spatial_sort
from uammd_tpu_torch.core.types import real_dtype


def _words(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, (3, n), dtype=np.int64).astype(np.int32)
    w[:, :6] = np.array([[0, -1, 2**31 - 1, -2**31, 1, 7]] * 3, dtype=np.int32)
    return w


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def test_hashes_are_bit_equal_to_jax():
    a, b, c = _words()
    f = jax.jit(lambda a, b, c: (jrng.hash_u32(a), jrng.hash_u32(a, b, c),
                                 jrng.pair_counter(a, b), jrng.pair_counter(b, a)))
    want = [_u32(x) for x in f(a, b, c)]
    ta, tb, tc = (torch.as_tensor(x) for x in (a, b, c))
    got = [trng.hash_u32(ta), trng.hash_u32(ta, tb, tc), trng.pair_counter(ta, tb),
           trng.pair_counter(tb, ta)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[2].numpy(), got[3].numpy())  # symmetric
    # Python ints as words, as a counter is passed
    np.testing.assert_array_equal(trng.hash_u32(ta, 12345).numpy(),
                                  _u32(jax.jit(lambda a: jrng.hash_u32(a, 12345))(a)))


@pytest.mark.parametrize("dt,tol", [("float32", 1e-6), ("float64", 1e-12)])
def test_pair_uniform_and_normal_match_jax(dt, tol):
    a, b, _ = _words(seed=1)
    a, b = np.abs(a) % 100000, np.abs(b) % 100000
    jd, td = getattr(jnp, dt), getattr(torch, dt)
    step = np.int32(17)
    u, g = jax.jit(lambda i, j, s: (jrng.pair_uniform(i, j, s, jd),
                                    jrng.pair_normal(i, j, s, jd)))(a, b, step)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    tu = trng.pair_uniform(ta, tb, torch.as_tensor(step), td)
    tn = trng.pair_normal(ta, tb, torch.as_tensor(step), td)
    assert tu.dtype == tn.dtype == td
    np.testing.assert_array_equal(tu.numpy(), np.asarray(u))
    np.testing.assert_allclose(tn.numpy(), np.asarray(g), rtol=0, atol=tol)
    np.testing.assert_array_equal(trng.pair_normal(tb, ta, 17, td).numpy(), tn.numpy())
    assert abs(float(tn.mean())) < 0.05 and abs(float(tn.std()) - 1.0) < 0.05


def _states(n=300, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4.0, 4.0, (n, 3))
    kw = dict(vel=rng.normal(size=(n, 3)), mass=rng.uniform(1, 2, n),
              charge=rng.normal(size=n), type_id=rng.integers(0, 3, n))
    extra = {"tag": rng.normal(size=(n, 2))}
    sj = j_make_state(pos, dtype=jnp.float64, **kw)
    sj = sj.replace(extra={"tag": jnp.asarray(extra["tag"])})
    st = make_state(pos, dtype=torch.float64, device="cpu", **kw)
    st = st.replace(extra={"tag": torch.as_tensor(extra["tag"])})
    return sj, st, rng


def _same_state(st, sj):
    for k in ("pos", "vel", "mass", "charge", "type_id", "id"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k)))
    np.testing.assert_array_equal(st.extra["tag"].numpy(), np.asarray(sj.extra["tag"]))


def test_permute_and_spatial_sort_match_jax():
    sj, st, rng = _states()
    perm = rng.permutation(300)
    _same_state(st.permute(torch.as_tensor(perm)), sj.permute(jnp.asarray(perm)))
    for L, cells in ((8.0, 4), ((8.0, 7.0, 9.0), 5)):
        want = jax.jit(lambda s: j_spatial_sort(s, L, cells))(sj)
        got = spatial_sort(st, L, cells)
        _same_state(got, want)
        assert sorted(got.id.tolist()) == list(range(300))


def test_groups_match_jax():
    sj, st, rng = _states(seed=2)
    jb, tb = j_box(8.0, dtype=jnp.float64), box(8.0, dtype=torch.float64, device="cpu")
    ids = rng.choice(300, 40, replace=False)
    pairs = [
        (tg.all_particles(st), jg.all_particles(sj)),
        (tg.none(st), jg.none(sj)),
        (tg.id_range(st, 20, 77), jg.id_range(sj, 20, 77)),
        (tg.id_list(st, ids), jg.id_list(sj, ids)),
        (tg.by_type(st, 1), jg.by_type(sj, 1)),
        (tg.domain(st, tb, (-2.0, -1.0, -3.0), (1.0, 3.0, 0.5)),
         jg.domain(sj, jb, (-2.0, -1.0, -3.0), (1.0, 3.0, 0.5))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = pairs[4][0]
    moved_t = st.replace(pos=st.pos + 1.0, vel=st.vel * 2.0, force=torch.ones_like(st.pos))
    moved_j = sj.replace(pos=sj.pos + 1.0, vel=sj.vel * 2.0, force=jnp.ones_like(sj.pos))
    got = tg.apply_masked(moved_t, st.replace(force=torch.zeros_like(st.pos)), mask)
    want = jg.apply_masked(moved_j, sj.replace(force=jnp.zeros_like(sj.pos)),
                           jnp.asarray(mask.numpy()))
    for k in ("pos", "vel", "force"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


def test_real_dtype():
    x = torch.zeros(3, dtype=torch.float64)
    assert real_dtype(x) == torch.float64
    assert real_dtype({"a": torch.zeros(2, dtype=torch.int32), "b": (None, x)}) == torch.float64
    assert real_dtype([torch.zeros(2, dtype=torch.int64)]) == torch.float32
