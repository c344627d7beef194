"""The port's Newton pair force and reaction fold
(uammd_tpu_torch.engine.kernel2) against the JAX package's Pallas kernels
(interpret mode on the CPU).

System: tests/test_engine2.py:35's n 600, L 12 liquid-like lattice with
CAP 8 below the largest occupancy, so 110 of 600 particles ride in the
128-row straggler list. Tolerances:

- each Newton output (home, the 4 reaction groups, the reduced straggler
  forces) within 1e-5 of max|f|, and every slot within 1e-4 of its own
  scale |f_ref| + median|f| (max|f| is set by the closest pair, about 0.3
  apart here, and would hide a wrong straggler term): float32 sums in
  another order;
- the folded total against the JAX v1 27-stencil kernel within 5e-6
  relative, as tests/test_engine2.py:55 holds the JAX v2 engine;
- the fold bit for bit (the same adds in the same order);
- the straggler pairs and the fused radial within 1e-6 relative (XLA may
  contract a multiply-add into an FMA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import kernel2 as jk
from uammd_tpu.engine import layout as jl
from uammd_tpu.engine.md import lj_g as j_lj_g
from uammd_tpu.engine.md import lj_g_fused as j_lj_g_fused
from uammd_tpu.engine.pair_kernel import make_pair_force_kernel as j_make_pair
from uammd_tpu_torch.engine import kernel2 as tk
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.md import lj_g, lj_g_fused
from uammd_tpu_torch.utils.lattices import lattice

N, L, RC2 = 600, 12.0, 6.25


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(0)
    pos = lattice(N, L, "fcc") + 0.3 * rng.standard_normal((N, 3))
    spec = tl.choose_spec(L, N, 2.5, cap=8, pos=pos, n_strag=128)
    gt = tl.pack(spec, pos, device="cpu")
    assert int((gt.spid >= 0).sum()) > 0  # the straggler path is exercised
    return pos, spec, gt


@pytest.fixture(scope="module")
def jax_newton(system):
    """The JAX Newton kernel's 18 outputs on the port's packed state."""
    _, spec, gt = system
    spec_j = jl.choose_spec(L, N, 2.5, cap=8, pos=system[0], n_strag=128)
    kern = jk.make_newton_pair_kernel(
        spec_j, j_lj_g_fused(rc2=RC2, approx=False), interpret=True,
        strag_cellcenter=True)
    xyz = [jnp.asarray(a.numpy()) for a in (gt.x, gt.y, gt.z)]
    strag = jk.broadcast_stragglers(spec_j, jnp.asarray(gt.spos.numpy()),
                                    jnp.asarray(gt.spid.numpy()))
    return [np.asarray(a) for a in jax.jit(kern)(*xyz, strag)]


@pytest.fixture(scope="module")
def port_newton(system):
    _, spec, gt = system
    strag = tk.broadcast_stragglers(spec, gt.spos, gt.spid)
    launches = tk.NEWTON_PAIR.launches
    out = tk.make_newton_pair_kernel(spec, lj_g_fused(rc2=RC2), strag_cellcenter=True)(
        gt.x, gt.y, gt.z, strag)
    assert tk.NEWTON_PAIR.launches == launches  # the CPU path launches nothing
    return out


def _flat(out):
    home, groups, sforce = out
    return [a.numpy() for a in home] + [c.numpy() for g in groups for c in g], sforce.numpy()


def _slot_err(ref, test, med):
    """max |test - ref| / (|ref| + med) over every slot."""
    return np.max(np.abs(test - ref) / (np.abs(ref) + med))


def test_newton_plain_matches_jax_kernel(system, jax_newton, port_newton):
    grids, sforce = _flat(port_newton)
    home_j = [jnp.asarray(a) for a in jax_newton[:3]]
    groups_j = [[jnp.asarray(a) for a in jax_newton[3 + 3 * i: 6 + 3 * i]] for i in range(4)]
    folded = [np.asarray(a) for a in jk.fold_reactions_jnp(home_j, groups_j)]
    fmax = max(np.abs(a).max() for a in folded)
    med = np.median(np.abs(np.concatenate([a[system[2].mask.numpy()] for a in folded])))
    for k in range(15):
        err = np.abs(grids[k] - jax_newton[k]).max() / fmax
        assert err < 1e-5, (k, err)
        assert _slot_err(jax_newton[k], grids[k], med) < 1e-4, k
    sf_j = np.stack([jax_newton[15 + c].sum(axis=(0, 1, 3)) for c in range(3)], axis=-1)
    assert np.abs(sforce - sf_j).max() / fmax < 1e-5
    assert _slot_err(sf_j, sforce, med) < 1e-4
    assert np.abs(sf_j).max() > 0


def test_folded_total_matches_jax_v1(system, port_newton):
    pos, spec, gt = system
    home, groups, sforce = port_newton
    f = tk.fold_reactions_plain(home, groups)
    sf = sforce + tk.straggler_pair_forces(spec, lj_g(), gt.spos, gt.spid)
    f2 = tl.unpack(gt.replace(fx=f[0], fy=f[1], fz=f[2], sforce=sf))[2].numpy()
    spec1 = tl.choose_spec(L, N, 2.5, pos=pos)
    g1 = tl.pack(spec1, pos, device="cpu")
    xyz = [jnp.asarray(a.numpy()) for a in (g1.x, g1.y, g1.z)]
    kern = j_make_pair(jl.choose_spec(L, N, 2.5, pos=pos), j_lj_g(), interpret=True)
    f1 = [torch.from_numpy(np.array(a)) for a in jax.jit(kern)(*xyz)]
    f1 = tl.unpack(g1.replace(fx=f1[0], fy=f1[1], fz=f1[2]))[2].numpy()
    err = np.abs(f2 - f1).max() / np.abs(f1).max()
    assert err < 5e-6, err


def test_straggler_image_modes_agree(system, port_newton):
    """Per-pair minimum image (kernel2.py:353-378) and the cell-centre wrap
    (:314-352) give the same forces."""
    _, spec, gt = system
    strag = tk.broadcast_stragglers(spec, gt.spos, gt.spid)
    other = tk.newton_pair_plain(spec, lj_g_fused(rc2=RC2), gt.x, gt.y, gt.z, strag,
                                 strag_cellcenter=False)
    a, sa = _flat(port_newton)
    b, sb = _flat(other)
    fmax = max(np.abs(x).max() for x in a[:3])
    assert max(np.abs(x - y).max() for x, y in zip(a, b)) / fmax < 1e-6
    assert np.abs(sa - sb).max() / fmax < 1e-6


def test_fold_bit_equal_to_jax(system, port_newton):
    _, spec, _ = system
    home, groups, _ = port_newton
    launches = tk.FOLD.launches
    f_port = [a.numpy() for a in tk.make_fold_kernel(spec)(home, groups)]
    assert tk.FOLD.launches == launches
    home_j = [jnp.asarray(a.numpy()) for a in home]
    groups_j = [[jnp.asarray(c.numpy()) for c in g] for g in groups]
    f_jnp = jk.fold_reactions_jnp(home_j, groups_j)
    spec_j = jl.choose_spec(L, N, 2.5, cap=8, pos=system[0], n_strag=128)
    f_pallas = jax.jit(jk.make_fold_kernel(spec_j, interpret=True))(home_j, groups_j)
    for a, b, c in zip(f_port, f_jnp, f_pallas):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, np.asarray(c))


def test_straggler_pair_forces_match_jax(system):
    _, spec, gt = system
    sf = tk.straggler_pair_forces(spec, lj_g(), gt.spos, gt.spid).numpy()
    spec_j = jl.choose_spec(L, N, 2.5, cap=8, pos=system[0], n_strag=128)
    sf_j = np.asarray(jk.straggler_pair_forces(
        spec_j, j_lj_g(), jnp.asarray(gt.spos.numpy()), jnp.asarray(gt.spid.numpy())))
    assert np.abs(sf_j).max() > 0  # some stragglers are neighbours
    np.testing.assert_allclose(sf, sf_j, rtol=0, atol=1e-6 * np.abs(sf_j).max())


def test_lj_g_fused_matches_jax():
    r2 = np.concatenate([np.linspace(1e-4, 7.0, 2001), [RC2, 4e-3, 0.0]]).astype(np.float32)
    g_port = lj_g_fused(rc2=RC2)(torch.from_numpy(r2)).numpy()
    g_jax = np.asarray(j_lj_g_fused(rc2=RC2, approx=False)(jnp.asarray(r2)))
    np.testing.assert_allclose(g_port, g_jax, rtol=1e-6, atol=0)
    assert g_port[r2 >= RC2].max() == 0.0 and np.isfinite(g_port).all()


def test_wrapper_rejects_bad_input(system):
    _, spec, gt = system
    with pytest.raises(TypeError):  # the kernel takes the fused radial only
        tk.make_newton_pair_kernel(spec, lj_g())
    force = tk.make_newton_pair_kernel(spec, lj_g_fused(rc2=RC2))
    with pytest.raises(ValueError):
        force(gt.x, gt.y, gt.z)  # a straggler spec needs the strag block
    with pytest.raises(ValueError):
        force(gt.x.double(), gt.y, gt.z, tk.broadcast_stragglers(spec, gt.spos, gt.spid))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("self_half", [False, True])
@pytest.mark.parametrize("cellcenter", [False, True])
def test_cuda_newton_matches_plain(cuda, system, port_newton, self_half, cellcenter):
    _, spec, gt = system
    g = tl.grid_state_from_numpy(spec, tl.grid_state_to_numpy(gt), device=cuda)
    strag = tk.broadcast_stragglers(spec, g.spos, g.spid)
    kern = tk.make_newton_pair_kernel(spec, lj_g_fused(rc2=RC2), self_half=self_half,
                                      strag_cellcenter=cellcenter)
    launches = tk.NEWTON_PAIR.launches
    home, groups, sforce = kern(g.x, g.y, g.z, strag)
    torch.cuda.synchronize()
    assert tk.NEWTON_PAIR.launches == launches + 1
    a, sa = _flat(port_newton)
    fmax = max(np.abs(x).max() for x in a[:3])
    folded_c = tk.make_fold_kernel(spec)(home, groups)
    folded_p = [f.numpy() for f in tk.fold_reactions_plain(*port_newton[:2])]
    med = np.median(np.abs(np.concatenate([f[gt.mask.numpy()] for f in folded_p])))
    for x, y in zip(folded_c, folded_p):
        assert np.abs(x.cpu().numpy() - y).max() / fmax < 1e-5
        assert _slot_err(y, x.cpu().numpy(), med) < 1e-4
    assert np.abs(sforce.cpu().numpy() - sa).max() / fmax < 1e-5
    assert _slot_err(sa, sforce.cpu().numpy(), med) < 1e-4
