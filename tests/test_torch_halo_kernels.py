"""The halo modes of the port's kernels (the z-slab domain decomposition)
against the JAX package's Pallas kernels in interpret mode on the CPU.

- #6 ``halo_z`` (``kernel2.make_newton_pair_kernel(halo_z=True)``) on one
  shard of tests/test_domain2.py:25's clump system split over 8 shards
  (the one whose top boundary cuts the clump: the lattice's spacing, 3.6,
  is past the cutoff, so only the clump's particles interact), with the
  ghost row built as domain2.py:167-174 builds it and the clump's
  stragglers: every output slot within 1e-4 of its own scale |f_ref| +
  median|f| (tests/test_torch_kernel2.py's rule: float32 sums in another
  order; the median over the slots that feel a force);
- #8 (``make_fold_kernel_halo``) against the JAX kernel and
  ``fold_reactions_halo_jnp`` on those outputs and random recv blocks:
  within 1e-6 relative (the same float32 adds in the same order);
- #1 with ``periodic_z=False`` on a halo-extended slab of a 4-shard split:
  every row (home and ghost) within 1e-5 of max|f| (float32 sums in
  another order);
- #2 with ``periodic_z=False``, the DPD functor (its pair hash bit-equal,
  tests/test_torch_dpd.py's 1e-5 of max|f|) and the SPH force functor
  (tests/test_torch_sph.py's 1e-4 of max|f|), on a halo-extended slab.

On a slab taller than the cutoff the halo and periodic modes differ only in
the ghost rows' outputs, which the caller drops; so each control feeds the
slab without the caller's image shift of its ghost rows, which must break
the home rows next to them.
- ``gpu``: each CUDA mode against its plain version (skips without a GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import dpd as jd
from uammd_tpu.engine import kernel2 as jk
from uammd_tpu.engine import layout as jl
from uammd_tpu.engine import pair_kernel as jp
from uammd_tpu.engine import sph as js
from uammd_tpu.engine.md import lj_g as j_lj_g
from uammd_tpu.engine.md import lj_g_fused as j_lj_g_fused
from uammd_tpu.interactors import sph as jsph
from uammd_tpu_torch.engine import dpd as td
from uammd_tpu_torch.engine import kernel2 as tk
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import pair_kernel as tp
from uammd_tpu_torch.engine import sph as ts
from uammd_tpu_torch.engine.md import lj_g, lj_g_fused
from uammd_tpu_torch.utils.lattices import lattice

RC2 = 6.25
N_DEV = 4
SPEC_FIELDS = ("box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small plain-torch runs gain nothing from more threads, and the
    test tier runs files in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _jspec(spec):
    return jl.GridSpec(**{f: getattr(spec, f) for f in SPEC_FIELDS})


def clump_system(n=2400, L=48.0, seed=0):
    """tests/test_domain2.py:25's jittered lattice with one dense clump."""
    rng = np.random.default_rng(seed)
    n_clump = 48
    gx, gy, gz = np.meshgrid(*[np.arange(4) * 1.1] * 2, np.arange(3) * 1.1)
    clump = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    clump = (clump + np.array([5.0, 5.0, 5.0]))[:n_clump]
    base = lattice(n, L * 0.98, "fcc")
    base = base + rng.normal(0.0, 0.05, base.shape)
    lo, hi = clump.min(axis=0) - 1.0, clump.max(axis=0) + 1.0
    inside = np.all((base > lo) & (base < hi), axis=1)
    base = base[~inside][: n - n_clump]
    pos = np.concatenate([base, clump], axis=0)
    vel = rng.normal(0.0, 0.3, (n, 3))
    return pos.astype(np.float32), vel.astype(np.float32)


def halo_slab(a, shard, nz_loc, shift=0.0):
    """Rows [shard * nz_loc - 1, (shard + 1) * nz_loc] of a periodic grid,
    the ghost rows across the global boundary moved by -shift / +shift
    (domain.py:74-85)."""
    nz = a.shape[0]
    lo, hi = shard * nz_loc, (shard + 1) * nz_loc
    below = a[(lo - 1) % nz][None] - (shift if lo == 0 else 0.0)
    above = a[hi % nz][None] + (shift if hi == nz else 0.0)
    return torch.cat([below, a[lo:hi], above]).contiguous()


@pytest.fixture(scope="module")
def newton_case():
    """Shard 4 of 8 (rows 8-9; the clump sits in rows 9-10) with the ghost
    row of shard 5 and the clump's stragglers: the port's halo outputs and
    the JAX kernel's."""
    pos, _ = clump_system()
    L = 48.0
    spec = tl.choose_spec((L, L, L), 2400, 2.5, pos=pos, n_strag=24, nz_multiple=8)
    gs = tl.pack(spec, pos, device="cpu")
    assert int((gs.spid >= 0).sum()) > 0
    nzl = spec.shape[2] // 8
    lo = 4 * nzl
    local = tl.GridSpec(**{**{f: getattr(spec, f) for f in SPEC_FIELDS},
                           "shape": spec.shape[:2] + (nzl,)})
    home = [a[lo:lo + nzl].contiguous() for a in (gs.x, gs.y, gs.z)]
    ghost = [a[lo + nzl:lo + nzl + 1].contiguous() for a in (gs.x, gs.y, gs.z)]
    strag = tk.broadcast_stragglers(local, gs.spos, gs.spid)
    out = tk.make_newton_pair_kernel(local, lj_g_fused(rc2=RC2), halo_z=True)(
        *home, *ghost, strag)
    kern = jk.make_newton_pair_kernel(_jspec(local), j_lj_g_fused(rc2=RC2, approx=False),
                                      interpret=True, halo_z=True)
    args = [jnp.asarray(a.numpy()) for a in home + ghost]
    strag_j = jk.broadcast_stragglers(_jspec(local), jnp.asarray(gs.spos.numpy()),
                                      jnp.asarray(gs.spid.numpy()))
    want = [np.asarray(a) for a in _jit0(kern, *args, strag_j)(*args, strag_j)]
    return local, home + ghost + [strag], out, want


def test_newton_halo_plain_matches_jax(newton_case):
    local, ins, (h, groups, sforce), want = newton_case
    home = ins[:3]
    got = [a.numpy() for a in h] + [c.numpy() for g in groups for c in g]
    folded = jk.fold_reactions_jnp([jnp.asarray(a) for a in want[:3]],
                                   [[jnp.asarray(a) for a in want[3 + 3 * i:6 + 3 * i]]
                                    for i in range(4)])
    # the median over the slots that feel a force: the lattice's spacing
    # (3.6) is past the cutoff, so only the clump's particles interact
    f = np.abs(np.concatenate([np.asarray(a)[home[0].numpy() < 1e8] for a in folded]))
    med = np.median(f[f > 0])
    for k in range(15):
        assert np.max(np.abs(got[k] - want[k]) / (np.abs(want[k]) + med)) < 1e-4, k
    sf_j = np.stack([want[15 + c].sum(axis=(0, 1, 3)) for c in range(3)], axis=-1)
    assert np.abs(sf_j).max() > 0
    assert np.max(np.abs(sforce.numpy() - sf_j) / (np.abs(sf_j) + med)) < 1e-4
    # the ghost row is used: reactions land on it through the (1, dyb)
    # groups' top row
    assert max(np.abs(want[3 + 3 * g + c][-1]).max() for g in range(3) for c in range(3)) > 0


def test_newton_halo_rejects_cellcenter():
    spec = tl.choose_spec(12.0, 600, 2.5, n_strag=8)
    with pytest.raises(ValueError, match="cell"):
        tk.make_newton_pair_kernel(spec, lj_g_fused(rc2=RC2), halo_z=True,
                                   strag_cellcenter=True)


def test_fold_halo_matches_jax(newton_case):
    local, _, (h, groups, _), _ = newton_case
    rng = np.random.default_rng(3)
    recv = [torch.from_numpy(rng.standard_normal((1,) + local.array_shape[1:]).astype(np.float32))
            for _ in range(9)]
    got = [a.numpy() for a in tk.make_fold_kernel_halo(local)(h, groups, recv)]
    hj = [jnp.asarray(a.numpy()) for a in h]
    gj = [[jnp.asarray(c.numpy()) for c in g] for g in groups]
    rj = [jnp.asarray(r.numpy()) for r in recv]
    kern = jk.make_fold_kernel_halo(_jspec(local), interpret=True)
    for want in (_jit0(kern, hj, gj, rj)(hj, gj, rj), jk.fold_reactions_halo_jnp(hj, gj, rj)):
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


def test_fold_halo_stacked_entry_equals_list_form_and_jax(newton_case):
    """The stacked entry (the Newton halo kernel's [15, ...] buffer and the
    [9, nyb, CAP, NLANE] block of the reactions' exchange) equals the list
    form bit for bit, and ``fold_reactions_halo_jnp``."""
    local, ins, _, _ = newton_case
    kern = tk.make_newton_pair_kernel(local, lj_g_fused(rc2=RC2), halo_z=True)
    buf, _ = kern.stacked(*ins)
    h, groups, _ = kern(*ins)
    assert tuple(buf.shape) == (15,) + local.array_shape
    assert all(torch.equal(buf[3 + 3 * g + c], groups[g][c]) for g in range(4) for c in range(3))
    rng = np.random.default_rng(4)
    recv = torch.from_numpy(rng.standard_normal((9,) + local.array_shape[1:]).astype(np.float32))
    fold = tk.make_fold_kernel_halo(local)
    got = fold.stacked(buf, recv)
    listed = fold(h, groups, [recv[k][None] for k in range(9)])
    assert all(torch.equal(a, b) for a, b in zip(got, listed))
    want = jk.fold_reactions_halo_jnp([jnp.asarray(a.numpy()) for a in h],
                                      [[jnp.asarray(c.numpy()) for c in g] for g in groups],
                                      [jnp.asarray(recv[k][None].numpy()) for k in range(9)])
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()
    assert np.abs(recv.numpy()).max() > 0 and not torch.equal(
        got[0][0], fold.stacked(buf, torch.zeros_like(recv))[0][0])


def _err(got, want, m):
    """max |got - want| over the occupied slots, over max |want| there."""
    scale = max(np.abs(w[m]).max() for w in want)
    return max(np.abs(np.asarray(a)[m] - w[m]).max() for a, w in zip(got, want)) / scale


def test_pair_force_halo_matches_jax():
    """#1 in its halo mode on shard 0 of 4 (the bottom ghost row shifted by
    -Lz)."""
    rng = np.random.default_rng(1)
    n, L = 1200, 24.0
    pos = lattice(n, L, "fcc") + rng.normal(0, 0.05, (n, 3))
    spec = tl.choose_spec(L, n, 2.5, pos=pos, nz_multiple=N_DEV)
    gs = tl.pack(spec, pos, device="cpu")
    nzl = spec.shape[2] // N_DEV
    slab = [halo_slab(a, 0, nzl) for a in (gs.x, gs.y)] + [halo_slab(gs.z, 0, nzl, L)]
    local = tl.GridSpec(**{**{f: getattr(spec, f) for f in SPEC_FIELDS},
                           "shape": spec.shape[:2] + (nzl + 2,)})
    kern_t = tp.make_pair_force_kernel(local, lj_g(), periodic_z=False)
    got = [a.numpy() for a in kern_t(*slab)]
    kern = jp.make_pair_force_kernel(_jspec(local), j_lj_g(), interpret=True, periodic_z=False)
    args = [jnp.asarray(a.numpy()) for a in slab]
    want = [np.asarray(a) for a in _jit0(kern, *args)(*args)[:3]]
    m = slab[0].numpy() < 1e8
    assert _err(got, want, m) < 1e-5
    unshifted = kern_t(slab[0], slab[1], halo_slab(gs.z, 0, nzl))
    assert _err([a.numpy()[1] for a in unshifted], [w[1] for w in want], m[1]) > 1e-2


@pytest.fixture(scope="module")
def channel_slab():
    """Shard 0 of 4 of a DPD-like liquid (n 1200, L 24, rc 2.5: nz 8)."""
    rng = np.random.default_rng(2)
    n, L = 1200, 24.0
    pos = np.asarray(lattice(n, L, "fcc")) + 0.03 * rng.standard_normal((n, 3))
    vel = (0.5 * rng.standard_normal((n, 3))).astype(np.float32)
    spec = tl.choose_spec(L, n, 2.5, skin=1.1, pos=pos, nz_multiple=N_DEV)
    gs = tl.pack(spec, pos, vel=vel, device="cpu")
    nzl = spec.shape[2] // N_DEV
    local = tl.GridSpec(**{**{f: getattr(spec, f) for f in SPEC_FIELDS},
                           "shape": spec.shape[:2] + (nzl + 2,)})
    grids = {k: halo_slab(getattr(gs, k), 0, nzl) for k in ("x", "y", "vx", "vy", "vz")}
    grids["z"] = halo_slab(gs.z, 0, nzl, L)
    grids["z_unshifted"] = halo_slab(gs.z, 0, nzl)
    grids["pid"] = halo_slab(gs.pid.to(torch.float32), 0, nzl)
    return local, grids


def test_dpd_halo_matches_jax(channel_slab):
    local, g = channel_slab
    step, sigma_dt = 7, float(np.sqrt(2.0 * 1.0 * 2.0 / 0.01))
    fn = td.DPDPair(2.5, 10.0, 2.0, sigma_dt)
    xyz = [g["x"], g["y"], g["z"]]
    ch = [g["vx"], g["vy"], g["vz"], g["pid"]]
    stepf = torch.tensor(float(step))
    got = [a.numpy() for a in tp.make_pair_channel_kernel(local, fn, periodic_z=False)(
        *xyz, *ch, stepf)]
    kern = jp.make_pair_channel_kernel(_jspec(local), jd.dpd_pair_fn(2.5, 10.0, 2.0, sigma_dt),
                                       5, 3, interpret=True, periodic_z=False)
    args = [jnp.asarray(a.numpy()) for a in xyz + ch] + [
        jnp.full(local.array_shape, float(step), jnp.float32)]
    want = [np.asarray(a) for a in _jit0(kern, *args)(*args)]
    m = g["pid"].numpy() > -0.5
    assert _err(got, want, m) < 1e-5
    unshifted = tp.make_pair_channel_kernel(local, fn, periodic_z=False)(
        g["x"], g["y"], g["z_unshifted"], *ch, stepf)
    assert _err([a.numpy()[1] for a in unshifted], [w[1] for w in want], m[1]) > 1e-2


def test_sph_force_halo_matches_jax(channel_slab):
    local, g = channel_slab
    params = dict(support=1.2, viscosity=5.0, gas_stiffness=10.0, rest_density=0.08)
    rng = np.random.default_rng(4)
    m = (g["pid"] > -0.5).to(torch.float32)
    p_rho2 = torch.from_numpy(rng.uniform(0.5, 1.5, local.array_shape).astype(np.float32)) * m
    xyz = [g["x"], g["y"], g["z"]]
    ch = [p_rho2, g["vx"], g["vy"], g["vz"], m]
    fn = ts.SPHForcePair(ts.SPHParams(**params))
    got = [a.numpy() for a in tp.make_pair_channel_kernel(local, fn, periodic_z=False)(
        *xyz, *ch)]
    kern = jp.make_pair_channel_kernel(_jspec(local),
                                       js.sph_force_pair_fn(jsph.SPHParams(**params)), 5, 3,
                                       interpret=True, periodic_z=False)
    args = [jnp.asarray(a.numpy()) for a in xyz + ch]
    want = [np.asarray(a) for a in _jit0(kern, *args)(*args)]
    assert _err(got, want, m.numpy() > 0) < 1e-4


def test_halo_mode_takes_straggler_free_functors():
    spec = tl.choose_spec(10.0, 320, 1.0)
    with pytest.raises(ValueError, match="halo"):
        tp.PairChannelKernel(spec, object(), periodic_z=False)
    with pytest.raises(ValueError, match="force alone"):
        tp.make_pair_force_kernel(spec, lj_g(), compute_virial=True, periodic_z=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_halo_modes_match_plain(cuda, newton_case, channel_slab):
    """#6 halo_z and #2's DPD halo mode on the card against their plain
    versions on the CPU (one launch each)."""
    local, ins, ref, _ = newton_case
    kern = tk.make_newton_pair_kernel(local, lj_g_fused(rc2=RC2), halo_z=True, self_half=True)
    before = tk.NEWTON_PAIR_HALO.launches
    h, groups, sforce = kern(*[a.to(cuda).contiguous() for a in ins])
    torch.cuda.synchronize()
    assert tk.NEWTON_PAIR_HALO.launches == before + 1
    got = list(h) + [c for g in groups for c in g] + [sforce]
    want = list(ref[0]) + [c for g in ref[1] for c in g] + [ref[2]]
    scale = max(float(a.abs().max()) for a in want[:3])
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want)) < 1e-5 * scale
    slab_local, g = channel_slab
    names = ("x", "y", "z", "vx", "vy", "vz", "pid")
    fn = td.DPDPair(2.5, 10.0, 2.0, 20.0)
    kern = tp.make_pair_channel_kernel(slab_local, fn, periodic_z=False)
    before = tp.PAIR_CHANNEL_DPD_HALO.launches
    got = kern(*[g[k].to(cuda) for k in names], torch.tensor(3.0, device=cuda))
    torch.cuda.synchronize()
    assert tp.PAIR_CHANNEL_DPD_HALO.launches == before + 1
    want = kern(*[g[k] for k in names], torch.tensor(3.0))
    scale = max(float(a.abs().max()) for a in want)
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want)) < 2e-5 * scale
