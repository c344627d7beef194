"""The port's G-J update from folded forces (#11,
uammd_tpu_torch.engine.update_kernel.GJUpdateKernel) and the v2 engine's
unfused configuration (``fold_in_update=False``) against the JAX package.

- ``gj_update_z`` with ``jax.random``'s normals against ``gj_update_jnp``
  (update_kernel.py:322, the mirror of the TPU kernel) at T = 1.5 in
  float32: outputs within 1e-6 of max|ref| (XLA may contract a multiply-add
  into an FMA), the drift equal.
- The unfused port engine against JAX's CPU ``GridMD2`` (which is the
  unfused path off the TPU: the jnp fold and ``gj_update_jnp``,
  md2.py:72-76) at T = 0 for 3 steps, through ``unpack`` at atol 2e-4 on
  positions (tests/test_engine2.py:82's tolerance).
- The fused and unfused port engines at T = 1 for 5 steps: both draw the
  same counter noise, so positions agree within 1e-5 (on the CPU the two
  plain versions fold in the same order, and the runs are bit-equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine.md2 import make_lj_md2 as j_make_lj_md2
from uammd_tpu.engine.update_kernel import gj_update_jnp
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import md2 as md2_mod
from uammd_tpu_torch.engine import rebin_kernel as tr
from uammd_tpu_torch.engine import update_kernel as tu
from uammd_tpu_torch.engine.md2 import make_lj_md2
from uammd_tpu_torch.utils.lattices import lattice

DT, T, FRICTION, MASS = 0.01, 1.5, 1.0, 1.0
N, L = 600, 12.0


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


@pytest.fixture(scope="module")
def grids():
    """A [4, 4, 8, 16] grid with a quarter of its slots empty: positions,
    w, folded forces and reference positions 0.1 away."""
    spec = tl.GridSpec(box_size=(12.0, 12.0, 12.0), shape=(4, 16, 4), cap=8, fold=4,
                       cutoff=2.5, skin=1.2, n_strag=16)
    rng = np.random.default_rng(11)
    shape = spec.array_shape
    empty = rng.random(shape) < 0.25

    def grid(scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    x, y, z = ((rng.random(shape) * 12 - 6).astype(np.float32) for _ in range(3))
    x[empty] = y[empty] = z[empty] = tl.EMPTY_POS
    w = [np.where(empty, 0, grid(1.0)).astype(np.float32) for _ in range(3)]
    f = [grid(5.0) for _ in range(3)]
    ref = [np.where(empty, p, p - grid(0.1)).astype(np.float32) for p in (x, y, z)]
    return spec, [x, y, z] + w + f + ref


def test_update_z_matches_jax_mirror(grids):
    spec, arrs = grids
    j = [jnp.asarray(a) for a in arrs]
    key = jax.random.key(5)

    def jax_side(*a):
        out, drift = gj_update_jnp(spec, DT, T, FRICTION, MASS, *a, key)
        shape = a[0].shape
        z = (jax.random.normal(key, shape, jnp.float32),
             jax.random.normal(jax.random.fold_in(key, 1), shape, jnp.float32),
             jax.random.normal(jax.random.fold_in(key, 2), shape, jnp.float32))
        return out, drift, z

    out_j, drift_j, z_j = _jit0(jax_side, *j)(*j)
    coef = tu.GJCoefficients(DT, T, FRICTION, MASS)
    t = [torch.from_numpy(a) for a in arrs]
    launches = tu.GJ_UPDATE.launches
    out_t, drift_t = tu.gj_update_z(coef, *t, *(torch.tensor(np.asarray(a)) for a in z_j))
    assert tu.GJ_UPDATE.launches == launches
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()
    assert float(drift_t) == float(drift_j)
    empty = arrs[0] >= 1e8
    assert (out_t[0].numpy()[empty] == tl.EMPTY_POS).all()
    assert (out_t[3].numpy()[empty] == 0).all()


def test_plain_update_draws_the_fused_noise(grids):
    """#11's plain version with zero reaction groups is #12's plain version
    with "bm" noise: the same counter streams, bit for bit (the straggler
    rows too)."""
    spec, arrs = grids
    t = [torch.from_numpy(a) for a in arrs]
    rng = np.random.default_rng(12)
    S = spec.n_strag
    strag = tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((S, 3)).astype(np.float32),
        rng.standard_normal((S, 3)).astype(np.float32),
        rng.standard_normal((S, 3)).astype(np.float32),
        np.where(rng.random(S) < 0.5, np.arange(S), -1).astype(np.int32)))
    seed = torch.tensor(77, dtype=torch.int32)
    a = tu.make_gj_update_kernel(spec, DT, T, FRICTION, MASS)(*t, seed, strag)
    zero = [torch.zeros_like(t[0])] * 12
    b = tu.make_gj_fold_update_kernel(spec, DT, T, FRICTION, MASS, noise="bm")(
        *t[:9], zero, *t[9:], seed, strag)
    for u, v in zip(list(a[0]) + [a[1]] + list(a[2]), list(b[0]) + [b[1]] + list(b[2])):
        assert torch.equal(u, v)
    assert float(a[1]) > 0.0


def _pos(seed, jitter):
    rng = np.random.default_rng(seed)
    return lattice(N, L, "fcc") + jitter * rng.standard_normal((N, 3)), rng


def test_unfused_engine_follows_jax_at_t0():
    pos, rng = _pos(3, 0.08)
    vel = rng.normal(0.0, 1.5, (N, 3))
    md_t = make_lj_md2(L, N, dt=0.01, temperature=0.0, cap=8, n_strag=128, pos=pos,
                       fold_in_update=False, device="cpu")
    md_j = j_make_lj_md2(L, N, dt=0.01, temperature=0.0, cap=8, n_strag=128, pos=pos)
    assert dataclasses.asdict(md_t.spec) == dataclasses.asdict(md_j.spec)
    assert not md_j.fold_in_update and not md_t.fold_in_update
    gt0 = md_t.init(pos, vel=vel)
    assert gt0.fgrp == () and int((gt0.spid >= 0).sum()) > 0
    fields = tl.grid_state_to_numpy(gt0)
    gj0 = jl.GridState(spec=md_j.spec, n=N, key=jax.random.key(0, impl="rbg"),
                       **{k: jnp.asarray(fields[k]) for k in tl.STATE_FIELDS})
    gj = _jit0(lambda g: md_j.step(md_j.step(md_j.step(g))), gj0)(gj0)
    gt = md_t.run(gt0, 3)
    pj = np.asarray(jl.unpack(gj)[0])
    pt = tl.unpack(gt)[0].numpy()
    d = pt - pj
    d -= L * np.round(d / L)
    assert np.abs(d).max() < 2e-4, np.abs(d).max()
    assert not bool(gt.overflow)
    assert int((gt.pid >= 0).sum()) + int((gt.spid >= 0).sum()) == N


def test_fused_and_unfused_agree():
    """T = 1, 5 steps from one state, noise "bm" on both: the fold as a pass
    of its own (#7 + #11) or inside the update (#12) gives the same
    trajectory. Fast initial velocities make the drift trigger a rebin
    within the 5 steps."""
    pos, rng = _pos(5, 0.1)
    vel = rng.normal(0.0, 2.5, (N, 3))
    kw = dict(dt=0.01, temperature=1.0, cap=8, n_strag=128, pos=pos, noise="bm", device="cpu")
    fused = make_lj_md2(L, N, **kw)
    unfused = make_lj_md2(L, N, fold_in_update=False, **kw)
    ga, gb = fused.init(pos, seed=4, vel=vel), unfused.init(pos, seed=4, vel=vel)
    refs = (ga.ref_x, gb.ref_x)
    ga, gb = fused.run(ga, 5), unfused.run(gb, 5)
    pa, pb = tl.unpack(ga)[0], tl.unpack(gb)[0]
    assert float((pa - pb).abs().max()) <= 1e-5
    assert torch.equal(pa, pb)
    assert torch.equal(ga.ref_x, gb.ref_x)  # the same rebin steps
    assert not torch.equal(ga.ref_x, refs[0])  # a rebin was crossed
    assert float(fused.temperature_of(ga)) == pytest.approx(
        float(unfused.temperature_of(gb)), rel=1e-6)


def test_unfused_engine_rebins_with_rebin_fast3(monkeypatch):
    """With the fold off the engine rebins its stragglers with
    ``rebin_fast3``, as the JAX engine does (md2.py:244), and not with the
    one-shot ``rebin_fast2``."""
    calls = []
    real = md2_mod.rebin_fast3
    monkeypatch.setattr(md2_mod, "rebin_fast3", lambda gs: calls.append(1) or real(gs))
    monkeypatch.setattr(tr, "rebin_fast2", lambda gs: pytest.fail("rebin_fast2 called"))
    pos, rng = _pos(5, 0.1)
    md = make_lj_md2(L, N, dt=0.01, temperature=1.0, cap=8, n_strag=128, pos=pos,
                     fold_in_update=False, device="cpu")
    gs = md.run(md.init(pos, seed=4, vel=rng.normal(0.0, 2.5, (N, 3))), 5)
    assert calls and not bool(gs.overflow)
    assert int((gs.pid >= 0).sum()) + int((gs.spid >= 0).sum()) == N


def test_unfused_state_keeps_folded_forces():
    """With the fold off ``compute_forces`` stores the folded forces and no
    reaction groups; ``folded_forces`` returns them as stored, equal to
    the fused engine's fold of its home forces and groups."""
    pos, _ = _pos(3, 0.08)
    kw = dict(dt=0.01, temperature=0.0, cap=8, n_strag=128, pos=pos, device="cpu")
    fused, unfused = make_lj_md2(L, N, **kw), make_lj_md2(L, N, fold_in_update=False, **kw)
    ga, gb = fused.init(pos), unfused.init(pos)
    assert gb.fgrp == () and len(ga.fgrp) == 12
    fa, fb = fused.folded_forces(ga), unfused.folded_forces(gb)
    assert all(b is s for b, s in zip(fb, (gb.fx, gb.fy, gb.fz)))
    assert all(torch.equal(a, b) for a, b in zip(fa, fb))
    assert torch.equal(ga.sforce, gb.sforce)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(cuda, grids):
    spec, arrs = grids
    t = [torch.from_numpy(a) for a in arrs]
    kern = tu.make_gj_update_kernel(spec, DT, T, FRICTION, MASS)
    seed = torch.tensor(9, dtype=torch.int32)
    launches = tu.GJ_UPDATE.launches
    out_c, d_c = kern(*(a.to(cuda) for a in t), seed.to(cuda))
    torch.cuda.synchronize()
    assert tu.GJ_UPDATE.launches == launches + 1
    out_p, d_p = kern(*t, seed)
    scale = max(float(a.abs().max()) for a in out_p)
    assert max(float((a.cpu() - b).abs().max()) for a, b in zip(out_c, out_p)) <= 2e-5 * scale
    assert abs(float(d_c) - float(d_p)) <= 2e-5 * scale
