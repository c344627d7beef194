"""The stacked entries of the n-channel fold #9 (``FoldNKernel.stacked``, on
the Newton channel kernel's [5, n, ...] buffer) and of the fused fold + G-J
update #12 (``GJFoldUpdateKernel.stacked``, on the Newton pair kernel's
[15, ...] buffer, which ``GridMD2`` keeps as ``GridState.fstack``).

- The stacked fold's plain route is bit-equal to JAX's
  ``fold_reactions_n_jnp`` (kernel2.py:716) at n = 3 and 6.
- At T = 0 the v2 engine's update from its stacked force buffer matches
  JAX's ``fold_reactions_jnp`` + ``gj_update_jnp`` (update_kernel.py:322)
  within tests/test_torch_update_kernel.py's 1e-6 absolute (a few float32
  ulps where XLA contracts a multiply-add into an FMA).
- At T > 0 the stacked and the list routes draw the same counter noise and
  are bit-equal, "clt" and "bm"; so are engine steps with the buffer and
  without it (the step stacks the forces itself).
- The step folds the state's force fields: ``fstack`` is handed over
  only while they are its views.
- The stacked entries refuse a wrong shape, dtype or channel count, and on
  a tensor that is not on the CPU they check before any launch.

JAX runs only under ``jax.jit`` (no Pallas interpret compile): a few
seconds in all. The CUDA kernels against their plain versions need a GPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import kernel2 as jk
from uammd_tpu.engine.update_kernel import gj_update_jnp
from uammd_tpu_torch.engine import _build
from uammd_tpu_torch.engine import kernel2 as tk
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import update_kernel as tu
from uammd_tpu_torch.engine.md2 import make_lj_md2
from uammd_tpu_torch.utils.lattices import lattice

DT, T, FRICTION, MASS = 0.01, 1.5, 1.0, 1.0
N, L = 600, 12.0
SPEC = tl.GridSpec(box_size=(12.0, 12.0, 12.0), shape=(3, 12, 4), cap=8, fold=4,
                   cutoff=2.5, skin=1.2, n_strag=16)  # [4, 3, 8, 12]


def _raw(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((5, n) + SPEC.array_shape).astype(np.float32)


@pytest.mark.parametrize("n", [3, 6])
def test_stacked_fold_matches_jax_bit_for_bit(n):
    raw = _raw(n, n)
    fold = tk.make_fold_kernel_n(SPEC, n)
    got = fold.stacked(torch.from_numpy(raw))
    assert got.shape == (n,) + SPEC.array_shape
    home = [jnp.asarray(raw[0, c]) for c in range(n)]
    groups = [[jnp.asarray(raw[1 + g, c]) for c in range(n)] for g in range(4)]
    want = jax.jit(jk.fold_reactions_n_jnp)(home, groups)
    for c in range(n):
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))
    # the list form on the same grids gives the same bits
    listed = fold([torch.from_numpy(raw[0, c]) for c in range(n)],
                  [[torch.from_numpy(raw[1 + g, c]) for c in range(n)] for g in range(4)])
    assert all(torch.equal(a, b) for a, b in zip(listed, got))


def _engine(temperature, noise="clt", seed=3):
    rng = np.random.default_rng(seed)
    pos = lattice(N, L, "fcc") + 0.08 * rng.standard_normal((N, 3))
    md = make_lj_md2(L, N, dt=DT, temperature=temperature, cap=8, n_strag=128, pos=pos,
                     noise=noise, device="cpu")
    gs = md.init(pos, seed=4, vel=rng.normal(0.0, 1.5, (N, 3)))
    return md, gs


def _update_args(gs):
    return ((gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz), (gs.ref_x, gs.ref_y, gs.ref_z),
            (gs.spos, gs.svel, gs.sforce, gs.spid))


def test_engine_update_from_the_stacked_forces_matches_jax_at_t0():
    md, gs = _engine(0.0)
    assert gs.fstack is not None and gs.fstack.shape == (15,) + md.spec.array_shape
    assert gs.fx.data_ptr() == gs.fstack.data_ptr() and len(gs.fgrp) == 12
    grids, refs, strag = _update_args(gs)
    (out, drift, _) = md.update.stacked(*grids, gs.fstack, *refs, gs.step, strag)
    f = [jnp.asarray(a.numpy()) for a in gs.fstack]
    fx, fy, fz = jk.fold_reactions_jnp(f[:3], [f[3 + 3 * g:6 + 3 * g] for g in range(4)])
    j = [jnp.asarray(a.numpy()) for a in grids + refs]
    out_j, drift_j = jax.jit(
        lambda *a: gj_update_jnp(md.spec, DT, 0.0, FRICTION, MASS, *a, jax.random.key(0))
    )(*j[:6], fx, fy, fz, *j[6:])
    for a, b in zip(out, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert abs(float(drift) - float(drift_j)) < 1e-6
    assert float(drift) > 0.0


@pytest.mark.parametrize("noise", tu.NOISES)
def test_stacked_and_list_routes_are_bit_equal(noise):
    md, gs = _engine(T, noise)
    grids, refs, strag = _update_args(gs)
    got = md.update.stacked(*grids, gs.fstack, *refs, gs.step, strag)
    want = md.update(*grids, gs.fx, gs.fy, gs.fz, gs.fgrp, *refs, gs.step, strag)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[2], want[0] + want[2]))
    assert torch.equal(got[1], want[1])
    # a step from a state without the buffer stacks the forces itself
    a, b = md.step(gs), md.step(gs.replace(fstack=None))
    for name in ("x", "y", "z", "vx", "vy", "vz", "spos", "svel", "fx", "fz"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.fstack is not None and torch.equal(a.fstack, b.fstack)


def test_stacked_entries_refuse_wrong_inputs():
    shape = SPEC.array_shape
    with pytest.raises(ValueError):
        tk.make_fold_kernel_n(SPEC, 7)
    fold = tk.make_fold_kernel_n(SPEC, 6)
    for raw in (torch.zeros((5, 3) + shape),  # the channel count
                torch.zeros((5, 6) + shape, dtype=torch.float64),
                torch.zeros((5, 6, 4, 3, 8, 16)),
                torch.zeros((4, 6) + shape)):
        with pytest.raises(ValueError):
            fold.stacked(raw)
    upd = tu.make_gj_fold_update_kernel(SPEC, DT, T, FRICTION, MASS, noise="clt")
    g = [torch.zeros(shape) for _ in range(9)]
    seed = torch.tensor(1, dtype=torch.int32)
    for forces, grids in ((torch.zeros((12,) + shape), g),
                          (torch.zeros((15,) + shape, dtype=torch.float64), g),
                          (torch.zeros((15,) + shape), g[:8] + [torch.zeros((4, 3, 8, 8))])):
        with pytest.raises(ValueError):
            upd.stacked(*grids[:6], forces, *grids[6:], seed)


def test_stacked_entries_check_before_any_launch(monkeypatch):
    """On a tensor that is not on the CPU (meta here) the CUDA route runs:
    it raises on a tensor that is not a CUDA one, and on a plane that 16-byte
    loads cannot cover, before any launch."""
    shape = SPEC.array_shape
    meta = {"device": "meta"}
    n0, u0 = tk.FOLD_N.launches, tu.GJ_FOLD_UPDATE.launches
    with pytest.raises(ValueError, match="CUDA"):
        tk.make_fold_kernel_n(SPEC, 3).stacked(torch.empty((5, 3) + shape, **meta))
    upd = tu.make_gj_fold_update_kernel(SPEC, DT, T, FRICTION, MASS)
    g = [torch.empty(shape, **meta) for _ in range(9)]
    with pytest.raises(ValueError, match="CUDA"):
        upd.stacked(*g[:6], torch.empty((15,) + shape, **meta), *g[6:],
                    torch.empty((), dtype=torch.int32, **meta))
    # a plane of 3 x 3 slots
    odd = tl.GridSpec(box_size=(12.0, 12.0, 12.0), shape=(3, 4, 4), cap=3, fold=1,
                      cutoff=2.5, skin=1.2, n_strag=0)
    monkeypatch.setattr(_build, "check_cuda_tensor", lambda *a, **k: None)
    with pytest.raises(ValueError, match="multiple of 4"):
        tk.make_fold_kernel_n(odd, 3).stacked(torch.empty((5, 3) + odd.array_shape, **meta))
    upd = tu.make_gj_fold_update_kernel(odd, DT, T, FRICTION, MASS)
    g = [torch.empty(odd.array_shape, **meta) for _ in range(9)]
    with pytest.raises(ValueError, match="multiple of 4"):
        upd.stacked(*g[:6], torch.empty((15,) + odd.array_shape, **meta), *g[6:],
                    torch.empty((), dtype=torch.int32, **meta))
    assert (tk.FOLD_N.launches, tu.GJ_FOLD_UPDATE.launches) == (n0, u0)


def test_the_step_folds_the_state_forces_not_a_stale_buffer():
    """``fstack`` only saves restacking fx, fy, fz and ``fgrp``: replacing a
    force drops it, and a buffer that no longer holds the forces (a state
    built around ``replace``) is not handed to the update."""
    md, gs = _engine(T)
    assert gs.force_stack() is gs.fstack
    zero = torch.zeros_like(gs.fx)
    cleared = gs.replace(fx=zero)
    assert cleared.fstack is None and torch.equal(cleared.force_stack()[0], zero)
    stale = dataclasses.replace(gs, fx=zero)  # fx replaced, the old buffer kept
    assert stale.fstack is gs.fstack and stale.force_stack() is not gs.fstack
    assert torch.equal(stale.force_stack(), cleared.force_stack())
    a, b, c = md.step(stale), md.step(cleared), md.step(gs)
    for name in ("x", "vx", "vy", "spos", "svel"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert not torch.equal(a.vx, c.vx)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 6])
def test_cuda_stacked_fold_matches_plain(cuda, n):
    raw = torch.from_numpy(_raw(n, 10 + n))
    fold = tk.make_fold_kernel_n(SPEC, n)
    before = tk.FOLD_N.launches
    got = fold.stacked(raw.to(cuda))
    torch.cuda.synchronize()
    assert tk.FOLD_N.launches == before + 1
    assert torch.equal(got.cpu(), fold.stacked(raw))


@pytest.mark.gpu
@pytest.mark.parametrize("noise", tu.NOISES)
def test_cuda_stacked_update_matches_plain(cuda, noise):
    md, gs = _engine(T, noise)
    grids, refs, strag = _update_args(gs)
    want = md.update.stacked(*grids, gs.fstack, *refs, gs.step, strag)
    before = tu.GJ_FOLD_UPDATE.launches
    got = md.update.stacked(*(t.to(cuda) for t in grids), gs.fstack.to(cuda),
                            *(t.to(cuda) for t in refs), gs.step.to(cuda),
                            tuple(t.to(cuda) for t in strag))
    torch.cuda.synchronize()
    assert tu.GJ_FOLD_UPDATE.launches == before + 1
    tol = 0.0 if noise == "clt" else 1e-5  # the card's logf/sinf/cosf in "bm"
    for a, b in zip(got[0] + got[2], want[0] + want[2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=tol)
    assert abs(float(got[1]) - float(want[1])) <= tol
