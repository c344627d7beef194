"""The port's rebin kernel (uammd_tpu_torch.engine.rebin_kernel) against the
JAX package's Pallas kernel (interpret mode on the CPU): equal slot for
slot, exactly, for Q = 7 (rebin_fast_noforce, the MD path) and Q = 10
(rebin_fast), and a capacity violation latches overflow.

The JAX kernel runs once, with Q = 10: its placement does not depend on the
payload, so its positions, velocities and pids are also the reference for
Q = 7 (whose forces come back zero). It runs under ``jax.jit``: one
compile of the interpret-mode kernel takes about 45 s on one CPU core,
and an eager call pays about as much again every time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu.engine.rebin_kernel import rebin_fast as j_rebin_fast
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine.rebin_kernel import (
    REBIN,
    make_rebin_kernel,
    rebin_fast,
    rebin_fast_noforce,
)

PORT = {7: rebin_fast_noforce, 10: rebin_fast}


@pytest.fixture(scope="module")
def displaced():
    """The n 1500, L 24 system (NLANE 16, fold 2) with random velocities and
    forces, every particle displaced by less than the drift threshold."""
    n, L = 1500, 24.0
    rng = np.random.default_rng(2)
    pos = (rng.random((n, 3)) - 0.5) * L
    spec_j = jl.choose_spec(L, n, 2.5)
    spec_t = tl.choose_spec(L, n, 2.5)
    gj = jl.pack(spec_j, pos, vel=rng.standard_normal((n, 3)),
                 force=rng.standard_normal((n, 3)))
    f = {k: np.asarray(getattr(gj, k)) for k in tl.STATE_FIELDS}
    f["n"] = n
    m = f["pid"] >= 0
    step = 0.99 * spec_t.drift_threshold / np.sqrt(3.0)
    for k in ("x", "y", "z"):
        f[k] = (f[k] + rng.uniform(-step, step, f[k].shape) * m).astype(np.float32)
    gj = gj.replace(**{k: jnp.asarray(f[k]) for k in ("x", "y", "z")})
    return gj, tl.grid_state_from_numpy(spec_t, f, device="cpu")


@pytest.fixture(scope="module")
def jax_rebinned(displaced):
    return jax.jit(j_rebin_fast)(displaced[0])


@pytest.mark.parametrize("q", sorted(PORT))
def test_plain_matches_jax_kernel_exactly(displaced, jax_rebinned, q):
    _, gt = displaced
    launches = REBIN.launches
    rt = PORT[q](gt)
    assert REBIN.launches == launches  # the CPU path launches nothing
    for k in tl.STATE_FIELDS:
        want = np.asarray(getattr(jax_rebinned, k))
        if q == 7 and k in ("fx", "fy", "fz"):
            want = np.zeros_like(want)
        np.testing.assert_array_equal(want, getattr(rt, k).numpy(), err_msg=k)
    assert int((rt.pid >= 0).sum()) == gt.n
    assert not bool(rt.overflow)
    # the kernel regrouped particles, so slots moved
    assert not torch.equal(rt.pid, gt.pid)


def test_overflow_latches_on_capacity_violation(displaced):
    _, gt = displaced
    m = gt.mask
    # cram everything into a few cells: ranks pass CAP and particles that
    # moved more than one cell are lost, either of which latches overflow
    cram = {k: torch.where(m, getattr(gt, k) * (0.1 / 24.0), getattr(gt, k))
            for k in ("x", "y", "z")}
    g2 = gt.replace(**cram)
    _, _, over = make_rebin_kernel(gt.spec)(
        torch.stack([g2.x, g2.y, g2.z, g2.vx, g2.vy, g2.vz, (g2.pid + 1).float()]))
    assert int(over) > 0
    assert bool(rebin_fast(g2).overflow)
    assert bool(rebin_fast_noforce(g2).overflow)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q", [7, 10])
def test_cuda_kernel_matches_plain_exactly(cuda, displaced, q):
    _, gt = displaced
    qs = [gt.x, gt.y, gt.z, gt.vx, gt.vy, gt.vz, gt.fx, gt.fy, gt.fz][: q - 1]
    stacked = torch.stack(qs + [(gt.pid + 1).float()])
    kern = make_rebin_kernel(gt.spec)
    launches = REBIN.launches
    out_c, count_c, over_c = kern(stacked.to(cuda))
    torch.cuda.synchronize()
    assert REBIN.launches == launches + 1
    out_p, count_p, over_p = kern(stacked)
    assert torch.equal(out_c.cpu(), out_p)
    assert (int(count_c), int(over_c)) == (int(count_p), int(over_p)) == (gt.n, 0)


# ---------------------------------------------------------------------------
# The separable three-pass rebin with stragglers (rebin_fast3), against the
# JAX package's make_separable_rebin (interpret mode) slot for slot and its
# rebin_fast3 field for field, on tests/test_engine2.py:87-125's displaced
# state: n 600, L 12, CAP 8 with 110 stragglers, every particle moved by a
# clipped 0.35-sigma Gaussian.


@pytest.fixture(scope="module")
def strag_moved():
    from uammd_tpu_torch.utils.lattices import lattice

    n, L = 600, 12.0
    rng = np.random.default_rng(0)
    pos = lattice(n, L, "fcc") + 0.3 * rng.standard_normal((n, 3))
    spec = tl.choose_spec(L, n, 2.5, cap=8, pos=pos, n_strag=128)
    f = tl.grid_state_to_numpy(tl.pack(spec, pos, vel=rng.standard_normal((n, 3)),
                                       device="cpu"))
    m = f["pid"] >= 0
    dx = np.clip(0.35 * rng.standard_normal(f["x"].shape), -1.0, 1.0) * m
    f["x"] = (f["x"] + dx).astype(np.float32)
    f["y"] = (f["y"] + 0.5 * dx).astype(np.float32)
    f["z"] = (f["z"] - 0.3 * dx).astype(np.float32)
    sv = (f["spid"] >= 0)[:, None]
    f["spos"] = (f["spos"] + 0.35 * rng.standard_normal(f["spos"].shape) * sv).astype(np.float32)
    assert sv.sum() > 0
    spec_j = jl.choose_spec(L, n, 2.5, cap=8, pos=pos, n_strag=128)
    gj = jl.GridState(spec=spec_j, n=n, key=jax.random.key(0, impl="rbg"),
                      **{k: jnp.asarray(f[k]) for k in tl.STATE_FIELDS})
    return gj, tl.grid_state_from_numpy(spec, f, device="cpu")


@pytest.fixture(scope="module")
def jax_separable(strag_moved):
    """The JAX separable rebin kernel under one ``jax.jit`` (its
    interpret-mode compile is the cost), also placed in the JAX package's
    kernel cache so that its ``rebin_fast3`` reuses the compiled kernel."""
    from uammd_tpu.engine import rebin_kernel as jrk

    spec_j = strag_moved[0].spec
    kern = jax.jit(jrk.make_separable_rebin(spec_j, 7, interpret=True))
    jrk._KERNEL_CACHE[(spec_j, 7, "v3", jax.default_backend())] = kern
    return kern


def _stacks(g, xp):
    stacked = xp.stack([g.x, g.y, g.z, g.vx, g.vy, g.vz, (g.pid + 1).astype(xp.float32)]
                       if xp is jnp else
                       [g.x, g.y, g.z, g.vx, g.vy, g.vz, (g.pid + 1).to(torch.float32)])
    strag = [g.spos[:, 0], g.spos[:, 1], g.spos[:, 2], g.svel[:, 0], g.svel[:, 1],
             g.svel[:, 2]]
    if xp is jnp:
        return stacked, jnp.stack(strag + [(g.spid + 1).astype(jnp.float32)])
    return stacked, torch.stack(strag + [(g.spid + 1).to(torch.float32)])


def test_separable_plain_matches_jax_kernel_exactly(strag_moved, jax_separable):
    from uammd_tpu_torch.engine.rebin_kernel import SEP_REBIN, make_separable_rebin

    gj, gt = strag_moved
    stacked_j, strag_j = _stacks(gj, jnp)
    S, nlane = gt.spec.n_strag, gt.spec.nlane
    out_j = jax_separable(stacked_j, jnp.broadcast_to(strag_j[:, :, None], (7, S, nlane)))
    launches = SEP_REBIN.launches
    out_t = make_separable_rebin(gt.spec)(*_stacks(gt, torch))
    assert SEP_REBIN.launches == launches  # the CPU path launches nothing
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]), err_msg="out")
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]), err_msg="mini")
    assert int(out_t[2]) == int(out_j[2]) == gt.n
    assert int(out_t[3]) == int(out_j[3])
    assert (out_t[1][6] > 0.5).any()  # the mini-grid holds stragglers


def test_rebin_fast3_matches_jax(strag_moved, jax_separable):
    from uammd_tpu.engine.rebin_kernel import rebin_fast3 as j_rebin_fast3
    from uammd_tpu_torch.engine.rebin_kernel import rebin_fast3

    gj, gt = strag_moved
    rj = j_rebin_fast3(gj)  # eager around the cached, compiled kernel
    rt = rebin_fast3(gt)
    for k in tl.STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj, k)), getattr(rt, k).numpy(),
                                      err_msg=k)
    assert int((rt.pid >= 0).sum()) + int((rt.spid >= 0).sum()) == gt.n
    assert int((rt.spid >= 0).sum()) > 0
    assert not bool(rt.overflow)
    # the same particles as the sort rebin, in canonical order
    for a, b in zip(tl.unpack(rt)[:2], tl.unpack(tl.rebin(gt))[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_rebin_fast3_latches_overflow(strag_moved):
    from uammd_tpu_torch.engine.rebin_kernel import rebin_fast3

    _, gt = strag_moved
    m = gt.mask
    cram = {k: torch.where(m, getattr(gt, k) * 0.05, getattr(gt, k)) for k in ("x", "y", "z")}
    assert bool(rebin_fast3(gt.replace(**cram)).overflow)


@pytest.mark.gpu
def test_cuda_separable_matches_plain_exactly(cuda, strag_moved):
    from uammd_tpu_torch.engine.rebin_kernel import SEP_REBIN, make_separable_rebin

    _, gt = strag_moved
    stacked, strag = _stacks(gt, torch)
    kern = make_separable_rebin(gt.spec)
    launches = SEP_REBIN.launches
    out_c = kern(stacked.to(cuda), strag.to(cuda))
    torch.cuda.synchronize()
    assert SEP_REBIN.launches == launches + 1
    out_p = kern(stacked, strag)
    assert torch.equal(out_c[0].cpu(), out_p[0])
    assert torch.equal(out_c[1].cpu(), out_p[1])
    assert (int(out_c[2]), int(out_c[3])) == (int(out_p[2]), int(out_p[3]))
