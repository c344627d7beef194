"""The port's one-shot straggler-aware rebin (#4,
uammd_tpu_torch.engine.rebin_kernel.RebinKernel2 / rebin_fast2) against
the JAX package's ``make_rebin_kernel2`` (Pallas, interpret mode on the
CPU) and ``rebin_fast2``, on tests/test_engine2.py:87-110's drifted
straggler system (n 600, L 12, CAP 8, 128 straggler rows, every particle
moved by a clipped 0.35-sigma Gaussian).

The rebin moves values and does no arithmetic on them, so the comparison
is exact: ``out`` and ``mini`` slot for slot, the counts, and every field
of ``rebin_fast2``'s state (the stragglers after ``_compact_mini``). The
JAX kernel is compiled once (at XLA backend optimisation level 0) and
placed in the JAX package's kernel cache for its ``rebin_fast2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.engine import layout as jl
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import rebin_kernel as trk
from uammd_tpu_torch.utils.lattices import lattice

N, L = 600, 12.0


@pytest.fixture(scope="module")
def strag_moved():
    rng = np.random.default_rng(0)
    pos = lattice(N, L, "fcc") + 0.3 * rng.standard_normal((N, 3))
    spec = tl.choose_spec(L, N, 2.5, cap=8, pos=pos, n_strag=128)
    f = tl.grid_state_to_numpy(tl.pack(spec, pos, vel=rng.standard_normal((N, 3)),
                                       device="cpu"))
    m = f["pid"] >= 0
    dx = np.clip(0.35 * rng.standard_normal(f["x"].shape), -1.0, 1.0) * m
    f["x"] = (f["x"] + dx).astype(np.float32)
    f["y"] = (f["y"] + 0.5 * dx).astype(np.float32)
    f["z"] = (f["z"] - 0.3 * dx).astype(np.float32)
    sv = (f["spid"] >= 0)[:, None]
    f["spos"] = (f["spos"] + 0.35 * rng.standard_normal(f["spos"].shape) * sv).astype(np.float32)
    assert sv.sum() > 0
    spec_j = jl.choose_spec(L, N, 2.5, cap=8, pos=pos, n_strag=128)
    gj = jl.GridState(spec=spec_j, n=N, key=jax.random.key(0, impl="rbg"),
                      **{k: jnp.asarray(f[k]) for k in tl.STATE_FIELDS})
    return gj, tl.grid_state_from_numpy(spec, f, device="cpu")


@pytest.fixture(scope="module")
def jax_kernel(strag_moved):
    """The JAX kernel compiled once at XLA backend optimisation level 0 for
    the system's shapes."""
    from uammd_tpu.engine import rebin_kernel as jrk

    gj = strag_moved[0]
    spec_j = gj.spec
    stacked, strag = _rows(gj, jnp)
    args = (stacked, jnp.broadcast_to(strag[:, :, None], (7, spec_j.n_strag, spec_j.nlane)))
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    kern = jax.jit(jrk.make_rebin_kernel2(spec_j, 7, interpret=True)).lower(*args).compile(
        compiler_options=opts)
    jrk._KERNEL_CACHE[(spec_j, 7, "v2", jax.default_backend())] = kern
    return kern


def _rows(g, xp):
    if xp is jnp:
        stacked = jnp.stack([g.x, g.y, g.z, g.vx, g.vy, g.vz, (g.pid + 1).astype(jnp.float32)])
        strag = jnp.stack([g.spos[:, 0], g.spos[:, 1], g.spos[:, 2], g.svel[:, 0],
                           g.svel[:, 1], g.svel[:, 2], (g.spid + 1).astype(jnp.float32)])
        return stacked, strag
    stacked = torch.stack([g.x, g.y, g.z, g.vx, g.vy, g.vz, (g.pid + 1).to(torch.float32)])
    strag = torch.stack([g.spos[:, 0], g.spos[:, 1], g.spos[:, 2], g.svel[:, 0],
                         g.svel[:, 1], g.svel[:, 2], (g.spid + 1).to(torch.float32)])
    return stacked, strag


def _compare(gj, gt, jax_kernel, what):
    spec = gt.spec
    stacked_j, strag_j = _rows(gj, jnp)
    out_j = jax_kernel(stacked_j,
                       jnp.broadcast_to(strag_j[:, :, None], (7, spec.n_strag, spec.nlane)))
    launches = trk.REBIN2.launches
    stacked_t, strag_t = _rows(gt, torch)
    # the JAX kernel's broadcast [Q, S, NLANE] block and the plain [Q, S] rows
    out_t = trk.make_rebin_kernel2(spec)(
        stacked_t, strag_t[:, :, None].expand(7, spec.n_strag, spec.nlane))
    out_r = trk.rebin2_plain(spec, stacked_t, strag_t)
    assert trk.REBIN2.launches == launches  # the CPU path launches nothing
    for got in (out_t, out_r):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(out_j[0]), err_msg=what)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(out_j[1]), err_msg=what)
        assert int(got[2]) == int(out_j[2]) and int(got[3]) == int(out_j[3]), what
    return out_t


def test_plain_matches_jax_kernel_exactly(strag_moved, jax_kernel):
    gj, gt = strag_moved
    out = _compare(gj, gt, jax_kernel, "drifted straggler system")
    assert int(out[2]) == N and int(out[3]) == 0
    assert (out[1][6] > 0.5).any()  # the mini-grid holds the new stragglers


def test_rebin_fast2_matches_jax_and_the_other_rebins(strag_moved, jax_kernel):
    from uammd_tpu.engine.rebin_kernel import rebin_fast2 as j_rebin_fast2

    gj, gt = strag_moved
    rj = j_rebin_fast2(gj)  # eager around the cached, compiled kernel
    rt = trk.rebin_fast2(gt)
    for k in tl.STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rj, k)), getattr(rt, k).numpy(),
                                      err_msg=k)
    assert int((rt.pid >= 0).sum()) + int((rt.spid >= 0).sum()) == N
    assert int((rt.spid >= 0).sum()) > 0
    assert not bool(rt.overflow)
    # the same particles as the separable rebin and the sort rebin, by pid
    p2, v2, _ = tl.unpack(rt)
    for other in (trk.rebin_fast3(gt), tl.rebin(gt)):
        assert not bool(other.overflow)
        p, v, _ = tl.unpack(other)
        assert torch.equal(p2, p) and torch.equal(v2, v)


def test_ocap_overflow_matches_jax(strag_moved, jax_kernel):
    """Every straggler row moved into one cell: more than CAP + OCAP
    candidates rank there, and the overflow count (and rebin_fast2's flag)
    match the JAX kernel's."""
    gj, gt = strag_moved
    sv = gt.spid >= 0
    spos = torch.where(sv[:, None], torch.tensor([0.1, 0.2, 0.3]), gt.spos)
    g2t = gt.replace(spos=spos)
    g2j = gj.replace(spos=jnp.asarray(spos.numpy()))
    out = _compare(g2j, g2t, jax_kernel, "stragglers crammed into one cell")
    assert int(out[3]) > 0
    assert bool(trk.rebin_fast2(g2t).overflow)


def test_rebin_fast2_on_the_unfused_engines_drifted_states(monkeypatch):
    """Every state the unfused v2 engine (``fold_in_update=False``) hands
    to its rebin in 6 fast steps: ``rebin_fast2`` keeps every particle
    without overflow and gives the same particles by pid as the engine's
    ``rebin_fast3``."""
    from uammd_tpu_torch.engine import md2

    seen = []
    real = md2.rebin_fast3
    monkeypatch.setattr(md2, "rebin_fast3", lambda gs: seen.append(gs) or real(gs))
    rng = np.random.default_rng(2)
    pos = lattice(N, L, "fcc") + np.clip(0.15 * rng.standard_normal((N, 3)), -0.2, 0.2)
    md = md2.make_lj_md2(L, N, dt=0.01, temperature=1.0, cap=8, n_strag=128, pos=pos,
                         fold_in_update=False, device="cpu")
    md.run(md.init(pos, seed=3, vel=rng.normal(0.0, 2.5, (N, 3))), 6)
    assert len(seen) >= 2
    for gs in seen:
        r2, r3 = trk.rebin_fast2(gs), real(gs)
        assert not bool(r2.overflow)
        assert int((r2.pid >= 0).sum()) + int((r2.spid >= 0).sum()) == N
        p2, v2, _ = tl.unpack(r2)
        p3, v3, _ = tl.unpack(r3)
        assert torch.equal(p2, p3) and torch.equal(v2, v3)


def test_needs_a_straggler_spec():
    spec = tl.choose_spec(L, N, 2.5)
    with pytest.raises(ValueError, match="straggler"):
        trk.make_rebin_kernel2(spec)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_exactly(cuda, strag_moved):
    _, gt = strag_moved
    stacked, strag = _rows(gt, torch)
    kern = trk.make_rebin_kernel2(gt.spec)
    launches = trk.REBIN2.launches
    got = kern(stacked.to(cuda), strag.to(cuda))
    torch.cuda.synchronize()
    assert trk.REBIN2.launches == launches + 1
    want = kern(stacked, strag)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert (int(got[2]), int(got[3])) == (int(want[2]), int(want[3]))
