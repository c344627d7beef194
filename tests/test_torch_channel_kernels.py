"""The port's channel kernels of the PSE near field against the JAX
package's (Pallas interpret mode on the CPU): the 27-stencil channel kernel
#2 (``pair_kernel.make_pair_channel_kernel``), the Newton channel kernel #10
(``kernel2.make_newton_channel_kernel``, through ``PSEGrid._kernel(nvec,
newton=True)``) and the n-channel fold #9 (``kernel2.make_fold_kernel_n``).

System: tests/test_pse_engine.py:536's n 512 fcc suspension at volume
fraction 0.08 with a 20-particle clump, so 17 particles ride in the
48-row straggler list. Both sides get JAX's packed arrays slot for slot.
The JAX ``PSEGrid`` is built from the port's constants (that ``create``
gives JAX's constants is tests/test_torch_pse_engine.py's business), and
each JAX kernel is compiled once at XLA backend optimisation level 0.
Tolerance: every output within 2e-5 x max|out| (the bar of
test_pse_engine.py:573), float32 sums in another order; the straggler
partials are compared as reduced totals (the JAX kernels return
per-program partial grids that their caller sums). The fold is bit-equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as j_box
from uammd_tpu.engine import kernel2 as jk
from uammd_tpu.engine.layout import GridSpec as JGridSpec
from uammd_tpu.engine.layout import pack_channels as j_pack_channels
from uammd_tpu.engine.pair_kernel import broadcast_strag_channels as j_bsc
from uammd_tpu.engine.pair_kernel import make_pair_channel_kernel as j_make_channel
from uammd_tpu.integrators.bdhi.pse_engine import PSEGrid as JPSEGrid
from uammd_tpu.utils.lattices import lattice
from uammd_tpu_torch.core.box import box as t_box
from uammd_tpu_torch.engine import kernel2 as tk
from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import pair_kernel as tp
from uammd_tpu_torch.integrators.bdhi.pse_engine import PSEGrid

N, PHI = 512, 0.08
L = (N * (4.0 / 3.0) * math.pi / PHI) ** (1.0 / 3.0)
KW = dict(viscosity=1.0, radius=1.0, far_grid=32, tolerance=1e-3, lanczos_iterations=3,
          n_strag=48)
TOL = 2e-5


def _pos():
    rng = np.random.default_rng(3)
    base = np.asarray(lattice(N - 20, L, "fcc"))
    clump = rng.uniform(-2.0, 2.0, (20, 3)) + 3.0
    return np.concatenate([base, clump]).astype(np.float32), rng


def _jit0(fn, *args):
    """jax.jit(fn) compiled for ``args`` at backend optimisation level 0."""
    opts = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


@pytest.fixture(scope="module")
def system():
    pos, rng = _pos()
    be_t = PSEGrid.create(t_box(L, device="cpu"), N, pos=pos, **KW)
    spec_j = JGridSpec(**{f: getattr(be_t.spec, f) for f in (
        "box_size", "shape", "cap", "fold", "cutoff", "skin", "n_strag")})
    be_j = JPSEGrid(box=j_box(L), far=None, viscosity=1.0, radius=1.0, xi=be_t.xi,
                    rcut=be_t.rcut, spec=spec_j, qb=be_t.qb, coef=be_t.coef,
                    uscale=be_t.uscale, self_f=be_t.self_f, fit_error=be_t.fit_error,
                    coef_noise=be_t.coef_noise)
    chans = rng.normal(size=(N, 6)).astype(np.float32)
    cg_j = jax.jit(lambda p, c: j_pack_channels(be_j.spec, p, c))(jnp.asarray(pos),
                                                                jnp.asarray(chans))
    assert int(np.asarray((cg_j.spid >= 0).sum())) > 0, "want stragglers"
    cg_t = tl.channel_grid_from_numpy(be_t.spec, {
        k: np.asarray(getattr(cg_j, k)) for k in
        ("x", "y", "z", "pid", "overflow", "spos", "spid")} | {
        "channels": [np.asarray(c) for c in cg_j.channels],
        "schannels": [np.asarray(c) for c in cg_j.schannels], "n": N}, device="cpu")
    return be_j, be_t, cg_j, cg_t


def _j_args(be_j, cg_j, nvec):
    chans = list(cg_j.channels[: 3 * nvec])
    blk = j_bsc(be_j.spec, cg_j.spos, tuple(cg_j.schannels[: 3 * nvec]), cg_j.spid)
    return chans, blk


def _t_args(be_t, cg_t, nvec):
    chans = list(cg_t.channels[: 3 * nvec])
    blk = tp.broadcast_strag_channels(be_t.spec, cg_t.spos, tuple(cg_t.schannels[: 3 * nvec]),
                                      cg_t.spid)
    return chans, blk


@pytest.fixture(scope="module")
def jax_outputs(system):
    """The JAX 27-stencil kernel's outputs (``make_pair_channel_kernel`` with
    the PSE ``pair_fn``, interpret mode) at nvec 1 and 2, and the Newton
    kernel's (``PSEGrid._kernel(1, newton=True)``, interpret mode, fold by
    ``fold_reactions_n_jnp``) at nvec 1; straggler partials reduced to
    totals."""
    be_j, _, cg_j, _ = system
    out = {}
    for nvec, name in ((1, "27"), (2, "27"), (1, "newton")):
        chans, blk = _j_args(be_j, cg_j, nvec)
        if name == "27":
            pf, pbf = be_j._pair_fn(nvec)
            kern = j_make_channel(be_j.spec, pf, 3 * nvec, 3 * nvec, interpret=True,
                                  pair_both_fn=pbf)
        else:
            kern = be_j._kernel(nvec, newton=True)
        nc = 3 * nvec
        args = (cg_j.x, cg_j.y, cg_j.z, *chans, blk)
        o = _jit0(lambda x, y, z, *c: kern(x, y, z, *c[:-1], strag=c[-1]), *args)(*args)
        out[(nvec, name)] = ([np.asarray(a) for a in o[:nc]],
                             [np.asarray(jnp.sum(a, axis=(0, 1, 3))) for a in o[nc:]])
    return out


def _assert_close(got, want, what):
    grids_t, strag_t = got
    grids_j, strag_j = want
    scale = max(float(np.abs(a).max()) for a in grids_j)
    assert scale > 0
    for c, (a, b) in enumerate(zip(grids_t, grids_j)):
        np.testing.assert_allclose(a, b, atol=TOL * scale, rtol=0, err_msg=f"{what} grid {c}")
    assert len(strag_t) == len(strag_j)
    for c, (a, b) in enumerate(zip(strag_t, strag_j)):
        np.testing.assert_allclose(a, b, atol=TOL * scale, rtol=0,
                                   err_msg=f"{what} stragglers {c}")


def _split(outs, nvec):
    nc = 3 * nvec
    return [o.numpy() for o in outs[:nc]], [o.numpy() for o in outs[nc:]]


@pytest.mark.parametrize("nvec", [1, 2])
def test_pair_channel_plain_matches_jax(system, jax_outputs, nvec):
    _, be_t, _, cg_t = system
    chans, blk = _t_args(be_t, cg_t, nvec)
    outs = tp.make_pair_channel_kernel(be_t.spec, be_t.near_fn(), nvec)(
        cg_t.x, cg_t.y, cg_t.z, *chans, strag=blk)
    _assert_close(_split(outs, nvec), jax_outputs[(nvec, "27")], f"#2 nvec {nvec}")


def test_newton_channel_plain_matches_jax(system, jax_outputs):
    """#10 at nvec 1 against JAX; at nvec 2 it is held to #2's plain
    version below, which is held to JAX above."""
    _, be_t, _, cg_t = system
    chans, blk = _t_args(be_t, cg_t, 1)
    outs = be_t._kernel(1, newton=True)(cg_t.x, cg_t.y, cg_t.z, *chans, strag=blk)
    _assert_close(_split(outs, 1), jax_outputs[(1, "newton")], "#10 nvec 1")


@pytest.mark.parametrize("nvec", [1, 2])
def test_newton_plain_matches_27_stencil_plain(system, nvec):
    """#10 and #2 compute the same function (each pair once or twice)."""
    _, be_t, _, cg_t = system
    chans, blk = _t_args(be_t, cg_t, nvec)
    o27 = be_t._kernel(nvec, newton=False)(cg_t.x, cg_t.y, cg_t.z, *chans, strag=blk)
    ont = be_t._kernel(nvec, newton=True)(cg_t.x, cg_t.y, cg_t.z, *chans, strag=blk)
    _assert_close(_split(ont, nvec), _split(o27, nvec), f"#10 vs #2 nvec {nvec}")


def test_fold_n_matches_jax_bit_for_bit(system):
    """#9's plain version against ``fold_reactions_n_jnp`` and the Pallas
    ``make_fold_kernel_n`` (interpret mode), on the port's raw Newton
    outputs at n = 6; and at n = 3 it equals the 3-channel fold #7."""
    be_j, be_t, _, cg_t = system
    chans, blk = _t_args(be_t, cg_t, 2)
    home, groups, _ = be_t._kernel(2, newton=True).raw(cg_t.x, cg_t.y, cg_t.z, *chans,
                                                       strag=blk)
    got = tk.make_fold_kernel_n(be_t.spec, 6)(home, groups)
    hj = [jnp.asarray(h.numpy()) for h in home]
    gj = [[jnp.asarray(c.numpy()) for c in g] for g in groups]
    want_jnp = _jit0(jk.fold_reactions_n_jnp, hj, gj)(hj, gj)
    want_pl = jk.make_fold_kernel_n(be_j.spec, 6, interpret=True)(hj, gj)
    for a, b, c in zip(got, want_jnp, want_pl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    three = tk.fold_reactions_plain(home[:3], [g[:3] for g in groups])
    for a, b in zip(tk.fold_reactions_n_plain(home[:3], [g[:3] for g in groups]), three):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_channel_kernels_reject_other_functors(system):
    _, be_t, _, _ = system
    with pytest.raises(TypeError):
        tp.make_pair_channel_kernel(be_t.spec, lambda *a: a)
    with pytest.raises(TypeError):
        tk.make_newton_channel_kernel(be_t.spec, lambda *a: a)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _on(cg, dev):
    return tl.channel_grid_from_numpy(cg.spec, tl.channel_grid_to_numpy(cg), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("nvec", [1, 2])
@pytest.mark.parametrize("newton", [False, True])
def test_cuda_channel_kernels_match_plain(cuda, system, nvec, newton):
    """#2 and #10 (with #9) on the card against their plain versions on the
    CPU, 2e-5 x max|out|; one launch each."""
    _, be_t, _, cg_t = system
    cg_c = _on(cg_t, cuda)
    chans, blk = _t_args(be_t, cg_t, nvec)
    chans_c, blk_c = _t_args(be_t, cg_c, nvec)
    want = be_t._kernel(nvec, newton=newton)(cg_t.x, cg_t.y, cg_t.z, *chans, strag=blk)
    counter = tk.NEWTON_CHANNEL if newton else tp.PAIR_CHANNEL
    before = counter.launches
    got = be_t._kernel(nvec, newton=newton)(cg_c.x, cg_c.y, cg_c.z, *chans_c, strag=blk_c)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    _assert_close(_split([g.cpu() for g in got], nvec), _split(want, nvec),
                  f"CUDA {'#10' if newton else '#2'} nvec {nvec}")


@pytest.mark.gpu
def test_cuda_fold_n_matches_plain(cuda, system):
    _, be_t, _, cg_t = system
    chans, blk = _t_args(be_t, cg_t, 2)
    home, groups, _ = be_t._kernel(2, newton=True).raw(cg_t.x, cg_t.y, cg_t.z, *chans,
                                                       strag=blk)
    want = tk.fold_reactions_n_plain(home, groups)
    before = tk.FOLD_N.launches
    got = tk.make_fold_kernel_n(be_t.spec, 6)(
        [h.to(cuda) for h in home], [[c.to(cuda) for c in g] for g in groups])
    torch.cuda.synchronize()
    assert tk.FOLD_N.launches == before + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
