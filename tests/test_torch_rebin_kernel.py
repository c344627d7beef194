"""The port's rebin kernel (uammd_tpu_torch.engine.rebin_kernel) against the
JAX package's Pallas kernel (interpret mode on the CPU): equal slot for
slot, exactly, for Q = 7 (rebin_fast_noforce, the MD path) and Q = 10
(rebin_fast), and a capacity violation latches overflow.

On a face of the box the port's rebins wrap a coordinate before its cell
test, as the sort rebin does, where JAX's kernel tests the image-shifted
coordinate: the face tests seed the same state with particles on the
float32 values near +-L/2 where that loses a particle or stores another
representative, and hold every port rebin to JAX's ``layout.rebin`` there.

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
# one jitted JAX kernel call for the module: the face state has the
# displaced state's shapes, so it reuses the compiled program
_J_REBIN_FAST = jax.jit(j_rebin_fast)


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
    return _J_REBIN_FAST(displaced[0])


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


def test_separable_plain_overflow_matches_jax_on_a_z_pass_overflow(strag_moved,
                                                                   jax_separable):
    """tests/test_torch_sep_rebin_pull.py's state that overflows only in the
    z pass's intermediate (three full columns moved into one z cell, the
    outer two out of its y cell; the final cells fit), at the n 600 spec:
    the plain version's count and overflow equal JAX's kernel's."""
    from test_torch_sep_rebin_pull import crammed
    from uammd_tpu_torch.engine.rebin_kernel import separable_rebin_plain

    spec, stacked, strag = crammed("z")
    assert spec == strag_moved[1].spec
    S, nlane = spec.n_strag, spec.nlane
    out_j = jax_separable(jnp.asarray(stacked.numpy()),
                          jnp.broadcast_to(jnp.asarray(strag.numpy())[:, :, None], (7, S, nlane)))
    out_t = separable_rebin_plain(spec, stacked, strag)
    assert int(out_t[3]) > 0
    assert (int(out_t[2]), int(out_t[3])) == (int(out_j[2]), int(out_j[3]))


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


# ---------------------------------------------------------------------------
# The faces of the box. A float32 replica of the rule of JAX's kernels (and
# of the port's #3 and #4 before they wrapped first): a destination cell d
# adds the image shift of its stencil's wrapped index to the candidate and
# tests floor(frac(p / L + 1/2) n) == d on the shifted value.

F32 = np.float32


def _cell(p, iL, n):
    fr = p * iL + F32(0.5)
    return np.floor((fr - np.floor(fr)) * F32(n))


def _wrap(p, L, iL):
    return (p - L * np.rint(p * iL)) + F32(0.0)


def _old_claims(x, s, L, n):
    """(destination, stored value) of every cell that claims the
    coordinate ``x`` of a particle in source cell ``s`` on one axis."""
    L = F32(L)
    iL = F32(1.0) / L
    out = []
    for d in sorted({(s - 1) % n, s, (s + 1) % n}):
        k = next(k for k in (-1, 0, 1) if (d + k) % n == s)
        idx = d + k
        sh = -L if idx < 0 else (L if idx >= n else F32(0.0))
        p = F32(x) + sh
        if _cell(p, iL, n) == d:
            out.append((d, _wrap(p, L, iL)))
    return out


def _sort_cell(x, L, n):
    L = F32(L)
    iL = F32(1.0) / L
    w = _wrap(F32(x), L, iL)
    fr = w * iL + F32(0.5)
    return min(int((fr - np.floor(fr)) * F32(n)), n - 1), w


def face_values(L, n, ulps=8):
    """(source cell, x) within ``ulps`` float32 spacings of -L/2 and +L/2,
    for source cells 0 and n - 1, where the shifted rule does not store
    the particle exactly once as the sort rebin stores it."""
    bad = []
    for edge in (-L / 2, L / 2):
        x = F32(edge)
        xs = [x]
        lo = hi = x
        for _ in range(ulps):
            lo, hi = np.nextafter(lo, F32(-np.inf)), np.nextafter(hi, F32(np.inf))
            xs += [lo, hi]
        for s in (0, n - 1):
            for v in sorted(xs):
                want = _sort_cell(v, L, n)
                got = _old_claims(v, s, L, n)
                if len(got) != 1 or got[0][0] != want[0] or got[0][1] != want[1]:
                    bad.append((s, F32(v)))
    return bad


def seed_faces(f, spec, per_axis):
    """Copy of the numpy fields ``f`` with particles moved onto the face
    values ``per_axis[a]`` ((source cell, x) pairs) of each axis a: each
    value goes to a different occupied slot whose cell on that axis is the
    source cell. Returns (fields, the pids moved)."""
    f = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in f.items()}
    nz, nyb, cap, nlane = spec.array_shape
    F = spec.fold
    lane = np.arange(nlane)
    cell = (np.broadcast_to((lane // F)[None, None, None, :], (nz, nyb, cap, nlane)),
            np.broadcast_to((np.arange(nyb)[:, None] * F + lane % F)[None, :, None, :],
                            (nz, nyb, cap, nlane)),
            np.broadcast_to(np.arange(nz)[:, None, None, None], (nz, nyb, cap, nlane)))
    used = np.zeros((nz, nyb, cap, nlane), bool)
    moved = []
    for a, key in enumerate(("x", "y", "z")):
        for s, v in per_axis[a]:
            free = np.argwhere((f["pid"] >= 0) & (cell[a] == s) & ~used)
            i = tuple(free[len(free) // 2])
            used[i] = True
            f[key][i] = v
            moved.append(int(f["pid"][i]))
    return f, moved


@pytest.fixture(scope="module")
def faces(displaced):
    """The displaced state with particles on every face value of each axis
    within 8 ulps of +-L/2 (the last x cell's 11.999999 among them), as
    JAX and port states; a straggler-capable port copy (16 empty rows) for
    the straggler rebins #4 and #5."""
    import dataclasses

    gj, gt = displaced
    spec = gt.spec
    per_axis = [face_values(L, n) for L, n in zip(spec.box_size, spec.shape)]
    assert (spec.shape[0] - 1, np.nextafter(F32(12.0), F32(0.0))) in per_axis[0]
    f = tl.grid_state_to_numpy(gt)
    f, moved = seed_faces(f, spec, per_axis)
    gjf = gj.replace(**{k: jnp.asarray(f[k]) for k in ("x", "y", "z")})
    gtf = tl.grid_state_from_numpy(spec, f, device="cpu")
    spec_s = dataclasses.replace(spec, n_strag=16)
    fs = dict(f, spos=np.full((16, 3), tl.EMPTY_POS, np.float32),
              svel=np.zeros((16, 3), np.float32), sforce=np.zeros((16, 3), np.float32),
              spid=np.full(16, -1, np.int32))
    return gjf, gtf, tl.grid_state_from_numpy(spec_s, fs, device="cpu"), moved


@pytest.fixture(scope="module")
def jax_sorted_faces(faces):
    return np.asarray(jl.unpack(jax.jit(jl.rebin)(faces[0]))[0])


def test_jax_kernel_loses_a_face_particle(faces, jax_sorted_faces):
    gjf, gtf, _, moved = faces
    out = _J_REBIN_FAST(gjf)
    pids = np.asarray(out.pid)
    kept = set(pids[pids >= 0].tolist())
    assert len(kept) < gtf.n  # the kernel found no cell for some particle
    assert bool(out.overflow)
    lost = set(range(gtf.n)) - kept
    assert lost <= set(moved)
    # the last x cell's particle at 11.999999 is among them
    assert moved[0] in lost
    # JAX's sort rebin keeps every particle, each at its wrapped coordinate
    rj = jax.jit(jl.rebin)(gjf)
    assert int((np.asarray(rj.pid) >= 0).sum()) == gtf.n
    assert not bool(rj.overflow)
    assert np.isfinite(jax_sorted_faces).all()


@pytest.mark.parametrize("which", ["rebin_plain_q10", "rebin_plain_q7", "rebin2_plain",
                                   "separable_rebin_plain", "layout.rebin"])
def test_port_rebins_keep_face_particles_as_jax_sort(faces, jax_sorted_faces, which):
    from uammd_tpu_torch.engine.rebin_kernel import rebin_fast2, rebin_fast3

    _, gtf, gts, moved = faces
    run = {"rebin_plain_q10": lambda: rebin_fast(gtf),
           "rebin_plain_q7": lambda: rebin_fast_noforce(gtf),
           "rebin2_plain": lambda: rebin_fast2(gts),
           "separable_rebin_plain": lambda: rebin_fast3(gts),
           "layout.rebin": lambda: tl.rebin(gtf)}[which]
    rt = run()
    assert not bool(rt.overflow)
    n_kept = int((rt.pid >= 0).sum()) + (int((rt.spid >= 0).sum()) if rt.spid.numel() else 0)
    assert n_kept == gtf.n
    pos = tl.unpack(rt)[0].numpy()
    np.testing.assert_array_equal(pos, jax_sorted_faces)
    np.testing.assert_array_equal(pos[moved], jax_sorted_faces[moved])


def test_old_rule_fails_on_the_face_values(faces):
    """The control: the shifted rule's replica loses or moves the seeded
    values, one axis at a time, so the face tests above see them."""
    _, gtf, _, _ = faces
    spec = gtf.spec
    for L, n in zip(spec.box_size, spec.shape):
        vals = face_values(L, n)
        assert vals
        for s, v in vals:
            got = _old_claims(v, s, L, n)
            assert len(got) != 1 or (got[0][0], got[0][1]) != _sort_cell(v, L, n)


def test_pair_force_misses_the_partners_of_a_face_representative():
    """A property of the reference, recorded and not repaired: the sort
    rebin (both packages' ``pack``) stores a particle at +L/2 - 1 ulp in x
    cell 0, on the far side of the box from its cell. The pair kernels
    reach cell 0's neighbours through image shifts, so its x neighbours
    come out about L away and its pairs across the face are left out."""
    L = 24.0
    face = float(np.nextafter(F32(12.0), F32(0.0)))
    pos = np.array([[face, 0.3, 0.2], [face - 1.1, 0.3, 0.2], [-11.0, 0.3, 0.2]])
    spec = tl.choose_spec(L, 3, 2.5)
    gs = tl.pack(spec, pos, device="cpu")
    gj = jl.pack(jl.choose_spec(L, 3, 2.5), pos)
    p0 = int(np.argwhere(np.asarray(gj.pid) == 0)[0][3])
    assert int(np.argwhere(gs.pid.numpy() == 0)[0][3]) == p0
    assert p0 // spec.fold == 0  # x cell 0, at x = +L/2 - 1 ulp
    assert float(gs.x[gs.pid == 0][0]) == face
    from uammd_tpu_torch.engine import md, pair_kernel

    g = md.lj_g()
    f = [a[gs.mask] for a in pair_kernel.pair_force_plain(spec, g, gs.x, gs.y, gs.z)]
    fx = dict(zip(gs.pid[gs.mask].tolist(), f[0].tolist()))
    # minimum image: particle 0 has partners 1.1 (particle 1) and 1.0
    # (particle 2) away; the grid sees neither, but it sees the pair (1, 2)
    # 2.1 apart across the face
    assert fx[0] == 0.0
    g12 = float(g(torch.tensor(2.1 * 2.1, dtype=torch.float64))) * 2.1
    assert fx[1] != 0.0 and fx[1] == -fx[2]
    assert abs(fx[1]) == pytest.approx(abs(g12), rel=1e-5)
    missed = [abs(float(g(torch.tensor(d * d, dtype=torch.float64))) * d) for d in (1.1, 1.0)]
    assert min(missed) > 1.0  # the forces the face representative misses


def _floats_between(lo, hi):
    """Every float32 in [lo, hi] (lo < 0 < hi or one side), ascending."""
    lo, hi = F32(lo), F32(hi)
    parts = []
    if lo < 0:
        top = F32(-hi).view(np.int32) if hi < 0 else 0
        parts.append(-np.arange(top, F32(-lo).view(np.int32) + 1, dtype=np.int32)
                     .view(np.float32))
    if hi >= 0:
        bottom = F32(lo).view(np.int32) if lo >= 0 else 0
        parts.append(np.arange(bottom, hi.view(np.int32) + 1, dtype=np.int32).view(np.float32))
    return np.unique(np.concatenate(parts))


# (L, cells) of each path whose rebin is a kernel: the L 24 test state, v1
# (L 128: 32, 40, 42 cells), DPD (70.44: 64), SPH (81.27: 32, 36), the PSE
# near grid (222.27: 19, 18)
FACE_AXES = [(24.0, 8), (128.0, 32), (128.0, 40), (128.0, 42), (70.44111464308536, 64),
             (81.2749338607718, 32), (81.2749338607718, 36), (222.2676086902632, 19),
             (222.2676086902632, 18)]


@pytest.mark.parametrize("L,n", FACE_AXES)
def test_rules_differ_only_near_the_face_or_on_the_far_side(L, n):
    """Over every float32 within half a cell of -L/2 and +L/2 and the source
    cells 0 and n - 1, the shifted rule and the wrap-first rule claim the
    same cell and store the same bits, except within 3 ulps of +-L/2 or for
    a particle on the far side of its source cell (cell 0 at x > 0, the
    last cell at x < 0)."""
    Lf = F32(L)
    iL = F32(1.0) / Lf
    half = F32(L / 2)
    for edge in (-L / 2, L / 2):
        xs = _floats_between(edge - 0.5 * L / n, edge + 0.5 * L / n)
        w_new = _wrap(xs, Lf, iL)
        c_new = _cell(w_new, iL, n)
        near = np.abs(np.abs(xs) - half) <= 3 * np.spacing(half)
        for s in (0, n - 1):
            differ = np.zeros(xs.shape, bool)
            for d in sorted({(s - 1) % n, s, (s + 1) % n}):
                k = next(k for k in (-1, 0, 1) if (d + k) % n == s)
                sh = -Lf if d + k < 0 else (Lf if d + k >= n else F32(0.0))
                q = xs + sh
                old = _cell(q, iL, n) == d
                new = c_new == d
                same_bits = _wrap(q, Lf, iL).view(np.int32) == w_new.view(np.int32)
                differ |= (old != new) | (old & new & ~same_bits)
            far = xs > 0 if s == 0 else xs < 0
            assert not (differ & ~near & ~far).any(), xs[differ & ~near & ~far][:4]
