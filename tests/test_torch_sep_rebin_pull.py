"""The separable rebin #5's CUDA design (``csrc/sep_rebin.cu``) replayed in
float32 torch on the CPU, against ``separable_rebin_plain`` (the three
passes, z then y then x).

The kernel gives the passes' result in one classify-and-pull pair: a code
byte a slot (the offset of its wrapped coordinate's cell on each axis, 3
where farther or not a number), the straggler rows' full cells, and a pull
that ranks each cell's particles by source (dx, then dy, then dz, each -1,
0, +1), slots ascending, with the cell's straggler rows right after source
(0, 0, +1), and counts the passes' intermediate occupancies from the
masked codes. ``pull_replica`` is that algorithm written out in torch. It
must equal the plain version bit for bit (out, mini, count, overflow)
where the plain version reports no overflow, and set overflow exactly when
the plain version does on states that overflow in only the z pass's
intermediate, only the y pass's, or only the final cell. Two controls must
differ from the plain version: the replica in #3's (dz, dy, dx) order and
the replica with the straggler rows ranked last.

The kernel stores a straggler's x and y wrapped twice, as the passes do,
and takes its cell from the coordinates wrapped once: the last test shows
the wrap idempotent on every float32 near a half box at each path's L.

The one-shot straggler rebin #4 (``csrc/rebin2.cu``) runs the same
classify and a pull in #3's (dz, dy, dx) order with the cell's straggler
rows after the last source, each value wrapped once and only the final
ranks counted for overflow: ``rebin2_replica`` must equal
``rebin2_plain`` bit for bit on the clean states and on a crammed one,
and the replica in #5's order must not.

No JAX here: about 6 s on one core.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from uammd_tpu_torch.engine import layout as tl
from uammd_tpu_torch.engine import rebin_kernel as rk
from uammd_tpu_torch.engine.layout import EMPTY_POS, OCAP, stencil_sources
from uammd_tpu_torch.utils.lattices import lattice

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-torch runs; the test tier runs files in parallel worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ replica
def codes_of(spec, stacked):
    """The classify kernel's code of every slot [nz, nyb, CAP, NLANE]:
    16 fz + 4 fy + fx, f = 1 + the offset of the wrapped coordinate's cell
    from the slot's (3: farther or not a number), 0xff for an empty slot."""
    nz, nyb, _, nlane = spec.array_shape
    F = spec.fold
    lane = torch.arange(nlane)
    own = ((lane // F)[None, None, None, :],
           (torch.arange(nyb)[:, None] * F + lane % F)[None, :, None, :],
           torch.arange(nz)[:, None, None, None])
    code = torch.zeros(stacked.shape[1:], dtype=torch.int64)
    for d, (n, L) in enumerate(zip(spec.shape, spec.box_size)):
        _, c = rk._wrapped_cell(stacked[d], L, n)
        diff = c - own[d].to(torch.float32)
        field = torch.full_like(code, 3)
        field = torch.where(diff == 0, 1, field)
        field = torch.where((diff == 1) | (diff == 1 - n), 2, field)
        field = torch.where((diff == -1) | (diff == n - 1), 0, field)
        code = code + field * 4 ** d
    return torch.where(stacked[-1] > 0.5, code, 0xFF)


def strag_cells(spec, strag):
    """The flat index (z nyb + yb) NLANE + lane of the cell that claims each
    straggler row by its full cell (the z pass's rule), or -1."""
    valid = strag[-1] > 0.5
    cell = []
    for d, (n, L) in enumerate(zip(spec.shape, spec.box_size)):
        _, c = rk._wrapped_cell(strag[d], L, n)
        valid = valid & (c >= 0) & (c < n)
        cell.append(torch.nan_to_num(c).clamp(0, n - 1).to(torch.int64))
    cx, cy, cz = cell
    yb = cy // spec.fold
    flat = (cz * spec.nyb + yb) * spec.nlane + cx * spec.fold + (cy - yb * spec.fold)
    return torch.where(valid, flat, -1)


def source_order(order):
    """The 27 source offsets (dx, dy, dz) of a destination in rank order and
    the index after which its straggler rows come: 0 the passes' order, 1
    #3's (dz, dy, dx) order, 2 the passes' order with the stragglers last."""
    offs = [(c, b, a) if order == 1 else (a, b, c)
            for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]
    return offs, {0: 14, 1: 22, 2: 26}[order]


def want_code(dx, dy, dz):
    return 16 * (1 - dz) + 4 * (1 - dy) + (1 - dx)


def pull_replica(spec, stacked, strag, ocap=OCAP, order=0):
    """#5's classify and pull. Returns (out, mini, count, overflow, the
    largest z-pass, y-pass and final occupancies)."""
    n_q = stacked.shape[0]
    nz, nyb, cap, nlane = spec.array_shape
    S = spec.n_strag
    wide = cap + ocap
    Ls = spec.box_size
    codes = codes_of(spec, stacked)
    scell = strag_cells(spec, strag)
    rows = torch.arange(cap)[None, None, :, None]
    gvals = torch.stack([rk._wrap_pos(stacked[d], Ls[d]) for d in range(3)]
                        + [stacked[q] + 0.0 for q in range(3, n_q)])
    # a straggler's x and y wrapped twice, as the z and then the y / x pass
    # store them
    sw = [rk._wrap_pos(rk._wrap_pos(strag[0], Ls[0]), Ls[0]),
          rk._wrap_pos(rk._wrap_pos(strag[1], Ls[1]), Ls[1]), rk._wrap_pos(strag[2], Ls[2])]
    svals = torch.stack(sw + [strag[q] + 0.0 for q in range(3, n_q)])
    svals = svals[:, None, None, :, None].expand(n_q, nz, nyb, S, nlane)
    flat = ((torch.arange(nz)[:, None, None] * nyb + torch.arange(nyb)[None, :, None]) * nlane
            + torch.arange(nlane)[None, None, :])
    mine = scell[None, None, :, None] == flat[:, :, None, :]  # [nz, nyb, S, nlane]
    out = torch.zeros((n_q, nz, nyb, wide, nlane), dtype=torch.float32)
    base = torch.zeros((nz, nyb, 1, nlane), dtype=torch.int64)
    n_y = torch.zeros((nz, nyb, nlane), dtype=torch.int64)
    n_z = torch.zeros_like(n_y)
    offs, js = source_order(order)
    for j, (dx, dy, dz) in enumerate(offs):
        zs, ybs, ls, _ = stencil_sources(spec, dz, dy, dx, "cpu")
        cand = codes[zs, ybs, rows, ls]
        w = want_code(dx, dy, dz)
        base = rk._rank_into(out, base, gvals[:, zs, ybs, rows, ls], cand == w)[0]
        if dx == 0:
            n_y += ((cand & 0x3C) == (w & 0x3C)).sum(dim=2)
        if dx == 0 and dy == 0:
            n_z += ((cand & 0x30) == (w & 0x30)).sum(dim=2)
        if j == js:
            base = rk._rank_into(out, base, svals, mine)[0]
            n_y += mine.sum(dim=2)
            n_z += mine.sum(dim=2)
    total = base[:, :, 0, :]
    unfilled = torch.arange(wide)[None, None, :, None] >= base
    out[:3] = torch.where(unfilled, torch.full_like(out[:3], EMPTY_POS), out[:3])
    over = sum((t - wide).clamp(min=0).sum() for t in (n_z, n_y, total))
    return (out[:, :, :, :cap].contiguous(), out[:, :, :, cap:].contiguous(), total.sum(), over,
            (int(n_z.max()), int(n_y.max()), int(total.max())))


def rebin2_replica(spec, stacked, strag, ocap=OCAP, order=1):
    """#4's classify and pull: the sources in ``source_order(order)``'s
    order (1: #3's (dz, dy, dx), the kernel's; 0: #5's, a control) with the
    cell's straggler rows after the last source, every value wrapped once.
    Returns (out, mini, count, overflow)."""
    n_q = stacked.shape[0]
    nz, nyb, cap, nlane = spec.array_shape
    S = spec.n_strag
    wide = cap + ocap
    Ls = spec.box_size
    codes = codes_of(spec, stacked)
    scell = strag_cells(spec, strag)
    rows = torch.arange(cap)[None, None, :, None]
    gvals = torch.stack([rk._wrap_pos(stacked[d], Ls[d]) for d in range(3)]
                        + [stacked[q] + 0.0 for q in range(3, n_q)])
    svals = torch.stack([rk._wrap_pos(strag[d], Ls[d]) for d in range(3)]
                        + [strag[q] + 0.0 for q in range(3, n_q)])
    svals = svals[:, None, None, :, None].expand(n_q, nz, nyb, S, nlane)
    flat = ((torch.arange(nz)[:, None, None] * nyb + torch.arange(nyb)[None, :, None]) * nlane
            + torch.arange(nlane)[None, None, :])
    mine = scell[None, None, :, None] == flat[:, :, None, :]  # [nz, nyb, S, nlane]
    out = torch.zeros((n_q, nz, nyb, wide, nlane), dtype=torch.float32)
    base = torch.zeros((nz, nyb, 1, nlane), dtype=torch.int64)
    for dx, dy, dz in source_order(order)[0]:
        zs, ybs, ls, _ = stencil_sources(spec, dz, dy, dx, "cpu")
        cand = codes[zs, ybs, rows, ls]
        base = rk._rank_into(out, base, gvals[:, zs, ybs, rows, ls],
                             cand == want_code(dx, dy, dz))[0]
    base = rk._rank_into(out, base, svals, mine)[0]
    total = base[:, :, 0, :]
    unfilled = torch.arange(wide)[None, None, :, None] >= base
    out[:3] = torch.where(unfilled, torch.full_like(out[:3], EMPTY_POS), out[:3])
    return (out[:, :, :, :cap].contiguous(), out[:, :, :, cap:].contiguous(), total.sum(),
            (total - wide).clamp(min=0).sum())


# ------------------------------------------------------------------- states
def stacks_of(gs):
    stacked = torch.stack([gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz,
                           (gs.pid + 1).to(torch.float32)])
    strag = torch.stack([gs.spos[:, 0], gs.spos[:, 1], gs.spos[:, 2], gs.svel[:, 0],
                         gs.svel[:, 1], gs.svel[:, 2], (gs.spid + 1).to(torch.float32)])
    return stacked, strag


def n600_moved():
    """tests/test_torch_rebin_kernel.py's ``strag_moved``: n 600, L 12,
    CAP 8, 128 straggler rows (~110 used), every particle and straggler
    moved."""
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
    return spec, f


def liquid_moved(seed=1):
    """n 4000, L 24 (8^3 cells, fold 2, NLANE 16), CAP 10 below the largest
    occupancy (stragglers), every particle moved by up to the drift
    threshold per axis and the stragglers by a 0.3-sigma Gaussian."""
    n, L = 4000, 24.0
    rng = np.random.default_rng(seed)
    pos = lattice(n, L, "fcc") + 0.3 * rng.standard_normal((n, 3))
    spec = tl.choose_spec(L, n, 2.5, cap=10, pos=pos, n_strag=64)
    f = tl.grid_state_to_numpy(tl.pack(spec, pos, vel=rng.standard_normal((n, 3)),
                                       device="cpu"))
    m = f["pid"] >= 0
    step = 0.99 * spec.drift_threshold
    for k in ("x", "y", "z"):
        f[k] = (f[k] + rng.uniform(-step, step, f[k].shape) * m).astype(np.float32)
    sv = (f["spid"] >= 0)[:, None]
    f["spos"] = (f["spos"] + 0.3 * rng.standard_normal(f["spos"].shape) * sv).astype(np.float32)
    return spec, f


def half_box_values(L, ulps=8):
    """The float32 values within ``ulps`` spacings of -L/2 and +L/2."""
    out = []
    for edge in (-L / 2, L / 2):
        b = np.array([F32(edge)]).view(np.int32)[0]
        out += list((b + np.arange(-ulps, ulps + 1, dtype=np.int32)).view(np.float32))
    return out


def with_faces(spec, f):
    """``f`` with particles in the first and last cell of each axis moved
    onto the values within 8 ulps of -L/2 and +L/2 (each value onto its
    own particle of each of the two cells), and the first valid straggler
    rows onto them too."""
    f = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in f.items()}
    nz, nyb, cap, nlane = spec.array_shape
    F = spec.fold
    lane = np.arange(nlane)
    shape = (nz, nyb, cap, nlane)
    cells = (np.broadcast_to((lane // F)[None, None, None, :], shape),
             np.broadcast_to((np.arange(nyb)[:, None] * F + lane % F)[None, :, None, :], shape),
             np.broadcast_to(np.arange(nz)[:, None, None, None], shape))
    used = np.zeros(shape, bool)
    srows = list(np.flatnonzero(f["spid"] >= 0))
    for a, key in enumerate(("x", "y", "z")):
        vals = half_box_values(spec.box_size[a])
        for s in (0, spec.shape[a] - 1):
            free = np.argwhere((f["pid"] >= 0) & (cells[a] == s) & ~used)
            for v, i in zip(vals, free[:: max(1, len(free) // len(vals))]):
                i = tuple(int(t) for t in i)
                used[i] = True
                f[key][i] = v
        for v in vals[:: len(vals) // 4]:
            f["spos"][srows.pop(), a] = v
    return f


def crammed(which, ocap=OCAP):
    """A state at the n 600 spec (4^3 cells, CAP 8) that overflows CAP +
    ``ocap`` in only one pass: "z" (three full columns of cell (1, 1, 1)
    moved into its z cell, the outer two out of its y cell), "y" (the two
    full y neighbours moved into its y cell, out of its x cell) or "x" (the
    two full x neighbours moved into it). Every other cell holds one
    particle near its centre; three straggler rows sit in other cells.
    Returns (spec, stacked, strag)."""
    spec = n600_moved()[0]
    nz, nyb, cap, nlane = spec.array_shape
    n = spec.shape
    h = [L / c for L, c in zip(spec.box_size, n)]
    rng = np.random.default_rng(5)
    stacked = np.zeros((7,) + spec.array_shape, np.float32)
    stacked[:3] = EMPTY_POS
    pid = 0

    def put(c, rows, move=(0, 0, 0)):
        nonlocal pid
        yb, lane = c[1] // spec.fold, c[0] * spec.fold + c[1] % spec.fold
        for r in range(rows):
            for a in range(3):
                centre = -spec.box_size[a] / 2 + (c[a] + 0.5) * h[a]
                stacked[a, c[2], yb, r, lane] = centre + move[a] * h[a] + rng.uniform(-0.2, 0.2)
            stacked[3:6, c[2], yb, r, lane] = rng.standard_normal(3)
            pid += 1
            stacked[6, c[2], yb, r, lane] = pid

    full = {"z": {(1, 1, 0): (0, -1, 1), (1, 1, 1): (0, 0, 0), (1, 1, 2): (0, 1, -1)},
            "y": {(1, 0, 1): (-1, 1, 0), (1, 2, 1): (1, -1, 0)},
            "x": {(0, 1, 1): (1, 0, 0), (2, 1, 1): (-1, 0, 0)}}[which]
    for cz in range(n[2]):
        for cy in range(n[1]):
            for cx in range(n[0]):
                c = (cx, cy, cz)
                if c in full:
                    put(c, cap, full[c])
                else:
                    put(c, 1)
    S = spec.n_strag
    strag = np.zeros((7, S), np.float32)
    strag[:3] = EMPTY_POS
    for s, c in enumerate(((3, 3, 3), (0, 2, 3), (3, 0, 0))):
        for a in range(3):
            strag[a, s] = -spec.box_size[a] / 2 + (c[a] + 0.5) * h[a]
        strag[3:6, s] = rng.standard_normal(3)
        pid += 1
        strag[6, s] = pid
    return spec, torch.from_numpy(stacked), torch.from_numpy(strag)


CLEAN = ("n600 moved", "n4000 moved", "n4000 face values", "n4000 moved, seed 2")


@pytest.fixture(scope="module")
def plain_results():
    """The clean states (displaced stragglers; the face values) with the
    plain version's result on each."""
    spec, f = n600_moved()
    spec2, f2 = liquid_moved()
    states = dict(zip(CLEAN, ((spec, f), (spec2, f2), (spec2, with_faces(spec2, f2)),
                              liquid_moved(2))))
    out = {}
    for name, (spec, f) in states.items():
        stacked, strag = stacks_of(tl.grid_state_from_numpy(spec, f, device="cpu"))
        out[name] = (spec, stacked, strag, rk.separable_rebin_plain(spec, stacked, strag))
    return out


# -------------------------------------------------------------------- tests
@pytest.mark.parametrize("name", CLEAN)
def test_replica_equals_plain_on_clean_states(plain_results, name):
    spec, stacked, strag, (out_p, mini_p, count_p, over_p) = plain_results[name]
    n = int((stacked[6] > 0.5).sum()) + int((strag[6] > 0.5).sum())
    assert int(count_p) == n and int(over_p) == 0  # clean: every particle kept
    assert int((strag[6] > 0.5).sum()) > 0
    out, mini, count, over, _ = pull_replica(spec, stacked, strag)
    assert torch.equal(out, out_p)
    assert torch.equal(mini, mini_p)
    assert (int(count), int(over)) == (int(count_p), int(over_p))
    if name == "n600 moved":
        assert bool((mini_p[6] > 0.5).any())  # the mini-grid holds stragglers
    if name == "n4000 face values":
        assert all(bool((stacked[a] == F32(spec.box_size[a] / 2)).any()) for a in range(3))


@pytest.mark.parametrize("order", [1, 2], ids=["dz_dy_dx_order", "stragglers_last"])
def test_order_controls_differ_from_plain(plain_results, order):
    differs = []
    for name, (spec, stacked, strag, (out_p, mini_p, _, _)) in plain_results.items():
        out, mini = pull_replica(spec, stacked, strag, order=order)[:2]
        differs.append(not (torch.equal(out, out_p) and torch.equal(mini, mini_p)))
    assert differs[0]  # the n 600 state alone shows it
    assert sum(differs) >= 2


@pytest.mark.parametrize("which", ["z", "y", "x"])
def test_overflow_in_one_pass_sets_the_flag(which):
    spec, stacked, strag = crammed(which)
    wide = spec.cap + OCAP
    _, _, _, over, (z_max, y_max, x_max) = pull_replica(spec, stacked, strag)
    # the state overflows in the named pass only
    assert [z_max > wide, y_max > wide, x_max > wide] == [w == which for w in "zyx"]
    out_p, mini_p, count_p, over_p = rk.separable_rebin_plain(spec, stacked, strag)
    assert int(over_p) > 0 and int(over) > 0
    # the passes one at a time: the first to overflow is the named one
    pad = torch.zeros(stacked.shape[:3] + (OCAP, stacked.shape[4]))
    pad[:3] = EMPTY_POS
    wz, _, o_z = rk._sep_pass(spec, torch.cat([stacked, pad], dim=3), 2, wide, strag)
    wy, _, o_y = rk._sep_pass(spec, wz, 1, wide)
    _, _, o_x = rk._sep_pass(spec, wy, 0, wide)
    first = next(w for w, o in zip("zyx", (o_z, o_y, o_x)) if int(o) > 0)
    assert first == which


def test_overflow_flag_off_one_below_the_limit():
    """The y state with one of its crammed particles dropped fits (16 =
    CAP + OCAP), and both agree bit for bit there."""
    spec, stacked, strag = crammed("y")
    stacked = stacked.clone()
    stacked[:3, 1, 0, 0, 1] = EMPTY_POS  # the first particle of cell (1, 0, 1)
    stacked[3:, 1, 0, 0, 1] = 0.0
    out_p, mini_p, count_p, over_p = rk.separable_rebin_plain(spec, stacked, strag)
    out, mini, count, over, maxima = pull_replica(spec, stacked, strag)
    assert int(over_p) == 0 and maxima[1] == spec.cap + OCAP
    assert torch.equal(out, out_p) and torch.equal(mini, mini_p)
    assert (int(count), int(over)) == (int(count_p), 0)


# the paths' box lengths: n 600 and the CPU states (12, 24), the DD clump
# (48), LJ v1/v2/unfused/DD2 (128), the face-value tests' (64, 81.27, 100),
# the PSE near grid and BDHI-FCM suspensions (222.27, bench.py's 131072
# colloids at volume fraction 0.05)
PATH_LS = (12.0, 24.0, 48.0, 64.0, 81.27, 100.0, 128.0,
           (131072 * (4.0 / 3.0) * math.pi / 0.05) ** (1.0 / 3.0))


@pytest.mark.parametrize("L", PATH_LS)
def test_wrap_is_idempotent_within_a_box_length(L):
    """wrap(wrap(p)) == wrap(p), and so the same cell, for every float32 p
    within 2^12 spacings of -L/2 and +L/2. Elsewhere on |p| <= L, rint(p /
    L) is the nearest integer and |wrap(p)| stays more than 2^12 spacings
    inside L/2, where p (1/L) rounds below 1/2 and wrap returns its input:
    the wrap is idempotent on all of |p| <= L. A straggler's coordinates
    are stored wrapped and move less than the drift threshold before the
    next rebin, so the kernel's cell from the coordinates wrapped once is
    the passes' cell from the x and y wrapped twice. (Near +-1.5 L it need
    not be: at L = 222.27, p = 333.405 wraps to -111.13501 in cell n - 1
    and then to 111.134995 in cell 0.)"""
    Lf = F32(L)
    iL = F32(1.0) / Lf
    for edge in (-L / 2, L / 2):
        b = np.array([F32(edge)]).view(np.int32)[0]
        p = (b + np.arange(-4096, 4097, dtype=np.int32)).view(np.float32)
        w = (p - Lf * np.rint(p * iL)) + F32(0.0)
        w2 = (w - Lf * np.rint(w * iL)) + F32(0.0)
        assert np.array_equal(w.view(np.int32), w2.view(np.int32)), (L, edge)
        assert np.abs(w * iL).max() <= F32(0.5)


def test_the_double_wrap_moves_a_cell_far_outside_the_box():
    """The control of the range above: beyond it the two wraps can put a
    coordinate in different cells."""
    L = 222.27
    p = torch.tensor([333.405], dtype=torch.float32)
    w = rk._wrap_pos(p, L)
    assert float(rk._dest_cell(w, L, 3)) == 2.0
    assert float(rk._dest_cell(rk._wrap_pos(w, L), L, 3)) == 0.0


@pytest.mark.parametrize("name", CLEAN)
def test_rebin2_replica_equals_plain_on_clean_states(plain_results, name):
    spec, stacked, strag, _ = plain_results[name]
    want = rk.rebin2_plain(spec, stacked, strag)
    n = int((stacked[6] > 0.5).sum()) + int((strag[6] > 0.5).sum())
    assert (int(want[2]), int(want[3])) == (n, 0)
    got = rebin2_replica(spec, stacked, strag)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (int(got[2]), int(got[3])) == (int(want[2]), int(want[3]))
    if name == "n600 moved":
        assert bool((want[1][6] > 0.5).any())  # the mini-grid holds stragglers


@pytest.mark.parametrize("which", ["z", "y", "x"])
def test_rebin2_replica_equals_plain_on_crammed_states(which):
    """#4 has no intermediate pass: it overflows on the state crammed into
    one cell ("x") alone, and there too the out rows, the mini rows and
    both counts equal the plain version's."""
    spec, stacked, strag = crammed(which)
    want = rk.rebin2_plain(spec, stacked, strag)
    got = rebin2_replica(spec, stacked, strag)
    assert (int(want[3]) > 0) == (which == "x")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (int(got[2]), int(got[3])) == (int(want[2]), int(want[3]))


def test_rebin2_replica_in_the_passes_order_differs(plain_results):
    """The control: #5's source order ranks a cell's particles otherwise."""
    spec, stacked, strag, _ = plain_results["n600 moved"]
    want = rk.rebin2_plain(spec, stacked, strag)
    got = rebin2_replica(spec, stacked, strag, order=0)
    assert not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
