"""The tile decomposition of the port's pencil kernels #13/#14
(``uammd_tpu_torch/engine/csrc/pencil_*.cu``), held on the CPU:

- ``pencil_launch_plan``: the tiles partition the grid (every node in
  exactly one tile) and each block's shared memory fits in 48 KB (the
  kernels take no opt-in above it);
- ``pencil_neighbours_table`` equals a brute-force search of the pencils
  whose patch covers a node of each pencil, at 16^2, 24 x 16, 32^2 and
  384^2 and every halo the pencil path takes;
- a float64 torch transcription of the kernels' tile sums (the package's
  table, the patch mask, the z-window cull and the weights as the kernels
  form them) reproduces ``spread_pencil_fused_plain`` and
  ``interpolate_pencil_fused_plain`` within 1e-12 for the four windows,
  slack 0 and 1 with drifted positions, nz = support and a grid two
  pencils wide, and once JAX's XLA ``spread_pencil`` (under ``jax.jit``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uammd_tpu.core.box import box as jbox
from uammd_tpu.solvers import ibm as ji
from uammd_tpu.solvers import pencil_ibm as jp
from uammd_tpu_torch.core.box import box as tbox
from uammd_tpu_torch.integrators.bdhi.fcm import _NormalizedBM
from uammd_tpu_torch.solvers import ibm as ti
from uammd_tpu_torch.solvers import pencil_ibm as tp

torch.exp(torch.zeros(1 << 20))  # see tests/test_torch_ibm.py

WINDOWS = {"gaussian": ti.GaussianKernel(sigma=1.1, support=8), "peskin3": ti.Peskin3pt(),
           "peskin4": ti.Peskin4pt(), "bm": _NormalizedBM(beta=1.3267 * 6, support=6)}


def _tiles_cover(shape, plan):
    """How many tiles of ``plan`` hold each node of ``shape``."""
    nx, ny, nz = shape
    npy = ny // 8
    count = np.zeros(shape, np.int32)
    for p in range(plan.grid[1]):
        px, py = divmod(p, npy)
        for zt in range(plan.grid[0]):
            z0 = zt * plan.tz
            count[px * 8:px * 8 + 8, py * 8:py * 8 + 8, z0:min(nz, z0 + plan.tz)] += 1
    return count


@pytest.mark.parametrize("shape,support,slack,cap", [
    ((16, 16, 32), 8, 0, 40), ((24, 16, 20), 6, 1, 24), ((32, 32, 8), 8, 0, 64),
    ((96, 96, 96), 12, 0, 1112), ((144, 144, 144), 8, 1, 560), ((384, 384, 384), 14, 1, 120)])
def test_plan_tiles_partition_the_grid(shape, support, slack, cap):
    shapes_small = shape[0] * shape[1] * shape[2] <= 96 ** 3
    for C in range(1, 9):
        for interp in (False, True):
            plan = tp.pencil_launch_plan(shape, support, slack, C, cap, interp=interp)
            assert plan.chunk == tp.chunk_of(plan.tz) == (64 if plan.tz == 32 else 32)
            assert plan.smem == tp.pencil_smem_bytes(C, plan.tz, plan.chunk, interp)
            assert plan.smem <= tp.MAX_SMEM == 48 * 1024 and plan.threads == 8 * plan.tz
            assert plan.grid == (-(-shape[2] // plan.tz), (shape[0] // 8) * (shape[1] // 8))
            assert (plan.grid[0] - 1) * plan.tz < shape[2] <= plan.grid[0] * plan.tz
            if shapes_small:
                assert (_tiles_cover(shape, plan) == 1).all()
    # the paths' plans: FCM (C 3) 32-node tiles, Poisson and PSE 16
    want_tz = {96: 16, 144: 16, 384: 32}.get(shape[0])
    if want_tz:
        for interp in (False, True):
            assert tp.pencil_launch_plan(shape, support, slack, 3, cap, interp=interp).tz == want_tz
    if want_tz == 32:  # a 32-node interpolation block at C 6 .. 8 passes 48 KB: 16-node tiles
        for C in (6, 7, 8):
            assert tp.pencil_smem_bytes(C, 32, tp.chunk_of(32), True) > tp.MAX_SMEM
            assert tp.pencil_launch_plan(shape, support, slack, C, cap, interp=True).tz == 16
    with pytest.raises(ValueError):
        tp.pencil_launch_plan(shape, support, slack, 9, cap)


def _covers(n_pen, n, halo):
    """[p, q]: pencil q's patch (8 + 2 halo nodes from q * 8 - halo, wrapped)
    holds a node of pencil p, along one axis."""
    P = 8 + 2 * halo
    out = np.zeros((n_pen, n_pen), bool)
    for q in range(n_pen):
        nodes = (q * 8 - halo + np.arange(P)) % n
        out[np.unique(nodes // 8), q] = True
    return out


@pytest.mark.parametrize("xy", [(16, 16), (24, 16), (32, 32), (384, 384)])
def test_neighbour_table_is_brute_force(xy):
    npx, npy = xy[0] // 8, xy[1] // 8
    table = tp.pencil_neighbours_table(npx, npy)
    assert table.shape == (npx * npy, 9) and table.dtype == np.int32
    halos = [h for h in range(1, 9) if min(xy) >= 8 + 2 * h]
    assert halos
    for h in halos:
        cx, cy = _covers(npx, xy[0], h), _covers(npy, xy[1], h)
        cover = (cx[:, None, :, None] & cy[None, :, None, :]).reshape(npx * npy, npx * npy)
        for p in range(npx * npy):
            want = np.flatnonzero(cover[p])
            got = table[p][table[p] >= 0]
            np.testing.assert_array_equal(got, want)  # each pencil once, ascending
            assert (table[p][len(got):] == -1).all()
    if npx == 2:  # p - 1 and p + 1 are one pencil: listed once
        assert (table >= 0).sum(1).max() == (4 if npy == 2 else 6)
    t = tp.pencil_neighbours(xy, torch.device("cpu"))
    assert t is tp.pencil_neighbours(xy, torch.device("cpu"))  # made once
    np.testing.assert_array_equal(t.numpy(), table)


def tile_transcription(kern, pos, vals, field, shape, box, bins, slack, plan):
    """The kernels' tile sums in torch: for each tile (pencil p, z tile),
    the candidates of the pencils in p's row of the neighbour table whose z
    window (z0 .. z0 + support) meets the tile, their weights as the
    kernels form them, and the dense tile products. Returns the spread of
    ``vals`` (with 1/dV) and the slot values of the interpolation of
    ``field`` ([npen * cap, C], 0 in empty slots)."""
    nx, ny, nz = shape
    npy, npen = ny // 8, (nx // 8) * (ny // 8)
    halo = (kern.support + 1) // 2 + slack
    P, half, tz = 8 + 2 * halo, kern.support / 2.0, plan.tz
    dt = pos.dtype
    u = tp._node_coords(pos, shape, box)
    cap = bins.pids.shape[1]
    nbr = tp.pencil_neighbours(tuple(shape[:2]), pos.device).long()        # [npen, 9]
    k = torch.arange(9 * cap)
    q = nbr[:, k // cap]                                                  # [npen, K]
    flat = q.clamp(min=0) * cap + k % cap
    pid = bins.pids.reshape(-1)[flat].long()
    ok = (q >= 0) & (pid > 0)
    uc = u[(pid - 1).clamp(min=0)]                                        # [npen, K, 3]
    pen = torch.arange(npen)
    px, py = pen // npy, pen % npy
    j8 = torch.arange(8)

    def axis_w(ax, own, n):
        o = ((q // npy if ax == 0 else q % npy) * 8 - halo)[..., None]     # [npen, K, 1]
        j = torch.remainder((own * 8)[:, None, None] + j8 - o, n)
        d = (o + j).to(dt) - uc[..., ax:ax + 1]
        d = d - n * torch.round(d / n)
        return torch.where(j < P, kern.phi(d), 0.0)                        # [npen, K, 8]

    wx, wy = axis_w(0, px, nx), axis_w(1, py, ny)
    z0 = (torch.floor(uc[..., 2] - half) + 1).long()                      # [npen, K]
    scale = float(np.prod([n / L for n, L in zip(shape, box.lengths)]))
    C = vals.shape[1]
    spread = torch.zeros((C,) + tuple(shape), dtype=dt)
    slots = torch.zeros((npen * cap, C), dtype=dt)
    fcf = field.permute(3, 0, 1, 2)
    for zt in range(plan.grid[0]):
        zlo = zt * tz
        tzn = min(tz, nz - zlo)
        d = torch.remainder(zlo - z0, nz)
        keep = ok & ((d <= kern.support) | (d + tzn > nz))
        kz = torch.remainder(zlo + torch.arange(tzn) - z0[..., None], nz)  # [npen, K, tzn]
        wz = torch.where(kz <= kern.support,
                         kern.phi((z0[..., None] + kz).to(dt) - uc[..., 2:3]), 0.0)
        wz = wz * keep[..., None]
        v = vals[(pid - 1).clamp(min=0)] * scale * keep[..., None]
        tile = torch.einsum("pka,pkb,pkz,pkc->pcabz", wx, wy, wz, v)
        for p in range(npen):
            xs, ys = slice(px[p] * 8, px[p] * 8 + 8), slice(py[p] * 8, py[p] * 8 + 8)
            spread[:, xs, ys, zlo:zlo + tzn] = tile[p]
        ftile = torch.stack([fcf[:, px[p] * 8:px[p] * 8 + 8, py[p] * 8:py[p] * 8 + 8,
                                 zlo:zlo + tzn] for p in range(npen)])     # [npen, C, 8, 8, tzn]
        got = torch.einsum("pka,pkb,pkz,pcabz->pkc", wx, wy, wz, ftile)
        slots.index_add_(0, flat[keep], got[keep])
    return spread.permute(1, 2, 3, 0), slots


def _system(shape, n, slack, seed):
    """n uniform particles in a box of 0.61 per node, binned, then drifted
    by up to 0.99 h in x and y (3 h in z) when slack is 1."""
    rng = np.random.default_rng(seed)
    Ls = [m * 0.61 for m in shape]
    b = tbox(Ls, dtype=torch.float64, device="cpu")
    pos = torch.as_tensor((rng.random((n, 3)) - 0.5) * np.asarray(Ls))
    vals = torch.as_tensor(rng.normal(size=(n, 3)))
    field = torch.as_tensor(rng.normal(size=tuple(shape) + (3,)))
    bins = tp.bin_pencils(pos, shape, b)
    h = 0.61
    pos = pos + slack * torch.as_tensor(rng.uniform(-0.99, 0.99, (n, 3)) * [h, h, 3 * h])
    return pos, vals, field, b, bins


@pytest.mark.parametrize("shape,window,slack", [
    ((32, 24, 20), "gaussian", 0), ((32, 24, 20), "gaussian", 1),
    ((24, 24, 17), "peskin3", 0), ((24, 24, 17), "peskin3", 1),
    ((24, 32, 36), "peskin4", 0), ((24, 32, 36), "peskin4", 1),
    ((32, 32, 40), "bm", 0), ((32, 32, 40), "bm", 1),
    ((16, 16, 32), "gaussian", 0), ((16, 16, 32), "bm", 1),  # 2 x 2 pencils
    ((32, 16, 8), "gaussian", 0), ((24, 24, 3), "peskin3", 1),  # nz = support
])
def test_tile_sums_match_plain(shape, window, slack):
    kern = WINDOWS[window]
    assert tp.pencil_ok(shape, kern.support, slack)
    pos, vals, field, b, bins = _system(shape, 700, slack, seed=sum(shape) + slack)
    plan = tp.pencil_launch_plan(shape, kern.support, slack, 3, bins.pids.shape[1])
    f_t, slots = tile_transcription(kern, pos, vals, field, shape, b, bins, slack, plan)
    f_p, _ = tp.spread_pencil_fused_plain(kern, pos, vals, shape, b, bins, slack=slack)
    np.testing.assert_allclose(f_t.numpy(), f_p.numpy(), atol=1e-12 * float(f_p.abs().max()),
                               rtol=0)
    v_p, _ = tp.interpolate_pencil_fused_plain(kern, pos, field, b, bins, slack=slack)
    v_t = slots[bins.slot_of_pid.long()]
    np.testing.assert_allclose(v_t.numpy(), v_p.numpy(), atol=1e-12 * float(v_p.abs().max()),
                               rtol=0)
    # the chunked kernel sees the same candidates: every particle meets a tile
    assert float(f_p.abs().max()) > 0 and float(v_p.abs().max()) > 0


def test_tile_sums_match_jax_xla_spread():
    shape, L, n = (24, 16, 20), [14.64, 9.76, 12.2], 500
    rng = np.random.default_rng(3)
    pos = (rng.random((n, 3)) - 0.5) * np.asarray(L)
    vals = rng.normal(size=(n, 2))
    jb = jax.jit(jp.bin_pencils, static_argnums=1)(jnp.asarray(pos), shape,
                                                   jbox(L, dtype=jnp.float64))
    jk = ji.GaussianKernel(sigma=1.2, support=6)
    f_j, _ = jax.jit(lambda p, v: jp.spread_pencil(jk, p, v, shape, jbox(L, dtype=jnp.float64),
                                                   jb, slack=1))(jnp.asarray(pos),
                                                                 jnp.asarray(vals))
    kern = ti.GaussianKernel(sigma=1.2, support=6)
    bins = tp.pencil_bins_from_numpy({"pids": jb.pids, "slot_of_pid": jb.slot_of_pid,
                                      "overflow": jb.overflow}, device="cpu")
    b = tbox(L, dtype=torch.float64, device="cpu")
    plan = tp.pencil_launch_plan(shape, 6, 1, 2, bins.pids.shape[1])
    f_t, _ = tile_transcription(kern, torch.as_tensor(pos), torch.as_tensor(vals),
                                torch.zeros(shape + (2,), dtype=torch.float64), shape, b, bins,
                                1, plan)
    f_j = np.asarray(f_j)
    np.testing.assert_allclose(f_t.numpy(), f_j, atol=1e-12 * np.abs(f_j).max(), rtol=0)
