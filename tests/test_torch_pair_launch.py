"""Launch plans of the cell-warp kernels #1 (``csrc/pair_force.cu``) and #6
(``csrc/newton_pair.cu``), of the channel kernels #2
(``csrc/pair_channel.cu``) and #10 (``csrc/newton_channel.cu``) and of the
rebin #3 (``csrc/rebin.cu``), on the CPU: no JAX, no card.

For every spec the port launches them on (the LJ paths, the PSE near grid,
the domain-decomposed shards, the small straggler and clump systems; for
#2 the DPD, SPH, mixture, hierarchy, Poisson and PSE grids and the DD
slabs, with each functor's channels) the plan fits sm_90's shared memory
and thread limits, covers every cell once, and gives at least 2 x 132
blocks wherever the grid has that many cells. A spec that cannot fit
raises ``ValueError`` before anything is launched.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from uammd_tpu_torch.electrostatics.poisson import PoissonNear
from uammd_tpu_torch.engine import _build, kernel2, layout, md, pair_kernel
from uammd_tpu_torch.engine.dpd import DPDPair
from uammd_tpu_torch.engine.layout import GridSpec
from uammd_tpu_torch.engine.mixtures import LJMixturePair, LJMixturePairMasked
from uammd_tpu_torch.engine.pse_near import PSENear
from uammd_tpu_torch.engine.sph import SPHDensityPair, SPHForcePair
from uammd_tpu_torch.interactors.sph import SPHParams


def _spec(shape, cap, fold, n_strag=0, box=128.0):
    return GridSpec(box_size=(box,) * 3, shape=shape, cap=cap, fold=fold, cutoff=2.5,
                    skin=1.2, n_strag=n_strag)


# (name, spec) as [nz, nyb, CAP, NLANE] comments; shapes are (nx, ny, nz)
SPECS = {
    "lj_v1": _spec((32, 40, 42), 40, 4),  # [42, 10, 40, 128]
    "lj_v2": _spec((32, 40, 42), 32, 4, 16),  # [42, 10, 32, 128]
    "pse_near": _spec((19, 18, 19), 32, 6, 192, box=222.27),  # [19, 3, 32, 114]
    "dd2_shard": _spec((32, 40, 10), 32, 4, 16),  # [10, 10, 32, 128]
    "dd_v1_slab": _spec((32, 40, 12), 40, 4),  # [12, 10, 40, 128]
    "clump_shard": _spec((16, 15, 4), 16, 5, 24, box=48.0),  # [4, 3, 16, 80]
    "cap8_nlane16": _spec((4, 8, 4), 8, 4, 128, box=12.0),  # [4, 2, 8, 16]
    "cap8_nlane48": _spec((12, 8, 6), 8, 4, 64, box=30.0),  # [6, 2, 8, 48]
}
PLANS = {"pair_force": pair_kernel.pair_launch_plan,
         "newton_pair": kernel2.newton_launch_plan}


def _smem(kind, spec, cc, fc):
    w = (cc + 2) * (fc + 2)
    if kind == "pair_force":  # float4 pos[3][cap][W | 1], float4 shift[3][W], int x 3 [3][W]
        return 3 * (16 * spec.cap * (w | 1) + (16 + 12) * w)
    # float4 pos[2][cap][W | 1], float react[3][2][cap][W | 1], float4
    # shift[2][W], int x 2 [2][W], float strag[4][S], int reach[S], int box[8]
    return 2 * (28 * spec.cap * (w | 1) + (16 + 8) * w) + 20 * spec.n_strag + 32


@pytest.mark.parametrize("kind", sorted(PLANS))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_plan_fits_and_fills_the_card(kind, name):
    spec = SPECS[name]
    plan = PLANS[kind](spec)
    nx, _, nz = spec.shape
    assert 1 <= plan.cc <= nx and 1 <= plan.fc <= spec.fold
    assert plan.threads == 32 * plan.cc * plan.fc <= 1024
    assert plan.smem == _smem(kind, spec, plan.cc, plan.fc) <= 232448
    # every cell in exactly one block: ceil-divided chunks of x and the fold
    assert plan.grid == (-(-nx // plan.cc) * -(-spec.fold // plan.fc), spec.nyb, nz)
    assert plan.blocks >= min(264, spec.n_cells)
    if spec.n_cells >= 264:
        assert plan.blocks >= 264


def test_main_path_plans():
    """The 2^20 LJ specs take 4 x 4 cells a block (16 warps, 3360 blocks);
    the PSE near grid's 57 (z, yb) columns are cut into 8 blocks each."""
    for kind in PLANS:
        for name in ("lj_v1", "lj_v2"):
            plan = PLANS[kind](SPECS[name])
            assert (plan.cc, plan.fc, plan.blocks, plan.threads) == (4, 4, 3360, 512)
    # the path's own kernel at each spec: three blocks fit on an SM
    for plan in (pair_kernel.pair_launch_plan(SPECS["lj_v1"]),
                 kernel2.newton_launch_plan(SPECS["lj_v2"])):
        assert 3 * (plan.smem + 1024) <= 233472
    plan = kernel2.newton_launch_plan(SPECS["pse_near"])
    assert plan.blocks >= 264 and plan.grid[1:] == (3, 19)


def test_plan_matches_choose_spec_at_the_lj_spec():
    """The LJ path's spec as choose_spec builds it has the shape planned above."""
    spec = layout.choose_spec(128.0, 1 << 20, 2.5, cap=40)
    assert spec.array_shape == (42, 10, 40, 128)
    assert pair_kernel.pair_launch_plan(spec).blocks == 3360


def test_small_grid_takes_a_block_per_cell():
    spec = _spec((4, 4, 4), 8, 1, 128, box=12.0)  # the n 600 straggler system's grid
    for plan_of in PLANS.values():
        plan = plan_of(spec)
        assert (plan.cc, plan.fc, plan.blocks, plan.threads) == (1, 1, 64, 32)


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_unfittable_spec_raises(kind):
    too_deep = _spec((8, 8, 8), 2000, 2, 16)  # 2000 slots a cell: > 227 KB even for one cell
    with pytest.raises(ValueError, match="shared memory"):
        PLANS[kind](too_deep)


def test_too_many_stragglers_raise():
    spec = _spec((8, 8, 8), 8, 2, 20000)  # 20 bytes a straggler row
    with pytest.raises(ValueError):
        kernel2.newton_launch_plan(spec)
    pair_kernel.pair_launch_plan(spec)  # #1 takes no stragglers


@pytest.fixture
def no_device_checks(monkeypatch):
    """Reach the wrappers' CUDA path with meta tensors (no card here):
    the device check is skipped and every launch is recorded."""
    launched = []
    monkeypatch.setattr(_build, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build.Kernel, "__call__",
                        lambda self, *a: launched.append(self.symbol))
    return launched


def test_wrappers_raise_before_any_launch(no_device_checks):
    spec = _spec((8, 8, 8), 2000, 2, 16)
    meta = [torch.empty(spec.array_shape, device="meta") for _ in range(3)]
    with pytest.raises(ValueError):
        pair_kernel.make_pair_force_kernel(spec, md.lj_g())(*meta)
    with pytest.raises(ValueError):
        pair_kernel.make_pair_force_kernel(spec, md.lj_g(), periodic_z=False)(*meta)
    with pytest.raises(ValueError):
        pair_kernel.make_pair_force_kernel(spec, md.lj_g(), md.lj_e(),
                                           compute_virial=True)(*meta)
    strag = torch.empty((4, spec.n_strag, spec.nlane), device="meta")
    for halo in (False, True):
        kern = kernel2.make_newton_pair_kernel(spec, md.lj_g_fused(rc2=6.25), halo_z=halo)
        ghost = [torch.empty((1,) + spec.array_shape[1:], device="meta")] * 3 if halo else []
        with pytest.raises(ValueError):
            kern(*meta, *ghost, strag)
    assert no_device_checks == []


def test_wrappers_pass_the_plan(no_device_checks, monkeypatch):
    """On a spec that fits, the launch gets the plan's block shape and
    occ_trim 0 as its last three arguments."""
    args = []
    monkeypatch.setattr(_build.Kernel, "__call__", lambda self, *a: args.append(a))
    monkeypatch.setattr(_build, "ptr", lambda t: 0)
    spec = SPECS["lj_v2"]
    meta = [torch.empty(spec.array_shape, device="meta") for _ in range(3)]
    kern = pair_kernel.make_pair_force_kernel(spec, md.lj_g())
    kern(*meta)
    assert args[-1][-3:] == (4, 4, 0)
    newton = kernel2.make_newton_pair_kernel(spec, md.lj_g_fused(rc2=6.25), self_half=True)
    newton.occ_trim = 1  # the control
    strag = torch.zeros((4, spec.n_strag, spec.nlane), device="meta")
    newton(*meta, strag)
    assert args[-1][-3:] == (4, 4, 1)
    assert kernel2.NewtonPairKernel.occ_trim == 0
    assert np.prod(kern.plan.grid) == kern.plan.blocks


# #2: (spec as [nz, nyb, CAP, NLANE], functor, nvec); shapes are (nx, ny, nz)
_POISSON = PoissonNear(17.5, 0.3, [[1.0, 0.5]] * 2, [[0.2, 0.1]] * 2, ((1.0, 0.0), (1.0, 0.0)))
_PSE = PSENear(coef=([1.0, 0.5],) * 4, uscale=((1.0, 0.0), (1.0, 0.0)), qb=0.3, rcut=4.0)
CHANNEL_CASES = {
    "dpd": (_spec((64, 64, 64), 16, 2, box=70.4), DPDPair(1.0, 25.0, 4.5, 30.0), 1),
    "sph_density": (_spec((32, 36, 36), 48, 4, box=81.3), SPHDensityPair(1.0), 1),
    "sph_force": (_spec((32, 36, 36), 48, 4, box=81.3), SPHForcePair(SPHParams()), 1),
    "lj_mix": (_spec((32, 36, 37), 48, 4, box=151.8), LJMixturePair(2.5), 1),
    "hierarchy": (_spec((7, 6, 7), 24, 2, box=72.0), LJMixturePairMasked(2.5), 1),
    "poisson": (_spec((10, 9, 10), 216, 3, box=192.0), _POISSON, 1),
    "poisson_strag64": (_spec((10, 9, 10), 216, 3, 64, box=192.0), _POISSON, 1),
    "pse_nvec1": (SPECS["pse_near"], _PSE, 1),
    "pse_nvec2": (SPECS["pse_near"], _PSE, 2),
    "dd_dpd_slab": (_spec((64, 64, 18), 16, 2, box=70.4), DPDPair(1.0, 25.0, 4.5, 30.0), 1),
    "dd_sph_slab": (_spec((32, 36, 11), 48, 4, box=81.3), SPHForcePair(SPHParams()), 1),
}
CHANNEL_SHAPES = {
    "dpd": (64, 32, 16, 128), "sph_density": (36, 9, 48, 128), "sph_force": (36, 9, 48, 128),
    "lj_mix": (37, 9, 48, 128), "hierarchy": (7, 3, 24, 14), "poisson": (10, 3, 216, 30),
    "poisson_strag64": (10, 3, 216, 30), "pse_nvec1": (19, 3, 32, 114),
    "pse_nvec2": (19, 3, 32, 114), "dd_dpd_slab": (18, 32, 16, 128),
    "dd_sph_slab": (11, 9, 48, 128),
}


def _channel_warps(cap, cc, fc):
    """The chunks the block's cells should give at the mean occupancy
    cap^2 // (cap + 48): ~26 lanes a chunk below 27, else ceil(mean / 32)
    chunks a cell; 1 to 16."""
    m = max(1, cap * cap // (cap + 48))
    w = -(-cc * fc * m // 26) if m <= 26 else cc * fc * -(-m // 32)
    return min(16, max(1, w))


def _channel_smem(cap, cc, fc, ng, S):
    """float4 positions, 3 layers x CAP rows of W | 1 columns; a float4
    shift and 3 ints a column; per warp a ring of 128 int2 pairs and 8 box
    floats; a count and CAP list entries a home cell; chunk starts + 1 and
    16 scalars; the straggler rows [ng + 4, S] and their kept list."""
    w = (cc + 2) * (fc + 2)
    cells = cc * fc
    return (3 * cap * (w | 1) * 16 + 3 * w * 28 + 4 * cells * (1 + cap)
            + 4 * (cells * -(-cap // 32) + 1 + 16)
            + (8 * 128 + 32) * _channel_warps(cap, cc, fc) + 4 * (ng + 5) * S)


@pytest.mark.parametrize("name", sorted(CHANNEL_CASES))
def test_channel_plan_fits_and_fills_the_card(name):
    spec, fn, nvec = CHANNEL_CASES[name]
    assert spec.array_shape == CHANNEL_SHAPES[name]
    plan = pair_kernel.channel_launch_plan(spec, fn, nvec)
    nx, _, nz = spec.shape
    ng = 3 * nvec if isinstance(fn, PSENear) else fn.n_chan - fn.n_uniform
    S = spec.n_strag if isinstance(fn, PSENear) or fn.strag else 0
    assert 1 <= plan.cc <= nx and 1 <= plan.fc <= spec.fold and plan.cc * plan.fc <= 64
    assert plan.threads == 32 * _channel_warps(spec.cap, plan.cc, plan.fc) <= 1024
    assert plan.smem == _channel_smem(spec.cap, plan.cc, plan.fc, ng, S) <= 232448
    assert plan.grid == (-(-nx // plan.cc) * -(-spec.fold // plan.fc), spec.nyb, nz)
    assert plan.blocks >= min(264, spec.n_cells)
    if spec.n_cells >= 264:
        assert plan.blocks >= 264


def test_channel_plan_unfittable_spec_raises():
    """A spec whose cells cannot be staged (2000 slots a cell: > 227 KB for
    one cell of any functor) raises before any launch."""
    spec = _spec((8, 8, 8), 2000, 2)
    for fn in (DPDPair(1.0, 25.0, 4.5, 30.0), SPHDensityPair(1.0), _POISSON):
        with pytest.raises(ValueError, match="shared memory"):
            pair_kernel.channel_launch_plan(spec, fn)
    with pytest.raises(ValueError, match="shared memory"):
        pair_kernel.channel_launch_plan(_spec((8, 8, 8), 16, 2, 20000), _PSE, 2)
    # 671M slots: fits #1's indices, but not 4 channels of them
    with pytest.raises(ValueError, match="32-bit"):
        pair_kernel.channel_launch_plan(_spec((256, 256, 256), 40, 4),
                                        DPDPair(1.0, 25.0, 4.5, 30.0))


def test_channel_wrappers_pass_the_plan(no_device_checks, monkeypatch):
    """#2's launches get the plan's block shape and occ_trim as (cc, fc,
    occ_trim); an unfittable spec raises before any launch."""
    args = []
    monkeypatch.setattr(_build.Kernel, "__call__",
                        lambda self, *a: args.append((self.symbol, a)))
    monkeypatch.setattr(_build, "ptr", lambda t: 0)
    for name in ("dpd", "poisson_strag64", "pse_nvec2"):
        spec, fn, nvec = CHANNEL_CASES[name]
        kern = pair_kernel.make_pair_channel_kernel(spec, fn, nvec)
        meta = [torch.empty(spec.array_shape, device="meta") for _ in range(3)]
        ng = pair_kernel.channel_grid_channels(fn, nvec)
        chans = [torch.empty(spec.array_shape, device="meta") for _ in range(ng)]
        chans += [torch.zeros((), device="meta")] * (0 if isinstance(fn, PSENear) else
                                                     fn.n_uniform)
        strag = None
        if spec.n_strag:
            strag = torch.zeros((3 + ng + 1, spec.n_strag, spec.nlane), device="meta")
        kern.occ_trim = 1 if name == "dpd" else 0
        kern(*meta, *chans, strag=strag)
        plan = kern.plan
        sym, a = args[-1]
        lead = a[:-7] if spec.n_strag or isinstance(fn, PSENear) else a[:-4]
        assert lead[-3:] == (plan.cc, plan.fc, kern.occ_trim), (name, sym)
    assert pair_kernel.PairChannelKernel.occ_trim == 0
    spec = _spec((8, 8, 8), 2000, 2)
    meta = [torch.empty(spec.array_shape, device="meta") for _ in range(7)]
    n = len(args)
    with pytest.raises(ValueError):
        pair_kernel.make_pair_channel_kernel(spec, DPDPair(1.0, 25.0, 4.5, 30.0))(
            *meta, torch.zeros((), device="meta"))
    assert len(args) == n


# #10: the Newton channel kernel's plan at the PSE near grid and smaller
# straggler-capable grids, 3 and 6 channels
NEWTON_CHANNEL_CASES = ("pse_near", "clump_shard", "cap8_nlane16", "cap8_nlane48")


def _newton_channel_smem(cap, cc, fc, nc, S):
    """float4 positions, 2 layers x CAP rows of W | 1 columns, and a float4
    shift a column; per warp (one a cell, at most 10) a ring of 128 int2
    pairs, 8 box floats and [32][nc] home channels; the
    reverse table [nc][2][CAP][W]; 3 ints a column; a count and CAP list
    entries a home cell; chunk starts + 1 and 16 scalars; the straggler
    rows' kept list."""
    w = (cc + 2) * (fc + 2)
    cells = cc * fc
    return (2 * cap * (w | 1) * 16 + 2 * w * 16
            + (8 * 128 + 32 + 128 * nc) * min(10, cc * fc) + 4 * nc * 2 * cap * w
            + 2 * w * 12 + 4 * cells * (1 + cap) + 4 * (cells * -(-cap // 32) + 1 + 16)
            + 4 * S)


@pytest.mark.parametrize("nvec", [1, 2])
@pytest.mark.parametrize("name", NEWTON_CHANNEL_CASES)
def test_newton_channel_plan_fits_and_fills_the_card(name, nvec):
    spec = SPECS[name]
    plan = kernel2.newton_channel_plan(spec, nvec)
    nx, _, nz = spec.shape
    assert 1 <= plan.cc <= nx and 1 <= plan.fc <= spec.fold and plan.cc * plan.fc <= 64
    assert plan.threads == 32 * min(10, plan.cc * plan.fc) <= 320
    assert plan.smem == _newton_channel_smem(spec.cap, plan.cc, plan.fc, 3 * nvec,
                                             spec.n_strag)
    # two blocks an SM (233472 bytes, 1024 of them reserved a block)
    assert 2 * (plan.smem + 1024) <= 233472
    # staged indices fit the ring's 16 bits
    assert 2 * spec.cap * ((plan.cc + 2) * (plan.fc + 2) | 1) <= 65535
    assert plan.grid == (-(-nx // plan.cc) * -(-spec.fold // plan.fc), spec.nyb, nz)
    assert plan.blocks >= min(264, spec.n_cells)


def test_newton_channel_wrapper_passes_the_plan(no_device_checks, monkeypatch):
    """#10's launch gets the plan's (cc, fc) and occ_trim, then the box and
    the functor; the fold #9 follows it."""
    args = []
    monkeypatch.setattr(_build.Kernel, "__call__",
                        lambda self, *a: args.append((self.symbol, a)))
    monkeypatch.setattr(_build, "ptr", lambda t: 0)
    spec = SPECS["pse_near"]
    for nvec in (1, 2):
        kern = kernel2.make_newton_channel_kernel(spec, _PSE, nvec)
        kern.occ_trim = nvec - 1
        meta = [torch.empty(spec.array_shape, device="meta") for _ in range(3 + 3 * nvec)]
        strag = torch.zeros((4 + 3 * nvec, spec.n_strag, spec.nlane), device="meta")
        kern(*meta, strag=strag)
        plan = kernel2.newton_channel_plan(spec, nvec)
        (sym, a), (fold_sym, _) = args[-2], args[-1]
        assert (sym, fold_sym) == ("uammd_newton_channel", "uammd_fold_n")
        assert a[7] == nvec and a[13] == spec.n_strag
        assert a[14:17] == (plan.cc, plan.fc, nvec - 1)
    assert kernel2.NewtonChannelKernel.occ_trim == 0


REBIN_SPECS = {
    "lj_v1": (SPECS["lj_v1"], 2580480),
    "dpd": (_spec((64, 64, 64), 16, 2, box=70.4), 4194304),
    "sph": (_spec((32, 36, 36), 48, 4, box=81.3), 1990656),
    "cap8_nlane16": (SPECS["cap8_nlane16"], 2048),
}


@pytest.mark.parametrize("name", sorted(REBIN_SPECS))
def test_rebin_plan_and_scratch(name, no_device_checks, monkeypatch):
    """#3's two kernels fit their launch limits; the wrapper hands the
    launch a uint8 code scratch of [nz, nyb, NLANE, CAP rounded up to 16]."""
    from uammd_tpu_torch.engine import rebin_kernel

    spec, code_bytes = REBIN_SPECS[name]
    plan = rebin_kernel.rebin_launch_plan(spec)
    cpad = -(-spec.cap // 16) * 16
    nz, nyb, cap, nlane = spec.array_shape
    assert plan["classify_threads"] == nlane * cpad // 16 <= 1024
    assert plan["pull_threads"] % 32 == 0 and 4 * nlane <= plan["pull_threads"] <= 512
    assert plan["pull_smem_bytes"] == 4 * (cap + 1) * nlane <= 48 * 1024
    assert plan["classify_blocks"] == plan["pull_blocks"] == nz * nyb
    assert plan["code_bytes"] == nz * nyb * nlane * cpad == code_bytes
    args = []
    monkeypatch.setattr(_build.Kernel, "__call__", lambda self, *a: args.append(a))
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    stacked = torch.empty((7,) + spec.array_shape, device="meta")
    rebin_kernel.make_rebin_kernel(spec)(stacked)
    codes = args[-1][1]
    assert codes.dtype == torch.uint8 and codes.numel() == code_bytes
    assert args[-1][4:10] == (7, spec.shape[0], nyb, nz, spec.fold, cap)
