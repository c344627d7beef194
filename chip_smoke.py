#!/usr/bin/env python3
"""GPU smoke run of uammd_tpu_torch, the PyTorch/CUDA port of uammd_tpu.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Imports nothing of JAX or of the JAX package. Phases:

1. Build every CUDA kernel of the port from ``uammd_tpu_torch/engine/csrc``
   (one nvcc per source, all started together) into the git-ignored
   ``uammd_tpu_torch/_build/``.
2. Hold each kernel against its plain PyTorch version on the card:
   - v1 pair force: max|df| / max|f| < 1e-5 (float32 sums in another
     order), on a jittered simple-cubic lattice at N = 32768, rho 0.5 (no
     pair closer than 0.86), on a perturbed fcc lattice at the 2^20
     benchmark spec and on the final liquid;
   - v1 rebin, Q = 7 and Q = 10, after random displacements below the
     drift threshold: ``out``, ``count`` and ``overflow`` exactly equal; a
     crammed configuration must latch overflow;
   - Newton pair force, exact reciprocal: every output (home, 4 reaction
     groups, straggler forces) and the folded total within 1e-5 of the
     largest folded force, and every slot within ``SLOT_TOL`` of its own
     scale |f_ref| + median|f|, on the n 600 straggler system (CAP 8,
     128-row list, no pair closer than 0.84; all four self-cell x
     straggler-image modes) and on the 2^20 perturbed fcc state; with the
     approximate reciprocal within ``FAST_RECIP_TOL`` and
     ``FAST_RECIP_SLOT_TOL``. Two controls on the straggler system show
     that the check fails a kernel that drops the straggler interactions
     or flips the sign of their reactions;
   - fold: bit-equal;
   - fused fold + G-J update at T = 1.5 on identical counter noise: "clt"
     bit-equal with an equal drift, "bm" within ``BM_TOL`` (the card's
     logf/sinf/cosf against PyTorch's);
   - separable rebin after a displacement with stragglers present:
     ``out``, ``mini``, count and overflow exactly equal; a crammed state
     latches overflow through ``rebin_fast3``;
   - pencil spread and interpolation (kernels #13/#14 of the BDHI-FCM
     path): max|d| <= ``PENCIL_TOL`` x max|ref| at n 5000, L 24, 32^3 for
     the Gaussian, Peskin 3- and 4-point and ES/BM windows, slack 0 and 1,
     and on the FCM path's first state (131072 particles, 384^3, support
     14, slack 1). Two controls must fail that bound by 100x: the spread
     with one particle's values dropped and the interpolation of a field
     shifted by one node. ``FCM.grid_velocity`` and ``interpolate_auto``
     must go through the same kernels (one launch each) and agree with
     the plain versions at n 4200, 48^3. The fcc start on the 384^3 grid
     must overflow the pencil cap and NaN-poison the mobility.
3. The main paths at full size, as bench.py's LJ protocol runs them: N =
   2^20, box 128^3 (rho 0.5), rcut 2.5, T 1.5.
   - v1: melt 300 steps at dt 0.004 from the fcc lattice, then a fresh v1
     engine on the melted positions at dt 0.01: 100 settle and 200 timed
     steps;
   - v2 (the engine bench.py times): ``make_lj_md2`` on the melted
     positions at dt 0.01 with n_strag 16, noise "clt" and the fast
     reciprocal: 100 settle and 200 timed steps.
   - BDHI-FCM (``main_path_fcm``): bench.py:117-118's suspension (N =
     131072, volume fraction 0.05, radius 1) from uniform random positions
     under gravity, ``fcm_em`` over the FCM mobility at h = a sqrt(pi)/3
     (384^3, Gaussian support 14, slack 1), dt 0.01, T 1: 20 warm-up and
     100 timed steps.
   Every kernel launch count is set to 0 just before each path and read
   just after it. Each LJ path requires no overflow, all particles kept
   (grid plus stragglers), T within 20 % of 1.5, and every kernel of the
   path launched (the per-step kernels at least once per step). The FCM
   path requires no pencil overflow, finite positions, both pencil kernels
   launched at least once per timed step, the self-mobility through the
   kernels with the path's bins within 1e-3 of Hashimoto's, the noise of
   two ``compute_mf_bdw`` draws differing by 2 (2T/dt) m_self per axis
   within 2 % (averaged over ``FDT_PAIRS`` pairs), and the mean settling
   velocity within 10 % of m_self |g|.
4. Time each kernel and its plain version (CUDA events, after warm-up) at
   its path's final shapes, check them against each other once more there,
   print the v2 and FCM steps' breakdowns and the kernels' JSON line.

The last line is ``{"ok": true, "device": {...}}``; any failed check raises
before it and the exit code is not 0. Without a GPU it exits with code 2
and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

N = 1 << 20
BOX = 128.0
TEMPERATURE = 1.5
RC2 = 2.5 * 2.5
MELT_STEPS, SETTLE_STEPS, TIMED_STEPS = 300, 100, 200
N_STRAG = 16  # bench.py:84

# The approximate reciprocal (rcp.approx.ftz.f32, about 1 ulp) enters the
# force as t^7: a few ulp relative per pair, 100x below this bound.
FAST_RECIP_TOL = 1e-4
# Per-slot bounds on |df| / (|f_ref| + median|f|): float32 sums in another
# order differ by a few 1e-6 of a slot's scale (2.7e-6 for float32 against
# float64 on the n 600 straggler system, on a CPU); the approximate
# reciprocal adds its few ulp per pair term.
SLOT_TOL = 1e-4
FAST_RECIP_SLOT_TOL = 1e-3
# "bm" noise goes through logf, sinf and cosf, which may round differently
# in the kernel and in PyTorch's kernels by an ulp or two: 1e-5 is a few
# ulp of a position of size 64.
BM_TOL = 1e-5

# H100 SXM data sheet peaks (full 700 W power limit): float32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# float32 operations the pair force needs, per unordered pair of particles
# in one 27-cell stencil (a Newton-halved evaluation visits each once):
# the cutoff test d = r_j - r_i, r2 = d.d (3 sub, 3 mul, 2 add) for every
# such pair, and for pairs inside the cutoff the LJ radial (clamp, 1/r2 and
# 8 mul/add), g * d (3) and the sums into both particles (6).
OPS_PAIR_TEST = 8
OPS_PAIR_FORCE = 19


# The BDHI-FCM path: bench.py:117-118's colloidal suspension (N = 131072,
# volume fraction 0.05, radius 1) under gravity, with the FCM mobility at
# h = a sqrt(pi) / 3 (a 384^3 grid, Gaussian support 14) and fcm_em's
# persistent pencil bins (slack 1).
FCM_N = 131072
FCM_PHI = 0.05
FCM_L = (FCM_N * (4.0 / 3.0) * math.pi / FCM_PHI) ** (1.0 / 3.0)
FCM_PPR = 3.0 / math.sqrt(math.pi)
FCM_DT, FCM_T, FCM_G = 0.01, 1.0, 1.0
FCM_WARM, FCM_TIMED = 20, 100
FDT_PAIRS = 4
# Pencil kernels against their plain versions: max|d| <= PENCIL_TOL x
# max|ref|. Both sum float32 products in another order (atomics in the
# spread), and the largest difference over the 1.7e8 outputs of the 384^3
# field is an extreme of many: 5.7e-6 for the spread and 2.7e-6 for the
# interpolation on the path's first state, 6.2e-7 at 32^3 (a first chip
# run; the phase also prints both against float64 plain versions).
PENCIL_TOL = 2e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_force_err(f_ref, f_test, mask) -> float:
    fmax = max(float(a[mask].abs().max()) for a in f_ref)
    err = max(float((a[mask] - b[mask]).abs().max()) for a, b in zip(f_ref, f_test))
    return err / fmax


def stacked_of(gs, q: int):
    import torch

    cols = [gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz, gs.fx, gs.fy, gs.fz]
    return torch.stack(cols[: q - 1] + [(gs.pid + 1).to(torch.float32)]).contiguous()


def strag_stack_of(gs):
    import torch

    return torch.stack([gs.spos[:, 0], gs.spos[:, 1], gs.spos[:, 2], gs.svel[:, 0],
                        gs.svel[:, 1], gs.svel[:, 2],
                        (gs.spid + 1).to(torch.float32)]).contiguous()


def displaced(gs, seed: int):
    """Every particle (stragglers too) moved by less than the drift
    threshold per axis."""
    import torch

    gen = torch.Generator(device=gs.device)
    gen.manual_seed(seed)
    step = 0.99 * gs.spec.drift_threshold / math.sqrt(3.0)
    m = gs.mask

    def move(a, mask):
        u = torch.rand(a.shape, generator=gen, device=a.device) * 2.0 - 1.0
        return a + step * u * mask

    return gs.replace(x=move(gs.x, m), y=move(gs.y, m), z=move(gs.z, m),
                      spos=move(gs.spos, (gs.spid >= 0)[:, None]))


def check_pair(gs, what: str) -> float:
    from uammd_tpu_torch.engine import md, pair_kernel

    g = md.lj_g()
    f_k = pair_kernel.make_pair_force_kernel(gs.spec, g)(gs.x, gs.y, gs.z)
    f_p = pair_kernel.pair_force_plain(gs.spec, g, gs.x, gs.y, gs.z)
    m = gs.mask
    check(all(bool(a[m].isfinite().all()) for a in f_k), f"{what}: pair forces finite")
    err = rel_force_err(f_p, f_k, m)
    check(err < 1e-5, f"{what}: pair kernel vs plain, max|df|/max|f| = {err:.3g} < 1e-5")
    return err


def check_rebin(gs, q: int, what: str, expect_clean: bool = True):
    import torch
    from uammd_tpu_torch.engine import rebin_kernel as rk

    stacked = stacked_of(gs, q)
    out_k, count_k, over_k = rk.make_rebin_kernel(gs.spec)(stacked)
    out_p, count_p, over_p = rk.rebin_plain(gs.spec, stacked)
    check(torch.equal(out_k, out_p), f"{what}: rebin Q={q} out equals plain slot for slot")
    check((int(count_k), int(over_k)) == (int(count_p), int(over_p)),
          f"{what}: rebin Q={q} count/overflow {int(count_k)}/{int(over_k)} "
          f"== plain {int(count_p)}/{int(over_p)}")
    if expect_clean:
        check(int(count_k) == gs.n and int(over_k) == 0,
              f"{what}: rebin Q={q} keeps all {gs.n} particles without overflow")
    return int(count_k), int(over_k)


def newton_pair(gs, *, approx=False, self_half=True, cellcenter=True, plain=False,
                spid=None):
    """The Newton kernel's (or its plain version's) outputs on ``gs``;
    ``spid`` replaces the state's straggler ids (-1 drops a row)."""
    from uammd_tpu_torch.engine import kernel2, md

    spec = gs.spec
    g = md.lj_g_fused(rc2=RC2, approx=approx)
    spid = gs.spid if spid is None else spid
    strag = kernel2.broadcast_stragglers(spec, gs.spos, spid) if spec.n_strag else None
    if plain:
        return kernel2.newton_pair_plain(spec, g, gs.x, gs.y, gs.z, strag,
                                         strag_cellcenter=cellcenter)
    kern = kernel2.make_newton_pair_kernel(spec, g, self_half=self_half,
                                           strag_cellcenter=cellcenter)
    return kern(gs.x, gs.y, gs.z, strag)


def newton_outputs(gs, out, plain_fold=False):
    """The Newton outputs (home, groups, straggler forces) and their folded
    total (the fold kernel, or its plain version), as one list of tensors."""
    from uammd_tpu_torch.engine import kernel2

    home, groups, sf = out
    fold = kernel2.fold_reactions_plain if plain_fold else kernel2.make_fold_kernel(gs.spec)
    grids = list(home) + [c for g in groups for c in g] + list(fold(home, groups))
    return grids + ([sf] if sf is not None else [])


def newton_errs(ref, test, scale):
    """max|df| over every slot of every output, relative to the largest
    folded force (``rel``) and to the slot's own scale |f_ref| + median|f|
    (``slot``), where ``scale`` = (max|f|, median|f|) of the folded total
    over occupied slots."""
    fmax, med = scale
    diffs = [(a - b).abs() for a, b in zip(test, ref)]
    return {"rel": max(float(d.max()) for d in diffs) / fmax,
            "slot": max(float((d / (b.abs() + med)).max()) for d, b in zip(diffs, ref))}


def check_newton(gs, what: str, modes=((True, True),), approx=False, tol=1e-5,
                 slot_tol=SLOT_TOL):
    """Every output of the Newton kernel and the folded total against the
    plain version (exact reciprocal), relative to the largest folded force
    of an occupied slot and to each slot's own scale; returns the largest
    errors, max|f| and median|f|."""
    import torch

    ref = newton_outputs(gs, newton_pair(gs, plain=True), plain_fold=True)
    m = gs.mask
    fa = torch.cat([a[m].abs() for a in ref[15:18]])
    scale = (float(fa.max()), float(fa.median()))
    worst = {"rel": 0.0, "slot": 0.0, "max_f": scale[0], "median_f": scale[1]}
    for self_half, cellcenter in modes:
        test = newton_outputs(gs, newton_pair(gs, approx=approx, self_half=self_half,
                                              cellcenter=cellcenter))
        check(all(bool(a[m].isfinite().all()) for a in test[15:18]),
              f"{what}: Newton forces finite")
        err = newton_errs(ref, test, scale)
        check(err["rel"] < tol and err["slot"] < slot_tol,
              f"{what}: Newton kernel (self_half={self_half}, cellcenter={cellcenter}, "
              f"approx={approx}) vs plain, max|df|/max|f| = {err['rel']:.3g} < {tol}, "
              f"per slot {err['slot']:.3g} < {slot_tol}")
        worst = {k: max(v, err.get(k, v)) for k, v in worst.items()}
    return worst


def check_newton_controls(gs, what: str):
    """Outputs that a wrong kernel would give on a straggler state must fail
    the check of ``check_newton``: the kernel's outputs with the straggler
    rows dropped, and with the sign of the straggler reactions flipped.
    Returns their per-slot errors."""
    import torch

    ref = newton_outputs(gs, newton_pair(gs, plain=True), plain_fold=True)
    fa = torch.cat([a[gs.mask].abs() for a in ref[15:18]])
    scale = (float(fa.max()), float(fa.median()))
    dropped = newton_outputs(gs, newton_pair(gs, spid=torch.full_like(gs.spid, -1)))
    dropped[-1] = torch.zeros_like(ref[-1])
    flipped = newton_outputs(gs, newton_pair(gs))
    flipped[-1] = -flipped[-1]
    errs = {"stragglers_dropped": newton_errs(ref, dropped, scale)["slot"],
            "straggler_reaction_flipped": newton_errs(ref, flipped, scale)["slot"]}
    for k, v in errs.items():
        check(v > 100 * SLOT_TOL, f"{what}: control '{k}' fails the per-slot check "
                                  f"({v:.3g} > {100 * SLOT_TOL})")
    return errs


def check_fold(spec, home, groups, what: str):
    import torch
    from uammd_tpu_torch.engine import kernel2

    f_k = kernel2.make_fold_kernel(spec)(home, groups)
    f_p = kernel2.fold_reactions_plain(home, groups)
    check(all(torch.equal(a, b) for a, b in zip(f_k, f_p)), f"{what}: fold bit-equal to plain")


def update_inputs(gs, home, groups, seed: int):
    """Arguments of the fused update on ``gs``: random w, the given forces,
    reference positions up to 0.2 away, and a seed."""
    import torch

    gen = torch.Generator(device=gs.device)
    gen.manual_seed(seed)
    m = gs.mask

    def rnd(scale):
        return scale * torch.randn(gs.x.shape, generator=gen, device=gs.device) * m

    w = [rnd(1.2) for _ in range(3)]
    ref = [p - rnd(0.1) for p in (gs.x, gs.y, gs.z)]
    step = torch.tensor(seed, dtype=torch.int32, device=gs.device)
    return ([gs.x, gs.y, gs.z] + w + list(home), [c for g in groups for c in g], ref, step)


def check_update(gs, home, groups, noise: str, what: str):
    import torch
    from uammd_tpu_torch.engine import update_kernel as uk

    kern = uk.make_gj_fold_update_kernel(gs.spec, 0.01, TEMPERATURE, 1.0, 1.0, noise=noise)
    a, grp, ref, step = update_inputs(gs, home, groups, 20251)
    strag = None
    if gs.spec.n_strag:
        gen = torch.Generator(device=gs.device).manual_seed(20252)
        sv = (gs.spid >= 0)[:, None]
        strag = (gs.spos, torch.randn(gs.svel.shape, generator=gen, device=gs.device) * sv,
                 torch.randn(gs.sforce.shape, generator=gen, device=gs.device) * sv, gs.spid)
    out_k, d_k, *s_k = kern(*a, grp, *ref, step, strag)
    out_p, d_p, *s_p = uk.gj_fold_update_plain(gs.spec, kern.coef, noise, *a, grp, *ref,
                                               step, strag)
    if strag is not None:  # the straggler rows ride in the same call
        out_k, out_p = tuple(out_k) + s_k[0], tuple(out_p) + s_p[0]
    err = max(float((x - y).abs().max()) for x, y in zip(out_k, out_p))
    d_err = abs(float(d_k) - float(d_p))
    if noise == "clt":
        check(all(torch.equal(x, y) for x, y in zip(out_k, out_p)) and d_err == 0.0,
              f"{what}: fused update (clt) bit-equal to plain, drift equal "
              f"(max|d| {err:.3g}, drift {float(d_k)} vs {float(d_p)})")
    else:
        check(err <= BM_TOL and d_err <= BM_TOL,
              f"{what}: fused update (bm) within {BM_TOL} of plain: {err:.3g}, "
              f"drift {d_err:.3g}")
    check(float(d_k) > 0.0, f"{what}: fused update sees the drift")
    return err, d_err


def check_sep_rebin(gs, what: str, expect_clean: bool = True):
    import torch
    from uammd_tpu_torch.engine import rebin_kernel as rk

    stacked, strag = stacked_of(gs, 7), strag_stack_of(gs)
    out_k, mini_k, count_k, over_k = rk.make_separable_rebin(gs.spec)(stacked, strag)
    out_p, mini_p, count_p, over_p = rk.separable_rebin_plain(gs.spec, stacked, strag)
    check(torch.equal(out_k, out_p) and torch.equal(mini_k, mini_p),
          f"{what}: separable rebin out and mini equal plain slot for slot")
    check((int(count_k), int(over_k)) == (int(count_p), int(over_p)),
          f"{what}: separable rebin count/overflow {int(count_k)}/{int(over_k)} "
          f"== plain {int(count_p)}/{int(over_p)}")
    if expect_clean:
        check(int(count_k) == gs.n and int(over_k) == 0,
              f"{what}: separable rebin keeps all {gs.n} particles without overflow")
    return int(count_k), int(over_k), int((mini_k[6] > 0.5).sum())


def stencil_pairs(gs) -> tuple[int, int]:
    """Unordered pairs of distinct particles in one 27-cell stencil of this
    state, and those of them within the cutoff: the work the pair force's
    data needs. Each pair is seen from both ends, so the ordered counts are
    halved. Straggler rows are not counted."""
    import numpy as np
    import torch
    from uammd_tpu_torch.engine import layout

    spec = gs.spec
    rc2 = float(np.float32(spec.cutoff * spec.cutoff))
    rows = torch.arange(spec.cap, device=gs.device)[None, None, :, None]
    pid_i = gs.pid[:, :, :, None, :]
    home = [a[:, :, :, None, :] for a in (gs.x, gs.y, gs.z)]
    cand = cut = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, lane, shifts = layout.stencil_sources(spec, dz, dy, dx, gs.device)
                pid_j = gs.pid[zs, ybs, rows, lane][:, :, None]
                both = (pid_i >= 0) & (pid_j >= 0) & (pid_i != pid_j)
                r2 = sum(((a[zs, ybs, rows, lane] + s)[:, :, None] - h) ** 2
                         for a, s, h in zip((gs.x, gs.y, gs.z), shifts, home))
                cand += int(both.sum())
                cut += int((both & (r2 < rc2)).sum())
    return cand // 2, cut // 2


def gates(engine, gs, what: str, n_steps: int, launches: dict, per_step, at_least_once):
    n_kept = int((gs.pid >= 0).sum()) + int((gs.spid >= 0).sum())
    t_meas = float(engine.temperature_of(gs))
    check(not bool(gs.overflow), f"{what}: no overflow")
    check(n_kept == N, f"{what}: all particles kept: {n_kept} == {N}")
    check(math.isfinite(t_meas) and abs(t_meas - TEMPERATURE) < 0.2 * TEMPERATURE,
          f"{what}: temperature {t_meas:.4f} within 20 % of {TEMPERATURE}")
    for k in per_step:
        check(launches[k] >= n_steps,
              f"{what}: {k} kernel launched {launches[k]} >= {n_steps} times")
    for k in at_least_once:
        check(launches[k] >= 1, f"{what}: {k} kernel launched {launches[k]} >= 1 times")
    return n_kept, t_meas


# ---------------------------------------------------------------- BDHI-FCM
def rel_err(test, ref) -> float:
    return float((test - ref).abs().max() / ref.abs().max())


def pencil_kernels():
    """The four window functions as the pencil kernels take them: the
    test_pencil_ibm.py:210 Gaussian, Peskin 3- and 4-point, and FCM's
    normalised ES/BM at its default support 6."""
    from uammd_tpu_torch.integrators.bdhi.fcm import _NormalizedBM
    from uammd_tpu_torch.solvers import ibm

    return {"gaussian": ibm.GaussianKernel(sigma=1.1, support=8), "peskin3": ibm.Peskin3pt(),
            "peskin4": ibm.Peskin4pt(), "bm": _NormalizedBM(beta=1.3267 * 6, support=6)}


def check_pencil(kern, pos, vals, shape, b, bins, slack: int, what: str):
    """Kernels #13 and #14 against their plain versions (the interpolation
    of the plain spread field); both within PENCIL_TOL x max|ref|. Returns
    (spread err, interp err, plain field, plain values)."""
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    f_p, _ = tp.spread_pencil_fused_plain(kern, pos, vals, shape, b, bins, slack=slack)
    f_k, _ = tp.spread_pencil_fused(kern, pos, vals, shape, b, bins, slack=slack)
    v_p, _ = tp.interpolate_pencil_fused_plain(kern, pos, f_p, b, bins, slack=slack)
    v_k, _ = tp.interpolate_pencil_fused(kern, pos, f_p, b, bins, slack=slack)
    errs = (rel_err(f_k, f_p), rel_err(v_k, v_p))
    check(all(math.isfinite(e) and e <= PENCIL_TOL for e in errs),
          f"{what}: pencil spread / interp vs plain, max|d|/max|ref| = "
          f"{errs[0]:.3g} / {errs[1]:.3g} <= {PENCIL_TOL}")
    return errs[0], errs[1], f_p, v_p


def check_pencil_controls(kern, pos, vals, shape, b, bins, slack, f_p, v_p, what: str):
    """Outputs a wrong kernel would give must fail check_pencil's bound by
    a wide margin: the spread with particle 0's values dropped, and the
    interpolation read from a field shifted by one node along x."""
    import torch
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    dropped = vals.clone()
    dropped[0] = 0.0
    f_d, _ = tp.spread_pencil_fused(kern, pos, dropped, shape, b, bins, slack=slack)
    v_s, _ = tp.interpolate_pencil_fused(kern, pos, torch.roll(f_p, 1, dims=0), b, bins,
                                         slack=slack)
    errs = {"spread_one_particle_dropped": rel_err(f_d, f_p),
            "interp_field_shifted_one_node": rel_err(v_s, v_p)}
    for k, v in errs.items():
        check(v > 100 * PENCIL_TOL, f"{what}: control '{k}' fails the pencil check "
                                    f"({v:.3g} > {100 * PENCIL_TOL})")
    return errs


def check_auto_dispatch(dev):
    """``FCM.grid_velocity`` and ``interpolate_auto`` take the pencil path
    through kernels #13/#14 (one launch each) and agree with their plain
    versions within PENCIL_TOL x max|ref|, at tests/test_bdhi.py:187's
    system (n 4200, L 40, points_per_radius 1.2, support 8)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.integrators.bdhi.fcm import FCM
    from uammd_tpu_torch.solvers import ibm
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    rng = np.random.default_rng(9)
    L = 40.0
    pos = torch.tensor((rng.random((4200, 3)) - 0.5) * L, dtype=torch.float32, device=dev)
    f = torch.tensor(rng.normal(size=(4200, 3)), dtype=torch.float32, device=dev)
    fcm = FCM.create(box(L, device=dev), viscosity=1.0, radius=1.0, points_per_radius=1.2,
                     support=8)
    n0, n1 = tp.SPREAD.launches, tp.INTERP.launches
    u_k, kern = fcm.grid_velocity(pos, f)
    v_k = ibm.interpolate_auto(kern, pos, u_k, fcm.box)
    launched = (tp.SPREAD.launches - n0, tp.INTERP.launches - n1)
    bins = tp.bin_pencils(pos, fcm.shape, fcm.box)
    field, _ = tp.spread_pencil_fused_plain(kern, pos, f, fcm.shape, fcm.box, bins)
    u_p = fcm._irfftn(fcm._mobility_k(torch.fft.rfftn(field, dim=(0, 1, 2)), pos))
    v_p, _ = tp.interpolate_pencil_fused_plain(kern, pos, u_k, fcm.box, bins)
    errs = {"grid_velocity": rel_err(u_k, u_p), "interpolate_auto": rel_err(v_k, v_p)}
    check(launched == (1, 1), f"auto dispatch: grid_velocity and interpolate_auto launched "
                              f"the spread / interp kernels {launched} times, want (1, 1)")
    check(all(math.isfinite(e) and e <= PENCIL_TOL for e in errs.values()),
          f"auto dispatch vs plain, max|d|/max|ref| = {errs} <= {PENCIL_TOL}")
    return errs


def fcm_setup(dev, seed: int):
    """The path's box, FCM and uniform random start (numpy, from ``seed``)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.integrators.bdhi.fcm import FCM

    b = box(FCM_L, device=dev)
    fcm = FCM.create(b, viscosity=1.0, radius=1.0, points_per_radius=FCM_PPR)
    pos = (np.random.default_rng(seed).random((FCM_N, 3)) - 0.5) * FCM_L
    return b, fcm, torch.tensor(pos, dtype=torch.float32, device=dev)


def hashimoto_mobility() -> float:
    """Periodic self-mobility of one sphere, Hashimoto's series
    (tests/test_bdhi.py:67), at viscosity 1 and radius 1."""
    m0 = 1.0 / (6.0 * math.pi)
    return m0 * (1.0 - 2.83729748 / FCM_L + (4.0 * math.pi / 3.0) / FCM_L**3)


def fcm_kernel_checks(dev):
    """Phase 2b: kernels #13/#14 against their plain versions at n 5000,
    L 24, 32^3 for the four window functions and slack 0 and 1, with the
    two controls; through the auto dispatch (``check_auto_dispatch``); then
    at full size on the path's first state (with
    float64 plain versions as a yardstick of both); then the fcc control."""
    import numpy as np
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.solvers import pencil_ibm as tp
    from uammd_tpu_torch.utils.lattices import lattice

    rng = np.random.default_rng(5)
    n, L, shape = 5000, 24.0, (32, 32, 32)
    b = box(L, device=dev)
    pos0 = torch.tensor((rng.random((n, 3)) - 0.5) * L, dtype=torch.float32, device=dev)
    vals = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)
    bins = tp.bin_pencils(pos0, shape, b)
    # with slack 1 the particles move by up to 0.99 h in x and y (and 3 h
    # in z) after binning: the persistent-bin contract of fcm_em
    h = L / shape[0]
    moved = pos0 + torch.tensor(rng.uniform(-0.99, 0.99, (n, 3)) * [h, h, 3 * h],
                                dtype=torch.float32, device=dev)
    small, controls = {}, {}
    for name, kern in pencil_kernels().items():
        for slack, pos in ((0, pos0), (1, moved)):
            what = f"n 5000 32^3 {name} slack {slack}"
            es, ei, f_p, v_p = check_pencil(kern, pos, vals, shape, b, bins, slack, what)
            small[f"{name}_slack{slack}"] = [es, ei]
            if name == "gaussian":
                controls[f"slack{slack}"] = check_pencil_controls(
                    kern, pos, vals, shape, b, bins, slack, f_p, v_p, what)

    auto = check_auto_dispatch(dev)

    bf, fcm, pos = fcm_setup(dev, seed=0)
    kern = fcm._kernel()
    bins = fcm.pencil_bins(pos, slack=1)
    check(not bool(bins.overflow), "FCM first state: no pencil overflow")
    f = torch.tensor(rng.normal(size=(FCM_N, 3)), dtype=torch.float32, device=dev)
    es, ei, f_p, v_p = check_pencil(kern, pos, f, fcm.shape, bf, bins, 1, "FCM first state")
    full_controls = check_pencil_controls(kern, pos, f, fcm.shape, bf, bins, 1, f_p, v_p,
                                          "FCM first state")
    f_k, _ = tp.spread_pencil_fused(kern, pos, f, fcm.shape, bf, bins, slack=1)
    v_k, _ = tp.interpolate_pencil_fused(kern, pos, f_p, bf, bins, slack=1)
    spread_abs = float((f_k - f_p).abs().max())
    interp_abs = float((v_k - v_p).abs().max())
    b64 = box(FCM_L, dtype=torch.float64, device=dev)
    p64 = pos.double()
    f_64, _ = tp.spread_pencil_fused_plain(kern, p64, f.double(), fcm.shape, b64, bins, slack=1)
    v_64, _ = tp.interpolate_pencil_fused_plain(kern, p64, f_p.double(), b64, bins, slack=1)
    vs_f64 = {"spread_kernel": rel_err(f_k.double(), f_64),
              "spread_plain": rel_err(f_p.double(), f_64),
              "interp_kernel": rel_err(v_k.double(), v_64),
              "interp_plain": rel_err(v_p.double(), v_64)}
    del f_p, f_k, f_64, v_64, p64

    # the fcc start overflows the pencil cap on this grid: the result is
    # NaN-poisoned, never silently short of particles
    pos_fcc = torch.tensor(lattice(FCM_N, FCM_L, "fcc"), dtype=torch.float32, device=dev)
    bins_fcc = fcm.pencil_bins(pos_fcc, slack=1)
    occ_fcc = int(torch.bincount(tp.pencil_of(pos_fcc, fcm.shape, bf)).max())
    fcc_mf = fcm.compute_mf(pos_fcc, torch.ones_like(pos_fcc), bins=bins_fcc, slack=1)
    check(bool(bins_fcc.overflow), "fcc control: the pencil bins latch overflow")
    check(bool(fcc_mf.isnan().all()), "fcc control: the mobility is NaN-poisoned")
    out = {"phase": "fcm_kernels_vs_plain", "ok": True, "tol": PENCIL_TOL,
           "small_spread_interp_rel_err": small, "small_controls": controls,
           "auto_dispatch_rel_err": auto,
           "full": {"shape": list(fcm.shape), "support": fcm.support,
                    "cap": bins.pids.shape[1],
                    "max_pencil_load": int(torch.bincount(tp.pencil_of(pos, fcm.shape, bf)).max()),
                    "spread_rel_err": es, "interp_rel_err": ei, "controls": full_controls,
                    "rel_err_vs_float64_plain": vs_f64},
           "fcc_control": {"overflow": True, "max_pencil_load": occ_fcc,
                           "cap": bins_fcc.pids.shape[1], "mobility_all_nan": True}}
    print(json.dumps(out), flush=True)
    return {"pencil_spread": spread_abs, "pencil_interp": interp_abs}


def fcm_main_path(dev, counted):
    """Phase 3c: fcm_em with gravity on the 131072-particle suspension,
    FCM_WARM + FCM_TIMED steps, with the launch counts of ``counted`` set
    to 0 just before and read just after; then the gates."""
    import torch
    from uammd_tpu_torch.core.state import make_state
    from uammd_tpu_torch.integrators.bdhi.euler_maruyama import fcm_em
    from uammd_tpu_torch.interactors.external import external_forces, gravity

    b, fcm, pos = fcm_setup(dev, seed=1)
    energy_fn, force_fn = gravity((0.0, 0.0, -FCM_G))

    def forces(state, aux):
        return external_forces(state, energy_fn, force_fn), aux

    for k in counted.values():
        k.launches = 0
    integ = fcm_em(forces, fcm, dt=FCM_DT, temperature=FCM_T, slack=1)
    state, aux = integ.init(make_state(pos, seed=1, device=dev), None)
    overflows, rebins = [aux[0].overflow], 0
    for _ in range(FCM_WARM):
        state, aux = integ.step(state, aux)
    torch.cuda.synchronize()
    before = {k: v.launches for k, v in counted.items()}
    z0 = state.pos[:, 2].clone()
    t0 = time.perf_counter()
    for _ in range(FCM_TIMED):
        prev = aux[0]
        state, aux = integ.step(state, aux)
        if aux[0] is not prev:
            rebins += 1
            overflows.append(aux[0].overflow)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    timed = {k: launches[k] - before[k] for k in counted}
    bins = aux[0]

    m_self = hashimoto_mobility()
    check(not bool(torch.stack(overflows).any()), "FCM path: no pencil overflow")
    check(bool(state.pos.isfinite().all()), "FCM path: all positions finite")
    for k in counted:
        check(timed[k] >= FCM_TIMED, f"FCM path: {k} launched {timed[k]} >= {FCM_TIMED} "
                                     f"times in the timed steps")
    v_settle = -float((state.pos[:, 2] - z0).mean()) / (FCM_TIMED * FCM_DT)
    settle_ratio = v_settle / (m_self * FCM_G)
    check(abs(settle_ratio - 1.0) < 0.1,
          f"FCM path: mean settling velocity {v_settle:.5g} within 10 % of m_self |g| "
          f"= {m_self * FCM_G:.5g} (ratio {settle_ratio:.4f})")
    # self-mobility through the kernels, with the path's own bins
    e = torch.zeros_like(state.pos)
    e[0, 0] = 1.0
    v0 = fcm.compute_mf(state.pos, e, bins=bins, slack=1)
    hashimoto_err = float(v0[0, 0]) / m_self - 1.0
    check(abs(hashimoto_err) < 1e-3,
          f"FCM path: self-mobility {float(v0[0, 0]):.7g} within 1e-3 of Hashimoto "
          f"{m_self:.7g} ({hashimoto_err:.3g})")
    # fluctuation-dissipation: two noise draws with the same forces differ by
    # amp^2 * 2 * M_ii per axis, amp^2 = 2 T / dt. Hydrodynamic correlations
    # leave about N/4 independent samples in one pair (a 2 % spread per axis,
    # measured at N = 16384 on a CPU), so FDT_PAIRS pairs are averaged.
    amp = math.sqrt(2.0 * FCM_T / FCM_DT)
    f = state.force
    msq = torch.zeros(3, dtype=torch.float64, device=dev)
    for _ in range(FDT_PAIRS):
        d = (fcm.compute_mf_bdw(state.pos, f, state.gen, amp, bins=bins, slack=1)
             - fcm.compute_mf_bdw(state.pos, f, state.gen, amp, bins=bins, slack=1))
        msq += (d.double() ** 2).mean(0)
    msq = [float(x) / FDT_PAIRS for x in msq]
    want = 2.0 * amp * amp * m_self
    fdt = [m / want - 1.0 for m in msq]
    check(all(abs(x) < 0.02 for x in fdt),
          f"FCM path: noise mean square per axis {msq} ({FDT_PAIRS} pairs) within 2 % of "
          f"{want:.6g}")
    ms = 1e3 * timed_s / FCM_TIMED
    out = {"phase": "main_path_fcm", "n": FCM_N, "box": FCM_L, "volume_fraction": FCM_PHI,
           "shape": list(fcm.shape), "support": fcm.support, "cap": bins.pids.shape[1],
           "dt": FCM_DT, "temperature": FCM_T, "slack": 1, "warmup_steps": FCM_WARM,
           "timed_steps": FCM_TIMED, "timed_seconds": timed_s, "ms_per_step": ms,
           "particle_steps_per_s": FCM_N * FCM_TIMED / timed_s, "rebins_timed": rebins,
           "overflow": False, "launches": launches, "timed_launches": timed,
           "settling_velocity": v_settle, "settling_over_m_self_g": settle_ratio,
           "self_mobility": float(v0[0, 0]), "hashimoto": m_self,
           "hashimoto_rel_err": hashimoto_err, "noise_msq_per_axis": msq,
           "noise_msq_want": want, "fdt_rel_err": fdt, "fdt_pairs": FDT_PAIRS,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(out), flush=True)
    return {"fcm": fcm, "box": b, "state": state, "bins": bins, "ms": ms,
            "rebins_per_step": rebins / FCM_TIMED, "launches": launches}


def fcm_breakdown(path, card, errs):
    """Phase 4b: each part of the FCM step timed alone at the path's final
    state (CUDA events), times its calls per step; and the pencil kernels'
    rows of the kernels line."""
    import torch
    from uammd_tpu_torch.integrators.bdhi.fcm import _sample_white_rfft
    from uammd_tpu_torch.solvers import pencil_ibm as tp
    from uammd_tpu_torch.solvers.ibm import _poison

    fcm, b, state, bins = path["fcm"], path["box"], path["state"], path["bins"]
    pos, f, shape = state.pos, state.force, fcm.shape
    kern = fcm._kernel()
    amp = math.sqrt(2.0 * FCM_T / FCM_DT)
    field, _ = tp.spread_pencil_fused(kern, pos, f, shape, b, bins, slack=1)
    fk = torch.fft.rfftn(field, dim=(0, 1, 2))
    uk = fcm._kspace_combine(fk.clone(), _sample_white_rfft(state.gen, shape, fcm.dV,
                                                            torch.float32, pos.device), amp, pos)
    u = torch.fft.irfftn(uk, s=shape, dim=(0, 1, 2))
    Ls = fcm.box_size

    ref = pos + 0.1

    def drift_read():  # fcm_em's rebin test: two reductions and one host read
        w = [torch.max(torch.abs(dd - L * torch.round(dd / L)))
             for dd, L in ((pos[:, k] - ref[:, k], Ls[k]) for k in range(2))]
        return float(torch.maximum(*w))

    t = {
        "pencil_spread": cuda_ms(lambda: tp.spread_pencil_fused(kern, pos, f, shape, b, bins,
                                                                slack=1), reps=10),
        "pencil_interp": cuda_ms(lambda: tp.interpolate_pencil_fused(kern, pos, u, b, bins,
                                                                     slack=1), reps=10),
        "rfftn": cuda_ms(lambda: torch.fft.rfftn(field, dim=(0, 1, 2)), reps=10),
        "irfftn": cuda_ms(lambda: torch.fft.irfftn(uk, s=shape, dim=(0, 1, 2)), reps=10),
        "poison_field": cuda_ms(lambda: _poison(field, bins.overflow), reps=10),
        "bin_pencils": cuda_ms(lambda: fcm.pencil_bins(pos, slack=1), reps=10),
    }
    clone_ms = cuda_ms(lambda: fk.clone(), reps=10)
    t["kspace_combine_and_noise"] = cuda_ms(lambda: fcm._kspace_combine(
        fk.clone(), _sample_white_rfft(state.gen, shape, fcm.dV, torch.float32, pos.device),
        amp, pos), reps=10) - clone_ms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        drift_read()
    t["host_drift_read"] = 1e3 * (time.perf_counter() - t0) / 20
    calls = {k: 1.0 for k in t}
    calls["bin_pencils"] = path["rebins_per_step"]
    per_step = {k: t[k] * calls[k] for k in t}
    ms = path["ms"]
    print(json.dumps({
        "phase": "breakdown_fcm", "card": card, "ms_per_step": ms, "ms_per_call": t,
        "calls_per_step": calls, "ms_per_step_by_part": per_step,
        "shares": {k: v / ms for k, v in per_step.items()},
        "rest_ms": ms - sum(per_step.values()),
        "note": "each part timed alone with CUDA events at the path's final state (host "
                "clock for the drift read, on an idle card); rest = step minus the parts: "
                "gravity, the position update, the interpolation's poison, the launch gaps "
                "while the host waits for the drift read"}), flush=True)

    plain_ms = {
        "pencil_spread": cuda_ms(lambda: tp.spread_pencil_fused_plain(
            kern, pos, f, shape, b, bins, slack=1), reps=3, warmup=1),
        "pencil_interp": cuda_ms(lambda: tp.interpolate_pencil_fused_plain(
            kern, pos, u, b, bins, slack=1), reps=3, warmup=1),
    }
    # the work this state needs: per particle, the nodes of each axis where
    # phi is nonzero (integers within support/2 of u), their product, times
    # C multiply-adds; the bytes: u, the values or outputs, pids, and the
    # field written (spread) or read (interpolation) once
    uu = tp._node_coords(pos, shape, b).double()
    half = kern.support / 2.0
    per_axis = torch.ceil(uu + half) - torch.floor(uu - half) - 1
    pairs = float(per_axis.prod(1).sum())
    C = 3
    ops_ms = 1e3 * 2.0 * C * pairs / PEAK_FP32_FLOPS
    field_bytes = 4 * C * math.prod(shape)
    part_bytes = 4 * (FCM_N * 3 + bins.pids.numel())
    bytes_ms = {"pencil_spread": 1e3 * (field_bytes + part_bytes + 4 * FCM_N * C) / PEAK_HBM_BYTES,
                "pencil_interp": 1e3 * (field_bytes + part_bytes + 4 * bins.pids.numel() * C)
                / PEAK_HBM_BYTES}
    rows = []
    for name, src, rep in (("pencil_spread", "pencil_spread.cu",
                            "uammd_tpu/solvers/pencil_ibm.py:450"),
                           ("pencil_interp", "pencil_interp.cu",
                            "uammd_tpu/solvers/pencil_ibm.py:572")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"uammd_tpu_torch/engine/csrc/{src}", "replaces": rep,
                     "launches": path["launches"][name], "max_abs_err": errs[name],
                     "ms": t[name], "plain_ms": plain_ms[name],
                     "bound_ms": max(bytes_ms[name], ops_ms),
                     "bound_by": "operations" if ops_ms > bytes_ms[name] else "bytes",
                     "library_ms": None, "node_pairs": pairs})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from uammd_tpu_torch.engine import (
            _build, kernel2, layout, md, md2, pair_kernel, rebin_kernel, update_kernel)
        from uammd_tpu_torch.solvers import pencil_ibm
        from uammd_tpu_torch.utils.lattices import lattice
    except ImportError as e:
        print(f"chip_smoke: the uammd_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # plain versions' matrix products in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}), flush=True)

    # 1. build
    build_s = _build.build()
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": sorted(p.name for p in _build.SRC_DIR.glob("*.cu"))}),
          flush=True)

    # 2. kernels against their plain versions
    # a 32^3 simple-cubic lattice at rho 0.5 (spacing 1.26), each site moved
    # by up to 0.2 per axis, so no pair is closer than 0.86 and the forces
    # stay of liquid size (uniform random positions put pairs at the 4e-3
    # clamp, where |f| ~ 1e17 would swamp a relative tolerance)
    n_small = 32768
    L_small = (n_small / 0.5) ** (1.0 / 3.0)
    rng = torch.Generator().manual_seed(7)
    jitter = (torch.rand((n_small, 3), generator=rng, dtype=torch.float64) - 0.5) * 0.4
    pos_small = lattice(n_small, L_small, "sc") + jitter.numpy()
    spec_small = layout.choose_spec(L_small, n_small, 2.5, pos=pos_small)
    vel = torch.randn((n_small, 3), generator=rng).numpy()
    gs_small = layout.pack(spec_small, pos_small, vel=vel, force=vel[::-1].copy(),
                           device=dev)
    err_small = check_pair(gs_small, "N=32768 jittered sc")
    moved = displaced(gs_small, 11)
    for q in (7, 10):
        check_rebin(moved, q, "N=32768 displaced")
    m = gs_small.mask
    crammed = gs_small.replace(**{k: torch.where(m, getattr(gs_small, k) * (0.1 / L_small),
                                                 getattr(gs_small, k)) for k in ("x", "y", "z")})
    count_c, over_c = check_rebin(crammed, 7, "crammed", expect_clean=False)
    check(over_c > 0 or count_c != n_small, "crammed: rebin latches overflow")
    check(bool(rebin_kernel.rebin_fast_noforce(crammed).overflow), "crammed: overflow flag")

    pos_fcc = lattice(N, BOX, "fcc")
    spec_fcc = layout.choose_spec(BOX, N, 2.5, pos=pos_fcc)
    jitter = torch.randn((N, 3), generator=rng, dtype=torch.float64).numpy() * 0.1
    gs_fcc = layout.pack(spec_fcc, pos_fcc + jitter, device=dev)
    err_fcc = check_pair(gs_fcc, "2^20 perturbed fcc")
    moved = displaced(gs_fcc, 12)
    for q in (7, 10):
        check_rebin(moved, q, "2^20 perturbed fcc displaced")
    del gs_fcc, moved, gs_small, crammed

    # the v2 kernels on tests/test_engine2.py:35's system (n 600, L 12, CAP
    # 8 below the largest occupancy, so about 100 particles are stragglers),
    # its fcc sites (nearest neighbours 1.41 apart) moved by a 0.15-sigma
    # Gaussian clipped to 0.2 per axis, so no pair is closer than 0.84 and
    # the largest force stays a few hundred
    n_s, L_s = 600, 12.0
    jit_s = (0.15 * torch.randn((n_s, 3), generator=rng, dtype=torch.float64)).clamp(-0.2, 0.2)
    pos_s = lattice(n_s, L_s, "fcc") + jit_s.numpy()
    spec_s = layout.choose_spec(L_s, n_s, 2.5, cap=8, pos=pos_s, n_strag=128)
    gs_s = layout.pack(spec_s, pos_s, vel=torch.randn((n_s, 3), generator=rng).numpy(),
                       device=dev)
    n_strag_s = int((gs_s.spid >= 0).sum())
    check(n_strag_s > 0, "n 600 CAP 8: the straggler list is used")
    all_modes = ((False, False), (False, True), (True, False), (True, True))
    v2_err = {"n600_strag": check_newton(gs_s, "n 600 stragglers", modes=all_modes)}
    fast_err = {"n600_strag": check_newton(gs_s, "n 600 stragglers", approx=True,
                                           tol=FAST_RECIP_TOL, slot_tol=FAST_RECIP_SLOT_TOL)}
    controls = check_newton_controls(gs_s, "n 600 stragglers")
    home, groups, _ = newton_pair(gs_s)
    check_fold(spec_s, home, groups, "n 600 stragglers")
    upd_err = {f"n600_{nz}": check_update(gs_s, home, groups, nz, "n 600 stragglers")
               for nz in update_kernel.NOISES}
    # tests/test_engine2.py:96-102's displacement: every particle by a
    # clipped 0.35-sigma Gaussian, so cells pass CAP and stragglers move
    dx = (0.35 * torch.randn(gs_s.x.shape, generator=rng).to(dev)).clamp(-1.0, 1.0) * gs_s.mask
    sdx = 0.35 * torch.randn(gs_s.spos.shape, generator=rng).to(dev) * (gs_s.spid >= 0)[:, None]
    moved_s = gs_s.replace(x=gs_s.x + dx, y=gs_s.y + 0.5 * dx, z=gs_s.z - 0.3 * dx,
                           spos=gs_s.spos + sdx)
    sep_s = check_sep_rebin(moved_s, "n 600 stragglers moved")
    check(sep_s[2] > 0, "n 600 stragglers moved: the mini-grid holds stragglers")
    r3 = rebin_kernel.rebin_fast3(moved_s)
    check(not bool(r3.overflow) and int((r3.pid >= 0).sum()) + int((r3.spid >= 0).sum()) == n_s,
          "n 600 stragglers moved: rebin_fast3 keeps every particle")
    crammed = gs_s.replace(**{k: torch.where(gs_s.mask, getattr(gs_s, k) * 0.05,
                                             getattr(gs_s, k)) for k in ("x", "y", "z")})
    check(bool(rebin_kernel.rebin_fast3(crammed).overflow),
          "crammed n 600: rebin_fast3 latches overflow")

    spec_fcc2 = layout.choose_spec(BOX, N, 2.5, pos=pos_fcc, n_strag=N_STRAG)
    gs_fcc2 = layout.pack(spec_fcc2, pos_fcc + jitter, device=dev)
    v2_err["n2^20_fcc"] = check_newton(gs_fcc2, "2^20 perturbed fcc")
    fast_err["n2^20_fcc"] = check_newton(gs_fcc2, "2^20 perturbed fcc", approx=True,
                                         tol=FAST_RECIP_TOL, slot_tol=FAST_RECIP_SLOT_TOL)
    home, groups, _ = newton_pair(gs_fcc2)
    check_fold(spec_fcc2, home, groups, "2^20 perturbed fcc")
    for nz in update_kernel.NOISES:
        upd_err[f"n2^20_{nz}"] = check_update(gs_fcc2, home, groups, nz, "2^20 perturbed fcc")
    sep_fcc = check_sep_rebin(displaced(gs_fcc2, 14), "2^20 perturbed fcc displaced")
    del gs_fcc2, home, groups, gs_s, moved_s, crammed, r3
    print(json.dumps({"phase": "kernels_vs_plain", "ok": True,
                      "pair_rel_err": {"n32768_jittered_sc": err_small, "n2^20_fcc": err_fcc},
                      "rebin": "exact at Q=7 and Q=10", "fcc_spec": list(spec_fcc.array_shape),
                      "newton_err": v2_err, "newton_fast_recip_err": fast_err,
                      "newton_controls_slot_err": controls, "slot_tol": SLOT_TOL,
                      "fast_recip_tol": FAST_RECIP_TOL,
                      "fast_recip_slot_tol": FAST_RECIP_SLOT_TOL, "fold": "bit-equal",
                      "update_max_abs_err_and_drift_err": upd_err,
                      "separable_rebin": "exact (out, mini, count, overflow)",
                      "n600_stragglers": n_strag_s, "n600_mini_stragglers": sep_s[2],
                      "fcc_v2_spec": list(spec_fcc2.array_shape),
                      "fcc_v2_mini_stragglers": sep_fcc[2]}), flush=True)

    fcm_errs = fcm_kernel_checks(dev)

    kernels = {"pair_force": pair_kernel.PAIR_FORCE, "rebin": rebin_kernel.REBIN,
               "newton_pair": kernel2.NEWTON_PAIR, "fold": kernel2.FOLD,
               "gj_fold_update": update_kernel.GJ_FOLD_UPDATE,
               "separable_rebin": rebin_kernel.SEP_REBIN}

    def zero_counts():
        for k in kernels.values():
            k.launches = 0

    # 3a. the v1 path: melt, then settle and timed steps on a fresh engine
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    md_melt = md.make_lj_md(BOX, N, dt=0.004, temperature=TEMPERATURE, pos=pos_fcc, device=dev)
    gs = md_melt.run(md_melt.init(pos_fcc, seed=0), MELT_STEPS)
    check(not bool(gs.overflow), "melt phase: no overflow")
    melted = layout.unpack(gs)[0].cpu().numpy()
    torch.cuda.synchronize()
    melt_s = time.perf_counter() - t0

    engine = md.make_lj_md(BOX, N, dt=0.01, temperature=TEMPERATURE, pos=melted, device=dev)
    gs = engine.run(engine.init(melted, seed=1), SETTLE_STEPS)
    torch.cuda.synchronize()
    before = {k: v.launches for k, v in kernels.items()}
    t0 = time.perf_counter()
    gs = engine.run(gs, TIMED_STEPS)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches_v1 = {k: v.launches for k, v in kernels.items()}
    timed_v1 = {k: launches_v1[k] - before[k] for k in kernels}
    total_steps = MELT_STEPS + SETTLE_STEPS + TIMED_STEPS
    n_kept, t_meas = gates(engine, gs, "v1 path", total_steps, launches_v1,
                           ["pair_force"], ["rebin"])
    check(all(bool(a.isfinite().all()) for a in layout.unpack(gs)), "v1: final state finite")
    ms_v1 = 1e3 * timed_s / TIMED_STEPS
    print(json.dumps({
        "phase": "main_path", "n": N, "box": BOX, "melt_steps": MELT_STEPS,
        "settle_steps": SETTLE_STEPS, "timed_steps": TIMED_STEPS,
        "melt_spec": list(md_melt.spec.array_shape), "timed_spec": list(engine.spec.array_shape),
        "melt_seconds": melt_s, "timed_seconds": timed_s, "ms_per_step": ms_v1,
        "particle_steps_per_s": N * TIMED_STEPS / timed_s,
        "temperature": t_meas, "particles_kept": n_kept, "overflow": False,
        "launches": launches_v1, "timed_launches": timed_v1,
    }), flush=True)

    # 3b. the v2 path, as bench.py:83-91 builds it, on the melted positions
    zero_counts()
    torch.cuda.synchronize()
    engine2 = md2.make_lj_md2(BOX, N, dt=0.01, temperature=TEMPERATURE, pos=melted,
                              n_strag=N_STRAG, noise="clt", fast_recip=True, device=dev)
    gs2 = engine2.run(engine2.init(melted, seed=1), SETTLE_STEPS)
    torch.cuda.synchronize()
    before = {k: v.launches for k, v in kernels.items()}
    t0 = time.perf_counter()
    gs2 = engine2.run(gs2, TIMED_STEPS)
    torch.cuda.synchronize()
    timed2_s = time.perf_counter() - t0
    n_strag_now = int((gs2.spid >= 0).sum())
    launches_v2 = {k: v.launches for k, v in kernels.items()}
    timed_v2 = {k: launches_v2[k] - before[k] for k in kernels}
    n_kept2, t_meas2 = gates(engine2, gs2, "v2 path", SETTLE_STEPS + TIMED_STEPS, launches_v2,
                             ["newton_pair", "gj_fold_update"], ["fold", "separable_rebin"])
    check(all(bool(a.isfinite().all()) for a in layout.unpack(gs2)), "v2: final state finite")
    ms_v2 = 1e3 * timed2_s / TIMED_STEPS
    print(json.dumps({
        "phase": "main_path_v2", "n": N, "box": BOX, "n_strag": N_STRAG, "noise": "clt",
        "fast_recip": True, "spec": list(engine2.spec.array_shape), "cap": engine2.spec.cap,
        "settle_steps": SETTLE_STEPS, "timed_steps": TIMED_STEPS,
        "timed_seconds": timed2_s, "ms_per_step": ms_v2,
        "particle_steps_per_s": N * TIMED_STEPS / timed2_s,
        "temperature": t_meas2, "particles_kept": n_kept2, "stragglers": n_strag_now,
        "overflow": False, "launches": launches_v2, "timed_launches": timed_v2,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }), flush=True)

    # 3c. the BDHI-FCM path, with its own zeroed launch counts
    fcm_path = fcm_main_path(dev, {"pencil_spread": pencil_ibm.SPREAD,
                                   "pencil_interp": pencil_ibm.INTERP})

    # 4. kernel times at each path's final shapes
    slot_bytes = 4 * engine.spec.n_slots
    spec = engine.spec
    g = md.lj_g()
    force = pair_kernel.make_pair_force_kernel(spec, g)
    err_liquid = check_pair(gs, "2^20 liquid")
    moved = displaced(gs, 13)
    check_rebin(moved, 7, "2^20 liquid displaced")
    stacked = stacked_of(moved, 7)
    rebin = rebin_kernel.make_rebin_kernel(spec)
    m = gs.mask
    pair_abs_err = max(
        float((a[m] - b[m]).abs().max())
        for a, b in zip(force(gs.x, gs.y, gs.z),
                        pair_kernel.pair_force_plain(spec, g, gs.x, gs.y, gs.z)))
    rebin_abs_err = float((rebin(stacked)[0] - rebin_kernel.rebin_plain(spec, stacked)[0])
                          .abs().max())
    pair_ms = cuda_ms(lambda: force(gs.x, gs.y, gs.z), reps=20)
    pair_plain_ms = cuda_ms(
        lambda: pair_kernel.pair_force_plain(spec, g, gs.x, gs.y, gs.z), reps=3, warmup=1)
    rebin_ms = cuda_ms(lambda: rebin(stacked), reps=20)
    rebin_plain_ms = cuda_ms(lambda: rebin_kernel.rebin_plain(spec, stacked), reps=3, warmup=1)
    pairs, pairs_in_cutoff = stencil_pairs(gs)
    pair_bytes_ms = 1e3 * 6 * slot_bytes / PEAK_HBM_BYTES
    pair_ops_ms = (1e3 * (OPS_PAIR_TEST * pairs + OPS_PAIR_FORCE * pairs_in_cutoff)
                   / PEAK_FP32_FLOPS)
    rebin_bytes_ms = 1e3 * (2 * 7 * slot_bytes + 8) / PEAK_HBM_BYTES
    del moved, stacked

    # the v2 kernels at the v2 path's final state, with its engine's options
    spec2 = engine2.spec
    slot2 = 4 * spec2.n_slots
    S = spec2.n_strag
    gk = md.lj_g_fused(rc2=RC2, approx=True)
    newton = kernel2.make_newton_pair_kernel(spec2, gk, self_half=True, strag_cellcenter=True)
    strag = kernel2.broadcast_stragglers(spec2, gs2.spos, gs2.spid)
    err_v2 = check_newton(gs2, "2^20 v2 liquid", approx=True, tol=FAST_RECIP_TOL,
                          slot_tol=FAST_RECIP_SLOT_TOL)
    out_k = newton(gs2.x, gs2.y, gs2.z, strag)
    out_p = newton_pair(gs2, plain=True)
    f_k = kernel2.fold_reactions_plain(*out_k[:2])
    f_p = kernel2.fold_reactions_plain(*out_p[:2])
    m2 = gs2.mask
    newton_abs_err = max(float((a[m2] - b[m2]).abs().max()) for a, b in zip(f_k, f_p))
    home, groups = out_k[0], out_k[1]
    fold = kernel2.make_fold_kernel(spec2)
    check_fold(spec2, home, groups, "2^20 v2 liquid")
    fold_abs_err = max(float((x - y).abs().max()) for x, y in zip(
        fold(home, groups), kernel2.fold_reactions_plain(home, groups)))
    upd = engine2.update
    a, grp, ref, step = update_inputs(gs2, home, groups, 31)
    # the straggler rows as GridMD2.step passes them
    strag2 = (gs2.spos, gs2.svel, gs2.sforce, gs2.spid)
    upd_abs_err = check_update(gs2, home, groups, "clt", "2^20 v2 liquid")[0]
    moved2 = displaced(gs2, 15)
    sep_liquid = check_sep_rebin(moved2, "2^20 v2 liquid displaced")
    st2, sst2 = stacked_of(moved2, 7), strag_stack_of(moved2)
    sep = rebin_kernel.make_separable_rebin(spec2)
    sep_abs_err = max(float((x - y).abs().max()) for x, y in zip(
        sep(st2, sst2)[:2], rebin_kernel.separable_rebin_plain(spec2, st2, sst2)[:2]))

    newton_ms = cuda_ms(lambda: newton(gs2.x, gs2.y, gs2.z, strag), reps=20)
    newton_plain_ms = cuda_ms(lambda: newton_pair(gs2, plain=True), reps=3, warmup=1)
    fold_ms = cuda_ms(lambda: fold(home, groups), reps=20)
    fold_plain_ms = cuda_ms(lambda: kernel2.fold_reactions_plain(home, groups), reps=5, warmup=1)
    upd_ms = cuda_ms(lambda: upd(*a, grp, *ref, step, strag2), reps=20)
    upd_plain_ms = cuda_ms(lambda: update_kernel.gj_fold_update_plain(
        spec2, upd.coef, "clt", *a, grp, *ref, step, strag2), reps=5, warmup=1)
    sep_ms = cuda_ms(lambda: sep(st2, sst2), reps=20)
    sep_plain_ms = cuda_ms(lambda: rebin_kernel.separable_rebin_plain(spec2, st2, sst2),
                           reps=3, warmup=1)
    pairs2, cut2 = stencil_pairs(gs2)
    newton_ops_ms = 1e3 * (OPS_PAIR_TEST * pairs2 + OPS_PAIR_FORCE * cut2) / PEAK_FP32_FLOPS
    newton_bytes_ms = 1e3 * (18 * slot2 + 28 * S) / PEAK_HBM_BYTES
    fold_bytes_ms = 1e3 * 18 * slot2 / PEAK_HBM_BYTES
    # the update reads 24 grids, [S, 3] spos, svel, sforce, [S] spid and the
    # step seed, and writes 6 grids, spos, svel and the drift
    upd_bytes_ms = 1e3 * (30 * slot2 + 64 * S + 8) / PEAK_HBM_BYTES
    # the separable rebin reads 7 grids and the [7, S] stragglers, writes 7
    # grids and the [7, nz, nyb, OCAP, NLANE] mini-grid
    mini_bytes = 4 * 7 * spec2.n_slots // spec2.cap * rebin_kernel.OCAP
    sep_bytes_ms = 1e3 * (2 * 7 * slot2 + mini_bytes + 7 * 4 * S + 8) / PEAK_HBM_BYTES

    per_step = {k: timed_v2[k] / TIMED_STEPS for k in kernels}
    kernel_ms = {"newton_pair": newton_ms, "fold": fold_ms, "gj_fold_update": upd_ms,
                 "separable_rebin": sep_ms}
    shares = {k: per_step[k] * v / ms_v2 for k, v in kernel_ms.items()}
    print(json.dumps({
        "phase": "breakdown_v2", "card": card, "ms_per_step": ms_v2,
        "launches_per_step": per_step,
        "kernel_ms_per_step": {k: per_step[k] * v for k, v in kernel_ms.items()},
        "shares": shares, "share_rest": 1.0 - sum(shares.values()),
        "newton_err_liquid": err_v2, "stencil_pairs": pairs2,
        "stencil_pairs_in_cutoff": cut2, "stragglers": n_strag_now,
        "separable_rebin_mini_stragglers": sep_liquid[2],
        "v1": {"ms_per_step": ms_v1, "pair_force_ms": pair_ms, "rebin_ms": rebin_ms,
               "launches_per_timed_step": {k: timed_v1[k] / TIMED_STEPS
                                           for k in ("pair_force", "rebin")},
               "pair_rel_err_liquid": err_liquid, "stencil_pairs": pairs,
               "stencil_pairs_in_cutoff": pairs_in_cutoff},
        "note": "kernel ms per step = kernel time (CUDA events, separate runs) x launches "
                "per timed step; shares are over the timed wall-clock ms per step",
    }), flush=True)

    def row(name, source, replaces, launches, err, ms, plain_ms, bytes_ms, ops_ms=0.0):
        return {"name": name, "route": "cuda",
                "source": f"uammd_tpu_torch/engine/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                "library_ms": None}

    rows = [
        row("pair_force", "pair_force.cu", "uammd_tpu/engine/pair_kernel.py:272",
            launches_v1["pair_force"], pair_abs_err, pair_ms, pair_plain_ms,
            pair_bytes_ms, pair_ops_ms),
        row("rebin", "rebin.cu", "uammd_tpu/engine/rebin_kernel.py:223",
            launches_v1["rebin"], rebin_abs_err, rebin_ms, rebin_plain_ms, rebin_bytes_ms),
        row("newton_pair", "newton_pair.cu", "uammd_tpu/engine/kernel2.py:447",
            launches_v2["newton_pair"], newton_abs_err, newton_ms, newton_plain_ms,
            newton_bytes_ms, newton_ops_ms),
        row("fold", "fold.cu", "uammd_tpu/engine/kernel2.py:531",
            launches_v2["fold"], fold_abs_err, fold_ms, fold_plain_ms, fold_bytes_ms),
        row("gj_fold_update", "gj_fold_update.cu", "uammd_tpu/engine/update_kernel.py:301",
            launches_v2["gj_fold_update"], upd_abs_err, upd_ms, upd_plain_ms, upd_bytes_ms),
        row("separable_rebin", "sep_rebin.cu",
            "uammd_tpu/engine/rebin_kernel.py:904,920,934",
            launches_v2["separable_rebin"], sep_abs_err, sep_ms, sep_plain_ms, sep_bytes_ms),
    ]
    rows += fcm_breakdown(fcm_path, card, fcm_errs)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
