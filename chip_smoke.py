#!/usr/bin/env python3
"""GPU smoke run of uammd_tpu_torch, the PyTorch/CUDA port of uammd_tpu.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc.
Imports nothing of JAX or of the JAX package. Phases:

1. Build every CUDA kernel of the port from ``uammd_tpu_torch/engine/csrc``
   (one nvcc per source, all started together) into the git-ignored
   ``uammd_tpu_torch/_build/``.
2. Hold each kernel against its plain PyTorch version on the card:
   - pair force: max|df| / max|f| < 1e-5 (float32 sums in another order),
     on a jittered simple-cubic lattice at N = 32768, rho 0.5 (no pair
     closer than 0.86), on a perturbed fcc lattice at the 2^20 benchmark
     spec and on the final liquid;
   - rebin, Q = 7 and Q = 10, after random displacements below the drift
     threshold: ``out``, ``count`` and ``overflow`` exactly equal; a crammed
     configuration must latch overflow.
3. The main path at full size, as bench.py's LJ protocol runs it: N = 2^20,
   box 128^3 (rho 0.5), rcut 2.5, T 1.5; melt 300 steps at dt 0.004 from
   the fcc lattice, then a fresh engine on the melted positions at dt 0.01:
   100 settle steps and 200 timed steps. Every kernel launch count is set
   to 0 before the melt and read after the timed steps. Requires no
   overflow, all particles kept, T within 20 % of 1.5, and every kernel of
   the path launched.
4. Time each kernel and its plain version (CUDA events, after warm-up) on
   the final liquid state, check them against each other once more there,
   and print the kernels' JSON line.

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
MELT_STEPS, SETTLE_STEPS, TIMED_STEPS = 300, 100, 200

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


def displaced(gs, seed: int):
    """Every particle moved by less than the drift threshold per axis."""
    import torch

    gen = torch.Generator(device=gs.device)
    gen.manual_seed(seed)
    step = 0.99 * gs.spec.drift_threshold / math.sqrt(3.0)
    m = gs.mask

    def move(a):
        u = torch.rand(a.shape, generator=gen, device=a.device) * 2.0 - 1.0
        return a + step * u * m

    return gs.replace(x=move(gs.x), y=move(gs.y), z=move(gs.z))


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


def stencil_pairs(gs) -> tuple[int, int]:
    """Unordered pairs of distinct particles in one 27-cell stencil of this
    state, and those of them within the cutoff: the work the pair force's
    data needs. Each pair is seen from both ends, so the ordered counts are
    halved."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from uammd_tpu_torch.engine import _build, layout, md, pair_kernel, rebin_kernel
        from uammd_tpu_torch.utils.lattices import lattice
    except ImportError as e:
        print(f"chip_smoke: the uammd_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
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
    print(json.dumps({"phase": "kernels_vs_plain", "ok": True,
                      "pair_rel_err": {"n32768_jittered_sc": err_small, "n2^20_fcc": err_fcc},
                      "rebin": "exact at Q=7 and Q=10", "fcc_spec": list(spec_fcc.array_shape)}),
          flush=True)

    # 3. the main path: melt, then settle and timed steps on a fresh engine
    kernels = {"pair_force": pair_kernel.PAIR_FORCE, "rebin": rebin_kernel.REBIN}
    for k in kernels.values():
        k.launches = 0
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
    launches = {k: v.launches for k, v in kernels.items()}
    timed_launches = {k: launches[k] - before[k] for k in kernels}

    n_kept = int((gs.pid >= 0).sum())
    t_meas = float(engine.temperature_of(gs))
    total_steps = MELT_STEPS + SETTLE_STEPS + TIMED_STEPS
    check(not bool(gs.overflow), "timed phase: no overflow")
    check(n_kept == N, f"all particles kept: {n_kept} == {N}")
    check(math.isfinite(t_meas) and abs(t_meas - TEMPERATURE) < 0.2 * TEMPERATURE,
          f"temperature {t_meas:.4f} within 20 % of {TEMPERATURE}")
    check(launches["pair_force"] >= total_steps,
          f"pair kernel launched {launches['pair_force']} >= {total_steps} times")
    check(launches["rebin"] >= 1, f"rebin kernel launched {launches['rebin']} >= 1 times")
    check(all(bool(a.isfinite().all()) for a in layout.unpack(gs)), "final state finite")
    ms_per_step = 1e3 * timed_s / TIMED_STEPS
    print(json.dumps({
        "phase": "main_path", "n": N, "box": BOX, "melt_steps": MELT_STEPS,
        "settle_steps": SETTLE_STEPS, "timed_steps": TIMED_STEPS,
        "melt_spec": list(md_melt.spec.array_shape), "timed_spec": list(engine.spec.array_shape),
        "melt_seconds": melt_s, "timed_seconds": timed_s, "ms_per_step": ms_per_step,
        "particle_steps_per_s": N * TIMED_STEPS / timed_s,
        "temperature": t_meas, "particles_kept": n_kept, "overflow": False,
        "launches": launches, "timed_launches": timed_launches,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }), flush=True)

    # 4. kernel times on the final liquid state (the timed engine's shapes)
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

    slot_bytes = 4 * spec.n_slots
    pairs, pairs_in_cutoff = stencil_pairs(gs)
    pair_bytes_ms = 1e3 * 6 * slot_bytes / PEAK_HBM_BYTES
    pair_ops_ms = (1e3 * (OPS_PAIR_TEST * pairs + OPS_PAIR_FORCE * pairs_in_cutoff)
                   / PEAK_FP32_FLOPS)
    rebin_bytes_ms = 1e3 * (2 * 7 * slot_bytes + 8) / PEAK_HBM_BYTES
    per_step = {k: timed_launches[k] / TIMED_STEPS for k in kernels}
    share_pair = per_step["pair_force"] * pair_ms / ms_per_step
    share_rebin = per_step["rebin"] * rebin_ms / ms_per_step
    print(json.dumps({
        "phase": "breakdown", "card": card, "ms_per_step": ms_per_step,
        "launches_per_step": per_step,
        "share_pair_force": share_pair, "share_rebin": share_rebin,
        "share_rest": 1.0 - share_pair - share_rebin,
        "pair_rel_err_liquid": err_liquid, "stencil_pairs": pairs,
        "stencil_pairs_in_cutoff": pairs_in_cutoff,
        "padded_pair_slots": 27 * spec.cap * spec.n_slots,
        "pair_bound_ms": {"bytes": pair_bytes_ms, "operations": pair_ops_ms},
        "note": "shares are kernel times (CUDA events, separate runs) x launches per "
                "timed step over the timed wall-clock ms per step",
    }), flush=True)

    rows = [
        {"name": "pair_force", "route": "cuda",
         "source": "uammd_tpu_torch/engine/csrc/pair_force.cu",
         "replaces": "uammd_tpu/engine/pair_kernel.py:272",
         "launches": launches["pair_force"], "max_abs_err": pair_abs_err,
         "ms": pair_ms, "plain_ms": pair_plain_ms,
         "bound_ms": max(pair_bytes_ms, pair_ops_ms),
         "bound_by": "operations" if pair_ops_ms >= pair_bytes_ms else "bytes",
         "library_ms": None},
        {"name": "rebin", "route": "cuda",
         "source": "uammd_tpu_torch/engine/csrc/rebin.cu",
         "replaces": "uammd_tpu/engine/rebin_kernel.py:223",
         "launches": launches["rebin"], "max_abs_err": rebin_abs_err,
         "ms": rebin_ms, "plain_ms": rebin_plain_ms,
         "bound_ms": rebin_bytes_ms, "bound_by": "bytes", "library_ms": None},
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
