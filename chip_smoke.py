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
     crammed configuration must latch overflow; with a NaN and an infinite
     coordinate the same (out, count, overflow) as plain;
   - the rebins on the faces of the box (``rebin_face_checks``): at each
     path's own box and grid (v1, the v2 spec with stragglers, DPD, SPH,
     the PSE near grid), a packed, sub-drift displaced state with
     particles moved onto every float32 value within 8 ulps of -L/2 and
     +L/2 where the TPU kernels' rule (the image-shifted coordinate tested
     before it wraps) loses a particle, claims it twice or stores another
     representative (``face_values``, a float32 replica): #3 (Q 7, 10),
     or #4 and #5, exactly equal to their plain versions, every particle
     kept, and each rebin's positions equal by pid to the sort rebin's;
     the control, that rule's plain replica on the same state, must lose
     or move a particle;
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
   - fused fold + G-J update at T = 1.5 on identical counter noise, through
     its stacked entry (the Newton output as one [15, ...] buffer, as
     ``GridMD2`` hands it over): "clt" bit-equal with an equal drift, "bm"
     within ``BM_TOL`` (the card's logf/sinf/cosf against PyTorch's), on
     the n 600 straggler system, the 2^20 fcc state and the v2 path's final
     liquid; two controls that must fail the "clt" check: the plain update
     with the seed off by one, and the drift with the launch block that
     holds its maximum dropped;
   - separable rebin #5 (one classify-and-pull launch pair) after a
     displacement with stragglers present: ``out``, ``mini``, count and
     overflow exactly equal; a crammed state latches overflow through
     ``rebin_fast3``; then (``sep_rebin_checks``) the n 600 moved state of
     tests/test_torch_sep_rebin_pull.py exactly equal, three states that
     overflow CAP + OCAP in only the z pass's intermediate, only the y
     pass's or only the final cell, where the kernel must flag overflow
     exactly when plain does, the y state one particle short exactly
     equal, and two controls that must change the output (the kernel
     ranking in #3's (dz, dy, dx) order, and the straggler rows ranked
     last); #5 is also held exactly to plain on every rebin of the
     unfused path's settle steps and of the 1-shard DD2 path, at Q 4 on
     the PSE near grid, and on each state its rows are timed at; ptxas
     must report no spill in any instance of #3, #4, #5, the folds, #11
     and #12;
   - pencil spread and interpolation (kernels #13/#14 of the BDHI-FCM
     path): max|d| <= ``PENCIL_TOL`` x max|ref| at n 5000, L 24, 32^3 for
     the Gaussian, Peskin 3- and 4-point and ES/BM windows, slack 0 and 1,
     and on the FCM path's first state (131072 particles, 384^3, support
     14, slack 1). Two controls must fail that bound by 100x: the spread
     with one particle's values dropped and the interpolation of a field
     shifted by one node. ``FCM.grid_velocity`` and ``interpolate_auto``
     must go through the same kernels (one launch each) and agree with
     the plain versions at n 4200, 48^3; on a 36^3 grid (tile-safe, not
     pencil-safe) at n 8192 ``spread_auto`` and ``interpolate_auto`` must
     launch no pencil kernel, equal the tiled path bit for bit and agree
     with the direct path within ``PENCIL_TOL`` (the same two controls). The fcc start on the 384^3 grid
     must overflow the pencil cap and NaN-poison the mobility. Then
     (``pencil_tile_checks``) the same bound on grids two pencils wide
     (16 x 16 x 32), a 24 x 16 grid, nz = support (8 and 4) and C = 1, 4,
     5 and 8; in each case and on the FCM path's first state the spread
     launched into a NaN-filled field must leave no NaN and two spreads
     must be bit-equal; ptxas must report no spill in any instance, and the
     spread's SASS must hold no global atomic (the interpolation's count
     is the control that the search finds them).
   - the channel kernels of the PSE near field (``pse_kernels_vs_plain``):
     the 27-stencil channel kernel #2, the Newton channel kernel #10 (with
     the n-channel fold #9) and #9 alone against their plain versions at 1
     and 2 stacked 3-vectors, within ``CHANNEL_TOL`` x max|ref|, on
     tests/test_pse_engine.py:536's n 512 clump system (17 stragglers) and
     on the PSE path's first packed state; #9's stacked entry on #10's
     buffer bit-equal to plain at 3 and 6 channels (and at the path's final
     state); #10 against #2 on the card, #7 against #9 at n = 3, and three
     controls that must fail the bound (the stragglers dropped, a reaction
     group rolled the wrong way, #10's candidate loops one row short), and
     one that must fail #9's bit-equality (the groups added in the reverse
     order); #10 with one x = NaN: NaN in exactly
     the plain version's entries; whether two #10 calls give the same bits
     (printed); #5 (n_q 4, ocap 16), #6 and #7 at the PSE grid's shape
     (NLANE 114, S 192).
   - slice D (``slice_d_kernels_vs_plain``): #2 with each of its five new
     functors (DPD at the step counter 7, SPH density, SPH force, LJ
     mixture, masked LJ mixture) and #1 with energy, virial and stress on,
     within ``CHANNEL_TOL`` x max|ref| of their plain versions on small
     jittered systems (n 4000-4096) and on tests/test_mixtures.py:67's
     hierarchy at 8x its counts; controls that must fail that bound: DPD
     hashed with the step off by one, SPH's force with p_j dropped, the
     masked mixture with its mask ignored, #1's energy not halved; #1's
     trace(stress) = virial; the Lanczos sqrt(T) e1 kernel against eigh
     with the clamp on indefinite tridiagonals (within ``SQRT_TOL``).
   - slice A3 (``unfused_kernel_checks``): the G-J update from folded
     forces #11 against its plain version on identical counter noise at
     T = 0 and T = 1 on the 2^20 perturbed fcc state at the v2 spec and on
     the n 600 straggler system, within ``UNFUSED_TOL`` x max|ref|; the
     one-shot straggler rebin #4 on the moved n 600 system: ``out``,
     ``mini``, count and overflow exactly equal, every particle kept, and
     ``rebin_fast2`` equal by pid to ``rebin_fast3`` and the sort rebin.
     Controls: #11 with the seed off by one must fail the bound; #4 without
     its straggler block must lose the stragglers from its count. The
     drift of #11 and #12 (``drift_rule_checks``, JAX's select rule) on
     both states with one slot 0.9 from its reference and, in turn, x =
     NaN on an occupied slot, fy = NaN on one and wz = NaN on an empty one:
     equal to plain bit for bit and NaN exactly where plain is (the NaN
     force), at T = 0 (#11, #12 "clt") and T = 1.5 (#12 "clt"); #11's
     straggler-drift option (float32 pid + 1, references ``sref``) with a
     NaN on an occupied and on an empty row; two controls that must fail
     somewhere: the old ``fmaxf`` rule's replica and the ``0 x NaN``
     rule's.
   - slice E1 (``poisson_checks``): #2 with the Poisson functor against its
     plain version on the electrolyte's packed state, without and with 64
     straggler rows (``CHANNEL_TOL``), the straggler spec's near field
     against the straggler-free one (``CHANNEL_TOL``), a control (the
     candidates' charges dropped) that must fail; the isolated-charge Wigner energy (rtol
     2e-3) and the two-charge Newton-3 check on the card.
   - slice G1 (``dd_kernel_checks``, ``dd_force_parity``): the halo modes
     of the z-slab domain decomposition against their plain versions: #6
     ``halo_z`` on every shard of tests/test_domain2.py:25's clump system
     (n 2400, 24 straggler rows a shard) and of the melted 2^20 liquid on 4
     shards, every slot within ``SLOT_TOL`` (control: the ghost rows
     emptied); the halo fold #8 bit-equal, in the list form and through
     the stacked entry the path calls (control: recv zeroed); #1 and #2
     (DPD, SPH density, SPH force) on shard 0's halo-extended slab within
     1e-5 and ``CHANNEL_TOL`` (control: the ghost rows' image shift
     dropped). The assembled DD force on one state against the single-chip
     engines' within ``DD_FORCE_TOL`` x max|f|: DD2 on 1 and 4 shards
     (stragglers too), DD v1 on 4.
   - ragged occupancy (``ragged_kernel_checks``, the cell-warp kernels):
     #1 (force-only, halo, observables) and #6 (the four self_half x
     cellcenter modes, exact and approximate reciprocal, and ``halo_z``)
     against their plain versions within the tolerances above, on seeded
     states at NLANE 114, 48 and 16 with CAP 40: occupancies from 0 to
     CAP, one cell full to CAP (a second warp pass), one empty (z, yb)
     column, occupied rows that are not a prefix, 16 straggler rows, and
     for #1 a particle with x = NaN whose NaN must land in exactly the
     plain version's slots. Controls: each kernel with its candidate loops
     one row short of the occupancy must fail the bound. Every launch plan
     (``pair_kernel.pair_launch_plan``, ``kernel2.newton_launch_plan``) is
     printed (``launch_plans``) with the kernel's own count of its shared
     memory, which must equal the plan's.
   - ragged occupancy of #2 (``ragged_channel_checks``): every functor
     (DPD, SPH density and force, LJ mixture and masked, Poisson and PSE at
     1 and 2 vectors, the last two with 15 valid straggler rows and an
     invalid one) on three seeded states with cells of 3.0 and cutoffs of
     2.9: NLANE 114 at CAP 40 (occupancies 0-40), a small-cell state (CAP
     16, mean <= 8) and a large-cell one (CAP 160, mean >= 100), each with
     an empty (z, yb) column and a cell full to CAP; periodic and, for the
     straggler-free functors, in the halo mode on the state with a ghost
     row above; clean and with one x = NaN, whose NaN must land in exactly
     the plain version's slots and sums (grids and straggler totals). Each
     within ``CHANNEL_TOL`` of max|ref| (SPH's force: of sum_j |term|);
     control: the candidate loops one row short must fail it. The plans
     (``pair_kernel.channel_launch_plan``) are printed with the kernel's own
     shared memory and threads, which must equal the plan's.
   - slice G2a (``g2_kernels_vs_plain``): the three kernel modes of the
     composed multi-shard PSE steps against their plain versions on every
     shard of a 4-shard mesh: #2 with the PSE functor in the halo mode over
     the combined own + neighbour straggler rows (the reverse sums of the
     slab's interior rows only), #2 with the fused LJ radial force
     (``pair_kernel.RadialForce``, halo mode, straggler rows) and #1 with
     the fused LJ radial (halo mode), on __graft_entry__.py strategy 8's
     clump system (n 2048, 10 real straggler rows) and on the full path's
     first state, clean and with one x = NaN (NaN in exactly the plain
     version's entries and straggler sums), within ``CHANNEL_TOL`` (#1:
     ``PAIR_FUSED_TOL``) of max|ref|. Controls on the clump that must fail
     the bound by 100x: the straggler rows dropped, the ghost rows counted
     into the straggler partials (the periodic entry), the candidate loops
     one row short (``occ_trim`` 1).
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
   - BDHI-PSE (``main_path_pse``): bench.py:104-276's PSE protocol at its
     defaults (N = 131072, volume fraction 0.05, fcc start, far grid 144,
     tolerance 1e-4, 192 straggler rows, Lanczos tuned to 1e-3, WCA pair
     force, dt 0.01, T 1): 40 warm-up and 40 timed persistent steps, one
     retry with n_strag x2 and far_cap_extra 24 on overflow. Gates: no
     overflow, finite positions, #10 and #9 launched at least m times per
     step and #6, #7, #13, #14 once, #5 in the timed window, one host read
     per step, the T = 0 displacement against dt x compute_mf, the
     persistent layout against a fresh pack, the sqrt identity, split
     invariance (far grid 144 against 128) and fluctuation-dissipation
     against Hashimoto's self-mobility.
   - DPD (``main_path_dpd``): Groot-Warren water (A 25, gamma 4.5, kT 1,
     rc 1) at N = 2^20, number density 3, from a jittered fcc lattice with
     Maxwellian velocities of zero net momentum, dt 0.01: 100 warm-up and
     200 timed steps. Gates: no overflow, all particles kept, the mean
     kinetic T of the timed steps within 5 % of 1, |total momentum| / N <
     1e-4, #2 once per step, #3 on drift, one host read per step.
   - SPH (``main_path_sph``): examples/dambreak.py:40-41's fluid (support
     1, viscosity 20, gas stiffness 15, rest density 1.2) as a periodic
     bulk at the dam's spacing 0.8 (N = 2^20), velocities 0.3 N(0, 1) of
     zero net momentum, dt 0.004: 100 + 200 steps. Gates: no overflow,
     finite state, |total momentum| / N < 1e-4, both #2 sweeps once per
     step, one host read per step.
   - ``MixtureLJ.forces`` on tests/test_mixtures.py:32's binary at N = 2^20
     (number density 0.3) and the hierarchy, against plain and timed;
     ``lj_pressure`` on the v2 path's final state (P and E finite, #1's
     observable mode launched, checked against plain there).
   - v2 unfused (``main_path_v2_unfused``): ``make_lj_md2(fold_in_update=
     False)`` on the melted liquid as the v2 path: 100 settle and 200 timed
     steps. Gates: those of the v2 path, #6, #7 and #11 once per timed
     step, #12 never, #5 on drift, one host read per step. In the settle
     steps every state the engine hands its rebin also goes through
     ``rebin_fast2`` (#4), which must keep the same particles by pid as
     the engine's ``rebin_fast3`` and the sort rebin; #4 against its plain
     version on the last
     of them and on the final liquid after a sub-cell drift, and #11 on
     the final liquid; #7 + #11 against #12 on one
     Newton output (``UNFUSED_TOL``, bit-equality reported); the fused
     engine ("bm") against the unfused one for ``FUSED_STEPS`` steps from
     one state: the same rebin steps and positions within ``fused_bound``.
   - Poisson (``main_path_poisson``): the electrolyte (N = 131072 charges
     of +-1 in a 192^3 box, gw 0.4, split 0.175 by generic_md.py:186-190's
     rule: a 96^3 far grid and a [10, 3, 216, 30] near grid) under
     ``brownian.euler_maruyama`` with ``PoissonSplit.sum`` as the force, dt
     0.001: 20 warm-up and 100 timed steps. Gates: finite state, no near
     overflow, |sum F| / (N rms F) < ``SUM_F_TOL``, #2 (Poisson), #13 and
     #14 once per timed step; host reads per step printed. Split
     invariance at the first configuration: splits 0.175 (with and without
     stragglers) and 0.25 against the no-split solver (640^3), energies
     within 2e-2 relative and forces within 2e-3 x max|f|.
   - DD2 (``main_path_dd2_4``, ``main_path_dd2_1``): ``make_lj_domain2``
     on the melted liquid (n_strag 16 a shard, the exact reciprocal, "bm")
     on 4 shards of this one card (nz 40) and on 1 shard: 100 settle + 200
     timed steps. Gates: T within 20 % of 1.5, ``ovf`` 0 on every shard and
     the count audit N, finite state, #6 ``halo_z``, #8 and #11 once per
     shard per step, #6/#7/#12 never, #5 (1 shard) or the two-sort rebin
     (4 shards) on drift, at most one host read per step outside rebins.
     #11 on each DD2 path's final state against its plain version as the
     step calls it (the rows' float32 pid + 1 and references;
     ``dd_update_row``: occupied slots within ``UNFUSED_TOL``), #6
     ``halo_z`` on the 1-shard path's final state against its plain
     version (``newton_halo_1_shard_row``).
     ``dd2_trajectory_parity``: DD2 on 4 shards against the single-chip
     unfused engine at T = 0 with a rebin forced at step 1, within 1e-5
     after 2 steps. DD v1, DPD and SPH (``main_path_dd_v1``, ``_dpd``,
     ``_sph``) on 4 shards: 50 + 100 steps; no overflow, count N, finite;
     v1 T within 20 % of 1.5, DPD mean kinetic T within 5 % of 1, DPD and
     SPH |total momentum| / N < 1e-4; #1 / #2 halo once (SPH: twice) per
     shard per step. On one card the exchanges are device-local copies: a
     mesh measures the halo machinery and the migration, not interconnect
     traffic (``breakdown_dd2``).
   - G2a (``main_path_pse_dd2_4``, ``_1``, ``main_path_pse_dd``): the
     composed multi-shard PSE steps of ``parallel/pse_dd2.py`` (persistent
     sharded slots, ``G2_STRAG`` = 192 straggler rows a shard) on 4 shards
     and on 1, and ``parallel/pse_dd.py`` (replicated pack, no stragglers)
     on 4, at bench.py's PSE size (N = 131072, volume fraction 0.05, fcc
     start, far grid 144 on x-slabs, tolerance 1e-4, Lanczos m = 4, the
     WCA with the exact reciprocal, dt 0.01, T 1, nz a multiple of 4):
     20 + 40 steps each. Gates: ``ovf`` 0 and the count audit (pse_dd2), no
     overflow (pse_dd), a rebin in pse_dd2's timed window (forced if none
     fires), finite state, the rms displacement within 0.2-8x
     sqrt(2 kT m0 dt steps) (tests/test_pse_dd.py:158-164), each new
     mode's launches exactly as predicted (per shard per step: 1 + m #2
     PSE halo launches, one #2 radial or #1 fused halo launch, one Lanczos
     sqrt). ``g2_parity``: at T = 0 pse_dd's step
     against the single-grid ``displacement_with_pair_force`` on the dimer
     system at N = 131072 (forces within 1e-4 max(fscale, 1), positions
     within 2e-4 max(dscale, 1)), pse_dd2 on the clump system on 4 and 2
     shards against the single-grid steps, 3 + 3 steps through a forced
     rebin (positions within 1e-4), and the far bucket control (far_m2 = 8
     must latch ``ovf``). ``breakdown_pse_dd2``: CUDA events around each
     phase of the pse_dd2 step (drift read, rebin, ghosts, pair force,
     matvec x (1 + m), Lanczos, bucketing, far field, update) and the host
     reads per step.
   - the general path (``general_path``, slice C): the README quick
     start's protocol on the v1 melt's final state: ``lj(cutoff=2.5)``
     unshifted in float32 over ``build_neighbor_list(skin_multiplier=1.2)``
     and ``ensure_capacity``, ``nvt_gronbech_jensen`` at dt 0.01, T 1.5,
     friction 1: 100 settle and 200 timed steps, each timed step ended by
     a synchronize (ms/step is their median). Gates: no overflow, finite
     pos, vel and force, T within 20 % of 1.5, at least one rebuild in the
     timed steps, one host read a step (also in a step that rebuilds).
     Checks at the start state: the forces by pid against #1's on the v1
     GridState (one launch) within ``GEN_FORCE_TOL`` x max|f|, the
     particles within 1e-5 of a face and their partners, and the pairs
     whose r2 lies within ``GEN_RC2_WINDOW`` of rc^2 (where the unshifted
     force jumps by 0.039 and the two paths' roundings of r2 may fall on
     either side), left out and counted; control: a list of radius 2.4 must fail the bound; the list
     against brute force (the same partners within 3.0) for 4096 sampled
     particles; the dense NBody path against the list path at N = 16384
     within 1e-5. Each layer (cell list, rebuild, ``apply_pairs``, the
     drift test and its read, the G-J update) timed alone. The path runs
     no hand kernel: the JAX general path has no ``pallas_call``.
   - slice C2 (``c2_phases``), each path with its counts zeroed just
     before: the list PSE (``list_pse_path``) on bench.py:116-123's system
     (N = 131072, volume fraction 0.05, fcc start), WCA over a Verlet list,
     ``bdhi_euler_maruyama`` over ``PSE.create(tolerance=1e-4)`` (far grid
     280^3 through #13/#14) at dt 0.01, T 1: 5 + 20 steps, each timed one
     ended by a synchronize. Gates: M F against the grid engine's T = 0
     displacement at the fcc state within ``C2_MF_RMS`` (RMS; control: the
     near field dropped), the mean square displacement of the timed steps
     within ``FDT_TOL`` of 2 T dt m_self per axis, #13 once, #14 twice and
     the Lanczos sqrt once a step, #13/#14 against their plain versions at
     this far grid with the two controls; each layer timed alone. Dense
     RPY (``dense_rpy_path``): ``CholeskyBDHI`` at N = 2048 and
     ``LanczosBDHI`` at N = 8192 from fcc, 3 + 10 steps; at N = 2048 the two
     M F within ``DENSE_MF_TOL`` and Lanczos' M^(1/2) z (m 24) within
     ``LANCZOS_ROOT_TOL`` of eigh's (control: m 2). Rotational FCM
     (``rotational_fcm_path``): ``bdhi_fcm_rotational`` on the FCM path's
     suspension with seeded forces and torques at T 1, 5 + 20 steps: |q|
     within ``QUAT_TOL`` of 1, #13/#14 twice a step, the T = 0 velocities
     through the kernels against the plain pencils within ``PENCIL_TOL``;
     one torqued particle's rotational self-mobility printed against
     1/(8 pi). The list SPH (``list_sph_path``) against #2's two sweeps by
     pid at the grid SPH path's final state, within ``SPH_LIST_TOL`` of
     the largest sum_j |term| (control: no viscosity), then
     ``make_sph_force_fn`` under ``nve``, 5 + 20 steps. Deserno
     (``deserno_path``): ``build_bilayer(64)`` under ``leimkuhler`` at dt
     2e-4, T 0.9, 20 + 100 steps, tests/test_support_subsystems.py:140's
     gates, and the list's forces against all pairs on
     ``build_bilayer(16)`` within 1e-5.
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
   print the v2, FCM, PSE, DPD, SPH, unfused v2 and Poisson steps'
   breakdowns and the kernels' JSON line (thirteen kernels, the six new
   functors of #2, #1's observable mode, the Lanczos sqrt kernel, slice
   G1's #6 ``halo_z`` (4 shards and 1), #8, #11, #1 halo and #2 halo rows
   (the rows of #11 and #4 with the profiler's device time, warm and with
   the L2 flushed, #11's also with its host time a launch; #7's the same
   at the v2 path's final state, and at the unfused and PSE paths' in
   ``v2_unfused_path_times`` and ``pse_path_times``), slice G2a's #2 PSE
   halo, #2 radial halo and #1 fused halo rows, #13 and #14 at the PSE
   and Poisson far fields besides FCM's, and #3 at the DPD and SPH paths'
   final states besides v1's, each with its launch plan).

``--only-pse`` runs the build and the PSE phases alone, ``--only-slice-d``
the build and slice D's phases (the observables on the v2 engine's
jittered fcc start), ``--only-unfused`` the build, slice A3's checks, the
v1 melt and the unfused v2 path, ``--only-poisson`` the build and slice
E1's phases, ``--only-dd`` the build, the v1 melt and slice G1's phases,
``--only-ragged`` the build and the ragged-occupancy checks of #1, #6 and #2,
``--only-g2`` the build and slice G2a's checks and paths, ``--only-pencil``
the build, the pencil kernels' checks, the FCM path and the #13/#14 rows
at the Poisson and PSE far fields' first states, ``--only-rebin`` the
build, the face checks, #3's and #5's checks and their rows at the v1,
DPD and SPH grids (#3) and the v2 spec and PSE near grid (#5) (their
packed starts, displaced), ``--only-update-fold`` the build, #12's checks,
the v1 melt, the v2 path, #9's checks (with the PSE channel kernels'), the
PSE path and the rows of #12, #10 and #9, ``--only-general`` the build,
the v1 melt and the general path, ``--only-c2`` the build, the auto
dispatch's checks, the SPH path and slice C2's phases; none prints a
result line (for work on those paths).

The last line is ``{"ok": true, "device": {...}}``; any failed check raises
before it and the exit code is not 0. Without a GPU it exits with code 2
and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
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
# interpolation), and the largest difference over the 1.7e8 outputs of the
# 384^3 field is an extreme of many: 5.7e-6 for the spread and 2.7e-6 for
# the interpolation on the path's first state, 6.2e-7 at 32^3 (a first
# chip run; the phase also prints both against float64 plain versions).
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


def host_us(fn, n: int = 100, rounds: int = 5) -> float:
    """Host time of one call of ``fn`` in microseconds: ``n`` calls issued
    without a sync (fewer launches than the launch queue holds), the median
    over ``rounds``."""
    import statistics
    import torch

    for _ in range(3):
        fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append(1e6 * (time.perf_counter() - t0) / n)
    torch.cuda.synchronize()
    return statistics.median(per)


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
                spid=None, occ_trim=0):
    """The Newton kernel's (or its plain version's) outputs on ``gs``;
    ``spid`` replaces the state's straggler ids (-1 drops a row);
    ``occ_trim`` 1 is the control that stops the kernel's candidate loops
    one row short."""
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
    kern.occ_trim = occ_trim
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


def update_grid(spec, strag_rows: int, name: str = "gj_fold_update") -> dict:
    """#12's (or, with ``name`` "gj_update", #11's) launch geometry as its
    library reports it (``uammd_<name>_grid``)."""
    from uammd_tpu_torch.engine import _build

    nz, nyb, cap, nlane = spec.array_shape
    dims = (ctypes.c_int * 4)()
    getattr(_build.load(name), f"uammd_{name}_grid")(
        ctypes.c_int(nz), ctypes.c_int(nyb), ctypes.c_int(cap * nlane),
        ctypes.c_int(strag_rows), dims)
    return dict(zip(("blocks_x", "block_rows", "threads", "slots_a_thread"), dims))


def update_block_of(spec, strag_rows: int = 0):
    """The launch block of #12 that updates each slot (a block row per (z,
    yb), ``threads`` x ``slots_a_thread`` slots a block along the plane), as
    an int64 grid."""
    import torch

    g = update_grid(spec, strag_rows)
    nz, nyb, cap, nlane = spec.array_shape
    rows = torch.arange(nz * nyb, dtype=torch.int64)[:, None]
    cols = (torch.arange(cap * nlane, dtype=torch.int64)[None, :]
            // (g["threads"] * g["slots_a_thread"]))
    return (rows * g["blocks_x"] + cols).reshape(spec.array_shape)


def check_update(gs, home, groups, noise: str, what: str, controls: bool = False):
    """#12 through its stacked entry (the forces as one [15, ...] buffer, as
    ``GridMD2`` hands them over) against its plain version on identical
    counter noise: "clt" bit-equal with an equal drift, "bm" within
    ``BM_TOL``. With ``controls`` ("clt"), two versions that the check must
    refuse: the plain version with the seed off by one, and the drift with
    the launch block that holds its maximum dropped."""
    import torch
    from uammd_tpu_torch.engine import update_kernel as uk

    kern = uk.make_gj_fold_update_kernel(gs.spec, 0.01, TEMPERATURE, 1.0, 1.0, noise=noise)
    a, grp, ref, step = update_inputs(gs, home, groups, 20251)
    forces = torch.stack(list(a[6:9]) + list(grp))
    strag = None
    if gs.spec.n_strag:
        gen = torch.Generator(device=gs.device).manual_seed(20252)
        sv = (gs.spid >= 0)[:, None]
        strag = (gs.spos, torch.randn(gs.svel.shape, generator=gen, device=gs.device) * sv,
                 torch.randn(gs.sforce.shape, generator=gen, device=gs.device) * sv, gs.spid)
    out_k, d_k, *s_k = kern.stacked(*a[:6], forces, *ref, step, strag)

    def plain(seed):
        res = uk.gj_fold_update_plain(gs.spec, kern.coef, noise, *a, grp, *ref, seed, strag)
        return (tuple(res[0]) + (tuple(res[2]) if strag is not None else ()), res[1])

    out_p, d_p = plain(step)
    out_k = tuple(out_k) + (tuple(s_k[0]) if strag is not None else ())
    err = max(float((x - y).abs().max()) for x, y in zip(out_k, out_p))
    d_err = abs(float(d_k) - float(d_p))

    def bit_equal(outs, drift):
        return all(torch.equal(x, y) for x, y in zip(out_k, outs)) and float(d_k) == drift

    if noise == "clt":
        check(bit_equal(out_p, float(d_p)),
              f"{what}: fused update (clt) bit-equal to plain, drift equal "
              f"(max|d| {err:.3g}, drift {float(d_k)} vs {float(d_p)})")
    else:
        check(err <= BM_TOL and d_err <= BM_TOL,
              f"{what}: fused update (bm) within {BM_TOL} of plain: {err:.3g}, "
              f"drift {d_err:.3g}")
    check(float(d_k) > 0.0, f"{what}: fused update sees the drift")
    if not controls:
        return err, d_err
    out_s, d_s = plain(step + 1)
    check(not bit_equal(out_s, float(d_s)),
          f"{what}: control, the plain update with the seed off by one, fails the check")
    m = (a[0] < 1.0e8).to(torch.float32)
    dinf = m * torch.stack([(p - r).abs() for p, r in zip(out_p[:3], ref)]).amax(0)
    blocks = update_block_of(gs.spec, 0 if strag is None else strag[3].shape[0]).to(dinf.device)
    top = blocks.reshape(-1)[int(dinf.reshape(-1).argmax())]
    d_drop = float(torch.where(blocks == top, 0.0, dinf).max())
    check(not bit_equal(out_p, d_drop),
          f"{what}: control, the drift with block {int(top)} dropped ({d_drop}), fails the "
          f"check (drift {float(d_k)})")
    return err, d_err, {"seed_off_by_one_max_abs": max(
        float((x - y).abs().max()) for x, y in zip(out_k, out_s)), "block_dropped_drift": d_drop}


def check_sep_stacks(spec, stacked, strag, what: str, ocap=None, expect_clean: bool = True,
                     kern=None, got=None):
    """#5 on (stacked, strag) against its plain version: ``out``, ``mini``,
    count and overflow exactly equal where the plain version reports no
    overflow; where it does (the state is latched as invalid), both flag
    it. ``got``: the kernel's result from the caller's own launch; else the
    check launches it and that launch is not counted (``SEP_REBIN.launches``
    is restored). Returns (the kernel's result, the plain version's)."""
    import torch
    from uammd_tpu_torch.engine import rebin_kernel as rk

    ocap = rk.OCAP if ocap is None else ocap
    if got is None:
        kern = rk.make_separable_rebin(spec, ocap) if kern is None else kern
        n0 = rk.SEP_REBIN.launches
        got = kern(stacked, strag)
        rk.SEP_REBIN.launches = n0
    want = rk.separable_rebin_plain(spec, stacked, strag, ocap)
    if int(want[3]) == 0:
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{what}: separable rebin out and mini equal plain slot for slot")
        check((int(got[2]), int(got[3])) == (int(want[2]), int(want[3])),
              f"{what}: separable rebin count/overflow {int(got[2])}/{int(got[3])} "
              f"== plain {int(want[2])}/{int(want[3])}")
    else:
        check(int(got[3]) > 0, f"{what}: separable rebin flags the overflow plain flags "
                               f"({int(want[3])})")
    if expect_clean:
        n = int((stacked[-1] > 0.5).sum()) + int((strag[-1] > 0.5).sum())
        check(int(got[2]) == n and int(got[3]) == 0,
              f"{what}: separable rebin keeps all {n} particles without overflow")
    return got, want


def check_sep_rebin(gs, what: str, expect_clean: bool = True):
    got = check_sep_stacks(gs.spec, stacked_of(gs, 7), strag_stack_of(gs), what,
                           expect_clean=expect_clean)[0]
    return int(got[2]), int(got[3]), int((got[1][6] > 0.5).sum())


def sep_moved_n600(dev):
    """tests/test_torch_sep_rebin_pull.py's n 600 state: L 12, CAP 8, 128
    straggler rows (~110 used), every particle and straggler moved; (spec,
    stacked, strag)."""
    import numpy as np
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.utils.lattices import lattice

    n, L = 600, 12.0
    rng = np.random.default_rng(0)
    pos = lattice(n, L, "fcc") + 0.3 * rng.standard_normal((n, 3))
    spec = layout.choose_spec(L, n, 2.5, cap=8, pos=pos, n_strag=128)
    f = layout.grid_state_to_numpy(layout.pack(spec, pos, vel=rng.standard_normal((n, 3)),
                                               device="cpu"))
    m = f["pid"] >= 0
    dx = np.clip(0.35 * rng.standard_normal(f["x"].shape), -1.0, 1.0) * m
    f["x"] = (f["x"] + dx).astype(np.float32)
    f["y"] = (f["y"] + 0.5 * dx).astype(np.float32)
    f["z"] = (f["z"] - 0.3 * dx).astype(np.float32)
    sv = (f["spid"] >= 0)[:, None]
    f["spos"] = (f["spos"] + 0.35 * rng.standard_normal(f["spos"].shape) * sv).astype(np.float32)
    gs = layout.grid_state_from_numpy(spec, f, device=dev)
    return spec, stacked_of(gs, 7), strag_stack_of(gs)


def sep_crammed(dev, which: str, drop_one: bool = False):
    """tests/test_torch_sep_rebin_pull.py's ``crammed``: at the n 600 spec
    (4^3 cells, CAP 8, OCAP 8), a state that overflows CAP + OCAP = 16 in
    only the z pass's intermediate ("z": three full columns of cell (1, 1,
    1) moved into its z cell, the outer two out of its y cell), only the y
    pass's ("y": its two full y neighbours moved into its y cell, out of
    its x cell) or only the final cell ("x": its two full x neighbours moved
    into it); every other cell holds one particle, three straggler rows sit
    elsewhere. ``drop_one`` empties one crammed slot (the y state then
    fits exactly). Returns (spec, stacked, strag)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.utils.lattices import lattice

    rng0 = np.random.default_rng(0)
    spec = layout.choose_spec(12.0, 600, 2.5, cap=8,
                              pos=lattice(600, 12.0, "fcc") + 0.3 * rng0.standard_normal((600, 3)),
                              n_strag=128)
    cap, n = spec.cap, spec.shape
    h = [L / c for L, c in zip(spec.box_size, n)]
    rng = np.random.default_rng(5)
    stacked = np.zeros((7,) + spec.array_shape, np.float32)
    stacked[:3] = layout.EMPTY_POS
    pid = 0
    full = {"z": {(1, 1, 0): (0, -1, 1), (1, 1, 1): (0, 0, 0), (1, 1, 2): (0, 1, -1)},
            "y": {(1, 0, 1): (-1, 1, 0), (1, 2, 1): (1, -1, 0)},
            "x": {(0, 1, 1): (1, 0, 0), (2, 1, 1): (-1, 0, 0)}}[which]
    for cz in range(n[2]):
        for cy in range(n[1]):
            for cx in range(n[0]):
                c = (cx, cy, cz)
                rows, move = (cap, full[c]) if c in full else (1, (0, 0, 0))
                yb, lane = cy // spec.fold, cx * spec.fold + cy % spec.fold
                for r in range(rows):
                    for a in range(3):
                        centre = -spec.box_size[a] / 2 + (c[a] + 0.5) * h[a]
                        stacked[a, cz, yb, r, lane] = (centre + move[a] * h[a]
                                                       + rng.uniform(-0.2, 0.2))
                    stacked[3:6, cz, yb, r, lane] = rng.standard_normal(3)
                    pid += 1
                    stacked[6, cz, yb, r, lane] = pid
    strag = np.zeros((7, spec.n_strag), np.float32)
    strag[:3] = layout.EMPTY_POS
    for s, c in enumerate(((3, 3, 3), (0, 2, 3), (3, 0, 0))):
        for a in range(3):
            strag[a, s] = -spec.box_size[a] / 2 + (c[a] + 0.5) * h[a]
        strag[3:6, s] = rng.standard_normal(3)
        pid += 1
        strag[6, s] = pid
    if drop_one:
        c = next(iter(full))
        yb, lane = c[1] // spec.fold, c[0] * spec.fold + c[1] % spec.fold
        stacked[:3, c[2], yb, 0, lane] = layout.EMPTY_POS
        stacked[3:, c[2], yb, 0, lane] = 0.0
    return spec, torch.from_numpy(stacked).to(dev), torch.from_numpy(strag).to(dev)


def sep_plan_of(spec, ocap) -> dict:
    """#5's launch plan with the library's own scratch bytes, shared memory
    and threads, which must equal the plan's."""
    from uammd_tpu_torch.engine import _build
    from uammd_tpu_torch.engine import rebin_kernel as rk

    plan = rk.sep_rebin_launch_plan(spec, ocap)
    lib = _build.load("sep_rebin")
    lib.uammd_sep_rebin_smem.restype = ctypes.c_longlong
    lib.uammd_sep_rebin_scratch.restype = ctypes.c_longlong
    nx, _, nz = spec.shape
    got = {"pull_smem_bytes": int(lib.uammd_sep_rebin_smem(spec.cap, ocap, spec.nlane,
                                                           spec.n_strag)),
           "pull_threads": int(lib.uammd_sep_rebin_threads(spec.nlane)),
           "scratch_bytes": int(lib.uammd_sep_rebin_scratch(nx, spec.nyb, nz, spec.fold,
                                                            spec.cap, spec.n_strag))}
    check(all(plan[k] == v for k, v in got.items()),
          f"#5 plan: the library's {got} == the plan's {plan}")
    return plan


def rebin2_plan_of(spec, ocap) -> dict:
    """#4's launch plan (#5's geometry) with the library's own scratch
    bytes, shared memory and threads, which must equal the plan's."""
    from uammd_tpu_torch.engine import _build
    from uammd_tpu_torch.engine import rebin_kernel as rk

    plan = rk.rebin2_launch_plan(spec, ocap)
    lib = _build.load("rebin2")
    lib.uammd_rebin2_smem.restype = ctypes.c_longlong
    lib.uammd_rebin2_scratch.restype = ctypes.c_longlong
    nx, _, nz = spec.shape
    got = {"pull_smem_bytes": int(lib.uammd_rebin2_smem(spec.cap, ocap, spec.nlane,
                                                        spec.n_strag)),
           "pull_threads": int(lib.uammd_rebin2_threads(spec.nlane)),
           "scratch_bytes": int(lib.uammd_rebin2_scratch(nx, spec.nyb, nz, spec.fold,
                                                         spec.cap, spec.n_strag))}
    check(all(plan[k] == v for k, v in got.items()),
          f"#4 plan: the library's {got} == the plan's {plan}")
    return plan


def sep_rebin_checks(dev) -> dict:
    """Phase 2s: #5 beyond the paths' states. The n 600 moved state (~110
    stragglers) exactly equal to plain; three states that overflow CAP +
    OCAP in only the z pass's intermediate, only the y pass's or only the
    final cell: the kernel flags overflow exactly when plain does; the y
    state one particle short fits and is exactly equal. Controls that must
    change the output on the n 600 state: the kernel ranking in #3's (dz,
    dy, dx) order (``order`` 1) and ranking the straggler rows last (2)."""
    import torch
    from uammd_tpu_torch.engine import rebin_kernel as rk

    out = {}
    spec, stacked, strag = sep_moved_n600(dev)
    got, _ = check_sep_stacks(spec, stacked, strag, "n 600 moved")
    out["n600_moved"] = {"mini_stragglers": int((got[1][6] > 0.5).sum()),
                         "plan": sep_plan_of(spec, rk.OCAP)}
    for which in ("z", "y", "x"):
        sp, st_, ss_ = sep_crammed(dev, which)
        got, want = check_sep_stacks(sp, st_, ss_, f"crammed in the {which} pass",
                                     expect_clean=False)
        check(int(want[3]) > 0, f"crammed in the {which} pass: plain flags overflow")
        out[f"crammed_{which}"] = {"overflow_kernel": int(got[3]),
                                   "overflow_plain": int(want[3])}
    sp, st_, ss_ = sep_crammed(dev, "y", drop_one=True)
    check_sep_stacks(sp, st_, ss_, "crammed y, one short")
    for order, what in ((1, "(dz, dy, dx) order"), (2, "stragglers ranked last")):
        kern = rk.make_separable_rebin(spec)
        kern.order = order
        n0 = rk.SEP_REBIN.launches
        ctl = kern(stacked, strag)
        rk.SEP_REBIN.launches = n0
        want = rk.separable_rebin_plain(spec, stacked, strag)
        moved = int(((ctl[0] != want[0]).any(dim=0)).sum() + ((ctl[1] != want[1]).any(dim=0)).sum())
        check(moved > 0, f"control ({what}) changes the output: {moved} slots differ")
        out[f"control_order_{order}_slots_differing"] = moved
    print(json.dumps({"phase": "sep_rebin_checks", "ok": True, **out}), flush=True)
    return out


def profiler_ms(fn, names, reps: int = 20, cold: bool = False, tries: int = 3) -> dict:
    """``fn``'s device time a call from torch.profiler: the kernels whose
    names contain one of ``names`` (``kernels_ms``), and all device work in
    the window (``all_device_ms``). ``cold``: a 256 MiB fill before each
    call evicts the L2 (50 MB), so the inputs come from HBM; the fills are
    not in ``kernels_ms`` but are in ``all_device_ms``. A trace with no
    matching device event (CUPTI now and then delivers none) is taken
    again, up to ``tries`` sessions; then both are None: not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scrub = torch.empty(1 << 26, dtype=torch.int32, device="cuda") if cold else None
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    scrub.fill_(0)
                fn()
            torch.cuda.synchronize()
        mine = every = 0.0
        for e in prof.key_averages():
            d = getattr(e, "self_device_time_total", None)
            if d is None:
                d = getattr(e, "self_cuda_time_total", 0.0)
            every += max(d, 0.0)
            if d > 0 and any(n in e.key for n in names):
                mine += d
        if mine > 0:
            return {"kernels_ms": mine / 1e3 / reps, "all_device_ms": every / 1e3 / reps,
                    "l2": "flushed" if cold else "warm"}
        del prof
    return {"kernels_ms": None, "all_device_ms": None, "l2": "flushed" if cold else "warm"}


def device_ms(prof: dict, what: str) -> float:
    """The kernels' device time of a ``profiler_ms`` result, which a row
    must have measured."""
    check(prof["kernels_ms"] is not None and prof["kernels_ms"] > 0,
          f"{what}: the profiler measured the kernel's device time")
    return prof["kernels_ms"]


def fold_times(fold, home, groups) -> dict:
    """#7 (``uammd_fold``) on (home, groups): CUDA events, the profiler's
    device time warm and with the L2 flushed before each call, and the
    wrapper's host time a call; its launch count left as it was."""
    from uammd_tpu_torch.engine import kernel2

    n0 = kernel2.FOLD.launches
    out = {"ms": cuda_ms(lambda: fold(home, groups), reps=20)}
    for k, cold in (("device_ms_profiler", False), ("device_ms_profiler_cold", True)):
        out[k] = profiler_ms(lambda: fold(home, groups), ["fold_kernel"], cold=cold)
        device_ms(out[k], f"#7 ({k})")
    out["host_us_a_call"] = host_us(lambda: fold(home, groups))
    kernel2.FOLD.launches = n0
    return out


def spill_report(names) -> dict:
    """ptxas's registers and spill bytes of every kernel instance of the
    named libraries (from -Xptxas -v); each must spill nothing."""
    import re
    from uammd_tpu_torch.engine import _build

    out = {}
    for name in names:
        inst, cur, spill = {}, None, None
        for ln in _build.build_log(name).splitlines():
            if "Compiling entry" in ln:
                # the kernel's name and template argument from its mangled name
                m = re.search(r"_cu_[0-9a-f]{8}(\d+)", ln)
                if m is None:
                    cur = re.search(r"'([^']+)'", ln).group(1)
                else:
                    k = int(m.group(1))
                    rest = ln[m.end():]
                    # the template's integer and bool arguments (n: negative)
                    t = re.match(r"I((?:L[a-z]n?\d+E)+)E", rest[k:])
                    targs = (re.findall(r"L[a-z](n?\d+)E", t.group(1)) if t else [])
                    cur = rest[:k] + (f"<{', '.join(a.replace('n', '-') for a in targs)}>"
                                      if targs else "")
            elif cur and "spill stores" in ln:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
                spill = int(m.group(1)) + int(m.group(2))
            elif cur and "Used" in ln and "registers" in ln:
                inst[cur] = {"registers": int(re.search(r"Used (\d+) registers", ln).group(1)),
                             "spill_bytes": spill}
                cur = None
        check(inst and all(v["spill_bytes"] == 0 for v in inst.values()),
              f"{name}: ptxas reports a spill: {inst}")
        out[name] = inst
    return out


def sep_row(suffix: str, spec, ocap, stacked, strag, launches: int, what: str) -> dict:
    """#5's kernels-line row on (stacked, strag): held to its plain version
    (``check_sep_stacks``), timed with CUDA events (20 calls as the wrapper
    makes them) and by the profiler (the classify and pull kernels, and all
    device work of the call), with its plain version's time and its byte
    bound: Q planes and the [Q, S] rows read once, Q planes and the [Q, nz,
    nyb, OCAP, NLANE] mini-grid and the counts written once."""
    from uammd_tpu_torch.engine import rebin_kernel as rk

    kern = rk.make_separable_rebin(spec, ocap)
    got, want = check_sep_stacks(spec, stacked, strag, what, ocap, kern=kern)
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    n0 = rk.SEP_REBIN.launches
    ms = cuda_ms(lambda: kern(stacked, strag), reps=20)
    prof = profiler_ms(lambda: kern(stacked, strag), ["sep_pull", "rebin_classify"])
    device_ms(prof, f"{what}: #5")
    rk.SEP_REBIN.launches = n0
    plain_ms = cuda_ms(lambda: rk.separable_rebin_plain(spec, stacked, strag, ocap), reps=3,
                       warmup=1)
    q = stacked.shape[0]
    nz, nyb, _, nlane = spec.array_shape
    bytes_ = 4 * q * (2 * spec.n_slots + nz * nyb * ocap * nlane + spec.n_strag) + 8
    return {"name": "separable_rebin" + suffix, "route": "cuda",
            "source": "uammd_tpu_torch/engine/csrc/sep_rebin.cu (+ rebin_common.cuh)",
            "replaces": "uammd_tpu/engine/rebin_kernel.py:904,920,934", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * bytes_ / PEAK_HBM_BYTES, "bound_by": "bytes", "library_ms": None,
            "device_ms_profiler": prof, "shape": list(spec.array_shape), "q": q, "ocap": ocap,
            "n_strag": spec.n_strag, "stragglers": int((strag[-1] > 0.5).sum()),
            "mini_stragglers": int((got[1][-1] > 0.5).sum()),
            "launch_plan": sep_plan_of(spec, ocap), "state": what}


def fold_halo_row(run, launches: int, what: str) -> dict:
    """#8's kernels-line row at a DD2 path's final state: one step's sweep
    of its launches (one a shard) through the stacked entry, as
    ``DomainMD2Step.compute_forces`` calls it, bit-equal to the plain
    version, timed with CUDA events and by the profiler, with the plain
    version's time and the byte bound (15 grids and the 9 exchanged rows
    read, 3 grids written, over all shards)."""
    import torch
    from uammd_tpu_torch.engine import kernel2
    from uammd_tpu_torch.parallel.mesh import perm_up, ppermute

    step, st, spec = run["step"], run["st"], run["spec"]
    n, nzl = step.n_dev, step.nz_loc
    ghosts = step.ghost_rows(st.x, st.y, st.z)
    bufs = [step.kern.stacked(st.x[i], st.y[i], st.z[i], *ghosts[i],
                              *([dd2_strag_block(step, st, i)] if step.S else []))[0]
            for i in range(n)]
    rec = ppermute([b[3:12, nzl - 1].contiguous() for b in bufs], perm_up(n))
    err = 0.0
    for b, r in zip(bufs, rec):
        got = step.fold.stacked(b, r)
        want = kernel2.fold_reactions_halo_plain(b[:3], [b[3 + 3 * g:6 + 3 * g]
                                                         for g in range(4)], r[:, None])
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"{what}: the halo fold's stacked entry bit-equal to plain")
        err = max(err, max(float((x - y).abs().max()) for x, y in zip(got, want)))
    n0 = kernel2.FOLD_HALO.launches
    ms = cuda_ms(lambda: [step.fold.stacked(b, r) for b, r in zip(bufs, rec)], reps=20)
    prof = profiler_ms(lambda: [step.fold.stacked(b, r) for b, r in zip(bufs, rec)],
                       ["fold_rows"])
    device_ms(prof, f"{what}: #8")
    kernel2.FOLD_HALO.launches = n0
    plain_ms = cuda_ms(lambda: [kernel2.fold_reactions_halo_plain(
        b[:3], [b[3 + 3 * g:6 + 3 * g] for g in range(4)], r[:, None])
        for b, r in zip(bufs, rec)], reps=5, warmup=1)
    row_bytes = 4 * spec.n_slots // spec.shape[2]
    bytes_ = 18 * 4 * spec.n_slots + 9 * n * row_bytes
    return {"name": "fold_halo" + ("" if n > 1 else "_1_shard"), "route": "cuda",
            "source": "uammd_tpu_torch/engine/csrc/fold.cu",
            "replaces": "uammd_tpu/engine/kernel2.py:613", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * bytes_ / PEAK_HBM_BYTES, "bound_by": "bytes", "library_ms": None,
            "device_ms_profiler": prof, "shards": n,
            "shard_spec": list(step.local_spec.array_shape),
            "note": f"ms, plain_ms and bound_ms cover one step's {n} launch(es) (one per shard) "
                    f"at {what}"}


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
    system (n 4200, L 40, points_per_radius 1.2, support 8); then the
    tiled branch (``check_auto_dispatch_tiled``)."""
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
    return {**errs, "tiled": check_auto_dispatch_tiled(dev)}


def pencil_smem_of(plan, C: int, interp: bool) -> int:
    """The kernel's own count of a pencil plan's shared memory
    (``uammd_pencil_spread_smem`` / ``uammd_pencil_interp_smem``), which
    must equal the plan's."""
    from uammd_tpu_torch.engine import _build

    name = "pencil_interp" if interp else "pencil_spread"
    got = getattr(_build.load(name), f"uammd_{name}_smem")(C, plan.tz)
    check(got == plan.smem, f"{name} plan {plan.as_dict()}: the kernel counts {got} bytes "
                            f"of shared memory, the plan {plan.smem}")
    return got


def pencil_plans(what, kern, shape, slack, cap, c_spread, c_interp) -> dict:
    """The launch plans of #13 and #14 on a path's grid, each with the
    kernel's own count of its shared memory (printed as launch_plans)."""
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    out = {}
    for name, C, interp in (("pencil_spread", c_spread, False), ("pencil_interp", c_interp, True)):
        plan = tp.pencil_launch_plan(shape, kern.support, slack, C, cap, interp=interp)
        out[name] = {"C": C, **plan.as_dict(), "smem_kernel": pencil_smem_of(plan, C, interp)}
    print(json.dumps({"phase": "launch_plans", "what": what, **out}), flush=True)
    return out


def pencil_rows(suffix, what, kern, pos, vals, field, shape, b, bins, slack, launches,
                ms=None):
    """The kernels-line rows of #13 and #14 at one path's state (``what``):
    the spread of ``vals`` [N(, C)] and the interpolation of ``field``
    [nx, ny, nz(, C)], each held to its plain version within PENCIL_TOL x
    max|ref| and timed with CUDA events (``ms``: the two times where the
    caller took them), beside the plain versions' times and the bound: the
    larger of the bytes (u, pids, the values or the slots written, the field
    written or read once) and 2 C float32 operations per node pair the state
    needs (per particle, the nodes within support/2 of u on each axis,
    multiplied)."""
    import torch
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    shape = tuple(shape)
    c_s = 1 if vals.ndim == 1 else vals.shape[1]
    c_i = 1 if field.ndim == 3 else field.shape[3]
    f_k, _ = tp.spread_pencil_fused(kern, pos, vals, shape, b, bins, slack=slack)
    f_p, _ = tp.spread_pencil_fused_plain(kern, pos, vals, shape, b, bins, slack=slack)
    v_k, _ = tp.interpolate_pencil_fused(kern, pos, field, b, bins, slack=slack)
    v_p, _ = tp.interpolate_pencil_fused_plain(kern, pos, field, b, bins, slack=slack)
    err = {"pencil_spread": float((f_k - f_p).abs().max()),
           "pencil_interp": float((v_k - v_p).abs().max())}
    rel = {"pencil_spread": err["pencil_spread"] / float(f_p.abs().max()),
           "pencil_interp": err["pencil_interp"] / float(v_p.abs().max())}
    check(all(math.isfinite(e) and e <= PENCIL_TOL for e in rel.values()),
          f"{what}: pencil spread / interp vs plain, max|d|/max|ref| = {rel} <= {PENCIL_TOL}")
    del f_k, f_p, v_k, v_p
    if ms is None:
        ms = (cuda_ms(lambda: tp.spread_pencil_fused(kern, pos, vals, shape, b, bins,
                                                     slack=slack), reps=10),
              cuda_ms(lambda: tp.interpolate_pencil_fused(kern, pos, field, b, bins,
                                                          slack=slack), reps=10))
    plain_ms = (cuda_ms(lambda: tp.spread_pencil_fused_plain(kern, pos, vals, shape, b, bins,
                                                             slack=slack), reps=3, warmup=1),
                cuda_ms(lambda: tp.interpolate_pencil_fused_plain(kern, pos, field, b, bins,
                                                                  slack=slack), reps=3, warmup=1))
    uu = tp._node_coords(pos, shape, b).double()
    half = kern.support / 2.0
    pairs = float((torch.ceil(uu + half) - torch.floor(uu - half) - 1).prod(1).sum())
    n, nodes, cap = pos.shape[0], math.prod(shape), bins.pids.shape[1]
    part_bytes = 4 * (n * 3 + bins.pids.numel())
    plans = pencil_plans(what, kern, shape, slack, cap, c_s, c_i)
    rows = []
    for i, (name, src, rep, C, out_bytes) in enumerate((
            ("pencil_spread", "pencil_spread.cu", "uammd_tpu/solvers/pencil_ibm.py:450", c_s,
             4 * n * c_s),
            ("pencil_interp", "pencil_interp.cu", "uammd_tpu/solvers/pencil_ibm.py:572", c_i,
             4 * bins.pids.numel() * c_i))):
        ops_ms = 1e3 * 2.0 * C * pairs / PEAK_FP32_FLOPS
        bytes_ms = 1e3 * (4 * C * nodes + part_bytes + out_bytes) / PEAK_HBM_BYTES
        rows.append({"name": name + suffix, "route": "cuda",
                     "source": f"uammd_tpu_torch/engine/csrc/{src}", "replaces": rep,
                     "launches": launches.get(name, 0), "max_abs_err": err[name],
                     "ms": ms[i], "plain_ms": plain_ms[i], "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                     "library_ms": None, "shape": list(shape), "C": C,
                     "support": kern.support, "slack": slack, "node_pairs": pairs,
                     "rel_err": rel[name], "launch_plan": plans[name]})
    return rows


# (shape, box, n, window, slack, C): grids two pencils wide, a 24 x 16 grid,
# nz = support (8 and 4), and C = 1, 4, 5 and 8
PENCIL_TILE_CASES = (
    ((16, 16, 32), (12.0, 12.0, 24.0), 2000, "gaussian", 0, 3),
    ((16, 16, 32), (12.0, 12.0, 24.0), 2000, "bm", 1, 3),
    ((24, 16, 20), (18.0, 12.0, 15.0), 2000, "peskin4", 1, 3),
    ((24, 16, 20), (18.0, 12.0, 15.0), 2000, "peskin3", 0, 5),
    ((32, 32, 8), (24.0, 24.0, 6.0), 3000, "gaussian", 0, 1),
    ((32, 32, 8), (24.0, 24.0, 6.0), 3000, "gaussian", 0, 8),
    ((32, 32, 4), (24.0, 24.0, 3.0), 3000, "peskin4", 0, 4),
)


def pencil_build_report() -> dict:
    """ptxas's registers and spills of every #13/#14 instance (C, tile
    height), from the build's -Xptxas -v; each must spill nothing. And the
    global atomics in each library's SASS (cuobjdump): the spread must have
    none; the interpolation's one atomicAdd per channel is the control that
    the count finds them."""
    import os
    import re
    from uammd_tpu_torch.engine import _build

    out = {}
    for name in ("pencil_spread", "pencil_interp"):
        log = _build.build_log(name)
        inst, cur, spill = {}, None, None
        for ln in log.splitlines():
            m = re.search(r"_kernelILi(\d+)ELi(\d+)E", ln)
            if m and "Compiling entry" in ln:
                cur = f"C{m.group(1)}_tz{m.group(2)}"
            elif cur and "spill stores" in ln:
                spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
            elif cur and "registers" in ln:
                inst[cur] = {"registers": int(re.search(r"Used (\d+) registers", ln).group(1)),
                             "spill_bytes": spill}
                cur = None
        check(len(inst) == 16, f"{name}: ptxas reported {len(inst)} of 16 instances")
        check(all(v["spill_bytes"] == 0 for v in inst.values()),
              f"{name}: an instance spills: {inst}")
        sass = subprocess.run([os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump"), "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        atomics = len(re.findall(r"\b(?:REDG?|ATOMG?)\.", sass))
        out[name] = {"instances": inst, "global_atomics_in_sass": atomics}
    check(out["pencil_spread"]["global_atomics_in_sass"] == 0,
          "the spread #13 has no global atomic")
    check(out["pencil_interp"]["global_atomics_in_sass"] > 0,
          "control: the count finds the interpolation's atomics")
    return out


def pencil_tile_checks(dev) -> dict:
    """#13 and #14 on the cases of PENCIL_TILE_CASES against their plain
    versions within PENCIL_TOL x max|ref|; in each, and on the FCM path's
    first state, the spread launched into a NaN-filled field must leave no
    NaN (every node written) and two spreads must be bit-equal (no atomics,
    a fixed order); ptxas's report and the spread's SASS
    (``pencil_build_report``)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.engine import _build
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    windows = pencil_kernels()
    rng = np.random.default_rng(13)

    def coverage_and_repeat(kern, pos, vals, shape, b, bins, slack, what):
        u = tp._node_coords(pos, shape, b).contiguous()
        v2 = (vals if vals.ndim == 2 else vals[:, None]).contiguous()
        C = v2.shape[1]
        nan = torch.full((C,) + tuple(shape), float("nan"), device=dev)
        plan = tp.pencil_launch_plan(shape, kern.support, slack, C, bins.pids.shape[1])
        ints, ab = tp._kernel_args(kern, shape, bins, slack, C, plan)
        P = _build.ptr
        tp.SPREAD(P(u), P(v2), P(bins.pids), P(tp.pencil_neighbours(tuple(shape[:2]), dev)),
                  P(nan), *ints, *ab, 1.0)
        left = int(nan.isnan().sum())
        check(left == 0, f"{what}: the spread leaves {left} nodes of a NaN-filled field unwritten")
        a, _ = tp.spread_pencil_fused(kern, pos, vals, shape, b, bins, slack=slack)
        c, _ = tp.spread_pencil_fused(kern, pos, vals, shape, b, bins, slack=slack)
        check(bool(torch.equal(a, c)), f"{what}: two spreads are bit-equal")

    cases = {}
    for shape, L, n, window, slack, C in PENCIL_TILE_CASES:
        what = f"{shape} {window} slack {slack} C {C}"
        kern = windows[window]
        b = box(list(L), device=dev)
        pos = torch.tensor((rng.random((n, 3)) - 0.5) * np.asarray(L), dtype=torch.float32,
                           device=dev)
        vals = torch.tensor(rng.normal(size=(n, C)), dtype=torch.float32, device=dev)
        bins = tp.bin_pencils(pos, shape, b)
        h = min(L[0] / shape[0], L[1] / shape[1])
        pos = pos + slack * torch.tensor(rng.uniform(-0.99, 0.99, (n, 3)) * h,
                                         dtype=torch.float32, device=dev)
        es, ei, _, _ = check_pencil(kern, pos, vals, shape, b, bins, slack, what)
        coverage_and_repeat(kern, pos, vals, shape, b, bins, slack, what)
        cases[what] = [es, ei]

    # the FCM path's first state: every node written, two spreads bit-equal
    bf, fcm, pos = fcm_setup(dev, seed=0)
    kern = fcm._kernel()
    bins = fcm.pencil_bins(pos, slack=1)
    f = torch.tensor(rng.normal(size=(FCM_N, 3)), dtype=torch.float32, device=dev)
    coverage_and_repeat(kern, pos, f, fcm.shape, bf, bins, 1, "FCM first state")
    del f, pos, bins
    torch.cuda.empty_cache()

    report = pencil_build_report()
    out = {"phase": "pencil_tile_checks", "ok": True, "tol": PENCIL_TOL,
           "spread_interp_rel_err": cases,
           "nan_field_fully_written": True, "two_spreads_bit_equal": True,
           "build": report}
    print(json.dumps(out), flush=True)
    return out


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
    """Periodic self-mobility of one sphere in the FCM path's box."""
    return hashimoto_mobility_at(FCM_L)


def hashimoto_mobility_at(L: float) -> float:
    """Hashimoto's periodic self-mobility of one sphere (tests/test_bdhi.py:67)
    at viscosity 1 and radius 1 in a cube of side L."""
    m0 = 1.0 / (6.0 * math.pi)
    return m0 * (1.0 - 2.83729748 / L + (4.0 * math.pi / 3.0) / L ** 3)


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


def pencil_first_state_rows(dev) -> list:
    """The #13/#14 rows at the Poisson and PSE far fields' first states (the
    electrolyte's and the fcc suspension's positions, without their paths;
    launches 0): the spread of the charges (forces) and the interpolation
    of a 4-channel field (a random 3-channel one)."""
    import torch
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    pos, q, pos_np = electrolyte(dev)
    far = poisson_split(dev, pos_np).far
    kern = far._kernel()
    bins = tp.bin_pencils(pos, far.shape, far.box)
    rho, _ = tp.spread_pencil_fused(kern, pos, q, far.shape, far.box, bins)
    f4 = torch.fft.irfftn(torch.stack([torch.fft.rfftn(rho)] * 4), s=far.shape, dim=(1, 2, 3))
    rows = pencil_rows("_poisson", "Poisson far field, first state", kern, pos, q,
                       f4.permute(1, 2, 3, 0), far.shape, far.box, bins, 0, {})
    b, pos = pse_box_and_fcc(dev)
    be = pse_backend(b, pos)
    bins = be.far.pencil_bins(pos, slack=be.far_slack, cap_extra=be.far_cap_extra)
    gen = torch.Generator(device=dev).manual_seed(3)
    f = torch.randn(pos.shape, generator=gen, device=dev)
    u = torch.randn((3,) + tuple(be.far.shape), generator=gen, device=dev).permute(1, 2, 3, 0)
    rows += pencil_rows("_pse", "PSE far field, first state", be.far._kernel(), pos, f, u,
                        be.far.shape, b, bins, be.far_slack, {})
    return rows


def pencil_only(dev, card) -> int:
    """``--only-pencil``: the checks of #13/#14, the FCM path and its
    breakdown, and the #13/#14 rows at the Poisson and PSE far fields'
    first states, for working on the pencil kernels; prints no result
    line."""
    import torch
    from uammd_tpu_torch.solvers import pencil_ibm

    fcm_kernel_checks(dev)
    pencil_tile_checks(dev)
    path = fcm_main_path(dev, {"pencil_spread": pencil_ibm.SPREAD,
                               "pencil_interp": pencil_ibm.INTERP})
    rows = fcm_breakdown(path, card)
    del path
    torch.cuda.empty_cache()
    rows += pencil_first_state_rows(dev)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


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


def fcm_breakdown(path, card):
    """Phase 4b: each part of the FCM step timed alone at the path's final
    state (CUDA events), times its calls per step; and the pencil kernels'
    rows of the kernels line (``pencil_rows``)."""
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

    rows = pencil_rows("", "FCM path's final state", kern, pos, f, u, shape, b, bins, 1,
                       path["launches"])
    t = {
        "pencil_spread": rows[0]["ms"],
        "pencil_interp": rows[1]["ms"],
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

    return rows


# ---------------------------------------------------------------- BDHI-PSE
# The BDHI-PSE path: bench.py:104-276's PSE protocol at its defaults (N =
# 131072 colloids of radius 1 at volume fraction 0.05, fcc start,
# far_grid 144, tolerance 1e-4, n_strag 192, near skin 1, Lanczos tuned to
# 1e-3 with m_max 16, WCA between surfaces, dt 0.01, T 1, 40 warm-up + 40
# timed steps, one retry with n_strag x2 and far_cap_extra 24 on overflow).
PSE_N = 131072
PSE_PHI = 0.05
PSE_L = (PSE_N * (4.0 / 3.0) * math.pi / PSE_PHI) ** (1.0 / 3.0)
PSE_FAR_GRID, PSE_TOLERANCE, PSE_STRAG, PSE_LTOL = 144, 1e-4, 192, 1e-3
PSE_FAR_GRID_SPLIT = 128  # the second split of the invariance gate
PSE_DT, PSE_T = 0.01, 1.0
PSE_WARM, PSE_TIMED = 40, 40
# channel kernels against their plain versions: max|d| <= CHANNEL_TOL x
# max|ref| (the bar of tests/test_pse_engine.py:573): float32 sums in
# another order (atomics in the Newton kernel), FMA Horner steps and
# rsqrtf against torch.rsqrt
CHANNEL_TOL = 2e-5
SQRT_RTOL = 5e-3  # tests/test_pse_engine.py:87
SPLIT_RMS = 1e-2  # tests/test_pse_engine.py:53
MF_RTOL = 2e-4  # tests/test_pse_engine.py:69, as max|d| / max|ref|
# the persistent layout against a fresh pack (tests/test_pse_engine.py:319's
# bar): the two layouts wrap coordinates differently, so a pair at the
# cutoff, where the remainder jumps by ~1e-4 m0, may fall on either side
PERSIST_TOL = 5e-3
FDT_DRAWS = 4
HOST_READ_STEPS = 3
FDT_TOL = 0.02
# float32 operations per pair of the PSE functor: the cutoff test (d, r2:
# 8) for every candidate pair; for pairs inside rcut the radial (rsqrt, q,
# u, two 12-step FMA Horner chains, g / r2: 55) and per 3-vector and
# direction f F + (g / r2)(d . F) d with its sums (18)
OPS_CH_TEST, OPS_CH_RADIAL, OPS_CH_APPLY = 8, 55, 18


def pse_box_and_fcc(dev):
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.utils.lattices import lattice
    import torch

    pos = torch.tensor(lattice(PSE_N, PSE_L, "fcc"), dtype=torch.float32, device=dev)
    return box(PSE_L, device=dev), pos


def pse_backend(b, pos, n_strag=None, far_cap_extra=0, far_grid=None):
    import dataclasses
    from uammd_tpu_torch.integrators.bdhi.pse_engine import PSEGrid

    n_strag = PSE_STRAG if n_strag is None else n_strag
    be = PSEGrid.create(b, PSE_N, viscosity=1.0, radius=1.0, far_grid=far_grid or PSE_FAR_GRID,
                        tolerance=PSE_TOLERANCE, lanczos_iterations=10, pos=pos,
                        n_strag=n_strag, near_skin=1.0)
    if far_cap_extra:
        be = dataclasses.replace(be, far_cap_extra=int(far_cap_extra))
    return be


def wca():
    from uammd_tpu_torch.engine.md import lj_g_fused

    rc = 2.0 ** (1.0 / 6.0) * 2.0
    return lj_g_fused(1.0, 2.0, rc2=rc * rc, approx=True)


def channel_outputs(be, cg, nvec, kind, strag_valid=True):
    """Outputs of one channel kernel (or plain version) on ``cg``'s first
    3 nvec channels as a list: the grids, then the straggler totals.
    ``kind``: "27" / "newton" (kernels), "27_plain" / "newton_plain"."""
    import torch
    from uammd_tpu_torch.engine import kernel2, pair_kernel

    spec = be.spec
    chans = list(cg.channels[: 3 * nvec])
    spid = cg.spid if strag_valid else torch.full_like(cg.spid, -1)
    blk = (pair_kernel.broadcast_strag_channels(spec, cg.spos, tuple(cg.schannels[: 3 * nvec]),
                                                spid) if spec.n_strag else None)
    fn = be.near_fn()
    if kind == "27":
        out = be._kernel(nvec, newton=False)(cg.x, cg.y, cg.z, *chans, strag=blk)
    elif kind == "newton":
        out = be._kernel(nvec, newton=True)(cg.x, cg.y, cg.z, *chans, strag=blk)
    elif kind == "27_plain":
        g, sp = pair_kernel.pair_channel_plain(spec, fn, nvec, cg.x, cg.y, cg.z, chans, blk)
        out = tuple(g) + (tuple(sp) if sp is not None else ())
    else:
        home, groups, sp = kernel2.newton_channel_plain(spec, fn, nvec, cg.x, cg.y, cg.z,
                                                        chans, blk)
        out = tuple(kernel2.fold_reactions_n_plain(home, groups)) + (
            tuple(sp) if sp is not None else ())
    return list(out)


def channel_err(ref, test, nvec) -> float:
    """max|d| over every output (grids and straggler totals) / max|ref grid|."""
    scale = max(float(a.abs().max()) for a in ref[: 3 * nvec])
    return max(float((a - b).abs().max()) for a, b in zip(ref, test)) / scale


def check_channel_kernels(be, cg, what: str, controls: bool):
    """#2 and #10 (+ #9) against their plain versions and each other at
    nvec 1 and 2; #9 alone bit-equal; #7 against #9 at n = 3; with
    ``controls`` the two wrong kernels that must fail the bound."""
    import torch
    from uammd_tpu_torch.engine import kernel2

    errs = {}
    spec = be.spec
    for nvec in (1, 2):
        p27 = channel_outputs(be, cg, nvec, "27_plain")
        pnt = channel_outputs(be, cg, nvec, "newton_plain")
        k27 = channel_outputs(be, cg, nvec, "27")
        knt = channel_outputs(be, cg, nvec, "newton")
        e = {"27_vs_plain": channel_err(p27, k27, nvec),
             "newton_vs_plain": channel_err(pnt, knt, nvec),
             "newton_vs_27_kernels": channel_err(k27, knt, nvec),
             "plain_newton_vs_plain_27": channel_err(p27, pnt, nvec)}
        for k, v in e.items():
            check(v < CHANNEL_TOL, f"{what}: nvec {nvec} {k} {v:.3g} < {CHANNEL_TOL}")
        errs[f"nvec{nvec}"] = e
        chans = list(cg.channels[: 3 * nvec])
        blk = (kernel2_strag_block(be, cg, nvec) if spec.n_strag else None)
        home, groups, sp = be._kernel(nvec, newton=True).raw(cg.x, cg.y, cg.z, *chans, strag=blk)
        # the reverse sums go through shared and global float atomics: print
        # whether two calls give the same bits
        home2, groups2, sp2 = be._kernel(nvec, newton=True).raw(cg.x, cg.y, cg.z, *chans,
                                                                strag=blk)
        e["newton_bit_equal_calls"] = (
            all(torch.equal(a, b) for a, b in zip(home, home2))
            and all(torch.equal(a, b) for g1, g2 in zip(groups, groups2) for a, b in zip(g1, g2))
            and (sp is None or torch.equal(sp, sp2)))
        del home2, groups2, sp2
        f_k = kernel2.make_fold_kernel_n(spec, 3 * nvec)(home, groups)
        f_p = kernel2.fold_reactions_n_plain(home, groups)
        check(all(torch.equal(a, b) for a, b in zip(f_k, f_p)),
              f"{what}: nvec {nvec} fold #9 bit-equal to plain")
        # #9's stacked entry on #10's buffer as the path hands it over
        raw, _ = be._kernel(nvec, newton=True).raw_stacked(cg.x, cg.y, cg.z, *chans, strag=blk)
        f_s = kernel2.make_fold_kernel_n(spec, 3 * nvec).stacked(raw)
        f_sp = kernel2.fold_reactions_n_plain(raw[0], raw[1:])
        check(all(torch.equal(a, b) for a, b in zip(f_s, f_sp)),
              f"{what}: nvec {nvec} fold #9's stacked entry bit-equal to plain")
        if controls:
            # the groups added in the reverse order must fail the bit-equality
            rev = list(raw[0])
            for (dz, dyb), g in reversed(list(zip(kernel2.REACTION_GROUPS, raw[1:]))):
                rev = [r + torch.roll(gc, (dz, dyb), (0, 1)) for r, gc in zip(rev, g)]
            n_diff = sum(int((a != b).sum()) for a, b in zip(f_s, rev))
            check(n_diff > 0, f"{what}: nvec {nvec} control, #9's groups added in the reverse "
                              f"order, fails the bit-equality ({n_diff} slots differ)")
            errs.setdefault("fold_reverse_order_slots_differ", {})[f"nvec{nvec}"] = n_diff
        if nvec == 1:
            f7 = kernel2.make_fold_kernel(spec)(home, groups)
            check(all(torch.equal(a, b) for a, b in zip(f7, f_k)),
                  f"{what}: fold #7 equals fold #9 at n = 3")
        if controls and nvec == 1:
            # the group (1, 0) folded the wrong way: rolled by (-1, 0)
            wrong = list(kernel2.fold_reactions_n_plain(home, groups))
            wrong = [w - torch.roll(gc, (1, 0), (0, 1)) + torch.roll(gc, (-1, 0), (0, 1))
                     for w, gc in zip(wrong, groups[1])]
            c_roll = channel_err(pnt[:3], wrong, nvec)
            check(c_roll > CHANNEL_TOL,
                  f"{what}: control, a group rolled the wrong way, fails the bound ({c_roll:.3g})")
            c_drop = None  # no straggler to drop
            if bool(cg.smask.any()):
                dropped = channel_outputs(be, cg, nvec, "newton", strag_valid=False)
                c_drop = channel_err(pnt, dropped, nvec)
                check(c_drop > CHANNEL_TOL,
                      f"{what}: control, the stragglers dropped, fails the bound ({c_drop:.3g})")
            # #10 with its candidate loops one row short of the occupancy
            trim = kernel2.make_newton_channel_kernel(spec, be.near_fn(), nvec)
            trim.occ_trim = 1
            c_trim = channel_err(pnt, list(trim(cg.x, cg.y, cg.z, *chans, strag=blk)), nvec)
            check(c_trim > CHANNEL_TOL,
                  f"{what}: control, #10 one row short, fails the bound ({c_trim:.3g})")
            errs["controls"] = {"stragglers_dropped": c_drop, "group_rolled_wrong_way": c_roll,
                                "newton_one_row_short": c_trim}
    return errs


def check_newton_channel_nan(be, cg, what: str) -> dict:
    """#10 (+ #9) on ``cg`` with one occupied slot's x set to NaN, at nvec
    1 and 2: NaN in exactly the plain version's entries (folded grids and
    straggler totals), the rest within ``CHANNEL_TOL`` x max|ref|."""
    import torch

    occ = cg.mask.nonzero()
    x = cg.x.clone()
    x[tuple(occ[len(occ) // 2])] = float("nan")
    cgn = cg.replace(x=x)
    out = {}
    for nvec in (1, 2):
        ref = channel_outputs(be, cgn, nvec, "newton_plain")
        got = channel_outputs(be, cgn, nvec, "newton")
        n_ref = sum(int(a.isnan().sum()) for a in ref)
        same = all(torch.equal(a.isnan(), b.isnan()) for a, b in zip(ref, got))
        check(n_ref > 0 and same,
              f"{what}: #10 nvec {nvec} with a NaN: NaN in exactly the plain version's "
              f"{n_ref} entries")
        scale = max(float(torch.nan_to_num(a, nan=0.0).abs().max()) for a in ref[: 3 * nvec])
        err = max(float((torch.nan_to_num(a, nan=0.0) - torch.nan_to_num(b, nan=0.0))
                        .abs().max()) for a, b in zip(ref, got)) / scale
        check(err < CHANNEL_TOL, f"{what}: #10 nvec {nvec} with a NaN, finite entries "
                                 f"{err:.3g} < {CHANNEL_TOL}")
        out[f"nvec{nvec}"] = {"nan_entries": n_ref, "rel_err": err}
    return out


def kernel2_strag_block(be, cg, nvec):
    from uammd_tpu_torch.engine import pair_kernel

    return pair_kernel.broadcast_strag_channels(be.spec, cg.spos,
                                                tuple(cg.schannels[: 3 * nvec]), cg.spid)


def with_channels(be, cg, dev, seed: int):
    """``cg`` with 6 random normal channels (zero on empty slots/rows)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m = cg.mask.to(torch.float32)
    sm = cg.smask.to(torch.float32)
    chans = tuple(torch.randn(cg.x.shape, generator=gen, device=dev) * m for _ in range(6))
    sch = tuple(torch.randn(cg.spid.shape, generator=gen, device=dev) * sm for _ in range(6))
    return cg.replace(channels=chans, schannels=sch)


def pse_kernel_checks(dev):
    """Phase 2c: the channel kernels #2, #10 (with #9) and #9 alone against
    their plain versions on tests/test_pse_engine.py:536's n 512 clump
    system and on the PSE path's first packed state; #5, #6 and #7 at the
    PSE grid's shape (NLANE 114, S 192, n_q 4, ocap 16)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.engine import kernel2, rebin_kernel
    from uammd_tpu_torch.engine.layout import pack_channels
    from uammd_tpu_torch.utils.lattices import lattice

    n, phi = 512, 0.08
    L = (n * (4.0 / 3.0) * math.pi / phi) ** (1.0 / 3.0)
    rng = np.random.default_rng(3)
    pos = np.concatenate([np.asarray(lattice(n - 20, L, "fcc")),
                          rng.uniform(-2.0, 2.0, (20, 3)) + 3.0]).astype(np.float32)
    from uammd_tpu_torch.integrators.bdhi.pse_engine import PSEGrid

    be_s = PSEGrid.create(box(L, device=dev), n, far_grid=32, tolerance=1e-3,
                          lanczos_iterations=3, pos=pos, n_strag=48)
    cg_s = pack_channels(be_s.spec, torch.tensor(pos, device=dev),
                         torch.tensor(rng.normal(size=(n, 6)), dtype=torch.float32, device=dev))
    n_strag_s = int(cg_s.smask.sum())
    check(n_strag_s > 0, "n 512 clump: the straggler list is used")
    small = check_channel_kernels(be_s, cg_s, "n 512 clump", controls=True)
    small_nan = check_newton_channel_nan(be_s, cg_s, "n 512 clump")

    b, pos_fcc = pse_box_and_fcc(dev)
    be = pse_backend(b, pos_fcc)
    st = be.em_state(pos_fcc)
    cg, _, _ = be._refresh(st, pos_fcc)
    cg = with_channels(be, cg, dev, 17)
    full = check_channel_kernels(be, cg, "PSE first state", controls=True)
    full_nan = check_newton_channel_nan(be, cg, "PSE first state")

    # #6 + #7 at the PSE grid's shape, on the fcc start jittered by 1.2 per
    # axis (the fcc start itself has no pair inside the WCA cutoff)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    jit = pos_fcc + 1.2 * torch.randn(pos_fcc.shape, generator=gen, device=dev)
    cgj, _, _ = be._refresh(be.em_state(jit), jit)
    check(not bool(cgj.overflow), "jittered PSE state: no overflow")
    g = wca()
    strag = kernel2.broadcast_stragglers(be.spec, cgj.spos, cgj.spid)
    home, groups, sf = kernel2.make_newton_pair_kernel(be.spec, g)(cgj.x, cgj.y, cgj.z, strag)
    ph, pg, psf = kernel2.newton_pair_plain(be.spec, g, cgj.x, cgj.y, cgj.z, strag)
    fk = kernel2.make_fold_kernel(be.spec)(home, groups)
    fp = kernel2.fold_reactions_plain(ph, pg)
    fmax = max(float(a.abs().max()) for a in fp)
    check(fmax > 0, "jittered PSE state: pairs inside the WCA cutoff")
    newton_err = max(max(float((a - c).abs().max()) for a, c in zip(fk, fp)),
                     float((sf - psf).abs().max())) / fmax
    check(newton_err < FAST_RECIP_TOL,
          f"PSE grid: Newton pair #6 + fold #7 vs plain {newton_err:.3g} < {FAST_RECIP_TOL}")
    check(all(torch.equal(a, c) for a, c in zip(fk, kernel2.fold_reactions_plain(home, groups))),
          "PSE grid: fold #7 bit-equal to plain")
    # #5 with n_q 4 and ocap 16 on the refresh's input after a drift below
    # the threshold
    moved = pos_fcc + 0.9 * be.spec.drift_threshold * (
        2.0 * torch.rand(pos_fcc.shape, generator=gen, device=dev) - 1.0)
    sep = be._near_rebin()
    stacked, sstack = be._near_rebin_inputs(be.em_state(pos_fcc), moved)
    mk = check_sep_stacks(be.spec, stacked, sstack, "PSE grid (n_q 4, ocap 16)", sep.ocap,
                          kern=sep)[0][1]
    out = {"phase": "pse_kernels_vs_plain", "ok": True, "tol": CHANNEL_TOL,
           "n512_clump": {"spec": list(be_s.spec.array_shape), "stragglers": n_strag_s,
                          "rel_err": small, "newton_nan": small_nan},
           "first_state": {"spec": list(be.spec.array_shape), "n_strag": be.spec.n_strag,
                           "stragglers": int(cg.smask.sum()), "rel_err": full,
                           "newton_nan": full_nan},
           "pse_grid_newton_pair_rel_err": newton_err, "pse_grid_fold": "bit-equal",
           "pse_grid_separable_rebin": "exact (out, mini, count, overflow)",
           "separable_rebin_mini_stragglers": int((mk[3] > 0.5).sum())}
    print(json.dumps(out), flush=True)
    return {"err_27": full["nvec2"]["27_vs_plain"], "err_newton": full["nvec2"]["newton_vs_plain"],
            "newton_bit_equal_calls": {k: full[k]["newton_bit_equal_calls"]
                                       for k in ("nvec1", "nvec2")}}


def newton_channel_plan_of(spec, nvec) -> dict:
    """#10's launch plan with the library's own shared memory and threads,
    which must equal the plan's."""
    from uammd_tpu_torch.engine import _build, kernel2

    plan = kernel2.newton_channel_plan(spec, nvec)
    lib = _build.load("newton_channel")
    lib.uammd_newton_channel_smem.restype = ctypes.c_longlong
    smem = int(lib.uammd_newton_channel_smem(spec.cap, plan.cc, plan.fc, 3 * nvec,
                                             spec.n_strag))
    threads = int(lib.uammd_newton_channel_threads(spec.cap, plan.cc, plan.fc))
    check(smem == plan.smem and threads == plan.threads,
          f"#10 plan (nvec {nvec}): the library's {smem} bytes / {threads} threads == the "
          f"plan's {plan.smem} / {plan.threads}")
    return plan.as_dict()


def pse_run(dev, counted, n_strag, far_cap_extra):
    """One run of the path: create, tune Lanczos, em_state, PSE_WARM +
    PSE_TIMED persistent steps with the launch counts zeroed just before
    the steps. Returns what the gates and the breakdown need."""
    import torch

    b, pos = pse_box_and_fcc(dev)
    t0 = time.perf_counter()
    be = pse_backend(b, pos, n_strag=n_strag, far_cap_extra=far_cap_extra)
    be = be.tuned_lanczos(pos, tol=PSE_LTOL)
    fs = be.make_pair_force_slots(wca())
    st = be.em_state(pos)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for k in counted.values():
        k.launches = 0
    p = pos
    for _ in range(PSE_WARM):
        dx, _, st = be.displacement_with_pair_force_persistent(fs, p, gen, PSE_DT, PSE_T, st)
        p = b.wrap_position(p + dx)
    torch.cuda.synchronize()
    before = {k: v.launches for k, v in counted.items()}
    reb0 = (st.n_rebin_near, st.n_rebin_far)
    t0 = time.perf_counter()
    for _ in range(PSE_TIMED):
        dx, f, st = be.displacement_with_pair_force_persistent(fs, p, gen, PSE_DT, PSE_T, st)
        p = b.wrap_position(p + dx)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    return {"box": b, "be": be, "fs": fs, "st": st, "pos": p, "gen": gen,
            "forces": f, "setup_s": setup_s, "timed_s": timed_s, "launches": launches,
            "timed": {k: launches[k] - before[k] for k in counted},
            "rebin_near": st.n_rebin_near - reb0[0], "rebin_far": st.n_rebin_far - reb0[1],
            "overflow": bool(st.overflow), "ovf_near": bool(st.ovf_near),
            "ovf_far": bool(st.ovf_far)}


def host_reads_per_step(run) -> list:
    """The synchronising CUDA calls of HOST_READ_STEPS persistent steps
    (``host_reads``)."""
    be, st = run["be"], run["st"]
    return host_reads(lambda: be.displacement_with_pair_force_persistent(
        run["fs"], run["pos"], run["gen"], PSE_DT, PSE_T, st), HOST_READ_STEPS)


def pse_main_path(dev, counted):
    """Phase 3d: bench.py's PSE protocol, with its one overflow retry;
    then the gates."""
    import dataclasses
    import torch
    from uammd_tpu_torch.engine.layout import unpack_values

    run = pse_run(dev, counted, PSE_STRAG, 0)
    retried = False
    first = {k: run[k] for k in ("overflow", "ovf_near", "ovf_far")}
    if run["overflow"]:
        retried = True
        run = pse_run(dev, counted, 2 * PSE_STRAG, 24)
    check(not run["overflow"], f"PSE path: no overflow after {int(retried)} retries "
                               f"(near {run['ovf_near']}, far {run['ovf_far']})")
    be, p, st, gen = run["be"], run["pos"], run["st"], run["gen"]
    fails = []  # every gate is read and printed before the first failure raises

    def gate(ok: bool, what: str) -> None:
        if not ok:
            fails.append(what)

    m = be.lanczos_iterations
    gate(bool(p.isfinite().all()), "PSE path: all positions finite")
    t = run["timed"]
    for k, need in (("newton_channel", m), ("fold_n", m), ("newton_pair", 1), ("fold", 1),
                    ("pencil_spread", 1), ("pencil_interp", 1), ("lanczos_sqrt", 1)):
        gate(t[k] >= need * PSE_TIMED,
              f"PSE path: {k} launched {t[k]} >= {need} x {PSE_TIMED} times in the timed steps")
    gate(t["separable_rebin"] >= 1, "PSE path: the near rebin #5 ran in the timed window")
    reads = host_reads_per_step(run)
    reads_per_step = len(reads) / HOST_READ_STEPS

    # T = 0: the fused displacement equals dt x compute_mf (same binning)
    gen_f = torch.Generator(device=dev)
    gen_f.manual_seed(5)
    F = torch.randn(p.shape, generator=gen_f, device=dev)
    mf = be.compute_mf(p, F)
    d0, ovf = be.displacement(p, F, gen, PSE_DT, 0.0)
    mf_err = float((d0 - PSE_DT * mf).abs().max() / (PSE_DT * mf).abs().max())
    gate(not bool(ovf) and mf_err < MF_RTOL,
          f"PSE path: T = 0 displacement vs dt x compute_mf {mf_err:.3g} < {MF_RTOL}")
    # the persistent layout (refreshed, rebinned on drift) against a fresh
    # pack of the same state: M_near F, unpacked
    cg, _, _ = be._refresh(st, p)
    src = cg.pid.clamp(min=0).long()
    f3 = [torch.where(cg.mask, F[src, d], 0.0) for d in range(3)]
    sf3 = [torch.where(cg.smask, F[cg.spid.clamp(min=0).long(), d], 0.0) for d in range(3)]
    *vp, svp = be.near_matvec_slots(cg, *f3, sf3=sf3)
    v_persist = unpack_values(cg, vp, svalues=svp)
    v_fresh = be.near_matvec(p, F)
    persist_err = float((v_persist - v_fresh).abs().max() / v_fresh.abs().max())
    gate(persist_err < PERSIST_TOL,
          f"PSE path: near M F on the persistent layout vs a fresh pack {persist_err:.3g} "
          f"< {PERSIST_TOL}")
    dxp, _, _ = be.displacement_with_pair_force_persistent(run["fs"], p, gen, PSE_DT, 0.0, st)

    # the sqrt identity ||B z||^2 = z.M z on the path's state, 3 draws
    sqrt_err = []
    for _ in range(3):
        z3, zs = be.draw_z(cg, gen)
        bx, by, bz, s3, _ = be._near_noise_slots_z(cg, z3, zs)
        lhs = float(sum((a.double() ** 2).sum() for a in (bx, by, bz)) + (s3.double() ** 2).sum())
        vx, vy, vz, sv3 = be.near_matvec_slots(cg, *z3, sf3=(zs[0], zs[1], zs[2]))
        rhs = float(sum((a.double() * c.double()).sum() for a, c in zip(z3, (vx, vy, vz)))
                    + sum((a.double() * c.double()).sum() for a, c in zip(zs, sv3)))
        sqrt_err.append(lhs / rhs - 1.0)
    gate(all(abs(x) < SQRT_RTOL for x in sqrt_err),
          f"PSE path: sqrt identity {sqrt_err} within {SQRT_RTOL}")

    # split invariance: far_grid 144 against 128 on the same state
    be128 = dataclasses.replace(pse_backend(run["box"], p, far_grid=PSE_FAR_GRID_SPLIT),
                                lanczos_iterations=m)
    mf128 = be128.compute_mf(p, F)
    split_rms = float(((mf - mf128) ** 2).mean().sqrt() / (mf ** 2).mean().sqrt())
    gate(split_rms < SPLIT_RMS, f"PSE path: split invariance RMS {split_rms:.3g} < {SPLIT_RMS}")

    # fluctuation-dissipation: the noise part of the step, dx(T) - dx(0)
    m_self = hashimoto_mobility_at(PSE_L)
    msq = torch.zeros(3, dtype=torch.float64, device=dev)
    for _ in range(FDT_DRAWS):
        dxt, _, _ = be.displacement_with_pair_force_persistent(run["fs"], p, gen, PSE_DT,
                                                               PSE_T, st)
        msq += ((dxt - dxp).double() ** 2).mean(0)
    msq = [float(x) / FDT_DRAWS for x in msq]
    want = 2.0 * PSE_T * PSE_DT * m_self
    fdt = [x / want - 1.0 for x in msq]
    gate(all(abs(x) < FDT_TOL for x in fdt),
          f"PSE path: noise mean square per axis {msq} within {FDT_TOL:.0%} of {want:.6g}")
    ms = 1e3 * run["timed_s"] / PSE_TIMED
    out = {"phase": "main_path_pse", "n": PSE_N, "box": PSE_L, "volume_fraction": PSE_PHI,
           "near_spec": list(be.spec.array_shape), "n_strag": be.spec.n_strag,
           "far_shape": list(be.far.shape), "far_support": be.far.support,
           "far_cap": int(st.far_pids.shape[1]), "rcut": be.rcut, "xi": be.xi,
           "self_f": be.self_f, "fit_error": be.fit_error,
           "fit_error_noise": be.fit_error_noise, "lanczos_m": m,
           "dt": PSE_DT, "temperature": PSE_T, "warmup_steps": PSE_WARM,
           "timed_steps": PSE_TIMED, "setup_seconds": run["setup_s"],
           "timed_seconds": run["timed_s"], "ms_per_step": ms,
           "particle_steps_per_s": PSE_N * PSE_TIMED / run["timed_s"],
           "rebin_near_steps": run["rebin_near"], "rebin_far_steps": run["rebin_far"],
           "ovf_near": run["ovf_near"], "ovf_far": run["ovf_far"],
           "first_attempt": first, "retry_taken": retried, "host_reads_per_step": reads_per_step, "host_reads_at": reads,
           "launches": run["launches"],
           "launches_per_timed_step": {k: v / PSE_TIMED for k, v in t.items()},
           "mf_rel_err": mf_err, "persistent_vs_fresh": persist_err,
           "sqrt_identity_rel_err": sqrt_err, "split_rms_144_vs_128": split_rms,
           "noise_msq_per_axis": msq, "noise_msq_want": want, "fdt_rel_err": fdt,
           "fdt_draws": FDT_DRAWS, "m_self": m_self,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(out), flush=True)
    gate(reads_per_step <= 1, f"PSE path: {reads_per_step} host reads per step {reads}")
    run["fails"] = fails
    run["ms"] = ms
    return run


def pse_profile(run, steps: int = 5) -> dict:
    """Device time per kernel over ``steps`` persistent steps from a
    torch.profiler trace, and the card's busy share of the wall time (one
    stream, so the kernels do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    be, st, p, gen = run["be"], run["st"], run["pos"], run["gen"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            dx, _, st = be.displacement_with_pair_force_persistent(run["fs"], p, gen, PSE_DT,
                                                                   PSE_T, st)
            p = run["box"].wrap_position(p + dx)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            kernels[e.key[:90]] = (t / 1e3 / steps, e.count / steps)
    busy = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    return {"phase": "profile_pse", "steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy if kernels else None,
            "device_busy_share": busy / (wall_ms / steps) if kernels else None,
            "kernels": len(kernels), "launches_per_step": sum(v[1] for v in kernels.values()),
            "top_ms_and_calls_per_step": {k: v for k, v in top},
            "note": "torch.profiler (CUPTI) device time; wall time includes the profiler's "
                    "own cost; null when the trace holds no device time"}


def channel_pairs(be, cg) -> dict:
    """The channel kernels' work on ``cg``: unordered candidate pairs of
    distinct particles in one 27-cell stencil and those inside rcut, plus
    the home x straggler candidate pairs and those inside rcut."""
    import numpy as np
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.engine.kernel2 import _box

    spec = be.spec
    rc2 = float(np.float32(be.rcut * be.rcut))
    rows = torch.arange(spec.cap, device=cg.x.device)[None, None, :, None]
    pid_i = cg.pid[:, :, :, None, :]
    home = [a[:, :, :, None, :] for a in (cg.x, cg.y, cg.z)]
    cand = cut = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, lane, shifts = layout.stencil_sources(spec, dz, dy, dx, cg.x.device)
                pid_j = cg.pid[zs, ybs, rows, lane][:, :, None]
                both = (pid_i >= 0) & (pid_j >= 0) & (pid_i != pid_j)
                r2 = sum(((a[zs, ybs, rows, lane] + s)[:, :, None] - h) ** 2
                         for a, s, h in zip((cg.x, cg.y, cg.z), shifts, home))
                cand += int(both.sum())
                cut += int((both & (r2 < rc2)).sum())
    Ls, iLs = _box(spec.box_size, cg.x.device)
    act = cg.mask.reshape(-1)
    hp = torch.stack([a.reshape(-1)[act] for a in (cg.x, cg.y, cg.z)], -1)
    sp = cg.spos[cg.smask]
    d = sp[None, :, :] - hp[:, None, :]
    d = d - Ls * torch.round(d * iLs)
    s_cut = int(((d * d).sum(-1) < rc2).sum())
    return {"stencil": cand // 2, "stencil_in_rcut": cut // 2,
            "straggler": int(act.sum()) * int(sp.shape[0]), "straggler_in_rcut": s_cut}


def channel_ops_ms(pairs, nvec) -> float:
    """The least time for the function's float32 operations: each
    unordered pair tested once, each pair inside rcut evaluated once both
    ways."""
    cand = pairs["stencil"] + pairs["straggler"]
    inside = pairs["stencil_in_rcut"] + pairs["straggler_in_rcut"]
    ops = OPS_CH_TEST * cand + (OPS_CH_RADIAL + 2 * OPS_CH_APPLY * nvec) * inside
    return 1e3 * ops / PEAK_FP32_FLOPS


def pse_breakdown(run, card, errs):
    """Phase 4c: each part of the PSE step timed alone (CUDA events) at the
    path's final state, times its calls per step; and the rows of the
    channel kernels in the kernels line."""
    import torch
    from uammd_tpu_torch.engine import kernel2
    from uammd_tpu_torch.engine.layout import unpack_values
    from uammd_tpu_torch.integrators.bdhi.fcm import _sample_white_rfft
    from uammd_tpu_torch.solvers import lanczos
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    be, st, p, gen = run["be"], run["st"], run["pos"], run["gen"]
    dev = p.device
    m = be.lanczos_iterations
    cg, bins, _ = be._refresh(st, p)
    cg = with_channels(be, cg, dev, 29)
    spec = be.spec
    t, calls = {}, {}

    def args(nvec):
        return ([cg.x, cg.y, cg.z] + list(cg.channels[: 3 * nvec]),
                kernel2_strag_block(be, cg, nvec))

    fold_dev, fold_host = {}, {}
    for nvec in (1, 2):
        a, blk = args(nvec)
        knt = be._kernel(nvec, newton=True)
        # #10 and #9 as the path calls them: the kernel's one buffer, folded
        # as it is
        t[f"newton_channel_{3 * nvec}ch"] = cuda_ms(lambda: knt.raw_stacked(*a, strag=blk),
                                                    reps=10)
        raw, _ = knt.raw_stacked(*a, strag=blk)
        fold = kernel2.make_fold_kernel_n(spec, 3 * nvec)
        n0 = kernel2.FOLD_N.launches
        t[f"fold_n_{3 * nvec}ch"] = cuda_ms(lambda: fold.stacked(raw), reps=20)
        # warm: #10's buffer in L2, as the path hands it over; cold: from HBM,
        # the bytes its bound counts
        fold_dev[3 * nvec] = {l2: profiler_ms(lambda: fold.stacked(raw), ["fold_rows"], cold=c)
                              for l2, c in (("warm", False), ("cold", True))}
        for l2 in fold_dev[3 * nvec]:
            device_ms(fold_dev[3 * nvec][l2], f"#9 {3 * nvec} channels ({l2} L2)")
        fold_host[3 * nvec] = host_us(lambda: fold.stacked(raw))
        kernel2.FOLD_N.launches = n0
        k27 = be._kernel(nvec, newton=False)
        t[f"pair_channel_{3 * nvec}ch"] = cuda_ms(lambda: k27(*a, strag=blk), reps=5)
    calls.update({"newton_channel_6ch": 1.0, "newton_channel_3ch": m - 1.0,
                  "fold_n_6ch": 1.0, "fold_n_3ch": m - 1.0,
                  "pair_channel_6ch": 0.0, "pair_channel_3ch": 0.0})
    sf3 = cg.schannels[:3]
    t["straggler_pairs_radial"] = cuda_ms(lambda: (cg.__dict__.pop("_strag_radial", None),
                                                   be._strag_radial(cg, False)), reps=20)
    t["straggler_pairs_apply"] = cuda_ms(lambda: be._strag_pair_apply(cg, sf3), reps=20)
    calls["straggler_pairs_radial"] = 2.0  # the full and the noise radial
    calls["straggler_pairs_apply"] = m + 1.0  # M F and w0 in the fused pass; m - 1 more
    K = 3 * (spec.n_slots + spec.n_strag)
    v = torch.randn(K, generator=gen, device=dev)
    t["lanczos_vector_work"] = cuda_ms(lambda: lanczos.lanczos_sqrt_apply(
        lambda x: x * 1.5, v, m=m, w0=v * 1.5), reps=5)
    al, bt = torch.rand(m, device=dev) + 1.0, torch.rand(m + 1, device=dev) * 0.1
    t["lanczos_sqrt_T"] = cuda_ms(lambda: lanczos._sqrt_e1(al, bt, m), reps=10)
    t["lanczos_vector_work"] -= t["lanczos_sqrt_T"]
    calls["lanczos_vector_work"] = calls["lanczos_sqrt_T"] = 1.0
    fs = run["fs"]
    t["pair_force_newton_fold"] = cuda_ms(lambda: fs(cg), reps=10)
    calls["pair_force_newton_fold"] = 1.0
    # #7 alone on the Newton output of this state, as the step folds it
    n6 = kernel2.NEWTON_PAIR.launches
    strag6 = kernel2.broadcast_stragglers(spec, cg.spos, cg.spid) if spec.n_strag else None
    home6, groups6, _ = kernel2.make_newton_pair_kernel(spec, wca())(cg.x, cg.y, cg.z, strag6)
    kernel2.NEWTON_PAIR.launches = n6
    run["fold_times"] = fold_times(kernel2.make_fold_kernel(spec), home6, groups6)
    Ls = spec.box_size
    pos_w = torch.stack([p[:, d] - Ls[d] * torch.round(p[:, d] / Ls[d]) for d in range(3)], -1)
    t["near_rebin_sep_rebin"] = cuda_ms(lambda: be._near_repack(st, p, pos_w), reps=10)
    calls["near_rebin_sep_rebin"] = run["rebin_near"] / PSE_TIMED
    t["far_bin_pencils"] = cuda_ms(lambda: be.far.pencil_bins(p, slack=be.far_slack,
                                                              cap_extra=be.far_cap_extra), reps=10)
    calls["far_bin_pencils"] = run["rebin_far"] / PSE_TIMED
    t["refresh_gathers_and_drift"] = cuda_ms(lambda: be._refresh(st, p), reps=10)
    calls["refresh_gathers_and_drift"] = 1.0
    far, f = be.far, run["forces"]
    kern = far._kernel()
    field, _ = tp.spread_pencil_fused(kern, p, f, far.shape, be.box, bins, slack=be.far_slack)
    fk = torch.fft.rfftn(field, dim=(0, 1, 2))
    amp = math.sqrt(2.0 * PSE_T / PSE_DT)
    uk = far._kspace_combine(fk.clone(), _sample_white_rfft(gen, far.shape, far.dV,
                                                            torch.float32, dev), amp, p)
    u = torch.fft.irfftn(uk, s=far.shape, dim=(0, 1, 2))
    # the path's forces are 0 (no pair of the suspension is inside the WCA
    # cutoff): the rows spread seeded values of the same shape
    f_rand = torch.randn(f.shape, generator=torch.Generator(device=dev).manual_seed(17),
                         device=dev)
    far_rows = pencil_rows("_pse", "PSE path's final state (far field)", kern, p, f_rand, u,
                           far.shape, be.box, bins, be.far_slack, run["launches"])
    t["far_spread"], t["far_interp"] = far_rows[0]["ms"], far_rows[1]["ms"]
    t["far_ffts"] = (cuda_ms(lambda: torch.fft.rfftn(field, dim=(0, 1, 2)), reps=10)
                     + cuda_ms(lambda: torch.fft.irfftn(uk, s=far.shape, dim=(0, 1, 2)),
                               reps=10))
    clone_ms = cuda_ms(lambda: fk.clone(), reps=10)
    t["far_kspace_combine_and_noise"] = cuda_ms(lambda: far._kspace_combine(
        fk.clone(), _sample_white_rfft(gen, far.shape, far.dV, torch.float32, dev), amp, p),
        reps=10) - clone_ms
    for k in ("far_spread", "far_interp", "far_ffts", "far_kspace_combine_and_noise"):
        calls[k] = 1.0
    vals = (cg.x, cg.y, cg.z)
    svals = tuple(cg.spos[:, d] for d in range(3))
    t["unpack"] = cuda_ms(lambda: unpack_values(cg, vals, svalues=svals), reps=20)
    calls["unpack"] = 2.0  # forces and velocities
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        be._drift_flags(st, p).tolist()
    t["host_read"] = 1e3 * (time.perf_counter() - t0) / 20
    calls["host_read"] = 1.0
    per_step = {k: t[k] * calls[k] for k in t}
    ms = run["ms"]
    top = max(per_step, key=per_step.get)
    print(json.dumps({
        "phase": "breakdown_pse", "card": card, "ms_per_step": ms, "lanczos_m": m,
        "ms_per_call": t, "calls_per_step": calls, "ms_per_step_by_part": per_step,
        "shares": {k: v / ms for k, v in per_step.items()},
        "rest_ms": ms - sum(per_step.values()), "largest_part": top,
        "note": "each part timed alone with CUDA events at the path's final state (host "
                "clock for the host read, on an idle card); refresh includes the drift "
                "check and its host read and the gathers; rest = step minus the parts: "
                "the position update, the small torch ops, launch gaps"}), flush=True)

    print(json.dumps(pse_profile(run)), flush=True)

    # kernels line rows
    pairs = channel_pairs(be, cg)
    a1, blk1 = args(1)
    a2, blk2 = args(2)
    plain_27 = cuda_ms(lambda: channel_outputs(be, cg, 2, "27_plain"), reps=1, warmup=1)
    plain_nt = cuda_ms(lambda: channel_outputs(be, cg, 2, "newton_plain"), reps=1, warmup=1)
    raw, _ = be._kernel(2, newton=True).raw_stacked(*a2, strag=blk2)
    plain_fold = cuda_ms(lambda: kernel2.fold_reactions_n_plain(raw[0], raw[1:]), reps=5,
                         warmup=1)
    fold_want = kernel2.fold_reactions_n_plain(raw[0], raw[1:])
    fold_got = kernel2.make_fold_kernel_n(spec, 6).stacked(raw)
    check(all(torch.equal(x, y) for x, y in zip(fold_got, fold_want)),
          "PSE path's final state: #9's stacked entry bit-equal to plain (6 channels)")
    fold_err = max(float((x - y).abs().max()) for x, y in zip(fold_got, fold_want))
    ops2 = channel_ops_ms(pairs, 2)
    # n = 6: 30 grids read, 6 written (n = 3: half)
    fold_bytes = 1e3 * 4 * (5 * 6 + 6) * spec.n_slots / PEAK_HBM_BYTES
    # the 6-channel pass: 9 grids and the [10, S] rows read, 6 grids out
    ch_bytes = 1e3 * 4 * ((9 + 6) * spec.n_slots + 16 * spec.n_strag) / PEAK_HBM_BYTES
    launches = run["launches"]

    def row(name, src, rep, ms_, plain, bound_ops, bound_bytes, err, extra):
        return {"name": name, "route": "cuda", "source": f"uammd_tpu_torch/engine/csrc/{src}",
                "replaces": rep, "launches": launches.get(name, 0), "max_abs_err": err,
                "ms": ms_, "plain_ms": plain, "bound_ms": max(bound_ops, bound_bytes),
                "bound_by": "operations" if bound_ops > bound_bytes else "bytes",
                "library_ms": None, **extra}

    rows = [
        row("pair_channel", "pair_channel.cu", "uammd_tpu/engine/pair_kernel.py:538",
            t["pair_channel_6ch"], plain_27, ops2, ch_bytes, errs["err_27"],
            {"shape": "6 channels at the PSE path's final state", "pairs": pairs,
             "ms_3ch": t["pair_channel_3ch"],
             "launch_plan": channel_plan_of(spec, be.near_fn(), 2),
             "note": "off the main path on the card (newton=False, and the cross-check of #10)"}),
        row("newton_channel", "newton_channel.cu", "uammd_tpu/engine/kernel2.py:992",
            t["newton_channel_6ch"], plain_nt, ops2, ch_bytes, errs["err_newton"],
            {"shape": "6 channels at the PSE path's final state", "pairs": pairs,
             "ms_3ch": t["newton_channel_3ch"], "bound_ms_3ch": channel_ops_ms(pairs, 1),
             "bit_equal_calls": errs.get("newton_bit_equal_calls"),
             "launch_plan": newton_channel_plan_of(spec, 2),
             "launch_plan_3ch": newton_channel_plan_of(spec, 1)}),
        row("fold_n", "fold.cu", "uammd_tpu/engine/kernel2.py:702", t["fold_n_6ch"],
            plain_fold, 0.0, fold_bytes, fold_err,
            {"shape": "n = 6 at the PSE grid, the stacked entry on #10's buffer",
             "device_ms_profiler": fold_dev[6]["warm"],
             "device_ms_profiler_cold": fold_dev[6]["cold"], "host_us_a_call": fold_host[6],
             "ms_3ch": t["fold_n_3ch"], "device_ms_profiler_3ch": fold_dev[3]["warm"],
             "device_ms_profiler_cold_3ch": fold_dev[3]["cold"],
             "host_us_a_call_3ch": fold_host[3], "bound_ms_3ch": fold_bytes / 2,
             "launch_plan": {"threads": 256, "slots_a_thread": 4,
                             "blocks": [-(-spec.cap * spec.nlane // 1024),
                                        spec.shape[2] * spec.nyb]}}),
    ]
    # #5 at Q 4 and OCAP 16 on the inputs a near rebin at the final state gets
    stacked, sstack = be._near_rebin_inputs(st, p)
    rows.append(sep_row("_pse", spec, be.NEAR_REBIN_OCAP, stacked, sstack,
                        launches.get("separable_rebin", 0), "the PSE path's final state"))
    return rows + far_rows


def pse_counters() -> dict:
    from uammd_tpu_torch.engine import kernel2, pair_kernel, rebin_kernel
    from uammd_tpu_torch.solvers import pencil_ibm

    from uammd_tpu_torch.solvers import lanczos

    return {"newton_channel": kernel2.NEWTON_CHANNEL, "fold_n": kernel2.FOLD_N,
            "lanczos_sqrt": lanczos.LANCZOS_SQRT,
            "pair_channel": pair_kernel.PAIR_CHANNEL, "newton_pair": kernel2.NEWTON_PAIR,
            "fold": kernel2.FOLD, "separable_rebin": rebin_kernel.SEP_REBIN,
            "pencil_spread": pencil_ibm.SPREAD, "pencil_interp": pencil_ibm.INTERP}


def pse_only(dev, card) -> int:
    """``--only-pse``: the PSE phases alone, for working on them; prints
    no result line."""
    errs = pse_kernel_checks(dev)
    run = pse_main_path(dev, pse_counters())
    print(json.dumps({"kernels": pse_breakdown(run, card, errs)}), flush=True)
    check(not run["fails"], "; ".join(run["fails"]))
    return 0


# ------------------------------------------------ slice D: DPD, SPH, LJ mixtures, observables
# DPD: Groot-Warren water (J. Chem. Phys. 107, 4423 (1997); the parameters of
# tests/test_engine_dpd.py:36) at number density 3
DPD_RHO = 3.0
DPD_L = (N / DPD_RHO) ** (1.0 / 3.0)
DPD_KW = dict(rc=1.0, A=25.0, gamma=4.5, temperature=1.0, dt=0.01)
# SPH: the fluid of examples/dambreak.py:40-41 (the reference's
# misc/dambreak.cu) as a periodic bulk at the dam's particle spacing 0.8,
# velocities 0.3 N(0, 1) as tests/test_engine_sph.py:17-23 draws them, at
# the dam break's dt
SPH_RHO = 1.0 / 0.8 ** 3
SPH_L = (N / SPH_RHO) ** (1.0 / 3.0)
SPH_KW = dict(support=1.0, viscosity=20.0, gas_stiffness=15.0, rest_density=1.2)
SPH_DT, SPH_V0 = 0.004, 0.3
D_WARM, D_TIMED = 100, 200
D_HOST_READ_STEPS = 3
DPD_T_TOL = 0.05
MOMENTUM_TOL = 1e-4  # |total momentum| / N
# LJ mixtures: tests/test_mixtures.py:32-41's binary (eps 1.0 / 0.5, sigma
# 1.0 / 1.6, cut_scale 2.5) at number density 0.3; the two-grid hierarchy at
# 8x the counts of test_mixtures.py:67-80 in a box twice as wide
MIX_RHO = 0.3
MIX_L = (N / MIX_RHO) ** (1.0 / 3.0)
MIX_CUT = 2.5
HIER_L, HIER_SMALL, HIER_LARGE = 72.0, 2400, 128
# float32 operations per pair inside the functor's cutoff, each pair once
# and both directions (on top of OPS_PAIR_TEST per candidate pair), and
# the DPD hash's 32-bit integer operations, which Hopper issues at half the
# float32 rate (64 INT32 lanes against 128 FP32 lanes per SM, NVIDIA's
# Hopper white paper). DPD: rsqrt, w, v.r, the variate, the force and its
# sums into both particles (36); the three hashes, min/max and conversions
# (121 integer). SPH density: sqrt, q, the spline and its sums (17); SPH
# force: dv.dr, viscosity, sqrt, q, dW/dq, the force and its sums (41); LJ
# mixture: mixing, per-pair cutoff, clamp, radial and sums (25, masked 27).
# #1's observable mode adds the energy, virial and six stress sums (37) to
# OPS_PAIR_FORCE.
OPS_DPD, OPS_DPD_INT = 36, 121
OPS_SPH_DENSITY, OPS_SPH_FORCE = 17, 41
OPS_LJ_MIX, OPS_LJ_MIX_MASKED = 25, 27
OPS_PAIR_OBS = OPS_PAIR_FORCE + 37
# float64 peak outside the tensor cores (H100 SXM data sheet), for the
# Lanczos eigensolve (about 9 m^3 operations)
PEAK_FP64_FLOPS = 34e12
SQRT_TOL = 1e-10


def fcc_start(n, L, jitter, seed):
    """fcc sites moved by a Gaussian of ``jitter`` per axis (numpy)."""
    import numpy as np
    from uammd_tpu_torch.utils.lattices import lattice

    rng = np.random.default_rng(seed)
    return np.asarray(lattice(n, L, "fcc")) + jitter * rng.standard_normal((n, 3))


def zero_momentum(n, scale, seed):
    """``scale`` N(0, 1) velocities with their mean removed (numpy float32)."""
    import numpy as np

    v = scale * np.random.default_rng(seed).standard_normal((n, 3))
    return (v - v.mean(axis=0)).astype(np.float32)


def outs_err(ref, test) -> float:
    """max|d| over every output / max|ref|."""
    scale = max(float(a.abs().max()) for a in ref)
    return max(float((a - b).abs().max()) for a, b in zip(ref, test)) / scale


def check_functor(spec, fn, args, what, control=None, info=None):
    """#2 with ``fn`` against its plain version on ``args`` (x, y, z,
    channels), max|d| < CHANNEL_TOL x max|ref|; ``control`` (a
    JAX-signature pair_fn with a planted fault) must fail the bound.
    Returns (rel err, control rel err, max abs err).

    With ``info`` (a dict, filled in) the bound's scale is instead the
    largest per-slot sum of the terms' magnitudes, sum_j |term_ij|: a sum
    whose terms cancel (SPH's pressure force in a uniform bulk) differs
    between two float32 summation orders by a few ulp of that scale, not of
    its small result. ``info`` also gets the max|ref| ratio and both
    float32 versions against a float64 plain evaluation."""
    from uammd_tpu_torch.engine import pair_kernel

    got = pair_kernel.make_pair_channel_kernel(spec, fn)(*args)
    want = pair_kernel.channel_plain(spec, fn, fn.n_out, *args[:3], args[3:])
    for a in got:
        check(bool(a.isfinite().all()), f"{what}: outputs finite")
    err_abs = max(float((a - b).abs().max()) for a, b in zip(want, got))
    scale = max(float(a.abs().max()) for a in want)
    if info is not None:
        absum = pair_kernel.channel_plain(
            spec, lambda *a: tuple(t.abs() for t in fn(*a)), fn.n_out, *args[:3], args[3:])
        f64 = pair_kernel.channel_plain(spec, fn, fn.n_out, *(a.double() for a in args[:3]),
                                        [c.double() for c in args[3:]])
        info.update({"rel_err_vs_max_ref": err_abs / scale,
                     "rel_err_vs_float64_plain": {"kernel": outs_err(f64, got),
                                                  "plain": outs_err(f64, want)}})
        scale = max(float(a.max()) for a in absum)
        info["scale_sum_abs_terms"] = scale
        del absum, f64
    err = err_abs / scale
    check(err < CHANNEL_TOL, f"{what}: #2 vs plain {err:.3g} < {CHANNEL_TOL}")
    c = None
    if control is not None:
        wrong = pair_kernel.channel_plain(spec, control, fn.n_out, *args[:3], args[3:])
        c = max(float((a - b).abs().max()) for a, b in zip(wrong, got)) / scale
        check(c > CHANNEL_TOL, f"{what}: control fails the bound ({c:.3g})")
    return err, c, err_abs


def dpd_args(md, gs):
    return (gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz, gs.pid.float(), gs.step.float())


def sph_args(md, gs):
    """The channels of both SPH sweeps at ``gs``: (density args, force args)."""
    import numpy as np
    import torch

    p = md.params
    m = gs.mask
    mch = md._mass_channel(gs)
    rho = md.density(gs)
    rho_s = torch.where(m, rho, torch.ones_like(rho))
    pr = float(np.float32(p.gas_stiffness)) * (rho_s - float(np.float32(p.rest_density)))
    pdr = torch.where(m, pr / (rho_s * rho_s), torch.zeros_like(rho))
    return (gs.x, gs.y, gs.z, mch), (gs.x, gs.y, gs.z, pdr, gs.vx, gs.vy, gs.vz, mch)


def dpd_control(fn):
    """DPD hashed with the step counter off by one."""
    return lambda r2, dx, dy, dz, ci, cj: fn(r2, dx, dy, dz, ci[:4] + [ci[4] + 1.0], cj)


def sph_control(fn):
    """SPH's force with p_j dropped."""
    import torch

    return lambda r2, dx, dy, dz, ci, cj: fn(r2, dx, dy, dz, ci,
                                             [torch.zeros_like(cj[0])] + list(cj[1:]))


def mix_control(fn_plain):
    """The masked mixture with the small-small mask ignored."""
    return lambda r2, dx, dy, dz, ci, cj: fn_plain(r2, dx, dy, dz, ci[:2], cj[:2])


def hierarchy_system():
    """HIER_SMALL sigma-0.5 and HIER_LARGE sigma-4 particles placed uniformly
    at random in the HIER_L box, each rejected while it sits closer than
    0.9 sigma_ij to one placed before (the test's uniform placement without
    the deep overlaps whose clamped forces would swamp a relative bound):
    every pair class interacts."""
    import numpy as np

    rng = np.random.default_rng(41)
    sigma = np.concatenate([np.full(HIER_LARGE, 4.0), np.full(HIER_SMALL, 0.5)])
    eps = np.concatenate([np.full(HIER_LARGE, 0.6), np.full(HIER_SMALL, 1.0)])
    pos = np.zeros((len(sigma), 3))
    for i in range(len(sigma)):
        while True:
            p = (rng.random(3) - 0.5) * HIER_L
            d = pos[:i] - p
            d -= HIER_L * np.round(d / HIER_L)
            if not ((d * d).sum(1) < (0.45 * (sigma[:i] + sigma[i])) ** 2).any():
                break
        pos[i] = p
    return pos.astype(np.float32), eps, sigma


def obs_check(gs, what):
    """#1's observable mode against its plain version on a repack of
    ``gs`` (every output within CHANNEL_TOL x its max|ref|), trace(stress)
    = virial, and the control (the energy not halved) that must fail."""
    from uammd_tpu_torch.engine import layout, md, pair_kernel

    pos = layout.unpack(gs)[0]
    spec0 = layout.choose_spec(gs.spec.box_size, gs.n, gs.spec.cutoff, skin=gs.spec.skin,
                               pos=pos.cpu().numpy(), n_strag=0)
    g0 = layout.pack(spec0, pos, device=gs.device)
    kern = pair_kernel.make_pair_force_kernel(spec0, md.lj_g(), md.lj_e(), compute_virial=True,
                                              compute_stress=True)
    got = kern(g0.x, g0.y, g0.z)
    want = pair_kernel.pair_force_plain(spec0, md.lj_g(), g0.x, g0.y, g0.z, e_fn=md.lj_e(),
                                        compute_virial=True, compute_stress=True)
    m = g0.mask
    errs = []
    for a, b in zip(got, want):
        errs.append(float((a[m] - b[m]).abs().max() / b[m].abs().max()))
    err = max(errs)
    check(err < CHANNEL_TOL, f"{what}: #1 observables vs plain {err:.3g} < {CHANNEL_TOL}")
    vir = got[4][m]
    trace = (got[5] + got[8] + got[10])[m]
    tr = float((trace - vir).abs().max() / vir.abs().max())
    check(tr < CHANNEL_TOL, f"{what}: trace(stress) = virial {tr:.3g} < {CHANNEL_TOL}")
    c = float((got[3][m] - 2.0 * want[3][m]).abs().max() / want[3][m].abs().max())
    check(c > CHANNEL_TOL, f"{what}: control, the energy not halved, fails ({c:.3g})")
    return {"rel_err": err, "trace_vs_virial": tr, "control_energy_not_halved": c,
            "max_abs_err": max(float((a[m] - b[m]).abs().max()) for a, b in zip(got, want)),
            "spec": list(spec0.array_shape)}, g0, kern


def lanczos_checks(dev):
    """The Jacobi sqrt(T) e1 kernel against eigh with the clamp on
    indefinite tridiagonals (the 2 x 2 of ROADMAP's fault 1 and random ones
    up to m 48)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.solvers import lanczos

    errs = {}
    for e in (1e-7, 1e-4):
        a = torch.tensor([0.5, 0.5], dtype=torch.float64)
        b = torch.tensor([0.0, 0.5 + e], dtype=torch.float64)
        got = lanczos._sqrt_e1(a.to(dev), b.to(dev), 2).cpu()
        want = lanczos.sqrt_e1_plain(a, b, 2)
        check(bool(got.isfinite().all()), f"sqrt(T) e1 finite on the indefinite 2 x 2 (e {e})")
        errs[f"2x2_e{e}"] = float((got - want).abs().max())
        check(errs[f"2x2_e{e}"] < SQRT_TOL, f"sqrt(T) e1 2 x 2 (e {e}) vs eigh")
    rng = np.random.default_rng(5)
    for m in (4, 16, 48):
        a, b = torch.tensor(rng.normal(size=m)), torch.tensor(rng.normal(size=m))
        got = lanczos._sqrt_e1(a.to(dev), b.to(dev), m).cpu()
        want = lanczos.sqrt_e1_plain(a, b, m)
        errs[f"random_m{m}"] = float((got - want).abs().max() / want.abs().max())
        check(errs[f"random_m{m}"] < SQRT_TOL,
              f"sqrt(T) e1 on an indefinite m {m} vs eigh {errs[f'random_m{m}']:.3g}")
    return errs


def slice_d_kernel_checks(dev):
    """Phase 2d: the five new functors of #2 and #1's observable mode against
    their plain versions on small systems, with a control each that must
    fail the bound; the Lanczos sqrt kernel on indefinite tridiagonals."""
    import numpy as np
    import torch
    from uammd_tpu_torch.engine import layout, mixtures
    from uammd_tpu_torch.engine.dpd import GridDPD
    from uammd_tpu_torch.engine.sph import GridSPH
    from uammd_tpu_torch.interactors.sph import SPHParams

    out = {"phase": "slice_d_kernels_vs_plain", "tol": CHANNEL_TOL}
    n = 4000
    L = (n / DPD_RHO) ** (1.0 / 3.0)
    pos = fcc_start(n, L, 0.1, 1)
    md = GridDPD.create(L, n, pos=pos, device=dev, **DPD_KW)
    gs = layout.pack(md.spec, pos, vel=zero_momentum(n, 1.0, 2), device=dev).replace(
        step=torch.tensor(7, dtype=torch.int32, device=dev))
    out["dpd_n4000"] = check_functor(md.spec, md.kern.fn, dpd_args(md, gs), "DPD n 4000",
                                     dpd_control(md.kern.fn))[:2]
    L = (n / SPH_RHO) ** (1.0 / 3.0)
    pos = fcc_start(n, L, 0.1, 3)
    ms = GridSPH.create(L, n, SPHParams(**SPH_KW), dt=SPH_DT, pos=pos, device=dev)
    gs = layout.pack(ms.spec, pos, vel=zero_momentum(n, SPH_V0, 4), device=dev)
    a_rho, a_f = sph_args(ms, gs)
    out["sph_density_n4000"] = check_functor(ms.spec, ms.rho_kern.fn, a_rho,
                                             "SPH density n 4000")[:2]
    out["sph_force_n4000"] = check_functor(ms.spec, ms.f_kern.fn, a_f, "SPH force n 4000",
                                           sph_control(ms.f_kern.fn))[:2]
    L = (n / MIX_RHO) ** (1.0 / 3.0)
    pos = fcc_start(n, L, 0.1, 5)
    rng = np.random.default_rng(6)
    t = rng.integers(0, 2, n)
    eps, sig = np.where(t == 0, 1.0, 0.5), np.where(t == 0, 1.0, 1.6)
    mx = mixtures.MixtureLJ.create(L, n, eps, sig, cut_scale=MIX_CUT, device=dev)
    cg = layout.pack_channels(mx.spec, torch.tensor(pos, dtype=torch.float32, device=dev),
                              mixtures._channels(eps, sig, dev))
    out["lj_mix_n4000"] = check_functor(mx.spec, mx.kern.fn, (cg.x, cg.y, cg.z, *cg.channels),
                                        "LJ mixture n 4000")[:2]
    pos, eps, sig = hierarchy_system()
    mh = mixtures.MixtureLJHierarchical.create(HIER_L, len(pos), eps, sig, cut_scale=MIX_CUT,
                                               device=dev)
    flag = torch.zeros(len(pos), dtype=torch.float32, device=dev)
    flag[list(mh.small_idx)] = 1.0
    cg = layout.pack_channels(mh.coarse_spec, torch.tensor(pos, device=dev),
                              mixtures._channels(eps, sig, dev, flag))
    fn = mh.kern_coarse.fn
    out["lj_mix_masked_hierarchy"] = check_functor(
        mh.coarse_spec, fn, (cg.x, cg.y, cg.z, *cg.channels), "masked LJ mixture hierarchy",
        mix_control(mixtures.LJMixturePair(MIX_CUT)))[:2]
    fine = mh.fine
    cgf = layout.pack_channels(fine.spec, torch.tensor(pos[list(mh.small_idx)], device=dev),
                               mixtures._channels(eps[list(mh.small_idx)],
                                                  sig[list(mh.small_idx)], dev))
    out["lj_mix_fine_grid"] = check_functor(fine.spec, fine.kern.fn,
                                            (cgf.x, cgf.y, cgf.z, *cgf.channels),
                                            "LJ mixture fine grid")[:2]
    # #1 with every output on a jittered sc lattice at rho 0.5 (spacing
    # 1.26, no pair closer than 0.86)
    n1 = 4096
    L1 = (n1 / 0.5) ** (1.0 / 3.0)
    from uammd_tpu_torch.utils.lattices import lattice

    p1 = np.asarray(lattice(n1, L1, "sc")) + np.random.default_rng(8).uniform(
        -0.2, 0.2, (n1, 3))
    g1 = layout.pack(layout.choose_spec(L1, n1, 2.5, pos=p1), p1, device=dev)
    out["pair_force_obs_n4096"] = obs_check(g1, "#1 observables n 4096")[0]
    out["lanczos_sqrt"] = lanczos_checks(dev)
    out["ok"] = True
    print(json.dumps(out), flush=True)
    return out


def host_reads(step, steps: int) -> list:
    """The synchronising CUDA calls of ``steps`` calls of ``step()``, found
    by PyTorch's sync debug mode: for each, the innermost frame of the
    repo's code (file:line) that led to it. A sync with no frame of the
    port's code on the stack is not the step's (one shows up once, on the
    first counted call), so chip_smoke's own frames are left out; garbage
    from earlier phases is freed first, so that no finalizer runs inside
    the counted steps."""
    import gc
    import traceback
    import warnings
    import torch

    where = []

    def show(message, category, filename, lineno, *args, **kw):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "uammd_tpu_torch" in f.filename or "chip_smoke" in f.filename]
            f = frames[-1] if frames else None
            where.append(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}" if f else
                         f"{filename.rsplit('/', 1)[-1]}:{lineno}")

    gc.collect()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [w for w in where if not w.startswith("chip_smoke")]


def engine_path(what, md, gs, counted, per_step, on_drift, t_fn=None):
    """D_WARM + D_TIMED steps of a DPD or SPH engine with the launch counts
    zeroed just before; the mean of ``t_fn`` over the timed steps is kept on
    the card. Returns the run's record."""
    import torch

    for k in counted.values():
        k.launches = 0
    for _ in range(D_WARM):
        gs = md.step(gs)
    torch.cuda.synchronize()
    before = {k: v.launches for k, v in counted.items()}
    rebins = counted["rebin"].launches
    t_sum = torch.zeros((), dtype=torch.float64, device=gs.device)
    t0 = time.perf_counter()
    for _ in range(D_TIMED):
        gs = md.step(gs)
        if t_fn is not None:
            t_sum += t_fn(gs)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    timed = {k: launches[k] - before[k] for k in counted}
    rebins = counted["rebin"].launches - rebins
    reads = host_reads(lambda: md.step(gs), D_HOST_READ_STEPS)
    n_kept = int((gs.pid >= 0).sum())
    mom = [float(a.double().sum()) / N for a in (gs.vx, gs.vy, gs.vz)]
    check(not bool(gs.overflow), f"{what}: no overflow")
    check(n_kept == N, f"{what}: all particles kept: {n_kept} == {N}")
    check(all(bool(a.isfinite().all()) for a in (gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz)),
          f"{what}: positions and velocities finite")
    check(max(abs(p) for p in mom) < MOMENTUM_TOL,
          f"{what}: |total momentum| / N {mom} < {MOMENTUM_TOL}")
    for k in per_step:
        check(timed[k] == D_TIMED, f"{what}: {k} launched {timed[k]} == {D_TIMED} times")
    for k in on_drift:
        check(timed[k] >= 1, f"{what}: {k} launched on drift ({timed[k]} >= 1)")
    reads_per_step = len(reads) / D_HOST_READ_STEPS
    check(reads_per_step <= 1, f"{what}: {reads_per_step} host reads per step {reads}")
    return {"gs": gs, "timed_s": timed_s, "ms": 1e3 * timed_s / D_TIMED,
            "launches": launches, "timed": timed, "rebins": rebins,
            "t_mean": float(t_sum) / D_TIMED if t_fn is not None else None,
            "momentum_per_particle": mom, "host_reads_per_step": reads_per_step,
            "host_reads_at": reads, "particles_kept": n_kept}


def dpd_main_path(dev):
    """Phase 3e: Groot-Warren water at N = 2^20, number density 3."""
    from uammd_tpu_torch.engine import pair_kernel, rebin_kernel
    from uammd_tpu_torch.engine.dpd import GridDPD

    # jitter 0.13: a start near the liquid's potential energy, so that the
    # kinetic temperature settles within the warm-up (a near-perfect lattice
    # starts cold, a strongly jittered one hot, and either takes a few time
    # units to relax)
    pos = fcc_start(N, DPD_L, 0.13, 11)
    t0 = time.perf_counter()
    md = GridDPD.create(DPD_L, N, pos=pos, device=dev, **DPD_KW)
    gs = md.init(pos, vel=zero_momentum(N, math.sqrt(DPD_KW["temperature"]), 12))
    counted = {"pair_channel_dpd": pair_kernel.PAIR_CHANNEL_DPD, "rebin": rebin_kernel.REBIN}
    setup_s = time.perf_counter() - t0
    run = engine_path("DPD path", md, gs, counted, ["pair_channel_dpd"], ["rebin"],
                      t_fn=md.temperature_of)
    t = run["t_mean"]
    check(abs(t - DPD_KW["temperature"]) < DPD_T_TOL * DPD_KW["temperature"],
          f"DPD path: mean kinetic T {t:.4f} within {DPD_T_TOL:.0%} of 1")
    out = {"phase": "main_path_dpd", "n": N, "box": DPD_L, "density": DPD_RHO, **DPD_KW,
           "spec": list(md.spec.array_shape), "warmup_steps": D_WARM, "timed_steps": D_TIMED,
           "setup_seconds": setup_s, "timed_seconds": run["timed_s"], "ms_per_step": run["ms"],
           "particle_steps_per_s": N * D_TIMED / run["timed_s"],
           "temperature_mean_timed": t, "momentum_per_particle": run["momentum_per_particle"],
           "particles_kept": run["particles_kept"], "overflow": False,
           "rebins_timed": run["rebins"], "launches": run["launches"],
           "timed_launches": run["timed"], "host_reads_per_step": run["host_reads_per_step"],
           "host_reads_at": run["host_reads_at"],
           "note": "the timed steps include summing the kinetic temperature on the card"}
    print(json.dumps(out), flush=True)
    run["md"] = md
    return run


def sph_main_path(dev):
    """Phase 3f: the dam break's fluid as a periodic bulk at N = 2^20."""
    from uammd_tpu_torch.engine import pair_kernel, rebin_kernel
    from uammd_tpu_torch.engine.sph import GridSPH
    from uammd_tpu_torch.interactors.sph import SPHParams

    pos = fcc_start(N, SPH_L, 0.05, 13)
    t0 = time.perf_counter()
    md = GridSPH.create(SPH_L, N, SPHParams(**SPH_KW), dt=SPH_DT, pos=pos, device=dev)
    gs = md.init(pos, vel=zero_momentum(N, SPH_V0, 14))
    counted = {"pair_channel_sph_density": pair_kernel.PAIR_CHANNEL_SPH_DENSITY,
               "pair_channel_sph_force": pair_kernel.PAIR_CHANNEL_SPH_FORCE,
               "rebin": rebin_kernel.REBIN}
    setup_s = time.perf_counter() - t0
    run = engine_path("SPH path", md, gs, counted,
                      ["pair_channel_sph_density", "pair_channel_sph_force"], [])
    rho = md.density(run["gs"])[run["gs"].mask]
    out = {"phase": "main_path_sph", "n": N, "box": SPH_L, "number_density": SPH_RHO,
           **SPH_KW, "dt": SPH_DT, "spec": list(md.spec.array_shape), "warmup_steps": D_WARM,
           "timed_steps": D_TIMED, "setup_seconds": setup_s, "timed_seconds": run["timed_s"],
           "ms_per_step": run["ms"], "particle_steps_per_s": N * D_TIMED / run["timed_s"],
           "momentum_per_particle": run["momentum_per_particle"],
           "density_mean_min_max": [float(rho.mean()), float(rho.min()), float(rho.max())],
           "particles_kept": run["particles_kept"], "overflow": False,
           "rebins_timed": run["rebins"], "launches": run["launches"],
           "timed_launches": run["timed"], "host_reads_per_step": run["host_reads_per_step"],
           "host_reads_at": run["host_reads_at"]}
    print(json.dumps(out), flush=True)
    run["md"] = md
    return run


def functor_pairs(spec, x, y, z, pid, rc2_of) -> dict:
    """The channel kernel's work on a state: unordered candidate pairs of
    distinct particles in one 27-cell stencil, and those inside the
    functor's cutoff (``rc2_of(i_slot_index, j_gather)`` gives the per-pair
    cutoff squared; a float for a fixed one)."""
    import torch
    from uammd_tpu_torch.engine import layout

    rows = torch.arange(spec.cap, device=x.device)[None, None, :, None]
    pid_i = pid[:, :, :, None, :]
    home = [a[:, :, :, None, :] for a in (x, y, z)]
    cand = inside = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, lane, shifts = layout.stencil_sources(spec, dz, dy, dx, x.device)
                pid_j = pid[zs, ybs, rows, lane][:, :, None]
                both = (pid_i >= 0) & (pid_j >= 0) & (pid_i != pid_j)
                r2 = sum(((a[zs, ybs, rows, lane] + s)[:, :, None] - h) ** 2
                         for a, s, h in zip((x, y, z), shifts, home))
                rc2 = rc2_of((zs, ybs, rows, lane)) if callable(rc2_of) else rc2_of
                cand += int(both.sum())
                inside += int((both & (r2 < rc2)).sum())
    return {"candidates": cand // 2, "inside": inside // 2}


def functor_row(name, rep, launches, err_abs, ms, plain_ms, pairs, ops, n_io, spec,
                int_ops=0, extra=None, fn=None):
    """A kernels-line row for one #2 functor instantiation: the bound is the
    larger of the operations (OPS_PAIR_TEST per candidate pair, ``ops``
    float32 and ``int_ops`` integer operations per pair inside) and the
    bytes (``n_io`` grids in and out). With the functor ``fn`` the row also
    carries the launch plan (``channel_plan_of``)."""
    ops_ms = 1e3 * ((OPS_PAIR_TEST * pairs["candidates"] + ops * pairs["inside"])
                    / PEAK_FP32_FLOPS + int_ops * pairs["inside"] / (PEAK_FP32_FLOPS / 2))
    bytes_ms = 1e3 * 4 * n_io * spec.n_slots / PEAK_HBM_BYTES
    return {"name": name, "route": "cuda",
            "source": "uammd_tpu_torch/engine/csrc/pair_channel.cu (+ channel_functors.cuh)",
            "replaces": rep, "launches": launches, "max_abs_err": err_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes", "library_ms": None,
            "pairs": pairs, **(extra or {}),
            **({"launch_plan": channel_plan_of(spec, fn)} if fn is not None else {})}


def engine_breakdown(what, run, card, parts):
    """Each part of a DPD / SPH step timed alone with CUDA events at the
    path's final state, times its calls per step; ``parts`` holds the
    channel-kernel sweeps' ms."""
    import torch
    from uammd_tpu_torch.engine.dpd import force_kick, kick_drift
    from uammd_tpu_torch.engine.rebin_kernel import rebin_fast_noforce

    md, gs = run["md"], run["gs"]
    t, calls = dict(parts), {k: 1.0 for k in parts}
    kd = cuda_ms(lambda: kick_drift(md, gs), reps=20)
    t["update"] = kd + cuda_ms(lambda: force_kick(md, gs), reps=10) - sum(parts.values())
    t["rebin"] = cuda_ms(lambda: rebin_fast_noforce(gs), reps=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        float(kick_drift(md, gs)[1])
    t["drift_read"] = 1e3 * (time.perf_counter() - t0) / 20 - kd
    calls.update({"update": 1.0, "rebin": run["rebins"] / D_TIMED, "drift_read": 1.0})
    per_step = {k: t[k] * calls[k] for k in t}
    print(json.dumps({
        "phase": f"breakdown_{what}", "card": card, "ms_per_step": run["ms"],
        "ms_per_call": t, "calls_per_step": calls, "ms_per_step_by_part": per_step,
        "shares": {k: v / run["ms"] for k, v in per_step.items()},
        "rest_ms": run["ms"] - sum(per_step.values()),
        "note": "CUDA events on an idle card; update = both half kicks, the drift and the "
                "pressure (SPH) without the sweeps; drift_read = host clock around a fresh "
                "drift and its read, minus the drift's device time"}), flush=True)


def slice_d_paths(dev, card, gs2, engine2, keep=None):
    """Phases 3e-3h and 4d: the DPD and SPH paths, the mixtures at N = 2^20
    and the two-grid hierarchy, the observables on the v2 LJ path's final
    state; the kernels at each one's final state; returns the kernels-line
    rows of #2's five functors and #1's observable mode. With ``keep`` (a
    dict), ``keep["sph"]`` gets the SPH path's (GridSPH, final GridState)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.engine import layout, mixtures, pair_kernel
    from uammd_tpu_torch.engine.observe import lj_pressure

    rows = []
    # DPD
    dpd = dpd_main_path(dev)
    md, gs = dpd["md"], dpd["gs"]
    args = dpd_args(md, gs)
    err, c, err_abs = check_functor(md.spec, md.kern.fn, args, "DPD path final state",
                                    dpd_control(md.kern.fn))
    fn = md.kern.fn
    pair_ms = cuda_ms(lambda: md.kern(*args), reps=20)
    plain_ms = cuda_ms(lambda: pair_kernel.channel_plain(md.spec, fn, 3, *args[:3], args[3:]),
                       reps=1, warmup=1)
    engine_breakdown("dpd", dpd, card, {"pair_channel_dpd": pair_ms})
    rows.append(rebin_row("_dpd", gs, dpd["launches"]["rebin"], "DPD path final state", 44))
    pairs = functor_pairs(md.spec, gs.x, gs.y, gs.z, gs.pid, fn.rc2)
    rows.append(functor_row("pair_channel_dpd",
                            "uammd_tpu/engine/pair_kernel.py:538 (dpd_pair_fn, "
                            "uammd_tpu/engine/dpd.py:72)",
                            dpd["launches"]["pair_channel_dpd"], err_abs, pair_ms, plain_ms,
                            pairs, OPS_DPD, 10, md.spec, int_ops=OPS_DPD_INT,
                            extra={"rel_err": err, "control_step_off_by_one": c,
                                   "shape": list(md.spec.array_shape)}, fn=fn))
    del dpd, md, gs, args
    # SPH
    sph = sph_main_path(dev)
    ms, gs = sph["md"], sph["gs"]
    a_rho, a_f = sph_args(ms, gs)
    e_rho, _, abs_rho = check_functor(ms.spec, ms.rho_kern.fn, a_rho, "SPH path density")
    # the force of a uniform bulk is a sum of pressure terms that cancel: the
    # bound's scale is sum_j |term| there (check_functor)
    f_info = {}
    e_f, c_f, abs_f = check_functor(ms.spec, ms.f_kern.fn, a_f, "SPH path force",
                                    sph_control(ms.f_kern.fn), info=f_info)
    rho_ms = cuda_ms(lambda: ms.rho_kern(*a_rho), reps=10)
    f_ms = cuda_ms(lambda: ms.f_kern(*a_f), reps=10)
    rho_plain = cuda_ms(lambda: pair_kernel.channel_plain(ms.spec, ms.rho_kern.fn, 1,
                                                          *a_rho[:3], a_rho[3:]),
                        reps=1, warmup=1)
    f_plain = cuda_ms(lambda: pair_kernel.channel_plain(ms.spec, ms.f_kern.fn, 3, *a_f[:3],
                                                        a_f[3:]), reps=1, warmup=1)
    engine_breakdown("sph", sph, card, {"pair_channel_sph_density": rho_ms,
                                        "pair_channel_sph_force": f_ms})
    rows.append(rebin_row("_sph", gs, sph["launches"]["rebin"], "SPH path final state", 45))
    pairs = functor_pairs(ms.spec, gs.x, gs.y, gs.z, gs.pid, ms.f_kern.fn.cut2)
    rep = "uammd_tpu/engine/pair_kernel.py:538 ({}, uammd_tpu/engine/sph.py:{})"
    rows.append(functor_row("pair_channel_sph_density", rep.format("sph_density_pair_fn", 42),
                            sph["launches"]["pair_channel_sph_density"], abs_rho, rho_ms,
                            rho_plain, pairs, OPS_SPH_DENSITY, 5, ms.spec,
                            extra={"rel_err": e_rho, "shape": list(ms.spec.array_shape)},
                            fn=ms.rho_kern.fn))
    rows.append(functor_row("pair_channel_sph_force", rep.format("sph_force_pair_fn", 55),
                            sph["launches"]["pair_channel_sph_force"], abs_f, f_ms, f_plain,
                            pairs, OPS_SPH_FORCE, 11, ms.spec,
                            extra={"rel_err_vs_sum_abs_terms": e_f, **f_info,
                                   "control_p_j_dropped": c_f,
                                   "shape": list(ms.spec.array_shape)}, fn=ms.f_kern.fn))
    if keep is not None:
        keep["sph"] = (ms, gs)
    del sph, ms, gs, a_rho, a_f
    # LJ mixture at N = 2^20
    rng = np.random.default_rng(15)
    pos = torch.tensor(fcc_start(N, MIX_L, 0.1, 16), dtype=torch.float32, device=dev)
    t = rng.integers(0, 2, N)
    eps = torch.tensor(np.where(t == 0, 1.0, 0.5), dtype=torch.float32, device=dev)
    sig = torch.tensor(np.where(t == 0, 1.0, 1.6), dtype=torch.float32, device=dev)
    k_mix = pair_kernel.PAIR_CHANNEL_LJ_MIX
    k_mix.launches = 0
    mx = mixtures.MixtureLJ.create(MIX_L, N, eps.cpu().numpy(), sig.cpu().numpy(),
                                   cut_scale=MIX_CUT, device=dev)
    f_mix, ovf = mx.forces(pos, eps, sig)
    mix_launches = k_mix.launches
    check(not bool(ovf) and bool(f_mix.isfinite().all()), "mixture N = 2^20: no overflow, finite")
    check(mix_launches == 1, f"mixture N = 2^20: #2 launched once ({mix_launches})")
    forces_ms = cuda_ms(lambda: mx.forces(pos, eps, sig), reps=5)
    cg = layout.pack_channels(mx.spec, pos, mixtures._channels(eps, sig, dev))
    a_mix = (cg.x, cg.y, cg.z, *cg.channels)
    e_mix, _, abs_mix = check_functor(mx.spec, mx.kern.fn, a_mix, "mixture N = 2^20")
    mix_ms = cuda_ms(lambda: mx.kern(*a_mix), reps=10)
    mix_plain = cuda_ms(lambda: pair_kernel.channel_plain(mx.spec, mx.kern.fn, 3, *a_mix[:3],
                                                          a_mix[3:]), reps=1, warmup=1)
    cs2 = mx.kern.fn.cs2
    hs = cg.channels[1]
    pairs = functor_pairs(mx.spec, cg.x, cg.y, cg.z, cg.pid,
                          lambda ix: cs2 * (hs[:, :, :, None, :] + hs[ix][:, :, None]) ** 2)
    rows.append(functor_row("pair_channel_lj_mix",
                            "uammd_tpu/engine/pair_kernel.py:538 (lj_mixture_pair_fn, "
                            "uammd_tpu/engine/mixtures.py:40)", mix_launches, abs_mix, mix_ms,
                            mix_plain, pairs, OPS_LJ_MIX, 8, mx.spec,
                            extra={"rel_err": e_mix, "shape": list(mx.spec.array_shape),
                                   "forces_call_ms": forces_ms}, fn=mx.kern.fn))
    print(json.dumps({"phase": "mixture_2^20", "n": N, "box": MIX_L, "density": MIX_RHO,
                      "spec": list(mx.spec.array_shape), "forces_ms": forces_ms,
                      "kernel_ms": mix_ms, "launches": mix_launches, "rel_err": e_mix,
                      "pairs": pairs}), flush=True)
    del cg, a_mix, f_mix, pos, eps, sig, mx
    # the two-grid hierarchy
    hp, he, hsig = hierarchy_system()
    k_mask = pair_kernel.PAIR_CHANNEL_LJ_MIX_MASKED
    k_mask.launches = k_mix.launches = 0
    mh_c = mixtures.MixtureLJHierarchical.create(HIER_L, len(hp), he, hsig, cut_scale=MIX_CUT,
                                                 device=dev)
    f_h, ovf = mh_c.forces(hp, he, hsig)
    hier_launches = {"masked": k_mask.launches, "fine": k_mix.launches}
    mh_p = mixtures.MixtureLJHierarchical.create(HIER_L, len(hp), he, hsig, cut_scale=MIX_CUT,
                                                 device="cpu")
    f_hp, _ = mh_p.forces(hp, he, hsig)
    e_h = float((f_h.cpu() - f_hp).abs().max() / f_hp.abs().max())
    check(not bool(ovf) and e_h < CHANNEL_TOL,
          f"hierarchy: forces through both kernels vs plain {e_h:.3g} < {CHANNEL_TOL}")
    flag = torch.zeros(len(hp), dtype=torch.float32, device=dev)
    flag[list(mh_c.small_idx)] = 1.0
    cg = layout.pack_channels(mh_c.coarse_spec, torch.tensor(hp, device=dev),
                              mixtures._channels(he, hsig, dev, flag))
    a_h = (cg.x, cg.y, cg.z, *cg.channels)
    fn = mh_c.kern_coarse.fn
    e_m, c_m, abs_m = check_functor(mh_c.coarse_spec, fn, a_h, "hierarchy coarse grid",
                                    mix_control(mixtures.LJMixturePair(MIX_CUT)))
    masked_ms = cuda_ms(lambda: mh_c.kern_coarse(*a_h), reps=20)
    masked_plain = cuda_ms(lambda: pair_kernel.channel_plain(mh_c.coarse_spec, fn, 3, *a_h[:3],
                                                             a_h[3:]), reps=3, warmup=1)
    hs = cg.channels[1]
    pairs = functor_pairs(mh_c.coarse_spec, cg.x, cg.y, cg.z, cg.pid,
                          lambda ix: fn.cs2 * (hs[:, :, :, None, :] + hs[ix][:, :, None]) ** 2)
    rows.append(functor_row("pair_channel_lj_mix_masked",
                            "uammd_tpu/engine/pair_kernel.py:538 (lj_mixture_pair_fn_masked, "
                            "uammd_tpu/engine/mixtures.py:108)", hier_launches["masked"], abs_m,
                            masked_ms, masked_plain, pairs, OPS_LJ_MIX_MASKED, 9,
                            mh_c.coarse_spec,
                            extra={"rel_err": e_m, "control_mask_ignored": c_m,
                                   "shape": list(mh_c.coarse_spec.array_shape),
                                   "note": "a kernel check on the hierarchy system, not a path"},
                            fn=fn))
    print(json.dumps({"phase": "mixture_hierarchy", "n": len(hp), "box": HIER_L,
                      "coarse_spec": list(mh_c.coarse_spec.array_shape),
                      "fine_spec": list(mh_c.fine.spec.array_shape), "launches": hier_launches,
                      "forces_rel_err": e_h, "coarse_rel_err": e_m, "control": c_m}),
          flush=True)
    # the observables on the v2 LJ path's final state
    k_obs = pair_kernel.PAIR_FORCE_OBS
    k_obs.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P, E = lj_pressure(gs2, md=engine2)
    P, E = float(P), float(E)
    pressure_s = time.perf_counter() - t0
    obs_launches = k_obs.launches
    check(math.isfinite(P) and math.isfinite(E), f"observables: P {P} and E {E} finite")
    check(obs_launches >= 1, "observables: #1's observable mode launched")
    obs, g0, kern = obs_check(gs2, "v2 LJ final state")
    obs_ms = cuda_ms(lambda: kern(g0.x, g0.y, g0.z), reps=10)
    from uammd_tpu_torch.engine import md as tmd

    obs_plain = cuda_ms(lambda: pair_kernel.pair_force_plain(
        g0.spec, tmd.lj_g(), g0.x, g0.y, g0.z, e_fn=tmd.lj_e(), compute_virial=True,
        compute_stress=True), reps=1, warmup=1)
    cand, inside = stencil_pairs(g0)
    ops_ms = 1e3 * (OPS_PAIR_TEST * cand + OPS_PAIR_OBS * inside) / PEAK_FP32_FLOPS
    bytes_ms = 1e3 * 4 * 14 * g0.spec.n_slots / PEAK_HBM_BYTES
    print(json.dumps({"phase": "observables_v2_final_state", "n": N, "pressure": P,
                      "potential_energy": E, "lj_pressure_seconds": pressure_s,
                      "kernel_ms": obs_ms, "launches": obs_launches, **obs}), flush=True)
    rows.append({"name": "pair_force_obs", "route": "cuda",
                 "source": "uammd_tpu_torch/engine/csrc/pair_force.cu",
                 "replaces": "uammd_tpu/engine/pair_kernel.py:272 (energy, virial, stress)",
                 "launches": obs_launches, "max_abs_err": obs["max_abs_err"], "ms": obs_ms,
                 "plain_ms": obs_plain, "bound_ms": max(ops_ms, bytes_ms),
                 "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                 "library_ms": None, "pairs": {"candidates": cand, "inside": inside},
                 "shape": obs["spec"], "rel_err": obs["rel_err"]})
    return rows


def lanczos_row(run, errs):
    """The Lanczos sqrt(T) e1 kernel at the PSE path's final state: T from
    an m-step Lanczos pass of the noise operator on a fresh draw, checked
    against eigh with the clamp; and its kernels-line row."""
    import torch
    from uammd_tpu_torch.integrators.bdhi.pse_engine import _stack_flat
    from uammd_tpu_torch.solvers import lanczos

    be, st, p, gen = run["be"], run["st"], run["pos"], run["gen"]
    m = be.lanczos_iterations
    cg, _, _ = be._refresh(st, p)
    z3, zs = be.draw_z(cg, gen)
    zf = _stack_flat(z3, None if zs is None else tuple(zs))
    _, al, bt = lanczos.lanczos_tridiag(be._krylov_mv(cg, noise=True), zf, m)
    got = lanczos._sqrt_e1(al, bt, m)
    want = lanczos.sqrt_e1_plain(al.cpu(), bt.cpu(), m)
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    check(err < SQRT_TOL, f"PSE path's T: sqrt(T) e1 kernel vs eigh {err:.3g} < {SQRT_TOL}")
    ms = cuda_ms(lambda: lanczos._sqrt_e1(al, bt, m), reps=50)
    plain = cuda_ms(lambda: lanczos.sqrt_e1_plain(al, bt, m), reps=10)
    T = lanczos._tridiag(al, bt, m)
    library = cuda_ms(lambda: torch.linalg.eigh(T), reps=10)
    ops_ms = 1e3 * 9 * m ** 3 / PEAK_FP64_FLOPS
    bytes_ms = 1e3 * 8 * 3 * m / PEAK_HBM_BYTES
    return {"name": "lanczos_sqrt", "route": "cuda",
            "source": "uammd_tpu_torch/engine/csrc/lanczos_sqrt.cu",
            "replaces": "uammd_tpu/solvers/lanczos.py:74 (jnp.linalg.eigh; no pallas_call)",
            "launches": run["launches"].get("lanczos_sqrt", 0),
            "max_abs_err": float((got.cpu() - want).abs().max()), "ms": ms,
            "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes", "library_ms": library,
            "m": m, "rel_err": err, "indefinite_checks": errs,
            "note": "library_ms: torch.linalg.eigh of T alone, which reads its error flag on "
                    "the host"}


def slice_d_only(dev, card) -> int:
    """``--only-slice-d``: slice D's checks and paths alone, for working on
    them, with the observables on the v2 engine's jittered fcc start (a
    perfect lattice's forces cancel to round-off) instead of its path's
    final state; prints no result line."""
    from uammd_tpu_torch.engine import md2

    slice_d_kernel_checks(dev)
    pos = fcc_start(N, BOX, 0.1, 17)
    engine2 = md2.make_lj_md2(BOX, N, dt=0.01, temperature=TEMPERATURE, pos=pos,
                              n_strag=N_STRAG, noise="clt", fast_recip=True, device=dev)
    rows = slice_d_paths(dev, card, engine2.init(pos, seed=1), engine2)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0



# ------------------------------------------------ slice A3: the v2 engine unfused
# make_lj_md2(fold_in_update=False): the Newton pair #6, the fold #7 as a pass
# of its own and the G-J update from folded forces #11, rebinning with
# rebin_fast3 (#5) as the JAX engine does, on the melted 2^20 liquid of
# main_path_v2; the one-shot straggler rebin #4 (rebin_fast2) is held
# against it on the states the engine rebins. #11 has Box-Muller noise only:
# its check and the fused comparison run "bm".
UNFUSED_TOL = 2e-5  # #11 against plain, x max|ref| (the card's logf/sinf/cosf)
FUSED_STEPS = 10
FUSED_TOL = 1e-5  # fused against unfused positions after FUSED_STEPS
# The Newton kernel adds its reactions with float atomics in an order that
# changes from run to run, so two fused runs from one state end apart too
# (1.14e-5 on an H100: one or two ulps of the coordinates, which reach 128):
# the bound is FUSED_TOL, or this times that spread when larger, and never
# more than FUSED_CAP.
FUSED_SPREAD_RATIO = 2.0
FUSED_CAP = 5e-5


def fused_bound(spread: float) -> float:
    return max(FUSED_TOL, min(FUSED_SPREAD_RATIO * spread, FUSED_CAP))


def n600_straggler_system(dev, rng):
    """tests/test_engine2.py:35's system (n 600, L 12, CAP 8, 128-row list),
    its fcc sites moved by a clipped 0.15-sigma Gaussian, and the same state
    after tests/test_engine2.py:96-102's displacement (a clipped 0.35-sigma
    Gaussian: cells pass CAP, stragglers move), drawn from the torch
    generator ``rng`` in that order."""
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.utils.lattices import lattice

    n_s, L_s = 600, 12.0
    jit_s = (0.15 * torch.randn((n_s, 3), generator=rng, dtype=torch.float64)).clamp(-0.2, 0.2)
    pos_s = lattice(n_s, L_s, "fcc") + jit_s.numpy()
    spec_s = layout.choose_spec(L_s, n_s, 2.5, cap=8, pos=pos_s, n_strag=128)
    gs_s = layout.pack(spec_s, pos_s, vel=torch.randn((n_s, 3), generator=rng).numpy(),
                       device=dev)
    return gs_s, engine2_drift(gs_s, rng)


def engine2_drift(gs, rng):
    """tests/test_engine2.py:96-102's sub-cell drift, drawn from the torch
    generator ``rng``: x by a 0.35-sigma Gaussian clipped to 1, y by half
    of it, z by -0.3 of it, and the stragglers by a 0.35-sigma Gaussian."""
    import torch

    dev = gs.device
    dx = (0.35 * torch.randn(gs.x.shape, generator=rng).to(dev)).clamp(-1.0, 1.0) * gs.mask
    sdx = 0.35 * torch.randn(gs.spos.shape, generator=rng).to(dev) * (gs.spid >= 0)[:, None]
    return gs.replace(x=gs.x + dx, y=gs.y + 0.5 * dx, z=gs.z - 0.3 * dx, spos=gs.spos + sdx)


def check_rebin2(gs, what: str):
    """#4 against its plain version: out, mini, count and overflow equal
    slot for slot, every particle kept without overflow; rebin_fast2's
    state equal by pid to rebin_fast3's and the sort rebin's. Returns the
    mini-grid's stragglers and the max abs difference."""
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.engine import rebin_kernel as rk

    stacked, strag = stacked_of(gs, 7), strag_stack_of(gs)
    got = rk.make_rebin_kernel2(gs.spec)(stacked, strag)
    want = rk.rebin2_plain(gs.spec, stacked, strag)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{what}: one-shot rebin out and mini equal plain slot for slot")
    check((int(got[2]), int(got[3])) == (int(want[2]), int(want[3])),
          f"{what}: one-shot rebin count/overflow {int(got[2])}/{int(got[3])} == plain "
          f"{int(want[2])}/{int(want[3])}")
    check(int(got[2]) == gs.n and int(got[3]) == 0,
          f"{what}: one-shot rebin keeps all {gs.n} particles without overflow")
    r2 = rk.rebin_fast2(gs)
    n_kept = int((r2.pid >= 0).sum()) + int((r2.spid >= 0).sum())
    check(not bool(r2.overflow) and n_kept == gs.n, f"{what}: rebin_fast2 keeps every particle")
    p2, v2, _ = layout.unpack(r2)
    for name, other in (("rebin_fast3", rk.rebin_fast3(gs)), ("layout.rebin", layout.rebin(gs))):
        p, v, _ = layout.unpack(other)
        check(torch.equal(p2, p) and torch.equal(v2, v),
              f"{what}: rebin_fast2 positions and velocities equal {name}'s by pid")
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    return int((got[1][6] > 0.5).sum()), err


def gj_inputs(gs, seed: int):
    """#11's arguments on ``gs``: random w, folded forces from the Newton
    kernel and the fold, reference positions up to 0.2 away, and the
    straggler rows."""
    import torch
    from uammd_tpu_torch.engine import kernel2

    home, groups, sf = newton_pair(gs)
    folded = kernel2.make_fold_kernel(gs.spec)(home, groups)
    a, _, ref, step = update_inputs(gs, home, groups, seed)
    a = a[:6] + list(folded)
    strag = None
    if gs.spec.n_strag:
        gen = torch.Generator(device=gs.device).manual_seed(seed + 1)
        sv = (gs.spid >= 0)[:, None]
        strag = (gs.spos, torch.randn(gs.svel.shape, generator=gen, device=gs.device) * sv,
                 sf * sv, gs.spid)
    return a, ref, step, strag


def check_gj_update(gs, temperature: float, what: str, control: bool = False):
    """#11 against gj_update_plain on identical counter noise: each output
    (the six grids over occupied slots, the straggler rows over occupied
    rows) within UNFUSED_TOL x its own max|ref|, the drift too. With
    ``control`` the plain version's seed is off by one, which must fail
    that bound (through the velocities: the noise moves a position by
    about 1e-5 of the box). Returns the relative and absolute errors."""
    from uammd_tpu_torch.engine import update_kernel as uk

    kern = uk.make_gj_update_kernel(gs.spec, 0.01, temperature, 1.0, 1.0)
    a, ref, step, strag = gj_inputs(gs, 20261)
    got = kern(*a, *ref, step, strag)
    want = uk.gj_update_plain(gs.spec, kern.coef, *a, *ref, step + 1 if control else step, strag)
    m = gs.mask
    pairs = [(x[m], y[m]) for x, y in zip(got[0], want[0])]
    if strag is not None:
        sm = gs.spid >= 0
        pairs += [(x[sm], y[sm]) for x, y in zip(got[2], want[2])]
    pairs.append((got[1].reshape(1), want[1].reshape(1)))
    pairs = [(x, y) for x, y in pairs if y.numel()]
    err = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30) for x, y in pairs)
    err_abs = max(float((x - y).abs().max()) for x, y in pairs)
    if control:
        check(err > UNFUSED_TOL, f"{what}: control (seed off by one) fails the bound ({err:.3g})")
    else:
        check(err < UNFUSED_TOL, f"{what}: G-J update #11 (T = {temperature}) vs plain "
                                 f"{err:.3g} < {UNFUSED_TOL}")
        check(float(got[1]) > 0.0, f"{what}: #11 sees the drift")
    return err, err_abs


DRIFT_STATES = ("finite", "nan_position", "nan_force_occupied", "nan_velocity_empty")


def same_float(a: float, b: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == b


def drift_state(grids, state: str, slots):
    """The update's 12 input grids (x, y, z, w, f, the references) with
    slot ``slots[0]`` (occupied) 0.9 further from its x reference and the
    state's non-finite value: x = NaN on the occupied slot ``slots[1]``
    (which then counts as empty), fy = NaN there, or wz = NaN on the empty
    slot ``slots[2]``."""
    g = [t.clone() for t in grids]
    i0, i1, i2 = slots
    g[9].view(-1)[i0] -= 0.9
    at = {"nan_position": (0, i1), "nan_force_occupied": (7, i1),
          "nan_velocity_empty": (5, i2)}.get(state)
    if at is not None:
        g[at[0]].view(-1)[at[1]] = float("nan")
    return g


def drift_rule_replicas(x, out, ref) -> dict:
    """The drifts the two wrong rules give on the plain update's outputs:
    the old kernels' ``fmaxf`` chain times the mask (a NaN dropped) and
    ``mask * max(...)`` (0 x NaN kept NaN on an empty slot)."""
    import torch

    m = (x < 1.0e8).to(torch.float32)
    d = [(o - r).abs() for o, r in zip(out[:3], ref)]
    chain = torch.fmax(torch.fmax(torch.fmax(torch.zeros_like(d[0]), d[0]), d[1]), d[2])
    return {"fmaxf": float((m * chain).amax()),
            "zero_times_nan": float((m * torch.maximum(d[0], torch.maximum(d[1], d[2]))).amax())}


def drift_rule_checks(gs, what: str, strag_rows: bool = False) -> dict:
    """#11 and #12's drift against their plain versions on ``DRIFT_STATES``
    built on ``gs`` (the Newton kernel's forces, random w, references up to
    0.2 away): bit-equal, NaN exactly where plain is NaN (the NaN force on
    an occupied slot), at T = 0 (#11, and #12 "clt") and T = 1.5 (#12
    "clt"). Two controls that must fail, each on some state: the old
    ``fmaxf`` rule's replica and the ``0 x NaN`` rule's. With
    ``strag_rows``, #11's straggler-drift option too (the rows' ids as the
    DD2 state's float32 pid + 1, their references ``sref``): a NaN on an
    occupied row makes the drift NaN, one on an empty row changes
    nothing."""
    import torch
    from uammd_tpu_torch.engine import kernel2
    from uammd_tpu_torch.engine import update_kernel as uk

    home, groups, sf = newton_pair(gs)
    folded = list(kernel2.make_fold_kernel(gs.spec)(home, groups))
    a, grp, ref, step = update_inputs(gs, home, groups, 20261)
    flat = gs.mask.reshape(-1)
    occ, empty = flat.nonzero().flatten(), (~flat).nonzero().flatten()
    slots = (int(occ[0]), int(occ[len(occ) // 2]), int(empty[len(empty) // 2]))
    n0, f0 = uk.GJ_UPDATE.launches, uk.GJ_FOLD_UPDATE.launches
    got, plain, rules = {}, {}, {}
    for state in DRIFT_STATES:
        g11 = drift_state(a[:6] + folded + ref, state, slots)
        g12 = drift_state(a + ref, state, slots)
        for temperature in (0.0, TEMPERATURE):
            if temperature == 0.0:
                k11 = uk.make_gj_update_kernel(gs.spec, 0.01, temperature, 1.0, 1.0)
                res = k11(*g11, step)
                want = uk.gj_update_plain(gs.spec, k11.coef, *g11, step)
                key = f"#11 T0 {state}"
                got[key], plain[key] = float(res[1]), float(want[1])
                rules[key] = drift_rule_replicas(g11[0], want[0], g11[9:])
            k12 = uk.make_gj_fold_update_kernel(gs.spec, 0.01, temperature, 1.0, 1.0,
                                                noise="clt")
            forces = torch.stack(g12[6:9] + grp)
            res = k12.stacked(*g12[:6], forces, *g12[9:], step)
            want = uk.gj_fold_update_plain(gs.spec, k12.coef, "clt", *g12[:9], grp, *g12[9:],
                                           step)
            key = f"#12 clt T{temperature} {state}"
            got[key], plain[key] = float(res[1]), float(want[1])
            rules[key] = drift_rule_replicas(g12[0], want[0], g12[9:])
    if strag_rows:
        k11 = uk.make_gj_update_kernel(gs.spec, 0.01, 0.0, 1.0, 1.0)
        valid = gs.spid >= 0
        rows_v, rows_e = valid.nonzero().flatten(), (~valid).nonzero().flatten()
        spidf = (gs.spid + 1).to(torch.float32)
        sref = gs.spos - 0.05
        for state in ("finite", "nan_strag_occupied", "nan_strag_empty"):
            spos = gs.spos.clone()
            if state == "nan_strag_occupied":
                spos[int(rows_v[len(rows_v) // 2]), 2] = float("nan")
            elif state == "nan_strag_empty" and len(rows_e):
                spos[int(rows_e[0]), 0] = float("nan")
            rows = (spos, gs.svel, sf * valid[:, None], spidf)
            g11 = drift_state(a[:6] + folded + ref, "finite", slots)
            res = k11(*g11, step, rows, sref)
            want = uk.gj_update_plain(gs.spec, k11.coef, *g11, step, rows, sref)
            key = f"#11 T0 sref {state}"
            got[key], plain[key] = float(res[1]), float(want[1])
            check(math.isnan(plain[key]) == (state == "nan_strag_occupied"),
                  f"{what}: plain drift {plain[key]} on {state}")
            sp = [float((x - y).abs().max()) for x, y in zip(res[2], want[2])
                  if state == "finite"]
            check(all(v == 0.0 for v in sp), f"{what}: #11 straggler rows bit-equal ({sp})")
    uk.GJ_UPDATE.launches, uk.GJ_FOLD_UPDATE.launches = n0, f0
    for key in got:
        check(same_float(got[key], plain[key]),
              f"{what}: {key}: drift {got[key]} == plain {plain[key]}")
        if key in rules:
            check(math.isnan(plain[key]) == key.endswith("nan_force_occupied"),
                  f"{what}: {key}: plain drift {plain[key]} NaN only with the NaN force")
    fails = {r: [k for k in rules if not same_float(rules[k][r], got[k])]
             for r in ("fmaxf", "zero_times_nan")}
    for r, keys in fails.items():
        check(bool(keys), f"{what}: control, the {r} rule, fails the drift check somewhere")
    out = {"drifts": got, "controls_fail_on": fails}
    print(json.dumps({"phase": "drift_rule_checks", "what": what, "ok": True, **out}),
          flush=True)
    return out


def update_times(call, names, launches_a_call: int = 1) -> dict:
    """``call``'s CUDA-event ms, the profiler's device ms of the kernels
    ``names`` (L2 warm, and flushed before each call) and the host us a
    launch (the wrapper's time, calls issued without a sync)."""
    t = {"ms": cuda_ms(call, reps=20),
         "device_ms_profiler": profiler_ms(call, names),
         "device_ms_profiler_cold": profiler_ms(call, names, cold=True),
         "host_us_a_call": host_us(call) / launches_a_call}
    for k in ("device_ms_profiler", "device_ms_profiler_cold"):
        device_ms(t[k], f"{names} ({k})")
    return t


def unfused_kernel_checks(dev):
    """#4 on the n 600 straggler system and #11 on the 2^20 perturbed fcc
    state at the v2 spec, each against its plain version, with controls
    that must fail."""
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.engine import rebin_kernel as rk

    gs_s, moved = n600_straggler_system(dev, torch.Generator().manual_seed(31))
    check(int((gs_s.spid >= 0).sum()) > 0, "n 600 CAP 8: the straggler list is used")
    mini_s, r2_err = check_rebin2(moved, "n 600 stragglers moved")
    check(mini_s > 0, "n 600 stragglers moved: the one-shot mini-grid holds stragglers")
    # control: the straggler block zeroed loses the stragglers, which the
    # count must flag
    strag0 = torch.zeros_like(strag_stack_of(moved))
    lost = rk.make_rebin_kernel2(moved.spec)(stacked_of(moved, 7), strag0)
    n_strag = int((moved.spid >= 0).sum())
    check(int(lost[2]) == moved.n - n_strag,
          f"control: #4 without its straggler block counts {int(lost[2])} = "
          f"{moved.n} - {n_strag}, which flags overflow")
    crammed = gs_s.replace(**{k: torch.where(gs_s.mask, getattr(gs_s, k) * 0.05,
                                             getattr(gs_s, k)) for k in ("x", "y", "z")})
    check(bool(rk.rebin_fast2(crammed).overflow), "crammed n 600: rebin_fast2 latches overflow")

    pos_fcc = fcc_start(N, BOX, 0.1, 21)
    spec2 = layout.choose_spec(BOX, N, 2.5, pos=pos_fcc, n_strag=N_STRAG)
    gs2 = layout.pack(spec2, pos_fcc, device=dev)
    errs = {f"T{t}": check_gj_update(gs2, t, "2^20 perturbed fcc") for t in (0.0, 1.0)}
    errs["n600_T1"] = check_gj_update(gs_s, 1.0, "n 600 stragglers")
    control = check_gj_update(gs2, 1.0, "2^20 perturbed fcc", control=True)[0]
    drift_rule_checks(gs_s, "n 600 stragglers", strag_rows=True)
    drift_rule_checks(gs2, "2^20 perturbed fcc")
    print(json.dumps({"phase": "unfused_kernel_checks", "ok": True,
                      "gj_update_rel_and_abs_err": errs, "gj_update_tol": UNFUSED_TOL,
                      "gj_update_control_seed_off_by_one": control,
                      "rebin2": "exact (out, mini, count, overflow) on n 600 moved",
                      "rebin2_n600_mini_stragglers": mini_s,
                      "rebin2_control_no_straggler_block_count": int(lost[2]),
                      "spec": list(spec2.array_shape)}), flush=True)
    return {"gj_update": errs, "rebin2_err": r2_err}


def unfused_counters() -> dict:
    from uammd_tpu_torch.engine import kernel2, rebin_kernel, update_kernel

    return {"newton_pair": kernel2.NEWTON_PAIR, "fold": kernel2.FOLD,
            "gj_update": update_kernel.GJ_UPDATE, "gj_fold_update": update_kernel.GJ_FOLD_UPDATE,
            "rebin2": rebin_kernel.REBIN2, "separable_rebin": rebin_kernel.SEP_REBIN}


def melt(dev):
    """bench.py's melt: 300 v1 steps at dt 0.004 from the fcc lattice; the
    melted positions (numpy)."""
    from uammd_tpu_torch.engine import layout, md
    from uammd_tpu_torch.utils.lattices import lattice

    pos_fcc = lattice(N, BOX, "fcc")
    md_melt = md.make_lj_md(BOX, N, dt=0.004, temperature=TEMPERATURE, pos=pos_fcc, device=dev)
    gs = md_melt.run(md_melt.init(pos_fcc, seed=0), MELT_STEPS)
    check(not bool(gs.overflow), "melt phase: no overflow")
    return layout.unpack(gs)[0].cpu().numpy()


def unfused_engine(dev, pos, **kw):
    from uammd_tpu_torch.engine import md2

    return md2.make_lj_md2(BOX, N, dt=0.01, temperature=TEMPERATURE, pos=pos, n_strag=N_STRAG,
                           fast_recip=True, device=dev, **kw)


@contextlib.contextmanager
def rebin2_held(held: list):
    """While open, every state the v2 engine hands its rebin (md2's
    ``rebin_fast3``, #5) is also held to #5's plain version exactly, and
    goes through ``rebin_fast2`` (#4), which must keep every particle
    without overflow and give the same particles by pid as ``rebin_fast3``
    and the sort rebin ``layout.rebin``; ``held`` keeps the number of
    states and the last of them."""
    import torch
    from uammd_tpu_torch.engine import layout, md2
    from uammd_tpu_torch.engine import rebin_kernel as rk

    real = md2.rebin_fast3

    def rebin(gs):
        k = held[0] + 1 if held else 1
        out = real(gs)
        check_sep_rebin(gs, f"v2 unfused rebin {k}")
        r2 = rk.rebin_fast2(gs)
        n_kept = int((r2.pid >= 0).sum()) + int((r2.spid >= 0).sum())
        check(not bool(r2.overflow) and n_kept == gs.n,
              f"v2 unfused rebin {k}: rebin_fast2 keeps every particle")
        (p2, v2, _), (p3, v3, _) = layout.unpack(r2), layout.unpack(out)
        check(bool((p2 == p3).all()) and bool((v2 == v3).all()),
              f"v2 unfused rebin {k}: rebin_fast2 equals rebin_fast3 by pid")
        ps, vs, _ = layout.unpack(layout.rebin(gs))
        check(torch.equal(p2, ps) and torch.equal(v2, vs),
              f"v2 unfused rebin {k}: rebin_fast2 equals layout.rebin by pid")
        held[:] = [k, gs]
        return out

    md2.rebin_fast3 = rebin
    try:
        yield
    finally:
        md2.rebin_fast3 = real


def unfused_main_path(dev, card, melted, errs):
    """main_path_v2_unfused with #4 held on the states it rebins, #4 and
    #11 against plain on its states, #7 + #11 against #12 on one Newton
    output, the fused against unfused comparison, breakdown_unfused;
    returns the kernels-line rows of #11 and #4."""
    import torch
    from uammd_tpu_torch.engine import kernel2, layout
    from uammd_tpu_torch.engine import rebin_kernel as rk
    from uammd_tpu_torch.engine import update_kernel as uk

    counted = unfused_counters()
    for k in counted.values():
        k.launches = 0
    torch.cuda.synchronize()
    engine = unfused_engine(dev, melted, fold_in_update=False)
    held = []
    with rebin2_held(held):
        gs = engine.run(engine.init(melted, seed=1), SETTLE_STEPS)
    torch.cuda.synchronize()
    before = {k: v.launches for k, v in counted.items()}
    t0 = time.perf_counter()
    gs = engine.run(gs, TIMED_STEPS)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    timed = {k: launches[k] - before[k] for k in counted}
    steps = SETTLE_STEPS + TIMED_STEPS
    n_kept, t_meas = gates(engine, gs, "v2 unfused path", steps, launches, [],
                           ["separable_rebin", "rebin2"])
    for k in ("newton_pair", "fold", "gj_update"):
        check(timed[k] == TIMED_STEPS, f"v2 unfused: {k} launched {timed[k]} == {TIMED_STEPS} "
                                       f"times in the timed steps")
    check(timed["gj_fold_update"] == 0 and launches["gj_fold_update"] == 0,
          "v2 unfused: the fused update #12 never launched")
    n_held = held[0] if held else 0
    check(n_held >= 1 and launches["rebin2"] == n_held and timed["rebin2"] == 0,
          f"v2 unfused: #4 launched {launches['rebin2']} times, once on each of the {n_held} "
          f"states rebinned in the settle steps")
    check(all(bool(a.isfinite().all()) for a in layout.unpack(gs)), "v2 unfused: state finite")
    reads = host_reads(lambda: engine.step(gs), HOST_READ_STEPS)
    reads_per_step = len(reads) / HOST_READ_STEPS
    check(reads_per_step <= 1, f"v2 unfused: {reads_per_step} host reads per step {reads}")
    ms = 1e3 * timed_s / TIMED_STEPS
    print(json.dumps({
        "phase": "main_path_v2_unfused", "n": N, "box": BOX, "n_strag": N_STRAG,
        "fold_in_update": False, "rebin": "rebin_fast3 (#5); rebin_fast2 (#4) held against it "
                                          "in the settle steps",
        "noise": "bm (#11 has no other)",
        "fast_recip": True, "spec": list(engine.spec.array_shape),
        "settle_steps": SETTLE_STEPS, "timed_steps": TIMED_STEPS, "timed_seconds": timed_s,
        "ms_per_step": ms, "particle_steps_per_s": N * TIMED_STEPS / timed_s,
        "temperature": t_meas, "particles_kept": n_kept,
        "stragglers": int((gs.spid >= 0).sum()), "overflow": False, "launches": launches,
        "timed_launches": timed, "timed_launches_per_step":
            {k: v / TIMED_STEPS for k, v in timed.items()},
        "rebins_held_against_rebin_fast2": n_held,
        "host_reads_per_step": reads_per_step, "host_reads_at": reads}), flush=True)

    # #4 on the last state the path rebinned and on its final liquid after
    # tests/test_engine2.py:96-102's sub-cell drift, #11 on its final liquid
    moved = held[1]
    del held[:]
    mini_l, r2_err = check_rebin2(moved, "2^20 unfused liquid, last state rebinned in settle")
    mini_d, r2_err_d = check_rebin2(engine2_drift(gs, torch.Generator().manual_seed(16)),
                                    "2^20 unfused liquid displaced")
    r2_err = max(r2_err, r2_err_d)
    upd_err = check_gj_update(gs, TEMPERATURE, "2^20 unfused liquid")

    # #7 + #11 against #12 on one Newton output and one noise key: both
    # folds add home + the 4 reaction groups in fold.cu's order and both
    # updates run gj_common.cuh's arithmetic (bit-equality is reported)
    fused_upd = uk.make_gj_fold_update_kernel(engine.spec, 0.01, TEMPERATURE, 1.0, 1.0,
                                              noise="bm")
    home, groups, sf = newton_pair(gs)
    a, grp, ref, step = update_inputs(gs, home, groups, 43)
    s_rows = (gs.spos, gs.svel, sf * (gs.spid >= 0)[:, None], gs.spid)
    one = engine.update(*a[:6], *engine.fold(home, groups), *ref, step, s_rows)
    two = fused_upd(*a, grp, *ref, step, s_rows)
    pairs = list(zip(one[0], two[0])) + [(one[1], two[1])] + list(zip(one[2], two[2]))
    one_step_equal = all(torch.equal(u, v) for u, v in pairs)
    one_step_err = max(float((u - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                       for u, v in pairs)
    check(one_step_err < UNFUSED_TOL, f"one step: #7 + #11 against #12 on one Newton output "
                                      f"{one_step_err:.3g} < {UNFUSED_TOL}")

    # fused against unfused from one state (both "bm"), with a second fused
    # run for the spread of the fused engine against itself
    pos_now = layout.unpack(gs)[0].cpu().numpy()
    engines = {"fused": unfused_engine(dev, pos_now, noise="bm"),
               "fused_again": unfused_engine(dev, pos_now, noise="bm"),
               "unfused": unfused_engine(dev, pos_now, fold_in_update=False)}
    states = {k: e.init(pos_now, seed=5) for k, e in engines.items()}
    flags = {k: [] for k in engines}
    for _ in range(FUSED_STEPS):
        for k, e in engines.items():
            before_ref = states[k].ref_x
            states[k] = e.step(states[k])
            flags[k].append(not torch.equal(states[k].ref_x, before_ref))
    pp = {k: layout.unpack(g)[0] for k, g in states.items()}

    def gap_of(a, b):
        d = pp[a] - pp[b]
        return float((d - BOX * torch.round(d / BOX)).abs().max())

    gap, spread = gap_of("fused", "unfused"), gap_of("fused", "fused_again")
    check(flags["fused"] == flags["unfused"],
          f"fused and unfused rebin at the same steps {flags}")
    bound = fused_bound(spread)
    check(gap < bound, f"fused against unfused after {FUSED_STEPS} steps: {gap:.3g} < "
                       f"{bound:.3g} (fused against itself {spread:.3g})")
    bit_equal = bool(torch.equal(pp["fused"], pp["unfused"]))
    print(json.dumps({"phase": "fused_vs_unfused", "steps": FUSED_STEPS, "noise": "bm",
                      "one_step_bit_equal": one_step_equal, "one_step_rel_err": one_step_err,
                      "max_abs_position_gap": gap, "fused_run_to_run_gap": spread,
                      "within_fused_tol": gap < FUSED_TOL, "bound": bound,
                      "bit_equal": bit_equal,
                      "rebin_steps": [k for k, f in enumerate(flags["fused"]) if f],
                      "note": "on one Newton output the two folds and updates agree bit for "
                              "bit; over several steps the Newton kernel's float atomics "
                              "make no two runs bit-equal, fused or not"}), flush=True)
    del engines, states, pp

    # breakdown_unfused and the kernels' rows, at the path's final state
    spec = engine.spec
    slot = 4 * spec.n_slots
    S = spec.n_strag
    strag = kernel2.broadcast_stragglers(spec, gs.spos, gs.spid)
    newton = engine.pair
    fold = engine.fold
    a, ref, step, s_rows = gj_inputs(gs, 41)
    upd = engine.update
    stacked, srows = stacked_of(moved, 7), strag_stack_of(moved)
    r2k = rk.make_rebin_kernel2(spec)
    fold_t = fold_times(fold, home, groups)
    t = {"newton_pair": cuda_ms(lambda: newton(gs.x, gs.y, gs.z, strag), reps=20),
         "fold": fold_t["ms"],
         "gj_update": cuda_ms(lambda: upd(*a, *ref, step, s_rows), reps=20),
         "rebin_fast3": cuda_ms(lambda: rk.rebin_fast3(moved), reps=20)}
    r2_ms = cuda_ms(lambda: r2k(stacked, srows), reps=20)
    n2 = rk.REBIN2.launches
    r2_dev = {k: profiler_ms(lambda: r2k(stacked, srows), ["rebin2_pull", "rebin_classify"],
                             cold=k == "device_ms_profiler_cold")
              for k in ("device_ms_profiler", "device_ms_profiler_cold")}
    for k, v in r2_dev.items():
        device_ms(v, f"#4 ({k})")
    rk.REBIN2.launches = n2
    n11 = uk.GJ_UPDATE.launches
    upd_t = update_times(lambda: upd(*a, *ref, step, s_rows), ["gj_update_rows"])
    uk.GJ_UPDATE.launches = n11
    plain = {"gj_update": cuda_ms(lambda: uk.gj_update_plain(spec, upd.coef, *a, *ref, step,
                                                             s_rows), reps=5, warmup=1),
             "rebin2": cuda_ms(lambda: rk.rebin2_plain(spec, stacked, srows), reps=3, warmup=1)}
    per_step = {k: timed[k] / TIMED_STEPS for k in ("newton_pair", "fold", "gj_update")}
    per_step["rebin_fast3"] = timed["separable_rebin"] / TIMED_STEPS
    by_part = {k: t[k] * per_step[k] for k in t}
    print(json.dumps({
        "phase": "breakdown_unfused", "card": card, "ms_per_step": ms,
        "ms_per_call": t, "calls_per_step": per_step, "ms_per_step_by_part": by_part,
        "shares": {k: v / ms for k, v in by_part.items()},
        "rest_ms": ms - sum(by_part.values()), "rebin2_ms_per_call": r2_ms,
        "rebin2_mini_stragglers_liquid": [mini_l, mini_d],
        "note": "CUDA events on an idle card at the path's final state (the rebins on the "
                "last state the path rebinned); rebin_fast3 = #5 with its packing; rest = "
                "the straggler pairs, the drift read, compute_forces' bookkeeping"}),
          flush=True)
    mini_bytes = 4 * 7 * spec.n_slots // spec.cap * rk.OCAP
    upd_bytes_ms = 1e3 * (18 * slot + 64 * S + 8) / PEAK_HBM_BYTES
    r2_bytes_ms = 1e3 * (2 * 7 * slot + mini_bytes + 7 * 4 * S + 8) / PEAK_HBM_BYTES
    row_sep = sep_row("_unfused", spec, rk.OCAP, stacked, srows, launches["separable_rebin"],
                      "the last state the unfused path rebinned")
    del moved, stacked, srows
    src = "uammd_tpu_torch/engine/csrc/"
    return [row_sep,
        {"name": "gj_update", "route": "cuda", "source": src + "gj_update.cu (+ gj_common.cuh)",
         "replaces": "uammd_tpu/engine/update_kernel.py:134", "launches": launches["gj_update"],
         "max_abs_err": upd_err[1], "ms": t["gj_update"], "plain_ms": plain["gj_update"],
         "bound_ms": upd_bytes_ms, "bound_by": "bytes", "library_ms": None,
         "rel_err": upd_err[0], "checks": errs["gj_update"], **upd_t,
         "launch_plan": update_grid(spec, S, "gj_update")},
        {"name": "rebin2", "route": "cuda", "source": src + "rebin2.cu (+ rebin_common.cuh)",
         "replaces": "uammd_tpu/engine/rebin_kernel.py:522", "launches": launches["rebin2"],
         "max_abs_err": r2_err, "ms": r2_ms, "plain_ms": plain["rebin2"],
         "bound_ms": r2_bytes_ms, "bound_by": "bytes", "library_ms": None, **r2_dev,
         "launch_plan": rebin2_plan_of(spec, rk.OCAP),
         "launches_note": "held against rebin_fast3 on each state the unfused path rebinned "
                          "in its settle steps"},
    ], {"ms": ms, "fold_launches": launches["fold"], "fold_ms": t["fold"], "fold_times": fold_t,
        "newton_launches": launches["newton_pair"],
        "sep_rebin_launches": launches["separable_rebin"]}


def unfused_only(dev, card) -> int:
    """``--only-unfused``: slice A3's checks and path alone (after the v1
    melt), for working on them; prints no result line."""
    errs = unfused_kernel_checks(dev)
    rows, _ = unfused_main_path(dev, card, melt(dev), errs)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# ------------------------------------------------ slice E1: Poisson electrostatics under BD
# The electrolyte: N = 131072 charges of +-1 (alternating) at uniform random
# positions (numpy's default_rng(0)) in a cube of L = 192, the number
# density of examples/interaction_modules.py:60-64's Poisson block (32
# charges in L = 12) scaled to N; gw 0.4, eps 1, tolerance 1e-4; the split
# 0.07 / gw = 0.175 of generic_md.py:186-190 (max L / gw = 480 >= 128);
# Brownian dynamics (euler_maruyama) at viscosity 1, hydrodynamic radius 1,
# T 1, dt 0.001 with PoissonSplit.sum (force and energy) as the force.
E_N = 131072
E_L = 192.0
E_GW = 0.4
E_SPLIT = 0.07 / E_GW
E_TOL = 1e-4
E_STRAG = 64
E_DT, E_T, E_VISC, E_RH = 0.001, 1.0, 1.0, 1.0
E_WARM, E_TIMED = 20, 100
SPLIT_E_RTOL = 2e-2  # examples/interaction_modules.py:72
SPLIT_F_TOL = 2e-3  # tests/test_electrostatics.py:144, x max|f|
SUM_F_TOL = 1e-5  # |sum F| / (N rms F)
WIGNER_RTOL = 2e-3  # tests/test_electrostatics.py:91
# float32 operations per pair inside the Poisson near field's cutoff:
# rsqrt, q (2), the piece test, u (2), two degree-20 Horner sums (40 FMAs,
# 80 operations), g q_j and e q_j (2), g q_j d (3) and the four sums (4)
OPS_POISSON = 95


def electrolyte(dev):
    """(positions as float32 on the card, charges, positions as numpy)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    pos = rng.uniform(-E_L / 2, E_L / 2, (E_N, 3))
    q = np.where(np.arange(E_N) % 2 == 0, 1.0, -1.0)
    return (torch.tensor(pos, dtype=torch.float32, device=dev),
            torch.tensor(q, dtype=torch.float32, device=dev), pos)


def poisson_split(dev, pos_np, split=E_SPLIT, n_strag=0):
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.electrostatics.poisson import PoissonSplit

    return PoissonSplit.create(box(E_L, device=dev), E_N, gw=E_GW, split=split,
                               tolerance=E_TOL, pos=pos_np, n_strag=n_strag)


def near_args(ps, pos, q):
    """The near field's packed state: (kernel, (x, y, z, q grid), the
    straggler block or None, the ChannelGrid)."""
    from uammd_tpu_torch.engine import layout, pair_kernel

    near = ps.near
    cg = layout.pack_channels(near.spec, pos, q[:, None])
    check(not bool(cg.overflow), "electrolyte: the near grid packs without overflow")
    blk = None
    if near.spec.n_strag:
        blk = pair_kernel.broadcast_strag_channels(near.spec, cg.spos, cg.schannels, cg.spid)
    return near._kernel(), (cg.x, cg.y, cg.z, *cg.channels), blk, cg


def check_poisson_functor(ps, pos, q, what: str):
    """#2 with the Poisson functor against its plain version on the packed
    state (with the straggler rows when the spec has them), max|d| <
    CHANNEL_TOL x max|ref|; the control (every q_j = 1: the charge of the
    candidates dropped) must fail it. Returns (rel err, abs err, control)."""
    import torch
    from uammd_tpu_torch.engine import pair_kernel

    kern, args, blk, cg = near_args(ps, pos, q)
    got = kern(*args, strag=blk)
    rows = None if blk is None else blk[:, :, 0]
    want = pair_kernel.functor_plain(ps.spec, ps.near.pair_fn(), *args[:3], args[3:], rows)
    check(all(bool(a.isfinite().all()) for a in got), f"{what}: outputs finite")
    err = outs_err(want, got)
    err_abs = max(float((a - b).abs().max()) for a, b in zip(want, got))
    check(err < CHANNEL_TOL, f"{what}: Poisson functor vs plain {err:.3g} < {CHANNEL_TOL}")
    occupied = (cg.pid >= 0).to(torch.float32)
    cblk = None
    if blk is not None:
        cblk = blk.clone()
        cblk[3] = (cg.spid >= 0).to(torch.float32)[:, None]
    wrong = kern(*args[:3], occupied, strag=cblk)
    control = outs_err(want, wrong)
    check(control > CHANNEL_TOL, f"{what}: control (q_j dropped) fails the bound "
                                 f"({control:.3g})")
    return err, err_abs, control


def check_strag_apply(ps0, ps1, pos, q) -> dict:
    """The near field of the straggler spec against the straggler-free
    one, within CHANNEL_TOL x max|ref|: a straggler row's pairs round as
    the same pairs between grid particles (pse_near.strag_channel_block),
    so the two differ by float32 summation order."""
    a0, a1 = ps0.near.apply(pos, q), ps1.near.apply(pos, q)
    gap = float((a0 - a1).abs().max()) / float(a0.abs().max())
    check(gap < CHANNEL_TOL, f"straggler spec's near field against the straggler-free one "
                             f"{gap:.3g} < {CHANNEL_TOL}")
    return {"gap_over_max_ref": gap, "tol": CHANNEL_TOL}


def poisson_checks(dev):
    """The Poisson functor on the path's first state without and with
    stragglers; the straggler spec's apply against the straggler-free one;
    the isolated-charge Wigner energy and the two-charge Newton-3 check on
    the card."""
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.core.types import Computables
    from uammd_tpu_torch.electrostatics.poisson import Poisson

    pos, q, pos_np = electrolyte(dev)
    ps0 = poisson_split(dev, pos_np)
    ps1 = poisson_split(dev, pos_np, n_strag=E_STRAG)
    n_s = int((near_args(ps1, pos, q)[3].spid >= 0).sum())
    check(n_s > 0, f"n_strag {E_STRAG}: {n_s} stragglers in the list")
    errs = {"n_strag_0": check_poisson_functor(ps0, pos, q, "electrolyte"),
            f"n_strag_{E_STRAG}": check_poisson_functor(ps1, pos, q, "electrolyte stragglers")}
    apply_errs = check_strag_apply(ps0, ps1, pos, q)
    # tests/test_electrostatics.py:81-91 and :68-78 on the card (float64)
    f64 = torch.float64
    p = Poisson.create(box(40.0, dtype=f64, device=dev), gw=1.2, tolerance=1e-5)
    fev = p.sum(torch.zeros((1, 3), dtype=f64, device=dev), torch.ones(1, dtype=f64, device=dev),
                Computables(False, True))
    want = 1.0 / (8.0 * math.pi**1.5 * 1.2) - 2.83729748 / (8.0 * math.pi * 40.0)
    wigner = abs(float(fev.energy.sum()) - want) / abs(want)
    check(wigner < WIGNER_RTOL, f"isolated charge: energy within {wigner:.3g} < {WIGNER_RTOL}")
    p2 = Poisson.create(box(24.0, dtype=f64, device=dev), gw=0.9)
    fev2 = p2.sum(torch.tensor([[0.0, 0, 0], [5.0, 0, 0]], dtype=f64, device=dev),
                  torch.tensor([1.0, -1.0], dtype=f64, device=dev), Computables(True, True))
    f = fev2.force.cpu()
    newton3 = float((f[0] + f[1]).abs().max())
    check(float(f[0, 0]) > 0 and newton3 < 1e-10,
          f"two charges attract and F0 = -F1 ({newton3:.3g})")
    info = {"far_grid": list(ps0.far.shape), "far_support": ps0.far.support,
            "ngw": ps0.ngw, "rcut": ps0.rcut, "near_spec": list(ps0.spec.array_shape),
            "near_spec_strag": list(ps1.spec.array_shape), "stragglers": n_s,
            "fit_error": ps0.fit_error}
    print(json.dumps({"phase": "poisson_checks", "ok": True, **info,
                      "functor_rel_abs_control": errs, "tol": CHANNEL_TOL,
                      "strag_apply": apply_errs, "wigner_rel_err": wigner,
                      "newton3_abs": newton3}), flush=True)
    return {"functor": errs, "apply": apply_errs, "info": info}


def poisson_counters() -> dict:
    from uammd_tpu_torch.engine import pair_kernel
    from uammd_tpu_torch.solvers import pencil_ibm

    return {"pair_channel_poisson": pair_kernel.PAIR_CHANNEL_POISSON,
            "pencil_spread": pencil_ibm.SPREAD, "pencil_interp": pencil_ibm.INTERP}


def poisson_main_path(dev, card, checks):
    """main_path_poisson, the split-invariance gate and breakdown_poisson;
    returns the kernels-line row of the Poisson functor."""
    import numpy as np
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.core.state import make_state
    from uammd_tpu_torch.core.types import Computables, ForceEnergyVirial
    from uammd_tpu_torch.electrostatics.poisson import Poisson
    from uammd_tpu_torch.engine import layout, pair_kernel
    from uammd_tpu_torch.integrators import brownian
    from uammd_tpu_torch.solvers import pencil_ibm

    pos, q, pos_np = electrolyte(dev)
    ps = poisson_split(dev, pos_np)
    fe = Computables(force=True, energy=True)

    def force_fn(s, ovf):
        fev = ps.sum(s.pos, q, fe)
        return fev, ovf | ps.near.last_overflow

    integ = brownian.euler_maruyama(force_fn, dt=E_DT, temperature=E_T, viscosity=E_VISC,
                                    hydrodynamic_radius=E_RH)
    counted = poisson_counters()
    for k in counted.values():
        k.launches = 0
    st = make_state(pos_np, charge=q.cpu().numpy(), seed=0, device=dev)
    st, ovf = integ.init(st, torch.zeros((), dtype=torch.bool, device=dev))
    for _ in range(E_WARM):
        st, ovf = integ.step(st, ovf)
    torch.cuda.synchronize()
    before = {k: v.launches for k, v in counted.items()}
    t0 = time.perf_counter()
    for _ in range(E_TIMED):
        st, ovf = integ.step(st, ovf)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    timed = {k: launches[k] - before[k] for k in counted}
    reads = host_reads(lambda: integ.step(st, ovf), HOST_READ_STEPS)
    f64 = st.force.double()
    sum_f = float(f64.sum(dim=0).abs().max())
    rms_f = float(f64.pow(2).sum(dim=1).mean().sqrt())
    check(not bool(ovf), "Poisson path: no near-grid overflow")
    check(bool(st.pos.isfinite().all()) and bool(st.force.isfinite().all()),
          "Poisson path: positions and forces finite (a pencil overflow NaN-poisons)")
    check(sum_f / (E_N * rms_f) < SUM_F_TOL,
          f"Poisson path: |sum F| / (N rms F) = {sum_f / (E_N * rms_f):.3g} < {SUM_F_TOL}")
    for k in counted:
        check(timed[k] == E_TIMED, f"Poisson path: {k} launched {timed[k]} == {E_TIMED} times")
    ms = 1e3 * timed_s / E_TIMED
    print(json.dumps({
        "phase": "main_path_poisson", "n": E_N, "box": E_L, "gw": E_GW, "split": E_SPLIT,
        "dt": E_DT, "warm_steps": E_WARM, "timed_steps": E_TIMED, "timed_seconds": timed_s,
        "ms_per_step": ms, "particle_steps_per_s": E_N * E_TIMED / timed_s,
        **checks["info"], "launches": launches, "timed_launches": timed,
        "sum_f_over_n_rms_f": sum_f / (E_N * rms_f), "rms_f": rms_f,
        "host_reads_per_step": len(reads) / HOST_READ_STEPS, "host_reads_at": reads,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)

    # split invariance at the path's first configuration
    settings = {"split_0.175": ps, f"split_0.175_strag{E_STRAG}":
                poisson_split(dev, pos_np, n_strag=E_STRAG),
                "split_0.25": poisson_split(dev, pos_np, split=0.25)}
    res = {}
    for name, solver in settings.items():
        fev = solver.sum(pos, q, fe)
        res[name] = (fev.force, float(fev.energy.double().sum()))
    del settings
    torch.cuda.empty_cache()
    nosplit = Poisson.create(box(E_L, device=dev), gw=E_GW, tolerance=E_TOL)
    fev = nosplit.sum(pos, q, fe)  # the first call makes the FFT plans and k-space factors
    del fev
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fev = nosplit.sum(pos, q, fe)
    torch.cuda.synchronize()
    nosplit_s = time.perf_counter() - t0
    f_ref, e_ref = fev.force, float(fev.energy.double().sum())
    fmax = float(f_ref.abs().max())
    inv = {}
    for name, (f, e) in res.items():
        inv[name] = {"energy": e, "energy_rel_gap": abs(e - e_ref) / max(1.0, abs(e_ref)),
                     "force_gap_over_max_f": float((f - f_ref).abs().max()) / fmax}
        check(inv[name]["energy_rel_gap"] < SPLIT_E_RTOL,
              f"split invariance: {name} energy {e:.6g} vs no-split {e_ref:.6g}")
    gaps = [v["force_gap_over_max_f"] for v in inv.values()]
    forces_ok = max(gaps) < SPLIT_F_TOL
    print(json.dumps({"phase": "split_invariance", "no_split_grid": list(nosplit.shape),
                      "no_split_support": nosplit.support, "no_split_energy": e_ref,
                      "no_split_sum_seconds": nosplit_s, "settings": inv,
                      "energy_rtol": SPLIT_E_RTOL, "force_tol": SPLIT_F_TOL,
                      "forces_within_tol": forces_ok,
                      "fit_error": ps.fit_error}), flush=True)
    check(forces_ok, f"split invariance: forces within {SPLIT_F_TOL} x max|f| ({gaps})")
    del fev, f_ref, res, nosplit
    torch.cuda.empty_cache()

    # breakdown_poisson at the path's final state
    p = st.pos
    far = ps.far
    kern_g = far._kernel()
    kern, args, blk, cg = near_args(ps, p, q)
    bins = pencil_ibm.bin_pencils(p, far.shape, far.box)
    rho, _ = pencil_ibm.spread_pencil_fused(kern_g, p, q, far.shape, far.box, bins)
    f4 = torch.fft.irfftn(torch.stack([torch.fft.rfftn(rho)] * 4), s=far.shape, dim=(1, 2, 3))
    f4v = f4.permute(1, 2, 3, 0)
    fev = ps.sum(p, q, fe)
    far_rows = pencil_rows("_poisson", "Poisson path's final state (far field)", kern_g, p, q,
                           f4v, far.shape, far.box, bins, 0, launches)
    t = {
        "near_pair_channel_poisson": cuda_ms(lambda: kern(*args, strag=blk), reps=10),
        "spread": far_rows[0]["ms"],
        "interpolate": far_rows[1]["ms"],
        "ffts": cuda_ms(lambda: torch.fft.irfftn(
            torch.stack([torch.fft.rfftn(rho)] * 4), s=far.shape, dim=(1, 2, 3)), reps=10),
        "pencil_bins": cuda_ms(lambda: pencil_ibm.bin_pencils(p, far.shape, far.box), reps=10),
        "near_pack_unpack": cuda_ms(lambda: layout.unpack_values(
            cg, layout.pack_channels(ps.spec, p, q[:, None]).channels * 4), reps=10),
    }
    cached = ForceEnergyVirial(force=fev.force, energy=fev.energy)
    bd = brownian.euler_maruyama(lambda s, a: (cached, a), dt=E_DT, temperature=E_T,
                                 viscosity=E_VISC, hydrodynamic_radius=E_RH)
    t["bd_update"] = cuda_ms(lambda: bd.step(st, None), reps=20)
    by_part = dict(t)
    print(json.dumps({
        "phase": "breakdown_poisson", "card": card, "ms_per_step": ms, "ms_per_call": t,
        "shares": {k: v / ms for k, v in by_part.items()},
        "rest_ms": ms - sum(by_part.values()),
        "note": "each part once per step, timed alone with CUDA events at the path's final "
                "state; ffts = one rfftn and one 4-channel irfftn; near_pack_unpack = "
                "pack_channels and unpack_values of the near grid; rest = the k-space "
                "products, the straggler pairs, the force and energy sums"}), flush=True)

    # the Poisson functor's row at the path's final state
    fn = ps.near.pair_fn()
    want = pair_kernel.functor_plain(ps.spec, fn, *args[:3], args[3:])
    got = kern(*args, strag=blk)
    err_abs = max(float((a - b).abs().max()) for a, b in zip(want, got))
    check(err_abs / max(float(a.abs().max()) for a in want) < CHANNEL_TOL,
          "Poisson path's final state: functor vs plain")
    plain_ms = cuda_ms(lambda: pair_kernel.functor_plain(ps.spec, fn, *args[:3], args[3:]),
                       reps=2, warmup=1)
    pairs = functor_pairs(ps.spec, cg.x, cg.y, cg.z, cg.pid,
                          float(np.float32(ps.spec.cutoff ** 2)))
    row = functor_row("pair_channel_poisson", "uammd_tpu/engine/pair_kernel.py:538 "
                      "(poisson.py:350-395 functor)", launches["pair_channel_poisson"], err_abs,
                      t["near_pair_channel_poisson"], plain_ms, pairs, OPS_POISSON, 8, ps.spec,
                      extra={"checks": checks["functor"],
                             "launches_per_timed_step": timed["pair_channel_poisson"] / E_TIMED},
                      fn=fn)
    return [row] + far_rows, {"ms": ms, "launches": launches, "spread_ms": t["spread"],
                              "interp_ms": t["interpolate"], "pos": p, "q": q, "far": far,
                              "bins": bins, "field": f4v}


def poisson_only(dev, card) -> int:
    """``--only-poisson``: slice E1's checks and path alone, for working on
    them; prints no result line."""
    checks = poisson_checks(dev)
    rows, _ = poisson_main_path(dev, card, checks)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# ------------------------------------------ slice G1: the grid engines on a z-slab mesh
# The port keeps a mesh inside one process (uammd_tpu_torch/parallel/mesh.py):
# on this one card every shard of a 4-shard mesh lives on cuda:0, so each
# halo kernel launches once per shard for real and the exchanges between
# shards are device-local copies. A mesh here measures the halo machinery
# and the migration, not interconnect traffic.
# - DD2 (main_path_dd2): bench.py's liquid (N = 2^20, box 128, rcut 2.5, skin
#   1.2, T 1.5, friction 1, dt 0.01) from the melted positions, built by
#   make_lj_domain2 with n_strag 16 per shard, the exact reciprocal and "bm"
#   noise (#11), on 4 shards (nz 42 floored to 40, 10 rows a shard) and on 1
#   shard (the single-chip engine plus the halo machinery).
# - DD v1 (make_domain_md_step2), DPD and SPH on 4 shards at main_path's,
#   main_path_dpd's and main_path_sph's sizes.
DD_SHARDS = 4
DD_SETTLE, DD_TIMED = 100, 200
DDC_SETTLE, DDC_TIMED = 50, 100
# the DD force against the single-chip engine's folded force, x max|f|
# (float32 sums in another order: the Newton kernels add their reactions
# with atomics)
DD_FORCE_TOL = 1e-5
# DD2 on 4 shards against the single-chip unfused engine after 2 steps
# through a forced rebin (tests/test_domain2.py:115-116)
DD_TRAJ_TOL = 1e-5
DD_TRAJ_STEPS = 20


def dd_clump_system():
    """tests/test_domain2.py:25's jittered lattice (n 2400, L 48) with one
    dense clump (numpy): (pos, vel)."""
    import numpy as np
    from uammd_tpu_torch.utils.lattices import lattice

    n, L = 2400, 48.0
    rng = np.random.default_rng(0)
    gx, gy, gz = np.meshgrid(*[np.arange(4) * 1.1] * 2, np.arange(3) * 1.1)
    clump = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)[:48] + 5.0
    base = lattice(n, L * 0.98, "fcc") + rng.normal(0.0, 0.05, (n, 3))
    lo, hi = clump.min(axis=0) - 1.0, clump.max(axis=0) + 1.0
    base = base[~np.all((base > lo) & (base < hi), axis=1)][: n - 48]
    pos = np.concatenate([base, clump], axis=0).astype(np.float32)
    return pos, rng.normal(0.0, 0.3, (n, 3)).astype(np.float32)


def dd_mesh(dev, n_shards):
    from uammd_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_shards, devices=[dev] * n_shards)


def dd2_setup(dev, pos, n_shards, *, vel=None, temperature=TEMPERATURE, box=None, n=None,
              n_strag=N_STRAG, dt=0.01, seed=1):
    """(step, sharded state, spec, single-chip engine) of the v2 DD engine."""
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.parallel import domain2

    box = BOX if box is None else box
    n = N if n is None else n
    mesh = dd_mesh(dev, n_shards)
    if vel is None:
        return domain2.make_lj_domain2(mesh, box, n, dt=dt, temperature=temperature,
                                       n_strag=n_strag, pos=pos, seed=seed)
    spec = layout.choose_spec(box, n, 2.5, pos=pos, n_strag=n_strag, nz_multiple=n_shards)
    md = domain2._single_chip_md2(spec, 1.0, 1.0, dt, temperature, 1.0, 1.0, False, dev)
    gs = md.init(pos, vel=vel, seed=seed)
    step = domain2.make_domain_md2_step(mesh, spec, dt=dt, temperature=temperature, n_total=n)
    return step, domain2.shard_md2_state(md, gs, mesh, seed=seed), spec, md


def dd2_strag_block(step, st, i):
    import torch

    S, nlane = step.S, step.local_spec.nlane
    sval = (st.spidf[i] > 0.5).to(torch.float32)
    block = torch.stack([st.spos[i][:, 0], st.spos[i][:, 1], st.spos[i][:, 2], sval])
    return block[:, :, None].expand(4, S, nlane)


def dd2_newton(step, st, i, ghost, plain=False):
    """Shard i's Newton outputs (kernel or plain) with the ghost row
    ``ghost``, as a list (home, groups, straggler forces)."""
    from uammd_tpu_torch.engine import kernel2

    strag = dd2_strag_block(step, st, i) if step.S else None
    args = (st.x[i], st.y[i], st.z[i])
    if plain:
        out = kernel2.newton_pair_plain(step.local_spec, step.kern.g_fn, *args, strag,
                                        ghost=ghost)
    else:
        out = step.kern(*args, *ghost, strag) if strag is not None else step.kern(*args, *ghost)
    home, groups, sf = out
    return list(home) + [c for g in groups for c in g] + ([sf] if sf is not None else [])


def check_newton_halo(step, st, what, control=False):
    """#6 halo_z on every shard against its plain version: every output
    within 1e-5 of max|f| and every slot within SLOT_TOL of |f_ref| +
    median|f| (both over all shards' folded forces, the median over the
    slots that feel a force). With ``control`` the ghost rows are emptied
    (EMPTY_POS) on the kernel's side, which must fail the per-slot check.
    Returns the worst errors."""
    import torch
    from uammd_tpu_torch.engine import kernel2, layout

    ghosts = step.ghost_rows(st.x, st.y, st.z)
    refs, fa = [], []
    for i in range(step.n_dev):
        ref = dd2_newton(step, st, i, ghosts[i], plain=True)
        zeros = [torch.zeros_like(ghosts[i][0]) for _ in range(9)]
        folded = kernel2.fold_reactions_halo_plain(ref[:3], [ref[3 + 3 * g:6 + 3 * g]
                                                             for g in range(4)], zeros)
        m = st.pidf[i] > 0.5
        fa.append(torch.cat([a[m].abs() for a in folded]))
        refs.append(ref)
    fa = torch.cat(fa)
    scale = (float(fa.max()), float(fa[fa > 0].median()))
    worst = {"rel": 0.0, "slot": 0.0, "max_f": scale[0], "median_f": scale[1]}
    ctrl = 0.0
    for i, ref in enumerate(refs):
        test = dd2_newton(step, st, i, ghosts[i])
        check(all(bool(a.isfinite().all()) for a in test), f"{what} shard {i}: finite")
        err = newton_errs(ref, test, scale)
        check(err["rel"] < 1e-5 and err["slot"] < SLOT_TOL,
              f"{what} shard {i}: Newton halo_z vs plain {err['rel']:.3g} < 1e-5, per slot "
              f"{err['slot']:.3g} < {SLOT_TOL}")
        worst = {k: max(v, err.get(k, v)) for k, v in worst.items()}
        if control:
            empty = tuple(torch.full_like(g, layout.EMPTY_POS) for g in ghosts[i])
            ctrl = max(ctrl, newton_errs(ref, dd2_newton(step, st, i, empty), scale)["slot"])
    if control:
        check(ctrl > 100 * SLOT_TOL, f"{what}: control (ghost rows emptied) fails the "
                                     f"per-slot check ({ctrl:.3g} > {100 * SLOT_TOL})")
        worst["control_ghost_emptied"] = ctrl
    return worst


def check_fold_halo(step, st, what, control=False):
    """#8 on every shard's Newton outputs and the reactions its down
    neighbour sends, in the list form and through the stacked entry the
    path calls: bit-equal to its plain version; with ``control``, recv
    zeroed must change the result. Returns the max abs difference."""
    import torch
    from uammd_tpu_torch.engine import kernel2
    from uammd_tpu_torch.parallel.mesh import perm_up, ppermute

    n = step.n_dev
    ghosts = step.ghost_rows(st.x, st.y, st.z)
    outs = [dd2_newton(step, st, i, ghosts[i]) for i in range(n)]
    nzl = step.nz_loc
    rec = ppermute([torch.stack([o[3 + k][nzl - 1] for k in range(9)]) for o in outs],
                   perm_up(n))
    err, changed = 0.0, False
    for i in range(n):
        home, groups = outs[i][:3], [outs[i][3 + 3 * g:6 + 3 * g] for g in range(4)]
        recv = [rec[i][k][None] for k in range(9)]
        got = step.fold(home, groups, recv)
        want = kernel2.fold_reactions_halo_plain(home, groups, recv)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{what} shard {i}: halo fold bit-equal to plain")
        # the stacked entry as the path calls it: the Newton outputs as one
        # [15, ...] buffer and the exchanged [9, nyb, CAP, NLANE] block
        got_s = step.fold.stacked(torch.stack(outs[i][:15]), rec[i])
        check(all(torch.equal(a, b) for a, b in zip(got_s, want)),
              f"{what} shard {i}: the halo fold's stacked entry bit-equal to plain")
        err = max(err, max(float((a - b).abs().max()) for a, b in zip(got, want)))
        zero = step.fold(home, groups, [torch.zeros_like(r) for r in recv])
        changed |= not all(torch.equal(a, b) for a, b in zip(zero, got))
    if control:
        check(changed, f"{what}: control (recv zeroed) changes the fold")
    return err


def dd_slab(a, shard, nz_loc, shift=0.0):
    """Shard ``shard``'s rows of a periodic grid with one ghost row at each
    end (across the global boundary moved by -shift / +shift), as
    parallel/domain.py:halo_extend builds them."""
    import torch

    nz = a.shape[0]
    lo, hi = shard * nz_loc, (shard + 1) * nz_loc
    below = a[(lo - 1) % nz][None] - (shift if lo == 0 else 0.0)
    above = a[hi % nz][None] + (shift if hi == nz else 0.0)
    return torch.cat([below, a[lo:hi], above]).contiguous()


def dd_halo_spec(spec, n_shards):
    import dataclasses

    nzl = spec.shape[2] // n_shards
    return dataclasses.replace(spec, shape=spec.shape[:2] + (nzl + 2,)), nzl


def check_pair_force_halo(gs, what):
    """#1's halo mode on shard 0's halo-extended slab against its plain
    version (max|df| / max|f| < 1e-5); control: the ghost rows' image
    shift dropped must break the first home row. Returns (rel err, control,
    abs err)."""
    from uammd_tpu_torch.engine import md, pair_kernel

    local, nzl = dd_halo_spec(gs.spec, DD_SHARDS)
    L = gs.spec.box_size[2]
    slab = [dd_slab(gs.x, 0, nzl), dd_slab(gs.y, 0, nzl), dd_slab(gs.z, 0, nzl, L)]
    g = md.lj_g()
    kern = pair_kernel.make_pair_force_kernel(local, g, periodic_z=False)
    got = kern(*slab)
    want = pair_kernel.pair_force_plain(local, g, *slab, periodic_z=False)
    m = slab[0] < 1e8
    err = rel_force_err(want, got, m)
    check(err < 1e-5, f"{what}: #1 halo vs plain {err:.3g} < 1e-5")
    bad = kern(slab[0], slab[1], dd_slab(gs.z, 0, nzl))
    ctrl = rel_force_err([w[1] for w in want], [b[1] for b in bad], m[1])
    check(ctrl > 1e-3, f"{what}: control (ghost shift dropped) fails ({ctrl:.3g})")
    return err, ctrl, max(float((a[m] - b[m]).abs().max()) for a, b in zip(want, got))


def check_functor_halo(spec, fn, grids, channels, what, info=None):
    """#2's halo mode with ``fn`` on shard 0's halo-extended slab of the
    grids (x, y, z and the channel grids; 0-d channels stay uniform):
    within CHANNEL_TOL x max|ref| (or x max sum_j |term| with ``info``, as
    check_functor); control: the ghost rows' image shift dropped must fail
    that bound. Returns (rel err, control, abs err)."""
    from uammd_tpu_torch.engine import pair_kernel

    local, nzl = dd_halo_spec(spec, DD_SHARDS)
    L = spec.box_size[2]
    xyz = [dd_slab(grids[0], 0, nzl), dd_slab(grids[1], 0, nzl), dd_slab(grids[2], 0, nzl, L)]
    ch = [c if c.dim() == 0 else dd_slab(c, 0, nzl) for c in channels]
    kern = pair_kernel.make_pair_channel_kernel(local, fn, periodic_z=False)
    got = kern(*xyz, *ch)
    want = pair_kernel.channel_plain(local, fn, fn.n_out, *xyz, ch, periodic_z=False)
    for a in got:
        check(bool(a.isfinite().all()), f"{what}: outputs finite")
    err_abs = max(float((a - b).abs().max()) for a, b in zip(want, got))
    scale = max(float(a.abs().max()) for a in want)
    if info is not None:
        absum = pair_kernel.channel_plain(local, lambda *a: tuple(t.abs() for t in fn(*a)),
                                          fn.n_out, *xyz, ch, periodic_z=False)
        info["rel_err_vs_max_ref"] = err_abs / scale
        scale = max(float(a.max()) for a in absum)
        info["scale_sum_abs_terms"] = scale
    err = err_abs / scale
    check(err < CHANNEL_TOL, f"{what}: #2 halo vs plain {err:.3g} < {CHANNEL_TOL}")
    bad = kern(xyz[0], xyz[1], dd_slab(grids[2], 0, nzl), *ch)
    ctrl = max(float((a[1] - b[1]).abs().max()) for a, b in zip(bad, want)) / scale
    check(ctrl > CHANNEL_TOL, f"{what}: control (ghost shift dropped) fails ({ctrl:.3g})")
    return err, ctrl, err_abs


def dd_channel_states(dev):
    """The first states of main_path_dpd and main_path_sph (their engines
    and packed states)."""
    from uammd_tpu_torch.engine.dpd import GridDPD
    from uammd_tpu_torch.engine.sph import GridSPH
    from uammd_tpu_torch.interactors.sph import SPHParams

    pos = fcc_start(N, DPD_L, 0.13, 11)
    dpd = GridDPD.create(DPD_L, N, pos=pos, device=dev, **DPD_KW)
    g_dpd = dpd.init(pos, vel=zero_momentum(N, math.sqrt(DPD_KW["temperature"]), 12))
    pos = fcc_start(N, SPH_L, 0.05, 13)
    sph = GridSPH.create(SPH_L, N, SPHParams(**SPH_KW), dt=SPH_DT, pos=pos, device=dev)
    g_sph = sph.init(pos, vel=zero_momentum(N, SPH_V0, 14))
    return (dpd, g_dpd), (sph, g_sph)


def dd_kernel_checks(dev, melted):
    """dd_kernel_checks: #6 halo_z, #8, #1 and #2 (DPD, SPH density and
    force) in their halo modes against their plain versions, each with a
    control that must fail."""
    import torch
    from uammd_tpu_torch.engine import layout

    out = {}
    pos, vel = dd_clump_system()
    step, st, spec, _ = dd2_setup(dev, pos, DD_SHARDS, vel=vel, temperature=0.0, box=48.0,
                                  n=2400, n_strag=24, dt=0.05)
    check(sum(int((s > 0.5).sum()) for s in st.spidf) > 0, "clump system: stragglers present")
    out["newton_halo_clump"] = check_newton_halo(step, st, "clump system 4 shards")
    out["fold_halo_clump"] = check_fold_halo(step, st, "clump system 4 shards")
    step, st, spec, _ = dd2_setup(dev, melted, DD_SHARDS, temperature=0.0)
    out["newton_halo_2^20"] = check_newton_halo(step, st, "2^20 liquid 4 shards", control=True)
    out["fold_halo_2^20"] = check_fold_halo(step, st, "2^20 liquid 4 shards", control=True)
    out["dd2_spec"] = list(step.local_spec.array_shape)
    del step, st
    spec1 = layout.choose_spec(BOX, N, 2.5, pos=melted, nz_multiple=DD_SHARDS)
    gs1 = layout.pack(spec1, melted, device=dev)
    out["pair_force_halo"] = check_pair_force_halo(gs1, "2^20 liquid shard 0")
    del gs1
    (dpd, g_dpd), (sph, g_sph) = dd_channel_states(dev)
    a = dpd_args(dpd, g_dpd)
    out["dpd_halo"] = check_functor_halo(dpd.spec, dpd.kern.fn, a[:3], a[3:],
                                         "DPD first state shard 0")
    a_rho, a_f = sph_args(sph, g_sph)
    out["sph_density_halo"] = check_functor_halo(sph.spec, sph.rho_kern.fn, a_rho[:3],
                                                 a_rho[3:], "SPH first state shard 0")
    info = {}
    out["sph_force_halo"] = check_functor_halo(sph.spec, sph.f_kern.fn, a_f[:3], a_f[3:],
                                               "SPH first state shard 0", info=info)
    out["sph_force_halo_info"] = info
    del dpd, g_dpd, sph, g_sph, a, a_rho, a_f
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "dd_kernel_checks", "ok": True, **out,
                      "slot_tol": SLOT_TOL, "channel_tol": CHANNEL_TOL,
                      "fold_halo": "bit-equal"}), flush=True)
    return out


def dd_force_parity(dev, melted):
    """dd_force_parity: the assembled DD force on one state against the
    single-chip engine's folded force (DD2 on 1 and 4 shards of the melted
    liquid and on 8 shards of the clump system, the straggler forces in the
    shard lists' order) and DD v1 against GridMD's #1 force, within
    DD_FORCE_TOL x max|f|."""
    import torch
    from uammd_tpu_torch.engine import layout, md, pair_kernel
    from uammd_tpu_torch.parallel.domain import halo_extend

    out = {}
    pos, vel = dd_clump_system()
    # the melted liquid has (almost) no stragglers; the clump system on 8
    # shards (2 rows a shard) puts its stragglers next to a shard boundary
    cases = [(1, dict(pos=melted)), (DD_SHARDS, dict(pos=melted)),
             (8, dict(pos=pos, vel=vel, box=48.0, n=2400, n_strag=24, dt=0.05))]
    for n_shards, kw in cases:
        step, st, spec, _ = dd2_setup(dev, kw.pop("pos"), n_shards, temperature=0.0, **kw)
        fx, fy, fz, sf = step.compute_forces(st.x, st.y, st.z, st.pidf, st.spos, st.spidf)
        ref = [torch.cat(a) for a in (st.fx, st.fy, st.fz)]
        got = [torch.cat(a) for a in (fx, fy, fz)]
        m = torch.cat(st.pidf) > 0.5
        fmax = max(float(a[m].abs().max()) for a in ref)
        err = max(float((a[m] - b[m]).abs().max()) for a, b in zip(ref, got)) / fmax
        serr = max(float((a - b).abs().max()) for a, b in zip(st.sforce, sf)) / fmax
        n_strag = sum(int((s > 0.5).sum()) for s in st.spidf)
        check(err < DD_FORCE_TOL and serr < DD_FORCE_TOL,
              f"DD2 {n_shards} shards: force vs single chip {err:.3g}, stragglers {serr:.3g} "
              f"< {DD_FORCE_TOL}")
        name = f"dd2_{n_shards}" if n_shards != 8 else "dd2_8_clump"
        out[name] = {"rel_err": err, "strag_rel_err": serr, "stragglers": n_strag,
                     "max_f": fmax}
        del step, st, fx, fy, fz, ref, got
    spec1 = layout.choose_spec(BOX, N, 2.5, pos=melted, nz_multiple=DD_SHARDS)
    gs1 = layout.pack(spec1, melted, device=dev)
    ref = pair_kernel.make_pair_force_kernel(spec1, md.lj_g())(gs1.x, gs1.y, gs1.z)
    local, nzl = dd_halo_spec(spec1, DD_SHARDS)
    kern = pair_kernel.make_pair_force_kernel(local, md.lj_g(), periodic_z=False)
    L = spec1.box_size[2]
    shards = [[a[i * nzl:(i + 1) * nzl] for i in range(DD_SHARDS)] for a in (gs1.x, gs1.y, gs1.z)]
    ext = [halo_extend(shards[0]), halo_extend(shards[1]), halo_extend(shards[2], -L, L)]
    got = [torch.cat([kern(ext[0][i], ext[1][i], ext[2][i])[c][1:-1] for i in range(DD_SHARDS)])
           for c in range(3)]
    err = rel_force_err(ref, got, gs1.mask)
    check(err < DD_FORCE_TOL, f"DD v1 4 shards: force vs GridMD's #1 {err:.3g} < {DD_FORCE_TOL}")
    out["dd_v1_4"] = {"rel_err": err}
    print(json.dumps({"phase": "dd_force_parity", "ok": True, **out, "tol": DD_FORCE_TOL}),
          flush=True)
    return out


def dd_counters() -> dict:
    from uammd_tpu_torch.engine import kernel2, pair_kernel, rebin_kernel, update_kernel

    return {"newton_pair_halo": kernel2.NEWTON_PAIR_HALO, "fold_halo": kernel2.FOLD_HALO,
            "gj_update": update_kernel.GJ_UPDATE, "newton_pair": kernel2.NEWTON_PAIR,
            "fold": kernel2.FOLD, "gj_fold_update": update_kernel.GJ_FOLD_UPDATE,
            "separable_rebin": rebin_kernel.SEP_REBIN,
            "pair_force_halo": pair_kernel.PAIR_FORCE_HALO,
            "pair_force": pair_kernel.PAIR_FORCE,
            "pair_channel_dpd_halo": pair_kernel.PAIR_CHANNEL_DPD_HALO,
            "pair_channel_sph_density_halo": pair_kernel.PAIR_CHANNEL_SPH_DENSITY_HALO,
            "pair_channel_sph_force_halo": pair_kernel.PAIR_CHANNEL_SPH_FORCE_HALO}


def dd2_temperature(step, st, dt=0.01, mass=1.0) -> float:
    """The kinetic temperature of a sharded v2 state: v = w + (dt / 2m) f
    on the grid slots and the straggler rows."""
    import numpy as np
    import torch

    hv = float(np.float32(0.5 * dt / mass))
    ke = torch.zeros((), dtype=torch.float64, device=st.x[0].device)
    for i in range(step.n_dev):
        m = (st.pidf[i] > 0.5).to(torch.float32)
        for w, f in ((st.wx, st.fx), (st.wy, st.fy), (st.wz, st.fz)):
            ke += (((w[i] + hv * f[i]) * m) ** 2).double().sum()
        if step.S:
            sm = (st.spidf[i] > 0.5)[:, None]
            ke += (((st.svelw[i] + hv * st.sforce[i]) * sm) ** 2).double().sum()
    return float(0.5 * mass * ke) * 2.0 / (3.0 * N)


def dd_host_reads(step_fn, holder, steps, rebins_of):
    """Host reads of ``steps`` single steps, split into steps without and
    with a rebin: (reads per plain step, [reads of each rebin step])."""
    plain, rebin = [], []
    for _ in range(steps):
        r0 = rebins_of()
        reads = host_reads(lambda: holder.__setitem__(0, step_fn(holder[0])), 1)
        (rebin if rebins_of() > r0 else plain).append(len(reads))
    return plain, rebin


class HeldSep:
    """A separable rebin #5 that, while ``hold`` is set (the settle steps,
    outside the timed window), holds each of its calls (the path's own
    launch) to the plain version (``check_sep_stacks``); it counts its
    calls and the held ones and keeps the last inputs."""

    def __init__(self, kern, what):
        self.kern, self.what = kern, what
        self.spec, self.ocap = kern.spec, kern.ocap
        self.calls, self.held, self.hold, self.last = 0, 0, True, None

    def __call__(self, stacked, strag):
        got = self.kern(stacked, strag)
        self.calls += 1
        if self.hold:
            self.held += 1
            check_sep_stacks(self.spec, stacked, strag, f"{self.what} {self.calls}",
                             self.ocap, got=got)
        self.last = (stacked, strag)
        return got


def main_path_dd2(dev, card, melted, n_shards):
    """main_path_dd2 on ``n_shards``: DD_SETTLE + DD_TIMED steps from the
    melted liquid, with the launch counts zeroed just before."""
    import torch
    from uammd_tpu_torch.parallel.domain2 import gather_md2_state

    counted = dd_counters()
    t0 = time.perf_counter()
    step, st, spec, _ = dd2_setup(dev, melted, n_shards)
    setup_s = time.perf_counter() - t0
    if step.sep is not None:
        step.sep = HeldSep(step.sep, f"DD2 {n_shards} shard rebin")
    for k in counted.values():
        k.launches = 0
    rebin_steps = []
    for k in range(DD_SETTLE + DD_TIMED):
        if k == DD_SETTLE:
            if step.sep is not None:
                step.sep.hold = False
            torch.cuda.synchronize()
            before = {name: c.launches for name, c in counted.items()}
            t0 = time.perf_counter()
        r0 = step.rebins
        st = step(st)
        if step.rebins > r0:
            rebin_steps.append(k)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    timed = {k: launches[k] - before[k] for k in counted}
    steps = DD_SETTLE + DD_TIMED
    what = f"DD2 {n_shards} shards"
    ovf = [float(o) for o in st.ovf]
    check(max(ovf) == 0.0, f"{what}: no overflow and every particle kept (ovf {ovf})")
    n_kept = sum(int((p > 0.5).sum()) + int((s > 0.5).sum()) for p, s in zip(st.pidf, st.spidf))
    check(n_kept == N, f"{what}: the count audit: {n_kept} == {N}")
    t_meas = dd2_temperature(step, st)
    check(math.isfinite(t_meas) and abs(t_meas - TEMPERATURE) < 0.2 * TEMPERATURE,
          f"{what}: temperature {t_meas:.4f} within 20 % of {TEMPERATURE}")
    pos, vel = gather_md2_state(st, spec, N)
    check(bool(torch.isfinite(torch.from_numpy(pos)).all() and
               torch.isfinite(torch.from_numpy(vel)).all()), f"{what}: state finite")
    for k in ("newton_pair_halo", "fold_halo", "gj_update"):
        check(launches[k] == n_shards * steps,
              f"{what}: {k} launched {launches[k]} == {n_shards} x {steps} times")
    for k in ("newton_pair", "fold", "gj_fold_update"):
        check(launches[k] == 0, f"{what}: {k} never launched ({launches[k]})")
    check(len(rebin_steps) >= 1, f"{what}: rebinned on drift ({len(rebin_steps)} steps)")
    if n_shards == 1:
        check(launches["separable_rebin"] == len(rebin_steps) == step.sep.calls,
              f"{what}: #5 launched on each rebin step ({launches['separable_rebin']})")
        check(step.sep.held >= 1, f"{what}: #5 held to its plain version on the "
                                  f"{step.sep.held} rebins of the settle steps")
    else:
        check(launches["separable_rebin"] == 0, f"{what}: the two-sort rebin, not #5")
    holder = [st]
    plain_reads, rebin_reads = dd_host_reads(step, holder, HOST_READ_STEPS,
                                             lambda: step.rebins)
    check(plain_reads and max(plain_reads) <= 1,
          f"{what}: {plain_reads} host reads per step outside rebins")
    # a rebin step forced by offsetting the drift references
    st = holder[0]
    thr = 10 * spec.drift_threshold
    holder[0] = st.replace(rx=[r + thr for r in st.rx])
    plain2, rebin2 = dd_host_reads(step, holder, 1, lambda: step.rebins)
    check(rebin2, f"{what}: the offset references force a rebin")
    ms = 1e3 * timed_s / DD_TIMED
    rec = {"phase": f"main_path_dd2_{n_shards}", "n": N, "box": BOX, "shards": n_shards,
           "card": card, "spec": list(spec.array_shape),
           "shard_spec": list(step.local_spec.array_shape), "n_strag_per_shard": N_STRAG,
           "noise": "bm (#11)", "fast_recip": False, "settle_steps": DD_SETTLE,
           "timed_steps": DD_TIMED, "setup_seconds": setup_s, "timed_seconds": timed_s,
           "ms_per_step": ms, "particle_steps_per_s": N * DD_TIMED / timed_s,
           "temperature": t_meas, "particles_kept": n_kept, "ovf": ovf,
           "stragglers": sum(int((s > 0.5).sum()) for s in st.spidf),
           "rebin": "separable #5" if n_shards == 1 else "two-sort with migration",
           "rebin_steps": rebin_steps, "launches": launches, "timed_launches": timed,
           "sep_rebins_held_to_plain": step.sep.held if step.sep is not None else 0,
           "timed_launches_per_step": {k: v / DD_TIMED for k, v in timed.items()},
           "host_reads_per_plain_step": plain_reads + plain2,
           "host_reads_per_rebin_step": rebin_reads + rebin2,
           "note": "all shards on one card: the exchanges are device-local copies"}
    print(json.dumps(rec), flush=True)
    return {"step": step, "st": holder[0], "spec": spec, "ms": ms, "launches": launches,
            "timed": timed, "rebin_steps": rebin_steps}


def dd2_trajectory_parity(dev, melted):
    """DD2 on 4 shards against the single-chip unfused engine at T = 0 from
    one state (velocities 1.5^0.5 N(0, 1) of zero net momentum), with a
    rebin forced at step 1 on both: positions and velocities by pid within
    DD_TRAJ_TOL after 2 steps; after DD_TRAJ_STEPS printed, not gated. A
    second single-chip run from the same state gives the engine's own
    run-to-run gap (the Newton kernel's float atomics), printed beside."""
    import numpy as np
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.parallel.domain2 import gather_md2_state

    vel = zero_momentum(N, math.sqrt(TEMPERATURE), 17)
    step, st, spec, md = dd2_setup(dev, melted, DD_SHARDS, vel=vel, temperature=0.0)
    off = 10 * spec.drift_threshold
    st = st.replace(rx=[r + off for r in st.rx])
    # the single-chip runs start from the sharded state's own forces
    gs0 = md.init(melted, vel=vel, seed=1)
    f0 = [torch.cat(a) for a in (st.fx, st.fy, st.fz)]
    w0 = [torch.cat(a) for a in (st.wx, st.wy, st.wz)]
    runs = [gs0.replace(fx=f0[0], fy=f0[1], fz=f0[2], vx=w0[0], vy=w0[1], vz=w0[2],
                        ref_x=gs0.ref_x + off) for _ in range(2)]
    gaps, spread = [], []
    r0 = step.rebins

    def pos_vel(gs):
        p, w, _ = (t.cpu().numpy() for t in layout.unpack(gs))
        return p, w

    def gap(a, b):
        d = a[0] - b[0]
        d -= BOX * np.round(d / BOX)
        return float(np.abs(d).max()), float(np.abs(a[1] - b[1]).max())

    for k in range(DD_TRAJ_STEPS):
        runs = [md.step(g) for g in runs]
        st = step(st)
        if k == 0:
            check(step.rebins == r0 + 1 and torch.equal(runs[0].ref_x, runs[0].x),
                  "DD2 trajectory: both rebin at step 1")
        if k in (0, 1, DD_TRAJ_STEPS - 1):
            one, two = pos_vel(runs[0]), pos_vel(runs[1])
            dd = gather_md2_state(st, spec, N)
            gaps.append(gap(dd, one))
            spread.append(gap(two, one))
    rec = {"phase": "dd2_trajectory_parity", "shards": DD_SHARDS,
           "temperature": 0.0, "forced_rebin_step": 1, "tol": DD_TRAJ_TOL,
           "max_abs_pos_vel_after_1": gaps[0], "max_abs_pos_vel_after_2": gaps[1],
           f"max_abs_pos_vel_after_{DD_TRAJ_STEPS}": gaps[2],
           "single_chip_run_to_run_after_1_2_and_last": spread,
           "note": "the liquid is chaotic: the 20-step gap is printed, not gated "
                   "(tests/test_domain2.py:66-72)"}
    print(json.dumps(rec), flush=True)
    check(max(gaps[1]) < DD_TRAJ_TOL,
          f"DD2 trajectory: after 2 steps |dpos|, |dvel| {gaps[1]} < {DD_TRAJ_TOL}")
    return rec


def dd_channel_path(what, step, st, counted, per_step, t_fn=None):
    """DDC_SETTLE + DDC_TIMED steps of a v1 / DPD / SPH DD step with the
    launch counts zeroed just before; ``t_fn(state)`` (0-d on the card) is
    averaged over the timed steps. Gates: no overflow, count = N, finite
    state, ``per_step`` kernels launched once per shard per step."""
    import torch

    for k in counted.values():
        k.launches = 0
    for _ in range(DDC_SETTLE):
        st = step(st)
    torch.cuda.synchronize()
    r0 = step.rebins
    t_sum = torch.zeros((), dtype=torch.float64, device=st.x[0].device)
    t0 = time.perf_counter()
    for _ in range(DDC_TIMED):
        st = step(st)
        if t_fn is not None:
            t_sum += t_fn(st)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    steps = DDC_SETTLE + DDC_TIMED
    ovf = [float(o) for o in st.ovf]
    check(max(ovf) == 0.0, f"{what}: no overflow and every particle kept (ovf {ovf})")
    n_kept = sum(int((p > 0.5).sum()) for p in st.pidf)
    check(n_kept == N, f"{what}: count {n_kept} == {N}")
    check(all(bool(a.isfinite().all()) for k in ("x", "y", "z", "vx", "vy", "vz")
              for a in getattr(st, k)), f"{what}: positions and velocities finite")
    for k, per in per_step.items():
        check(launches[k] == per * DD_SHARDS * steps,
              f"{what}: {k} launched {launches[k]} == {per} x {DD_SHARDS} x {steps}")
    mom = [sum(float(a.double().sum()) for a in getattr(st, k)) / N for k in ("vx", "vy", "vz")]
    return {"st": st, "ms": 1e3 * timed_s / DDC_TIMED, "timed_s": timed_s,
            "launches": launches, "rebins_timed": step.rebins - r0, "momentum": mom,
            "t_mean": float(t_sum) / DDC_TIMED if t_fn is not None else None,
            "particles_kept": n_kept, "ovf": ovf}


def dd_kinetic_t(st, mass=1.0):
    import torch

    ke = sum(((a.double() ** 2).sum() for k in ("vx", "vy", "vz") for a in getattr(st, k)),
             torch.zeros((), dtype=torch.float64, device=st.x[0].device))
    return ke * mass / (3.0 * N)


def main_path_dd_channels(dev, card, melted):
    """main_path_dd_v1, main_path_dd_dpd and main_path_dd_sph on 4 shards
    at full size; returns their records (with the final states)."""
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.engine import md as md_mod
    from uammd_tpu_torch.engine import pair_kernel
    from uammd_tpu_torch.parallel import domain

    counted = dd_counters()
    mesh = dd_mesh(dev, DD_SHARDS)
    runs = {}
    # v1
    spec = layout.choose_spec(BOX, N, 2.5, pos=melted, nz_multiple=DD_SHARDS)
    eng = md_mod.GridMD(spec=spec, force_kernel=pair_kernel.make_pair_force_kernel(
        spec, md_mod.lj_g()), dt=0.01, temperature=TEMPERATURE, friction=1.0, mass=1.0,
        device=dev)
    st = domain.shard_grid_state2(eng.init(melted, seed=2), mesh, seed=2)
    step = domain.make_domain_md_step2(mesh, spec, dt=0.01, temperature=TEMPERATURE,
                                       friction=1.0, n_total=N)
    run = dd_channel_path("DD v1", step, st, counted, {"pair_force_halo": 1})
    check(run["launches"]["pair_force"] == 0, "DD v1: the periodic #1 never launched")
    t = float(dd_kinetic_t(run["st"]))
    check(abs(t - TEMPERATURE) < 0.2 * TEMPERATURE,
          f"DD v1: temperature {t:.4f} within 20 % of {TEMPERATURE}")
    runs["v1"] = dict(run, temperature=t, spec=spec, step=step)
    # DPD
    (dpd, g_dpd), (sph, g_sph) = dd_channel_states(dev)
    check(dpd.spec.shape[2] % DD_SHARDS == 0, f"DPD nz {dpd.spec.shape[2]} divides the mesh")
    step = domain.make_domain_dpd_step(mesh, dpd.spec, n_total=N, **DPD_KW)
    run = dd_channel_path("DD DPD", step, domain.shard_channel_state(g_dpd, mesh), counted,
                          {"pair_channel_dpd_halo": 1}, t_fn=dd_kinetic_t)
    check(abs(run["t_mean"] - 1.0) < DPD_T_TOL,
          f"DD DPD: mean kinetic T {run['t_mean']:.4f} within {DPD_T_TOL:.0%} of 1")
    check(max(abs(p) for p in run["momentum"]) < MOMENTUM_TOL,
          f"DD DPD: |total momentum| / N {run['momentum']} < {MOMENTUM_TOL}")
    runs["dpd"] = dict(run, spec=dpd.spec, step=step, md=dpd)
    # SPH
    check(sph.spec.shape[2] % DD_SHARDS == 0, f"SPH nz {sph.spec.shape[2]} divides the mesh")
    step = domain.make_domain_sph_step(mesh, sph.spec, sph.params, dt=SPH_DT, n_total=N)
    run = dd_channel_path("DD SPH", step, domain.shard_channel_state(g_sph, mesh), counted,
                          {"pair_channel_sph_density_halo": 1, "pair_channel_sph_force_halo": 1})
    check(max(abs(p) for p in run["momentum"]) < MOMENTUM_TOL,
          f"DD SPH: |total momentum| / N {run['momentum']} < {MOMENTUM_TOL}")
    runs["sph"] = dict(run, spec=sph.spec, step=step, md=sph)
    for name, r in runs.items():
        print(json.dumps({
            "phase": f"main_path_dd_{name}", "n": N, "shards": DD_SHARDS, "card": card,
            "spec": list(r["spec"].array_shape), "settle_steps": DDC_SETTLE,
            "timed_steps": DDC_TIMED, "timed_seconds": r["timed_s"], "ms_per_step": r["ms"],
            "particle_steps_per_s": N * DDC_TIMED / r["timed_s"],
            "temperature": r.get("temperature"), "temperature_mean_timed": r["t_mean"],
            "momentum_per_particle": r["momentum"], "particles_kept": r["particles_kept"],
            "ovf": r["ovf"], "rebins_timed": r["rebins_timed"], "launches": r["launches"],
            "note": "all shards on one card: the exchanges are device-local copies"}),
            flush=True)
    return runs


def breakdown_dd2(card, dd4, dd1, unfused_ms, errs):
    """Each part of the 4-shard DD2 step timed alone with CUDA events at the
    path's final state (all shards), against the 1-shard run and the
    single-chip unfused step; returns the kernels-line rows of #6 halo_z
    and #8."""
    import torch
    from uammd_tpu_torch.engine import kernel2, layout
    from uammd_tpu_torch.parallel.domain2 import gather_md2_state
    from uammd_tpu_torch.parallel.mesh import perm_up, pmax, ppermute

    step, st, spec = dd4["step"], dd4["st"], dd4["spec"]
    n, nzl = step.n_dev, step.nz_loc
    ghosts = step.ghost_rows(st.x, st.y, st.z)
    blocks = [dd2_strag_block(step, st, i) for i in range(n)]
    args = [(st.x[i], st.y[i], st.z[i]) + ghosts[i] + (blocks[i],) for i in range(n)]
    bufs = [step.kern.stacked(*a)[0] for a in args]
    sends = [b[3:12, nzl - 1].contiguous() for b in bufs]
    rec = ppermute(sends, perm_up(n))
    t = {
        "newton_pair_halo": cuda_ms(lambda: [step.kern(*a) for a in args], reps=10),
        "exchanges": cuda_ms(lambda: (step.ghost_rows(st.x, st.y, st.z),
                                      ppermute(sends, perm_up(n))), reps=20),
        "fold_halo": cuda_ms(lambda: [step.fold.stacked(bufs[i], rec[i]) for i in range(n)],
                             reps=20),
        "gj_update": cuda_ms(lambda: [step.upd(
            st.x[i], st.y[i], st.z[i], st.wx[i], st.wy[i], st.wz[i], st.fx[i], st.fy[i],
            st.fz[i], st.rx[i], st.ry[i], st.rz[i], st.stepc[i],
            (st.spos[i], st.svelw[i], st.sforce[i], st.spidf[i]), st.sref[i])
            for i in range(n)], reps=20),
        "strag_row_pass": cuda_ms(lambda: [step.strag_row_pass(
            st.x[i][0], st.y[i][0], st.z[i][0], st.spos[i], st.spidf[i] > 0.5)
            for i in range(n) for _ in range(2)], reps=10),
        "ss_forces": cuda_ms(lambda: [step.ss_forces(
            st.spos[i], st.spidf[i] > 0.5, torch.cat([st.spos[i]] * 3),
            torch.cat([st.spidf[i] > 0.5] * 3)) for i in range(n)], reps=10),
        "compute_forces": cuda_ms(lambda: step.compute_forces(
            st.x, st.y, st.z, st.pidf, st.spos, st.spidf), reps=10),
        "rebin": cuda_ms(lambda: step._sort_rebin(
            {k: getattr(st, k) for k in ("x", "y", "z", "wx", "wy", "wz")}, st.pidf, st.spos,
            st.svelw, st.spidf), reps=3, warmup=1),
    }
    dinfs = [a.abs().max() for a in st.wx]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        float(pmax(dinfs)[0])
    t["drift_read"] = 1e3 * (time.perf_counter() - t0) / 20
    calls = {k: 1.0 for k in t}
    calls["rebin"] = len([s for s in dd4["rebin_steps"] if s >= DD_SETTLE]) / DD_TIMED
    by_part = {k: t[k] * calls[k] for k in t if k != "compute_forces"}
    print(json.dumps({
        "phase": "breakdown_dd2", "card": card, "shards": n, "ms_per_step": dd4["ms"],
        "ms_per_step_1_shard": dd1["ms"], "ms_per_step_single_chip_unfused": unfused_ms,
        "ms_per_step_all_shards": t, "calls_per_step": calls, "ms_per_step_by_part": by_part,
        "shares": {k: v / dd4["ms"] for k, v in by_part.items()},
        "rest_ms": dd4["ms"] - sum(by_part.values()),
        "note": "CUDA events on an idle card at the 4-shard path's final state, each part "
                "over all shards; compute_forces holds the exchanges, #6, #8 and the "
                "straggler passes; drift_read = host clock around the pmax and its read; "
                "the rebin (two-sort, host reads of _bin_columns' masks) on that state"}),
        flush=True)
    # the kernels-line rows: one step's launches over all shards
    gs = layout.pack(spec, gather_md2_state(st, spec, N)[0], device=st.x[0].device)
    pairs, cut = stencil_pairs(gs)
    slot = 4 * spec.n_slots
    S = step.S
    plain_newton = cuda_ms(lambda: [kernel2.newton_pair_plain(
        step.local_spec, step.kern.g_fn, *a[:3], a[6], ghost=a[3:6]) for a in args],
        reps=2, warmup=1)
    ghost_bytes = 3 * 4 * n * spec.n_slots // spec.shape[2]
    newton_ops_ms = 1e3 * (OPS_PAIR_TEST * pairs + OPS_PAIR_FORCE * cut) / PEAK_FP32_FLOPS
    newton_bytes_ms = 1e3 * (18 * slot + ghost_bytes + n * 28 * S) / PEAK_HBM_BYTES
    src = "uammd_tpu_torch/engine/csrc/"
    note = (f"ms, plain_ms and bound_ms cover one step's {n} launches (one per shard) at "
            "the 4-shard DD2 path's final state")
    return [
        {"name": "newton_pair_halo", "route": "cuda", "source": src + "newton_pair.cu",
         "replaces": "uammd_tpu/engine/kernel2.py:447 (halo_z, :74-134)",
         "launches": dd4["launches"]["newton_pair_halo"],
         "max_abs_err": errs["newton_halo_abs"], "ms": t["newton_pair_halo"],
         "plain_ms": plain_newton, "bound_ms": max(newton_ops_ms, newton_bytes_ms),
         "bound_by": "operations" if newton_ops_ms > newton_bytes_ms else "bytes",
         "library_ms": None, "launches_1_shard_path": dd1["launches"]["newton_pair_halo"],
         "stencil_pairs": pairs, "stencil_pairs_in_cutoff": cut, "note": note},
        {**fold_halo_row(dd4, dd4["launches"]["fold_halo"], "the 4-shard DD2 path's final "
                                                            "state"),
         "launches_1_shard_path": dd1["launches"]["fold_halo"],
         "max_abs_err_checks": errs["fold_halo_abs"]},
    ]


def dd_channel_rows(card, runs, checks):
    """The kernels-line rows of #1's and #2's halo modes at the v1, DPD and
    SPH DD paths' final states (one step's launches over all shards)."""
    import torch
    from uammd_tpu_torch.engine import layout, md as md_mod, pair_kernel
    from uammd_tpu_torch.parallel.domain import halo_extend

    rows = []
    note = (f"ms, plain_ms and bound_ms cover one step's {DD_SHARDS} launches per sweep at "
            "the 4-shard path's final state; pairs counted on the whole grid")
    # v1
    r = runs["v1"]
    st, spec = r["st"], r["spec"]
    L = spec.box_size[2]
    local, nzl = dd_halo_spec(spec, DD_SHARDS)
    ext = [halo_extend(st.x), halo_extend(st.y), halo_extend(st.z, -L, L)]
    kern = pair_kernel.make_pair_force_kernel(local, md_mod.lj_g(), periodic_z=False)
    ms = cuda_ms(lambda: [kern(ext[0][i], ext[1][i], ext[2][i]) for i in range(DD_SHARDS)],
                 reps=10)
    plain = cuda_ms(lambda: [pair_kernel.pair_force_plain(local, md_mod.lj_g(), ext[0][i],
                                                          ext[1][i], ext[2][i],
                                                          periodic_z=False)
                             for i in range(DD_SHARDS)], reps=1, warmup=1)
    gs = layout.pack(spec, torch.cat([torch.stack([a.reshape(-1) for a in
                                                   (st.x[i], st.y[i], st.z[i])], -1)
                                      for i in range(DD_SHARDS)])[
        torch.cat(st.pidf).reshape(-1) > 0.5], device=st.x[0].device)
    pairs, cut = stencil_pairs(gs)
    ops_ms = 1e3 * (OPS_PAIR_TEST * pairs + OPS_PAIR_FORCE * cut) / PEAK_FP32_FLOPS
    bytes_ms = 1e3 * 6 * 4 * DD_SHARDS * local.n_slots / PEAK_HBM_BYTES
    rows.append({"name": "pair_force_halo", "route": "cuda",
                 "source": "uammd_tpu_torch/engine/csrc/pair_force.cu",
                 "replaces": "uammd_tpu/engine/pair_kernel.py:272 (periodic_z=False, :99-102)",
                 "launches": r["launches"]["pair_force_halo"],
                 "max_abs_err": checks["pair_force_halo"][2], "ms": ms, "plain_ms": plain,
                 "bound_ms": max(ops_ms, bytes_ms),
                 "bound_by": "operations" if ops_ms > bytes_ms else "bytes", "library_ms": None,
                 "rel_err": checks["pair_force_halo"][0],
                 "control_ghost_shift_dropped": checks["pair_force_halo"][1],
                 "stencil_pairs": pairs, "stencil_pairs_in_cutoff": cut, "note": note})
    del ext, gs
    # DPD and SPH
    for name, sweeps in (("dpd", (("pair_channel_dpd_halo", "dpd_halo", OPS_DPD, 10,
                                   OPS_DPD_INT),)),
                         ("sph", (("pair_channel_sph_density_halo", "sph_density_halo",
                                   OPS_SPH_DENSITY, 5, 0),
                                  ("pair_channel_sph_force_halo", "sph_force_halo",
                                   OPS_SPH_FORCE, 11, 0)))):
        r = runs[name]
        st, spec, eng = r["st"], r["spec"], r["md"]
        L = spec.box_size[2]
        local, nzl = dd_halo_spec(spec, DD_SHARDS)
        xyz = [halo_extend(st.x), halo_extend(st.y), halo_extend(st.z, -L, L)]
        v = [halo_extend(a) for a in (st.vx, st.vy, st.vz)]
        pe = halo_extend(st.pidf)
        m = [(p > 0.5).to(torch.float32) for p in pe]
        for row_name, key, ops, n_io, int_ops in sweeps:
            if row_name == "pair_channel_dpd_halo":
                fn = eng.kern.fn
                chans = [[v[0][i], v[1][i], v[2][i], pe[i] - 1.0,
                          torch.tensor(1.0, device=m[i].device)] for i in range(DD_SHARDS)]
                cut2 = fn.rc2
            elif row_name == "pair_channel_sph_density_halo":
                fn = eng.rho_kern.fn
                chans = [[m[i] * float(eng.mass)] for i in range(DD_SHARDS)]
                cut2 = fn.cut2
            else:  # a uniform P / rho^2 of 0.5: the same work as the path's
                fn = eng.f_kern.fn
                chans = [[m[i] * 0.5, v[0][i], v[1][i], v[2][i], m[i] * float(eng.mass)]
                         for i in range(DD_SHARDS)]
                cut2 = fn.cut2
            kern = pair_kernel.make_pair_channel_kernel(local, fn, periodic_z=False)
            ms = cuda_ms(lambda: [kern(xyz[0][i], xyz[1][i], xyz[2][i], *chans[i])
                                  for i in range(DD_SHARDS)], reps=10)
            plain = cuda_ms(lambda: [pair_kernel.channel_plain(
                local, fn, fn.n_out, xyz[0][i], xyz[1][i], xyz[2][i], chans[i],
                periodic_z=False) for i in range(DD_SHARDS)], reps=1, warmup=1)
            x, y, z = (torch.cat(getattr(st, k)) for k in ("x", "y", "z"))
            pid = torch.cat(st.pidf).to(torch.int32) - 1
            pairs = functor_pairs(spec, x, y, z, pid, cut2)
            row = functor_row(row_name, "uammd_tpu/engine/pair_kernel.py:538 "
                              "(periodic_z=False, :381-385)", r["launches"][row_name],
                              checks[key][2], ms, plain, pairs, ops, n_io, spec,
                              int_ops=int_ops,
                              extra={"rel_err": checks[key][0],
                                     "control_ghost_shift_dropped": checks[key][1],
                                     "shape": list(local.array_shape), "note": note,
                                     "launch_plan": channel_plan_of(local, fn)})
            rows.append(row)
        del xyz, v, pe, m
    return rows


def dd_update_row(run, what: str) -> dict:
    """#11's kernels-line row at a DD2 path's final state: one step's sweep
    of its launches (one a shard) as the step makes them (the straggler
    rows by their float32 pid + 1, their references joining the drift),
    each held to ``gj_update_plain`` (occupied slots and rows within
    ``UNFUSED_TOL`` x max|ref|, the drift too), timed with CUDA events, by
    the profiler (L2 warm, and flushed before each sweep) and on the host
    (a launch), with the plain version's time and the byte bound (a
    shard's 12 grids read and 6 written, its straggler rows and their
    references, the seed and the drift)."""
    from uammd_tpu_torch.engine import update_kernel as uk

    step, st = run["step"], run["st"]
    n = step.n_dev
    args = [((st.x[i], st.y[i], st.z[i], st.wx[i], st.wy[i], st.wz[i], st.fx[i], st.fy[i],
              st.fz[i], st.rx[i], st.ry[i], st.rz[i]), st.stepc[i],
             (st.spos[i], st.svelw[i], st.sforce[i], st.spidf[i]), st.sref[i])
            for i in range(n)]
    n0 = uk.GJ_UPDATE.launches
    err = 0.0
    for g, seed, srows, sref in args:
        got = step.upd(*g, seed, srows, sref)
        want = uk.gj_update_plain(step.local_spec, step.upd.coef, *g, seed, srows, sref)
        m, sm = g[0] < 1.0e8, srows[3] > 0.5
        pairs = ([(x[m], y[m]) for x, y in zip(got[0], want[0])]
                 + [(x[sm], y[sm]) for x, y in zip(got[2], want[2])]
                 + [(got[1].reshape(1), want[1].reshape(1))])
        pairs = [(x, y) for x, y in pairs if y.numel()]
        rel = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                  for x, y in pairs)
        check(rel < UNFUSED_TOL, f"{what}: #11 vs plain {rel:.3g} < {UNFUSED_TOL}")
        err = max(err, max(float((x - y).abs().max()) for x, y in pairs))

    def sweep():
        return [step.upd(*g, seed, srows, sref) for g, seed, srows, sref in args]

    times = update_times(sweep, ["gj_update_rows"], launches_a_call=n)
    uk.GJ_UPDATE.launches = n0
    plain = cuda_ms(lambda: [uk.gj_update_plain(step.local_spec, step.upd.coef, *g, seed, srows,
                                                sref) for g, seed, srows, sref in args],
                    reps=2, warmup=1)
    bytes_ = n * (4 * 18 * step.local_spec.n_slots + 76 * step.S + 8)
    return {"name": "gj_update_dd2" + ("" if n > 1 else "_1_shard"), "route": "cuda",
            "source": "uammd_tpu_torch/engine/csrc/gj_update.cu (+ gj_common.cuh)",
            "replaces": "uammd_tpu/engine/update_kernel.py:134",
            "launches": run["launches"]["gj_update"], "max_abs_err": err, **times,
            "plain_ms": plain, "bound_ms": 1e3 * bytes_ / PEAK_HBM_BYTES, "bound_by": "bytes",
            "library_ms": None, "shards": n, "shard_spec": list(step.local_spec.array_shape),
            "launch_plan": update_grid(step.local_spec, step.S, "gj_update"),
            "note": f"ms, device and plain_ms and bound_ms cover one step's {n} launch(es) "
                    f"(one per shard), host_us_a_call one launch, at {what}"}


def newton_halo_1_shard_row(run, what: str) -> dict:
    """#6 ``halo_z``'s kernels-line row on the 1-shard DD2 path: its launch
    at the path's final state against the plain version (largest abs
    error over its outputs), CUDA events, the plain time and the bound
    (the larger of the bytes and the stencil's operations)."""
    import torch
    from uammd_tpu_torch.engine import kernel2, layout
    from uammd_tpu_torch.parallel.domain2 import gather_md2_state

    step, st, spec = run["step"], run["st"], run["spec"]
    ghost = step.ghost_rows(st.x, st.y, st.z)[0]
    got = dd2_newton(step, st, 0, ghost)
    want = dd2_newton(step, st, 0, ghost, plain=True)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    args = (st.x[0], st.y[0], st.z[0]) + ghost + (dd2_strag_block(step, st, 0),)
    n0 = kernel2.NEWTON_PAIR_HALO.launches
    ms = cuda_ms(lambda: step.kern(*args), reps=10)
    kernel2.NEWTON_PAIR_HALO.launches = n0
    plain = cuda_ms(lambda: kernel2.newton_pair_plain(
        step.local_spec, step.kern.g_fn, *args[:3], args[6], ghost=args[3:6]), reps=2, warmup=1)
    gs = layout.pack(spec, gather_md2_state(st, spec, N)[0], device=st.x[0].device)
    pairs, cut = stencil_pairs(gs)
    del gs
    torch.cuda.empty_cache()
    ops_ms = 1e3 * (OPS_PAIR_TEST * pairs + OPS_PAIR_FORCE * cut) / PEAK_FP32_FLOPS
    ghost_bytes = 3 * 4 * spec.n_slots // spec.shape[2]
    bytes_ms = 1e3 * (18 * 4 * spec.n_slots + ghost_bytes + 28 * step.S) / PEAK_HBM_BYTES
    return {"name": "newton_pair_halo_1_shard", "route": "cuda",
            "source": "uammd_tpu_torch/engine/csrc/newton_pair.cu",
            "replaces": "uammd_tpu/engine/kernel2.py:447 (halo_z, :74-134)",
            "launches": run["launches"]["newton_pair_halo"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes", "library_ms": None,
            "stencil_pairs": pairs, "stencil_pairs_in_cutoff": cut,
            "shard_spec": list(step.local_spec.array_shape), "note": f"one launch at {what}"}


def dd_phases(dev, card, melted, unfused_ms):
    """Slice G1's phases in order; returns the kernels-line rows."""
    import torch

    checks = dd_kernel_checks(dev, melted)
    dd_force_parity(dev, melted)
    dd4 = main_path_dd2(dev, card, melted, DD_SHARDS)
    dd1 = main_path_dd2(dev, card, melted, 1)
    held = dd1["step"].sep  # #5's last inputs on the 1-shard path
    rows_1 = [fold_halo_row(dd1, dd1["launches"]["fold_halo"],
                            "the 1-shard DD2 path's final state"),
              dd_update_row(dd1, "the 1-shard DD2 path's final state"),
              newton_halo_1_shard_row(dd1, "the 1-shard DD2 path's final state"),
              sep_row("_dd2_1_shard", held.spec, held.ocap, *held.last,
                      dd1["launches"]["separable_rebin"],
                      "the 1-shard DD2 path's last rebin")]
    del dd1["st"], dd1["step"], held
    torch.cuda.empty_cache()
    errs = {"newton_halo_abs": None, "fold_halo_abs": max(checks["fold_halo_clump"],
                                                          checks["fold_halo_2^20"])}
    # the Newton halo kernel's largest abs error on the path's final state
    step, st = dd4["step"], dd4["st"]
    ghosts = step.ghost_rows(st.x, st.y, st.z)
    errs["newton_halo_abs"] = max(
        max(float((a - b).abs().max()) for a, b in zip(
            dd2_newton(step, st, i, ghosts[i]), dd2_newton(step, st, i, ghosts[i], plain=True)))
        for i in range(step.n_dev))
    from uammd_tpu_torch.engine import layout

    spec1 = layout.choose_spec(BOX, N, 2.5, pos=melted, nz_multiple=DD_SHARDS)
    for what, spec in (("DD2 shard (#6 halo_z)", step.local_spec),
                       ("DD v1 slab (#1 halo)", dd_halo_spec(spec1, DD_SHARDS)[0])):
        print(json.dumps({"phase": "launch_plans", "what": what, **plan_of(spec)}), flush=True)
    rows = (breakdown_dd2(card, dd4, dd1, unfused_ms, errs)
            + [dd_update_row(dd4, "the 4-shard DD2 path's final state")] + rows_1)
    del dd4, step, st, ghosts
    torch.cuda.empty_cache()
    runs = main_path_dd_channels(dev, card, melted)
    rows += dd_channel_rows(card, runs, checks)
    del runs
    torch.cuda.empty_cache()
    dd2_trajectory_parity(dev, melted)
    return rows


# The cell-warp kernels #1 and #6 on ragged occupancy. One state per
# grid, NLANE 114 (fold 6), 48 and 16 (fold 4), with cells of 3.0 (above
# the 2.5 cutoff) and CAP 40: occupancies drawn from 0 to CAP, one cell
# full to CAP (a second pass of its warp), every cell of one (z, yb)
# column empty, the occupied rows scattered over the cell (not a prefix),
# on a jittered 4^3 sub-lattice of each cell (spacing 0.75, jitter 0.05:
# no pair closer than 0.65), with 15 valid straggler rows and an invalid
# one on free sites. #1's state has one particle with x = NaN.
RAGGED_GRIDS = (((19, 18, 8), 6), ((12, 24, 16), 4), ((4, 8, 5), 4))
RAGGED_CELL, RAGGED_CAP, RAGGED_STRAG = 3.0, 40, 16


def ragged_state(dev, shape, fold, seed, nan=False, extra_rows=0, cap=RAGGED_CAP, k=4,
                 occ_lo=0):
    """The seeded ragged state on ``shape`` (nx, ny, nz) cells, with
    ``extra_rows`` more z rows above (a halo mode's ghost row), CAP ``cap``,
    occupancies drawn from ``occ_lo`` to CAP on a k^3 sub-lattice of each cell:
    a namespace of spec, x, y, z, mask, spos, spid, as a ``GridState`` has
    them."""
    import types

    import numpy as np
    import torch
    from uammd_tpu_torch.engine import layout

    nx, ny, nz = shape
    nzt = nz + extra_rows
    box = (nx * RAGGED_CELL, ny * RAGGED_CELL, nzt * RAGGED_CELL)
    spec = layout.GridSpec(box_size=box, shape=(nx, ny, nzt), cap=cap, fold=fold,
                           cutoff=2.5, skin=1.2, n_strag=RAGGED_STRAG)
    rng = np.random.default_rng(seed)
    sub = (np.stack(np.meshgrid(*[np.arange(k)] * 3, indexing="ij"), -1).reshape(-1, 3) + 0.5)
    sub = sub * (RAGGED_CELL / k)
    arr = np.full((3,) + spec.array_shape, layout.EMPTY_POS, np.float32)
    lo = -0.5 * np.array(box)
    empty_col = (nz // 2, 0)  # (z, yb)
    free = []
    for cz in range(nzt):
        for cy in range(ny):
            yb, f = divmod(cy, fold)
            for cx in range(nx):
                n = int(rng.integers(occ_lo, cap + 1))
                if (cz, yb) == empty_col:
                    n = 0
                if (cx, cy, cz) == (1, 1, 1):
                    n = cap
                sites = rng.permutation(len(sub))
                rows = rng.choice(cap, n, replace=False)
                corner = lo + RAGGED_CELL * np.array([cx, cy, cz])
                p = corner + sub[sites[:n]] + rng.uniform(-0.05, 0.05, (n, 3)) * (4 / k)
                arr[:, cz, yb, rows, cx * fold + f] = p.T
                if n < len(sub) and cz < nz:
                    free.append(corner + sub[sites[n]])
    if nan:  # x of an occupied slot of the cell full to CAP
        arr[0, 1, 1 // fold, 7, 1 * fold + 1 % fold] = np.nan
    pick = rng.choice(len(free), RAGGED_STRAG, replace=False)
    spos = torch.tensor(np.array(free)[pick], dtype=torch.float32, device=dev)
    spid = torch.arange(RAGGED_STRAG, device=dev)
    spid[-1] = -1
    x, y, z = (torch.tensor(a, device=dev) for a in arr)
    return types.SimpleNamespace(spec=spec, x=x, y=y, z=z, mask=x < 1e8, spos=spos, spid=spid)


def plan_of(spec) -> dict:
    """Both cell-warp kernels' launch plans for ``spec``, each with the
    kernel's own count of its shared memory, which must equal the plan's."""
    import ctypes
    from uammd_tpu_torch.engine import _build, kernel2, pair_kernel

    out = {"spec": list(spec.array_shape), "n_strag": spec.n_strag}
    for name, plan, args in (
            ("pair_force", pair_kernel.pair_launch_plan(spec), ()),
            ("newton_pair", kernel2.newton_launch_plan(spec), (spec.n_strag,))):
        fn = getattr(_build.load(name), f"uammd_{name}_smem")
        fn.restype = ctypes.c_longlong
        smem = fn(spec.cap, plan.cc, plan.fc, *args)
        check(smem == plan.smem, f"{name} at {spec.array_shape}: the kernel's shared memory "
                                 f"{smem} == the plan's {plan.smem}")
        out[name] = plan.as_dict()
    return out


def check_ragged_pair(st, what) -> dict:
    """#1 force-only, halo and observable modes against their plain versions
    on a ragged state: every output within its tolerance (1e-5 of max|f|
    for the forces, CHANNEL_TOL of each output's max for the observables)
    over the slots where the plain version is finite, and the NaN slots of
    every output exactly the plain version's. The control (each candidate
    loop one row short) must fail the force bound."""
    import torch
    from uammd_tpu_torch.engine import md, pair_kernel

    spec, g, e = st.spec, md.lj_g(), md.lj_e()
    out = {}

    def compare(got, want, tol, name):
        nan_ok = all(torch.equal(a.isnan(), b.isnan()) for a, b in zip(got, want))
        fin = [b.isfinite() for b in want]
        if tol == 1e-5:  # the forces: one scale, the largest force
            scale = max(float(b[m].abs().max()) for b, m in zip(want, fin))
            err = max(float((a[m] - b[m]).abs().max()) for a, b, m in zip(got, want, fin)) / scale
        else:
            err = max(float((a[m] - b[m]).abs().max() / b[m].abs().max().clamp(min=1e-30))
                      for a, b, m in zip(got, want, fin))
        n_nan = sum(int(b.isnan().sum()) for b in want)
        check(nan_ok, f"{what}: #1 {name} puts NaN in exactly the plain version's slots "
                      f"({n_nan} of them)")
        check(err < tol, f"{what}: #1 {name} vs plain {err:.3g} < {tol}")
        out[name] = {"rel_err": err, "nan_slots": n_nan}

    for name, kw in (("force", {}), ("halo", {"periodic_z": False})):
        kern = pair_kernel.make_pair_force_kernel(spec, g, **kw)
        compare(kern(st.x, st.y, st.z),
                pair_kernel.pair_force_plain(spec, g, st.x, st.y, st.z, **kw), 1e-5, name)
    obs_kw = dict(compute_virial=True, compute_stress=True)
    kern = pair_kernel.make_pair_force_kernel(spec, g, e, **obs_kw)
    compare(kern(st.x, st.y, st.z),
            pair_kernel.pair_force_plain(spec, g, st.x, st.y, st.z, e_fn=e, **obs_kw),
            CHANNEL_TOL, "observables")
    kern = pair_kernel.make_pair_force_kernel(spec, g)
    kern.occ_trim = 1
    want = pair_kernel.pair_force_plain(spec, g, st.x, st.y, st.z)
    m = want[0].isfinite() & st.mask
    ctrl = rel_force_err(want, kern(st.x, st.y, st.z), m)
    check(ctrl > 1e-5, f"{what}: #1 control (candidate loops one row short) fails the "
                       f"bound ({ctrl:.3g} > 1e-5)")
    out["control_one_row_short"] = ctrl
    return out


def check_ragged_newton(st, ghost_st, what) -> dict:
    """#6 on a ragged state: periodic in the four self_half x cellcenter
    modes, exact (1e-5, SLOT_TOL) and approximate (FAST_RECIP_*) reciprocal,
    and ``halo_z`` (both self_half modes) with the top row of ``ghost_st``
    as its ghost row, against their plain versions (``check_newton``'s
    bounds); the control (each candidate loop one row short) must fail
    them."""
    import torch
    from uammd_tpu_torch.engine import kernel2, md

    modes = ((False, False), (False, True), (True, False), (True, True))
    out = {"exact": check_newton(st, what, modes=modes),
           "approx": check_newton(st, what, modes=modes, approx=True, tol=FAST_RECIP_TOL,
                                  slot_tol=FAST_RECIP_SLOT_TOL)}
    ref = newton_outputs(st, newton_pair(st, plain=True), plain_fold=True)
    fa = torch.cat([a[st.mask].abs() for a in ref[15:18]])
    scale = (float(fa.max()), float(fa.median()))
    err = newton_errs(ref, newton_outputs(st, newton_pair(st, occ_trim=1)), scale)
    check(err["rel"] > 1e-5 and err["slot"] > SLOT_TOL,
          f"{what}: #6 control (candidate loops one row short) fails both bounds "
          f"({err['rel']:.3g} > 1e-5, {err['slot']:.3g} > {SLOT_TOL})")
    out["control_one_row_short"] = err
    # halo_z: the slab is ghost_st's rows below its top one, the ghost row its top
    nz = st.spec.shape[2]
    spec = st.spec
    slab = [a[:nz].contiguous() for a in (ghost_st.x, ghost_st.y, ghost_st.z)]
    ghost = [a[nz:].contiguous() for a in (ghost_st.x, ghost_st.y, ghost_st.z)]
    g = md.lj_g_fused(rc2=RC2)
    strag = kernel2.broadcast_stragglers(spec, ghost_st.spos, ghost_st.spid)
    home, groups, sf = kernel2.newton_pair_plain(spec, g, *slab, strag, ghost=ghost)
    want = list(home) + [c for gr in groups for c in gr] + [sf]
    zeros = [torch.zeros_like(ghost[0]) for _ in range(9)]
    folded = kernel2.fold_reactions_halo_plain(home, groups, zeros)
    m = slab[0] < 1e8
    fa = torch.cat([a[m].abs() for a in folded])
    scale = (float(fa.max()), float(fa[fa > 0].median()))
    for self_half in (True, False):
        kern = kernel2.make_newton_pair_kernel(spec, g, halo_z=True, self_half=self_half)
        h, gr, s = kern(*slab, *ghost, strag)
        e = newton_errs(want, list(h) + [c for grp in gr for c in grp] + [s], scale)
        check(e["rel"] < 1e-5 and e["slot"] < SLOT_TOL,
              f"{what}: #6 halo_z (self_half={self_half}) vs plain {e['rel']:.3g} < 1e-5, "
              f"per slot {e['slot']:.3g} < {SLOT_TOL}")
        out[f"halo_self_half_{self_half}"] = e
    return out


def channel_plan_of(spec, fn, nvec=1) -> dict:
    """#2's launch plan for ``spec`` and the functor ``fn``, with the
    kernel's own count of its shared memory and threads, which must equal
    the plan's."""
    import ctypes
    from uammd_tpu_torch.engine import _build, pair_kernel

    plan = pair_kernel.channel_launch_plan(spec, fn, nvec)
    ng = pair_kernel.channel_grid_channels(fn, nvec)
    S = spec.n_strag if not isinstance(fn, pair_kernel.ChannelFunctor) or fn.strag else 0
    lib = _build.load("pair_channel")
    lib.uammd_pair_channel_smem.restype = ctypes.c_longlong
    smem = lib.uammd_pair_channel_smem(spec.cap, plan.cc, plan.fc, ng, S)
    threads = lib.uammd_pair_channel_threads(spec.cap, plan.cc, plan.fc)
    name = type(fn).__name__ + (f" nvec {nvec}" if nvec > 1 else "")
    check(smem == plan.smem and threads == plan.threads,
          f"pair_channel ({name}) at {spec.array_shape}: the kernel's shared memory {smem} == "
          f"the plan's {plan.smem}, threads {threads} == {plan.threads}")
    return {"functor": name, "spec": list(spec.array_shape), "n_strag": S, **plan.as_dict()}


# #2 on ragged occupancy: every functor on three seeded states with cells
# of 3.0 and each functor's cutoff at 2.9 (the mixtures': 2.5 sigma_ij,
# at most 2.75): RAGGED_GRIDS[0] (NLANE 114, CAP 40, occupancies 0-40), a
# small-cell state (NLANE 48, CAP 16, occupancies 0-16 on a 3^3 sub-lattice:
# mean <= 8) and a large-cell one (NLANE 16, CAP 160, occupancies 70-160
# on a 6^3 sub-lattice: mean >= 100), each with an empty (z, yb) column and
# a cell full to CAP; Poisson and PSE with the 16 straggler rows.
RAGGED_CH_CUT = 2.9
RAGGED_CH_STATES = (("cap40", RAGGED_GRIDS[0][0], RAGGED_GRIDS[0][1], {}),
                    ("cap16", (12, 24, 16), 4, {"cap": 16, "k": 3}),
                    ("cap160", (4, 8, 5), 4, {"cap": 160, "k": 6, "occ_lo": 70}))


def ragged_channel_cases(st, seed):
    """(name, functor, nvec, channels, straggler channels or None, scale
    by sum_j |term|) for each functor of #2 on the ragged state ``st``:
    seeded channels, 0 on empty slots (pid -1)."""
    import math as m

    import numpy as np
    import torch
    from uammd_tpu_torch.electrostatics.poisson import GaussianNearField
    from uammd_tpu_torch.engine.dpd import DPDPair
    from uammd_tpu_torch.engine.mixtures import LJMixturePair, LJMixturePairMasked
    from uammd_tpu_torch.engine.pse_near import PSENear
    from uammd_tpu_torch.engine.sph import SPHDensityPair, SPHForcePair
    from uammd_tpu_torch.interactors.sph import SPHParams

    dev = st.x.device
    occ = ~(st.x >= 5e8)
    rng = np.random.default_rng(seed)
    S = st.spec.n_strag

    def grid(lo, hi):
        v = torch.tensor(rng.uniform(lo, hi, tuple(st.x.shape)), dtype=torch.float32, device=dev)
        return torch.where(occ, v, torch.zeros_like(v))

    def rows(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, S), dtype=torch.float32, device=dev)

    pid = torch.where(occ, torch.cumsum(occ.reshape(-1).long(), 0).reshape(occ.shape) - 1,
                      torch.full_like(st.x, -1, dtype=torch.long)).to(torch.float32)
    step = torch.tensor(7.0, dtype=torch.float32, device=dev)
    vel = [grid(-1.0, 1.0) for _ in range(3)]
    mass = occ.to(torch.float32)
    hs = grid(0.3, 0.55)
    se = grid(0.7, 1.0)
    small = torch.where(occ & (hs < 0.42), 1.0, 0.0).to(torch.float32)
    h = RAGGED_CH_CUT / 2
    gw, ngw = 0.25, 0.478
    near = GaussianNearField.create((30.0,) * 3, 1000, gw=gw, ngw=ngw, rcut=RAGGED_CH_CUT)
    qb = 0.4
    pse = PSENear(coef=([0.8, -0.3, 0.05, 0.01], [0.2, -0.1, 0.02],
                        [0.1, 0.05, -0.02, 0.004], [0.03, -0.01, 0.002]),
                  uscale=((2.0 / qb, -1.0), (2.0 / (1.0 - qb), -(1.0 + qb) / (1.0 - qb))),
                  qb=qb, rcut=RAGGED_CH_CUT)
    charge = torch.where(occ, torch.where(grid(0, 1) < 0.5, -1.0, 1.0), 0.0).to(torch.float32)
    force = [grid(-1.0, 1.0) for _ in range(6)]
    return [
        ("dpd", DPDPair(RAGGED_CH_CUT, 25.0, 4.5, m.sqrt(2 * 4.5 / 0.01)), 1,
         [*vel, pid, step], None, False),
        ("sph_density", SPHDensityPair(h), 1, [mass], None, False),
        ("sph_force", SPHForcePair(SPHParams(support=h, viscosity=20.0)), 1,
         [grid(0.5, 2.0), *vel, mass], None, True),
        ("lj_mix", LJMixturePair(2.5), 1, [se, hs], None, False),
        ("lj_mix_masked", LJMixturePairMasked(2.5), 1, [se, hs, small], None, False),
        ("poisson", near.pair_fn(), 1, [charge], [torch.where(rows(0, 1) < 0.5, -1.0, 1.0)],
         False),
        ("pse_nvec1", pse, 1, force[:3], [rows(-1, 1) for _ in range(3)], False),
        ("pse_nvec2", pse, 2, force, [rows(-1, 1) for _ in range(6)], False),
    ]


def check_ragged_channel(st, case, what, periodic_z=True, control=False) -> dict:
    """#2 with one functor on a ragged state against its plain version:
    the NaN slots of every output (grids and straggler totals) exactly the
    plain version's, the rest within CHANNEL_TOL of max|ref| (or of the
    largest sum_j |term| where the case says so). With ``control`` each
    candidate loop stops one row short and the bound must fail."""
    import dataclasses

    import torch
    from uammd_tpu_torch.engine import pair_kernel

    name, fn, nvec, chans, srows, by_terms = case
    pse = not isinstance(fn, pair_kernel.ChannelFunctor)
    spec = st.spec if srows is not None else dataclasses.replace(st.spec, n_strag=0)
    kern = pair_kernel.make_pair_channel_kernel(spec, fn, nvec, periodic_z=periodic_z)
    kern.occ_trim = int(control)
    blk = rows = None
    if srows is not None:
        blk = pair_kernel.broadcast_strag_channels(spec, st.spos, tuple(srows), st.spid)
        rows = blk[:, :, 0]
    got = list(kern(st.x, st.y, st.z, *chans, strag=blk))
    if pse:
        g, sp = pair_kernel.pair_channel_plain(spec, fn, nvec, st.x, st.y, st.z, chans, blk)
        want = list(g) + (list(sp) if sp is not None else [])
    elif rows is not None:
        want = list(pair_kernel.functor_plain(spec, fn, st.x, st.y, st.z, chans, rows))
    else:
        want = list(pair_kernel.channel_plain(spec, fn, fn.n_out, st.x, st.y, st.z, chans,
                                              periodic_z))
    n_nan = sum(int(b.isnan().sum()) for b in want)
    nan_ok = all(torch.equal(a.isnan(), b.isnan()) for a, b in zip(got, want))
    fin = [b.isfinite() for b in want]
    scale = max(float(b[f].abs().max()) if bool(f.any()) else 0.0 for b, f in zip(want, fin))
    if by_terms:
        absum = pair_kernel.channel_plain(spec, lambda *a: tuple(t.abs() for t in fn(*a)),
                                          fn.n_out, st.x, st.y, st.z, chans, periodic_z)
        scale = max(float(a[a.isfinite()].max()) for a in absum)
    err = max(float((a[f] - b[f]).abs().max()) if bool(f.any()) else 0.0
              for a, b, f in zip(got, want, fin)) / scale
    mode = "halo" if not periodic_z else "periodic"
    if control:
        check(err > CHANNEL_TOL, f"{what}: #2 {name} {mode} control (candidate loops one row "
                                 f"short) fails the bound ({err:.3g} > {CHANNEL_TOL})")
        return {"control_one_row_short": err}
    check(nan_ok, f"{what}: #2 {name} {mode} puts NaN in exactly the plain version's slots "
                  f"and sums ({n_nan})")
    check(err < CHANNEL_TOL, f"{what}: #2 {name} {mode} vs plain {err:.3g} < {CHANNEL_TOL}")
    return {"rel_err": err, "nan_slots": n_nan}


def ragged_channel_checks(dev) -> dict:
    """#2's ragged-occupancy checks: each functor on each state of
    RAGGED_CH_STATES, clean and with one x = NaN, periodic and (the
    straggler-free functors) in the halo mode on the state with a ghost
    row above, with the control on the clean periodic state; the launch
    plans printed first."""
    import dataclasses

    import torch

    out = {}
    for k, (label, shape, fold, kw) in enumerate(RAGGED_CH_STATES):
        states = {(nan, extra): ragged_state(dev, shape, fold, seed=80 + k, nan=nan,
                                             extra_rows=extra, **kw)
                  for nan in (False, True) for extra in (0, 1)}
        st = states[(False, 0)]
        occ = (st.x < 5e8).sum(dim=2)
        what = f"ragged #2 {label}"
        entry = {"spec": list(st.spec.array_shape),
                 "occupancy_min_mean_max": [int(occ.min()), float(occ.float().mean()),
                                            int(occ.max())], "plans": [], "checks": {}}
        for (nan, extra), s in states.items():
            cases = ragged_channel_cases(s, seed=70 + k)
            for case in cases:
                name, fn, nvec, _, srows, _ = case
                if extra and srows is not None:
                    continue  # the halo mode serves the straggler-free functors
                res = entry["checks"].setdefault(name, {})
                if not nan and not extra:
                    sp = s.spec if srows is not None else dataclasses.replace(s.spec, n_strag=0)
                    entry["plans"].append(channel_plan_of(sp, fn, nvec))
                    res.update(check_ragged_channel(s, case, what, control=True))
                key = ("nan_" if nan else "") + ("halo" if extra else "periodic")
                res[key] = check_ragged_channel(s, case, what, periodic_z=not extra)
        print(json.dumps({"phase": "launch_plans", "what": what, "pair_channel": entry["plans"]}),
              flush=True)
        out[label] = entry
        del states
    torch.cuda.empty_cache()
    return out


def ragged_checks(dev) -> dict:
    """The ragged-occupancy checks of #1 and #6 on the three grids, with
    their launch plans printed first, then #2's (``ragged_channel_checks``)."""
    import torch

    out = {}
    for k, (shape, fold) in enumerate(RAGGED_GRIDS):
        st = ragged_state(dev, shape, fold, seed=90 + k, nan=True)
        clean = ragged_state(dev, shape, fold, seed=90 + k)
        tall = ragged_state(dev, shape, fold, seed=90 + k, extra_rows=1)
        what = f"ragged NLANE {st.spec.nlane}"
        print(json.dumps({"phase": "launch_plans", "what": what, **plan_of(st.spec)}),
              flush=True)
        occ = (st.x < 5e8).sum(dim=2)
        entry = {"spec": list(st.spec.array_shape),
                 "occupancy_min_mean_max": [int(occ.min()), float(occ.float().mean()),
                                            int(occ.max())],
                 "pair_force": check_ragged_pair(st, what),
                 "newton_pair": check_ragged_newton(clean, tall, what)}
        out[f"nlane_{st.spec.nlane}"] = entry
        del st, clean, tall
    torch.cuda.empty_cache()
    out["pair_channel"] = ragged_channel_checks(dev)
    print(json.dumps({"phase": "ragged_kernel_checks", "ok": True, **out,
                      "slot_tol": SLOT_TOL, "fast_recip_tol": FAST_RECIP_TOL,
                      "fast_recip_slot_tol": FAST_RECIP_SLOT_TOL,
                      "channel_tol": CHANNEL_TOL}), flush=True)
    return out


# ------------------------------------------------ slice G2a: the composed multi-shard PSE steps
# bench.py:104-160's PSE suspension (PSE_N, PSE_L, fcc start, far grid 144,
# tolerance 1e-4) on a z-slab mesh of this one card: the near grid's nz
# floored to a multiple of G2_SHARDS, Lanczos m = 4 (the PSE path's tuned
# count), the WCA lj_g_fused(1, 2, rc2 = (2^(1/6) 2)^2) with the exact
# reciprocal (pse_dd2's straggler pairs evaluate it in plain torch), dt 0.01,
# T 1. pse_dd2 keeps G2_STRAG straggler rows a shard (the single-grid PSE
# path's 192: the fcc start fills no cell past CAP, and 60 steps move a
# particle ~0.3, under the cell slack), pse_dd none (CAP from the largest
# occupancy).
G2_SHARDS = 4
G2_M = 4
G2_STRAG = 192
G2_WARM, G2_TIMED = 20, 40
# each DD step against the single-grid PSE step at T = 0: forces within
# 1e-4 max(fscale, 1), positions within 2e-4 max(dscale, 1)
# (tests/test_pse_dd.py:80-88)
G2_F_TOL, G2_P_TOL = 1e-4, 2e-4
# pse_dd2's trajectory within 1e-4 after 3 + 3 steps through a forced
# rebin (tests/test_pse_dd2.py:113-115)
G2_TRAJ_TOL, G2_TRAJ_STEPS = 1e-4, 3
# __graft_entry__.py strategy 8's clump system: n 2048, 18 particles 1.5
# apart in the near grid's centre cell (real straggler rows at CAP 8)
G2C_N, G2C_FAR, G2C_TOL, G2C_STRAG, G2C_DT = 2048, 120, 1e-2, 64, 1e-4
G2_BAND = (0.2, 8.0)  # rms displacement / sqrt(2 kT m0 dt steps), test_pse_dd.py:158-164
PAIR_FUSED_TOL = 1e-5  # #1 with the fused radial against plain, x max|f|
G2_FAR_M2_CONTROL = 8  # a bucket far below its load: ovf must latch
G2_BREAKDOWN_STEPS = 5
# fcc nearest-neighbour pairs of the full path's start pulled to 1.5 apart
# (inside the WCA cutoff 2.245), so the WCA modes meet pairs on its slabs
G2_CONTACTS, G2_CONTACT_GAP, G2_CONTACT_SEED = 256, 1.5, 41
# float32 operations per pair inside the WCA cutoff, each pair once and both
# directions: the select, clamp, 1/r2, t2 t3 t4, c1 t3 + c2 times t4 (9),
# g * d (3) and the sums into both particles (6)
OPS_PAIR_FUSED = 18


def g2_wca():
    from uammd_tpu_torch.engine.md import lj_g_fused

    rc = 2.0 ** (1.0 / 6.0) * 2.0
    return lj_g_fused(1.0, 2.0, rc2=rc * rc, approx=False)


def g2_backend(b, n, pos, *, n_strag, far_grid=PSE_FAR_GRID, tolerance=PSE_TOLERANCE):
    from uammd_tpu_torch.integrators.bdhi.pse_engine import PSEGrid

    return PSEGrid.create(b, n, viscosity=1.0, radius=1.0, far_grid=far_grid,
                          tolerance=tolerance, lanczos_iterations=G2_M, pos=pos,
                          n_strag=n_strag, nz_multiple=G2_SHARDS)


def g2_clump(dev):
    """__graft_entry__.py strategy 8's system: (box, positions [numpy], the
    pse_dd2 backend with G2C_STRAG rows)."""
    import numpy as np
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.utils.lattices import lattice

    n = G2C_N
    L = (n * (4.0 / 3.0) * math.pi / 0.05) ** (1.0 / 3.0)
    b = box(L, device=dev)
    sites = np.asarray(lattice(n, L, "fcc"))
    probe = g2_backend(b, n, sites.astype(np.float32), n_strag=G2C_STRAG, far_grid=G2C_FAR,
                       tolerance=G2C_TOL)
    sh = np.asarray(probe.spec.shape)
    center = (sh // 2 + 0.5) / sh * L - 0.5 * L
    gx, gy, gz = np.meshgrid(*[np.arange(3) * 1.5] * 2, np.arange(2) * 1.5)
    clump = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)
    clump = clump - clump.mean(axis=0) + center
    lo, hi = clump.min(axis=0) - 2.4, clump.max(axis=0) + 2.4
    sites = sites[~np.all((sites > lo) & (sites < hi), axis=1)][: n - len(clump)]
    pos = np.concatenate([sites, clump]).astype(np.float32)
    pos = pos - np.float32(L) * np.round(pos / np.float32(L))
    be = g2_backend(b, n, pos, n_strag=G2C_STRAG, far_grid=G2C_FAR, tolerance=G2C_TOL)
    return b, pos, be


def g2_dimers(dev):
    """tests/test_pse_dd.py:24-36's dimer system at PSE_N: PSE_N / 2 fcc
    sites of the PSE box, each with a partner 1.5 along x (inside the WCA
    cutoff, so the T = 0 step moves them). (box, positions [numpy])."""
    import numpy as np
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.utils.lattices import lattice

    sites = np.asarray(lattice(PSE_N // 2, PSE_L, "fcc"))
    pos = np.concatenate([sites, sites + np.array([1.5, 0.0, 0.0])])
    pos = pos - PSE_L * np.round(pos / PSE_L)
    return box(PSE_L, device=dev), pos.astype(np.float32)


def g2_steps(dev, be, n, temperature, dt, n_shards=G2_SHARDS, **kw):
    """(pse_dd2 step, pse_dd step) on an n_shards mesh of the card (either
    None when ``be``'s straggler list does not fit it)."""
    from uammd_tpu_torch.parallel import pse_dd, pse_dd2

    mesh = dd_mesh(dev, n_shards)
    if be.spec.n_strag:
        return pse_dd2.make_sharded_pse_em_step2(mesh, be, g_pair=g2_wca(), dt=dt,
                                                 temperature=temperature, n=n, **kw)
    return pse_dd.make_sharded_pse_em_step(mesh, be, g_pair=g2_wca(), dt=dt,
                                           temperature=temperature, n=n, **kw)


def g2_inputs(step2, st, seed):
    """Every shard's kernel inputs for pse_dd2's modes: the ghost-extended
    slabs, the combined straggler lists, seeded slot channels (masked, with
    their ghost rows) and the combined straggler channel rows."""
    import torch
    from uammd_tpu_torch.parallel.domain import halo_extend

    dev = st.x[0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    masks = [(p > 0.5).to(torch.float32) for p in st.pidf]
    sm = [s > 0.5 for s in st.spidf]
    Lz = step2.Ls[2]
    ext = [halo_extend(st.x), halo_extend(st.y), halo_extend(st.z, -Lz, Lz)]
    comb = step2.combined_strag(st.spos, st.spidf)
    g3 = [torch.randn((3,) + tuple(m.shape), generator=gen, device=dev) * m for m in masks]
    sg3 = [torch.randn((3, step2.S), generator=gen, device=dev) * s for s in sm]
    return {"ext": ext, "comb": comb, "hg": halo_extend(g3, dim=1), "cr": step2.comb_rows(sg3),
            "pidf": halo_extend(st.pidf)}


def g2_nan_slab(ext, i):
    """A copy of shard i's slab with x = NaN at its first occupied interior
    slot."""
    import torch

    x = ext[0][i].clone()
    idx = (x[1:-1] < 1e8).nonzero()[0]
    x[1 + int(idx[0]), int(idx[1]), int(idx[2]), int(idx[3])] = float("nan")
    return [x, ext[1][i], ext[2][i]]


def g2_mode_outputs(step2, mode, inp, i, plain=False, xyz=None, drop_strag=False,
                    periodic=False):
    """Shard i's outputs of one of pse_dd2's #2 modes ("pse": the PSE
    matvec over the combined rows; "radial": the WCA force) as a list (3
    grids, 3 straggler totals): the kernel, its plain version (``plain``),
    or a control (``drop_strag``: every row marked invalid; ``periodic``:
    the periodic entry, which sums the ghost rows' reverse terms too)."""
    import torch
    from uammd_tpu_torch.engine import pair_kernel

    xyz = xyz or [a[i] for a in inp["ext"]]
    comb = inp["comb"][i]
    if drop_strag:
        comb = torch.cat([comb[:, :3], torch.zeros_like(comb[:, 3:])], dim=1)
    local = step2.local_spec
    if mode == "pse":
        ch = [inp["hg"][i][c] for c in range(3)]
        blk = step2.bblock(comb, tuple(inp["cr"][i]))
        fn, kern = step2.near_fn, step2.nkern
    else:
        ch, blk = [], step2.bblock(comb)
        fn, kern = step2.force_fn, step2.fkern
    if plain:
        if mode == "pse":
            g, sp = pair_kernel.pair_channel_plain(local, fn, 1, *xyz, ch, blk, periodic_z=False)
            return list(g) + list(sp)
        return list(pair_kernel.functor_plain(local, fn, *xyz, ch, blk[:, :, 0],
                                              periodic_z=False))
    if periodic:
        kern = pair_kernel.make_pair_channel_kernel(local, fn, 1, periodic_z=True)
    return list(kern(*xyz, *ch, strag=blk))


def g2_scale(refs) -> float:
    """max|ref grid| over the finite entries of several outputs' lists."""
    import torch

    return max(float(torch.nan_to_num(a, nan=0.0).abs().max()) for ref in refs for a in ref[:3])


def g2_compare(ref, test, scale=None):
    """(max|d| over the finite entries / ``scale`` (default max|ref grid|),
    NaN in the same entries of every output, max|d|)."""
    import torch

    scale = g2_scale([ref]) if scale is None else scale
    same_nan = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(ref, test))
    err = max(float(torch.nan_to_num(a - b, nan=0.0).abs().max()) for a, b in zip(ref, test))
    return err / max(scale, 1e-30), same_nan, err


def g2_contacts(specs, pos):
    """The fcc start ``pos`` with G2_CONTACTS disjoint nearest-neighbour
    pairs pulled to G2_CONTACT_GAP apart about their midpoints. A pair is
    pulled only where both ends stay in their cells of every spec in
    ``specs``, so the cells' occupancy, and with it the pack, keeps the
    start's shape. Returns (positions on pos's device, pairs pulled)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.engine import layout

    p = pos.cpu().numpy()
    L = np.float32(specs[0].box_size[0])

    def keys(q):
        t = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))
        ok = torch.ones(len(q), dtype=torch.bool)
        return [layout._cell_key(s, t[:, 0], t[:, 1], t[:, 2], ok).numpy() for s in specs]

    k0 = keys(p)
    used = np.zeros(len(p), bool)
    q = p.copy()
    pairs = 0
    for i in np.random.default_rng(G2_CONTACT_SEED).permutation(len(p)):
        if pairs == G2_CONTACTS:
            break
        if used[i]:
            continue
        d = p - p[i]
        d -= L * np.round(d / L)
        r = np.sqrt((d * d).sum(axis=1))
        r[used] = np.inf
        r[i] = np.inf
        j = int(np.argmin(r))
        u = d[j] / r[j]
        mid = p[i] + 0.5 * d[j]
        ends = np.stack([mid - 0.5 * G2_CONTACT_GAP * u,
                         mid + 0.5 * G2_CONTACT_GAP * u]).astype(np.float32)
        ends -= L * np.round(ends / L)
        if all(k[0] == k_0[i] and k[1] == k_0[j] for k, k_0 in zip(keys(ends), k0)):
            q[i], q[j] = ends
            used[i] = used[j] = True
            pairs += 1
    return torch.from_numpy(q).to(pos.device), pairs


def g2_check_modes(step2, step1, st2, st1, what, controls, want_pairs=False):
    """Every shard's #2 PSE (halo, combined straggler rows) and #2 radial
    modes of ``step2`` on ``st2``, and #1 fused (halo) of ``step1`` on
    ``st1``, against their plain versions within CHANNEL_TOL x max|ref|
    (#1: PAIR_FUSED_TOL x max|f|), clean and with one x = NaN (NaN in
    exactly the plain version's entries); with ``controls`` the straggler
    rows dropped, the ghost rows counted and occ_trim 1 must each fail the
    bound by 100x; with ``want_pairs`` every mode must meet pairs inside
    its cutoff (max|ref| > 0). Returns the worst errors and the controls'."""
    import torch
    from uammd_tpu_torch.engine import pair_kernel
    from uammd_tpu_torch.parallel.domain import halo_extend

    out = {}
    inp = g2_inputs(step2, st2, 21)
    for mode in ("pse", "radial"):
        worst = {"rel": 0.0, "abs": 0.0, "nan_rel": 0.0}
        refs = [g2_mode_outputs(step2, mode, inp, i, plain=True) for i in range(step2.D)]
        scale = worst["max_ref"] = g2_scale(refs)
        if want_pairs:
            check(scale > 0.0, f"{what}: #2 {mode} halo meets pairs (max|ref| {scale:.3g} > 0)")
        if scale == 0.0:  # no pair inside the cutoff (the WCA on a lattice): exact zeros
            scale = 1.0
        for i in range(step2.D):
            ref = refs[i]
            got = g2_mode_outputs(step2, mode, inp, i)
            rel, same_nan, err = g2_compare(ref, got, scale)
            check(same_nan and rel < CHANNEL_TOL,
                  f"{what} shard {i}: #2 {mode} halo vs plain {rel:.3g} < {CHANNEL_TOL}")
            worst["rel"], worst["abs"] = max(worst["rel"], rel), max(worst["abs"], err)
            xyz = g2_nan_slab(inp["ext"], i)
            ref = g2_mode_outputs(step2, mode, inp, i, plain=True, xyz=xyz)
            got = g2_mode_outputs(step2, mode, inp, i, xyz=xyz)
            rel, same_nan, _ = g2_compare(ref, got, scale)
            n_nan = sum(int(torch.isnan(a).sum()) for a in ref)
            check(same_nan and n_nan > 0 and rel < CHANNEL_TOL,
                  f"{what} shard {i}: #2 {mode} halo with a NaN: NaN where plain puts it "
                  f"({n_nan}), finite within {rel:.3g} < {CHANNEL_TOL}")
            worst["nan_rel"] = max(worst["nan_rel"], rel)
            worst["nan_entries"] = max(worst.get("nan_entries", 0), n_nan)
        if controls:
            ctrl = {"strag_dropped": 0.0, "ghost_counted": 0.0, "occ_trim": 0.0}
            kern = step2.nkern if mode == "pse" else step2.fkern
            for i in range(step2.D):
                ref = refs[i]
                bad = g2_mode_outputs(step2, mode, inp, i, drop_strag=True)
                ctrl["strag_dropped"] = max(ctrl["strag_dropped"],
                                            g2_compare(ref, bad, scale)[0])
                bad = g2_mode_outputs(step2, mode, inp, i, periodic=True)
                ctrl["ghost_counted"] = max(ctrl["ghost_counted"], max(
                    float((a - b).abs().max()) for a, b in zip(ref[3:], bad[3:])) / scale)
                kern.occ_trim = 1
                try:
                    bad = g2_mode_outputs(step2, mode, inp, i)
                finally:
                    kern.occ_trim = 0
                ctrl["occ_trim"] = max(ctrl["occ_trim"], g2_compare(ref, bad, scale)[0])
            for k, v in ctrl.items():
                check(v > 100 * CHANNEL_TOL, f"{what}: #2 {mode} control ({k}) fails the bound "
                                             f"by 100x ({v:.3g} > {100 * CHANNEL_TOL})")
            worst["controls"] = ctrl
        out[f"pair_channel_{mode}_halo"] = worst
    # #1 with the fused radial on pse_dd's slabs
    Lz = step1.spec.box_size[2]
    ext = [halo_extend(step1.slabs(a)) for a in (st1.x, st1.y)] + [
        halo_extend(step1.slabs(st1.z), -Lz, Lz)]
    local, g = step1.local_spec, step1.fkern.g_fn
    worst = {"rel": 0.0, "abs": 0.0, "nan_rel": 0.0, "max_f": 0.0}
    ctrl = 0.0
    for i in range(step1.mesh.size):
        for xyz in ([a[i] for a in ext], g2_nan_slab(ext, i)):
            ref = pair_kernel.pair_force_plain(local, g, *xyz, periodic_z=False)
            got = step1.fkern(*xyz)
            fmax = max(float(torch.nan_to_num(a, nan=0.0).abs().max()) for a in ref)
            same_nan = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(ref, got))
            err = max(float(torch.nan_to_num(a - b, nan=0.0).abs().max()) for a, b in zip(ref, got))
            rel = err / max(fmax, 1.0)
            check(same_nan and rel < PAIR_FUSED_TOL,
                  f"{what} shard {i}: #1 fused halo vs plain {rel:.3g} < {PAIR_FUSED_TOL} "
                  f"(max|f| {fmax:.3g}), NaN where plain puts it")
            key = "rel" if xyz[0] is ext[0][i] else "nan_rel"
            worst[key] = max(worst[key], rel)
            if key == "rel":
                worst["abs"] = max(worst["abs"], err)
                worst["max_f"] = max(worst["max_f"], fmax)
                if controls:
                    step1.fkern.occ_trim = 1
                    try:
                        bad = step1.fkern(*xyz)
                    finally:
                        step1.fkern.occ_trim = 0
                    ctrl = max(ctrl, max(float((a - b).abs().max()) for a, b in zip(ref, bad))
                               / max(fmax, 1.0))
    if want_pairs:
        check(worst["max_f"] > 0.0, f"{what}: #1 fused halo meets pairs (max|f| "
                                    f"{worst['max_f']:.3g} > 0)")
    if controls:
        check(ctrl > 100 * PAIR_FUSED_TOL, f"{what}: #1 fused control (occ_trim) fails the "
                                           f"bound by 100x ({ctrl:.3g})")
        worst["control_occ_trim"] = ctrl
    out["pair_force_fused_halo"] = worst
    return out


def g2_kernel_checks(dev, full, clump):
    """g2_kernels_vs_plain: the three new modes on the clump system's halo
    slabs (4 shards, real straggler rows; with the controls), on the full
    path's first state's slabs, and on the same spec's slabs with
    G2_CONTACTS pairs inside the WCA cutoff."""
    import torch

    b, pos, be2 = clump
    be1 = g2_backend(b, G2C_N, pos, n_strag=0, far_grid=G2C_FAR, tolerance=G2C_TOL)
    step2 = g2_steps(dev, be2, G2C_N, 0.0, G2C_DT)
    step1 = g2_steps(dev, be1, G2C_N, 0.0, G2C_DT)
    st2 = step2.make_state(pos)
    n_strag = sum(int((s > 0.5).sum()) for s in st2.spidf)
    check(n_strag > 0, "clump system: real straggler rows")
    from uammd_tpu_torch.engine.layout import pack_channels

    cg1 = pack_channels(be1.spec, torch.from_numpy(pos).to(dev), torch.zeros((G2C_N, 0),
                                                                              device=dev))
    out = {"clump": g2_check_modes(step2, step1, st2, cg1, "clump 4 shards", controls=True),
           "clump_stragglers": n_strag, "clump_spec": list(be2.spec.array_shape),
           "clump_v1_spec": list(be1.spec.array_shape)}
    out["full_first_state"] = g2_check_modes(full["step2"], full["step1"], full["st2"],
                                             full["cg1"], "full first state 4 shards",
                                             controls=False)
    # the first state has no pair inside the WCA cutoff: the same spec with
    # contacts pulled in, where the WCA modes compute non-zero forces
    step2, step1 = full["step2"], full["step1"]
    pos_c, n_pairs = g2_contacts([step2.spec, step1.spec], full["pos"])
    check(n_pairs == G2_CONTACTS, f"full contacts: {n_pairs} == {G2_CONTACTS} pairs pulled")
    st2c = step2.make_state(pos_c)
    cg1c = pack_channels(step1.spec, pos_c, torch.zeros((PSE_N, 0), device=dev))
    check(not bool(cg1c.overflow) and max(float(o) for o in st2c.ovf) == 0.0
          and sum(int((s > 0.5).sum()) for s in st2c.spidf)
          == sum(int((s > 0.5).sum()) for s in full["st2"].spidf),
          "full contacts: the packs keep the first state's shape")
    out["full_contacts"] = g2_check_modes(step2, step1, st2c, cg1c, "full contacts 4 shards",
                                          controls=False, want_pairs=True)
    out["full_contact_pairs"] = n_pairs
    print(json.dumps({"phase": "g2_kernels_vs_plain", "ok": True, **out,
                      "channel_tol": CHANNEL_TOL, "pair_fused_tol": PAIR_FUSED_TOL}),
          flush=True)
    return out


def g2_parity(dev, clump):
    """At T = 0 each DD step against the port's single-grid PSE step
    (``displacement_with_pair_force``): pse_dd on the dimer system at PSE_N
    (one step: forces and positions), pse_dd2 on the clump system on 4 and
    2 shards (3 + 3 steps through a forced rebin); and the far bucket
    overflow control (far_m2 = 8 must latch ``ovf``)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.parallel import pse_dd2

    out = {}
    b, pos = g2_dimers(dev)
    be = g2_backend(b, PSE_N, pos, n_strag=0)
    p0 = torch.from_numpy(pos).to(dev)
    fs = be.make_pair_force_slots(g2_wca())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dx_ref, f_ref, ovf = be.displacement_with_pair_force(fs, p0, gen, PSE_DT, 0.0)
    check(not bool(ovf), "dimers: single-grid step without overflow")
    p_ref = b.wrap_position(p0 + dx_ref)
    step = g2_steps(dev, be, PSE_N, 0.0, PSE_DT)
    p_dd, f_dd, ovf_dd = step(p0)
    check(not bool(ovf_dd), "dimers: pse_dd step without overflow")
    fscale = float(f_ref.abs().max())
    dscale = float(dx_ref.abs().max())
    f_err = float((f_dd - f_ref).abs().max())
    d = p_dd - p_ref
    d = d - PSE_L * torch.round(d / PSE_L)
    p_err = float(d.abs().max())
    check(fscale > 1.0, f"dimers: the WCA force is not zero ({fscale:.3g})")
    check(f_err < G2_F_TOL * max(fscale, 1.0) and p_err < G2_P_TOL * max(dscale, 1.0),
          f"pse_dd at N = {PSE_N}: forces {f_err:.3g} < {G2_F_TOL} x {max(fscale, 1.0):.3g}, "
          f"positions {p_err:.3g} < {G2_P_TOL} x {max(dscale, 1.0):.3g}")
    out["pse_dd_dimers"] = {"n": PSE_N, "force_err": f_err, "fscale": fscale,
                            "pos_err": p_err, "dscale": dscale,
                            "spec": list(be.spec.array_shape)}
    del be, step, fs
    b, pos, be = clump
    fs = be.make_pair_force_slots(g2_wca())
    p = torch.from_numpy(pos).to(dev)
    for _ in range(2 * G2_TRAJ_STEPS):
        dx, _, ovf = be.displacement_with_pair_force(fs, p, gen, G2C_DT, 0.0)
        check(not bool(ovf), "clump: single-grid step without overflow")
        p = b.wrap_position(p + dx)
    p_ref = p.cpu().numpy()
    L = b.lengths[0]
    for n_shards in (G2_SHARDS, 2):
        step = g2_steps(dev, be, G2C_N, 0.0, G2C_DT, n_shards=n_shards)
        st = step.make_state(pos)
        n_strag = sum(int((s > 0.5).sum()) for s in st.spidf)
        for _ in range(G2_TRAJ_STEPS):
            st = step(st)
        st = st.replace(rx=[r + 10.0 * be.spec.drift_threshold for r in st.rx])
        for _ in range(G2_TRAJ_STEPS):
            st = step(st)
        ovf = max(float(o) for o in st.ovf)
        reb = min(int(r) for r in st.n_rebin)
        d = pse_dd2.gather_positions(st, G2C_N) - p_ref
        d -= L * np.round(d / L)
        err = float(np.abs(d).max())
        check(ovf == 0.0 and reb >= 1 and n_strag > 0 and err < G2_TRAJ_TOL,
              f"pse_dd2 clump {n_shards} shards: ovf {ovf} = 0, rebins {reb} >= 1, stragglers "
              f"{n_strag} > 0, positions {err:.3g} < {G2_TRAJ_TOL}")
        out[f"pse_dd2_clump_{n_shards}"] = {"pos_err": err, "rebins": reb,
                                            "stragglers": n_strag, "ovf": ovf}
    step = g2_steps(dev, be, G2C_N, 0.0, G2C_DT, far_m2=G2_FAR_M2_CONTROL)
    st = step(step.make_state(pos))
    latch = max(float(o) for o in st.ovf)
    check(latch > 0.0, f"control: far_m2 = {G2_FAR_M2_CONTROL} latches ovf ({latch})")
    out["far_bucket_control_ovf"] = latch
    print(json.dumps({"phase": "g2_parity", "ok": True, **out, "force_tol": G2_F_TOL,
                      "pos_tol": G2_P_TOL, "traj_tol": G2_TRAJ_TOL}), flush=True)
    return out


def g2_counters() -> dict:
    from uammd_tpu_torch.engine import pair_kernel
    from uammd_tpu_torch.solvers import lanczos

    return {"pair_channel_pse_halo": pair_kernel.PAIR_CHANNEL_HALO,
            "pair_channel_radial_halo": pair_kernel.PAIR_CHANNEL_RADIAL_HALO,
            "pair_force_fused_halo": pair_kernel.PAIR_FORCE_FUSED_HALO,
            "lanczos_sqrt": lanczos.LANCZOS_SQRT,
            "pair_channel": pair_kernel.PAIR_CHANNEL,
            "pair_channel_radial": pair_kernel.PAIR_CHANNEL_RADIAL,
            "pair_force_fused": pair_kernel.PAIR_FORCE_FUSED}


def g2_full(dev):
    """The full path's backends, steps and first states: pse_dd2 with
    G2_STRAG rows a shard and pse_dd without, both at nz_multiple 4."""
    import torch
    from uammd_tpu_torch.engine.layout import pack_channels

    b, pos = pse_box_and_fcc(dev)
    t0 = time.perf_counter()
    be2 = g2_backend(b, PSE_N, pos, n_strag=G2_STRAG)
    be1 = g2_backend(b, PSE_N, pos, n_strag=0)
    step2 = g2_steps(dev, be2, PSE_N, PSE_T, PSE_DT)
    step1 = g2_steps(dev, be1, PSE_N, PSE_T, PSE_DT)
    st2 = step2.make_state(pos)
    cg1 = pack_channels(be1.spec, pos, torch.zeros((PSE_N, 0), device=dev))
    torch.cuda.synchronize()
    return {"box": b, "pos": pos, "be2": be2, "be1": be1, "step2": step2, "step1": step1,
            "st2": st2, "cg1": cg1, "setup_s": time.perf_counter() - t0}


def g2_band(pos0, pos1, L, steps) -> tuple:
    """(rms displacement, its expected scale sqrt(2 kT m0 dt steps))."""
    import torch

    d = pos1 - pos0
    d = d - L * torch.round(d / L)
    rms = float(torch.sqrt((d.double() ** 2).sum(dim=1).mean()))
    m0 = 1.0 / (6.0 * math.pi)
    return rms, math.sqrt(2.0 * PSE_T * m0 * PSE_DT * steps)


def main_path_pse_dd2(dev, card, full, n_shards):
    """main_path_pse_dd2: pse_dd2 on ``n_shards`` shards of the card at
    bench.py's PSE size, G2_WARM + G2_TIMED steps at T = 1 from the fcc
    start, with the launch counts zeroed just before the steps; a rebin is
    forced in the middle of the timed window if none fired. Gates: ovf 0,
    the count audit, a rebin in the window, finite state, the rms
    displacement band, each kernel's launches as predicted."""
    import torch
    from uammd_tpu_torch.parallel import pse_dd2

    step = full["step2"] if n_shards == G2_SHARDS else g2_steps(
        dev, full["be2"], PSE_N, PSE_T, PSE_DT, n_shards=n_shards)
    st = step.make_state(full["pos"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    counted = g2_counters()
    for k in counted.values():
        k.launches = 0
    step.rebins = 0
    for _ in range(G2_WARM):
        st = step(st, gen)
    torch.cuda.synchronize()
    reb0 = step.rebins
    forced = False
    t0 = time.perf_counter()
    for k in range(G2_TIMED):
        if k == G2_TIMED // 2 and step.rebins == reb0:
            st = step.step_z(st, *step.draw(gen), force_rebin=True)
            forced = True
        else:
            st = step(st, gen)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    steps = G2_WARM + G2_TIMED
    D, m = n_shards, full["be2"].lanczos_iterations
    want = {"pair_channel_pse_halo": steps * D * (1 + m), "pair_channel_radial_halo": steps * D,
            "lanczos_sqrt": steps * D}
    for k, v in counted.items():
        check(launches[k] == want.get(k, 0),
              f"pse_dd2 {D} shards: {k} launched {launches[k]} = {want.get(k, 0)} times")
    ovf = max(float(o) for o in st.ovf)
    count = sum(int((p > 0.5).sum()) + int((s > 0.5).sum()) for p, s in zip(st.pidf, st.spidf))
    n_strag = sum(int((s > 0.5).sum()) for s in st.spidf)
    p1 = torch.from_numpy(pse_dd2.gather_positions(st, PSE_N)).to(dev)
    rms, expected = g2_band(full["pos"], p1, PSE_L, steps)
    check(ovf == 0.0, f"pse_dd2 {D} shards: ovf {ovf} = 0")
    check(count == PSE_N, f"pse_dd2 {D} shards: count audit {count} = {PSE_N}")
    check(step.rebins - reb0 >= 1, f"pse_dd2 {D} shards: a rebin in the timed window")
    check(bool(torch.isfinite(p1).all()), f"pse_dd2 {D} shards: finite state")
    check(G2_BAND[0] * expected < rms < G2_BAND[1] * expected,
          f"pse_dd2 {D} shards: rms displacement {rms:.4g} within {G2_BAND} x {expected:.4g}")
    ms = 1e3 * timed_s / G2_TIMED
    res = {"phase": f"main_path_pse_dd2_{D}", "card": card, "n": PSE_N, "shards": D,
           "spec": list(step.spec.array_shape), "local_spec": list(step.local_spec.array_shape),
           "n_strag_per_shard": step.S, "n_comb": step.n_comb, "far_m2": step.far_m2,
           "far_grid": list(full["be2"].far.shape), "far_support": full["be2"].far.support,
           "lanczos_m": m, "warm_steps": G2_WARM, "timed_steps": G2_TIMED,
           "timed_seconds": timed_s, "ms_per_step": ms,
           "particle_steps_per_s": PSE_N * G2_TIMED / timed_s, "rebins_warm": reb0,
           "rebins_timed": step.rebins - reb0, "rebin_forced": forced, "ovf": ovf,
           "count": count, "stragglers_final": n_strag, "rms_displacement": rms,
           "rms_expected": expected, "launches": launches, "launches_predicted": want,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(json.dumps(res), flush=True)
    res.update(step=step, st=st, gen=gen)
    return res


def main_path_pse_dd(dev, card, full):
    """main_path_pse_dd: pse_dd (v1) on G2_SHARDS shards at bench.py's PSE
    size without a straggler list, G2_WARM + G2_TIMED steps at T = 1 from
    the fcc start. Gates: no overflow, finite, the band, the launches."""
    import torch

    step = full["step1"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    counted = g2_counters()
    for k in counted.values():
        k.launches = 0
    p = full["pos"]
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(G2_WARM):
        p, _, o = step(p, gen)
        ovf = ovf | o
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(G2_TIMED):
        p, f, o = step(p, gen)
        ovf = ovf | o
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = {k: v.launches for k, v in counted.items()}
    steps = G2_WARM + G2_TIMED
    D, m = G2_SHARDS, full["be1"].lanczos_iterations
    want = {"pair_channel_pse_halo": steps * D * (1 + m), "pair_force_fused_halo": steps * D,
            "lanczos_sqrt": steps * D}
    for k, v in counted.items():
        check(launches[k] == want.get(k, 0),
              f"pse_dd: {k} launched {launches[k]} = {want.get(k, 0)} times")
    rms, expected = g2_band(full["pos"], p, PSE_L, steps)
    check(not bool(ovf), "pse_dd: no overflow (near pack, far binning)")
    check(bool(torch.isfinite(p).all()), "pse_dd: finite positions")
    check(G2_BAND[0] * expected < rms < G2_BAND[1] * expected,
          f"pse_dd: rms displacement {rms:.4g} within {G2_BAND} x {expected:.4g}")
    reads = host_reads(lambda: step(p, gen), 2)
    res = {"phase": "main_path_pse_dd", "card": card, "n": PSE_N, "shards": D,
           "spec": list(step.spec.array_shape), "local_spec": list(step.local_spec.array_shape),
           "far_m_cap": step.far_m_cap, "lanczos_m": m, "warm_steps": G2_WARM,
           "timed_steps": G2_TIMED, "timed_seconds": timed_s,
           "ms_per_step": 1e3 * timed_s / G2_TIMED,
           "particle_steps_per_s": PSE_N * G2_TIMED / timed_s, "overflow": False,
           "rms_displacement": rms, "rms_expected": expected, "launches": launches,
           "launches_predicted": want, "host_reads_per_step": len(reads) / 2,
           "host_read_lines": sorted(set(reads))}
    print(json.dumps(res), flush=True)
    res.update(step=step, pos=p)
    return res


class SpanTimer:
    """CUDA events around each named phase of a step (``span(name)``);
    ``ms()`` sums them per name."""

    def __init__(self):
        self.events = []

    def __call__(self, name):
        import torch

        rec = self.events

        @contextlib.contextmanager
        def span():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            yield
            e.record()
            rec.append((name, s, e))

        return span()

    def ms(self) -> tuple:
        import torch

        torch.cuda.synchronize()
        tot, cnt = {}, {}
        for name, s, e in self.events:
            tot[name] = tot.get(name, 0.0) + s.elapsed_time(e)
            cnt[name] = cnt.get(name, 0) + 1
        return tot, cnt


def breakdown_pse_dd2(card, dd4, dd1):
    """breakdown_pse_dd2: the ms of each layer of a pse_dd2 step (CUDA
    events around each phase, G2_BREAKDOWN_STEPS steps at each path's final
    state, then one forced rebin), the host reads per step, and the
    4-shard step against the 1-shard one."""
    out = {}
    for run in (dd4, dd1):
        step, st, gen = run["step"], run["st"], run["gen"]
        timer = SpanTimer()
        step.span = timer
        try:
            for _ in range(G2_BREAKDOWN_STEPS):
                st = step(st, gen)
            tot, cnt = timer.ms()
            timer.events.clear()
            st = step.step_z(st, *step.draw(gen), force_rebin=True)
            reb, _ = timer.ms()
        finally:
            del step.span
        k = G2_BREAKDOWN_STEPS
        per = {n: v / k for n, v in tot.items()}
        m = step.be.lanczos_iterations
        mv = per.get("matvec", 0.0)
        layers = {"drift_and_host_read": per.get("drift", 0.0),
                  "rebin_forced": reb.get("rebin", 0.0), "ghosts": per.get("halo", 0.0),
                  "pair_force": per.get("pair_force", 0.0),
                  "matvec_x_(1+m)": mv, "matvec_one": mv / (1 + m),
                  "lanczos_without_matvecs": per.get("lanczos", 0.0) - mv * m / (1 + m),
                  "bucketing": per.get("bucket", 0.0), "far_field": per.get("far", 0.0),
                  "update": per.get("update", 0.0)}
        step_ms = sum(per[n] for n in ("drift", "halo", "pair_force", "bucket", "far", "update")
                      if n in per) + mv / (1 + m) + per.get("lanczos", 0.0)
        reads = host_reads(lambda: step(st, gen), 3)
        out[f"shards_{step.D}"] = {
            "ms_per_step_timed": run["ms_per_step"], "ms_per_step_spans": step_ms,
            "layers_ms": layers, "span_calls_per_step": {n: c / k for n, c in cnt.items()},
            "host_reads_per_step": len(reads) / 3, "host_read_lines": sorted(set(reads))}
        run["st"] = st
    print(json.dumps({"phase": "breakdown_pse_dd2", "card": card, **out,
                      "note": "CUDA events around each phase of one step (the lanczos span "
                              "holds m of the 1 + m matvecs); on one card the exchanges are "
                              "device-local copies"}), flush=True)
    return out


def g2_pairs(local, ext, pidf_ext, comb, rc2) -> dict:
    """The work of a halo-mode channel kernel on one shard: ordered
    candidate pairs of distinct particles from the slab's interior home
    slots and those inside rc2, and the (interior home, valid combined
    row) pairs inside rc2 (minimum image)."""
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.engine.kernel2 import _box

    x, y, z = ext
    rows = torch.arange(local.cap, device=x.device)[None, None, :, None]
    pid = pidf_ext.to(torch.int64) - 1
    inner = torch.zeros_like(pid, dtype=torch.bool)
    inner[1:-1] = True
    pid_i = pid[:, :, :, None, :]
    home = [a[:, :, :, None, :] for a in (x, y, z)]
    cand = cut = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, lane, shifts = layout.stencil_sources(local, dz, dy, dx, x.device,
                                                               periodic_z=False)
                pid_j = pid[zs, ybs, rows, lane][:, :, None]
                both = (inner[:, :, :, None, :] & (pid_i >= 0) & (pid_j >= 0)
                        & (pid_i != pid_j))
                r2 = sum(((a[zs, ybs, rows, lane] + s)[:, :, None] - h) ** 2
                         for a, s, h in zip((x, y, z), shifts, home))
                cand += int(both.sum())
                cut += int((both & (r2 < rc2)).sum())
    Ls, iLs = _box(local.box_size, x.device)
    act = (inner & (pid >= 0)).reshape(-1)
    hp = torch.stack([a.reshape(-1)[act] for a in (x, y, z)], -1)
    sp = comb[comb[:, 3] > 0.5][:, :3]
    d = sp[None, :, :] - hp[:, None, :]
    d = d - Ls * torch.round(d * iLs)
    return {"candidates": cand, "inside": cut, "straggler": int(act.sum()) * int(sp.shape[0]),
            "straggler_inside": int(((d * d).sum(-1) < rc2).sum())}


def g2_rows(card, dd4, pd, checks):
    """The kernels-line rows of the three new modes: #2 PSE and #2 radial
    (halo, combined straggler rows) at the 4-shard pse_dd2 path's final
    state, #1 fused (halo) at the pse_dd path's final state; ms, plain ms
    and bound cover one step's launches of one sweep over the shards."""
    import numpy as np
    import torch
    from uammd_tpu_torch.engine import pair_kernel
    from uammd_tpu_torch.parallel.domain import halo_extend

    step, st = dd4["step"], dd4["st"]
    D = step.D
    inp = g2_inputs(step, st, 31)
    local = step.local_spec
    note = (f"ms, plain_ms and bound_ms cover one sweep's {D} launches (one per shard) at "
            "the path's final state; the pse row's launches are 1 + m sweeps a step")
    rows = []
    fx = {"pse": step.near_fn, "radial": step.force_fn}
    rc2s = {"pse": float(np.float32(step.be.rcut ** 2)), "radial": float(step.g_pair.rc2)}
    for mode, name, kname in (("pse", "pair_channel_pse_halo", "pair_channel_pse_halo"),
                              ("radial", "pair_channel_radial_halo",
                               "pair_channel_radial_halo")):
        # the kernel's inputs made once, outside the timed launches
        kern = step.nkern if mode == "pse" else step.fkern
        args = [([a[i] for a in inp["ext"]]
                 + ([inp["hg"][i][c] for c in range(3)] if mode == "pse" else []),
                 step.bblock(inp["comb"][i], tuple(inp["cr"][i]) if mode == "pse" else ()))
                for i in range(D)]
        ms = cuda_ms(lambda: [kern(*a, strag=blk) for a, blk in args], reps=10)
        plain = cuda_ms(lambda: [g2_mode_outputs(step, mode, inp, i, plain=True)
                                 for i in range(D)], reps=1, warmup=1)
        err = max(g2_compare(g2_mode_outputs(step, mode, inp, i, plain=True),
                             g2_mode_outputs(step, mode, inp, i))[2] for i in range(D))
        pairs = [g2_pairs(local, [a[i] for a in inp["ext"]], inp["pidf"][i], inp["comb"][i],
                          rc2s[mode]) for i in range(D)]
        tot = {k: sum(p[k] for p in pairs) for k in pairs[0]}
        cand = tot["candidates"] // 2 + tot["straggler"]
        inside = tot["inside"] // 2 + tot["straggler_inside"]
        if mode == "pse":
            ops = OPS_CH_TEST * cand + (OPS_CH_RADIAL + 2 * OPS_CH_APPLY) * inside
            n_io = 9  # x, y, z and 3 channels in, 3 sums out
        else:
            ops = OPS_PAIR_TEST * cand + OPS_PAIR_FUSED * inside
            n_io = 6
        ops_ms = 1e3 * ops / PEAK_FP32_FLOPS
        ng = 3 if mode == "pse" else 0
        bytes_ms = 1e3 * D * 4 * (n_io * local.n_slots + (ng + 4 + 3) * step.n_comb) \
            / PEAK_HBM_BYTES
        rows.append({"name": name, "route": "cuda",
                     "source": "uammd_tpu_torch/engine/csrc/pair_channel.cu (+ "
                               "channel_functors.cuh)",
                     "replaces": "uammd_tpu/engine/pair_kernel.py:538 (periodic_z=False, "
                                 ":381-385, with straggler rows; "
                                 + ("pse_dd2.py:110-113" if mode == "pse"
                                    else "pse_dd2.py:119-127") + ")",
                     "launches": dd4["launches"][kname], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                     "library_ms": None, "pairs": tot, "checks": checks["clump"][kname],
                     "checks_full_first_state": checks["full_first_state"][kname],
                     "checks_full_contacts": checks["full_contacts"][kname],
                     "launch_plan": channel_plan_of(local, fx[mode]),
                     "shape": list(local.array_shape), "n_comb": step.n_comb, "note": note})
    # #1 fused at the pse_dd path's final state
    step1 = pd["step"]
    from uammd_tpu_torch.engine.layout import pack_channels

    cg = pack_channels(step1.spec, pd["pos"], torch.zeros((PSE_N, 0), device=pd["pos"].device))
    Lz = step1.spec.box_size[2]
    ext = [halo_extend(step1.slabs(a)) for a in (cg.x, cg.y)] + [
        halo_extend(step1.slabs(cg.z), -Lz, Lz)]
    pidf = halo_extend(step1.slabs((cg.pid + 1).to(torch.float32)))
    local1, g = step1.local_spec, step1.fkern.g_fn
    ms = cuda_ms(lambda: [step1.fkern(ext[0][i], ext[1][i], ext[2][i]) for i in range(D)],
                 reps=10)
    plain = cuda_ms(lambda: [pair_kernel.pair_force_plain(local1, g, ext[0][i], ext[1][i],
                                                          ext[2][i], periodic_z=False)
                             for i in range(D)], reps=1, warmup=1)
    err = max(max(float((a - b).abs().max()) for a, b in zip(
        step1.fkern(ext[0][i], ext[1][i], ext[2][i]),
        pair_kernel.pair_force_plain(local1, g, ext[0][i], ext[1][i], ext[2][i],
                                     periodic_z=False))) for i in range(D))
    empty = torch.zeros((0, 4), device=cg.x.device)
    # the kernel culls at the nearer of the spec's cutoff and the radial's
    rc2 = min(float(np.float32(step1.spec.cutoff ** 2)), g.rc2)
    pairs = [g2_pairs(local1, [a[i] for a in ext], pidf[i], empty, rc2) for i in range(D)]
    tot = {k: sum(p[k] for p in pairs) for k in pairs[0]}
    ops_ms = 1e3 * (OPS_PAIR_TEST * tot["candidates"] // 2
                    + OPS_PAIR_FUSED * tot["inside"] // 2) / PEAK_FP32_FLOPS
    bytes_ms = 1e3 * D * 4 * 6 * local1.n_slots / PEAK_HBM_BYTES
    rows.append({"name": "pair_force_fused_halo", "route": "cuda",
                 "source": "uammd_tpu_torch/engine/csrc/pair_force.cu",
                 "replaces": "uammd_tpu/engine/pair_kernel.py:272 (periodic_z=False, "
                             ":99-102, g_fn = md.lj_g_fused; pse_dd.py:173-177)",
                 "launches": pd["launches"]["pair_force_fused_halo"], "max_abs_err": err,
                 "ms": ms, "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
                 "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
                 "library_ms": None, "pairs": tot,
                 "checks": checks["clump"]["pair_force_fused_halo"],
                 "checks_full_first_state": checks["full_first_state"]["pair_force_fused_halo"],
                 "checks_full_contacts": checks["full_contacts"]["pair_force_fused_halo"],
                 "launch_plan": plan_of(local1)["pair_force"], "shape": list(local1.array_shape),
                 "cutoff": step1.spec.cutoff, "note": note})
    return rows


def g2_phases(dev, card) -> list:
    """Slice G2a's phases in order; returns the kernels-line rows."""
    import torch

    full = g2_full(dev)
    clump = g2_clump(dev)
    checks = g2_kernel_checks(dev, full, clump)
    parity = g2_parity(dev, clump)
    torch.cuda.empty_cache()
    dd4 = main_path_pse_dd2(dev, card, full, G2_SHARDS)
    dd1 = main_path_pse_dd2(dev, card, full, 1)
    pd = main_path_pse_dd(dev, card, full)
    breakdown_pse_dd2(card, dd4, dd1)
    rows = g2_rows(card, dd4, pd, checks)
    print(json.dumps({"phase": "g2_summary", "card": card, "setup_s": full["setup_s"],
                      "pse_dd2_4_ms_per_step": dd4["ms_per_step"],
                      "pse_dd2_1_ms_per_step": dd1["ms_per_step"],
                      "pse_dd_4_ms_per_step": pd["ms_per_step"],
                      "parity": {k: v for k, v in parity.items()}}), flush=True)
    del full, dd4, dd1, pd
    torch.cuda.empty_cache()
    return rows


def g2_only(dev, card) -> int:
    """``--only-g2``: slice G2a's checks and paths alone, for working on
    them; prints no result line."""
    rows = g2_phases(dev, card)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


def dd_only(dev, card) -> int:
    """``--only-dd``: slice G1's phases alone (after the v1 melt), for
    working on them; prints no result line."""
    rows = dd_phases(dev, card, melt(dev), None)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


# ------------------------------------------------ the rebins on a face of the box
# Every rebin of the port (#3, #4, #5 and the sort rebin) puts a particle in
# the cell of its wrapped coordinate and stores that wrapped value. The TPU
# kernels (and #3 and #4 until they wrapped first) add a destination's image
# shift and test the shifted value before wrapping it; within ulps of
# +-L/2 that loses a particle, claims it twice or stores another
# representative. The face checks seed each path's state at its own L with
# particles on those values and hold the rebins to each other there.
FACE_ULPS = 8


def _cell32(p, iL, n):
    import numpy as np

    fr = p * iL + np.float32(0.5)
    return np.floor((fr - np.floor(fr)) * np.float32(n))


def _wrap32(p, L, iL):
    import numpy as np

    return (p - L * np.rint(p * iL)) + np.float32(0.0)


def face_values(L: float, n: int, ulps: int = FACE_ULPS) -> list:
    """(source cell, x) for the float32 values within ``ulps`` spacings of
    -L/2 and +L/2 and the source cells 0 and n - 1 where the shifted rule
    (a float32 replica: destination d tests floor(frac(p / L + 1/2) n) on
    p plus its stencil's image shift) does not store the particle exactly
    once, in the cell and at the wrapped value the sort rebin gives it."""
    import numpy as np

    f32 = np.float32
    Lf = f32(L)
    iL = f32(1.0) / Lf
    out = []
    for edge in (-L / 2, L / 2):
        xs = [f32(edge)]
        lo = hi = f32(edge)
        for _ in range(ulps):
            lo, hi = np.nextafter(lo, f32(-np.inf)), np.nextafter(hi, f32(np.inf))
            xs += [lo, hi]
        for s in (0, n - 1):
            for v in sorted(xs):
                w = _wrap32(v, Lf, iL)
                fr = w * iL + f32(0.5)
                want = (min(int((fr - np.floor(fr)) * f32(n)), n - 1), w)
                got = []
                for d in sorted({(s - 1) % n, s, (s + 1) % n}):
                    k = next(k for k in (-1, 0, 1) if (d + k) % n == s)
                    sh = -Lf if d + k < 0 else (Lf if d + k >= n else f32(0.0))
                    q = v + sh
                    if _cell32(q, iL, n) == d:
                        got.append((d, _wrap32(q, Lf, iL)))
                if len(got) != 1 or got[0][0] != want[0] or got[0][1] != want[1]:
                    out.append((s, float(v)))
    return out


def seed_faces(gs):
    """``gs`` with particles moved onto every face value of each axis at
    its spec's L and cell count: each value to its own occupied slot of the
    value's source cell on that axis. Returns (state, values per axis)."""
    import numpy as np
    import torch

    spec = gs.spec
    nz, nyb, cap, nlane = spec.array_shape
    F = spec.fold
    lane = np.arange(nlane)
    shape = (nz, nyb, cap, nlane)
    cells = (np.broadcast_to((lane // F)[None, None, None, :], shape),
             np.broadcast_to((np.arange(nyb)[:, None] * F + lane % F)[None, :, None, :], shape),
             np.broadcast_to(np.arange(nz)[:, None, None, None], shape))
    pid = gs.pid.cpu().numpy()
    used = np.zeros(shape, bool)
    cols = {k: getattr(gs, k).clone() for k in ("x", "y", "z")}
    values = []
    for a, key in enumerate(("x", "y", "z")):
        vals = face_values(spec.box_size[a], spec.shape[a])
        values.append(vals)
        for s, v in vals:
            free = np.argwhere((pid >= 0) & (cells[a] == s) & ~used)
            i = tuple(int(t) for t in free[len(free) // 2])
            used[i] = True
            cols[key][i] = v
    return gs.replace(**cols), values


def shifted_rule_rebin_plain(spec, stacked):
    """The control's rebin: ``rebin_kernel.rebin_plain`` with the shifted
    rule (each destination tests the image-shifted coordinate, then stores
    it wrapped), as the TPU kernel computes it."""
    import torch
    from uammd_tpu_torch.engine import rebin_kernel as rk
    from uammd_tpu_torch.engine.layout import EMPTY_POS, stencil_sources

    n_q = stacked.shape[0]
    nx, ny, nz = spec.shape
    F, cap, nlane, nyb = spec.fold, spec.cap, spec.nlane, spec.nyb
    Ls = spec.box_size
    dev = stacked.device
    lane = torch.arange(nlane, device=dev)
    my = ((lane // F).to(torch.float32)[None, None, None, :],
          (torch.arange(nyb, device=dev)[:, None] * F + lane[None, :] % F)
          .to(torch.float32)[None, :, None, :],
          torch.arange(nz, device=dev).to(torch.float32)[:, None, None, None])
    rows = torch.arange(cap, device=dev)[None, None, :, None]
    out = torch.zeros_like(stacked)
    base = torch.zeros((nz, nyb, 1, nlane), dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                zs, ybs, ls, shifts = stencil_sources(spec, dz, dy, dx, dev)
                cand = stacked[:, zs, ybs, rows, ls]
                p = [cand[d] + shifts[d] for d in range(3)]
                valid = cand[n_q - 1] > 0.5
                for d, n_ in enumerate((nx, ny, nz)):
                    valid = valid & (rk._dest_cell(p[d], Ls[d], n_) == my[d])
                vals = torch.stack([rk._wrap_pos(p[d], Ls[d]) for d in range(3)]
                                   + [cand[q] + 0.0 for q in range(3, n_q)])
                base, c, _ = rk._rank_into(out, base, vals, valid)
                count = count + c
    unfilled = rows >= base
    out[:3] = torch.where(unfilled, torch.full_like(out[:3], EMPTY_POS), out[:3])
    return out, count


def face_check(gs, what: str) -> dict:
    """Phase 2r on one state: sub-drift displacement, particles seeded on
    the face values of each axis, then every rebin that runs on such a
    spec held to its plain version bit for bit, every particle kept, and
    the rebins held to the sort rebin by pid; the control (the shifted
    rule's plain replica on the same state) must lose a particle or store
    another value."""
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.engine import rebin_kernel as rk

    seeded, values = seed_faces(displaced(gs, 41))
    stacked = stacked_of(seeded, 7)
    n_grid = int((seeded.pid >= 0).sum())
    out = {"spec": list(seeded.spec.array_shape), "box": list(seeded.spec.box_size),
           "values_per_axis": [len(v) for v in values],
           "values_x": [[s, v] for s, v in values[0]]}
    p_sort = layout.unpack(layout.rebin(seeded))[0]
    if seeded.spec.n_strag == 0:
        for q in (7, 10):
            check_rebin(seeded, q, f"{what} face values")
        p3 = layout.unpack(rk.rebin_fast(seeded))[0]
        check(torch.equal(p3, p_sort), f"{what} face values: #3 stores every particle as "
                                       f"the sort rebin does, by pid")
        out["checked"] = "#3 (Q 7, 10) and the sort rebin"
    else:
        out["mini_stragglers"], out["rebin2_err"] = check_rebin2(seeded, f"{what} face values")
        check_sep_rebin(seeded, f"{what} face values")
        out["checked"] = "#4, #5 and the sort rebin"
    old, count_old = shifted_rule_rebin_plain(seeded.spec, stacked)
    new, count_new = rk.rebin_plain(seeded.spec, stacked)[:2]
    claims = int(count_old) - n_grid  # < 0: particles lost, > 0: claimed twice
    moved = int(((old != new) & (old == old)).any(dim=0).sum())
    check(claims != 0 or moved > 0, f"{what} face values: control, the shifted rule loses or "
                                    f"doubles ({claims}) or moves ({moved}) a particle")
    out["control_shifted_rule"] = {"claims_minus_particles": claims, "slots_differing": moved,
                                   "new_rule_count": int(count_new)}
    return out


def face_states(dev) -> list:
    """(name, state) at each path's own box and grid whose rebins are
    kernels: v1 (#3), DPD (#3), SPH (#3), the v2 spec with stragglers (#4
    on the unfused path, #5) and the PSE near grid (#5), each packed from
    its path's start. (The n 600 check system, CAP 8 in 4^3 cells, is too
    crowded for 51 particles moved into its face cells: a rank passes CAP +
    OCAP there.)"""
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.engine.dpd import GridDPD
    from uammd_tpu_torch.engine.sph import GridSPH
    from uammd_tpu_torch.interactors.sph import SPHParams
    from uammd_tpu_torch.utils.lattices import lattice

    pos = lattice(N, BOX, "fcc")
    states = [("v1 (L 128)", layout.pack(layout.choose_spec(BOX, N, 2.5, pos=pos), pos,
                                          device=dev)),
              ("v2 with stragglers (L 128)", layout.pack(
                  layout.choose_spec(BOX, N, 2.5, pos=pos, n_strag=N_STRAG), pos, device=dev))]
    p = fcc_start(N, DPD_L, 0.13, 11)
    spec = GridDPD.create(DPD_L, N, pos=p, device=dev, **DPD_KW).spec
    states.append((f"DPD (L {DPD_L:.2f})", layout.pack(spec, p, device=dev)))
    p = fcc_start(N, SPH_L, 0.05, 13)
    spec = GridSPH.create(SPH_L, N, SPHParams(**SPH_KW), dt=SPH_DT, pos=p, device=dev).spec
    states.append((f"SPH (L {SPH_L:.2f})", layout.pack(spec, p, device=dev)))
    b, pos_pse = pse_box_and_fcc(dev)
    be = pse_backend(b, pos_pse)
    states.append((f"PSE near grid (L {PSE_L:.2f})", layout.pack(be.spec, pos_pse, device=dev)))
    return states


def rebin_face_checks(states) -> dict:
    """Phase 2r: ``face_check`` on each of ``face_states``."""
    out = {name: face_check(gs, name) for name, gs in states}
    print(json.dumps({"phase": "rebin_faces", "ok": True, "ulps": FACE_ULPS, **out}),
          flush=True)
    return out


def check_rebin_nan(gs, what: str) -> dict:
    """#3 on ``gs`` with one particle's x set to NaN and another's y to
    +inf: out, count and overflow equal the plain version's (both particles
    belong to no cell)."""
    import torch
    from uammd_tpu_torch.engine import rebin_kernel as rk

    stacked = stacked_of(gs, 7).clone()
    occ = (stacked[6] > 0.5).nonzero()
    stacked[0][tuple(occ[len(occ) // 3])] = float("nan")
    stacked[1][tuple(occ[2 * len(occ) // 3])] = float("inf")
    out_k, count_k, over_k = rk.make_rebin_kernel(gs.spec)(stacked)
    out_p, count_p, over_p = rk.rebin_plain(gs.spec, stacked)
    check(torch.equal(out_k, out_p), f"{what}: #3 with a NaN and an inf equals plain")
    check((int(count_k), int(over_k)) == (int(count_p), int(over_p)) == (gs.n - 2, 0),
          f"{what}: #3 with a NaN and an inf: count/overflow {int(count_k)}/{int(over_k)} == "
          f"plain {int(count_p)}/{int(over_p)}, the two particles in no cell")
    return {"count": int(count_k), "overflow": int(over_k)}


def rebin_plan_of(spec) -> dict:
    """#3's launch plan with the library's own shared memory and threads,
    which must equal the plan's."""
    from uammd_tpu_torch.engine import _build
    from uammd_tpu_torch.engine import rebin_kernel as rk

    plan = rk.rebin_launch_plan(spec)
    lib = _build.load("rebin")
    lib.uammd_rebin_smem.restype = ctypes.c_longlong
    smem = int(lib.uammd_rebin_smem(spec.cap, spec.nlane))
    threads = int(lib.uammd_rebin_threads(spec.nlane))
    check(smem == plan["pull_smem_bytes"] and threads == plan["pull_threads"],
          f"#3 plan: the library's {smem} bytes / {threads} threads == the plan's")
    return plan


def rebin_row(suffix: str, gs, launches: int, what: str, seed: int) -> dict:
    """#3's kernels-line row at ``gs`` (after a sub-drift displacement,
    Q = 7 as every path carries): checked against plain, timed (CUDA events)
    with its plain version, and its byte bound (7 planes in, 7 out)."""
    from uammd_tpu_torch.engine import rebin_kernel as rk

    moved = displaced(gs, seed)
    check_rebin(moved, 7, what)
    stacked = stacked_of(moved, 7)
    kern = rk.make_rebin_kernel(gs.spec)
    err = float((kern(stacked)[0] - rk.rebin_plain(gs.spec, stacked)[0]).abs().max())
    ms = cuda_ms(lambda: kern(stacked), reps=20)
    plain_ms = cuda_ms(lambda: rk.rebin_plain(gs.spec, stacked), reps=3, warmup=1)
    bytes_ms = 1e3 * (2 * 7 * 4 * gs.spec.n_slots + 8) / PEAK_HBM_BYTES
    return {"name": "rebin" + suffix, "route": "cuda",
            "source": "uammd_tpu_torch/engine/csrc/rebin.cu",
            "replaces": "uammd_tpu/engine/rebin_kernel.py:223", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bytes_ms,
            "bound_by": "bytes", "library_ms": None, "shape": list(gs.spec.array_shape),
            "launch_plan": rebin_plan_of(gs.spec)}


def rebin_only(dev, card) -> int:
    """``--only-rebin``: the build, the face checks, #3 against its plain
    version (N 32768 displaced, crammed, NaN) and its rows at the v1, DPD and
    SPH grids (displaced fcc starts: the paths' own specs, not their final
    states); prints no result line."""
    import torch
    from uammd_tpu_torch.engine import layout
    from uammd_tpu_torch.utils.lattices import lattice

    states = face_states(dev)
    faces = rebin_face_checks(states)
    n_small = 32768
    L_small = (n_small / 0.5) ** (1.0 / 3.0)
    pos = lattice(n_small, L_small, "sc")
    gs = layout.pack(layout.choose_spec(L_small, n_small, 2.5, pos=pos), pos, device=dev)
    for q in (7, 10):
        check_rebin(displaced(gs, 11), q, "N=32768 displaced")
    crammed = gs.replace(**{k: torch.where(gs.mask, getattr(gs, k) * (0.1 / L_small),
                                           getattr(gs, k)) for k in ("x", "y", "z")})
    count_c, over_c = check_rebin(crammed, 7, "crammed", expect_clean=False)
    check(over_c > 0 or count_c != n_small, "crammed: rebin latches overflow")
    nan = check_rebin_nan(gs, "N=32768")
    rows = [rebin_row("_" + name.split()[0].lower(), st, 0, f"{name} displaced", 43)
            for name, st in states if st.spec.n_strag == 0]
    sep_checks = sep_rebin_checks(dev)
    from uammd_tpu_torch.engine import rebin_kernel as rk
    from uammd_tpu_torch.integrators.bdhi.pse_engine import PSEGrid

    for name, st in states:
        if st.spec.n_strag:  # #5 at the v2 spec (Q 7) and the PSE near grid (Q 4, OCAP 16)
            moved = displaced(st, 47)
            if name.startswith("PSE"):  # x, y, z and pid + 1, as the PSE step stacks them
                keep = [0, 1, 2, 6]
                stacked = stacked_of(moved, 7)[keep].contiguous()
                strag = strag_stack_of(moved)[keep].contiguous()
                ocap = PSEGrid.NEAR_REBIN_OCAP
            else:
                stacked, strag, ocap = stacked_of(moved, 7), strag_stack_of(moved), rk.OCAP
            rows.append(sep_row("_" + name.split()[0].lower(), st.spec, ocap, stacked, strag, 0,
                                f"{name} displaced"))
    print(json.dumps({"phase": "rebin_only", "card": card, "nan": nan,
                      "faces": list(faces), "sep_rebin_checks": sep_checks, "rows": rows}),
          flush=True)
    return 0

def update_row(engine2, gs2, launches: int) -> dict:
    """#12's kernels-line row at the v2 path's final state: the stacked
    entry as ``GridMD2.step`` calls it (the Newton output buffer as it
    comes), held to its plain version first ("clt" bit-equal, "bm" within
    ``BM_TOL``: ``check_update``), then timed with CUDA events, by the
    profiler (inputs warm, and with the L2 flushed before each call) and
    on the host, with the "bm" update's times beside; the byte bound: 24
    grids read and 6 written, the straggler rows (spos, svel, sforce, spid
    read, spos', svel' written), the seed and the drift."""
    from uammd_tpu_torch.engine import kernel2
    from uammd_tpu_torch.engine import update_kernel as uk

    spec = engine2.spec
    strag = kernel2.broadcast_stragglers(spec, gs2.spos, gs2.spid)
    forces, _ = engine2.pair.stacked(gs2.x, gs2.y, gs2.z, strag)
    home, groups = forces[:3], [forces[3 + 3 * g:6 + 3 * g] for g in range(4)]
    errs = {nz: check_update(gs2, home, groups, nz, f"2^20 v2 liquid ({nz})")
            for nz in uk.NOISES}
    a, grp, ref, step = update_inputs(gs2, home, groups, 31)
    strag2 = (gs2.spos, gs2.svel, gs2.sforce, gs2.spid)  # as GridMD2.step passes them
    n0 = uk.GJ_FOLD_UPDATE.launches
    times = {}
    for nz in uk.NOISES:
        kern = (engine2.update if nz == engine2.noise else uk.make_gj_fold_update_kernel(
            spec, engine2.dt, engine2.temperature, engine2.friction, engine2.mass, noise=nz))

        def call(kern=kern):
            return kern.stacked(*a[:6], forces, *ref, step, strag2)

        times[nz] = {"ms": cuda_ms(call, reps=20),
                     "device_ms_profiler": profiler_ms(call, ["gj_fold_update"]),
                     "device_ms_profiler_cold": profiler_ms(call, ["gj_fold_update"],
                                                            cold=True),
                     "host_us_a_call": host_us(call)}
        for k in ("device_ms_profiler", "device_ms_profiler_cold"):
            device_ms(times[nz][k], f"#12 ({nz}, {k})")
    uk.GJ_FOLD_UPDATE.launches = n0
    plain_ms = cuda_ms(lambda: uk.gj_fold_update_plain(
        spec, engine2.update.coef, engine2.noise, *a, grp, *ref, step, strag2), reps=5, warmup=1)
    S = spec.n_strag
    bytes_ = 4 * 30 * spec.n_slots + 64 * S + 8
    return {"name": "gj_fold_update", "route": "cuda",
            "source": "uammd_tpu_torch/engine/csrc/gj_fold_update.cu (+ gj_common.cuh)",
            "replaces": "uammd_tpu/engine/update_kernel.py:301", "launches": launches,
            "max_abs_err": errs[engine2.noise][0], "ms": times[engine2.noise]["ms"],
            "plain_ms": plain_ms, "bound_ms": 1e3 * bytes_ / PEAK_HBM_BYTES,
            "bound_by": "bytes", "library_ms": None,
            "device_ms_profiler": times[engine2.noise]["device_ms_profiler"],
            "device_ms_profiler_cold": times[engine2.noise]["device_ms_profiler_cold"],
            "host_us_a_call": times[engine2.noise]["host_us_a_call"],
            "noise": engine2.noise, "by_noise": times,
            "max_abs_err_and_drift_err": {k: v[:2] for k, v in errs.items()},
            "shape": list(spec.array_shape), "n_strag": S,
            "launch_plan": update_grid(spec, S),
            "state": "the v2 path's final state, random w and references up to 0.2 away"}


def v2_counters() -> dict:
    from uammd_tpu_torch.engine import kernel2, rebin_kernel, update_kernel

    return {"newton_pair": kernel2.NEWTON_PAIR, "fold": kernel2.FOLD,
            "gj_fold_update": update_kernel.GJ_FOLD_UPDATE,
            "separable_rebin": rebin_kernel.SEP_REBIN}


def main_path_v2(dev, melted, kernels) -> dict:
    """Phase 3b: the v2 path as bench.py:83-91 builds it (n_strag 16,
    "clt", the fast reciprocal) on the melted positions, 100 settle and 200
    timed steps, with the launch counts of ``kernels`` zeroed just before
    it; the gates, then what the breakdown and the rows need."""
    import torch
    from uammd_tpu_torch.engine import layout, md2

    for k in kernels.values():
        k.launches = 0
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
    reads = host_reads(lambda: engine2.step(gs2), 3)
    check(len(reads) <= 3, f"v2 path: {len(reads)} host reads in 3 steps {reads}")
    print(json.dumps({
        "phase": "main_path_v2", "host_reads_per_step": len(reads) / 3, "host_reads_at": reads, "n": N, "box": BOX, "n_strag": N_STRAG, "noise": "clt",
        "fast_recip": True, "spec": list(engine2.spec.array_shape), "cap": engine2.spec.cap,
        "settle_steps": SETTLE_STEPS, "timed_steps": TIMED_STEPS,
        "timed_seconds": timed2_s, "ms_per_step": ms_v2,
        "particle_steps_per_s": N * TIMED_STEPS / timed2_s,
        "temperature": t_meas2, "particles_kept": n_kept2, "stragglers": n_strag_now,
        "overflow": False, "launches": launches_v2, "timed_launches": timed_v2,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }), flush=True)
    return {"engine": engine2, "gs": gs2, "ms": ms_v2, "launches": launches_v2,
            "timed": timed_v2, "stragglers": n_strag_now}


def update_fold_only(dev, card) -> int:
    """``--only-update-fold``: #12's checks (the n 600 straggler system with
    its controls, the 2^20 perturbed fcc state), the v1 melt, the v2 path
    and #12's row at its final state; #9's checks (``pse_kernel_checks``),
    the PSE path and its breakdown; the kernels line of #12, #10 and #9,
    and no result line (for work on those kernels)."""
    import torch
    from uammd_tpu_torch.engine import layout, update_kernel
    from uammd_tpu_torch.utils.lattices import lattice

    rng = torch.Generator().manual_seed(7)
    gs_s, _ = n600_straggler_system(dev, rng)
    home, groups, _ = newton_pair(gs_s)
    errs = {f"n600_{nz}": check_update(gs_s, home, groups, nz, "n 600 stragglers",
                                       controls=nz == "clt") for nz in update_kernel.NOISES}
    pos_fcc = lattice(N, BOX, "fcc")
    spec = layout.choose_spec(BOX, N, 2.5, pos=pos_fcc, n_strag=N_STRAG)
    jitter = torch.randn((N, 3), generator=rng, dtype=torch.float64).numpy() * 0.1
    gs = layout.pack(spec, pos_fcc + jitter, device=dev)
    home, groups, _ = newton_pair(gs)
    for nz in update_kernel.NOISES:
        errs[f"n2^20_{nz}"] = check_update(gs, home, groups, nz, "2^20 perturbed fcc")
    del gs, home, groups, gs_s
    print(json.dumps({"phase": "update_checks", "ok": True,
                      "update_max_abs_err_and_drift_err": errs}), flush=True)
    v2 = main_path_v2(dev, melt(dev), v2_counters())
    rows = [update_row(v2["engine"], v2["gs"], v2["launches"]["gj_fold_update"])]
    del v2
    pse_errs = pse_kernel_checks(dev)
    run = pse_main_path(dev, pse_counters())
    rows += [r for r in pse_breakdown(run, card, pse_errs)
             if r["name"] in ("newton_channel", "fold_n")]
    print(json.dumps({"kernels": rows}), flush=True)
    check(not run["fails"], "; ".join(run["fails"]))
    return 0


# ------------------------------------------------ slice C: the general path
# The README quick start's protocol (README.md:76-98) at the v1 melt's
# final state (N = 2^20, box 128^3, rho 0.5): lj(cutoff=2.5) unshifted in
# float32 over a Verlet list (skin 1.2, then ensure_capacity), stepped by
# nvt_gronbech_jensen at bench.py's dt 0.01 and T 1.5, friction 1.
GEN_CUTOFF, GEN_SKIN, GEN_DT, GEN_FRICTION = 2.5, 1.2, 0.01, 1.0
GEN_SETTLE, GEN_TIMED = 100, 200
GEN_HOST_READ_STEPS = 5
# the general path's forces against #1's by pid: float32 sums in two orders
GEN_FORCE_TOL = 1e-4
# the control's list radius: below the potential's 2.5, so its pairs in
# (2.4, 2.5] are missing
GEN_CONTROL_CUTOFF = 2.4
# particles this close to a face lose their pairs across it on the grid
# path (ROADMAP.md section 3), so they and their partners are left out
GEN_FACE_EPS = 1e-5
# the unshifted LJ force jumps by 0.039 at rc; the two paths round a pair's
# displacement apart by up to an ulp of a box-sized coordinate (7.6e-6 at
# 64), so r2 by up to 2 |dr| sqrt(3) 7.6e-6 = 6.6e-5 at rc: a pair with r2
# this close to rc^2 may be in on one path and out on the other, and its
# two particles are left out
GEN_RC2_WINDOW = 1e-4
GEN_SAMPLE, GEN_SAMPLE_ROWS = 4096, 128
GEN_DENSE_N, GEN_DENSE_TOL = 16384, 1e-5


def general_vs_pair_kernel(dev, b, pot, pos, nl) -> dict:
    """The general path's forces at ``pos`` held by pid against #1's on the
    v1 GridState packed from the same positions (one launch of #1), leaving
    out the particles within ``GEN_FACE_EPS`` of a face and their list
    partners, and the two particles of each pair whose r2 lies within
    ``GEN_RC2_WINDOW`` of rc^2; the control, a list of radius 2.4, must
    fail the bound."""
    import torch
    from uammd_tpu_torch.engine import layout, md, pair_kernel
    from uammd_tpu_torch.interactors.pair import pair_forces
    from uammd_tpu_torch.neighbors.neighbor_list import (build_neighbor_list, ensure_capacity,
                                                         pair_r2)

    n = pos.shape[0]
    pos_np = pos.cpu().numpy()
    spec = layout.choose_spec(BOX, n, GEN_CUTOFF, pos=pos_np)
    gs = layout.pack(spec, pos_np, device=dev)
    check(not bool(gs.overflow), "general vs #1: the v1 pack keeps every particle")
    n0 = pair_kernel.PAIR_FORCE.launches
    fx, fy, fz = pair_kernel.make_pair_force_kernel(spec, md.lj_g())(gs.x, gs.y, gs.z)
    check(pair_kernel.PAIR_FORCE.launches == n0 + 1, "general vs #1: #1 launched once")
    m = gs.pid >= 0
    f1 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    f1[gs.pid[m].long()] = torch.stack([fx[m], fy[m], fz[m]], dim=-1)
    half = torch.tensor([0.5 * x for x in b.lengths], dtype=pos.dtype, device=dev)
    wrapped = b.wrap_position(pos)
    face = ((wrapped.abs() - half).abs() < GEN_FACE_EPS).any(dim=1)
    keep = ~face
    partners = nl.idx[face].long().reshape(-1)
    keep[partners[partners < n]] = False
    _, r2 = pair_r2(b, pos[torch.clamp(nl.idx, max=n - 1).long()], pos[:, None, :])
    rc2_gap = (r2 - GEN_CUTOFF ** 2).abs()
    del r2
    at_rc = (rc2_gap < GEN_RC2_WINDOW) & (nl.idx < n)
    keep &= ~at_rc.any(dim=1)
    f = pair_forces(pot, pos, nl).force
    check(bool(f.isfinite().all()), "general vs #1: forces finite")
    scale = float(f1[keep].abs().max())
    df = torch.where(keep[:, None], (f - f1).abs(), 0.0).amax(dim=1)
    err = float(df.max()) / scale
    w = int(df.argmax())
    worst = {"pid": w, "abs_df": float(df[w]), "f_general": f[w].tolist(),
             "f_pair_force": f1[w].tolist(), "pos": pos[w].tolist(),
             "partners": int((nl.idx[w] < n).sum()),
             "min_abs_r2_minus_rc2": float(rc2_gap[w][nl.idx[w] < n].min())}
    del rc2_gap
    check(err < GEN_FORCE_TOL,
          f"general path vs #1 by pid: max|df| / max|f| = {err:.3g} < {GEN_FORCE_TOL}")
    ctl_nl = ensure_capacity(build_neighbor_list(pos, b, GEN_CONTROL_CUTOFF,
                                                 skin_multiplier=1.0), pos)
    ctl = float((pair_forces(pot, pos, ctl_nl).force - f1)[keep].abs().max()) / scale
    check(ctl >= GEN_FORCE_TOL,
          f"control (a list of radius {GEN_CONTROL_CUTOFF}) fails the check: {ctl:.3g}")
    del ctl_nl, gs
    return {"rel_err": err, "tol": GEN_FORCE_TOL, "control_rel_err": ctl,
            "particles_near_a_face": int(face.sum()),
            "pairs_within_the_rc2_window": int(at_rc.sum()) // 2,
            "rc2_window": GEN_RC2_WINDOW, "particles_left_out": int((~keep).sum()),
            "max_abs_f": scale, "worst": worst, "pair_force_spec": list(spec.array_shape)}


def general_list_checks(dev, b, pos, nl) -> dict:
    """The list against brute force for ``GEN_SAMPLE`` sampled particles
    (the same set of partners within the list radius, the same arithmetic:
    ``neighbor_list.pair_r2``), and the dense NBody path against the list
    path at N = ``GEN_DENSE_N`` (a jittered fcc lattice at rho 0.5)."""
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.interactors.pair import pair_forces
    from uammd_tpu_torch.neighbors.neighbor_list import (build_neighbor_list, ensure_capacity,
                                                         pair_r2)
    from uammd_tpu_torch.potentials.radial import lj
    from uammd_tpu_torch.utils.lattices import lattice

    n = pos.shape[0]
    # the list radius squared, rounded to the positions' dtype as the build rounds it
    rl2 = float(torch.tensor((nl.cutoff * nl.skin_multiplier) ** 2, dtype=pos.dtype))
    gen = torch.Generator(device=dev).manual_seed(17)
    sample = torch.randperm(n, generator=gen, device=dev)[:GEN_SAMPLE]
    wrong = partners = 0
    for lo in range(0, GEN_SAMPLE, GEN_SAMPLE_ROWS):
        rows = sample[lo:lo + GEN_SAMPLE_ROWS]
        _, r2 = pair_r2(b, pos[None, :, :], pos[rows][:, None, :])  # [B, N]
        brute = r2 <= rl2
        brute[torch.arange(rows.shape[0], device=dev), rows] = False
        listed = torch.zeros((rows.shape[0], n + 1), dtype=torch.bool, device=dev)
        listed.scatter_(1, nl.idx[rows].long(), True)
        wrong += int((listed[:, :n] != brute).sum())
        partners += int(brute.sum())
    check(wrong == 0, f"the list against brute force: {wrong} pairs differ over "
                      f"{GEN_SAMPLE} particles")
    L16 = (GEN_DENSE_N / 0.5) ** (1.0 / 3.0)
    rng = torch.Generator().manual_seed(23)
    jit = (torch.rand((GEN_DENSE_N, 3), generator=rng, dtype=torch.float64) - 0.5) * 0.4
    p16 = torch.as_tensor(lattice(GEN_DENSE_N, L16, "fcc") + jit.numpy(), dtype=torch.float32,
                          device=dev)
    b16 = box(L16, device=dev)
    pot = lj(cutoff=GEN_CUTOFF, device=dev)
    nl16 = ensure_capacity(build_neighbor_list(p16, b16, pot.max_cutoff,
                                               skin_multiplier=GEN_SKIN), p16)
    f_list = pair_forces(pot, p16, nl16).force
    f_dense = pair_forces(pot, p16, box=b16).force
    dense_err = float((f_list - f_dense).abs().max() / f_dense.abs().max())
    check(dense_err < GEN_DENSE_TOL,
          f"dense NBody vs list at N = {GEN_DENSE_N}: {dense_err:.3g} < {GEN_DENSE_TOL}")
    return {"sampled": GEN_SAMPLE, "pairs_checked": partners, "pairs_differing": wrong,
            "dense_n": GEN_DENSE_N, "dense_vs_list_rel_err": dense_err,
            "dense_tol": GEN_DENSE_TOL}


def general_path(dev, card, melted) -> dict:
    """Phase 3j: the general path (slice C) as the README quick start runs
    it, on the v1 melt's final state: the build, ``GEN_SETTLE`` settle and
    ``GEN_TIMED`` timed Gronbech-Jensen steps (each ended by a
    synchronize: the median is ms/step), the gates, the checks against #1,
    brute force and the dense path, and each layer timed alone."""
    import dataclasses
    import statistics
    import torch
    from uammd_tpu_torch import box, make_state
    from uammd_tpu_torch.core.grid import Grid
    from uammd_tpu_torch.integrators.base import run, temperature
    from uammd_tpu_torch.integrators.verlet import nvt_gronbech_jensen
    from uammd_tpu_torch.interactors.pair import pair_forces
    from uammd_tpu_torch.neighbors.cell_list import build_cell_list
    from uammd_tpu_torch.neighbors.neighbor_list import (
        build_neighbor_list, ensure_capacity, maybe_rebuild, rebuild_neighbor_list)
    from uammd_tpu_torch.potentials.radial import lj

    torch.cuda.empty_cache()
    n = melted.shape[0]
    b = box(BOX, device=dev)
    st = make_state(melted, seed=0, device=dev)
    pot = lj(cutoff=GEN_CUTOFF, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nl = build_neighbor_list(st.pos, b, pot.max_cutoff, skin_multiplier=GEN_SKIN)
    nl = ensure_capacity(nl, st.pos)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    check(not bool(nl.overflow), "general path: the first list does not overflow")
    vs1 = general_vs_pair_kernel(dev, b, pot, st.pos, nl)
    lists = general_list_checks(dev, b, st.pos, nl)
    rebuilt = [0]

    def forces(state, nbrs):
        new = maybe_rebuild(nbrs, state.pos)
        rebuilt[0] += new is not nbrs
        return pair_forces(pot, state.pos, new), new

    integ = nvt_gronbech_jensen(forces, dt=GEN_DT, temperature=TEMPERATURE,
                                friction=GEN_FRICTION)
    # every kernel's count, zeroed just before the path: it launches none
    counted = {**v2_counters(), **unfused_counters(), **dd_counters(), **pse_counters()}
    for k in counted.values():
        k.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st, nl, _ = run(integ, st, nl, GEN_SETTLE)
    torch.cuda.synchronize()
    settle_rebuilds = rebuilt[0]
    per_step = []
    t_all = time.perf_counter()
    for _ in range(GEN_TIMED):
        t0 = time.perf_counter()
        st, nl = integ.step(st, nl)
        torch.cuda.synchronize()
        per_step.append(1e3 * (time.perf_counter() - t0))
    timed_s = time.perf_counter() - t_all
    timed_rebuilds = rebuilt[0] - settle_rebuilds
    launches = {k: v.launches for k, v in counted.items()}
    t_meas = float(temperature(st))
    check(not bool(nl.overflow), "general path: no overflow")
    check(all(bool(a.isfinite().all()) for a in (st.pos, st.vel, st.force)),
          "general path: pos, vel and force finite")
    check(math.isfinite(t_meas) and abs(t_meas - TEMPERATURE) < 0.2 * TEMPERATURE,
          f"general path: temperature {t_meas:.4f} within 20 % of {TEMPERATURE}")
    check(timed_rebuilds >= 1, f"general path: {timed_rebuilds} rebuilds in the timed steps")
    holder = [st, nl]

    def step():
        holder[0], holder[1] = integ.step(holder[0], holder[1])

    reads = host_reads(step, GEN_HOST_READ_STEPS)
    # and a step that rebuilds: the list's reference moved past the skin
    holder[1] = dataclasses.replace(holder[1], ref_pos=holder[1].ref_pos + 1.0)
    n_before = rebuilt[0]
    reads_rebuild = host_reads(step, 1)
    check(rebuilt[0] == n_before + 1, "general path: the forced step rebuilt its list")
    check(len(reads) == GEN_HOST_READ_STEPS and len(reads_rebuild) == 1,
          f"general path: one host read a step ({reads}; a rebuilding step: {reads_rebuild})")
    st, nl = holder
    peak = torch.cuda.max_memory_allocated()
    # each layer alone at the final state (CUDA events)
    grid = Grid(box=b, shape=nl.grid_shape)
    fev = pair_forces(pot, st.pos, nl)
    layers = {
        "cell_list_ms": cuda_ms(lambda: build_cell_list(st.pos, grid, nl.cell_capacity),
                                reps=10),
        "rebuild_ms": cuda_ms(lambda: rebuild_neighbor_list(nl, st.pos), reps=5, warmup=1),
        "apply_pairs_lj_ms": cuda_ms(lambda: pair_forces(pot, st.pos, nl), reps=10),
        "drift_test_ms": cuda_ms(lambda: nl.needs_rebuild(st.pos), reps=20),
        "drift_read_host_us": host_us(lambda: bool(nl.needs_rebuild(st.pos)), n=20),
        "gj_update_ms": cuda_ms(lambda: nvt_gronbech_jensen(
            lambda s, a: (fev, a), dt=GEN_DT, temperature=TEMPERATURE,
            friction=GEN_FRICTION).step(st, nl), reps=20),
    }
    med = statistics.median(per_step)
    out = {
        "phase": "general_path", "card": card, "n": n, "box": BOX, "potential":
        "lj(cutoff=2.5), unshifted, float32", "integrator":
        f"nvt_gronbech_jensen(dt={GEN_DT}, temperature={TEMPERATURE}, "
        f"friction={GEN_FRICTION})", "settle_steps": GEN_SETTLE, "timed_steps": GEN_TIMED,
        "grid_shape": list(nl.grid_shape), "cell_capacity": nl.cell_capacity,
        "max_neighbors": nl.max_neighbors, "build_ms": build_ms,
        "ms_per_step": med, "ms_per_step_mean": 1e3 * timed_s / GEN_TIMED,
        "ms_per_step_quartiles": statistics.quantiles(per_step, n=4),
        "particle_steps_per_s": n * GEN_TIMED / timed_s,
        "rebuilds_settle": settle_rebuilds, "rebuilds_timed": timed_rebuilds,
        "ms_per_rebuild": layers["rebuild_ms"], "layers": layers,
        "temperature": t_meas, "overflow": False,
        "host_reads_per_step": len(reads) / GEN_HOST_READ_STEPS, "host_reads_at": reads,
        "host_reads_rebuilding_step": reads_rebuild,
        "peak_memory_gib": peak / 2**30, "kernel_launches": launches,
        "vs_pair_force_kernel": vs1, "list_checks": lists,
        "note": "ms_per_step: the median of the timed steps, each ended by "
                "torch.cuda.synchronize(); the path runs no hand kernel (the JAX general "
                "path has no pallas_call), #1 is launched once as the forces' yardstick",
    }
    print(json.dumps(out), flush=True)
    return out


def general_only(dev, card) -> int:
    """``--only-general``: the v1 melt and the general path alone; prints
    no result line."""
    general_path(dev, card, melt(dev))
    return 0


# ---------------------------------------- slice C2: BDHI over lists, SPH, Deserno
# The list PSE on bench.py:116-123's system (pse_box_and_fcc: N = 131072,
# volume fraction 0.05, radius 1, fcc start): WCA between surfaces over a
# Verlet list, bdhi_euler_maruyama over PSE.create(tolerance=1e-4) at the
# PSE path's dt and T; C2_WARM settle and C2_TIMED timed steps, each ended
# by a synchronize (ms/step: their median).
C2_WARM, C2_TIMED = 5, 20
C2_HOST_READ_STEPS = 3
# the list PSE's M F against the grid engine's (PSEGrid at T = 0) at the
# fcc state: RMS of the difference over RMS of the grid's, the grid PSE
# path's split bar (both approximate the periodic RPY mobility, pair by
# pair, to ~1e-4 m0; a random force sums their differences over many
# neighbours)
C2_MF_RMS = SPLIT_RMS
# Dense RPY (open boundaries) from an fcc start at volume fraction 0.05
DENSE_N_CHOL, DENSE_N_LANCZOS = 2048, 8192
DENSE_WARM, DENSE_TIMED = 3, 10
DENSE_MF_TOL = 1e-5  # Cholesky's M F against Lanczos' matrix-free one, x max
# Lanczos M^(1/2) z (m = 24) against the symmetric root from eigh (float64),
# |d| / |ref|: float32 round-off once converged; m = 2 is far from converged
LANCZOS_ROOT_TOL = 1e-4
QUAT_TOL = 1e-5
# list SPH against GridSPH's two #2 sweeps, by pid: max|df| over the
# largest sum_j |term_ij| (the pressure terms of a uniform bulk cancel);
# float32 in two summation orders and two roundings of r_j - r_i
SPH_LIST_SKIN = 1.3  # examples/dambreak.py
SPH_LIST_TOL = 1e-4
SPH_EDGE_WINDOW = 1e-4  # pairs with |r2 - (2h)^2| below it are left out
# Deserno: build_bilayer(64) (8192 lipids, 24576 beads) in [L, L, 6L],
# leimkuhler at tests/test_support_subsystems.py:140's dt and T
DESERNO_SIDE, DESERNO_DT, DESERNO_T = 64, 2e-4, 0.9
DESERNO_WARM, DESERNO_TIMED = 20, 100
DESERNO_DENSE_SIDE, DESERNO_DENSE_TOL = 16, 1e-5
# the auto dispatch's tiled branch: a 36^3 grid (36 % 8 != 0: no pencils;
# tile 4) at N = 8192
TILED_M, TILED_N = 36, 8192


def c2_counters() -> dict:
    from uammd_tpu_torch.solvers import lanczos, pencil_ibm

    return {"pencil_spread": pencil_ibm.SPREAD, "pencil_interp": pencil_ibm.INTERP,
            "lanczos_sqrt": lanczos.LANCZOS_SQRT}


@contextlib.contextmanager
def plain_pencils():
    """FCM's spread and interpolation through the plain versions of #13/#14
    on CUDA tensors, for the length of the block."""
    from uammd_tpu_torch.integrators.bdhi import fcm
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    saved = fcm.spread_pencil_fused, fcm.interpolate_pencil_fused
    fcm.spread_pencil_fused = tp.spread_pencil_fused_plain
    fcm.interpolate_pencil_fused = tp.interpolate_pencil_fused_plain
    try:
        yield
    finally:
        fcm.spread_pencil_fused, fcm.interpolate_pencil_fused = saved


def timed_steps(step, holder, warm: int, timed: int):
    """``warm`` then ``timed`` calls of ``step(holder)``, each timed one
    ended by a synchronize: (per-step ms list, timed seconds)."""
    import torch

    for _ in range(warm):
        step(holder)
    torch.cuda.synchronize()
    per = []
    t_all = time.perf_counter()
    for _ in range(timed):
        t0 = time.perf_counter()
        step(holder)
        torch.cuda.synchronize()
        per.append(1e3 * (time.perf_counter() - t0))
    return per, time.perf_counter() - t_all


def step_stats(per) -> dict:
    import statistics

    return {"ms_per_step": statistics.median(per), "ms_per_step_mean": sum(per) / len(per),
            "ms_per_step_quartiles": statistics.quantiles(per, n=4)}


def pencil_cold_rows(rows, kern, pos, vals, field, shape, b, bins, slack=0):
    """Add the profiler's device time with the L2 flushed to the two rows
    ``pencil_rows`` made."""
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    calls = (lambda: tp.spread_pencil_fused(kern, pos, vals, shape, b, bins, slack=slack),
             lambda: tp.interpolate_pencil_fused(kern, pos, field, b, bins, slack=slack))
    n0 = tp.SPREAD.launches, tp.INTERP.launches
    for row, call, name in zip(rows, calls, ("spread_kernel", "interp_kernel")):
        row["device_ms_profiler_cold"] = profiler_ms(call, [name], cold=True)
        device_ms(row["device_ms_profiler_cold"], row["name"])
    tp.SPREAD.launches, tp.INTERP.launches = n0
    return rows


def list_pse_path(dev, card, grid_be=None) -> list:
    """Phase 3k: the list PSE (slice C2's path) at full size, its gates and
    layers, and #13/#14's rows at its far grid; ``grid_be`` the PSE path's
    PSEGrid (made here from the fcc state if None)."""
    import torch
    from uammd_tpu_torch.core.state import make_state
    from uammd_tpu_torch.integrators.bdhi.euler_maruyama import bdhi_euler_maruyama
    from uammd_tpu_torch.integrators.bdhi.pse import PSE
    from uammd_tpu_torch.interactors.pair import pair_forces
    from uammd_tpu_torch.neighbors.neighbor_list import (build_neighbor_list, ensure_capacity,
                                                         maybe_rebuild)
    from uammd_tpu_torch.potentials.radial import wca as radial_wca
    from uammd_tpu_torch.solvers import pencil_ibm as tp
    from uammd_tpu_torch.solvers.lanczos import lanczos_sqrt_apply

    torch.cuda.empty_cache()
    b, pos = pse_box_and_fcc(dev)
    t0 = time.perf_counter()
    pse = PSE.create(b, 1.0, 1.0, tolerance=PSE_TOLERANCE)
    create_s = time.perf_counter() - t0
    far = pse.far
    check(far.pencil_bins(pos) is not None, "list PSE: the far field takes the pencil path")
    gen_f = torch.Generator(device=dev).manual_seed(5)
    F = torch.randn(pos.shape, generator=gen_f, device=dev)
    # gate 1: M F against the grid engine's deterministic displacement
    if grid_be is None:
        grid_be = pse_backend(b, pos)
    d0, ovf = grid_be.displacement(pos, F, gen_f, PSE_DT, 0.0)
    check(not bool(ovf), "list PSE gate 1: the grid engine does not overflow at the fcc state")
    m_grid = d0 / PSE_DT
    m_list = pse.compute_mf(pos, F)

    def rms_rel(x):
        return float(((x - m_grid) ** 2).mean().sqrt() / (m_grid ** 2).mean().sqrt())

    mf_rms = rms_rel(m_list)
    mf_max = float((m_list - m_grid).abs().max() / m_grid.abs().max())
    ctl_rms = rms_rel(far.compute_mf(pos, F))  # the control: near field dropped
    check(mf_rms < C2_MF_RMS, f"list PSE vs PSEGrid at T = 0: RMS {mf_rms:.3g} < {C2_MF_RMS}")
    check(ctl_rms >= C2_MF_RMS, f"control (list PSE without near_matvec) fails the bound: "
                                f"RMS {ctl_rms:.3g}")
    del d0, m_grid, m_list

    pot = radial_wca(1.0, 2.0, device=dev)
    wnl = ensure_capacity(build_neighbor_list(pos, b, pot.max_cutoff), pos)
    check(not bool(wnl.overflow), "list PSE: the WCA list does not overflow")

    def forces(state, nbrs):
        nbrs = maybe_rebuild(nbrs, state.pos)
        return pair_forces(pot, state.pos, nbrs), nbrs

    integ = bdhi_euler_maruyama(forces, pse, dt=PSE_DT, temperature=PSE_T)
    counted = c2_counters()
    for k in counted.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    st, aux = integ.init(make_state(pos, seed=3, device=dev), wnl)
    holder = [st, aux]

    def step(h):
        h[0], h[1] = integ.step(h[0], h[1])

    for _ in range(C2_WARM):
        step(holder)
    p0 = holder[0].pos.clone()
    per, timed_s = timed_steps(step, holder, 0, C2_TIMED)
    launches = {k: v.launches for k, v in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    st, wnl = holder
    check(bool(st.pos.isfinite().all()), "list PSE path: positions finite")
    check(not bool(wnl.overflow), "list PSE path: no WCA list overflow")
    steps = C2_WARM + C2_TIMED
    # compute_mf spreads and interpolates once, compute_bdw interpolates once
    # (far noise) and runs one Lanczos sqrt (the near noise)
    per_step_min = {"pencil_spread": 1, "pencil_interp": 2, "lanczos_sqrt": 1}
    for k, need in per_step_min.items():
        check(launches[k] >= need * steps,
              f"list PSE path: {k} launched {launches[k]} >= {need} x {steps} times")
    # gate 2: self-diffusion over the timed steps (no force acts: WCA is zero
    # at these separations, so the displacement is the noise alone)
    m_self = hashimoto_mobility_at(PSE_L)
    msd = ((st.pos - p0).double() ** 2).mean(0)
    want = 2.0 * PSE_T * PSE_DT * C2_TIMED * m_self
    fdt = [float(x) / want - 1.0 for x in msd]
    check(all(abs(x) < FDT_TOL for x in fdt),
          f"list PSE path: mean square displacement per axis {[float(x) for x in msd]} within "
          f"{FDT_TOL:.0%} of 2 T dt steps m_self = {want:.6g}")
    reads = host_reads(lambda: step(holder), C2_HOST_READ_STEPS)
    st, wnl = holder
    # each layer alone at the final state (CUDA events)
    nl = build_neighbor_list(st.pos, b, pse.rcut)  # PSE's own near list
    z = torch.randn(3 * PSE_N, generator=gen_f, device=dev)

    def near_mv(x):
        return pse.near_matvec(st.pos, x.reshape(-1, 3), nl).reshape(-1)

    n0 = {k: v.launches for k, v in counted.items()}
    layers = {
        "list_build_ms": cuda_ms(lambda: build_neighbor_list(st.pos, b, pse.rcut), reps=5),
        "far_compute_mf_ms": cuda_ms(lambda: far.compute_mf(st.pos, F), reps=5),
        "near_matvec_ms": cuda_ms(lambda: pse.near_matvec(st.pos, F, nl), reps=10),
        "near_lanczos_ms": cuda_ms(lambda: lanczos_sqrt_apply(near_mv, z,
                                                              m=pse.lanczos_iterations), reps=3),
        "far_noise_ms": cuda_ms(lambda: far.compute_bdw(st.pos, st.gen), reps=5),
        "wca_ms": cuda_ms(lambda: pair_forces(pot, st.pos, wnl), reps=10),
    }
    for k, v in counted.items():
        v.launches = n0[k]
    calls = {"list_build_ms": 2}
    split = {k: v * calls.get(k, 1) for k, v in layers.items()}
    stats = step_stats(per)
    # #13/#14 at the path's far grid and Gaussian, against plain, with controls
    kern = far._kernel(st.pos.dtype)
    bins = far.pencil_bins(st.pos)
    n1 = tp.SPREAD.launches, tp.INTERP.launches
    _, _, f_p, v_p = check_pencil(kern, st.pos, F, far.shape, b, bins, 0, "list PSE far field")
    ctl = check_pencil_controls(kern, st.pos, F, far.shape, b, bins, 0, f_p, v_p,
                                "list PSE far field")
    u = far._irfftn(far._mobility_k(torch.fft.rfftn(f_p, dim=(0, 1, 2)), st.pos))
    tp.SPREAD.launches, tp.INTERP.launches = n1
    rows = pencil_rows("_list_pse", "list PSE far field", kern, st.pos, F, u, far.shape, b,
                       bins, 0, launches)
    pencil_cold_rows(rows, kern, st.pos, F, u, far.shape, b, bins)
    tp.SPREAD.launches, tp.INTERP.launches = n1
    print(json.dumps({
        "phase": "list_pse_path", "card": card, "n": PSE_N, "box": PSE_L,
        "volume_fraction": PSE_PHI, "dt": PSE_DT, "temperature": PSE_T,
        "settle_steps": C2_WARM, "timed_steps": C2_TIMED, "create_seconds": create_s,
        "xi": pse.xi, "rcut": pse.rcut, "self_f": pse.self_f,
        "lanczos_m": pse.lanczos_iterations, "far_shape": list(far.shape),
        "far_support": far.support, "far_sigma_over_h": kern.sigma,
        "near_max_neighbors": nl.max_neighbors, "near_grid": list(nl.grid_shape),
        "wca_max_neighbors": wnl.max_neighbors, **stats,
        "timed_seconds": timed_s, "particle_steps_per_s": PSE_N * C2_TIMED / timed_s,
        "layers_ms_a_call": layers, "layers_ms_a_step": split,
        "rest_ms": stats["ms_per_step"] - sum(split.values()),
        "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
        "host_reads_per_step": len(reads) / C2_HOST_READ_STEPS, "host_reads_at": reads,
        "mf_vs_pse_grid_rms": mf_rms, "mf_vs_pse_grid_max": mf_max, "mf_rms_tol": C2_MF_RMS,
        "control_far_only_rms": ctl_rms, "msd_per_axis": [float(x) for x in msd],
        "msd_want": want, "fdt_rel_err": fdt, "m_self": m_self,
        "pencil_controls": ctl, "peak_memory_gib": peak / 2 ** 30,
        "note": "ms_per_step: the median of the timed steps, each ended by "
                "torch.cuda.synchronize(); layers timed alone at the final state; a step "
                "builds the near list twice (compute_mf, compute_bdw), as JAX's"}), flush=True)
    return rows


def dense_rpy_path(dev, card) -> dict:
    """Phase 3l: CholeskyBDHI at DENSE_N_CHOL and LanczosBDHI at
    DENSE_N_LANCZOS from fcc at volume fraction 0.05 (open boundaries, WCA
    over a list), DENSE_WARM + DENSE_TIMED steps at T 1; the checks at
    DENSE_N_CHOL."""
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.core.state import make_state
    from uammd_tpu_torch.integrators.bdhi.euler_maruyama import (CholeskyBDHI, LanczosBDHI,
                                                                 bdhi_euler_maruyama)
    from uammd_tpu_torch.integrators.bdhi.rpy import dense_mobility
    from uammd_tpu_torch.interactors.pair import pair_forces
    from uammd_tpu_torch.neighbors.neighbor_list import (build_neighbor_list, ensure_capacity,
                                                         maybe_rebuild)
    from uammd_tpu_torch.potentials.radial import wca as radial_wca
    from uammd_tpu_torch.solvers.lanczos import lanczos_sqrt_apply
    from uammd_tpu_torch.utils.lattices import lattice

    torch.cuda.empty_cache()
    pot = radial_wca(1.0, 2.0, device=dev)
    out = {"phase": "dense_rpy_path", "card": card, "settle_steps": DENSE_WARM,
           "timed_steps": DENSE_TIMED, "dt": PSE_DT, "temperature": PSE_T}
    for name, backend, n in (("cholesky", CholeskyBDHI(), DENSE_N_CHOL),
                             ("lanczos", LanczosBDHI(), DENSE_N_LANCZOS)):
        L = (n * (4.0 / 3.0) * math.pi / PSE_PHI) ** (1.0 / 3.0)
        b = box(L, device=dev)
        pos = torch.tensor(lattice(n, L, "fcc"), dtype=torch.float32, device=dev)
        nl = ensure_capacity(build_neighbor_list(pos, b, pot.max_cutoff), pos)

        def forces(state, nbrs):
            nbrs = maybe_rebuild(nbrs, state.pos)
            return pair_forces(pot, state.pos, nbrs), nbrs

        integ = bdhi_euler_maruyama(forces, backend, dt=PSE_DT, temperature=PSE_T)
        holder = list(integ.init(make_state(pos, seed=4, device=dev), nl))

        def step(h):
            h[0], h[1] = integ.step(h[0], h[1])

        torch.cuda.reset_peak_memory_stats()
        per, _ = timed_steps(step, holder, DENSE_WARM, DENSE_TIMED)
        check(bool(holder[0].pos.isfinite().all()), f"dense RPY ({name}): positions finite")
        out[name] = {"n": n, "box": L, **step_stats(per),
                     "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    # the checks at DENSE_N_CHOL
    n = DENSE_N_CHOL
    L = (n * (4.0 / 3.0) * math.pi / PSE_PHI) ** (1.0 / 3.0)
    pos = torch.tensor(lattice(n, L, "fcc"), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    f = torch.randn((n, 3), generator=gen, device=dev)
    chol, lan = CholeskyBDHI(), LanczosBDHI()
    a, c = chol.compute_mf(pos, f), lan.compute_mf(pos, f)
    mf_err = float((a - c).abs().max() / a.abs().max())
    check(mf_err < DENSE_MF_TOL, f"dense RPY: Cholesky vs Lanczos M F {mf_err:.3g} < "
                                 f"{DENSE_MF_TOL}")
    z = torch.randn(3 * n, generator=gen, device=dev)
    ev, V = torch.linalg.eigh(dense_mobility(pos.double()))
    ref = V @ (torch.sqrt(torch.clamp(ev, min=0.0)) * (V.T @ z.double()))

    def mv(x):
        return lan.compute_mf(pos, x.reshape(-1, 3)).reshape(-1)

    root = {}
    for m in (lan.iterations, 2):
        got, _ = lanczos_sqrt_apply(mv, z, m=m)
        root[m] = float((got.double() - ref).norm() / ref.norm())
    check(root[lan.iterations] < LANCZOS_ROOT_TOL,
          f"dense RPY: Lanczos M^(1/2) z (m {lan.iterations}) vs eigh {root[lan.iterations]:.3g} "
          f"< {LANCZOS_ROOT_TOL}")
    check(root[2] >= LANCZOS_ROOT_TOL, f"control (m 2) fails the bound: {root[2]:.3g}")
    out.update({"check_n": n, "mf_cholesky_vs_lanczos": mf_err, "mf_tol": DENSE_MF_TOL,
                "lanczos_root_vs_eigh": {f"m{k}": v for k, v in root.items()},
                "lanczos_root_tol": LANCZOS_ROOT_TOL,
                "mobility_eigenvalues": [float(ev.min()), float(ev.max())]})
    print(json.dumps(out), flush=True)
    return out


def rotational_fcm_path(dev, card) -> list:
    """Phase 3m: bdhi_fcm_rotational on the FCM path's suspension with
    seeded forces and torques at T = FCM_T, C2_WARM + C2_TIMED steps; the
    gates; one torqued particle's rotational self-mobility; #13/#14's rows
    for the force and torque passes."""
    import torch
    from uammd_tpu_torch.core.state import make_state
    from uammd_tpu_torch.integrators.bdhi.rotational import bdhi_fcm_rotational
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    torch.cuda.empty_cache()
    b, fcm, pos = fcm_setup(dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(7)
    F = torch.randn(pos.shape, generator=gen, device=dev)
    T = torch.randn(pos.shape, generator=gen, device=dev)

    def force_torque(state, aux):
        return F, T, aux

    integ = bdhi_fcm_rotational(force_torque, fcm, dt=FCM_DT, temperature=FCM_T)
    counted = c2_counters()
    for k in counted.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    holder = list(integ.init(make_state(pos, seed=2, device=dev), None))

    def step(h):
        h[0], h[1] = integ.step(h[0], h[1])

    per, timed_s = timed_steps(step, holder, C2_WARM, C2_TIMED)
    launches = {k: v.launches for k, v in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    st = holder[0]
    steps = C2_WARM + C2_TIMED
    check(bool(st.pos.isfinite().all() and st.dir.isfinite().all()),
          "rotational FCM: pos and dir finite")
    qerr = float((torch.linalg.vector_norm(st.dir, dim=1) - 1.0).abs().max())
    check(qerr < QUAT_TOL, f"rotational FCM: max ||q| - 1| = {qerr:.3g} < {QUAT_TOL}")
    # force and torque spread once each, u and (1/2) curl u interpolated once each
    for k in ("pencil_spread", "pencil_interp"):
        check(launches[k] >= 2 * steps,
              f"rotational FCM: {k} launched {launches[k]} >= 2 x {steps} times")
    # T = 0 through the kernels against the same call through the plain versions
    v_k, w_k = fcm.compute_hydrodynamic_displacements(st.pos, F, T)
    with plain_pencils():
        v_p, w_p = fcm.compute_hydrodynamic_displacements(st.pos, F, T)
    t0_err = {"v": rel_err(v_k, v_p), "omega": rel_err(w_k, w_p)}
    check(all(math.isfinite(e) and e <= PENCIL_TOL for e in t0_err.values()),
          f"rotational FCM at T = 0: kernels vs plain pencils {t0_err} <= {PENCIL_TOL}")
    # one torqued particle: omega / tau against 1/(8 pi eta a^3); the
    # periodic correction -1/(6 eta L^3) is printed beside it
    e = torch.zeros_like(st.pos)
    e[0, 2] = 1.0
    _, w1 = fcm.compute_hydrodynamic_displacements(st.pos, torch.zeros_like(st.pos), e)
    mu_r = float(w1[0, 2])
    mu_r0 = 1.0 / (8.0 * math.pi)
    # #13/#14 rows: the force pass (monopole Gaussian) and the torque pass
    # (rotlet Gaussian) at the path's final state
    kern, kern_t = fcm._kernel(), fcm._kernel_torque()
    bins = fcm.pencil_bins(st.pos)
    sp, _ = fcm._spread_interp(st.pos, bins)
    fk = (torch.fft.rfftn(sp(kern, st.pos, F), dim=(0, 1, 2))
          + fcm._curl_half(torch.fft.rfftn(sp(kern_t, st.pos, T), dim=(0, 1, 2)), st.pos))
    uk = fcm._mobility_k(fk, st.pos)
    w_field = fcm._irfftn(fcm._curl_half(uk, st.pos))
    u_field = fcm._irfftn(uk)
    n1 = tp.SPREAD.launches, tp.INTERP.launches
    rows = []
    for suffix, what, kn, vals, field in (
            ("_rot_force", "rotational FCM force pass", kern, F, u_field),
            ("_rot_torque", "rotational FCM torque pass", kern_t, T, w_field)):
        r = pencil_rows(suffix, what, kn, st.pos, vals, field, fcm.shape, b, bins, 0, launches)
        rows += pencil_cold_rows(r, kn, st.pos, vals, field, fcm.shape, b, bins)
    for r in rows:
        r["note"] = "launches: the path's count of the kernel, force and torque passes together"
    tp.SPREAD.launches, tp.INTERP.launches = n1
    print(json.dumps({
        "phase": "rotational_fcm_path", "card": card, "n": FCM_N, "box": FCM_L,
        "shape": list(fcm.shape), "support": fcm.support, "sigma_over_h": kern.sigma,
        "sigma_torque_over_h": kern_t.sigma, "dt": FCM_DT, "temperature": FCM_T,
        "settle_steps": C2_WARM, "timed_steps": C2_TIMED, **step_stats(per),
        "timed_seconds": timed_s, "launches": launches,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "max_abs_norm_q_minus_1": qerr, "t0_kernels_vs_plain": t0_err,
        "rotational_self_mobility": mu_r, "one_over_8_pi": mu_r0,
        "rel_diff": mu_r / mu_r0 - 1.0, "periodic_correction": -1.0 / (6.0 * FCM_L ** 3),
        "peak_memory_gib": peak / 2 ** 30}), flush=True)
    return rows


def list_sph_path(dev, card, sph_final) -> dict:
    """Phase 3n: the list SPH against GridSPH's two #2 sweeps at the grid
    SPH path's final state (``sph_final``: (GridSPH, GridState)), by pid;
    then make_sph_force_fn under nve, C2_WARM + C2_TIMED steps."""
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.core.state import make_state
    from uammd_tpu_torch.engine import layout, pair_kernel
    from uammd_tpu_torch.integrators.verlet import nve
    from uammd_tpu_torch.interactors.sph import (SPHParams, cubic_spline_gradw_over_r,
                                                 make_sph_force_fn, sph_density, sph_forces)
    from uammd_tpu_torch.neighbors.neighbor_list import (build_neighbor_list, ensure_capacity,
                                                         pair_r2)
    from uammd_tpu_torch.neighbors.pair_map import apply_pairs

    torch.cuda.empty_cache()
    md, gs = sph_final
    params = SPHParams(**SPH_KW)
    pos, vel, _ = layout.unpack(gs)
    n = pos.shape[0]
    mass = torch.full((n,), md.mass, dtype=pos.dtype, device=dev)
    b = box(SPH_L, device=dev)
    t0 = time.perf_counter()
    nl = ensure_capacity(build_neighbor_list(pos, b, params.max_cutoff,
                                             skin_multiplier=SPH_LIST_SKIN), pos)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    check(not bool(nl.overflow), "list SPH: the list does not overflow")
    # #2's two sweeps at the same state (one launch each), by pid
    n0 = (pair_kernel.PAIR_CHANNEL_SPH_DENSITY.launches,
          pair_kernel.PAIR_CHANNEL_SPH_FORCE.launches)
    fx, fy, fz = md.compute_forces(gs, gs.vx, gs.vy, gs.vz)
    check((pair_kernel.PAIR_CHANNEL_SPH_DENSITY.launches - n0[0],
           pair_kernel.PAIR_CHANNEL_SPH_FORCE.launches - n0[1]) == (1, 1),
          "list SPH check: #2's density and force sweeps launched once each")
    m = gs.pid >= 0
    f2 = torch.zeros((n, 3), dtype=pos.dtype, device=dev)
    f2[gs.pid[m].long()] = torch.stack([fx[m], fy[m], fz[m]], dim=-1)
    f_list = sph_forces(params, pos, vel, mass, nl).force
    check(bool(f_list.isfinite().all()), "list SPH: forces finite")
    # the scale: each particle's sum_j |term_ij| (pressure terms cancel in a bulk)
    rho = sph_density(params, pos, mass, nl)
    pdr = params.gas_stiffness * (rho - params.rest_density) / (rho * rho)
    h = params.support

    def abs_terms(r2, dr, ii, jj):
        (pi_, vi, mi), (pj_, vj, mj) = ii, jj
        inside = (r2 < (2.0 * h) ** 2) & (r2 > 1e-12)
        visc = -params.viscosity * torch.sum((vi - vj) * (-dr), dim=-1) / (r2 + 1e-3)
        g = (mi * mj * (pi_ + pj_ + visc) * cubic_spline_gradw_over_r(r2, h)).abs()
        return {"s": torch.where(inside, g * torch.sqrt(r2), 0.0)}

    scale = float(apply_pairs(lambda r2, dr, ii, jj, idx: abs_terms(r2, dr, ii, jj), nl, pos,
                              info=(pdr, vel, mass))["s"].max())
    # left out: particles within 1e-5 of a face and their partners (the grid
    # rebin's property, ROADMAP.md section 3), and both particles of each pair
    # at the support's edge, where the two paths' r2 may fall either side
    half = torch.tensor([0.5 * x for x in b.lengths], dtype=pos.dtype, device=dev)
    face = ((b.wrap_position(pos).abs() - half).abs() < GEN_FACE_EPS).any(dim=1)
    keep = ~face
    partners = nl.idx[face].long().reshape(-1)
    keep[partners[partners < n]] = False
    _, r2 = pair_r2(b, pos[torch.clamp(nl.idx, max=n - 1).long()], pos[:, None, :])
    edge = ((r2 - (2.0 * h) ** 2).abs() < SPH_EDGE_WINDOW) & (nl.idx < n)
    del r2
    keep &= ~edge.any(dim=1)
    err = float(torch.where(keep[:, None], (f_list - f2).abs(), 0.0).max()) / scale
    check(err < SPH_LIST_TOL, f"list SPH vs #2 by pid: max|df| / max sum|term| = {err:.3g} "
                              f"< {SPH_LIST_TOL}")
    ctl_params = SPHParams(**{**SPH_KW, "viscosity": 0.0})  # the control: no viscosity
    ctl = float(torch.where(keep[:, None], (sph_forces(ctl_params, pos, vel, mass, nl).force
                                            - f2).abs(), 0.0).max()) / scale
    check(ctl >= SPH_LIST_TOL, f"control (the list SPH without viscosity) fails: {ctl:.3g}")
    # the path: make_sph_force_fn under nve
    integ = nve(make_sph_force_fn(params), dt=SPH_DT)
    counted = {**c2_counters(), "pair_channel_sph_density": pair_kernel.PAIR_CHANNEL_SPH_DENSITY,
               "pair_channel_sph_force": pair_kernel.PAIR_CHANNEL_SPH_FORCE}
    for k in counted.values():
        k.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    holder = list(integ.init(make_state(pos, vel=vel, mass=mass, seed=8, device=dev), nl))

    def step(hh):
        hh[0], hh[1] = integ.step(hh[0], hh[1])

    per, timed_s = timed_steps(step, holder, C2_WARM, C2_TIMED)
    peak = torch.cuda.max_memory_allocated()
    st, nl2 = holder
    check(bool(st.pos.isfinite().all() and st.vel.isfinite().all()), "list SPH path: finite")
    check(not bool(nl2.overflow), "list SPH path: no list overflow")
    mom = float(torch.linalg.vector_norm((st.vel * mass[:, None]).double().sum(0))) / n
    check(mom < MOMENTUM_TOL, f"list SPH path: |total momentum| / N = {mom:.3g} < {MOMENTUM_TOL}")
    out = {"phase": "list_sph_path", "card": card, "n": n, "box": SPH_L, **SPH_KW,
           "skin": SPH_LIST_SKIN, "max_neighbors": nl.max_neighbors,
           "grid_shape": list(nl.grid_shape), "build_ms": build_ms,
           "vs_pair_channel_by_pid": err, "tol": SPH_LIST_TOL, "scale_sum_abs_terms": scale,
           "control_no_viscosity": ctl, "particles_near_a_face": int(face.sum()),
           "pairs_at_the_support_edge": int(edge.sum()) // 2,
           "particles_left_out": int((~keep).sum()), "dt": SPH_DT, "settle_steps": C2_WARM,
           "timed_steps": C2_TIMED, **step_stats(per), "timed_seconds": timed_s,
           "momentum_per_particle": mom, "kernel_launches": {k: v.launches
                                                             for k, v in counted.items()},
           "peak_memory_gib": peak / 2 ** 30,
           "memory_note": "each [N, K, 3] float32 tensor is "
                          f"{4 * 3 * n * nl.max_neighbors / 2 ** 30:.2f} GiB"}
    print(json.dumps(out), flush=True)
    return out


def deserno_path(dev, card) -> dict:
    """Phase 3o: a Deserno bilayer of build_bilayer(DESERNO_SIDE) under
    leimkuhler, DESERNO_WARM + DESERNO_TIMED steps; the gates of
    tests/test_support_subsystems.py:140; the list's forces against the
    dense all-pairs sum on build_bilayer(DESERNO_DENSE_SIDE)."""
    import numpy as np
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.core.state import make_state
    from uammd_tpu_torch.core.types import Computables
    from uammd_tpu_torch.integrators.brownian import leimkuhler
    from uammd_tpu_torch.interactors.deserno import (DesernoParams, build_bilayer,
                                                     deserno_forces, deserno_pair_kernel)
    from uammd_tpu_torch.neighbors.neighbor_list import (build_neighbor_list, ensure_capacity,
                                                         maybe_rebuild)
    from uammd_tpu_torch.neighbors.pair_map import apply_pairs, apply_pairs_dense

    torch.cuda.empty_cache()
    params = DesernoParams()
    # the list against all pairs on a small bilayer
    pos16, t16, _, _, L16 = build_bilayer(DESERNO_DENSE_SIDE, params, device=dev)
    b16 = box([L16, L16, 6 * L16], device=dev)
    p16 = torch.tensor(pos16 + np.random.default_rng(9).uniform(-0.05, 0.05, pos16.shape),
                       dtype=torch.float32, device=dev)
    t16 = torch.tensor(t16, device=dev)
    nl16 = ensure_capacity(build_neighbor_list(p16, b16, params.max_cutoff), p16)
    kern = deserno_pair_kernel(params, Computables(force=True))
    f_list = apply_pairs(kern, nl16, p16, info=t16, box=b16)["force"]
    f_dense = apply_pairs_dense(kern, p16, b16, info=t16)["force"]
    dense_err = float((f_list - f_dense).abs().max() / f_dense.abs().max())
    check(dense_err < DESERNO_DENSE_TOL,
          f"Deserno: list vs all pairs {dense_err:.3g} < {DESERNO_DENSE_TOL}")
    # the path
    pos, types, lip, straight, L = build_bilayer(DESERNO_SIDE, params, device=dev)
    b = box([L, L, 6 * L], device=dev)
    st = make_state(pos, type_id=types, seed=0, device=dev)
    nl = ensure_capacity(build_neighbor_list(st.pos, b, params.max_cutoff), st.pos)

    def force_fn(state, nbrs):
        nbrs = maybe_rebuild(nbrs, state.pos)
        return deserno_forces(state.pos, state.type_id, lip, straight, params, nbrs, box=b), nbrs

    integ = leimkuhler(force_fn, dt=DESERNO_DT, temperature=DESERNO_T, viscosity=1.0)
    torch.cuda.reset_peak_memory_stats()
    holder = list(integ.init(st, nl))

    def step(h):
        h[0], h[1] = integ.step(h[0], h[1])

    per, timed_s = timed_steps(step, holder, DESERNO_WARM, DESERNO_TIMED)
    st, (_, nl) = holder  # leimkuhler's aux: (the last noise, the list)
    check(bool(st.pos.isfinite().all()) and not bool(nl.overflow), "Deserno: finite, no overflow")
    z = st.pos[:, 2]
    t = torch.as_tensor(types, device=dev)
    zmax = float(z.abs().max())
    heads, tails = float(z[t == 0].abs().mean()), float(z[t == 1].abs().mean())
    check(zmax < 6 * params.sigma, f"Deserno: max|z| = {zmax:.4g} < 6 sigma")
    check(heads > tails, f"Deserno: heads outside the tails ({heads:.4g} > {tails:.4g})")
    out = {"phase": "deserno_path", "card": card, "lipids": 2 * DESERNO_SIDE ** 2,
           "beads": st.n, "box": [L, L, 6 * L], "dt": DESERNO_DT, "temperature": DESERNO_T,
           "settle_steps": DESERNO_WARM, "timed_steps": DESERNO_TIMED, **step_stats(per),
           "timed_seconds": timed_s, "max_neighbors": nl.max_neighbors, "max_abs_z": zmax,
           "mean_abs_z_heads": heads, "mean_abs_z_tails": tails,
           "list_vs_dense_rel_err": dense_err, "dense_beads": p16.shape[0],
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(json.dumps(out), flush=True)
    return out


def check_auto_dispatch_tiled(dev) -> dict:
    """The auto dispatch's tiled branch on the card: on a 36^3 grid (no
    pencils, tile 4) at N = 8192, ``spread_auto`` and ``interpolate_auto``
    launch no pencil kernel and return ``spread_tiled`` /
    ``interpolate_tiled`` bit for bit; each within PENCIL_TOL x max|ref| of
    the direct path. Controls that must fail the bound by 100x: the spread
    with one particle's values dropped, the interpolation of a field
    shifted by one node."""
    import numpy as np
    import torch
    from uammd_tpu_torch.core.box import box
    from uammd_tpu_torch.solvers import ibm, tiled_ibm
    from uammd_tpu_torch.solvers import pencil_ibm as tp

    m = TILED_M
    shape = (m, m, m)
    L = m * 0.61
    b = box(L, device=dev)
    kern = ibm.GaussianKernel(sigma=1.2, support=8)
    check(not tp.pencil_ok(shape, kern.support) and tiled_ibm.tile_shape_ok(
        shape, kern.support, tiled_ibm.pick_tile(shape, kern.support)),
        "tiled dispatch: the grid is tile-safe and pencil-unsafe")
    rng = np.random.default_rng(10)
    pos = torch.tensor((rng.random((TILED_N, 3)) - 0.5) * L, dtype=torch.float32, device=dev)
    q = torch.tensor(rng.normal(size=(TILED_N, 3)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.normal(size=shape + (3,)), dtype=torch.float32, device=dev)
    n0 = tp.SPREAD.launches, tp.INTERP.launches
    f_auto = ibm.spread_auto(kern, pos, q, shape, b)
    v_auto = ibm.interpolate_auto(kern, pos, u, b)
    check((tp.SPREAD.launches, tp.INTERP.launches) == n0,
          "tiled dispatch: no pencil kernel launched")
    f_t, ovf_f = tiled_ibm.spread_tiled(kern, pos, q, shape, b)
    v_t, ovf_v = tiled_ibm.interpolate_tiled(kern, pos, u, b)
    check(not bool(ovf_f) and not bool(ovf_v), "tiled dispatch: no tile overflow")
    check(torch.equal(f_auto, f_t) and torch.equal(v_auto, v_t),
          "tiled dispatch: the auto results are the tiled path's, bit for bit")
    f_d, v_d = ibm.spread(kern, pos, q, shape, b), ibm.interpolate(kern, pos, u, b)
    errs = {"spread": rel_err(f_auto, f_d), "interp": rel_err(v_auto, v_d)}
    check(all(math.isfinite(e) and e <= PENCIL_TOL for e in errs.values()),
          f"tiled dispatch vs direct, max|d|/max|ref| = {errs} <= {PENCIL_TOL}")
    dropped = q.clone()
    dropped[0] = 0.0
    ctl = {"spread_one_particle_dropped": rel_err(ibm.spread_auto(kern, pos, dropped, shape, b),
                                                  f_d),
           "interp_field_shifted_one_node": rel_err(
               ibm.interpolate_auto(kern, pos, torch.roll(u, 1, dims=0), b), v_d)}
    for k, v in ctl.items():
        check(v > 100 * PENCIL_TOL, f"tiled dispatch: control '{k}' fails ({v:.3g})")
    return {"shape": list(shape), "n": TILED_N, "tile": tiled_ibm.pick_tile(shape, kern.support),
            "vs_direct": errs, "controls": ctl}


def c2_phases(dev, card, sph_final, grid_be=None) -> list:
    """Slice C2's phases (3k-3o) with their times; returns the kernels-line
    rows of #13/#14 at the list PSE far field and the rotational passes."""
    import torch

    t0 = time.perf_counter()
    secs = {}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return r

    rows = timed("list_pse", lambda: list_pse_path(dev, card, grid_be))
    timed("dense_rpy", lambda: dense_rpy_path(dev, card))
    rows += timed("rotational_fcm", lambda: rotational_fcm_path(dev, card))
    timed("list_sph", lambda: list_sph_path(dev, card, sph_final))
    timed("deserno", lambda: deserno_path(dev, card))
    print(json.dumps({"phase": "c2_seconds", "card": card, "phases": secs,
                      "total": time.perf_counter() - t0}), flush=True)
    return rows


def c2_only(dev, card) -> int:
    """``--only-c2``: the auto dispatch's checks (pencil and tiled), the grid
    SPH path (for its final state) and slice C2's phases; prints no result
    line."""
    print(json.dumps({"phase": "auto_dispatch", **check_auto_dispatch(dev)}), flush=True)
    sph = sph_main_path(dev)
    rows = c2_phases(dev, card, (sph["md"], sph["gs"]))
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


def main() -> int:
    import torch

    only_pse = "--only-pse" in sys.argv[1:]
    only_slice_d = "--only-slice-d" in sys.argv[1:]
    only_unfused = "--only-unfused" in sys.argv[1:]
    only_poisson = "--only-poisson" in sys.argv[1:]
    only_dd = "--only-dd" in sys.argv[1:]
    only_ragged = "--only-ragged" in sys.argv[1:]
    only_g2 = "--only-g2" in sys.argv[1:]
    only_pencil = "--only-pencil" in sys.argv[1:]
    only_rebin = "--only-rebin" in sys.argv[1:]
    only_update_fold = "--only-update-fold" in sys.argv[1:]
    only_general = "--only-general" in sys.argv[1:]
    only_c2 = "--only-c2" in sys.argv[1:]

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
    for name in ("newton_channel", "pair_channel", "pair_force", "lanczos_sqrt", "gj_update",
                 "gj_fold_update", "rebin", "rebin2", "sep_rebin", "newton_pair", "fold"):
        print(json.dumps({"ptxas": name, "lines": [
            ln.strip() for ln in _build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]}), flush=True)
    # the classify-and-pull rebins, the folds and the updates spill nothing
    # in any instance
    print(json.dumps({"phase": "spills", "ok": True,
                      **spill_report(("rebin", "rebin2", "sep_rebin", "fold", "gj_update",
                                      "gj_fold_update"))}),
          flush=True)
    if only_pse:
        return pse_only(dev, card)
    if only_slice_d:
        return slice_d_only(dev, card)
    if only_unfused:
        return unfused_only(dev, card)
    if only_poisson:
        return poisson_only(dev, card)
    if only_dd:
        return dd_only(dev, card)
    if only_ragged:
        ragged_checks(dev)
        return 0
    if only_g2:
        return g2_only(dev, card)
    if only_pencil:
        return pencil_only(dev, card)
    if only_rebin:
        return rebin_only(dev, card)
    if only_update_fold:
        return update_fold_only(dev, card)
    if only_general:
        return general_only(dev, card)
    if only_c2:
        return c2_only(dev, card)

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
    rebin_nan = check_rebin_nan(gs_small, "N=32768")

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
    # the largest force stays a few hundred; and the same state after
    # tests/test_engine2.py:96-102's displacement (cells pass CAP and
    # stragglers move)
    gs_s, moved_s = n600_straggler_system(dev, rng)
    n_s, spec_s = gs_s.n, gs_s.spec
    n_strag_s = int((gs_s.spid >= 0).sum())
    check(n_strag_s > 0, "n 600 CAP 8: the straggler list is used")
    all_modes = ((False, False), (False, True), (True, False), (True, True))
    v2_err = {"n600_strag": check_newton(gs_s, "n 600 stragglers", modes=all_modes)}
    fast_err = {"n600_strag": check_newton(gs_s, "n 600 stragglers", approx=True,
                                           tol=FAST_RECIP_TOL, slot_tol=FAST_RECIP_SLOT_TOL)}
    controls = check_newton_controls(gs_s, "n 600 stragglers")
    home, groups, _ = newton_pair(gs_s)
    check_fold(spec_s, home, groups, "n 600 stragglers")
    upd_err = {f"n600_{nz}": check_update(gs_s, home, groups, nz, "n 600 stragglers",
                                          controls=nz == "clt")
               for nz in update_kernel.NOISES}
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
                      "rebin": "exact at Q=7 and Q=10", "rebin_nan": rebin_nan,
                      "fcc_spec": list(spec_fcc.array_shape),
                      "newton_err": v2_err, "newton_fast_recip_err": fast_err,
                      "newton_controls_slot_err": controls, "slot_tol": SLOT_TOL,
                      "fast_recip_tol": FAST_RECIP_TOL,
                      "fast_recip_slot_tol": FAST_RECIP_SLOT_TOL, "fold": "bit-equal",
                      "update_max_abs_err_and_drift_err": upd_err,
                      "separable_rebin": "exact (out, mini, count, overflow)",
                      "n600_stragglers": n_strag_s, "n600_mini_stragglers": sep_s[2],
                      "fcc_v2_spec": list(spec_fcc2.array_shape),
                      "fcc_v2_mini_stragglers": sep_fcc[2]}), flush=True)

    rebin_face_checks(face_states(dev))
    sep_rebin_checks(dev)
    fcm_kernel_checks(dev)
    pencil_tile_checks(dev)
    pse_errs = pse_kernel_checks(dev)
    d_errs = slice_d_kernel_checks(dev)
    a3_errs = unfused_kernel_checks(dev)
    e1_checks = poisson_checks(dev)
    ragged_checks(dev)

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
    v2 = main_path_v2(dev, melted, kernels)
    engine2, gs2, ms_v2 = v2["engine"], v2["gs"], v2["ms"]
    launches_v2, timed_v2, n_strag_now = v2["launches"], v2["timed"], v2["stragglers"]
    for what, spec in (("v1 path (#1)", engine.spec), ("v2 path (#6)", engine2.spec)):
        print(json.dumps({"phase": "launch_plans", "what": what, **plan_of(spec)}), flush=True)

    # 3c. the BDHI-FCM path, with its own zeroed launch counts
    fcm_path = fcm_main_path(dev, {"pencil_spread": pencil_ibm.SPREAD,
                                   "pencil_interp": pencil_ibm.INTERP})

    # 3d. the BDHI-PSE path, with its own zeroed launch counts
    pse_path = pse_main_path(dev, pse_counters())
    check(not pse_path["fails"], "; ".join(pse_path["fails"]))
    print(json.dumps({"phase": "launch_plans", "what": "PSE near grid (#6)",
                      **plan_of(pse_path["be"].spec)}), flush=True)

    # 4. kernel times at each path's final shapes
    slot_bytes = 4 * engine.spec.n_slots
    spec = engine.spec
    g = md.lj_g()
    force = pair_kernel.make_pair_force_kernel(spec, g)
    err_liquid = check_pair(gs, "2^20 liquid")
    row_rebin = rebin_row("", gs, launches_v1["rebin"], "2^20 liquid displaced", 13)
    m = gs.mask
    pair_abs_err = max(
        float((a[m] - b[m]).abs().max())
        for a, b in zip(force(gs.x, gs.y, gs.z),
                        pair_kernel.pair_force_plain(spec, g, gs.x, gs.y, gs.z)))
    pair_ms = cuda_ms(lambda: force(gs.x, gs.y, gs.z), reps=20)
    pair_plain_ms = cuda_ms(
        lambda: pair_kernel.pair_force_plain(spec, g, gs.x, gs.y, gs.z), reps=3, warmup=1)
    pairs, pairs_in_cutoff = stencil_pairs(gs)
    pair_bytes_ms = 1e3 * 6 * slot_bytes / PEAK_HBM_BYTES
    pair_ops_ms = (1e3 * (OPS_PAIR_TEST * pairs + OPS_PAIR_FORCE * pairs_in_cutoff)
                   / PEAK_FP32_FLOPS)

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
    row_upd = update_row(engine2, gs2, launches_v2["gj_fold_update"])
    moved2 = displaced(gs2, 15)
    sep_liquid = check_sep_rebin(moved2, "2^20 v2 liquid displaced")
    row_sep = sep_row("", spec2, rebin_kernel.OCAP, stacked_of(moved2, 7),
                      strag_stack_of(moved2), launches_v2["separable_rebin"],
                      "the v2 path's final state, displaced")

    newton_ms = cuda_ms(lambda: newton(gs2.x, gs2.y, gs2.z, strag), reps=20)
    newton_plain_ms = cuda_ms(lambda: newton_pair(gs2, plain=True), reps=3, warmup=1)
    fold_t = fold_times(fold, home, groups)
    fold_ms = fold_t["ms"]
    fold_plain_ms = cuda_ms(lambda: kernel2.fold_reactions_plain(home, groups), reps=5, warmup=1)
    upd_ms = row_upd["ms"]
    sep_ms = row_sep["ms"]
    pairs2, cut2 = stencil_pairs(gs2)
    newton_ops_ms = 1e3 * (OPS_PAIR_TEST * pairs2 + OPS_PAIR_FORCE * cut2) / PEAK_FP32_FLOPS
    newton_bytes_ms = 1e3 * (18 * slot2 + 28 * S) / PEAK_HBM_BYTES
    fold_bytes_ms = 1e3 * 18 * slot2 / PEAK_HBM_BYTES

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
        "v1": {"ms_per_step": ms_v1, "pair_force_ms": pair_ms, "rebin_ms": row_rebin["ms"],
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
        row_rebin,
        row("newton_pair", "newton_pair.cu", "uammd_tpu/engine/kernel2.py:447",
            launches_v2["newton_pair"], newton_abs_err, newton_ms, newton_plain_ms,
            newton_bytes_ms, newton_ops_ms),
        {**row("fold", "fold.cu", "uammd_tpu/engine/kernel2.py:531",
               launches_v2["fold"], fold_abs_err, fold_ms, fold_plain_ms, fold_bytes_ms),
         **{k: v for k, v in fold_t.items() if k != "ms"}},
        row_upd,
        row_sep,
    ]
    rows += fcm_breakdown(fcm_path, card)
    rows += pse_breakdown(pse_path, card, pse_errs)
    for r in rows[:6]:  # the LJ kernels that the PSE path also runs
        if r["name"] in pse_path["launches"]:
            r["launches_pse_path"] = pse_path["launches"][r["name"]]
        if r["name"] == "fold":
            r["pse_path_times"] = pse_path["fold_times"]
    rows.append(lanczos_row(pse_path, d_errs["lanczos_sqrt"]))
    # 3e-3h, 4d: slice D's paths, each with its own zeroed launch counts
    kept = {}
    rows += slice_d_paths(dev, card, gs2, engine2, keep=kept)
    del gs2, engine2
    # 3i, 4e: slice A3's unfused v2 path and slice E1's Poisson path, each
    # with its own zeroed launch counts
    a3_rows, a3 = unfused_main_path(dev, card, melted, a3_errs)
    unfused_launches = {"newton_pair": a3["newton_launches"], "fold": a3["fold_launches"],
                        "separable_rebin": a3["sep_rebin_launches"]}
    for r in rows:  # the earlier kernels that the unfused path also runs
        if r["name"] in unfused_launches:
            r["launches_v2_unfused_path"] = unfused_launches[r["name"]]
        if r["name"] == "fold":
            r["v2_unfused_path_times"] = a3["fold_times"]
    rows += a3_rows
    e1_rows, _ = poisson_main_path(dev, card, e1_checks)
    rows += e1_rows
    # slice G1: the grid engines on a z-slab mesh, each path with its own
    # zeroed launch counts
    rows += dd_phases(dev, card, melted, a3["ms"])
    # slice G2a: the composed multi-shard PSE steps, each path with its own
    # zeroed launch counts
    rows += g2_phases(dev, card)
    # slice C: the general path, with every kernel count zeroed just before
    gen = general_path(dev, card, melted)
    print(json.dumps({"phase": "general_vs_grid_paths", "card": card, "n": N,
                      "ms_per_step": {"general": gen["ms_per_step"], "v1": ms_v1,
                                      "v2": ms_v2, "v2_unfused": a3["ms"]}}), flush=True)
    # slice C2: BDHI over lists, SPH and Deserno, each path with its counts
    # zeroed just before
    rows += c2_phases(dev, card, kept.pop("sph"), pse_path["be"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
