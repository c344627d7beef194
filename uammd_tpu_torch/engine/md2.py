"""v2 high-throughput MD engine: Newton pair kernel + stragglers + the
reaction fold and the Gronbech-Jensen update, fused or not.

Port of ``uammd_tpu/engine/md2.py`` (``GridMD2`` / ``make_lj_md2``), the
engine ``bench.py`` times on the reference workload
(examples/misc/benchmark.cu): CAP sized to the bulk occupancy with the tail
in a straggler side list, the Newton-halved pair kernel, and the G-J update
with in-kernel noise.

Velocity convention: the state's (vx, vy, vz) carry the pre-half-kick
velocity w(t) = v(t) - (dt/2m) f(t); ``velocities_of`` and
``temperature_of`` reconstruct the physical v.

``fold_in_update`` has the JAX package's meaning. On (the default, as on
the TPU) the fold happens in the update: the state keeps the home force in
fx, fy, fz and the 12 reaction-group grids in ``fgrp``, views of the
Newton pair kernel's one [15, ...] output (``fstack``), and a step hands
that buffer (``GridState.force_stack``) to the fused fold + update kernel
(#12); on the CPU its plain version folds and then updates, which
computes the same thing. Off, ``compute_forces`` folds with the fold
kernel (#7) and stores the folded forces (``fgrp`` is ``()``), and a step
launches the update from folded forces (#11), which has Box-Muller noise
whatever ``noise`` says (the JAX kernel has no switch). Both updates draw
from the same counter streams. Either way the straggler-aware rebin is ``rebin_fast3`` (three one-axis passes), as in
the JAX engine (md2.py:244).

``lax.scan`` becomes a Python loop and the ``lax.cond`` on the drift one
host read per step. The noise is the counter hash of ``update_kernel``
keyed by ``GridState.step``, which carries the JAX package's per-run seed
base ``(seed * 2654435761 + 12345) % 2^31`` plus the step index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .kernel2 import (
    broadcast_stragglers,
    make_fold_kernel,
    make_newton_pair_kernel,
    straggler_pair_forces,
)
from .layout import GridSpec, GridState, choose_spec, pack
from .md import LJFused, lj_g, lj_g_fused
from .rebin_kernel import rebin_fast3, rebin_fast_noforce
from .update_kernel import make_gj_fold_update_kernel, make_gj_update_kernel


@dataclasses.dataclass(frozen=True)
class GridMD2:
    """Bound v2 engine: spec + kernels + integrator parameters + device."""

    spec: GridSpec
    g_fn: object  # radial of the straggler-straggler pairs (plain torch)
    dt: float
    temperature: float
    friction: float
    mass: float
    noise: str
    device: torch.device
    pair: object
    fold: object
    update: object
    fold_in_update: bool = True

    @staticmethod
    def create(spec: GridSpec, g_fn, *, dt, temperature, g_fn_kernel: LJFused,
               friction=1.0, mass=1.0, noise: str = "bm", self_half: bool = False,
               strag_cellcenter: bool = False, fold_in_update: bool | None = None,
               device=None) -> "GridMD2":
        """``g_fn_kernel`` is the fused LJ radial inside the pair kernel
        (``md.lj_g_fused``); ``g_fn`` serves the O(S^2) straggler pairs.
        ``fold_in_update`` None means on (see the module docstring)."""
        fused = fold_in_update is None or bool(fold_in_update)
        if fused:
            update = make_gj_fold_update_kernel(spec, dt, temperature, friction, mass,
                                                noise=noise)
        else:
            update = make_gj_update_kernel(spec, dt, temperature, friction, mass)
        return GridMD2(
            spec=spec, g_fn=g_fn, dt=dt, temperature=temperature,
            friction=friction, mass=mass, noise=noise, device=resolve_device(device),
            pair=make_newton_pair_kernel(
                spec, g_fn_kernel, self_half=self_half, strag_cellcenter=strag_cellcenter),
            fold=make_fold_kernel(spec), update=update, fold_in_update=fused,
        )

    # ----------------------------------------------------------- forces
    def compute_forces(self, gs: GridState) -> GridState:
        """Home forces and the unfolded reaction groups (``fgrp``), or with
        ``fold_in_update`` off the folded forces, plus the straggler
        forces."""
        S = self.spec.n_strag
        strag = broadcast_stragglers(self.spec, gs.spos, gs.spid) if S else None
        if self.fold_in_update:
            # the kernel's one buffer, kept whole for the update
            fstack, sf = self.pair.stacked(gs.x, gs.y, gs.z, strag)
            f = fstack.unbind(0)
            rep = dict(fx=f[0], fy=f[1], fz=f[2], fgrp=f[3:], fstack=fstack)
        else:
            home, groups, sf = self.pair(gs.x, gs.y, gs.z, strag)
            fx, fy, fz = self.fold(home, groups)
            rep = dict(fx=fx, fy=fy, fz=fz, fgrp=(), fstack=None)
        if S:
            sf = sf + straggler_pair_forces(self.spec, self.g_fn, gs.spos, gs.spid)
            rep["sforce"] = sf * (gs.spid >= 0)[:, None]
        return gs.replace(**rep)

    def folded_forces(self, gs: GridState):
        """Physical (folded) grid forces: the stored ones when nothing is
        left to fold (``fold_in_update`` off)."""
        if not gs.fgrp:
            return gs.fx, gs.fy, gs.fz
        groups = [gs.fgrp[3 * i: 3 * i + 3] for i in range(4)]
        return self.fold((gs.fx, gs.fy, gs.fz), groups)

    # ------------------------------------------------------------- init
    def init(self, pos, seed: int = 0, vel=None) -> GridState:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        gs = pack(self.spec, pos, vel=vel, gen=gen, device=self.device)
        # per-run base of the monotone noise seed (see step)
        gs = gs.replace(step=torch.tensor((seed * 2654435761 + 12345) % (1 << 31),
                                          dtype=torch.int32, device=self.device))
        if vel is None and self.temperature > 0:
            sd = float(np.sqrt(self.temperature / self.mass))
            m = gs.mask
            vx, vy, vz = (sd * torch.randn(gs.x.shape, generator=gen, device=self.device) * m
                          for _ in range(3))
            svel = (sd * torch.randn(gs.svel.shape, generator=gen, device=self.device)
                    * (gs.spid >= 0)[:, None])
            gs = gs.replace(vx=vx, vy=vy, vz=vz, svel=svel)
        gs = self.compute_forces(gs)
        # enter the deferred-half-kick convention: w = v - (dt/2m) f
        hv = float(np.float32(0.5 * self.dt / self.mass))
        ffx, ffy, ffz = self.folded_forces(gs)
        return gs.replace(vx=gs.vx - hv * ffx, vy=gs.vy - hv * ffy, vz=gs.vz - hv * ffz,
                          svel=gs.svel - hv * gs.sforce)

    # ------------------------------------------------------------- step
    def step(self, gs: GridState) -> GridState:
        spec = self.spec
        strag = (gs.spos, gs.svel, gs.sforce, gs.spid) if spec.n_strag else None
        # the grid and the straggler rows in one update, noise keyed by the
        # step seed (the JAX engine's _strag_update, md2.py:190, runs inside)
        grids = (gs.x, gs.y, gs.z, gs.vx, gs.vy, gs.vz)
        refs = (gs.ref_x, gs.ref_y, gs.ref_z)
        if self.fold_in_update:
            res = self.update.stacked(*grids, gs.force_stack(), *refs, gs.step, strag)
        else:
            res = self.update(*grids, gs.fx, gs.fy, gs.fz, *refs, gs.step, strag)
        (x, y, z, wx, wy, wz), drift = res[:2]
        gs = gs.replace(x=x, y=y, z=z, vx=wx, vy=wy, vz=wz, step=gs.step + 1)
        if spec.n_strag:
            gs = gs.replace(spos=res[2][0], svel=res[2][1])
            rebin_fn = rebin_fast3
        else:
            rebin_fn = rebin_fast_noforce
        # the largest per-axis (infinity-norm) displacement since the last
        # rebin, against the per-axis half-slack threshold (one host read)
        if float(drift) > float(np.float32(spec.drift_threshold)):
            gs = rebin_fn(gs)
        return self.compute_forces(gs)

    def run(self, gs: GridState, n_steps: int) -> GridState:
        for _ in range(n_steps):
            gs = self.step(gs)
        return gs

    # ------------------------------------------------------- observables
    def velocities_of(self, gs: GridState):
        hv = float(np.float32(0.5 * self.dt / self.mass))
        ffx, ffy, ffz = self.folded_forces(gs)
        m = gs.mask
        return ((gs.vx + hv * ffx) * m, (gs.vy + hv * ffy) * m, (gs.vz + hv * ffz) * m,
                (gs.svel + hv * gs.sforce) * (gs.spid >= 0)[:, None])

    def temperature_of(self, gs: GridState) -> torch.Tensor:
        vx, vy, vz, sv = self.velocities_of(gs)
        ke = 0.5 * self.mass * (torch.sum(vx**2 + vy**2 + vz**2) + torch.sum(sv**2))
        return 2.0 * ke / (3.0 * gs.n)


def make_lj_md2(
    box_size,
    n: int,
    *,
    epsilon: float = 1.0,
    sigma: float = 1.0,
    cutoff: float = 2.5,
    skin: float = 1.2,
    dt: float = 0.01,
    temperature: float = 1.0,
    friction: float = 1.0,
    mass: float = 1.0,
    cap: int | None = None,
    n_strag: int = 32,
    pos=None,
    fast_recip: bool = False,
    noise: str = "bm",
    self_half: bool = True,
    strag_cellcenter: bool = True,
    fold_in_update: bool | None = None,
    device=None,
) -> GridMD2:
    """v2 engine on the reference benchmark system
    (examples/misc/benchmark.cu:172-181) on ``device`` (default: the GPU).
    ``fast_recip`` takes the hardware approximate reciprocal inside the CUDA
    pair kernel's fused LJ radial; ``self_half`` and ``strag_cellcenter``
    choose the CUDA kernel's self-cell and straggler enumeration (the plain
    version computes the same forces either way); ``fold_in_update`` as
    ``GridMD2`` takes it."""
    dev = resolve_device(device)
    spec = choose_spec(box_size, n, cutoff, skin=skin, cap=cap, pos=pos, n_strag=n_strag)
    gk = lj_g_fused(epsilon, sigma, rc2=cutoff * cutoff, approx=fast_recip)
    return GridMD2.create(
        spec, lj_g(epsilon, sigma), dt=dt, temperature=temperature,
        friction=friction, mass=mass, g_fn_kernel=gk, noise=noise,
        self_half=self_half, strag_cellcenter=strag_cellcenter,
        fold_in_update=fold_in_update, device=dev,
    )
