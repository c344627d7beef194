"""DPD on the grid-resident engine.

Port of ``uammd_tpu/engine/dpd.py`` (reference: src/Interactor/Potential/
DPD.cuh:41-192 through the PairForces transverser): the DPD pair force
(conservative + dissipative + random) runs over the 27-stencil channel
kernel #2 with velocities, particle ids and the step counter riding as
channels, and the pair noise is a counter-based integer hash of
(min pid, max pid, step), so the random force is exactly antisymmetric and
momentum is conserved to round-off.

The hash is JAX's bit for bit: ``core/rng.py``'s (the same murmur3-style
mix as the JAX engine's ``_hash``, in int64 tensors masked to 32 bits:
torch's ``>>`` on int32 is arithmetic, JAX's ``shift_right_logical`` is
not), with this engine's own keys and its CLT draw, and in
``csrc/channel_functors.cuh`` with ``uint32_t``.

Integration: velocity Verlet with the half-kicked velocity entering the
dissipative force (Groot-Warren lambda = 1/2). The JAX engine's
``lax.cond`` on the drift becomes a host ``if`` on one read per step, and
the rebin is the port's ``rebin_fast_noforce`` (kernel #3).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import rng as prng
from ..device import resolve_device
from .layout import GridSpec, GridState, choose_spec, pack
from .pair_kernel import (PAIR_CHANNEL_DPD, PAIR_CHANNEL_DPD_HALO, ChannelFunctor, DPDParams,
                          make_pair_channel_kernel)
from .rebin_kernel import rebin_fast_noforce

_K1, _K2 = 0x00BEEF01, 0x00F00D02
# the JAX engine's ``_hash`` and ``_u24f`` (dpd.py:61-69)
_hash = prng.hash_u32
_u24f = prng.uniform_from_bits


class DPDPair(ChannelFunctor):
    """``dpd_pair_fn`` (dpd.py:72-108): channels (vx, vy, vz, pid_f,
    step_f), 3 sums out. On the card the step rides as one uniform value
    (a 0-d float32 tensor, as the JAX engine's float32 step channel holds
    it), and both sides hash the integer it truncates to."""

    n_chan, n_out, n_uniform = 5, 3, 1
    kernel = PAIR_CHANNEL_DPD
    kernel_halo = PAIR_CHANNEL_DPD_HALO

    def __init__(self, rc: float, A: float, gamma: float, sigma_dt: float):
        self.rc2 = float(np.float32(rc * rc))
        self.inv_rc = float(np.float32(1.0 / rc))
        self.A = float(np.float32(A))
        self.gamma = float(np.float32(gamma))
        self.sigma = float(np.float32(sigma_dt))
        self.sq6 = float(np.float32(math.sqrt(6.0)))

    def params(self) -> DPDParams:
        return DPDParams(self.rc2, self.inv_rc, self.A, self.gamma, self.sigma, self.sq6)

    def reach(self, hs: float = 0.0) -> float:
        return math.sqrt(self.rc2)

    def __call__(self, r2, dxv, dyv, dzv, ch_i, ch_j):
        vxi, vyi, vzi, pidi, stepf = ch_i
        vxj, vyj, vzj, pidj, _ = ch_j
        inside = (r2 < self.rc2) & (r2 > 1e-10)
        r2s = torch.where(inside, r2, torch.ones_like(r2))
        rinv = torch.rsqrt(r2s)
        w = 1.0 - r2s * rinv * self.inv_rc
        vdotr = ((vxj - vxi) * dxv + (vyj - vyi) * dyv + (vzj - vzi) * dzv) * rinv
        ii = pidi.to(torch.int32)
        jj = pidj.to(torch.int32)
        c = _hash(torch.minimum(ii, jj), torch.maximum(ii, jj))
        st = stepf.to(torch.int32)
        u1 = _u24f(_hash(c, st, _K1))
        u2 = _u24f(_hash(c, st, _K2))
        xi = self.sq6 * (u1 + u2 - 1.0)
        fmod = self.A * w - self.gamma * w * w * vdotr + self.sigma * w * xi
        f = torch.where(inside, -fmod * rinv, torch.zeros_like(r2))
        return f * dxv, f * dyv, f * dzv


@dataclasses.dataclass(frozen=True)
class GridDPD:
    """Slot-resident DPD engine (velocity Verlet + one #2 pass per step)."""

    spec: GridSpec
    rc: float
    A: float
    gamma: float
    temperature: float
    dt: float
    mass: float
    device: torch.device
    kern: object

    @staticmethod
    def create(box_size, n, *, rc=1.0, A=25.0, gamma=4.5, temperature=1.0, dt=0.01,
               mass=1.0, skin=1.1, cap=None, pos=None, device=None) -> "GridDPD":
        """On ``device`` (default: the GPU)."""
        spec = choose_spec(box_size, n, rc, skin=skin, cap=cap, pos=pos)
        # float64, then float32 in DPDPair (dpd.py:129)
        sigma_dt = math.sqrt(2.0 * temperature * gamma / dt)
        kern = make_pair_channel_kernel(spec, DPDPair(rc, A, gamma, sigma_dt))
        return GridDPD(spec=spec, rc=rc, A=A, gamma=gamma, temperature=temperature, dt=dt,
                       mass=mass, device=resolve_device(device), kern=kern)

    def compute_forces(self, gs: GridState, vx, vy, vz) -> tuple:
        """The pair pass at the given slot velocities."""
        pidf = gs.pid.to(torch.float32)
        stepf = gs.step.to(torch.float32)
        return self.kern(gs.x, gs.y, gs.z, vx, vy, vz, pidf, stepf)

    def init(self, pos, seed: int = 0, vel=None) -> GridState:
        """Pack ``pos`` (and ``vel``); without ``vel`` at T > 0, Maxwellian
        velocities from a ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        gs = pack(self.spec, pos, vel=vel, gen=gen, device=self.device)
        if vel is None and self.temperature > 0:
            sd = float(np.sqrt(self.temperature / self.mass))
            m = gs.mask
            vx, vy, vz = (sd * torch.randn(gs.x.shape, generator=gen, device=self.device) * m
                          for _ in range(3))
            gs = gs.replace(vx=vx, vy=vy, vz=vz)
        fx, fy, fz = self.compute_forces(gs, gs.vx, gs.vy, gs.vz)
        return gs.replace(fx=fx, fy=fy, fz=fz)

    def step(self, gs: GridState) -> GridState:
        """DPD velocity Verlet: the force at t+dt is evaluated with the
        half-kicked velocity (Groot-Warren lambda = 1/2). One host read:
        the drift against the half-slack threshold."""
        return verlet_step(self, gs)

    def run(self, gs: GridState, n_steps: int) -> GridState:
        for _ in range(n_steps):
            gs = self.step(gs)
        return gs

    def temperature_of(self, gs: GridState) -> torch.Tensor:
        ke = 0.5 * self.mass * torch.sum(gs.vx ** 2 + gs.vy ** 2 + gs.vz ** 2)
        return 2.0 * ke / (3.0 * gs.n)


def verlet_step(engine, gs: GridState) -> GridState:
    """The velocity-Verlet step that the DPD and SPH engines share
    (dpd.py:166-191, sph.py:141-159): half kick and drift
    (``kick_drift``), a rebin through ``rebin_fast_noforce`` when the
    squared drift passes the float32 threshold (the step's one host read),
    then forces at the half-kicked velocities and the second half kick
    (``force_kick``)."""
    gs, d2 = kick_drift(engine, gs)
    if float(d2) > float(np.float32(engine.spec.drift_threshold ** 2)):
        gs = rebin_fast_noforce(gs)
    return force_kick(engine, gs)


def kick_drift(engine, gs: GridState):
    """Half kick with f(t), drift, step + 1; returns (state, the largest
    squared drift since the last rebin as a 0-d tensor)."""
    dt = float(np.float32(engine.dt))
    hv = float(np.float32(0.5 * engine.dt / engine.mass))
    m = gs.mask
    zero = torch.zeros((), dtype=gs.x.dtype, device=gs.x.device)
    vxh = (gs.vx + hv * gs.fx) * m
    vyh = (gs.vy + hv * gs.fy) * m
    vzh = (gs.vz + hv * gs.fz) * m
    x = gs.x + torch.where(m, dt * vxh, zero)
    y = gs.y + torch.where(m, dt * vyh, zero)
    z = gs.z + torch.where(m, dt * vzh, zero)
    gs = gs.replace(x=x, y=y, z=z, vx=vxh, vy=vyh, vz=vzh, step=gs.step + 1)
    d2 = torch.where(m, (x - gs.ref_x) ** 2 + (y - gs.ref_y) ** 2 + (z - gs.ref_z) ** 2,
                     zero).max()
    return gs, d2


def force_kick(engine, gs: GridState) -> GridState:
    """Forces at the (half-kicked) slot velocities, then the second half kick."""
    hv = float(np.float32(0.5 * engine.dt / engine.mass))
    fx, fy, fz = engine.compute_forces(gs, gs.vx, gs.vy, gs.vz)
    vx = (gs.vx + hv * fx) * gs.mask
    vy = (gs.vy + hv * fy) * gs.mask
    vz = (gs.vz + hv * fz) * gs.mask
    return gs.replace(fx=fx, fy=fy, fz=fz, vx=vx, vy=vy, vz=vz)
