"""High-throughput MD on the grid-resident layout (v1 engine).

Port of ``uammd_tpu/engine/md.py`` (``GridMD`` / ``make_lj_md``): the
reference's benchmark workload (examples/misc/benchmark.cu — a 1M-particle
LJ liquid under Gronbech-Jensen Langevin dynamics). Each step is a plain
PyTorch elementwise G-J update, a drift-triggered rebin through the rebin
kernel, the pair-force kernel and the final half kick, in that order.

``jax.lax.scan`` becomes a Python loop, and the ``lax.cond`` on the drift
check becomes a Python ``if`` on one ``.item()``-style host read per step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .layout import GridSpec, GridState, choose_spec, needs_rebin, pack
from .pair_kernel import LJEnergy, LJRadial, make_pair_force_kernel
from .rebin_kernel import rebin_fast, rebin_fast_noforce


def maybe_rebin(gs: GridState) -> GridState:
    """Drift-triggered rebin through the rebin kernel (one host sync)."""
    return rebin_fast(gs) if bool(needs_rebin(gs)) else gs


def maybe_rebin_noforce(gs: GridState) -> GridState:
    """As maybe_rebin but dropping forces (recomputed right after)."""
    return rebin_fast_noforce(gs) if bool(needs_rebin(gs)) else gs


def lj_g(epsilon: float = 1.0, sigma: float = 1.0) -> LJRadial:
    """(dE/dr)/r for 12-6 LJ, written with a single reciprocal t = 1/r2.

    Callable on tensors (the plain version); the pair kernel evaluates the
    same expression in its device function from ``epsilon`` and ``sigma``."""
    return LJRadial(epsilon, sigma)


def lj_e(epsilon: float = 1.0, sigma: float = 1.0, shift_rc=None) -> LJEnergy:
    """12-6 LJ pair energy (JAX ``md.lj_e``), shifted to 0 at ``shift_rc``
    when given. Callable on tensors (the plain version); the pair kernel's
    observable mode evaluates the same expression in its device function."""
    return LJEnergy(epsilon, sigma, shift_rc)


class LJFused:
    """The LJ radial with the cutoff and clamp selects fused in, as
    ``md.lj_g_fused`` of the JAX package writes it: with t = 1/max(r2, lo),
    g = r2 < rc2 ? t^4 (c1 t^3 + c2) : 0, sigma folded into c1 and c2.

    Called on a tensor it is the plain version and always takes the exact
    reciprocal. The Newton pair kernel reads ``c1``, ``c2``, ``rc2`` and
    ``lo`` and evaluates the same expression in its device function, with
    ``rcp.approx.ftz.f32`` in place of the division when ``approx``."""

    def __init__(self, epsilon=1.0, sigma=1.0, *, rc2, clamp_lo=4e-3, approx=False):
        s6 = float(sigma) ** 6
        self.c1 = float(np.float32(-48.0 * epsilon * s6 * s6))
        self.c2 = float(np.float32(24.0 * epsilon * s6))
        self.rc2 = float(np.float32(rc2))
        self.lo = float(np.float32(clamp_lo))
        self.approx = bool(approx)

    def __call__(self, r2: torch.Tensor) -> torch.Tensor:
        t = 1.0 / torch.clamp(r2, min=self.lo)
        t2 = t * t
        t3 = t2 * t
        t4 = t2 * t2
        return torch.where(r2 < self.rc2, t4 * (self.c1 * t3 + self.c2),
                           torch.zeros((), dtype=r2.dtype, device=r2.device))


def lj_g_fused(epsilon=1.0, sigma=1.0, *, rc2, clamp_lo=4e-3, approx=False) -> LJFused:
    """Minimum-op LJ radial with the cutoff/clamp selects fused in (JAX
    ``md.lj_g_fused``). ``approx`` selects the hardware approximate
    reciprocal inside the CUDA kernel; the plain version is exact."""
    return LJFused(epsilon, sigma, rc2=rc2, clamp_lo=clamp_lo, approx=approx)


@dataclasses.dataclass(frozen=True)
class GridMD:
    """Bound engine: spec + force kernel + integrator params + device."""

    spec: GridSpec
    force_kernel: object
    dt: float
    temperature: float
    friction: float
    mass: float
    device: torch.device

    def init(self, pos, seed: int = 0) -> GridState:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        gs = pack(self.spec, pos, gen=gen, device=self.device)
        if self.temperature > 0:
            sd = float(np.sqrt(self.temperature / self.mass))
            m = gs.mask
            vx, vy, vz = (
                sd * torch.randn(gs.x.shape, generator=gen, device=self.device) * m
                for _ in range(3)
            )
            gs = gs.replace(vx=vx, vy=vy, vz=vz)
        return self.compute_forces(gs)

    def compute_forces(self, gs: GridState) -> GridState:
        fx, fy, fz = self.force_kernel(gs.x, gs.y, gs.z)
        m = gs.mask
        return gs.replace(fx=fx * m, fy=fy * m, fz=fz * m)

    def step(self, gs: GridState) -> GridState:
        """One Gronbech-Jensen Langevin step (reference:
        src/Integrator/VerletNVT/GronbechJensen.cu:20-62).

        Order: position/velocity update with f(t) -> drift-triggered rebin
        (forces dropped: f(t) is fully consumed by then) -> new forces ->
        final half kick."""
        mask = gs.mask
        if self.temperature > 0:
            amp = float(np.float32(np.sqrt(
                2.0 * self.temperature * self.friction * self.mass * self.dt)))
            nx_, ny_, nz_ = (
                amp * torch.randn(gs.x.shape, generator=gs.gen, device=gs.device)
                for _ in range(3)
            )
        else:
            nx_ = ny_ = nz_ = torch.zeros_like(gs.x)
        # float32 coefficients, grouped as the JAX package groups them, held
        # as Python floats (exact) for the tensor arithmetic
        dt = np.float32(self.dt)
        m = np.float32(self.mass)
        gdt = np.float32(0.5 * self.friction * self.dt)
        b = np.float32(1.0 / (1.0 + gdt))
        a = np.float32((1.0 - gdt) * b)
        c_x = np.float32(0.5) * b * dt / m
        hv = np.float32(0.5) * dt / m
        bdt, c_x, hva, bm = (float(v) for v in (b * dt, c_x, hv * a, b / m))
        dt, a, hv = float(dt), float(a), float(hv)

        x = gs.x + mask * (bdt * gs.vx + c_x * (dt * gs.fx + nx_))
        y = gs.y + mask * (bdt * gs.vy + c_x * (dt * gs.fy + ny_))
        z = gs.z + mask * (bdt * gs.vz + c_x * (dt * gs.fz + nz_))
        vx = mask * (a * gs.vx + hva * gs.fx + bm * nx_)
        vy = mask * (a * gs.vy + hva * gs.fy + bm * ny_)
        vz = mask * (a * gs.vz + hva * gs.fz + bm * nz_)
        gs = gs.replace(x=x, y=y, z=z, vx=vx, vy=vy, vz=vz)
        gs = maybe_rebin_noforce(gs)
        gs = self.compute_forces(gs)
        return gs.replace(
            vx=gs.vx + hv * gs.fx, vy=gs.vy + hv * gs.fy, vz=gs.vz + hv * gs.fz
        )

    def step_nve(self, gs: GridState) -> GridState:
        h = float(np.float32(0.5) * np.float32(self.dt) / np.float32(self.mass))
        dt = float(np.float32(self.dt))
        vx = gs.vx + h * gs.fx
        vy = gs.vy + h * gs.fy
        vz = gs.vz + h * gs.fz
        m = gs.mask
        gs = gs.replace(
            x=gs.x + m * dt * vx,
            y=gs.y + m * dt * vy,
            z=gs.z + m * dt * vz,
            vx=vx, vy=vy, vz=vz,
        )
        gs = maybe_rebin_noforce(gs)
        gs = self.compute_forces(gs)
        return gs.replace(
            vx=gs.vx + h * gs.fx, vy=gs.vy + h * gs.fy, vz=gs.vz + h * gs.fz
        )

    def run(self, gs: GridState, n_steps: int, *, nve: bool = False) -> GridState:
        """Advance n_steps (one host sync per step, for the drift check)."""
        step = self.step_nve if nve else self.step
        for _ in range(n_steps):
            gs = step(gs)
        return gs

    def temperature_of(self, gs: GridState) -> torch.Tensor:
        ke = 0.5 * self.mass * torch.sum(gs.vx**2 + gs.vy**2 + gs.vz**2)
        return 2.0 * ke / (3.0 * gs.n)


def make_lj_md(
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
    pos=None,
    device=None,
) -> GridMD:
    """The reference benchmark system (examples/misc/benchmark.cu:172-181)
    on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    spec = choose_spec(box_size, n, cutoff, skin=skin, cap=cap, pos=pos)
    kern = make_pair_force_kernel(spec, lj_g(epsilon, sigma))
    return GridMD(
        spec=spec, force_kernel=kern, dt=dt,
        temperature=temperature, friction=friction, mass=mass, device=dev,
    )
