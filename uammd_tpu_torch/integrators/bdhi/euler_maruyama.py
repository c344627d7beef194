"""BDHI Euler-Maruyama integrators: dX = (K X + M F) dt + sqrt(2 kT dt) B dW.

Port of ``bdhi_euler_maruyama`` and ``fcm_em`` from
``uammd_tpu/integrators/bdhi/euler_maruyama.py`` (reference:
src/Integrator/BDHI/BDHI_EulerMaruyama.cu:125-166). A backend exposes

    compute_mf(pos, F)    -> M F      [N, 3]
    compute_bdw(pos, gen) -> B dW     [N, 3]  (B B^T = M)
    divergence(pos)       -> kT div M [N, 3]

where the JAX package passes a PRNG key, the port passes the
``torch.Generator`` that ``core.state.next_key`` names. Backends here:
``CholeskyBDHI`` (dense RPY, BDHI_Cholesky.cuh) and ``LanczosBDHI``
(matrix-free RPY with a Lanczos sqrt(M), BDHI_Lanczos.cuh); the spectral
ones are in fcm.py and pse.py.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...core.state import next_key
from ...solvers.lanczos import lanczos_sqrt_apply
from ..base import Integrator, advance_time
from .rpy import cholesky_sqrt_dot, dense_mobility, rpy_matvec


def _normal_z(pos, gen):
    """z ~ N(0, 1) of size 3N in the positions' dtype, drawn from ``gen``."""
    return torch.randn(3 * pos.shape[0], generator=gen, dtype=pos.dtype, device=pos.device)


@dataclasses.dataclass(frozen=True)
class CholeskyBDHI:
    """Dense RPY and Cholesky noise (reference: BDHI_Cholesky.cuh)."""

    viscosity: float = 1.0
    radius: float = 1.0
    box: object = None

    def _mobility(self, pos):
        return dense_mobility(pos, viscosity=self.viscosity, radius=self.radius, box=self.box)

    def compute_mf(self, pos, f):
        return (self._mobility(pos) @ f.reshape(-1)).reshape(-1, 3)

    def compute_bdw(self, pos, gen):
        return cholesky_sqrt_dot(self._mobility(pos), _normal_z(pos, gen)).reshape(-1, 3)

    def divergence(self, pos):
        return torch.zeros_like(pos)


@dataclasses.dataclass(frozen=True)
class LanczosBDHI:
    """Matrix-free RPY and a Lanczos sqrt(M) (reference: BDHI_Lanczos.cuh)."""

    viscosity: float = 1.0
    radius: float = 1.0
    box: object = None
    iterations: int = 24

    def compute_mf(self, pos, f):
        return rpy_matvec(pos, f, viscosity=self.viscosity, radius=self.radius, box=self.box)

    def compute_bdw(self, pos, gen):
        def mv(x):
            return self.compute_mf(pos, x.reshape(-1, 3)).reshape(-1)

        out, _ = lanczos_sqrt_apply(mv, _normal_z(pos, gen), m=self.iterations)
        return out.reshape(-1, 3)

    def divergence(self, pos):
        return torch.zeros_like(pos)


def bdhi_euler_maruyama(force_fn, backend, dt: float, temperature: float = 0.0, K=None, *,
                        is2D: bool = False) -> Integrator:
    """The EulerMaruyama<Method> integrator (BDHI_EulerMaruyama.cu:125-166)."""

    def init(state, aux):
        if state.force is None:
            state = state.replace(force=torch.zeros_like(state.pos))
        return state, aux

    def step(state, aux):
        fev, aux = force_fn(state, aux)
        dx = dt * backend.compute_mf(state.pos, fev.force)
        if K is not None:
            dx = dx + dt * (state.pos @ torch.as_tensor(K, dtype=state.dtype,
                                                        device=state.device).T)
        if temperature > 0:
            state, gen = next_key(state)
            dx = dx + math.sqrt(2.0 * temperature * dt) * backend.compute_bdw(state.pos, gen)
            dx = dx + temperature * dt * backend.divergence(state.pos)
        if is2D:
            dx[:, 2] = 0.0
        return advance_time(state.replace(pos=state.pos + dx, force=fev.force), dt), aux

    return Integrator(init=init, step=step)


def fcm_em(force_fn, fcm, dt: float, temperature: float = 0.0, *, slack: int = 1) -> Integrator:
    """Euler-Maruyama on the FCM backend with the fused spectral pass and
    persistent pencil bins: one spread, one k-space combine (mobility and
    fluctuation), one interpolation per step (reference:
    FCM_impl.cuh:654-693), and the particle -> pencil binning carried
    across steps, rebuilt only when some particle's x/y drift since the
    last binning exceeds ``slack`` grid spacings.

    The JAX package decides the rebin inside the compiled step
    (``lax.cond``); here the largest drift is read on the host once per
    step, which waits for the step's work to be enqueued and done."""
    amp = math.sqrt(2.0 * temperature / dt) if temperature > 0 else 0.0
    hmin = min(fcm.box_size[0] / fcm.shape[0], fcm.box_size[1] / fcm.shape[1])
    thr = slack * hmin
    Ls = fcm.box_size

    def init(state, aux):
        if state.force is None:
            state = state.replace(force=torch.zeros_like(state.pos))
        bins = fcm.pencil_bins(state.pos, slack=slack)
        return state, (bins, state.pos, aux)

    def wdrift(pos, ref, d):
        """Largest min-image displacement along axis d since ``ref`` (0-d)."""
        dd = pos[:, d] - ref[:, d]
        return torch.max(torch.abs(dd - Ls[d] * torch.round(dd / Ls[d])))

    def step(state, carry):
        bins, ref, aux = carry
        fev, aux = force_fn(state, aux)
        if bins is None:
            # pencil path unavailable (small N / unsafe grid): per-call bins
            if temperature > 0:
                state, gen = next_key(state)
                mf = fcm.compute_mf_bdw(state.pos, fev.force, gen, amp)
            else:
                mf = fcm.compute_mf(state.pos, fev.force)
        else:
            # compared in the state's dtype, as JAX compares it
            # (``jnp.asarray(thr, state.dtype)``)
            thr_d = float(torch.tensor(thr, dtype=state.pos.dtype))
            if float(torch.maximum(wdrift(state.pos, ref, 0), wdrift(state.pos, ref, 1))) > thr_d:
                bins, ref = fcm.pencil_bins(state.pos, slack=slack), state.pos
            if temperature > 0:
                state, gen = next_key(state)
                mf = fcm.compute_mf_bdw(state.pos, fev.force, gen, amp, bins=bins, slack=slack)
            else:
                mf = fcm.compute_mf(state.pos, fev.force, bins=bins, slack=slack)
        new = (bins, ref, aux)
        return advance_time(state.replace(pos=state.pos + dt * mf, force=fev.force), dt), new

    return Integrator(init=init, step=step)
