"""BDHI Euler-Maruyama integrators: dX = (K X + M F) dt + sqrt(2 kT dt) B dW.

Port of ``bdhi_euler_maruyama`` and ``fcm_em`` from
``uammd_tpu/integrators/bdhi/euler_maruyama.py`` (reference:
src/Integrator/BDHI/BDHI_EulerMaruyama.cu:125-166). A backend exposes

    compute_mf(pos, F)    -> M F      [N, 3]
    compute_bdw(pos, gen) -> B dW     [N, 3]  (B B^T = M)
    divergence(pos)       -> kT div M [N, 3]

where the JAX package passes a PRNG key, the port passes the
``torch.Generator`` that ``core.state.next_key`` names. The dense and
Lanczos backends (``CholeskyBDHI``, ``LanczosBDHI``) are not ported yet.
"""

from __future__ import annotations

import math

import torch

from ...core.state import next_key
from ..base import Integrator, advance_time


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
