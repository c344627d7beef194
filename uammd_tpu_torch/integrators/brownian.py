"""Overdamped Langevin (Brownian dynamics) integrators.

Port of ``uammd_tpu/integrators/brownian.py`` (reference:
src/Integrator/BrownianDynamics.cu): dX = (K X + M F) dt + sqrt(2 T M dt) dW
with per-particle mobility M = 1/(6 pi eta a) (a = hydrodynamic radius, per
particle if ``state.radius`` is set, BrownianDynamics.cu:132) and an
optional 3x3 shear matrix K. Four schemes:

- euler_maruyama  (BrownianDynamics.cu:119-144)
- midpoint        (:190-232): half drift to the midpoint with noise B dW1,
  forces again, full drift from the initial point with B (dW1 + dW2),
  B = sqrt(T M dt).
- adams_bashforth (:276-301): drift with 1.5 F_n - 0.5 F_{n-1}.
- leimkuhler      (:331-356): noise sqrt(T M dt / 2) (xi_n + xi_{n-1}),
  the previous draw carried in ``aux``.

No kernel: plain tensor arithmetic around the force function. The noise
comes from the state's ``torch.Generator`` (``core.state.next_key``), so a
run draws other numbers than the JAX package from the same seed.
"""

from __future__ import annotations

import math

import torch

from ..core.state import SimState, next_key
from .base import Integrator, advance_time


def self_mobility(state: SimState, viscosity: float, hydrodynamic_radius=None):
    """Per-particle scalar mobility (reference: BrownianDynamics.cu:19-46)."""
    m0 = 1.0 / (6.0 * math.pi * viscosity)
    ones = torch.ones(state.n, dtype=state.dtype, device=state.device)
    if hydrodynamic_radius is not None:
        return (m0 / hydrodynamic_radius) * ones
    if state.radius is not None:
        return m0 / state.radius
    return m0 * ones


def _shear(K, pos):
    if K is None:
        return 0.0
    return pos @ torch.as_tensor(K, dtype=pos.dtype, device=pos.device).T


_Z_MASKS: dict = {}


def _z_mask(is2D, state):
    # made once per (is2D, dtype, device): a copy to the card per step would
    # wait for it
    key = (bool(is2D), state.dtype, state.device)
    if key not in _Z_MASKS:
        _Z_MASKS[key] = torch.tensor([1.0, 1.0, 0.0] if is2D else [1.0, 1.0, 1.0],
                                     dtype=state.dtype, device=state.device)
    return _Z_MASKS[key]


def _normal(state: SimState):
    state, gen = next_key(state)
    return state, torch.randn(state.pos.shape, generator=gen, dtype=state.dtype,
                              device=state.device)


def _ensure_force(state):
    """The step stores the last force in the state; start it at zero."""
    if state.force is None:
        return state.replace(force=torch.zeros_like(state.pos))
    return state


def euler_maruyama(force_fn, dt: float, temperature: float = 0.0, viscosity: float = 1.0,
                   hydrodynamic_radius=None, K=None, *, is2D: bool = False) -> Integrator:
    def init(state, aux):
        return _ensure_force(state), aux

    def step(state, aux):
        M = self_mobility(state, viscosity, hydrodynamic_radius)[:, None]
        fev, aux = force_fn(state, aux)
        dx = dt * (_shear(K, state.pos) + M * fev.force)
        if temperature > 0:
            state, xi = _normal(state)
            dx = dx + torch.sqrt(2.0 * temperature * M * dt) * xi
        x = state.pos + dx * _z_mask(is2D, state)
        return advance_time(state.replace(pos=x, force=fev.force), dt), aux

    return Integrator(init=init, step=step)


def midpoint(force_fn, dt: float, temperature: float = 0.0, viscosity: float = 1.0,
             hydrodynamic_radius=None, K=None, *, is2D: bool = False) -> Integrator:
    """Stochastic midpoint scheme (reference: BrownianDynamics.cu:190-232)."""

    def init(state, aux):
        return _ensure_force(state), aux

    def step(state, aux):
        zm = _z_mask(is2D, state)
        M = self_mobility(state, viscosity, hydrodynamic_radius)[:, None]
        x0 = state.pos
        fev, aux = force_fn(state, aux)
        dx = dt * (0.5 * _shear(K, x0) + 0.5 * M * fev.force)
        if temperature > 0:
            B = torch.sqrt(temperature * M * dt)
            state, xi1 = _normal(state)
            dW1 = B * xi1
            dx = dx + dW1
        x_mid = x0 + dx * zm
        fev2, aux = force_fn(state.replace(pos=x_mid), aux)
        dx = dt * (_shear(K, x_mid) + M * fev2.force)
        if temperature > 0:
            state, xi2 = _normal(state)
            dx = dx + dW1 + B * xi2
        x = x0 + dx * zm
        return advance_time(state.replace(pos=x, force=fev2.force), dt), aux

    return Integrator(init=init, step=step)


def adams_bashforth(force_fn, dt: float, temperature: float = 0.0, viscosity: float = 1.0,
                    hydrodynamic_radius=None, K=None, *, is2D: bool = False) -> Integrator:
    """AB2 drift (reference: BrownianDynamics.cu:276-301); aux carries the
    previous forces as (prev_force, user_aux)."""

    def init(state, aux):
        fev, aux = force_fn(state, aux)
        return state.replace(force=fev.force), (fev.force, aux)

    def step(state, carry):
        prev_force, aux = carry
        M = self_mobility(state, viscosity, hydrodynamic_radius)[:, None]
        fev, aux = force_fn(state, aux)
        dx = dt * (_shear(K, state.pos) + M * (1.5 * fev.force - 0.5 * prev_force))
        if temperature > 0:
            state, xi = _normal(state)
            dx = dx + torch.sqrt(2.0 * temperature * M * dt) * xi
        x = state.pos + dx * _z_mask(is2D, state)
        return advance_time(state.replace(pos=x, force=fev.force), dt), (fev.force, aux)

    return Integrator(init=init, step=step)


def leimkuhler(force_fn, dt: float, temperature: float = 0.0, viscosity: float = 1.0,
               hydrodynamic_radius=None, K=None, *, is2D: bool = False) -> Integrator:
    """Leimkuhler-Matthews BAOAB-limit scheme (reference:
    BrownianDynamics.cu:331-356): noise = sqrt(T M dt / 2)(xi_n + xi_{n-1});
    aux = (prev_noise, user_aux)."""

    def init(state, aux):
        state, xi = _normal(state)
        return _ensure_force(state), (xi, aux)

    def step(state, carry):
        xi_prev, aux = carry
        M = self_mobility(state, viscosity, hydrodynamic_radius)[:, None]
        fev, aux = force_fn(state, aux)
        dx = dt * (_shear(K, state.pos) + M * fev.force)
        state, xi = _normal(state)
        if temperature > 0:
            dx = dx + torch.sqrt(0.5 * temperature * M * dt) * (xi + xi_prev)
        x = state.pos + dx * _z_mask(is2D, state)
        return advance_time(state.replace(pos=x, force=fev.force), dt), (xi, aux)

    return Integrator(init=init, step=step)
