"""Integrator base: step functions driven by a Python loop.

Port of ``uammd_tpu/integrators/base.py`` (reference:
src/Integrator/Integrator.cuh:33-125). An integrator is a pair of functions

    init(state, aux) -> (state, aux)
    step(state, aux) -> (state, aux)

where ``aux`` carries cached acceleration structures (pencil bins, ...).
Interactors are ``force_fn(state, aux) -> (fev, aux)`` closures, summed by
``combine_interactors``. ``run`` is a Python loop over ``step`` (the JAX
package's ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.logging import SimulationError
from ..core.state import SimState
from ..core.types import ForceEnergyVirial


@dataclasses.dataclass(frozen=True)
class Integrator:
    init: Callable  # (state, aux) -> (state, aux)
    step: Callable  # (state, aux) -> (state, aux)


def combine_interactors(*force_fns):
    """Sum several force_fn(state, aux) -> (fev, aux); aux is threaded
    through in order (reference: Integrator::addInteractor)."""

    def combined(state, aux):
        total = ForceEnergyVirial()
        for fn in force_fns:
            fev, aux = fn(state, aux)
            total = total + fev
        return total, aux

    return combined


def run(integrator: Integrator, state: SimState, aux: Any, n_steps: int, *,
        observe: Callable | None = None, observe_every: int = 1,
        initialize: bool = True, guard: bool = False):
    """Advance ``n_steps``. ``observe(state)`` is recorded every
    ``observe_every`` steps and the observations are returned as a list
    (None without ``observe``). ``guard`` raises SimulationError when the
    final pos, vel or force is not finite (one device read)."""
    if initialize:
        state, aux = integrator.init(state, aux)
    obs = None
    if observe is not None:
        assert n_steps % observe_every == 0
        obs = []
    for k in range(n_steps):
        state, aux = integrator.step(state, aux)
        if observe is not None and (k + 1) % observe_every == 0:
            obs.append(observe(state))
    if guard:
        _guard_finite(state)
    return state, aux, obs


def _guard_finite(state: SimState) -> None:
    for name in ("pos", "vel", "force"):
        v = getattr(state, name, None)
        if v is not None and not bool(torch.isfinite(v).all()):
            raise SimulationError(f"non-finite values in state.{name} after run()")


def advance_time(state: SimState, dt) -> SimState:
    upd = {}
    if state.time is not None:
        upd["time"] = state.time + dt
    if state.step is not None:
        upd["step"] = state.step + 1
    return state.replace(**upd) if upd else state


def kinetic_energy(state: SimState) -> torch.Tensor:
    """Total kinetic energy (reference: VerletNVT Basic.cu sumKineticEnergy)."""
    v = state.get_vel()
    return 0.5 * torch.sum(state.get_mass() * torch.sum(v * v, dim=-1))


def temperature(state: SimState, dim: int = 3) -> torch.Tensor:
    return 2.0 * kinetic_energy(state) / (dim * state.n)
